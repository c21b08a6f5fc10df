// Native data-loader hot path: a copy of esm_tpu/native/fasta.cc inside the
// port (the port imports nothing of esm_tpu). It runs on the host CPU.
//
// Two entry points, bound from Python via ctypes (esm_tpu_torch/native/__init__.py):
//
//   esm_fasta_parse     — single-pass mmap'd FASTA scan with the exact
//                         record semantics of the reference loader
//                         (reference esm/data.py:19-47
//                         FastaBatchedDataset.from_file): per-line strip,
//                         '>' headers stripped of whitespace, empty headers
//                         named "seqnum%09d" by 0-based line index, and the
//                         reference's leading-junk behavior (bytes before the
//                         first header attach to the first record; dropped if
//                         the file has no header at all).
//
//   esm_tokenize_batch  — byte-LUT tokenization of parsed records straight
//                         into a caller-allocated padded int32 token matrix
//                         (reference esm/data.py:253-297 BatchConverter hot
//                         loop), with truncation and bos/eos insertion.
//
// Both are pure C ABI, no Python dependency; the Python side allocates all
// buffers (numpy) and owns all object creation.

#include <cstdint>
#include <cstdio>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// Python str.strip() whitespace set, ASCII subset: \t\n\v\f\r, space, and
// the file/group/record/unit separators \x1c-\x1f (which Python also
// strips). Non-ASCII whitespace (\x85, NBSP, ...) never reaches this code:
// the Python binding rejects any non-ASCII buffer and falls back to the
// exact text-mode parser.
inline bool is_space(unsigned char c) {
  return (c >= 0x09 && c <= 0x0d) || c == ' ' || (c >= 0x1c && c <= 0x1f);
}

// Trim [b, e) on both sides; returns trimmed length, updates b.
inline int64_t trim(const char* data, int64_t& b, int64_t e) {
  while (b < e && is_space((unsigned char)data[b])) ++b;
  while (e > b && is_space((unsigned char)data[e - 1])) --e;
  return e - b;
}

struct Sink {
  char* label_buf;
  int64_t* label_off;
  char* seq_buf;
  int64_t* seq_off;
  bool fill;
  // Fill-pass buffer capacities (from the sizing pass). The file may grow
  // between the two calls (e.g. a concurrently-appended shard) — every write
  // is bounds-checked and sets `overflow` instead of running past the
  // caller's numpy buffers.
  int64_t n_cap = 0;
  int64_t label_cap = 0;
  int64_t seq_cap = 0;

  int64_t n = 0;
  int64_t label_bytes = 0;
  int64_t seq_bytes = 0;
  bool overflow = false;

  void header(const char* data, int64_t b, int64_t e, int64_t line_idx) {
    int64_t len = trim(data, b, e);
    char tmp[32];
    const char* src = data + b;
    if (len == 0) {
      // reference: f"seqnum{line_idx:09d}" (esm/data.py:40)
      len = snprintf(tmp, sizeof(tmp), "seqnum%09lld", (long long)line_idx);
      src = tmp;
    }
    if (fill) {
      if (n >= n_cap || label_bytes + len > label_cap) {
        overflow = true;
        return;
      }
      label_off[n] = label_bytes;
      // Sequence bytes seen before the first header belong to the first
      // record (the reference never clears its line buffer on the first
      // flush, esm/data.py:27-33) — so record 0 starts at offset 0.
      seq_off[n] = (n == 0) ? 0 : seq_bytes;
      memcpy(label_buf + label_bytes, src, (size_t)len);
    }
    label_bytes += len;
    ++n;
  }

  void seq_line(const char* data, int64_t b, int64_t e) {
    int64_t len = trim(data, b, e);
    if (len > 0) {
      if (fill) {
        if (seq_bytes + len > seq_cap) {
          overflow = true;
          return;
        }
        memcpy(seq_buf + seq_bytes, data + b, (size_t)len);
      }
      seq_bytes += len;
    }
  }

  void finish() {
    if (fill && !overflow) {
      label_off[n] = label_bytes;
      seq_off[n] = seq_bytes;
    }
  }
};

void scan(const char* data, int64_t size, Sink& out) {
  int64_t pos = 0;
  int64_t line_idx = 0;
  while (pos < size) {
    // Universal-newline line split ('\n', '\r', or '\r\n'), matching the
    // reference's text-mode file iteration. memchr (SIMD) for the common
    // '\n', then check for an earlier '\r' within the candidate line.
    const char* nl =
        (const char*)memchr(data + pos, '\n', (size_t)(size - pos));
    int64_t end = nl ? (int64_t)(nl - data) : size;
    const char* cr =
        (const char*)memchr(data + pos, '\r', (size_t)(end - pos));
    if (cr) end = (int64_t)(cr - data);
    if (end > pos && data[pos] == '>') {
      out.header(data, pos + 1, end, line_idx);
    } else {
      // Bytes before the first header are appended to the sequence stream;
      // if a header follows they become the head of the first record's
      // sequence, mirroring the reference's un-cleared line buffer
      // (esm/data.py:27-33). With no header in the file, n stays 0 and the
      // caller never reads them.
      out.seq_line(data, pos, end);
    }
    if (out.overflow) break;
    pos = end;
    if (pos < size) {
      if (data[pos] == '\r' && pos + 1 < size && data[pos + 1] == '\n') ++pos;
      ++pos;
    }
    ++line_idx;
  }
  out.finish();
}

}  // namespace

extern "C" {

// Two-call protocol. Call with label_buf == NULL to size the outputs
// (fills n_records / label_bytes / seq_bytes only); call again with
// caller-allocated buffers:
//   label_buf: label_bytes chars     label_off: (n_records+1) int64
//   seq_buf:   seq_bytes chars       seq_off:   (n_records+1) int64
// On the fill call, n_records / label_bytes / seq_bytes are IN-OUT: they
// carry the buffer capacities in (from the sizing call) and the actual
// counts out. Returns 0 on success, -1 if the file cannot be opened/mapped,
// -2 if the file outgrew the capacities between the two calls (the caller
// must re-size; no out-of-bounds write happens).
int esm_fasta_parse(const char* path, int64_t* n_records, int64_t* label_bytes,
                    int64_t* seq_bytes, char* label_buf, int64_t* label_off,
                    char* seq_buf, int64_t* seq_off) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return -1;
  }
  int64_t size = (int64_t)st.st_size;
  const char* data = nullptr;
  if (size > 0) {
    void* m = mmap(nullptr, (size_t)size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (m == MAP_FAILED) {
      close(fd);
      return -1;
    }
    data = (const char*)m;
  }

  Sink out;
  out.fill = (label_buf != nullptr);
  out.label_buf = label_buf;
  out.label_off = label_off;
  out.seq_buf = seq_buf;
  out.seq_off = seq_off;
  if (out.fill) {
    out.n_cap = *n_records;
    out.label_cap = *label_bytes;
    out.seq_cap = *seq_bytes;
    if (size > 0) madvise((void*)data, (size_t)size, MADV_SEQUENTIAL);
  }
  scan(data, size, out);

  *n_records = out.n;
  *label_bytes = out.label_bytes;
  *seq_bytes = out.seq_bytes;
  if (size > 0) munmap((void*)data, (size_t)size);
  close(fd);
  return out.overflow ? -2 : 0;
}

// LUT-tokenize `n` records (selected by `idx` into the seq_off table) into a
// row-padded int32 matrix out[n][stride].
//   lut:    256 int32 entries, -1 = byte has no single-char token
//   trunc:  truncate each sequence to this many tokens (0 = no truncation)
//   bos/eos: token ids inserted before/after when >= 0
//   pad:    fill value for the tail of each row
// Caller guarantees stride >= bos? + min(len, trunc) + eos? for every row.
// Returns 0 on success, or -(i+1) if record idx[i] contains an unmapped
// byte (caller falls back to the exact slow tokenizer for that batch).
int64_t esm_tokenize_batch(const uint8_t* seq_buf, const int64_t* seq_off,
                           const int64_t* idx, int64_t n, const int32_t* lut,
                           int64_t trunc, int32_t bos, int32_t eos,
                           int32_t pad, int32_t* out, int64_t stride) {
  for (int64_t i = 0; i < n; ++i) {
    int64_t r = idx[i];
    int64_t b = seq_off[r], e = seq_off[r + 1];
    int64_t len = e - b;
    if (trunc > 0 && len > trunc) len = trunc;
    int32_t* row = out + i * stride;
    int64_t w = 0;
    if (bos >= 0) row[w++] = bos;
    for (int64_t j = 0; j < len; ++j) {
      int32_t t = lut[seq_buf[b + j]];
      if (t < 0) return -(i + 1);
      row[w++] = t;
    }
    if (eos >= 0) row[w++] = eos;
    for (; w < stride; ++w) row[w] = pad;
  }
  return 0;
}

}  // extern "C"
