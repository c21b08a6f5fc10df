"""Native (C++) FASTA loader, on the host.

Port of esm_tpu/native (the source, ``fasta.cc``, is a copy of esm_tpu's).
It is built at first use with the system g++ into ``build/native/`` beside
the package, named by a hash of the source, and bound with ctypes:

  * ``parse_fasta(path)``: an mmap'd single-pass FASTA scan with the
    reference's record semantics (``FastaBatchedDataset.from_file`` takes
    it);
  * ``tokenize_batch(...)``: byte-LUT tokenization of parsed records into a
    padded int32 token matrix (``Alphabet.byte_lut`` gives the table), with
    no per-sequence Python strings.

When g++ is missing or the build fails, ``available()`` is False, a warning
carries the compiler's message, and the callers keep their pure-Python
paths (as esm_tpu's do).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import warnings
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_SRC = Path(__file__).with_name("fasta.cc")
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_lib = None
_tried = False


def _build() -> Path:
    src = _SRC.read_bytes()
    so = _BUILD_DIR / f"esm_fasta_{hashlib.sha256(src).hexdigest()[:16]}.so"
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-std=c++17", "-shared", "-fPIC", str(_SRC), "-o", tmp],
                       check=True, capture_output=True, text=True, timeout=120)
        os.replace(tmp, so)  # atomic when several processes build at once
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(str(_build()))
    except subprocess.CalledProcessError as e:
        warnings.warn(f"native FASTA loader: g++ failed ({e.returncode}): {e.stderr}")
        return None
    except (OSError, subprocess.TimeoutExpired) as e:
        warnings.warn(f"native FASTA loader unavailable: {e}")
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.esm_fasta_parse.restype = ctypes.c_int
    lib.esm_fasta_parse.argtypes = [
        ctypes.c_char_p, i64p, i64p, i64p, ctypes.c_char_p, i64p, ctypes.c_char_p, i64p,
    ]
    lib.esm_tokenize_batch.restype = ctypes.c_int64
    lib.esm_tokenize_batch.argtypes = [
        ctypes.c_char_p, i64p, i64p, ctypes.c_int64, i32p,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p, ctypes.c_int64,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    """Whether the library is built and loaded (building it now if needed);
    False after a failed build, which warns with the compiler's message."""
    return _load() is not None


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def parse_fasta(path) -> Optional[Tuple[List[str], np.ndarray, np.ndarray]]:
    """Parse a FASTA file natively.

    Returns ``(labels, seq_buf, seq_off)`` where record i's cleaned sequence
    bytes are ``seq_buf[seq_off[i]:seq_off[i+1]]``, or None when the library
    is unavailable, the file cannot be mapped, the file changed between the
    sizing and fill passes, or the content is not pure ASCII (the
    pure-Python parser then keeps the reference's text-mode semantics:
    invalid UTF-8 raises, non-ASCII whitespace strips as str.strip does).
    """
    lib = _load()
    if lib is None:
        return None
    n, lb, sb = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    path_b = os.fsencode(str(path))
    nullc = ctypes.c_char_p()
    null64 = ctypes.POINTER(ctypes.c_int64)()
    if lib.esm_fasta_parse(path_b, ctypes.byref(n), ctypes.byref(lb), ctypes.byref(sb),
                           nullc, null64, nullc, null64) != 0:
        return None
    label_buf = np.zeros(max(lb.value, 1), dtype=np.uint8)
    seq_buf = np.zeros(max(sb.value, 1), dtype=np.uint8)
    label_off = np.empty(n.value + 1, dtype=np.int64)
    seq_off = np.empty(n.value + 1, dtype=np.int64)
    # in-out: capacities in, actual counts out; the C side bounds-checks every
    # write and returns -2 if the file grew between the passes
    n2, lb2, sb2 = ctypes.c_int64(n.value), ctypes.c_int64(lb.value), ctypes.c_int64(sb.value)
    if lib.esm_fasta_parse(
        path_b, ctypes.byref(n2), ctypes.byref(lb2), ctypes.byref(sb2),
        label_buf.ctypes.data_as(ctypes.c_char_p), _i64p(label_off),
        seq_buf.ctypes.data_as(ctypes.c_char_p), _i64p(seq_off),
    ) != 0 or n2.value != n.value:
        return None  # the file changed between the passes
    if (lb2.value and label_buf[:lb2.value].max() >= 128) or (
        sb2.value and seq_buf[:sb2.value].max() >= 128
    ):
        return None  # non-ASCII content: the exact-semantics Python path
    lview = label_buf[:lb2.value].tobytes().decode("ascii")
    off = label_off.tolist()
    labels = [lview[off[i]:off[i + 1]] for i in range(n.value)]
    return labels, seq_buf, seq_off[: n.value + 1]


def tokenize_batch(
    seq_buf: np.ndarray,
    seq_off: np.ndarray,
    indices,
    lut: np.ndarray,
    *,
    truncation: Optional[int] = None,
    bos: int = -1,
    eos: int = -1,
    pad: int = 0,
    stride: Optional[int] = None,
) -> Optional[np.ndarray]:
    """Fill a padded (len(indices), stride) int32 token matrix from parsed
    records. Returns None on a byte the table does not map (the caller uses
    the exact tokenizer) or when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    idx = np.ascontiguousarray(indices, dtype=np.int64)
    lut = np.ascontiguousarray(lut, dtype=np.int32)
    if lut.shape != (256,):
        raise ValueError(f"lut must have 256 entries, got {lut.shape}")
    seq_buf = np.ascontiguousarray(seq_buf, dtype=np.uint8)
    seq_off = np.ascontiguousarray(seq_off, dtype=np.int64)
    if len(seq_off) and seq_off[-1] > len(seq_buf):
        raise ValueError(f"seq_off ends at {seq_off[-1]}, past the {len(seq_buf)}-byte buffer")
    if len(idx) and (idx.min() < 0 or idx.max() + 1 >= len(seq_off)):
        raise IndexError(f"record indices out of range [0, {len(seq_off) - 1})")
    trunc = int(truncation) if truncation else 0
    lens = seq_off[idx + 1] - seq_off[idx]
    if trunc:
        lens = np.minimum(lens, trunc)
    need = int(lens.max() if len(idx) else 0) + (bos >= 0) + (eos >= 0)
    if stride is None:
        stride = need
    elif stride < need:
        raise ValueError(f"stride {stride} < longest row {need}")
    out = np.empty((len(idx), stride), dtype=np.int32)
    rc = lib.esm_tokenize_batch(
        seq_buf.ctypes.data_as(ctypes.c_char_p), _i64p(seq_off), _i64p(idx), len(idx),
        _i32p(lut), trunc, bos, eos, pad, _i32p(out), stride,
    )
    if rc != 0:
        return None
    return out
