"""FASTA / alignment IO and token-budget batching.

Port of esm_tpu/data/fasta.py (reference semantics: esm/data.py:19-88,
339-378). Host-side. ``FastaBatchedDataset.from_file`` takes the native
parser (``esm_tpu_torch.native``) when it is built and the file is ASCII,
and the pure-Python loop otherwise, with the same records.
"""

from __future__ import annotations

import re
from typing import Iterator, List, Optional, Sequence, Tuple


class FastaBatchedDataset:
    def __init__(self, sequence_labels: Sequence[str], sequence_strs: Sequence[str]):
        self.sequence_labels = list(sequence_labels)
        self.sequence_strs = list(sequence_strs)

    @classmethod
    def from_file(cls, fasta_file) -> "FastaBatchedDataset":
        from .. import native

        parsed = native.parse_fasta(fasta_file)
        if parsed is not None:
            labels, seq_buf, seq_off = parsed
            if len(set(labels)) != len(labels):
                raise AssertionError("Found duplicate sequence labels")
            # parse_fasta returns pure-ASCII buffers only: bytes are characters
            sview = seq_buf[: seq_off[-1]].tobytes().decode("ascii")
            off = seq_off.tolist()
            ds = cls(labels, [sview[off[i]:off[i + 1]] for i in range(len(labels))])
            ds._seq_buf, ds._seq_off = seq_buf, seq_off  # for native.tokenize_batch
            return ds

        sequence_labels: List[str] = []
        sequence_strs: List[str] = []
        cur_seq_label: Optional[str] = None
        buf: List[str] = []

        def _flush_current_seq():
            nonlocal cur_seq_label, buf
            if cur_seq_label is None:
                return
            sequence_labels.append(cur_seq_label)
            sequence_strs.append("".join(buf))
            cur_seq_label = None
            buf = []

        with open(fasta_file, "r") as infile:
            for line_idx, line in enumerate(infile):
                if line.startswith(">"):
                    _flush_current_seq()
                    line = line[1:].strip()
                    cur_seq_label = line if len(line) > 0 else f"seqnum{line_idx:09d}"
                else:
                    buf.append(line.strip())
        _flush_current_seq()

        if len(set(sequence_labels)) != len(sequence_labels):
            raise AssertionError("Found duplicate sequence labels")
        return cls(sequence_labels, sequence_strs)

    def __len__(self) -> int:
        return len(self.sequence_labels)

    def __getitem__(self, idx: int) -> Tuple[str, str]:
        return self.sequence_labels[idx], self.sequence_strs[idx]

    def get_batch_indices(
        self, toks_per_batch: int, extra_toks_per_seq: int = 0
    ) -> List[List[int]]:
        """Sort by length, greedily fill batches until the padded token count
        would exceed ``toks_per_batch`` (reference esm/data.py:65-88)."""
        sizes = [(len(s), i) for i, s in enumerate(self.sequence_strs)]
        sizes.sort()
        batches: List[List[int]] = []
        buf: List[int] = []
        max_len = 0
        for sz, i in sizes:
            sz += extra_toks_per_seq
            if max(sz, max_len) * (len(buf) + 1) > toks_per_batch and buf:
                batches.append(buf)
                buf = []
                max_len = 0
            max_len = max(max_len, sz)
            buf.append(i)
        if buf:
            batches.append(buf)
        return batches


def read_fasta(
    path,
    keep_gaps: bool = True,
    keep_insertions: bool = True,
    to_upper: bool = False,
) -> Iterator[Tuple[str, str]]:
    with open(path, "r") as f:
        yield from read_alignment_lines(
            f, keep_gaps=keep_gaps, keep_insertions=keep_insertions, to_upper=to_upper
        )


def read_alignment_lines(
    lines,
    keep_gaps: bool = True,
    keep_insertions: bool = True,
    to_upper: bool = False,
) -> Iterator[Tuple[str, str]]:
    seq: Optional[str] = None
    desc: Optional[str] = None

    def parse(s: str) -> str:
        if not keep_gaps:
            s = re.sub("-", "", s)
        if not keep_insertions:
            s = re.sub("[a-z]", "", s)
        return s.upper() if to_upper else s

    for line in lines:
        if len(line) > 0 and line[0] == ">":
            if seq is not None:
                yield desc, parse(seq)
            desc = line.strip().lstrip(">")
            seq = ""
        else:
            if seq is None:
                raise ValueError("alignment text must start with a '>' header line")
            seq += line.strip()
    if seq is None or desc is None:
        raise ValueError("no records in alignment text")
    yield desc, parse(seq)
