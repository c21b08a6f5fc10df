"""Protein token alphabet and batch conversion.

Port of esm_tpu/data/alphabet.py (reference semantics: esm/data.py:91-297,
esm/constants.py:7-9). Token tables match the reference exactly: checkpoint
embedding rows are indexed by these ids. ``BatchConverter`` returns an int64
token tensor, as the reference does, and can pad the sequence axis up to a
multiple (``pad_to_multiple``). ``MSABatchConverter`` turns MSAs into
(B, R, C) token tensors for the MSA Transformer.
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

# Standard amino-acid / gap tokens, in checkpoint vocabulary order
# (reference: esm/constants.py:7-9).
PROTEIN_TOKS: Tuple[str, ...] = (
    "L", "A", "G", "V", "S", "E", "R", "T", "I", "D", "P", "K", "Q", "N", "F",
    "Y", "M", "H", "W", "C", "X", "B", "U", "Z", "O", ".", "-",
)

RawMSA = Sequence[Tuple[str, str]]


class Alphabet:
    """Vocabulary with architecture-specific special tokens: prepend tokens,
    standard tokens, padding to a multiple of 8 with ``<null_i>``, then
    append tokens (reference esm/data.py:91-174)."""

    def __init__(
        self,
        standard_toks: Sequence[str],
        prepend_toks: Sequence[str] = ("<null_0>", "<pad>", "<eos>", "<unk>"),
        append_toks: Sequence[str] = ("<cls>", "<mask>", "<sep>"),
        prepend_bos: bool = True,
        append_eos: bool = False,
        use_msa: bool = False,
    ):
        self.standard_toks = list(standard_toks)
        self.prepend_toks = list(prepend_toks)
        self.append_toks = list(append_toks)
        self.prepend_bos = prepend_bos
        self.append_eos = append_eos
        self.use_msa = use_msa

        self.all_toks = list(self.prepend_toks)
        self.all_toks.extend(self.standard_toks)
        for i in range((8 - (len(self.all_toks) % 8)) % 8):
            self.all_toks.append(f"<null_{i + 1}>")
        self.all_toks.extend(self.append_toks)

        self.tok_to_idx = {tok: i for i, tok in enumerate(self.all_toks)}

        self.unk_idx = self.tok_to_idx["<unk>"]
        self.padding_idx = self.get_idx("<pad>")
        self.cls_idx = self.get_idx("<cls>")
        self.mask_idx = self.get_idx("<mask>")
        self.eos_idx = self.get_idx("<eos>")
        self.all_special_tokens = ["<eos>", "<unk>", "<pad>", "<cls>", "<mask>"]
        self.unique_no_split_tokens = self.all_toks
        self._byte_lut: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.all_toks)

    def get_idx(self, tok: str) -> int:
        return self.tok_to_idx.get(tok, self.unk_idx)

    def get_tok(self, ind: int) -> str:
        return self.all_toks[ind]

    def to_dict(self) -> dict:
        return self.tok_to_idx.copy()

    @classmethod
    def from_architecture(cls, name: str) -> "Alphabet":
        """Architecture-specific token layout (reference esm/data.py:143-174)."""
        if name in ("ESM-1", "protein_bert_base"):
            prepend: Tuple[str, ...] = ("<null_0>", "<pad>", "<eos>", "<unk>")
            append: Tuple[str, ...] = ("<cls>", "<mask>", "<sep>")
            prepend_bos, append_eos, use_msa = True, False, False
        elif name in ("ESM-1b", "roberta_large"):
            prepend = ("<cls>", "<pad>", "<eos>", "<unk>")
            append = ("<mask>",)
            prepend_bos, append_eos, use_msa = True, True, False
        elif name in ("MSA Transformer", "msa_transformer"):
            prepend = ("<cls>", "<pad>", "<eos>", "<unk>")
            append = ("<mask>",)
            prepend_bos, append_eos, use_msa = True, False, True
        elif "invariant_gvp" in name.lower():
            prepend = ("<null_0>", "<pad>", "<eos>", "<unk>")
            append = ("<mask>", "<cath>", "<af2>")
            prepend_bos, append_eos, use_msa = True, False, False
        else:
            raise ValueError(f"Unknown architecture {name!r}")
        return cls(PROTEIN_TOKS, prepend, append, prepend_bos, append_eos, use_msa)

    def tokenize(self, text: str) -> List[str]:
        """Split ``text`` into tokens: special (multi-char) vocabulary tokens
        are kept whole, everything between them is split on whitespace
        (reference esm/data.py:179-247, in one regex pass)."""
        specials = set(self.unique_no_split_tokens)
        pattern = "(" + "|".join(re.escape(t) for t in self.unique_no_split_tokens) + ")"
        out: List[str] = []
        for piece in re.split(pattern, text):
            if piece in specials:
                out.append(piece)
            else:
                out.extend(piece.split())
        return out

    def encode(self, text: str) -> List[int]:
        fast = self._encode_fast(text)
        if fast is not None:
            return fast
        return [self.tok_to_idx[tok] for tok in self.tokenize(text)]

    def byte_lut(self) -> np.ndarray:
        """256-entry int32 table from the ASCII byte of each single-character
        token to its id (-1: no such token); the table of the byte-LUT
        encoder and of the native bulk tokenizer
        (``esm_tpu_torch.native.tokenize_batch``)."""
        if self._byte_lut is None:
            lut = np.full(256, -1, dtype=np.int32)
            for tok, idx in self.tok_to_idx.items():
                if len(tok) == 1 and ord(tok) < 256:
                    lut[ord(tok)] = idx
            self._byte_lut = lut
        return self._byte_lut

    def _encode_fast(self, text: str) -> Optional[List[int]]:
        """Byte-LUT encoding for plain residue strings; any byte without a
        single-character token falls back to the exact tokenizer (including
        its KeyError on unknown residues)."""
        lut = self.byte_lut()
        try:
            raw = text.encode("ascii")
        except UnicodeEncodeError:
            return None
        ids = lut[np.frombuffer(raw, dtype=np.uint8)]
        if (ids < 0).any():
            return None
        return ids.tolist()

    def get_batch_converter(
        self, truncation_seq_length: Optional[int] = None, pad_to_multiple: int = 1
    ) -> "BatchConverter":
        if self.use_msa:
            return MSABatchConverter(self, truncation_seq_length, pad_to_multiple)
        return BatchConverter(self, truncation_seq_length, pad_to_multiple)


def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


class BatchConverter:
    """(label, str) batch -> (labels, strs, int64 token tensor): truncation,
    bos/eos insertion and pad fill (reference esm/data.py:253-297), plus
    ``pad_to_multiple`` on the sequence axis."""

    def __init__(
        self,
        alphabet: Alphabet,
        truncation_seq_length: Optional[int] = None,
        pad_to_multiple: int = 1,
    ):
        self.alphabet = alphabet
        self.truncation_seq_length = truncation_seq_length
        self.pad_to_multiple = pad_to_multiple

    def __call__(self, raw_batch: Sequence[Tuple[str, str]]):
        batch_size = len(raw_batch)
        batch_labels, seq_str_list = zip(*raw_batch)
        seq_encoded_list = [self.alphabet.encode(s) for s in seq_str_list]
        if self.truncation_seq_length:
            seq_encoded_list = [s[: self.truncation_seq_length] for s in seq_encoded_list]
        max_len = max(len(s) for s in seq_encoded_list)
        total = max_len + int(self.alphabet.prepend_bos) + int(self.alphabet.append_eos)
        if self.pad_to_multiple > 1:
            total = _round_up(total, self.pad_to_multiple)
        tokens = torch.full((batch_size, total), self.alphabet.padding_idx, dtype=torch.int64)
        offset = int(self.alphabet.prepend_bos)
        for i, seq_encoded in enumerate(seq_encoded_list):
            if self.alphabet.prepend_bos:
                tokens[i, 0] = self.alphabet.cls_idx
            tokens[i, offset : offset + len(seq_encoded)] = torch.as_tensor(
                seq_encoded, dtype=torch.int64
            )
            if self.alphabet.append_eos:
                tokens[i, offset + len(seq_encoded)] = self.alphabet.eos_idx
        return list(batch_labels), list(seq_str_list), tokens


class MSABatchConverter(BatchConverter):
    """One MSA or a batch of MSAs -> (labels, strs, (B, R, C) int64 token
    tensor), padded to the deepest and longest MSA; the rows of an MSA must
    all have one length (reference esm/data.py:300-336)."""

    def __call__(self, inputs: Union[Sequence[RawMSA], RawMSA]):
        raw_batch = [inputs] if isinstance(inputs[0][0], str) else inputs
        max_alignments = max(len(msa) for msa in raw_batch)
        max_seqlen = max(len(msa[0][1]) for msa in raw_batch)
        total = max_seqlen + int(self.alphabet.prepend_bos) + int(self.alphabet.append_eos)
        if self.pad_to_multiple > 1:
            total = _round_up(total, self.pad_to_multiple)
        tokens = torch.full((len(raw_batch), max_alignments, total), self.alphabet.padding_idx,
                            dtype=torch.int64)
        labels, strs = [], []
        for i, msa in enumerate(raw_batch):
            if len({len(seq) for _, seq in msa}) != 1:
                raise RuntimeError(
                    "Received unaligned sequences for input to MSA, all sequence "
                    "lengths must be equal."
                )
            msa_labels, msa_strs, msa_tokens = BatchConverter.__call__(self, msa)
            labels.append(msa_labels)
            strs.append(msa_strs)
            tokens[i, : msa_tokens.shape[0], : msa_tokens.shape[1]] = msa_tokens
        return labels, strs, tokens
