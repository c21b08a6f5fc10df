"""The port's native FASTA loader (esm_tpu_torch.native) against esm_tpu.native
and against the port's pure-Python parser, on the inputs of tests/test_native.py;
its bulk tokenizer against esm_tpu's and the port's BatchConverter.

Both packages build their copy of fasta.cc with g++ at first use; a machine
without g++ has neither, and these tests then fail on ``available()``.
"""

import numpy as np
import pytest

from esm_tpu import native as jnative
from esm_tpu.data.fasta import FastaBatchedDataset as JaxFastaBatchedDataset
from esm_tpu_torch import native
from esm_tpu_torch.data import Alphabet
from esm_tpu_torch.data.fasta import FastaBatchedDataset

TRICKY = (
    "junk-before-header\n"
    ">seq1 description here\n"
    "MKTV\n"
    "  RQER \n"
    "\n"
    ">\n"
    "AAAA\r\n"
    ">   \n"
    "CCCC\n"
    ">last"
)
CASES = [
    TRICKY,
    "",
    "no header at all\njust junk\n",
    ">a\nAC\n",
    ">a\rAC\rGT\r",
    ">a\nAC",
    ">a\nAC\n>b\n>c\nGG\n",
    ">a\nAC\x1c\nGT\x1f\n",
]


def _large():
    rng = np.random.RandomState(0)
    aas = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)
    lines = []
    for i in range(500):
        s = bytes(aas[rng.randint(0, 20, int(rng.randint(1, 400)))]).decode()
        lines.append(f">rec{i} x={i}\n")
        lines.extend(s[j:j + 60] + "\n" for j in range(0, len(s), 60))
    return "".join(lines)


def _python_from_file(path, monkeypatch):
    with monkeypatch.context() as mp:
        mp.setattr(native, "parse_fasta", lambda _: None)
        return FastaBatchedDataset.from_file(path)


def test_available():
    assert native.available() and jnative.available()


@pytest.mark.parametrize("text", CASES + [_large()],
                         ids=[f"case{i}" for i in range(len(CASES))] + ["large"])
def test_parse_matches_esm_tpu_and_python(tmp_path, monkeypatch, text):
    p = tmp_path / "t.fasta"
    p.write_bytes(text.encode())
    got, want = native.parse_fasta(p), jnative.parse_fasta(p)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[1][: got[2][-1]], want[1][: want[2][-1]])
    ds = FastaBatchedDataset.from_file(p)
    assert hasattr(ds, "_seq_buf")
    jds = JaxFastaBatchedDataset.from_file(p)
    py = _python_from_file(p, monkeypatch)
    assert ds.sequence_labels == jds.sequence_labels == py.sequence_labels
    assert ds.sequence_strs == jds.sequence_strs == py.sequence_strs


def test_duplicate_labels_raise(tmp_path):
    p = tmp_path / "d.fasta"
    p.write_text(">a\nAC\n>a\nGT\n")
    with pytest.raises(AssertionError):
        FastaBatchedDataset.from_file(p)


def test_non_ascii_takes_the_python_path(tmp_path):
    p = tmp_path / "u.fasta"
    p.write_bytes(">prot\xc3\xa9ine one\nAC\n>second\nGT\n".encode("latin-1"))
    assert native.parse_fasta(p) is None
    ds = FastaBatchedDataset.from_file(p)
    assert ds.sequence_labels == ["protéine one", "second"]
    assert not hasattr(ds, "_seq_buf")
    p2 = tmp_path / "bad.fasta"
    p2.write_bytes(b">a\nAC\xffGT\n")
    assert native.parse_fasta(p2) is None
    with pytest.raises(UnicodeDecodeError):
        FastaBatchedDataset.from_file(p2)


@pytest.mark.parametrize("arch", ["ESM-1b", "ESM-1"])
@pytest.mark.parametrize("trunc", [None, 12])
def test_tokenize_batch_matches_esm_tpu_and_batch_converter(tmp_path, arch, trunc):
    from esm_tpu.data import Alphabet as JaxAlphabet

    alphabet, jalphabet = Alphabet.from_architecture(arch), JaxAlphabet.from_architecture(arch)
    np.testing.assert_array_equal(alphabet.byte_lut(), jalphabet.byte_lut())
    seqs = ["MKTVRQERLK", "ACDEFGHIKLMNPQRSTVWY", "GG", "KLMNPQRSTVWYACDE"]
    p = tmp_path / "s.fasta"
    p.write_text("".join(f">s{i}\n{s}\n" for i, s in enumerate(seqs)))
    ds = FastaBatchedDataset.from_file(p)
    want = alphabet.get_batch_converter(trunc)([(l, s) for l, s in ds])[2].numpy()
    kw = dict(truncation=trunc, bos=alphabet.cls_idx if alphabet.prepend_bos else -1,
              eos=alphabet.eos_idx if alphabet.append_eos else -1, pad=alphabet.padding_idx,
              stride=want.shape[1])
    order = np.array([2, 0, 3, 1])
    toks = native.tokenize_batch(ds._seq_buf, ds._seq_off, order, alphabet.byte_lut(), **kw)
    np.testing.assert_array_equal(toks, want[order])
    np.testing.assert_array_equal(
        toks, jnative.tokenize_batch(ds._seq_buf, ds._seq_off, order, jalphabet.byte_lut(), **kw))


def test_tokenize_batch_unmapped_byte_and_bad_indices():
    seq = np.frombuffer(b"AC1DE", dtype=np.uint8)  # '1' has no token
    off = np.array([0, 5], dtype=np.int64)
    lut = Alphabet.from_architecture("ESM-1b").byte_lut()
    assert native.tokenize_batch(seq, off, [0], lut, bos=0, eos=2, pad=1) is None
    with pytest.raises(IndexError):
        native.tokenize_batch(seq, off, [1], lut)
