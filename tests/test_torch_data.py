"""The port's host-side modules against esm_tpu's on the same inputs:
alphabet and batch conversion, FASTA parsing and token-budget batching,
input validation, and the pipelined executor. Exact equality."""

import numpy as np
import pytest
import torch

from esm_tpu.data import alphabet as jalpha
from esm_tpu.data import fasta as jfasta
from esm_tpu.runtime import run_pipeline as jax_run_pipeline
from esm_tpu.utils import validation as jval
from esm_tpu_torch.data import alphabet as talpha
from esm_tpu_torch.data import fasta as tfasta
from esm_tpu_torch.runtime import run_pipeline
from esm_tpu_torch.utils import validation as tval

ARCHS = ["ESM-1", "ESM-1b", "MSA Transformer", "invariant_gvp"]


@pytest.mark.parametrize("arch", ARCHS)
def test_alphabet_tables(arch):
    a = talpha.Alphabet.from_architecture(arch)
    b = jalpha.Alphabet.from_architecture(arch)
    assert a.all_toks == b.all_toks
    for attr in ("padding_idx", "cls_idx", "mask_idx", "eos_idx", "unk_idx",
                 "prepend_bos", "append_eos", "use_msa"):
        assert getattr(a, attr) == getattr(b, attr), attr


@pytest.mark.parametrize("trunc,multiple", [(None, 1), (6, 1), (None, 8), (5, 16)])
def test_batch_converter(trunc, multiple):
    batch = [("x", "MKTAYIAK"), ("y", "GA<mask>VL"), ("z", "AC D E"), ("w", "M")]
    a = talpha.Alphabet.from_architecture("ESM-1b").get_batch_converter(trunc, multiple)
    b = jalpha.Alphabet.from_architecture("ESM-1b").get_batch_converter(trunc, multiple)
    la, sa, ta = a(batch)
    lb, sb, tb = b(batch)
    assert la == list(lb) and sa == list(sb)
    assert ta.dtype == torch.int64
    np.testing.assert_array_equal(ta.numpy(), tb)


def test_unknown_residue_raises_like_jax():
    with pytest.raises(KeyError):
        jalpha.Alphabet.from_architecture("ESM-1b").encode("MK<foo>")
    with pytest.raises(KeyError):
        talpha.Alphabet.from_architecture("ESM-1b").encode("MK<foo>")


def test_msa_converter_is_not_ported():
    """The MSA batch converter is ported now: the MSA alphabet returns
    MSABatchConverter, whose (B, R, C) tokens equal JAX's."""
    conv = talpha.Alphabet.from_architecture("MSA Transformer").get_batch_converter()
    assert isinstance(conv, talpha.MSABatchConverter)
    msa = [("a", "MKT-A"), ("b", "MRTQA")]
    ref = jalpha.Alphabet.from_architecture("MSA Transformer").get_batch_converter()(msa)[2]
    np.testing.assert_array_equal(conv(msa)[2].numpy(), np.asarray(ref))


@pytest.fixture
def fasta_file(tmp_path):
    rng = np.random.RandomState(0)
    path = tmp_path / "x.fasta"
    with open(path, "w") as f:
        for i in range(40):
            n = int(rng.randint(1, 300))
            seq = "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), n))
            label = f"seq{i} some description" if i % 7 else ""
            f.write(f">{label}\n")
            for j in range(0, n, 60):
                f.write(seq[j:j + 60] + "\n")
    return path


@pytest.mark.parametrize("budget,extra", [(1, 0), (512, 1), (4096, 2)])
def test_fasta_dataset_and_batches(fasta_file, budget, extra):
    a = tfasta.FastaBatchedDataset.from_file(fasta_file)
    b = jfasta.FastaBatchedDataset.from_file(fasta_file)
    assert a.sequence_labels == b.sequence_labels
    assert a.sequence_strs == b.sequence_strs
    assert a.get_batch_indices(budget, extra) == b.get_batch_indices(budget, extra)


def test_read_fasta(fasta_file):
    for kw in ({}, {"keep_gaps": False, "keep_insertions": False, "to_upper": True}):
        assert list(tfasta.read_fasta(fasta_file, **kw)) == list(jfasta.read_fasta(fasta_file, **kw))


@pytest.mark.parametrize(
    "tokens,err",
    [
        (np.zeros((2, 3, 4), np.int64), ValueError),
        (np.zeros((2, 3), np.float32), TypeError),
        (np.full((2, 3), 40), ValueError),
        (np.full((2, 3), -1), ValueError),
    ],
)
def test_check_tokens_errors(tokens, err):
    alpha = talpha.Alphabet.from_architecture("ESM-1b")
    with pytest.raises(err):
        jval.check_tokens(tokens, alpha)
    with pytest.raises(err):
        tval.check_tokens(tokens, alpha)
    with pytest.raises(err):
        tval.check_tokens(torch.from_numpy(tokens), alpha)


def test_check_tokens_accepts_valid():
    alpha = talpha.Alphabet.from_architecture("ESM-1b")
    t = torch.randint(0, len(alpha), (2, 5))
    assert tval.check_tokens(t, alpha) is t
    assert tval.check_tokens([[0, 1, 2]], alpha).shape == (1, 3)


@pytest.mark.parametrize("layers,err", [([7], ValueError), ([-8], ValueError), ([1.0], TypeError)])
def test_check_repr_layers(layers, err):
    with pytest.raises(err):
        jval.check_repr_layers(layers, 6)
    with pytest.raises(err):
        tval.check_repr_layers(layers, 6)
    tval.check_repr_layers([-7, 0, 6], 6)


def test_pipeline_matches_jax_executor():
    def run(fn):
        seen = []
        stats = fn(range(23), lambda i: i * 2, lambda x: x + 1,
                   lambda idx, item, prep, out: seen.append((idx, item, prep, out)),
                   prefetch=2, in_flight=3, writers=3)
        return sorted(seen), stats.batches
    assert run(run_pipeline) == run(jax_run_pipeline)


def test_pipeline_skips_failed_batches_on_request():
    def dispatch(x):
        if x == 6:
            raise RuntimeError("boom")
        return x

    seen = []
    stats = run_pipeline(range(5), lambda i: i * 2, dispatch,
                         lambda idx, item, prep, out: seen.append(out),
                         on_batch_error=lambda idx, item, err: True)
    assert sorted(seen) == [0, 2, 4, 8] and stats.failed == 1
    with pytest.raises(RuntimeError, match="boom"):
        run_pipeline(range(5), lambda i: i * 2, dispatch, lambda *a: None)
