"""The port's examples (esm_tpu_torch.examples) end to end on the CPU at
tiny sizes, and the modules they lean on: ESMFold fine-tuning on PDB files
(full and LoRA with the masked-LM auxiliary; its batches and its pad-safe
masking pattern: eos keeps its place on the shorter sequence of a batch),
secondary-structure fine-tuning (frozen LM and --train-lm), the int8 ESM-2
built one layer at a time against a bf16 copy of its weights, contact
prediction from a cached checkpoint, the structure-module-only ESMFold
constructors, and the profiling utilities.

Bounds: the int8 logits as esm_tpu's int8 tests hold them
(tests/test_quantization.py: 0.15 (max |ref| + 1), argmax agreement above
0.95); everything else is exact or a property (finite, falling, unchanged).
"""

import json
import re

import numpy as np
import pytest
import torch

from esm_tpu_torch import metrics, pretrained
from esm_tpu_torch.data import Alphabet
from esm_tpu_torch.examples import (
    contact_prediction,
    esm2_15b_int8_single_chip,
    esmfold_finetune,
    finetune_secondary_structure,
)
from esm_tpu_torch.io.export import save_esm2, save_esmfold
from esm_tpu_torch.models import esm2
from esm_tpu_torch.models import esmfold as ef
from esm_tpu_torch.models.esmfold import esmfold as tef
from esm_tpu_torch.utils import profiling

RESNAMES = ["ALA", "GLY", "SER", "LEU", "VAL", "THR", "GLU", "LYS", "ASP", "ILE", "PHE", "MET"]


def synth_backbone(seed, l):
    g = np.random.RandomState(seed)
    ca = np.cumsum(g.randn(l, 3) * 0.5 + np.array([3.8, 0.0, 0.0]), axis=0)
    n = ca + g.randn(l, 3) * 0.2 + np.array([-1.2, 0.6, 0.0])
    c = ca + g.randn(l, 3) * 0.2 + np.array([1.3, -0.6, 0.2])
    return np.stack([n, ca, c], axis=1)


def write_pdb(path, coords, resnames):
    """A standard-column PDB of N/CA/C backbone atoms."""
    lines, serial = [], 1
    for i in range(coords.shape[0]):
        for name, xyz in zip(("N", "CA", "C"), coords[i]):
            lines.append(f"ATOM  {serial:5d}  {name:<3s} {resnames[i]:>3s} A{i + 1:4d}    "
                         f"{xyz[0]:8.3f}{xyz[1]:8.3f}{xyz[2]:8.3f}  1.00  0.00           {name[0]}")
            serial += 1
    path.write_text("\n".join(lines) + "\nEND\n")


@pytest.fixture
def pdbs(tmp_path):
    d = tmp_path / "pdbs"
    d.mkdir()
    for f, length in enumerate((9, 6, 12)):
        names = [RESNAMES[(f + i) % len(RESNAMES)] for i in range(length)]
        write_pdb(d / f"s{f}.pdb", synth_backbone(20 + f, length), names)
    return d


# -- ESMFold fine-tuning -----------------------------------------------------------


@pytest.mark.parametrize("flags", [[], ["--lora", "--lm-aux-weight", "0.1", "--batch-size", "2"]])
def test_esmfold_finetune_runs(pdbs, flags, capsys):
    args = esmfold_finetune.create_parser().parse_args(
        ["--pdbs", str(pdbs), "--steps", "4", "--cpu", "--log-every", "1", "--lr", "1e-3"]
        + flags)
    state, losses = esmfold_finetune.main(args)
    out = capsys.readouterr().out
    assert "loaded 3 backbones, lengths [9, 6, 12]" in out
    printed = [float(x) for x in re.findall(r"loss (\S+)", out)]
    assert printed == [float(f"{x:.6f}") for x in losses] and len(losses) == 4
    assert all(np.isfinite(losses))
    if flags:
        assert "LoRA:" in out and "merged LoRA adapters" in out
        assert all(n.endswith(("lora_a", "lora_b")) for n, _ in state.model.named_parameters())
    else:
        assert not any(p.requires_grad for p in state.model.esm.parameters())


def test_esmfold_finetune_batches_cover_each_epoch():
    rng = np.random.RandomState(0)
    batches = esmfold_finetune.batch_indices(rng, 7, 3)
    for _ in range(3):  # an epoch: 2 contiguous slices of one shuffled order
        a, b = next(batches), next(batches)
        assert len(a) == len(b) == 3 and len(set(a) | set(b)) == 6
    small = esmfold_finetune.batch_indices(rng, 2, 3)
    assert sorted(set(next(small))) == [0, 1]


def _lm_tokens(model, cfg, aa, mask, pattern, monkeypatch):
    """The tokens ESMFold's LM receives for a batch."""
    seen = []
    real = tef.esm2.apply

    def spy(m, c, tokens, **kw):
        seen.append(tokens.clone())
        return real(m, c, tokens, **kw)

    monkeypatch.setattr(tef.esm2, "apply", spy)
    with torch.no_grad():
        tef.apply(model, cfg, aa, mask=mask, masking_pattern=pattern, num_recycles=0)
    monkeypatch.setattr(tef.esm2, "apply", real)
    return seen[0]


def test_lm_aux_pattern_keeps_eos_in_place(monkeypatch):
    cfg = esmfold_finetune.tiny_config(0)
    model = ef.init_esmfold(cfg, torch.Generator().manual_seed(0), device="cpu")
    aa, mask, _, _ = esmfold_finetune.encode(
        ["MKTAYIAKQR", "MKTA"], [np.zeros((10, 3, 3)), np.zeros((4, 3, 3))])
    pattern = esmfold_finetune.lm_aux_pattern(np.random.RandomState(1), mask)
    assert not pattern[mask == 0].any()
    pattern[1, 1] = 1  # one masked residue in the short row
    eos = cfg.esm.eos_idx
    toks = _lm_tokens(model, cfg, torch.from_numpy(aa), torch.from_numpy(mask),
                      torch.from_numpy(pattern), monkeypatch)
    assert toks[1, 4 + 1] == eos and toks[0, 10 + 1] == eos  # after bos and the residues
    assert toks[1, 2] == cfg.esm.mask_idx
    # the JAX example's pattern also marks padded columns: eos moves off the short row's end
    leaky = pattern.copy()
    leaky[1, 4:] = 1
    toks = _lm_tokens(model, cfg, torch.from_numpy(aa), torch.from_numpy(mask),
                      torch.from_numpy(leaky), monkeypatch)
    assert toks[1, 5] != eos


# -- secondary structure -------------------------------------------------------------


@pytest.mark.parametrize("train_lm", [False, True])
def test_secondary_structure_finetune_runs(train_lm, capsys):
    argv = ["--synthetic", "32", "--steps", "30", "--batch-size", "8", "--num-layers", "2",
            "--embed-dim", "32", "--attention-heads", "4", "--log-every", "10", "--cpu",
            "--lr", "1e-2"] + (["--train-lm"] if train_lm else [])
    args = finetune_secondary_structure.create_parser().parse_args(argv)
    lm0 = esm2.init(esm2.ESM2Config.from_alphabet(Alphabet.from_architecture("ESM-1b"),
                                                  num_layers=2, embed_dim=32, attention_heads=4),
                    torch.Generator().manual_seed(0), device="cpu")
    model, classes, losses = finetune_secondary_structure.run(args)
    assert classes == ["C", "E", "H"]
    assert "32 chains, 3 SS classes: CEH" in capsys.readouterr().out
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    same = all(torch.equal(p, lm0.state_dict()[k]) for k, p in model.lm.state_dict().items())
    assert same != train_lm  # the LM trains only with --train-lm


def test_secondary_structure_download_refused():
    args = finetune_secondary_structure.create_parser().parse_args(
        ["--download", "--root-path", "/nonexistent", "--cpu", "--num-layers", "1",
         "--embed-dim", "32", "--attention-heads", "4"])
    with pytest.raises(NotImplementedError, match="not ported"):
        finetune_secondary_structure.run(args)


# -- ESM-2 int8, built one layer at a time ---------------------------------------------


@pytest.fixture
def small_size(monkeypatch):
    """A registry entry whose linears reach quantize_params' 65,536 elements."""
    monkeypatch.setitem(esm2.ESM2_SIZES, "esm2_small_test",
                        dict(num_layers=2, embed_dim=256, attention_heads=4))
    return "esm2_small_test"


def test_int8_layerwise_build_against_bf16(small_size):
    handle, twin, alphabet = esm2_15b_int8_single_chip.seeded_esm2(
        small_size, 3, "cpu", bf16_copy=True)
    model = handle.model
    assert all(model.get_submodule(n).weight.dtype == torch.int8
               for n in ("layers.0.fc1", "layers.1.self_attn.q_proj", "lm_head.dense"))
    assert all(p.dtype == torch.bfloat16 for p in twin.model.parameters())
    assert twin.model.layers[1].self_attn.rot_emb.inv_freq.dtype == torch.float32
    assert not any(p.requires_grad for p in model.parameters())
    # the same weights: dequantized int8 within one quantization step of bf16's
    w, q = twin.model.layers[1].fc2.weight.float(), model.layers[1].fc2
    assert (q.weight.float() * q.scale[:, None] - w).abs().max() <= q.scale.max() * 0.51 + 1e-2
    tokens = alphabet.get_batch_converter()([("a", "MKTAYIAKQRQISFVKSHFSRQ")])[2]
    with torch.no_grad():
        ref = twin(tokens)["logits"].float()
        got = handle(tokens)["logits"].float()
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() < 0.15 * (ref.abs().max() + 1)
    assert (got.argmax(-1) == ref.argmax(-1)).float().mean() > 0.95


def test_int8_example_main(small_size, capsys):
    out = esm2_15b_int8_single_chip.main(["--model", small_size, "--random-seed", "0", "--cpu"])
    assert out["logits"].shape[:2] == (1, 67)
    assert "mean embedding[:4]" in capsys.readouterr().out


# -- contact prediction, structure-module-only constructors -------------------------------


def test_contact_prediction_example(tmp_path, capsys):
    handle, alphabet = pretrained.random_model_and_alphabet("esm2_t6_8M_UR50D", seed=1,
                                                            device="cpu")
    path = tmp_path / "esm2_t6_8M_UR50D.pt"
    save_esm2(handle.model, path)
    seqs = {"p1": "MKTVRQERLKSIVRILERSKEPVSGAQLAEELSV", "p2": "MKTAYIAKQRQISFVKSHFSRQLEERLGL"}
    (tmp_path / "s.fasta").write_text("".join(f">{k}\n{v}\n" for k, v in seqs.items()))
    true = (np.random.RandomState(2).rand(len(seqs["p1"]), len(seqs["p1"])) < 0.2)
    np.savez(tmp_path / "t.npz", p1=true.astype(np.float32))
    args = contact_prediction.create_parser().parse_args(
        ["--model", str(path), "--fasta", str(tmp_path / "s.fasta"), "--targets-npz",
         str(tmp_path / "t.npz"), "--cpu"])
    res = contact_prediction.main(args)
    out = capsys.readouterr().out
    want = metrics.contact_precision(res["p1"], true.astype(np.float32))
    assert f"p1: long-range precision@L = {want:.3f}" in out
    assert "p2: top contact pairs:" in out and res["p2"].shape == (29, 29)
    toks = alphabet.get_batch_converter()([("p2", seqs["p2"])])[2]
    with torch.no_grad():
        direct = handle.predict_contacts(toks)[0].numpy()
    np.testing.assert_allclose(res["p2"], direct, atol=1e-5)


@pytest.mark.parametrize("size", ["8M", "8M_270K"])
def test_structure_module_only_constructors(tmp_path, monkeypatch, size):
    lm_name = {"8M": "esm2_t6_8M_UR50D_500K", "8M_270K": "esm2_t6_8M_UR50D"}[size]
    cfg = ef.ESMFoldConfig(
        esm=esm2.ESM2Config.from_alphabet(Alphabet.from_architecture("ESM-1b"), num_layers=2,
                                          embed_dim=32, attention_heads=2),
        trunk=ef.FoldingTrunkConfig(
            num_blocks=0, sequence_state_dim=64, pairwise_state_dim=32, sequence_head_width=16,
            pairwise_head_width=16, max_recycles=1,
            structure_module=ef.StructureModuleConfig(c_s=32, c_z=32, c_ipa=8, c_resnet=16,
                                                      no_heads_ipa=4, no_blocks=2)),
        esm_type=f"esm2_{size}",
    )
    model = ef.init_esmfold(cfg, torch.Generator().manual_seed(0), device="cpu")
    save_esm2(model.esm, tmp_path / f"{lm_name}.pt")
    save_esmfold(model, tmp_path / f"esmfold_structure_module_only_{size}.pt")
    monkeypatch.setenv("ESM_TPU_CACHE", str(tmp_path))
    assert len(pretrained.SM_ONLY_SIZES) == 11
    handle = getattr(pretrained, f"esmfold_structure_module_only_{size}")(device="cpu")
    assert handle.cfg.trunk.num_blocks == 0 and len(handle.model.trunk.blocks) == 0
    got, want = handle.model.state_dict(), model.state_dict()
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
    out = handle.infer(["MKTAYIAKQR"])
    assert torch.isfinite(out["positions"]).all() and not out["positions"].requires_grad
    with pytest.raises(FileNotFoundError, match="not in the local cache"):
        pretrained.esmfold_structure_module_only_15B(device="cpu")


# -- profiling -------------------------------------------------------------------------------


def test_profiling_on_cpu(tmp_path):
    x = torch.randn(64, 64)
    with profiling.profile_trace(str(tmp_path / "trace")) as prof:
        (x @ x).sum()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    assert any("mm" in e.key for e in prof.key_averages())
    sec, out = profiling.timed(lambda a: a @ a, x, iters=3)
    assert sec > 0 and out.shape == (64, 64)
    assert profiling.timed_amortized(lambda: x @ x, iters=4, repeats=2) > 0
