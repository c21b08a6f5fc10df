"""The port's ESMFold (esm_tpu_torch.models.esmfold) against esm_tpu's on the
CPU: rigid ops, the structure module, one trunk block, and whole ``infer``
runs at a tiny size (LM 2 x 32, 2 trunk blocks, c_s 64, c_z 32, head width
16, structure module 2 blocks), on the same weights: esm_tpu's
``init_esmfold`` params carried across by ``esmfold_state_dict_from_jax``.

The JAX init zero-initializes the last layer of every residual branch, so
the triangle ops would add exactly zero and a wrong kernel would pass; the
all-zero tensors are re-drawn with seeded noise before both sides run (as
tests/test_esmfold_trunk.py:310-312 does to the HF oracle).

fp32 throughout, real rows only (padding and multimer linkers excluded).
Tolerances, from the fp32 differences in summation order and
transcendentals, grown through the blocks, recycles and the structure
module's geometry: positions 1e-3 Å, pLDDT 1e-3 (0-100 scale), pTM 1e-4,
PAE 1e-3 Å; per-op checks 2e-5 (rigid ops 1e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esm_tpu.data import Alphabet as JaxAlphabet
from esm_tpu.models import esm2 as jesm2
from esm_tpu.models import esmfold as jef
from esm_tpu.models.esmfold import blocks as jblocks
from esm_tpu.models.esmfold import structure_module as jsm
from esm_tpu.models.esmfold import trunk as jtrunk
from esm_tpu.models.esmfold.protein import output_to_pdb as jax_output_to_pdb
from esm_tpu.ops import rigid as jrg
from esm_tpu_torch.data import Alphabet
from esm_tpu_torch.io.from_jax import esmfold_state_dict_from_jax
from esm_tpu_torch.kernels import triangle_attention as ta
from esm_tpu_torch.models import esm2 as tesm2
from esm_tpu_torch.models import esmfold as tef
from esm_tpu_torch.models.esmfold import blocks as tblocks
from esm_tpu_torch.models.esmfold import structure_module as tsm
from esm_tpu_torch.models.esmfold import trunk as ttrunk
from esm_tpu_torch.models.esmfold.protein import output_to_pdb
from esm_tpu_torch.ops import rigid as trg

SEQS = ["MKTVRQERLKAYTRQELAEW", "MKTAY:RQELSG"]  # ragged, and a multimer
TOL = {"positions": 1e-3, "plddt": 1e-3, "ptm": 1e-4, "predicted_aligned_error": 1e-3,
       "mean_plddt": 1e-3}


def _sizes(lib, alphabet, use_esm_attn_map=False):
    return lib.ESMFoldConfig(
        esm=(jesm2 if lib is jef else tesm2).ESM2Config.from_alphabet(
            alphabet, num_layers=2, embed_dim=32, attention_heads=2),
        trunk=lib.FoldingTrunkConfig(
            num_blocks=2, sequence_state_dim=64, pairwise_state_dim=32, sequence_head_width=16,
            pairwise_head_width=16, max_recycles=2,
            structure_module=lib.StructureModuleConfig(
                c_s=32, c_z=32, c_ipa=8, c_resnet=16, no_heads_ipa=4, no_blocks=2)),
        use_esm_attn_map=use_esm_attn_map,
    )


def redraw_zeros(params, seed):
    """Every all-zero float tensor of an esm_tpu param tree, re-drawn with
    seeded noise: kernels ~ N(0, 1/(4 fan_in)), other tensors ~ N(0, 0.01)."""
    rng = np.random.RandomState(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif isinstance(v, list):
                out[k] = [walk(x) for x in v]
            else:
                a = np.asarray(v)
                if a.dtype.kind == "f" and a.size and not a.any():
                    scale = 0.5 * a.shape[-2] ** -0.5 if k == "kernel" else 0.1
                    a = (rng.randn(*a.shape) * scale).astype(a.dtype)
                out[k] = a
        return out

    return walk(params)


def build(use_esm_attn_map=False, seed=0):
    jalpha = JaxAlphabet.from_architecture("ESM-1b")
    jcfg = _sizes(jef, jalpha, use_esm_attn_map)
    params = redraw_zeros(jax.tree.map(np.asarray, jef.init_esmfold(
        jax.random.PRNGKey(seed), jcfg, jalpha)), seed + 1)
    cfg = _sizes(tef, Alphabet.from_architecture("ESM-1b"), use_esm_attn_map)
    model = tef.ESMFold(cfg, device="cpu")
    model.load_state_dict(esmfold_state_dict_from_jax(params, cfg), strict=True)
    return jcfg, jax.tree.map(jnp.asarray, params), params, cfg, model


@pytest.fixture(scope="module")
def models():
    return build()


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, atol, where=None):
    got, want = _np(got), _np(want)
    if where is not None:
        got, want = got[where], want[where]
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def _rigid(rng, shape):
    q = rng.randn(*shape, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    rots = np.array(jrg.quat_to_rot(jnp.asarray(q)))
    return rots, rng.randn(*shape, 3).astype(np.float32)


def test_rigid_ops_match():
    rng = np.random.RandomState(0)
    (ra, ta_), (rb, tb) = _rigid(rng, (3, 5)), _rigid(rng, (3, 5))
    pts = rng.randn(3, 5, 3).astype(np.float32)
    upd = (rng.randn(3, 5, 6) * 0.3).astype(np.float32)
    ja, jb = jrg.Rigid(jnp.asarray(ra), jnp.asarray(ta_)), jrg.Rigid(jnp.asarray(rb), jnp.asarray(tb))
    a, b = trg.Rigid(torch.from_numpy(ra), torch.from_numpy(ta_)), trg.Rigid(
        torch.from_numpy(rb), torch.from_numpy(tb))
    tp = torch.from_numpy(pts)
    pairs = [
        (trg.apply(a, tp), jrg.apply(ja, jnp.asarray(pts))),
        (trg.invert_apply(a, tp), jrg.invert_apply(ja, jnp.asarray(pts))),
        (trg.compose(a, b).rots, jrg.compose(ja, jb).rots),
        (trg.compose(a, b).trans, jrg.compose(ja, jb).trans),
        (trg.compose_q_update_vec(a, torch.from_numpy(upd)).rots,
         jrg.compose_q_update_vec(ja, jnp.asarray(upd)).rots),
        (trg.compose_q_update_vec(a, torch.from_numpy(upd)).trans,
         jrg.compose_q_update_vec(ja, jnp.asarray(upd)).trans),
        (trg.to_tensor_7(a), jrg.to_tensor_7(ja)),
        (trg.to_tensor_4x4(a), jrg.to_tensor_4x4(ja)),
        (trg.from_tensor_4x4(trg.to_tensor_4x4(a)).rots, ra),
    ]
    for got, want in pairs:
        _close(got, want, 1e-5)


def test_structure_module_matches(models):
    jcfg, jparams, _, cfg, model = models
    rng = np.random.RandomState(1)
    b, l = 2, 11
    s = rng.randn(b, l, 32).astype(np.float32)
    z = rng.randn(b, l, l, 32).astype(np.float32)
    aa = rng.randint(0, 21, (b, l))
    mask = np.ones((b, l), np.float32)
    mask[1, 8:] = 0
    want = jsm.structure_module_apply(jparams["trunk"]["structure_module"],
                                      jcfg.trunk.structure_module, jnp.asarray(s), jnp.asarray(z),
                                      jnp.asarray(aa), jnp.asarray(mask))
    with torch.no_grad():
        got = tsm.structure_module_apply(model.trunk.structure_module, cfg.trunk.structure_module,
                                         torch.from_numpy(s), torch.from_numpy(z),
                                         torch.from_numpy(aa), torch.from_numpy(mask))
    assert set(got) == set(want)
    real = mask.astype(bool)
    for k in ("frames", "sidechain_frames", "angles", "unnormalized_angles", "positions",
              "states"):
        _close(got[k][:, real], np.asarray(want[k])[:, real], 1e-4)


@pytest.mark.parametrize("use_flash_tri", [False, True])
def test_trunk_block_matches(models, use_flash_tri):
    jcfg, jparams, _, cfg, model = models
    rng = np.random.RandomState(2)
    b, l = 2, 9
    s = rng.randn(b, l, 64).astype(np.float32)
    z = rng.randn(b, l, l, 32).astype(np.float32)
    mask = np.ones((b, l), np.int64)
    mask[1, 7:] = 0
    block = jax.tree.map(lambda x: x[1], jparams["trunk"]["blocks"])
    js, jz = jblocks.triangular_self_attention_block(
        block, jnp.asarray(s), jnp.asarray(z), seq_heads=4, pair_heads=2,
        mask=jnp.asarray(mask), use_flash_tri=use_flash_tri)
    with torch.no_grad():
        ts, tz = tblocks.triangular_self_attention_block(
            model.trunk.blocks[1], torch.from_numpy(s), torch.from_numpy(z), seq_heads=4,
            pair_heads=2, mask=torch.from_numpy(mask), use_flash_tri=use_flash_tri)
    real = mask.astype(bool)
    _close(ts[real], np.asarray(js)[real], 2e-5)
    pair = real[:, :, None] & real[:, None, :]
    _close(tz[pair], np.asarray(jz)[pair], 2e-5)


def test_distogram_bins_match():
    coords = np.random.RandomState(3).randn(2, 7, 3, 3).astype(np.float32) * 6
    want = jtrunk.distogram_bins(jnp.asarray(coords))
    assert np.array_equal(ttrunk.distogram_bins(torch.from_numpy(coords)).numpy(), want)


def _compare_infer(got, want, multimer_rows=True):
    exists = _np(want["atom37_atom_exists"]).max(-1) > 0  # real residues (not pads/linkers)
    assert np.array_equal(_np(got["atom37_atom_exists"]).max(-1) > 0, exists)
    pair = exists[:, :, None] & exists[:, None, :]
    _close(got["positions"][-1][exists], np.asarray(want["positions"])[-1][exists],
           TOL["positions"])
    _close(got["plddt"][exists], np.asarray(want["plddt"])[exists], TOL["plddt"])
    _close(got["predicted_aligned_error"][pair],
           np.asarray(want["predicted_aligned_error"])[pair], TOL["predicted_aligned_error"])
    for k in ("ptm", "mean_plddt"):
        _close(got[k], want[k], TOL[k])


@pytest.mark.parametrize("num_recycles", [0, 2])
def test_infer_matches(models, num_recycles):
    jcfg, jparams, _, cfg, model = models
    want = jef.infer(jparams, jcfg, SEQS, num_recycles=num_recycles)
    got = tef.infer(model, cfg, SEQS, num_recycles=num_recycles)
    _compare_infer(got, want)
    assert got["positions"].shape == tuple(want["positions"].shape)


def test_infer_fused_triangle_matches(models):
    """use_flash_tri: the port's K6 plain version against esm_tpu's Pallas
    kernel (interpret), whole fold."""
    jcfg, jparams, _, cfg, model = models
    jcfg = dataclasses.replace(jcfg, trunk=dataclasses.replace(jcfg.trunk, use_flash_tri=True))
    cfg = dataclasses.replace(cfg, trunk=dataclasses.replace(cfg.trunk, use_flash_tri=True))
    want = jef.infer(jparams, jcfg, SEQS, num_recycles=1)
    before = ta.triangle_attention_fused.launches
    got = tef.infer(model, cfg, SEQS, num_recycles=1)
    assert ta.triangle_attention_fused.launches == before  # the plain version on the CPU
    _compare_infer(got, want)


def test_infer_frugal_and_bucketed(models):
    """frugal drops the O(L^2) diagnostics and changes nothing kept;
    pad_to_multiple=16 changes nothing on real rows, nor the PDB text."""
    jcfg, jparams, _, cfg, model = models
    out = tef.infer(model, cfg, SEQS, num_recycles=0)
    frugal = tef.infer(model, cfg, SEQS, num_recycles=0, frugal=True)
    for k in ("s_z", "distogram_logits", "ptm_logits", "aligned_confidence_probs", "states",
              "lddt_head"):
        assert k in out and k not in frugal, k
    for k in ("positions", "plddt", "ptm", "predicted_aligned_error", "mean_plddt"):
        assert torch.equal(frugal[k], out[k]), k
    bucketed = tef.infer(model, cfg, SEQS, num_recycles=0, pad_to_multiple=16)
    want = jef.infer(jparams, jcfg, SEQS, num_recycles=0, pad_to_multiple=16)
    L = out["positions"].shape[-3]
    assert bucketed["positions"].shape[-3] == -(-L // 16) * 16
    real = _np(out["atom37_atom_exists"]).max(-1) > 0
    _close(bucketed["positions"][-1, :, :L][real], out["positions"][-1][real], 2e-4)
    _compare_infer(bucketed, want)
    for a, b in zip(output_to_pdb(bucketed), output_to_pdb(out)):
        _assert_pdb_close(a, b)


def _assert_pdb_close(a: str, b: str):
    """The same records, atoms and residues; coordinates and B-factors equal
    to their last printed digit (values within 2e-4 can round apart)."""
    la, lb = a.splitlines(), b.splitlines()
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if not x.startswith("ATOM"):
            assert x == y
            continue
        assert x[:30] == y[:30] and x[66:] == y[66:]
        vx = [float(x[i:i + 8]) for i in (30, 38, 46)] + [float(x[60:66])]
        vy = [float(y[i:i + 8]) for i in (30, 38, 46)] + [float(y[60:66])]
        np.testing.assert_allclose(vx, vy, atol=0.011, rtol=0)


def test_infer_esm_attn_map_matches():
    """v0's pair features from the LM's attention maps (need_head_weights)."""
    jcfg, jparams, _, cfg, model = build(use_esm_attn_map=True, seed=5)
    want = jef.infer(jparams, jcfg, SEQS[:1], num_recycles=0)
    got = tef.infer(model, cfg, SEQS[:1], num_recycles=0)
    _compare_infer(got, want)


def test_output_to_pdb_text_matches_jax(models):
    """The same output arrays through both writers give the same text."""
    jcfg, jparams, _, _, _ = models
    want = jef.infer(jparams, jcfg, SEQS, num_recycles=0)
    arrays = {k: np.array(want[k]) for k in ("aatype", "positions", "atom37_atom_exists",
                                               "residue_index", "plddt", "chain_index")}
    got = output_to_pdb({k: torch.from_numpy(v) for k, v in arrays.items()})
    assert got == jax_output_to_pdb(arrays)
    assert "TER" in got[1] and got[1].count("TER") == 2  # two chains, linker dropped


def test_encoding_matches():
    for seq in ("MKTX", "MK:TAY:G", "ACDEFGHIKLMNPQRSTVWYB"):
        for got, want in zip(tef.encode_sequence(seq), jef.encode_sequence(seq)):
            assert np.array_equal(got, want)
    got = tef.batch_encode_sequences(SEQS)
    for g, w in zip(got, jef.batch_encode_sequences(SEQS)):
        assert np.array_equal(g, w)
    assert tef.auto_frugal(1, 1100) == jef.auto_frugal(1, 1100)
