"""Sequence parallelism of the port (esm_tpu_torch.parallel, esm2.apply_seq_sharded,
training.train_step_seq) against esm_tpu on the CPU.

The port's ranks are processes spawned over a gloo group
(tests/_torch_ring_ranks.py, which imports no JAX); esm_tpu runs on its
8-device virtual mesh (tests/conftest.py). Each rank cuts its shard of
esm_tpu's full results with ``local_shard`` and the comparisons run here.

Tolerances (fp32 on both sides; summation order and the block-wise
softmax combine): ring attention's output 2e-5, its gradients 3e-5
(against jax.grad of esm_tpu's dense attention, as tests/test_sharding.py
holds esm_tpu's own ring); logits (with rtol 1e-5) and representations
2e-5; a training step's loss 1e-5 and its updated parameters 2e-5.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ring_ranks import model_body, ring_body, spawn, train_body
from esm_tpu import training as jtraining
from esm_tpu.data import Alphabet as JaxAlphabet
from esm_tpu.models import esm2 as jesm2
from esm_tpu.ops.common import softmax_fp32
from esm_tpu.parallel import mesh as jmesh
from esm_tpu.parallel.ring_attention import ring_attention as jring_attention
from esm_tpu_torch.io.from_jax import esm2_state_dict_from_jax
from esm_tpu_torch.parallel import mesh as tmesh

SIZE = dict(num_layers=2, embed_dim=64, attention_heads=4)
OUT_TOL, GRAD_TOL, MODEL_TOL = 2e-5, 3e-5, 2e-5
MESHES = ((1, 1, 4), (1, 2, 2))


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_mesh(shape):
    return jmesh.make_mesh(jmesh.MeshConfig(*shape))


def _attention_inputs():
    rng = np.random.RandomState(7)
    b, h, t, d = 2, 4, 64, 16
    q = (rng.randn(b, h, t, d) * 0.3).astype(np.float32)
    k, v, w = (rng.randn(b, h, t, d).astype(np.float32) for _ in range(3))
    mask = np.zeros((b, t), bool)
    mask[0, 50:] = True
    mask_dead = mask.copy()
    mask_dead[1] = True  # a row whose keys are all padding
    w_ragged = w * (~mask)[:, None, :, None]
    w_dead = w_ragged.copy()
    w_dead[1] = w[1]  # a nonzero cotangent on the dead row
    return q, k, v, mask, mask_dead, w_ragged, w_dead


def _dense_grads(q, k, v, mask, w):
    def loss(q, k, v):
        logits = jnp.einsum("bhqd,bhkd->bhqk", q, k)
        logits = jnp.where(jnp.asarray(mask)[:, None, None, :], -jnp.inf, logits)
        return jnp.sum(jnp.einsum("bhqk,bhkd->bhqd", softmax_fp32(logits), v) * w)

    return jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


def _ring_results(world, tmp_path):
    q, k, v, mask, mask_dead, w_ragged, w_dead = _attention_inputs()
    mesh = _jax_mesh((1, 1, world))
    grads = _dense_grads(q, k, v, mask, w_ragged)
    inputs = {"q": _t(q), "k": _t(k), "v": _t(v), "mask": _t(mask), "mask_dead": _t(mask_dead),
              "w_ragged": _t(w_ragged), "w_dead": _t(w_dead)}
    for use_flash in (False, True):
        name = "flash" if use_flash else "exact"
        out = jring_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mesh,
                              key_padding_mask=jnp.asarray(mask), use_flash=use_flash)
        want = {"out": _t(out), "dq": _t(grads[0]), "dk": _t(grads[1]), "dv": _t(grads[2])}
        for n, x in want.items():
            inputs[f"ragged/{name}_{n}"] = x
            dead = x.clone()
            dead[1] = 0.0  # the dead row: zeros out, zero gradients
            inputs[f"dead_row/{name}_{n}"] = dead
    return spawn(ring_body, world, inputs, tmp_path)


@pytest.fixture(scope="module")
def ring2(tmp_path_factory):
    return _ring_results(2, tmp_path_factory.mktemp("ring2"))


@pytest.fixture(scope="module")
def ring4(tmp_path_factory):
    return _ring_results(4, tmp_path_factory.mktemp("ring4"))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("path", ["exact", "flash"])
def test_ring_attention_matches_esm_tpu(ring2, ring4, world, path):
    """Output against esm_tpu's ring_attention, q/k/v gradients against
    jax.grad of esm_tpu's dense attention, on every rank's shard."""
    for rank, res in enumerate(ring2 if world == 2 else ring4):
        got = res[f"ragged/{path}"]
        for name, tol in (("out", OUT_TOL), ("dq", GRAD_TOL), ("dk", GRAD_TOL),
                          ("dv", GRAD_TOL)):
            np.testing.assert_allclose(got[name].numpy(), got[f"want_{name}"].numpy(),
                                       atol=tol, err_msg=f"rank {rank} {name}")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("path", ["exact", "flash"])
def test_ring_attention_dead_row(ring2, ring4, world, path):
    """A batch row whose keys are all padding comes out as exact zeros, and a
    nonzero cotangent on it gives exact zero gradients; the other row is
    unaffected."""
    for rank, res in enumerate(ring2 if world == 2 else ring4):
        got = res[f"dead_row/{path}"]
        for name, tol in (("out", OUT_TOL), ("dq", GRAD_TOL), ("dk", GRAD_TOL),
                          ("dv", GRAD_TOL)):
            x = got[name].numpy()
            assert np.isfinite(x).all(), (rank, name)
            np.testing.assert_array_equal(x[1], 0.0, err_msg=f"rank {rank} {name}")
            np.testing.assert_allclose(x, got[f"want_{name}"].numpy(), atol=tol,
                                       err_msg=f"rank {rank} {name}")


def _lm_setup():
    jalpha = JaxAlphabet.from_architecture("ESM-1b")
    jcfg = jesm2.ESM2Config.from_alphabet(jalpha, **SIZE)
    params = jesm2.init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.RandomState(1)
    params["lm_head"]["bias"] = jnp.asarray(rng.randn(len(jalpha)).astype(np.float32) * 0.1)
    seqs = [("s%d" % i, "KALTARQQEVFDLIRDHISQTGMPPTRAEIA"[: 14 + 5 * i]) for i in range(4)]
    toks = np.array(jalpha.get_batch_converter(pad_to_multiple=8)(seqs)[2])
    assert toks.shape == (4, 32), toks.shape
    # <mask> tokens crowded into the first block of 8 columns of row 0 and
    # the last real block of row 3: the shards' shares differ from the row's
    toks[0, 1:7] = jalpha.mask_idx
    toks[3, 25:31] = jalpha.mask_idx
    state_dict = esm2_state_dict_from_jax(jax.tree.map(np.asarray, params), jcfg)
    return jcfg, params, toks, state_dict


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    jcfg, params, toks, state_dict = _lm_setup()
    inputs = {"size": SIZE, "state_dict": state_dict, "tokens": _t(toks).long(),
              "meshes": MESHES}
    # esm_tpu's own sequence-sharded forward (its flash and exact rings give
    # the same numbers within 1e-6; the exact one is held to here)
    out = jesm2.apply_seq_sharded(params, jcfg, jnp.asarray(toks), mesh=_jax_mesh((1, 1, 4)),
                                  seq_axis="tp", return_representations=True)
    inputs["logits"], inputs["reps"] = _t(out["logits"]), _t(out["representations"])
    return spawn(model_body, 4, inputs, tmp_path_factory.mktemp("lm"))


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("path", ["exact", "flash"])
def test_apply_seq_sharded_matches_esm_tpu(lm, shape, path):
    for rank, res in enumerate(lm):
        got = res[f"{shape}/{path}"]
        np.testing.assert_allclose(got["logits"].numpy(), got["want_logits"].numpy(),
                                   atol=MODEL_TOL, rtol=1e-5, err_msg=f"rank {rank}")
        np.testing.assert_allclose(got["reps"].numpy(), got["want_reps"].numpy(),
                                   atol=MODEL_TOL, err_msg=f"rank {rank}")


@pytest.mark.parametrize("shape", MESHES)
def test_token_dropout_counts_are_global(lm, shape):
    """The same forward with each shard counting its own <mask> tokens and
    lengths misses esm_tpu's logits by far more than the tolerance: the
    all-reduced counts are what the comparison above holds."""
    worst = max(np.nanmax(np.abs(r[f"{shape}/local_counts"]["logits"].numpy()
                                 - r[f"{shape}/local_counts"]["want_logits"].numpy()))
                for r in lm)  # (a shard of padding alone divides 0 by 0)
    assert worst > 100 * MODEL_TOL, worst


@pytest.mark.parametrize("shape", MESHES)
def test_apply_seq_sharded_refuses_contacts(lm, shape):
    for res in lm:
        assert "ring" in res[f"{shape}/contacts"], res[f"{shape}/contacts"]


def test_hybrid_mesh_keeps_tp_inside_a_host(lm):
    """make_hybrid_mesh over 4 ranks numbered host by host, 2 a host: one
    data slice a host, the tp groups within a host; a mesh that would put
    tp across hosts is refused."""
    for rank, res in enumerate(lm):
        got = res["hybrid"]
        assert got["shape"] == (2, 1, 2) and got["names"] == ("data", "fsdp", "tp")
        assert got["tp_ranks"] == ([0, 1] if rank < 2 else [2, 3])
        assert "multiple of the host count" in got["one_data_slice"]


@pytest.fixture(scope="module")
def jax_step():
    jcfg, params, toks, state_dict = _lm_setup()
    rng = jax.random.PRNGKey(5)
    corrupted, target_mask = jtraining._corrupt_batch(jcfg, rng, jnp.asarray(toks))
    tx = jtraining.make_optimizer(1e-3, warmup_steps=0, total_steps=10)
    state = jtraining.init_state(jax.tree.map(jnp.array, params), tx)
    state, metrics = jtraining.train_step_seq(state, jcfg, tx, rng, jnp.asarray(toks),
                                              mesh=_jax_mesh((1, 2, 2)), seq_axis="tp")
    return dict(jcfg=jcfg, state_dict=state_dict, toks=toks, corrupted=corrupted,
                target_mask=target_mask, loss=float(metrics["loss"]),
                params=esm2_state_dict_from_jax(jax.tree.map(np.asarray, state.params), jcfg))


@pytest.mark.parametrize("shape,options", [
    ((1, 2, 1), {}),                                                       # a ring of one
    ((1, 2, 2), {"use_flash": True, "remat": True, "remat_policy": "dots"}),
], ids=["ring1-exact", "ring2-flash-remat"])
def test_train_step_seq_matches_esm_tpu(jax_step, tmp_path, shape, options):
    """train_step_seq_corrupted on esm_tpu's corruption against
    esm_tpu.training.train_step_seq: the loss, and every parameter after the
    AdamW update, equal on every rank."""
    inputs = {"size": SIZE, "state_dict": jax_step["state_dict"], "mesh": shape,
              "options": options, "tokens": _t(jax_step["toks"]).long(),
              "corrupted": _t(jax_step["corrupted"]).long(),
              "target_mask": _t(jax_step["target_mask"])}
    results = spawn(train_body, shape[0] * shape[1] * shape[2], inputs, tmp_path)
    for rank, res in enumerate(results):
        np.testing.assert_allclose(res["metrics"]["loss"], jax_step["loss"], atol=1e-5)
        for name, p in res["params"].items():
            np.testing.assert_allclose(p.numpy(), jax_step["params"][name].numpy(), atol=2e-5,
                                       err_msg=f"rank {rank} {name}")


def test_mesh_config_for_devices_matches_esm_tpu():
    for n in range(1, 17):
        want, got = jmesh.MeshConfig.for_devices(n), tmesh.MeshConfig.for_devices(n)
        assert (got.shape, got.num_devices) == (want.shape, want.num_devices), n
