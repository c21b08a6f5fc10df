"""GPipe pipeline parallelism of the port (esm_tpu_torch.parallel.pipeline,
esm2.apply_pipelined, training.train_step_pp) against esm_tpu on the CPU.

The port's ranks are 8 processes spawned over a gloo group
(tests/_torch_shard_ranks.py, no JAX); esm_tpu runs its own pipeline on its
8-device virtual mesh (tests/conftest.py). Meshes (pp, data, fsdp, tp):
(2, 1, 2, 2), two stages with fsdp and tp inside each, and (4, 1, 1, 2),
four stages; microbatches M in {1, 2, 4}. A 4-layer ESM-2, width 64, 4 heads.

Tolerances: esm_tpu's, atol 2e-5 and rtol 1e-5 (tests/test_pipeline.py),
for the logits, the step's loss, each stage's gathered gradients and its
updated parameters. train_step_pp is held to esm_tpu's train_step_pp on its
pp mesh: its loss and updated parameters; the gradients (which it does not
return) to jax.grad of esm_tpu's one-device loss. As in
tests/test_torch_sharding.py, both optimizers take esm_tpu's gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_shard_ranks import pipeline_body, spawn, train_body
from esm_tpu import training as jtraining
from esm_tpu.data import Alphabet as JaxAlphabet
from esm_tpu.models import esm2 as jesm2
from esm_tpu.parallel import pipeline as jpipeline
from esm_tpu_torch.io.from_jax import esm2_state_dict_from_jax

SIZE = dict(num_layers=4, embed_dim=64, attention_heads=4)
TOL = dict(atol=2e-5, rtol=1e-5)
MESHES = ((2, 1, 2, 2), (4, 1, 1, 2))
CASES = tuple((shape, m) for shape in MESHES for m in (1, 2, 4))
PP_STEPS = (("pp2-fsdp2-tp2", (2, 1, 2, 2), 2, {}),
            ("pp4-tp2-remat", (4, 1, 1, 2), 4, {"remat": True, "use_flash": True}))


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_mesh(shape):
    pp, data, fsdp, tp = shape
    return jpipeline.make_pp_mesh(pp=pp, data=data, fsdp=fsdp, tp=tp)


@pytest.fixture(scope="module")
def lm():
    jalpha = JaxAlphabet.from_architecture("ESM-1b")
    jcfg = jesm2.ESM2Config.from_alphabet(jalpha, **SIZE)
    params = jesm2.init(jax.random.PRNGKey(0), jcfg)
    params["lm_head"]["bias"] = jnp.asarray(
        np.random.RandomState(1).randn(len(jalpha)).astype(np.float32) * 0.1)
    seqs = [("s%d" % i, "KALTARQQEVFDLIRDHISQTGMPPTRAEIA"[: 8 + 2 * i]) for i in range(8)]
    toks = np.array(jalpha.get_batch_converter(pad_to_multiple=8)(seqs)[2])
    six = jesm2.init(jax.random.PRNGKey(0), jesm2.ESM2Config.from_alphabet(
        jalpha, **dict(SIZE, num_layers=6)))
    return dict(jcfg=jcfg, params=params, toks=toks,
                state_dict=esm2_state_dict_from_jax(_np(params), jcfg),
                six_layers=esm2_state_dict_from_jax(_np(six), jesm2.ESM2Config.from_alphabet(
                    jalpha, **dict(SIZE, num_layers=6))))


def _copy(params):
    return jax.tree.map(jnp.array, params)


@pytest.fixture(scope="module")
def forward(lm, tmp_path_factory):
    want = {}
    for shape, m in CASES:
        mesh = _jax_mesh(shape)
        want[(shape, m)] = _t(jesm2.apply_pipelined(
            jpipeline.shard_params_pp(mesh, _copy(lm["params"])), lm["jcfg"],
            jnp.asarray(lm["toks"]), mesh=mesh, num_microbatches=m)["logits"])
    inputs = dict(size=SIZE, state_dict=lm["state_dict"], six_layers=lm["six_layers"],
                  tokens=_t(lm["toks"]).long(), cases=CASES, want=want)
    return spawn(pipeline_body, 8, inputs, tmp_path_factory.mktemp("pp"))


@pytest.mark.parametrize("shape,m", CASES)
def test_apply_pipelined_matches_esm_tpu(forward, shape, m):
    """Every stage returns the logits of its rows (the last stage's output,
    sent to all)."""
    for rank, res in enumerate(forward):
        got = res[(shape, m)]
        np.testing.assert_allclose(got["logits"].numpy(), got["want"].numpy(), **TOL,
                                   err_msg=f"rank {rank}")


def test_pipeline_validates(forward):
    """esm_tpu's errors (tests/test_pipeline.py:74): a batch that the
    microbatches do not divide, layers that the stages do not divide; and
    the plain forward refuses a model split into stages."""
    for res in forward:
        assert "not divisible by microbatches 3" in res["batch_error"]
        assert "6 layers not divisible by 4 stages" in res["layers_error"]
        assert "apply_pipelined" in res["apply_error"]


def test_generic_pipeline_apply(forward):
    """pipeline_apply drives any stage body: stage s multiplies by s + 1, so
    four stages multiply by 24 (esm_tpu's closed-form check), on every rank."""
    want = np.arange(24.0).reshape(6, 2, 2) * 24.0
    for res in forward:
        np.testing.assert_allclose(res["generic"].numpy(), want, rtol=1e-6)


@pytest.fixture(scope="module")
def jax_steps(lm):
    jcfg, toks = lm["jcfg"], jnp.asarray(lm["toks"])
    rng = jax.random.PRNGKey(7)
    corrupted, target_mask = jtraining._corrupt_batch(jcfg, rng, toks)
    (_, _), grads = jax.value_and_grad(jtraining.mlm_loss, has_aux=True)(
        lm["params"], jcfg, corrupted, toks, target_mask)
    tx = jtraining.make_optimizer(1e-3, warmup_steps=0, total_steps=10)
    out = dict(corrupted=corrupted, target_mask=target_mask, norm=float(optax.global_norm(grads)),
               grads=esm2_state_dict_from_jax(_np(grads), jcfg), steps={})
    for tag, shape, m, _ in PP_STEPS:
        mesh = _jax_mesh(shape)
        state = jtraining.init_state(jpipeline.shard_params_pp(mesh, _copy(lm["params"])), tx)
        state, metrics = jtraining.train_step_pp(state, jcfg, tx, rng, toks, mesh=mesh,
                                                 num_microbatches=m)
        out["steps"][tag] = (float(metrics["loss"]),
                             esm2_state_dict_from_jax(_np(state.params), jcfg))
    return out


@pytest.fixture(scope="module")
def pp_train(lm, jax_steps, tmp_path_factory):
    inputs = dict(size=SIZE, state_dict=lm["state_dict"], tokens=_t(lm["toks"]).long(),
                  corrupted=_t(jax_steps["corrupted"]).long(),
                  target_mask=_t(jax_steps["target_mask"]), pp_cases=PP_STEPS,
                  grads=jax_steps["grads"])
    return spawn(train_body, 8, inputs, tmp_path_factory.mktemp("pp_train"))


@pytest.mark.parametrize("case", PP_STEPS, ids=lambda c: c[0])
def test_train_step_pp_matches_esm_tpu(jax_steps, pp_train, case):
    """train_step_pp's step 0 with esm_tpu's corruption, on every rank: the
    loss and the updated parameters of its stage against esm_tpu's
    train_step_pp, the stage's gathered gradients against jax.grad, the
    global norm over all stages; together the stages cover every layer."""
    tag = case[0]
    want_loss, want_params = jax_steps["steps"][tag]
    layers = set()
    for rank, res in enumerate(pp_train):
        got = res[tag]
        np.testing.assert_allclose(got["loss"], want_loss, rtol=1e-5)
        np.testing.assert_allclose(got["norm"], jax_steps["norm"], rtol=1e-5)
        for name, g in got["grads"].items():
            np.testing.assert_allclose(g.numpy(), jax_steps["grads"][name].numpy(), **TOL,
                                       err_msg=f"rank {rank} grad {name}")
        for name, p in got["params"].items():
            np.testing.assert_allclose(p.numpy(), want_params[name].numpy(), **TOL,
                                       err_msg=f"rank {rank} {name}")
        layers |= {n.split(".")[1] for n in got["params"] if n.startswith("layers.")}
    assert layers == {str(i) for i in range(SIZE["num_layers"])}
