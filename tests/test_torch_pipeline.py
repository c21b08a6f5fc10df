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

LoRA on a pipeline-sharded ESM-2 (a 4-rank group: pp=4, pp=2 with data=2,
pp=2 with tp=2 on the flash path with remat; a bf16 base, fp32 compute) is
held to esm_tpu's one-device LoRA step, its counterpart being esm_tpu's
train_step_lora with apply_fn=partial(esm2.apply_pipelined, ...): the loss,
the adapter gradients gathered over the stages and the updated adapters at
the same tolerance; init_lora over the stages and the pp=4 adapter state
reloaded on one device bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_shard_ranks import pipeline_body, pp_lora_body, spawn, train_body
from esm_tpu import lora as jlora
from esm_tpu import training as jtraining
from esm_tpu.data import Alphabet as JaxAlphabet
from esm_tpu.models import esm2 as jesm2
from esm_tpu.parallel import pipeline as jpipeline
from esm_tpu_torch import lora, training
from esm_tpu_torch.data import Alphabet
from esm_tpu_torch.io import checkpoint
from esm_tpu_torch.io.from_jax import esm2_state_dict_from_jax, lora_from_jax
from esm_tpu_torch.models import esm2

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


# ---------------------------------------------- LoRA on a pipeline-sharded base

# without token dropout: over a bf16 table the port rescales a row with
# <mask> tokens in bf16 where XLA fuses it in fp32 (tests/test_torch_shard_train.py)
LORA_SIZE = dict(SIZE, token_dropout=False)
LORA_SCALE = 2.0
PP_LORA = (("pp4", (4, 1, 1, 1), 4, {}),
           ("pp2-data2", (2, 2, 1, 1), 2, {}),
           ("pp2-tp2-flash-remat", (2, 1, 1, 2), 2, {"use_flash": True, "remat": True}))


@pytest.fixture(scope="module")
def lora_ref(lm):
    """esm_tpu's one-device LoRA step over the bf16 base of the 4-layer
    model: its corruption, seeded adapters (nonzero b), jax.grad of its LoRA
    loss and the AdamW update with a clip at half the gradients' norm."""
    jcfg = jesm2.ESM2Config.from_alphabet(JaxAlphabet.from_architecture("ESM-1b"), **LORA_SIZE)
    toks = jnp.asarray(lm["toks"])
    corrupted, target_mask = jtraining._corrupt_batch(jcfg, jax.random.PRNGKey(8), toks)
    base = jax.tree.map(lambda x: x.astype(jnp.bfloat16), lm["params"])
    jad = jax.jit(functools.partial(jlora.init_lora, rank=4))(jax.random.PRNGKey(9), base)
    rng = np.random.RandomState(9)
    jad = jax.tree_util.tree_map_with_path(
        lambda path, x: (rng.randn(*x.shape) * 0.05).astype(np.float32)
        if path[-1].key == "lora_b" else np.asarray(x), jad)

    def loss_fn(a):
        patched = jlora.patch(jax.lax.stop_gradient(base), a, scale=LORA_SCALE)
        return jtraining.mlm_loss(patched, jcfg, corrupted, toks, target_mask)

    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jad)
    norm = float(optax.global_norm(grads))
    tx = jtraining.make_optimizer(1e-3, warmup_steps=0, total_steps=10, grad_clip_norm=norm / 2)
    updated = optax.apply_updates(jad, tx.update(grads, tx.init(jad), jad)[0])
    model = esm2.ESM2(esm2.ESM2Config.from_alphabet(Alphabet.from_architecture("ESM-1b"),
                                                    **LORA_SIZE))
    adapters = lora_from_jax(jad, model)
    return dict(corrupted=_t(corrupted).long(), target_mask=_t(target_mask), loss=float(loss),
                norm=norm, clip=norm / 2, model=model,
                adapters={p: (a.lora_a.detach(), a.lora_b.detach()) for p, a in
                          adapters.adapters()},
                grads=lora_from_jax(_np(grads), model).state_dict(),
                updated=lora_from_jax(_np(updated), model).state_dict())


@pytest.fixture(scope="module")
def pp_lora(lm, lora_ref, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp_lora")
    inputs = dict(size=SIZE, lora_size=LORA_SIZE, state_dict=lm["state_dict"],
                  tokens=_t(lm["toks"]).long(), corrupted=lora_ref["corrupted"],
                  target_mask=lora_ref["target_mask"], adapters=lora_ref["adapters"],
                  lora_grads=lora_ref["grads"], clip=lora_ref["clip"], scale=LORA_SCALE,
                  cases=PP_LORA, dir=str(tmp))
    return dict(ranks=spawn(pp_lora_body, 4, inputs, tmp), tmp=tmp)


@pytest.mark.parametrize("case", PP_LORA, ids=lambda c: c[0])
def test_pipelined_lora_step_matches_esm_tpu(lora_ref, pp_lora, case):
    """Step 0 of the LoRA step through the GPipe schedule, on every rank: the
    loss, the adapter gradients (each from its stage's backward, gathered
    over the stages) and the global norm over the stages against jax.grad of
    esm_tpu's LoRA loss; the adapters after AdamW's update (binding clip) on
    esm_tpu's gradients against optax's; a rank holds its stage's layers'
    adapters only; the next step's loss is lower."""
    tag, (pp, *_), _, _ = case
    per = SIZE["num_layers"] // pp
    for rank, res in enumerate(pp_lora["ranks"]):
        got = res[tag]
        np.testing.assert_allclose(got["loss"], lora_ref["loss"], **TOL)
        np.testing.assert_allclose(got["norm"], lora_ref["norm"], **TOL)
        assert got["grads"].keys() == lora_ref["grads"].keys()
        for name, g in got["grads"].items():
            np.testing.assert_allclose(g.numpy(), lora_ref["grads"][name].numpy(), **TOL,
                                       err_msg=f"rank {rank} grad {name}")
        for name, p in got["updated"].items():
            np.testing.assert_allclose(p.numpy(), lora_ref["updated"][name].numpy(), **TOL,
                                       err_msg=f"rank {rank} {name}")
        stage = rank // (4 // pp)
        assert {int(n.split(".")[1]) for n in got["stage"]} == set(
            range(stage * per, (stage + 1) * per)), (rank, got["stage"])
        assert got["loss1"] < got["loss"]


def test_init_lora_over_stages_draws_one_cards_adapters(lora_ref, pp_lora):
    """init_lora over the pp=4 base draws every layer's factors in the
    unsharded order: gathered over the stages, one card's init_lora."""
    want = lora.init_lora(torch.Generator().manual_seed(5), lora_ref["model"], rank=4).state_dict()
    for rank, res in enumerate(pp_lora["ranks"]):
        got = res["pp4"]["init"]
        assert got.keys() == want.keys()
        for name, t in got.items():
            assert torch.equal(t, want[name]), (rank, name)


def test_stage_adapters_carry_replicated_specs(pp_lora):
    """A stage's adapters carry the base's Sharding with their factors added
    as replicated; the base's specs stay as they were, and both still refuse
    an entry they do not hold."""
    for rank, res in enumerate(pp_lora["ranks"]):
        got = res["pp4"]["specs"]
        assert got["adapters"] and set(got["adapters"].values()) == {()}, rank
        assert got["in_base"] == [] and got["missing_raises"] == [True, True], (rank, got)


def test_pp4_adapter_state_reloads_on_one_device(lora_ref, pp_lora):
    """The pp=4 adapters' AdamW state after two updates (step 0's on
    esm_tpu's gradients, then a whole step), saved (the stages gathered over
    pp), reloads on one device bit for bit."""
    adapters = lora.LoRA({p: (a.clone(), b.clone()) for p, (a, b) in lora_ref["adapters"].items()})
    tx = training.make_optimizer(1e-3, warmup_steps=0, total_steps=10)
    one = checkpoint.load_train_state(pp_lora["tmp"] / "pp_lora", training.init_state(adapters, tx))
    assert (one.step, one.opt_state.count) == (1, 2)
    saved = pp_lora["ranks"][0]["pp4"]["saved"]
    for key, tree in (("params", one.model.state_dict()), ("mu", one.opt_state.mu),
                      ("nu", one.opt_state.nu)):
        assert tree.keys() == saved[key].keys(), key
        for name, t in tree.items():
            assert torch.equal(t, saved[key][name]), (key, name)
