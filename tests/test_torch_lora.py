"""The port's LoRA (esm_tpu_torch.lora, training.train_step_lora) against
esm_tpu.lora on the CPU: ESM-2 at 2 layers x 64 wide x 4 heads (as
tests/test_lora.py sets it up), the JAX init and JAX's adapters carried
across (esm2_state_dict_from_jax, lora_from_jax), every ``lora_b`` set to
seeded noise where a zero ``b`` would hide a fault.

fp32, TF32 off. Tolerances (tests/test_torch_training.py's): patched
forwards, losses and adapter gradients 1e-4 absolute (summation order and
transcendentals over two layers); merge against patch 1e-5 of the largest logit (W + ab rounds once
where the patch rounds twice); optimizer steps on the same gradients 1e-6
(elementwise fp32).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from esm_tpu import lora as jlora
from esm_tpu import training as jtraining
from esm_tpu.data import Alphabet as JaxAlphabet
from esm_tpu.models import esm2 as jesm2
from esm_tpu.quantization import quantize_params as jquantize
from esm_tpu_torch import lora, training
from esm_tpu_torch.data import Alphabet
from esm_tpu_torch.io.from_jax import esm2_state_dict_from_jax, lora_from_jax
from esm_tpu_torch.models import esm2 as tesm2
from esm_tpu_torch.quantization import quantize_params

SIZE = dict(num_layers=2, embed_dim=64, attention_heads=4)
SEQS = [("s%d" % i, "KALTARQQEVFDLIRDHISQTGMPPTRAEIA"[: 12 + 3 * i]) for i in range(4)]
TOL = dict(atol=1e-4, rtol=0)


def _randomize_b(adapters, seed, scale=0.05):
    """Every lora_b of a JAX adapter tree set to seeded noise."""
    rng = np.random.RandomState(seed)

    def walk(node):
        if isinstance(node, dict) and "lora_a" in node:
            b = np.asarray(node["lora_b"])
            return {"lora_a": node["lora_a"],
                    "lora_b": jnp.asarray((rng.randn(*b.shape) * scale).astype(np.float32))}
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return type(node)(walk(v) for v in node)

    return walk(adapters)


@pytest.fixture(scope="module", autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.fixture(scope="module")
def setup():
    jalpha = JaxAlphabet.from_architecture("ESM-1b")
    jcfg = jesm2.ESM2Config.from_alphabet(jalpha, **SIZE)
    params = jesm2.init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.RandomState(1)
    params["lm_head"]["bias"] = jnp.asarray(rng.randn(len(jalpha)).astype(np.float32) * 0.1)
    adapters = _randomize_b(jlora.init_lora(jax.random.PRNGKey(1), params, rank=4), 2)
    alphabet = Alphabet.from_architecture("ESM-1b")
    cfg = tesm2.ESM2Config.from_alphabet(alphabet, **SIZE)
    toks = alphabet.get_batch_converter(pad_to_multiple=8)(SEQS)[2]
    return dict(jcfg=jcfg, params=params, adapters=adapters, cfg=cfg, toks=toks,
                state_dict=esm2_state_dict_from_jax(jax.tree.map(np.asarray, params), jcfg))


def _model(setup):
    model = tesm2.ESM2(setup["cfg"], device="cpu")
    model.load_state_dict(setup["state_dict"], strict=True)
    return model


def _logits(model, cfg, toks):
    with torch.no_grad():
        return tesm2.apply(model, cfg, toks)["logits"].numpy()


def test_zero_b_patch_is_identity(setup):
    model = _model(setup)
    adapters = lora.init_lora(torch.Generator().manual_seed(1), model, rank=4)
    assert all(not a.lora_b.any() for _, a in adapters.adapters())
    base = _logits(model, setup["cfg"], setup["toks"])
    with lora.patch(model, adapters):
        patched = _logits(model, setup["cfg"], setup["toks"])
    np.testing.assert_array_equal(base, patched)
    assert not any("lora" in m.__dict__ for m in model.modules())  # detached on exit


@pytest.mark.parametrize("use_flash", [False, True])
def test_patched_forward_matches_jax(setup, use_flash):
    """Nonzero adapters with scale 2 through the exact path and the flash
    path (K1's plain version on the CPU) against esm_tpu's patched forward."""
    jcfg = dataclasses.replace(setup["jcfg"], use_flash=use_flash)
    jtoks = jnp.asarray(setup["toks"].numpy())
    want = np.asarray(jesm2.apply(jlora.patch(setup["params"], setup["adapters"], scale=2.0),
                                  jcfg, jtoks)["logits"])
    model = _model(setup)
    adapters = lora_from_jax(setup["adapters"], model)
    cfg = dataclasses.replace(setup["cfg"], use_flash=use_flash)
    base = _logits(model, cfg, setup["toks"])
    with lora.patch(model, adapters, scale=2.0):
        got = _logits(model, cfg, setup["toks"])
    assert np.abs(got - base).max() > 1e-3  # the adapters act
    np.testing.assert_allclose(got, want, **TOL)


def test_merge_matches_patch(setup):
    model = _model(setup)
    adapters = lora_from_jax(setup["adapters"], model)
    with lora.patch(model, adapters, scale=0.5):
        patched = _logits(model, setup["cfg"], setup["toks"])
    merged = lora.merge(model, adapters, scale=0.5)
    np.testing.assert_allclose(_logits(merged, setup["cfg"], setup["toks"]), patched,
                               atol=1e-5 * np.abs(patched).max(), rtol=0)
    for k, v in model.state_dict().items():  # the base is left as it was
        assert torch.equal(v, setup["state_dict"][k]), k
    assert not torch.equal(merged.layers[0].fc1.weight, model.layers[0].fc1.weight)


def test_int8_base_runs_unmerged_and_refuses_merge(setup):
    """The QLoRA-style configuration: esm_tpu's int8 base patched against the
    port's (the int8 values are bit-equal), and merge refuses."""
    jq = jquantize(setup["params"], min_size=1)
    want = np.asarray(jesm2.apply(jlora.patch(jq, setup["adapters"]), setup["jcfg"],
                                  jnp.asarray(setup["toks"].numpy()))["logits"])
    model = quantize_params(_model(setup), min_size=1)
    assert model.layers[0].self_attn.q_proj.weight.dtype == torch.int8
    adapters = lora_from_jax(setup["adapters"], model)
    with lora.patch(model, adapters):
        got = _logits(model, setup["cfg"], setup["toks"])
    np.testing.assert_allclose(got, want, **TOL)
    with pytest.raises(ValueError, match="int8"):
        lora.merge(model, adapters)


@pytest.mark.parametrize("targets", [None, {"q_proj", "v_proj"}, "predicate"])
def test_targets_and_num_params_match_jax(setup, targets):
    pred = lambda path: path[-1] in ("fc1", "dense") or path[0] == "contact_head"  # noqa: E731
    t = pred if targets == "predicate" else targets
    kw = {} if t is None else {"targets": t}
    jad = jlora.init_lora(jax.random.PRNGKey(1), setup["params"], rank=4, **kw)
    model = _model(setup)
    adapters = lora.init_lora(torch.Generator().manual_seed(1), model, rank=4, **kw)
    assert lora.num_params(adapters) == jlora.num_params(jad)
    carried = lora_from_jax(jad, model)
    assert [n for n, _ in adapters.adapters()] == [n for n, _ in carried.adapters()]
    for (_, a), (_, c) in zip(adapters.adapters(), carried.adapters()):
        assert a.lora_a.shape == c.lora_a.shape and a.lora_b.shape == c.lora_b.shape
    if targets == {"q_proj", "v_proj"}:
        names = {n.rsplit(".", 1)[-1] for n, _ in adapters.adapters()}
        assert names == {"q_proj", "v_proj"}
        d, r, n = 64, 4, 2
        assert lora.num_params(adapters) == 2 * n * (d * r + r * d)
    a = torch.stack([adapters.get_submodule(f"layers.{i}.self_attn.q_proj").lora_a.detach()
                     for i in range(2)]) if targets != "predicate" else None
    if a is not None:
        assert abs(float(a.std()) * 8 - 1) < 0.1  # N(0, 1 / d_in), d_in = 64


def test_misaligned_adapters_raise(setup):
    model = _model(setup)
    wrong_path = lora.LoRA({"layers.5.fc1": (torch.zeros(64, 4), torch.zeros(4, 256))})
    with pytest.raises(KeyError, match="not in the model"):
        lora.patch(model, wrong_path)
    not_linear = lora.LoRA({"layers.0.final_layer_norm": (torch.zeros(64, 4),
                                                          torch.zeros(4, 64))})
    with pytest.raises(ValueError, match="align"):
        lora.patch(model, not_linear)
    wrong_shape = lora.LoRA({"layers.0.fc1": (torch.zeros(64, 4), torch.zeros(4, 64))})
    with pytest.raises(ValueError, match="align"):
        lora.patch(model, wrong_shape)
    assert not any("lora" in m.__dict__ for m in model.modules())  # nothing attached
    with pytest.raises(KeyError, match="no linear"):
        lora_from_jax({"layers": {"nope": setup["adapters"]["layers"]["fc1"]}}, model)


def test_adapters_get_no_weight_decay(setup):
    """decay_mask takes nn.Linear weights only, as esm_tpu's takes leaves
    named "kernel": no adapter is decayed."""
    adapters = lora_from_jax(setup["adapters"], _model(setup))
    assert not any(training.decay_mask(adapters).values())
    jmask = jtraining.decay_mask(setup["adapters"])
    assert not any(jax.tree.leaves(jmask))


def test_lora_on_esmfold_trunk_block():
    """Every linear of a trunk block adapted (a predicate target): zero b is
    the identity; nonzero b moves both tracks; the patched block equals the
    merged one, through the five-way tri-mul projection, and the fused
    tri-mul (the plain versions of K7 and K8 on the CPU) equals the unfused
    one on the patched weights."""
    from esm_tpu_torch.models.esmfold import blocks
    from esm_tpu_torch.ops.common import init_linear_torch_default
    from esm_tpu_torch.ops.triangle import (
        triangle_multiplicative_update,
        triangle_multiplicative_update_fused,
    )

    gen = torch.Generator().manual_seed(0)
    block = blocks.TriangularSelfAttentionBlock(64, 32, 16, 16)
    with torch.no_grad():
        for m in block.modules():
            if isinstance(m, torch.nn.Linear):
                init_linear_torch_default(m, gen)
            elif isinstance(m, torch.nn.LayerNorm):
                m.weight.normal_(1.0, 0.1, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
    s = torch.randn(1, 12, 64, generator=gen)
    z = torch.randn(1, 12, 12, 32, generator=gen) * 0.1

    def run(mod):
        with torch.no_grad():
            return blocks.triangular_self_attention_block(mod, s, z, seq_heads=4, pair_heads=2)

    adapters = lora.init_lora(gen, block, rank=2, targets=lambda path: True)
    assert block.tri_mul_out.linear_a_g in [block.get_submodule(n) for n, _ in adapters.adapters()]
    s0, z0 = run(block)
    with lora.patch(block, adapters):
        s1, z1 = run(block)
    assert torch.equal(s0, s1) and torch.equal(z0, z1)
    with torch.no_grad():
        for _, a in adapters.adapters():
            a.lora_b.normal_(0.0, 0.05, generator=gen)
    with lora.patch(block, adapters):
        s2, z2 = run(block)
        with torch.no_grad():
            tm = block.tri_mul_out
            unfused = z + triangle_multiplicative_update(tm, z, outgoing=True)
            fused = triangle_multiplicative_update_fused(tm, z, outgoing=True)
    assert (s2 - s0).abs().max() > 1e-4 and (z2 - z0).abs().max() > 1e-4
    np.testing.assert_allclose(fused.numpy(), unfused.numpy(), atol=1e-5, rtol=0)
    s3, z3 = run(lora.merge(block, adapters))
    np.testing.assert_allclose(s3.numpy(), s2.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(z3.numpy(), z2.numpy(), atol=1e-5, rtol=0)


class _Capture:
    """A stand-in optimizer that keeps the adapters' gradients."""

    def init(self, model):
        return training.AdamWState(0, {}, {})

    def update(self, model, state):
        self.grads = {n: p.grad.clone() for n, p in model.named_parameters()}


def test_train_step_lora_matches_jax(setup):
    """Loss and adapter gradients of one step on JAX's corruption."""
    jcfg, params, jad = setup["jcfg"], setup["params"], setup["adapters"]
    jtoks = jnp.asarray(setup["toks"].numpy())
    corrupted, target_mask = jtraining._corrupt_batch(jcfg, jax.random.PRNGKey(3), jtoks)

    def loss_fn(a):
        p = jlora.patch(jax.lax.stop_gradient(params), a, scale=2.0)
        return jtraining.mlm_loss(p, jcfg, corrupted, jtoks, target_mask)

    (jloss, _), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(jad)
    model = _model(setup)
    adapters = lora_from_jax(jad, model)
    tx = _Capture()
    state = training.init_state(adapters, tx)
    state, metrics = training.train_step_lora_corrupted(
        state, model, setup["cfg"], tx, torch.from_numpy(np.array(corrupted)).to(torch.int64),
        setup["toks"], torch.from_numpy(np.array(target_mask)), scale=2.0)
    np.testing.assert_allclose(metrics["loss"].item(), float(jloss), **TOL)
    want = lora_from_jax(jgrads, model).state_dict()
    assert tx.grads.keys() == want.keys()
    for name, g in tx.grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), err_msg=name, **TOL)
    assert all(p.grad is None for p in model.parameters())
    assert all(p.requires_grad for p in model.parameters())  # restored after the step


def test_two_adamw_steps_over_adapters_match_optax(setup):
    rng = np.random.RandomState(4)
    jgrads = [jax.tree.map(lambda x: rng.randn(*x.shape).astype(np.float32), setup["adapters"])
              for _ in range(2)]
    kw = dict(warmup_steps=1, total_steps=10, grad_clip_norm=1.0)
    tx = jtraining.make_optimizer(1e-2, **kw)
    ad = setup["adapters"]
    opt = tx.init(ad)
    for g in jgrads:
        updates, opt = tx.update(g, opt, ad)
        ad = optax.apply_updates(ad, updates)
    model = _model(setup)
    adapters = lora_from_jax(setup["adapters"], model)
    ttx = training.make_optimizer(1e-2, **kw)
    state = training.init_state(adapters, ttx)
    for g in jgrads:
        named = lora_from_jax(g, model).state_dict()
        for n, p in adapters.named_parameters():
            p.grad = named[n].clone()
        ttx.update(adapters, state.opt_state)
    want = lora_from_jax(ad, model).state_dict()
    for n, p in adapters.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), atol=1e-6, err_msg=n)


def test_train_step_lora_trains_adapters_only(setup):
    """6 steps on one batch: the loss falls, the adapters move, the base is
    bit-identical, and every optimizer tensor is adapter-sized."""
    model = _model(setup)
    adapters = lora.init_lora(torch.Generator().manual_seed(1), model, rank=4)
    start = {k: v.clone() for k, v in adapters.state_dict().items()}
    tx = training.make_optimizer(5e-2, warmup_steps=1, total_steps=50)
    state = training.init_state(adapters, tx)
    losses = []
    for i in range(6):
        state, metrics = training.train_step_lora(
            state, model, setup["cfg"], tx, torch.Generator().manual_seed(10 + i), setup["toks"])
        losses.append(metrics["loss"].item())
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert any(not torch.equal(v, start[k]) for k, v in adapters.state_dict().items())
    for k, v in model.state_dict().items():
        assert torch.equal(v, setup["state_dict"][k]), k
    sizes = {p.numel() for p in adapters.parameters()}
    opt = state.opt_state
    assert opt.mu.keys() == opt.nu.keys() == dict(adapters.named_parameters()).keys()
    assert max(t.numel() for t in list(opt.mu.values()) + list(opt.nu.values())) <= max(sizes)


def test_full_remat_matches_dots(setup):
    model = _model(setup)
    results = {}
    for policy in ("dots", "full"):
        adapters = lora_from_jax(setup["adapters"], model)
        cfg = dataclasses.replace(setup["cfg"], remat=True, remat_policy=policy)
        tx = training.make_optimizer(1e-2, warmup_steps=1, total_steps=10)
        state = training.init_state(adapters, tx)
        for i in range(2):  # step 0 has LR 0
            state, metrics = training.train_step_lora(
                state, model, cfg, tx, torch.Generator().manual_seed(5), setup["toks"])
        results[policy] = (metrics["loss"].item(), adapters.state_dict())
    assert abs(results["dots"][0] - results["full"][0]) <= 1e-6
    for k, v in results["dots"][1].items():
        np.testing.assert_allclose(v.numpy(), results["full"][1][k].numpy(), atol=1e-6)
