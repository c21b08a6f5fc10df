"""ESM-2 masked-LM training of the port (esm_tpu_torch.training) against
esm_tpu.training, on the CPU, on the same weights (JAX init carried across by
esm2_state_dict_from_jax; 2 layers x 64 wide x 4 heads) and the same
corruption (JAX's ``_corrupt_batch``: jax.random's bits cannot be
reproduced, so the port's own ``mask_tokens`` is tested on its own terms).

Tolerances: the loss and its gradients 1e-4 absolute (fp32 on both sides,
summation order and transcendentals over two layers); two optimizer steps on
the same gradients 1e-6 (elementwise fp32, the global norm summed in another
order); accumulation and remat against one pass 1e-6 (the same operations
regrouped).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from esm_tpu import training as jtraining
from esm_tpu.data import Alphabet as JaxAlphabet
from esm_tpu.models import esm2 as jesm2
from esm_tpu_torch import training
from esm_tpu_torch.data import Alphabet
from esm_tpu_torch.io.from_jax import esm2_state_dict_from_jax
from esm_tpu_torch.models import esm2 as tesm2

SIZE = dict(num_layers=2, embed_dim=64, attention_heads=4)
SEQS = [("s%d" % i, "KALTARQQEVFDLIRDHISQTGMPPTRAEIA"[: 8 + 3 * i]) for i in range(8)]


@pytest.fixture(scope="module")
def setup():
    jalpha = JaxAlphabet.from_architecture("ESM-1b")
    jcfg = jesm2.ESM2Config.from_alphabet(jalpha, **SIZE)
    params = jesm2.init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.RandomState(1)
    params["lm_head"]["bias"] = jnp.asarray(rng.randn(len(jalpha)).astype(np.float32) * 0.1)
    state_dict = esm2_state_dict_from_jax(jax.tree.map(np.asarray, params), jcfg)
    alphabet = Alphabet.from_architecture("ESM-1b")
    cfg = tesm2.ESM2Config.from_alphabet(alphabet, **SIZE)
    toks = alphabet.get_batch_converter(pad_to_multiple=8)(SEQS)[2]
    corrupted, target_mask = jtraining._corrupt_batch(jcfg, jax.random.PRNGKey(3),
                                                      jnp.asarray(toks.numpy()))
    return dict(jcfg=jcfg, params=params, state_dict=state_dict, cfg=cfg, toks=toks,
                jcorrupted=corrupted, jtarget_mask=target_mask,
                corrupted=torch.from_numpy(np.array(corrupted)).to(torch.int64),
                target_mask=torch.from_numpy(np.array(target_mask)))


def _model(setup):
    model = tesm2.ESM2(setup["cfg"], device="cpu")
    model.load_state_dict(setup["state_dict"], strict=True)
    return model


def _as_torch_names(tree, setup, model):
    """A JAX parameter-shaped tree as a dict keyed by the port's parameter names."""
    sd = esm2_state_dict_from_jax(jax.tree.map(np.asarray, tree), setup["jcfg"])
    return {n: sd[n] for n, _ in model.named_parameters()}


def _grads(model):
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p)).clone()
            for n, p in model.named_parameters()}


@pytest.mark.parametrize("use_flash", [False, True])
def test_mlm_loss_and_grads_match_jax(setup, use_flash):
    jcfg = dataclasses.replace(setup["jcfg"], use_flash=use_flash)
    (jloss, jmetrics), jgrads = jax.value_and_grad(jtraining.mlm_loss, has_aux=True)(
        setup["params"], jcfg, setup["jcorrupted"], jnp.asarray(setup["toks"].numpy()),
        setup["jtarget_mask"],
    )
    model = _model(setup)
    cfg = dataclasses.replace(setup["cfg"], use_flash=use_flash)
    loss, metrics = training.mlm_loss(model, cfg, setup["corrupted"], setup["toks"],
                                      setup["target_mask"])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-4)
    np.testing.assert_allclose(metrics["acc"].item(), float(jmetrics["acc"]), atol=1e-6)
    assert metrics["num_masked"].item() == float(jmetrics["num_masked"]) > 0
    ref = _as_torch_names(jgrads, setup, model)
    for name, g in _grads(model).items():
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), atol=1e-4, err_msg=name)


@pytest.mark.parametrize("clip,bf16_moments", [(None, False), (1.0, True), (1e6, True)])
def test_two_optimizer_steps_match_optax(setup, clip, bf16_moments):
    """Global-norm clip (active at 1.0, idle at 1e6), bf16 first moments, the
    decay mask and the warmup from LR 0, on the same random gradients."""
    rng = np.random.RandomState(5)
    jgrads = [jax.tree.map(lambda x: rng.randn(*x.shape).astype(np.float32), setup["params"])
              for _ in range(2)]
    kw = dict(warmup_steps=1, total_steps=10, grad_clip_norm=clip)
    tx = jtraining.make_optimizer(1e-3, mu_dtype=jnp.bfloat16 if bf16_moments else None, **kw)
    params = setup["params"]
    opt = tx.init(params)
    for g in jgrads:
        updates, opt = tx.update(jax.tree.map(jnp.asarray, g), opt, params)
        params = optax.apply_updates(params, updates)

    model = _model(setup)
    ttx = training.make_optimizer(1e-3, mu_dtype=torch.bfloat16 if bf16_moments else None, **kw)
    state = training.init_state(model, ttx)
    for g in jgrads:
        named = _as_torch_names(g, setup, model)
        for n, p in model.named_parameters():
            p.grad = named[n].clone()
        ttx.update(model, state.opt_state)
    assert state.opt_state.count == 2
    want_mu = torch.bfloat16 if bf16_moments else torch.float32
    assert {m.dtype for m in state.opt_state.mu.values()} == {want_mu}
    ref = _as_torch_names(params, setup, model)
    moved = 0
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[n].numpy(), atol=1e-6, err_msg=n)
        moved += not torch.equal(p.detach(), setup["state_dict"][n])
    assert moved == len(ref)


def test_decay_mask_names():
    model = tesm2.ESM2(tesm2.ESM2Config(**SIZE), device="cpu")
    mask = training.decay_mask(model)
    assert mask["lm_head.dense.weight"] and mask["contact_head.regression.weight"]
    assert mask["layers.0.self_attn.q_proj.weight"] and mask["layers.1.fc2.weight"]
    assert not mask["embed_tokens.weight"] and "lm_head.weight" not in mask  # tied
    assert not any(mask[n] for n in mask if n.endswith(".bias") or "layer_norm" in n)


def test_schedule_is_optax_warmup_cosine():
    sched = training.warmup_cosine_schedule(4e-4, 10, 100)
    ref = optax.warmup_cosine_decay_schedule(0.0, 4e-4, 10, 100)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(sched(step), float(ref(step)), rtol=1e-6, atol=1e-10)


def test_factored_optimizer_matches_optax(setup):
    """make_optimizer(factored=True), once a raise, is optax.adafactor: two
    steps on the same random gradients within 1e-6 (at width 64 no tensor
    factors; tests/test_torch_trainers.py covers the factored statistics)."""
    rng = np.random.RandomState(6)
    jgrads = [jax.tree.map(lambda x: rng.randn(*x.shape).astype(np.float32), setup["params"])
              for _ in range(2)]
    kw = dict(warmup_steps=1, total_steps=10, factored=True)
    tx = jtraining.make_optimizer(1e-2, **kw)
    params = setup["params"]
    opt = tx.init(params)
    for g in jgrads:
        updates, opt = tx.update(jax.tree.map(jnp.asarray, g), opt, params)
        params = optax.apply_updates(params, updates)

    model = _model(setup)
    ttx = training.make_optimizer(1e-2, **kw)
    state = training.init_state(model, ttx)
    assert isinstance(state.opt_state, training.AdafactorState)
    for g in jgrads:
        named = _as_torch_names(g, setup, model)
        for n, p in model.named_parameters():
            p.grad = named[n].clone()
        ttx.update(model, state.opt_state)
    ref = _as_torch_names(params, setup, model)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[n].numpy(), atol=1e-6, err_msg=n)


def test_accum_matches_full_batch(setup):
    tx = training.make_optimizer(1e-3, warmup_steps=1, total_steps=10)
    full = training.init_state(_model(setup), tx)
    acc = training.init_state(_model(setup), tx)
    for i in range(2):  # step 0 has LR 0; step 1 moves the parameters
        full, m_full = training.train_step(full, setup["cfg"], tx,
                                           torch.Generator().manual_seed(i), setup["toks"])
        acc, m_acc = training.train_step_accum(acc, setup["cfg"], tx,
                                               torch.Generator().manual_seed(i), setup["toks"],
                                               accum_steps=4)
    assert full.step == acc.step == 2
    np.testing.assert_allclose(m_acc["loss"].item(), m_full["loss"].item(), atol=1e-6)
    assert m_acc["num_masked"].item() == m_full["num_masked"].item()
    start = setup["state_dict"]
    assert any(not torch.equal(p.detach(), start[n]) for n, p in full.model.named_parameters())
    for (n, a), b in zip(acc.model.named_parameters(), full.model.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-6, err_msg=n)


def test_accum_rejects_indivisible_batch(setup):
    tx = training.make_optimizer(1e-3, warmup_steps=1, total_steps=10)
    state = training.init_state(_model(setup), tx)
    with pytest.raises(ValueError, match="accum_steps"):
        training.train_step_accum(state, setup["cfg"], tx, torch.Generator().manual_seed(0),
                                  setup["toks"][:6], accum_steps=4)


def test_eval_step_matches_loss(setup):
    model = _model(setup)
    sums = training.eval_step(model, setup["cfg"], torch.Generator().manual_seed(3),
                              setup["toks"])
    assert sums["nll_sum"].shape == (setup["toks"].shape[0],)
    corrupted, target_mask = training._corrupt_batch(setup["cfg"],
                                                     torch.Generator().manual_seed(3),
                                                     setup["toks"])
    with torch.no_grad():
        loss, metrics = training.mlm_loss(model, setup["cfg"], corrupted, setup["toks"],
                                          target_mask)
    count = sums["count"].sum().item()
    np.testing.assert_allclose(sums["nll_sum"].sum().item() / max(count, 1.0), loss.item(),
                               atol=1e-6)
    assert count == metrics["num_masked"].item()
    np.testing.assert_array_equal(sums["count"].numpy(), target_mask.sum(-1).numpy())


@pytest.mark.parametrize("policy", ["dots", "full"])
@pytest.mark.parametrize("use_flash", [False, True])
def test_remat_grads_equal_no_remat(setup, use_flash, policy):
    grads = []
    for remat in (False, True):
        model = _model(setup)
        cfg = dataclasses.replace(setup["cfg"], use_flash=use_flash, remat=remat,
                                  remat_policy=policy)
        loss, _ = training.mlm_loss(model, cfg, setup["corrupted"], setup["toks"],
                                    setup["target_mask"])
        loss.backward()
        grads.append(_grads(model))
    for name, g in grads[0].items():
        np.testing.assert_allclose(grads[1][name].numpy(), g.numpy(), atol=1e-6, err_msg=name)


def test_unknown_remat_policy_raises(setup):
    cfg = dataclasses.replace(setup["cfg"], remat=True, remat_policy="everything")
    with pytest.raises(ValueError, match="remat_policy"):
        training.mlm_loss(_model(setup), cfg, setup["corrupted"], setup["toks"],
                          setup["target_mask"])


def test_mask_tokens_statistics():
    alphabet = Alphabet.from_architecture("ESM-1b")
    rng = np.random.RandomState(0)
    lengths = rng.randint(200, 510, size=64)
    seqs = [(str(i), "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), n)))
            for i, n in enumerate(lengths)]
    toks = alphabet.get_batch_converter()(seqs)[2]
    special = ((toks == alphabet.padding_idx) | (toks == alphabet.cls_idx)
               | (toks == alphabet.eos_idx))
    kw = dict(mask_idx=alphabet.mask_idx, padding_idx=alphabet.padding_idx, special_mask=special)
    corrupted, selected = training.mask_tokens(torch.Generator().manual_seed(1), toks, **kw)

    assert not (selected & special).any()
    assert torch.equal(corrupted[~selected], toks[~selected])
    rate = selected.sum().item() / (~special).sum().item()
    assert abs(rate - 0.15) < 0.01, rate
    n = selected.sum().item()
    masked = (corrupted[selected] == alphabet.mask_idx).sum().item() / n
    kept = (corrupted[selected] == toks[selected]).sum().item() / n
    swapped = corrupted[selected & (corrupted != alphabet.mask_idx) & (corrupted != toks)]
    # 10% draw a random standard residue, which is the original 1 time in 20
    assert abs(masked - 0.8) < 0.03 and abs(kept - 0.105) < 0.03, (masked, kept)
    assert abs(swapped.numel() / n - 0.095) < 0.03
    assert ((swapped >= 4) & (swapped < 24)).all()

    again = training.mask_tokens(torch.Generator().manual_seed(1), toks, **kw)
    other = training.mask_tokens(torch.Generator().manual_seed(2), toks, **kw)
    assert torch.equal(again[0], corrupted) and torch.equal(again[1], selected)
    assert not torch.equal(other[1], selected)
