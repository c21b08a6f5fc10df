"""The port's ESMFold fine-tuning (esm_tpu_torch.models.esmfold.losses,
training.train_step_fold[_lora]) against esm_tpu on the CPU: each loss
function on seeded inputs; fold_loss and the gradient of every trainable
parameter of a tiny ESMFold (LM 2 x 32, 2 trunk blocks, c_s 64, c_z 32,
structure module 2 blocks) against jax.value_and_grad, at num_recycles 0
and 1, with and without the masked-LM term; one full step and one LoRA step
against JAX's parameters after the step; the structure module's rotation
stop-gradient; ``infer`` outputs without grad.

Weights: esm_tpu's init carried across by ``esmfold_state_dict_from_jax``,
zero-initialized layers re-drawn. Gradients and stepped parameters from JAX
are carried across by the same function (it is linear), so both sides are
compared under the port's names.

fp32, TF32 off. Bounds: frames, pseudo-beta and lDDT 1e-6 to 1e-5
absolute, distogram bins exact, FAPE 1e-4 relative (its clamp and square
roots over 8 x 8 x 12 points); fold_loss and its metrics 1e-5 relative;
gradients per tensor within 2e-4 of the tensor's largest |gradient| (or of
1e-3 of the largest over all tensors, where a tensor's gradient is zero
but for rounding, such as a softmax logit's bias): the backward runs
through 2 trunk blocks, 2 structure-module blocks and the quaternion <->
rotation maps in other summation orders. The steps' parameter changes are
held to the gradients' bound plus 2 ulp of the parameters: they run AdamW
with eps 1, so that the first update, lr g / (|g| + eps) of the clipped
gradient, is close to linear in g (at the default eps 1e-8 its slope
reaches 1e8 near g = 0, and clipping at norm 1 puts many elements there,
where the rounding of a gradient decides a share of lr). The optimizer at
its defaults is held to optax on the same gradients, 1e-7 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from esm_tpu import lora as jlora
from esm_tpu import training as jtraining
from esm_tpu.models import esmfold as jef
from esm_tpu.models.esmfold import losses as jfl
from esm_tpu.models.esmfold import structure_module as jsm
from esm_tpu_torch import lora, training
from esm_tpu_torch.io.from_jax import esmfold_state_dict_from_jax, lora_from_jax
from esm_tpu_torch.models.esmfold import esmfold as tef
from esm_tpu_torch.models.esmfold import losses as tfl
from esm_tpu_torch.models.esmfold import structure_module as tsm
from esm_tpu_torch.ops import rigid as trg

from test_torch_esmfold import build

GRAD_TOL = 2e-4
STEP_EPS = 1.0  # AdamW's eps in the step tests


@pytest.fixture(scope="module", autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def synth_backbone(seed, b, l):
    """A non-degenerate synthetic N/CA/C backbone (B, L, 3, 3) in Å."""
    g = np.random.RandomState(seed)
    ca = np.cumsum(g.randn(b, l, 3) * 0.5 + np.array([3.8, 0.0, 0.0]), axis=1)
    n = ca + g.randn(b, l, 3) * 0.2 + np.array([-1.2, 0.6, 0.0])
    c = ca + g.randn(b, l, 3) * 0.2 + np.array([1.3, -0.6, 0.2])
    return np.stack([n, ca, c], axis=2).astype(np.float32)


def fold_batch(seed, b=2, l=8):
    """(aa, mask, coords, coord_mask, masking_pattern) as numpy: a padded
    column, an unresolved residue, a 15% masking pattern."""
    g = np.random.RandomState(seed)
    aa = g.randint(0, 20, (b, l)).astype(np.int32)
    aa[0, 1] = 7  # a glycine: pseudo-beta is CA there
    mask = np.ones((b, l), np.float32)
    mask[1, -2:] = 0.0
    coord_mask = np.ones((b, l), np.float32)
    coord_mask[0, 0] = 0.0
    pattern = (g.rand(b, l) < 0.15).astype(np.int32)
    pattern[0, 3] = 1
    return aa, mask, synth_backbone(seed + 1, b, l), coord_mask, pattern


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module")
def fold():
    """(jcfg, jax params, cfg, port model) with the LM frozen on the port."""
    jcfg, jparams, _, cfg, model = build(seed=3)
    training.split_fold_params(model)
    return jcfg, jparams, cfg, model


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


# -- the loss functions --------------------------------------------------------


def test_backbone_frames_and_fape_match():
    coords = synth_backbone(0, 2, 8)
    n, ca, c = (coords[..., i, :] for i in range(3))
    jr = jfl.backbone_frames(jnp.asarray(n), jnp.asarray(ca), jnp.asarray(c))
    tr = tfl.backbone_frames(_t(n), _t(ca), _t(c))
    np.testing.assert_allclose(tr.rots.numpy(), np.asarray(jr.rots), atol=1e-6)
    np.testing.assert_allclose(tr.trans.numpy(), np.asarray(jr.trans), atol=0)

    g = np.random.RandomState(1)
    q = g.randn(3, 2, 8, 4).astype(np.float32)
    t7 = np.concatenate([q / np.linalg.norm(q, axis=-1, keepdims=True),
                         g.randn(3, 2, 8, 3).astype(np.float32) * 5], -1)
    jp, tp = jfl.frames_from_tensor_7(jnp.asarray(t7)), tfl.frames_from_tensor_7(_t(t7))
    np.testing.assert_allclose(tp.rots.numpy(), np.asarray(jp.rots), atol=1e-6)
    pred = (ca[None] + g.randn(3, 2, 8, 3) * 2).astype(np.float32)
    w = np.ones((2, 8), np.float32)
    w[1, 5:] = 0
    for clamp in (10.0, 1.0):  # 1.0: most distances clamped
        want = jfl.fape(jp, jr, jnp.asarray(w), jnp.asarray(pred), jnp.asarray(ca),
                        jnp.asarray(w), clamp=clamp)
        got = tfl.fape(tp, tr, _t(w), _t(pred), _t(ca), _t(w), clamp=clamp)
        assert _rel(got, want) <= 1e-4, clamp


def test_pseudo_beta_distogram_lddt_match():
    coords = synth_backbone(2, 2, 9)
    aa = np.random.RandomState(3).randint(0, 20, (2, 9))
    aa[:, 4] = 7  # glycine
    pb = tfl.pseudo_beta(_t(aa), _t(coords))
    np.testing.assert_allclose(pb.numpy(), np.asarray(jfl.pseudo_beta(jnp.asarray(aa),
                                                                      jnp.asarray(coords))),
                               atol=1e-5)
    np.testing.assert_array_equal(pb[:, 4].numpy(), coords[:, 4, 1])
    bins = tfl.distogram_targets(pb)
    np.testing.assert_array_equal(bins.numpy(), np.asarray(jfl.distogram_targets(
        jnp.asarray(pb.numpy()))))
    pred = coords[..., 1, :] + np.random.RandomState(4).randn(2, 9, 3).astype(np.float32)
    m = np.ones((2, 9), np.float32)
    m[0, -3:] = 0
    np.testing.assert_allclose(
        tfl.lddt_ca(_t(pred), _t(coords[..., 1, :]), _t(m)).numpy(),
        np.asarray(jfl.lddt_ca(jnp.asarray(pred), jnp.asarray(coords[..., 1, :]),
                               jnp.asarray(m))), atol=1e-6)


# -- fold_loss and its gradients ------------------------------------------------


def jax_loss_and_grads(jcfg, jparams, batch, num_recycles, weights):
    aa, mask, coords, coord_mask, pattern = (None if x is None else jnp.asarray(x)
                                             for x in batch)
    trainable, frozen = jtraining.split_fold_params(jparams)

    def loss_fn(p):
        structure = jef.apply({**frozen, **p}, jcfg, aa, mask=mask, masking_pattern=pattern,
                              num_recycles=num_recycles)
        return jfl.fold_loss(structure, jcfg, aa, mask, coords, coord_mask, weights=weights,
                             masking_pattern=pattern)

    (loss, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(trainable)
    return float(loss), jax.tree.map(np.asarray, metrics), grads


def as_port_names(tree, jparams, cfg):
    """A trainable-shaped esm_tpu tree (gradients, stepped parameters) under
    the port's parameter names, the LM's entries dropped."""
    full = {**jax.tree.map(np.asarray, tree), "esm": jax.tree.map(np.asarray, jparams["esm"])}
    return {k: v for k, v in esmfold_state_dict_from_jax(full, cfg).items()
            if not k.startswith("esm.")}


def assert_grads_close(got, want, tol=GRAD_TOL, resolution=None):
    """Per tensor: |got - want| <= tol x the tensor's largest |want| (or
    1e-3 of the largest over all tensors), plus 2 ulp of ``resolution``'s
    tensor (the parameters whose fp32 rounding a step's change carries)."""
    assert set(got) == set(want)
    scale = max(float(w.abs().max()) for w in want.values())
    for name, g in got.items():
        w = want[name].numpy()
        bound = tol * max(np.abs(w).max(), 1e-3 * scale)
        if resolution is not None:
            bound += 2 * np.spacing(np.float32(resolution[name].abs().max()))
        err = np.abs(g.numpy() - w).max()
        assert err <= bound, f"{name}: {err} > {bound}"


@pytest.mark.parametrize("num_recycles,lm", [(0, False), (0, True), (1, False), (1, True)])
def test_fold_loss_and_grads_match_jax(fold, num_recycles, lm):
    jcfg, jparams, cfg, model = fold
    batch = fold_batch(10 + num_recycles)
    if not lm:
        batch = batch[:4] + (None,)
    lm_weight = 0.5 if lm else 0.0
    weights = (jfl.FoldLossWeights(lm=lm_weight), tfl.FoldLossWeights(lm=lm_weight))
    jloss, jmetrics, jgrads = jax_loss_and_grads(jcfg, jparams, batch, num_recycles, weights[0])

    model.zero_grad(set_to_none=True)
    t = [None if x is None else _t(x) for x in batch]
    loss, metrics = training._fold_loss(model, cfg, t, weights[1], num_recycles)
    loss.backward()
    assert ("lm_ce" in metrics) == lm
    assert _rel(loss.item(), jloss) <= 1e-5
    for k, v in metrics.items():
        assert _rel(v.item(), jmetrics[k]) <= 1e-5, k
    grads = {n: p.grad.clone() if p.grad is not None else torch.zeros_like(p)
             for n, p in training.trainable(model).items()}
    model.zero_grad(set_to_none=True)
    assert not any(n.startswith("esm.") for n in grads)
    assert "esm_s_combine" in grads and grads["esm_s_combine"].abs().max() > 0
    assert_grads_close(grads, as_port_names(jgrads, jparams, cfg))


def test_structure_module_rotation_stop_gradient(fold, monkeypatch):
    """IPA's gradients equal JAX's with the stop-gradient between blocks, and
    differ from them without it."""
    jcfg, jparams, cfg, model = fold
    rng = np.random.RandomState(20)
    b, l = 2, 9
    s = rng.randn(b, l, 32).astype(np.float32)
    z = rng.randn(b, l, l, 32).astype(np.float32)
    aa = rng.randint(0, 20, (b, l))
    mask = np.ones((b, l), np.float32)
    mask[1, 7:] = 0
    wpos = rng.randn(2, b, l, 14, 3).astype(np.float32)
    smc, jsmc = cfg.trunk.structure_module, jcfg.trunk.structure_module

    def jloss(p):
        out = jsm.structure_module_apply(p, jsmc, jnp.asarray(s), jnp.asarray(z),
                                         jnp.asarray(aa), jnp.asarray(mask))
        return jnp.sum(out["positions"] * wpos) + jnp.sum(out["frames"][..., :4])

    jg = jax.grad(jloss)(jparams["trunk"]["structure_module"])
    tree = jax.tree.map(lambda x: x * 0, jtraining.split_fold_params(jparams)[0])
    tree["trunk"]["structure_module"] = jg
    want = {k: v for k, v in as_port_names(tree, jparams, cfg).items()
            if k.startswith("trunk.structure_module.ipa.")}
    mod = model.trunk.structure_module

    def port_grads():
        mod.zero_grad(set_to_none=True)
        out = tsm.structure_module_apply(mod, smc, _t(s), _t(z), _t(aa), _t(mask))
        ((out["positions"] * _t(wpos)).sum() + out["frames"][..., :4].sum()).backward()
        g = {f"trunk.structure_module.{n}": p.grad.clone() for n, p in mod.named_parameters()
             if n.startswith("ipa.")}
        mod.zero_grad(set_to_none=True)
        return g

    assert_grads_close(port_grads(), want)
    monkeypatch.setattr(trg, "stop_rot_gradient", lambda r: r)
    with pytest.raises(AssertionError):
        assert_grads_close(port_grads(), want)


# -- the steps --------------------------------------------------------------------


def test_train_step_fold_matches_jax(fold):
    jcfg, jparams, cfg, model = fold
    batch = fold_batch(30)
    lr = 1e-2
    trainable, frozen = jtraining.split_fold_params(jparams)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(lr, eps=STEP_EPS))
    jstate = jtraining.init_state(jax.tree.map(jnp.copy, trainable), tx)
    jb = [jnp.asarray(x) for x in batch]
    jstate, jm = jtraining.train_step_fold(
        jstate, frozen, jcfg, tx, *jb[:4], masking_pattern=jb[4],
        weights=jfl.FoldLossWeights(lm=0.1), num_recycles=1)
    want = as_port_names(jstate.params, jparams, cfg)

    import copy

    stepped = copy.deepcopy(model)
    before = {k: v.clone() for k, v in stepped.esm.state_dict().items()}
    ttx = training.fold_optimizer(lr)
    ttx.eps = STEP_EPS
    state = training.init_state(stepped, ttx)
    assert set(state.opt_state.mu) == set(want)  # the LM is out of the optimizer's state
    t = [_t(x) for x in batch]
    state, m = training.train_step_fold(state, cfg, ttx, *t[:4], masking_pattern=t[4],
                                        weights=tfl.FoldLossWeights(lm=0.1), num_recycles=1)
    assert _rel(m["loss"].item(), float(jm["loss"])) <= 1e-5
    got = dict(stepped.named_parameters())
    start = dict(model.named_parameters())
    assert_grads_close({n: (got[n] - start[n]).detach() for n in want},
                       {n: w - start[n].detach() for n, w in want.items()}, resolution=want)
    assert all(torch.equal(v, before[k]) for k, v in stepped.esm.state_dict().items())


def test_fold_optimizer_matches_optax():
    """fold_optimizer against optax.chain(clip_by_global_norm(1.0),
    adamw(lr)) on the same gradients, 3 steps: b2 0.999, decay on every
    parameter (1-D ones too), the clip taking effect at step 1 only."""
    rng = np.random.RandomState(50)
    shapes = {"w": (4, 3), "b": (3,)}
    params = {k: rng.randn(*v).astype(np.float32) for k, v in shapes.items()}
    grads = [{k: (rng.randn(*v) * scale).astype(np.float32) for k, v in shapes.items()}
             for scale in (3.0, 0.1, 0.01)]
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1e-2))
    jp = jax.tree.map(jnp.asarray, params)
    opt = tx.init(jp)
    module = torch.nn.Module()
    for k, v in params.items():
        module.register_parameter(k, torch.nn.Parameter(_t(v.copy())))
    ttx = training.fold_optimizer(1e-2)
    state = ttx.init(module)
    for g in grads:
        upd, opt = tx.update(jax.tree.map(jnp.asarray, g), opt, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in module.named_parameters():
            p.grad = _t(g[k].copy())
        ttx.update(module, state)
    for k, p in module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), atol=1e-7, rtol=0)


def test_train_step_fold_refuses_unfrozen_lm():
    _, _, _, cfg, model = build(seed=4)
    tx = training.fold_optimizer()
    batch = [_t(x) for x in fold_batch(31)[:4]]
    with pytest.raises(ValueError, match="split_fold_params"):
        training.train_step_fold(training.init_state(model, tx), cfg, tx, *batch)


def test_train_step_fold_lora_matches_jax(fold):
    jcfg, jparams, cfg, model = fold
    batch = fold_batch(40, b=2, l=7)[:4]
    trainable, frozen = jtraining.split_fold_params(jparams)
    adapters = jlora.init_lora(jax.random.PRNGKey(5), trainable, rank=2,
                               targets=lambda path: True)
    # nonzero b, so that every adapter's a gets a gradient at the first step
    keys = iter(jax.random.split(jax.random.PRNGKey(6), 1000))
    adapters = jax.tree_util.tree_map_with_path(
        lambda p, x: x + 0.05 * jax.random.normal(next(keys), x.shape)
        if p[-1].key == "lora_b" else x, adapters)
    ported = lora_from_jax(jax.tree.map(np.asarray, adapters), model)
    # the same linears: every one of the trunk and heads, none of the LM
    names = {n for n, m in model.named_modules() if isinstance(m, torch.nn.Linear)
             and not n.startswith("esm.")}
    assert {n for n, _ in ported.adapters()} == names
    assert {n for n, _ in lora.init_lora(torch.Generator().manual_seed(0), model, rank=2,
                                         targets=lora.fold_targets).adapters()} == names

    lr = 1e-2
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(lr, eps=STEP_EPS))
    jstate = jtraining.init_state(adapters, tx)
    jstate, jm = jtraining.train_step_fold_lora(
        jstate, trainable, frozen, jcfg, tx, *(jnp.asarray(x) for x in batch))
    want = lora_from_jax(jax.tree.map(np.asarray, jstate.params), model)

    before = {k: v.clone() for k, v in model.state_dict().items()}
    start = {n: p.detach().clone() for n, p in ported.named_parameters()}
    ttx = training.fold_optimizer(lr)
    ttx.eps = STEP_EPS
    state = training.init_state(ported, ttx)
    state, m = training.train_step_fold_lora(state, model, cfg, ttx, *(_t(x) for x in batch))
    assert _rel(m["loss"].item(), float(jm["loss"])) <= 1e-5
    got = dict(ported.named_parameters())
    want = {n: w.detach() for n, w in want.named_parameters()}
    assert_grads_close({n: (got[n] - start[n]).detach() for n in start},
                       {n: w - start[n] for n, w in want.items()}, resolution=want)
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    assert all(not hasattr(m_, "lora") for m_ in model.modules())


def test_infer_outputs_carry_no_grad(fold):
    _, _, cfg, model = fold
    out = tef.infer(model, cfg, ["MKTAYIAKQR"], num_recycles=1)
    assert not any(v.requires_grad for v in out.values() if isinstance(v, torch.Tensor))
    assert torch.is_grad_enabled()
