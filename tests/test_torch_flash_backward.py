"""The differentiable flash attention of the port (K1 with the lse, K2, the
K4 and K5 entries; esm_tpu_torch.kernels.flash_attention) against esm_tpu's
Pallas kernels, run in interpret mode on the CPU as
tests/test_flash_attention.py runs them.

On the CPU the port runs the kernels' plain versions: the backward of
``FlashAttention`` is ``flash_attention_bwd_reference`` (the math K2
implements), not autograd of the forward. fp32 throughout; tolerance 1e-4
absolute on gradients and lse (as tests/test_flash_attention.py holds the
Pallas backward to autodiff), 1e-5 on forward outputs: both sides compute in
fp32 and differ in summation order. Inputs avoid query rows whose keys are
all masked (a known divergence, ROADMAP Queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esm_tpu.kernels import flash_attention as jfa
from esm_tpu_torch.kernels import flash_attention as fa

ATOL = 1e-4


def _inputs(b, h, t, s, d, masked, seed=0):
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, h, t, d) * d ** -0.5).astype(np.float32)
    k = rng.randn(b, h, s, d).astype(np.float32)
    v = rng.randn(b, h, s, d).astype(np.float32)
    w = rng.randn(b, h, t, d).astype(np.float32)  # output cotangent
    mask = None
    if masked:
        mask = np.zeros((b, s), bool)
        mask[-1, s - s // 3:] = True  # ragged: the last row loses its tail
    return q, k, v, w, mask


def _opt(x, lib):
    return None if x is None else lib(x)


def _jax_grads(q, k, v, w, mask, rotary):
    def loss(q, k, v):
        out = jfa.flash_attention(q, k, v, key_padding_mask=_opt(mask, jnp.asarray),
                                  rotary=rotary)
        return jnp.sum(out * w)

    g = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(x) for x in g]


def _torch_grads(q, k, v, w, mask, rotary):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(qt, kt, vt, key_padding_mask=_opt(mask, torch.from_numpy),
                             rotary=rotary)
    assert out.grad_fn is not None
    (out * torch.from_numpy(w)).sum().backward()
    return [x.grad.numpy() for x in (qt, kt, vt)]


def _assert_grads(q, k, v, w, mask, rotary):
    ref = _jax_grads(q, k, v, w, mask, rotary)
    got = _torch_grads(q, k, v, w, mask, rotary)
    for name, a, r in zip("qkv", got, ref):
        np.testing.assert_allclose(a, r, atol=ATOL, err_msg=f"d{name}")


@pytest.mark.parametrize("rotary", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("t", [37, 200])
@pytest.mark.parametrize("d", [16, 64])
def test_flash_backward_matches_jax_grad(d, t, masked, rotary):
    _assert_grads(*_inputs(2, 3, t, t, d, masked), rotary)


@pytest.mark.parametrize("t,s", [(40, 70), (70, 40)])
def test_flash_backward_matches_jax_grad_t_ne_s(t, s):
    _assert_grads(*_inputs(2, 2, t, s, 32, True, seed=4), True)


def test_flash_backward_matches_jax_grad_past_single_pass_limit():
    """T = S = 2100 > 2048: the TPU forward takes its blockwise body and the
    backward re-splits its key blocks."""
    _assert_grads(*_inputs(1, 2, 2100, 2100, 16, True, seed=3), True)


def test_backward_runs_the_plain_k2_on_cpu(monkeypatch):
    """On the CPU the autograd backward is flash_attention_bwd_reference."""
    calls = []
    real = fa.flash_attention_bwd_reference
    monkeypatch.setattr(fa, "flash_attention_bwd_reference",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    q, k, v, w, mask = _inputs(1, 2, 16, 16, 16, True)
    _torch_grads(q, k, v, w, mask, True)
    assert calls == [1]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("t,s", [(37, 37), (200, 200), (40, 70)])
def test_k4_with_lse_matches_jax(t, s, masked):
    q, k, v, _, mask = _inputs(2, 3, t, s, 32, masked, seed=5)
    out, lse = jfa.flash_attention_with_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            key_padding_mask=_opt(mask, jnp.asarray))
    tout, tlse = fa.flash_attention_with_lse(torch.from_numpy(q), torch.from_numpy(k),
                                             torch.from_numpy(v),
                                             key_padding_mask=_opt(mask, torch.from_numpy))
    assert tlse.shape == (2, 3, t) and tlse.dtype == torch.float32
    np.testing.assert_allclose(tout.numpy(), np.asarray(out), atol=1e-5)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(lse), atol=ATOL)


def test_plain_lse_is_the_log_sum_exp():
    q, k, v, _, mask = _inputs(2, 2, 30, 50, 16, True, seed=6)
    qt, kt, vt, mt = (torch.from_numpy(x) for x in (q, k, v, mask))
    _, lse = fa.flash_attention_reference(qt, kt, vt, key_padding_mask=mt, rotary=True,
                                          return_lse=True)
    cos, sin = fa.rotary_tables(50, 16)
    scores = fa._rotate_f32(qt, cos[:30], sin[:30]) @ fa._rotate_f32(kt, cos, sin).transpose(-1, -2)
    scores = scores.masked_fill(mt[:, None, None, :], -1e30)
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(scores, -1).numpy(), atol=1e-5)


def _block_case(seed=7):
    q, k, v, w, mask = _inputs(2, 2, 60, 90, 32, True, seed=seed)
    out, lse = fa.flash_attention_with_lse(torch.from_numpy(q), torch.from_numpy(k),
                                           torch.from_numpy(v),
                                           key_padding_mask=torch.from_numpy(mask))
    return q, k, v, w, mask, out, lse


def test_k5_block_bwd_matches_jax():
    q, k, v, w, mask, out, lse = _block_case()
    blk = slice(0, 40)
    ref = jfa.flash_attention_block_bwd(
        jnp.asarray(q), jnp.asarray(k[:, :, blk]), jnp.asarray(v[:, :, blk]),
        jnp.asarray(out.numpy()), jnp.asarray(lse.numpy()), jnp.asarray(w),
        key_padding_mask=jnp.asarray(mask[:, blk]),
    )
    got = fa.flash_attention_block_bwd(
        torch.from_numpy(q), torch.from_numpy(k[:, :, blk].copy()),
        torch.from_numpy(v[:, :, blk].copy()), out, lse, torch.from_numpy(w),
        key_padding_mask=torch.from_numpy(mask[:, blk].copy()),
    )
    for name, a, r in zip("qkv", got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=ATOL, err_msg=f"d{name}")


def test_block_partials_sum_to_the_full_gradients():
    q, k, v, w, mask, out, lse = _block_case(seed=8)
    parts = [
        fa.flash_attention_block_bwd(
            torch.from_numpy(q), torch.from_numpy(k[:, :, sl].copy()),
            torch.from_numpy(v[:, :, sl].copy()), out, lse, torch.from_numpy(w),
            key_padding_mask=torch.from_numpy(mask[:, sl].copy()),
        )
        for sl in (slice(0, 40), slice(40, 90))
    ]
    full = _torch_grads(q, k, v, w, mask, False)
    np.testing.assert_allclose((parts[0][0] + parts[1][0]).numpy(), full[0], atol=1e-5)
    np.testing.assert_allclose(torch.cat([parts[0][1], parts[1][1]], 2).numpy(), full[1],
                               atol=1e-5)
    np.testing.assert_allclose(torch.cat([parts[0][2], parts[1][2]], 2).numpy(), full[2],
                               atol=1e-5)


def test_no_grad_forward_keeps_no_graph():
    q, k, v, _, mask = (torch.from_numpy(x) if x is not None else None
                        for x in _inputs(1, 2, 16, 16, 16, True))
    q.requires_grad_()
    with torch.no_grad():
        assert fa.flash_attention(q, k, v, key_padding_mask=mask).grad_fn is None
    assert fa.flash_attention(q.detach(), k, v, key_padding_mask=mask).grad_fn is None


def test_bwd_wrapper_rejects_bad_residuals():
    q, k, v, w, mask = (torch.from_numpy(x) for x in _inputs(1, 2, 16, 16, 16, True))
    out, lse = fa.flash_attention_with_lse(q, k, v, key_padding_mask=mask)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd(q, k, v, out, lse[..., :-1], w)
    with pytest.raises(TypeError):
        fa.flash_attention_bwd(q, k, v, out.double(), lse, w)
