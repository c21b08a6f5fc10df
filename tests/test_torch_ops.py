"""The port's ops (esm_tpu_torch.ops) against esm_tpu.ops on the CPU, on the
same numpy inputs and parameters. fp32; tolerance 1e-5 absolute and relative
(one op each, differing only in summation order and transcendental
implementations), 1e-4 for the attention block (two matmuls deep)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esm_tpu.ops import attention as jatt
from esm_tpu.ops import common as jc
from esm_tpu.ops import heads as jh
from esm_tpu.ops import rotary as jrot
from esm_tpu_torch.ops import attention as tatt
from esm_tpu_torch.ops import common as tc
from esm_tpu_torch.ops import heads as th
from esm_tpu_torch.ops import rotary as trot

TOL = dict(atol=1e-5, rtol=1e-5)
rng = np.random.RandomState(0)


def _r(*shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _linear_pair(din, dout, bias=True):
    w = _r(dout, din, scale=din ** -0.5)
    b = _r(dout) if bias else None
    layer = tc.new_linear(din, dout, bias=bias)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(w))
        if bias:
            layer.bias.copy_(torch.from_numpy(b))
    params = {"kernel": jnp.asarray(w.T)}
    if bias:
        params["bias"] = jnp.asarray(b)
    return layer, params


def _ln_pair(d):
    w, b = _r(d) + 1.0, _r(d)
    ln = tc.new_layer_norm(d)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(w))
        ln.bias.copy_(torch.from_numpy(b))
    return ln, {"scale": jnp.asarray(w), "bias": jnp.asarray(b)}


@pytest.mark.parametrize("bias", [False, True])
def test_linear(bias):
    layer, params = _linear_pair(24, 40, bias)
    x = _r(3, 5, 24)
    np.testing.assert_allclose(
        tc.linear(layer, torch.from_numpy(x)).detach().numpy(),
        np.asarray(jc.linear(params, jnp.asarray(x))), **TOL,
    )


def test_linear_int8_matches_jax():
    """A weight-only int8 linear (ported since it raised): esm_tpu's
    quantize_linear and the port's give equal int8 values and scales, and
    the two linears agree on the same input."""
    from esm_tpu.quantization import quantize_linear as jquantize
    from esm_tpu_torch.quantization import quantize_linear

    layer, params = _linear_pair(24, 40)
    qparams = jquantize(params)
    quantize_linear(layer)
    assert layer.weight.dtype == torch.int8 and not layer.weight.requires_grad
    np.testing.assert_array_equal(layer.weight.numpy(), np.asarray(qparams["kernel"]).T)
    np.testing.assert_array_equal(layer.scale.numpy(), np.asarray(qparams["scale"]))
    x = _r(3, 5, 24)
    np.testing.assert_allclose(
        tc.linear(layer, torch.from_numpy(x)).detach().numpy(),
        np.asarray(jc.linear(qparams, jnp.asarray(x))), **TOL,
    )


@pytest.mark.parametrize("eps", [1e-5, 1e-12])
def test_layer_norm(eps):
    ln, params = _ln_pair(48)
    x = _r(4, 7, 48, scale=3.0)
    np.testing.assert_allclose(
        tc.layer_norm(ln, torch.from_numpy(x), eps).detach().numpy(),
        np.asarray(jc.layer_norm(params, jnp.asarray(x), eps)), **TOL,
    )


def test_layer_norm_bf16_returns_input_dtype():
    ln, _ = _ln_pair(16)
    y = tc.layer_norm(ln, torch.randn(2, 16).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16


@pytest.mark.parametrize(
    "name", ["gelu_erf", "softmax_fp32", "symmetrize", "apc"]
)
def test_elementwise_and_maps(name):
    x = _r(2, 3, 9, 9) + (3.0 if name == "apc" else 0.0)
    np.testing.assert_allclose(
        getattr(tc, name)(torch.from_numpy(x)).numpy(),
        np.asarray(getattr(jc, name)(jnp.asarray(x))), **TOL,
    )


@pytest.mark.parametrize("t,d", [(11, 16), (40, 64)])
def test_rotary(t, d):
    cos_t, sin_t = trot.rotary_tables(t, d)
    cos_j, sin_j = jrot.rotary_tables(t, d)
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), **TOL)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), **TOL)
    x = _r(2, 3, t, d)
    np.testing.assert_allclose(
        trot.apply_rotary(torch.from_numpy(x), cos_t, sin_t).numpy(),
        np.asarray(jrot.apply_rotary(jnp.asarray(x), cos_j, sin_j)), **TOL,
    )


def test_roberta_lm_head():
    d, vocab = 32, 33
    dense, pdense = _linear_pair(d, d)
    ln, pln = _ln_pair(d)
    emb = _r(vocab, d)
    bias = _r(vocab)
    head = th.RobertaLMHead(d, vocab, torch.nn.Parameter(torch.from_numpy(emb)))
    with torch.no_grad():
        head.dense.load_state_dict(dense.state_dict())
        head.layer_norm.load_state_dict(ln.state_dict())
        head.bias.copy_(torch.from_numpy(bias))
    x = _r(2, 6, d)
    out = th.roberta_lm_head(head, torch.from_numpy(x), head.weight).detach().numpy()
    ref = jh.roberta_lm_head(
        {"dense": pdense, "layer_norm": pln, "bias": jnp.asarray(bias)},
        jnp.asarray(x), jnp.asarray(emb),
    )
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)


def test_weighted_apc_symmetrize():
    a = np.abs(_r(2, 6, 10, 10))
    w = _r(6)
    np.testing.assert_allclose(
        th.weighted_apc_symmetrize(torch.from_numpy(a), torch.from_numpy(w)).numpy(),
        np.asarray(jh.weighted_apc_symmetrize(jnp.asarray(a), jnp.asarray(w))),
        atol=1e-5, rtol=1e-4,
    )


@pytest.mark.parametrize("prepend_bos,append_eos", [(True, True), (True, False)])
def test_contact_head(prepend_bos, append_eos):
    b, layers, heads, t = 2, 2, 3, 12
    tokens = rng.randint(4, 24, size=(b, t))
    if append_eos:
        tokens[0, -1] = 2
        tokens[1, 8] = 2
    att = np.abs(_r(b, layers, heads, t, t))
    head = th.ContactPredictionHead(layers * heads)
    reg, preg = _linear_pair(layers * heads, 1)
    head.regression.load_state_dict(reg.state_dict())
    out = th.contact_head(
        head, torch.from_numpy(tokens), torch.from_numpy(att),
        prepend_bos=prepend_bos, append_eos=append_eos, eos_idx=2,
    ).detach().numpy()
    ref = jh.contact_head(
        {"regression": preg}, jnp.asarray(tokens), jnp.asarray(att),
        prepend_bos=prepend_bos, append_eos=append_eos, eos_idx=2,
    )
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("need_weights", [False, True])
def test_multihead_attention(use_flash, need_weights):
    b, t, d, h = 2, 13, 32, 4
    attn = tatt.SelfAttention(d, h)
    params = {}
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        layer, params[name] = _linear_pair(d, d)
        getattr(attn, name).load_state_dict(layer.state_dict())
    x = _r(b, t, d)
    mask = np.zeros((b, t), bool)
    mask[1, 9:] = True
    out, probs = tatt.multihead_attention(
        attn, torch.from_numpy(x), num_heads=h, key_padding_mask=torch.from_numpy(mask),
        use_rotary=True, need_weights=need_weights, use_flash=use_flash,
    )
    ref = jatt.multihead_attention(
        params, jnp.asarray(x), num_heads=h, key_padding_mask=jnp.asarray(mask),
        use_rotary=True, need_weights=need_weights, use_flash=use_flash,
    )
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref.out), atol=1e-4, rtol=1e-4)
    if need_weights:
        np.testing.assert_allclose(probs.detach().numpy(), np.asarray(ref.probs), **TOL)
    else:
        assert probs is None


def test_bias_kv_and_ring_are_not_ported():
    """bias_kv attention (ESM-1) is ported now: the appended key shows as
    one more probability column. Ring attention is ported too
    (tests/test_torch_ring.py), but not with a bias_kv key (S = T + 1) or
    attention maps: those raise before any rank is contacted."""
    attn = tatt.SelfAttention(16, 2, use_bias_kv=True)
    torch.nn.init.normal_(attn.bias_k)
    torch.nn.init.normal_(attn.bias_v)
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        tc.init_linear(getattr(attn, name), torch.Generator().manual_seed(0))
    x = torch.randn(1, 3, 16, generator=torch.Generator().manual_seed(1))
    out, probs = tatt.multihead_attention(attn, x, num_heads=2, use_bias_kv=True,
                                          need_weights=True)
    assert out.shape == (1, 3, 16) and probs.shape == (1, 2, 3, 4)
    torch.testing.assert_close(probs.sum(-1), torch.ones(1, 2, 3))
    with pytest.raises(ValueError, match="ring attention takes no bias_kv"):
        tatt.multihead_attention(attn, x, num_heads=2, use_bias_kv=True, ring=("mesh", "tp"))
    with pytest.raises(ValueError, match="ring attention"):
        tatt.multihead_attention(attn, x, num_heads=2, need_weights=True, ring=("mesh", "tp"))
