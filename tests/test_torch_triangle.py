"""The port's triangle ops (esm_tpu_torch.ops.triangle) and the plain
versions of its kernels K6, K7 and K8 against esm_tpu on the CPU, on the
same weights and inputs (numpy seeds).

esm_tpu's Pallas kernels run in interpret mode here (their CPU default);
the port's wrappers run their plain versions on CPU tensors. fp32
throughout. Tolerance: 2e-5 absolute (esm_tpu's own fused-vs-exact bound,
tests/test_esmfold_trunk.py:357): both sides compute in fp32, and differ in
summation order and transcendental implementations only.

The exact and fused triangle-attention paths mask keys with different
constants (1e9·(mask - 1) against -1e30), which changes only rows whose
keys are all masked (padded residues); comparisons across the two paths,
and against esm_tpu's strip path at J > 1024 (which pads J), therefore
look at real pairs only. Comparisons of one path with its own counterpart
look at every position.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esm_tpu.kernels import triangle_attention as jta
from esm_tpu.kernels import triangle_mul as jtm
from esm_tpu.ops import triangle as jtri
from esm_tpu_torch.kernels import triangle_attention as ta
from esm_tpu_torch.kernels import triangle_mul as tm
from esm_tpu_torch.ops import triangle as tri

ATOL = 2e-5
C, HEADS = 32, 2


def _lin(rng, i, o, bias=True):
    p = {"kernel": (rng.randn(i, o) * i ** -0.5).astype(np.float32)}
    if bias:
        p["bias"] = (rng.randn(o) * 0.1).astype(np.float32)
    return p


def _ln(rng, c):
    return {"scale": (1 + 0.1 * rng.randn(c)).astype(np.float32),
            "bias": (0.1 * rng.randn(c)).astype(np.float32)}


def tri_mul_params(rng, c=C):
    p = {"layer_norm_in": _ln(rng, c), "layer_norm_out": _ln(rng, c)}
    for n in ("linear_a_p", "linear_a_g", "linear_b_p", "linear_b_g", "linear_g", "linear_z"):
        p[n] = _lin(rng, c, c)
    return p


def tri_att_params(rng, c=C, heads=HEADS):
    return {
        "layer_norm": _ln(rng, c),
        "linear": _lin(rng, c, heads, bias=False),
        "mha": {
            "linear_q": _lin(rng, c, c, bias=False),
            "linear_k": _lin(rng, c, c, bias=False),
            "linear_v": _lin(rng, c, c, bias=False),
            "linear_o": _lin(rng, c, c),
            "linear_g": _lin(rng, c, c),
        },
    }


@torch.no_grad()
def load_into(module, params):
    """Copy an esm_tpu-layout param dict into a port module of the same
    names (kernel (in, out) -> weight (out, in); LN scale -> weight)."""
    for name, p in params.items():
        sub = getattr(module, name)
        if "kernel" in p:
            sub.weight.copy_(torch.from_numpy(np.ascontiguousarray(p["kernel"].T)))
            if "bias" in p:
                sub.bias.copy_(torch.from_numpy(p["bias"]))
        elif "scale" in p:
            sub.weight.copy_(torch.from_numpy(p["scale"]))
            sub.bias.copy_(torch.from_numpy(p["bias"]))
        else:
            load_into(sub, p)
    return module


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _inputs(seed, b=2, l=9, masked=True, c=C):
    """z (B, L, L, C) and the pair mask of a ragged batch (the second
    sequence 2 residues short), or None."""
    rng = np.random.RandomState(seed)
    z = rng.randn(b, l, l, c).astype(np.float32)
    if not masked:
        return z, None
    m = np.ones((b, l), np.float32)
    m[1, l - 2:] = 0
    return z, (m[:, :, None] * m[:, None, :]).astype(np.float32)


def _assert_close(got, want, where=None, atol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    if where is not None:
        got, want = got[where.astype(bool)], want[where.astype(bool)]
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def _t(x):
    return None if x is None else torch.from_numpy(x)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("outgoing", [True, False])
def test_tri_mul_matches(outgoing, masked):
    params = tri_mul_params(np.random.RandomState(0))
    z, mask = _inputs(1, masked=masked)
    want = jtri.triangle_multiplicative_update(
        _jax(params), jnp.asarray(z), outgoing=outgoing,
        mask=None if mask is None else jnp.asarray(mask))
    mod = load_into(tri.TriangleMultiplication(C), params)
    with torch.no_grad():
        got = tri.triangle_multiplicative_update(mod, _t(z), outgoing=outgoing, mask=_t(mask))
    _assert_close(got.numpy(), want)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("outgoing", [True, False])
def test_tri_mul_fused_matches_jax_and_unfused(outgoing, masked):
    """K7 + einsum + K8 (plain versions) against esm_tpu's fused op (Pallas
    interpret), and against z + the unfused op."""
    params = tri_mul_params(np.random.RandomState(2))
    z, mask = _inputs(3, masked=masked)
    jm = None if mask is None else jnp.asarray(mask)
    want = jtri.triangle_multiplicative_update_fused(_jax(params), jnp.asarray(z),
                                                     outgoing=outgoing, mask=jm)
    mod = load_into(tri.TriangleMultiplication(C), params)
    before = (tm.tri_mul_stage1.launches, tm.tri_mul_epilogue.launches)
    with torch.no_grad():
        got = tri.triangle_multiplicative_update_fused(mod, _t(z), outgoing=outgoing,
                                                       mask=_t(mask))
        unfused = _t(z) + tri.triangle_multiplicative_update(mod, _t(z), outgoing=outgoing,
                                                             mask=_t(mask))
    assert (tm.tri_mul_stage1.launches, tm.tri_mul_epilogue.launches) == before  # plain on CPU
    _assert_close(got.numpy(), want)
    _assert_close(got.numpy(), unfused.numpy())


@pytest.mark.parametrize("masked", [False, True])
def test_k7_k8_plain_versions_match_jax(masked):
    """The plain versions of K7 and K8, row for row, against esm_tpu's
    tri_mul_stage1 and tri_mul_epilogue (Pallas interpret)."""
    params = tri_mul_params(np.random.RandomState(4))
    z, mask = _inputs(5, masked=masked)
    x = np.random.RandomState(6).randn(*z.shape).astype(np.float32)
    jp = _jax(params)
    ja, jb = jtm.tri_mul_stage1(jnp.asarray(z), None if mask is None else jnp.asarray(mask), jp)
    jo = jtm.tri_mul_epilogue(jnp.asarray(x), jnp.asarray(z), jp)
    mod = load_into(tri.TriangleMultiplication(C), params)
    with torch.no_grad():
        a, b = tm.tri_mul_stage1(_t(z), _t(mask), mod)
        o = tm.tri_mul_epilogue(_t(x), _t(z), mod)
    _assert_close(a.numpy(), ja)
    _assert_close(b.numpy(), jb)
    _assert_close(o.numpy(), jo)
    if masked:  # masked rows give exact zeros
        assert np.all(a.numpy()[mask == 0] == 0) and np.all(b.numpy()[mask == 0] == 0)


@pytest.mark.parametrize("path", ["exact", "chunk4", "chunk5", "chunk13", "fused"])
@pytest.mark.parametrize("starting", [True, False])
def test_triangle_attention_matches(starting, path):
    """Each path against esm_tpu's same path (every position), and against
    the exact path on real pairs, with a ragged mask."""
    params = tri_att_params(np.random.RandomState(7))
    z, mask = _inputs(8)
    kw = ({} if path == "exact" else {"use_flash": True} if path == "fused"
          else {"chunk_size": int(path[len("chunk"):])})
    want = jtri.triangle_attention(_jax(params), jnp.asarray(z), num_heads=HEADS,
                                   starting=starting, mask=jnp.asarray(mask), **kw)
    exact = jtri.triangle_attention(_jax(params), jnp.asarray(z), num_heads=HEADS,
                                    starting=starting, mask=jnp.asarray(mask))
    mod = load_into(tri.TriangleAttention(C, HEADS), params)
    before = ta.triangle_attention_fused.launches
    with torch.no_grad():
        got = tri.triangle_attention(mod, _t(z), num_heads=HEADS, starting=starting,
                                     mask=_t(mask), **kw).numpy()
    assert ta.triangle_attention_fused.launches == before  # the plain version on the CPU
    _assert_close(got, want)
    _assert_close(got, exact, where=mask)


def _k6_inputs(seed, b, i, j, h, d):
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, i, j, h, d) * d ** -0.5).astype(np.float32)
    k = rng.randn(b, i, j, h, d).astype(np.float32)
    v = rng.randn(b, i, j, h, d).astype(np.float32)
    tri_bias = rng.randn(b, h, j, j).astype(np.float32)
    keep = np.ones((b, i, j), bool)
    keep[-1, :, j - j // 3:] = False   # ragged keys
    keep[-1, -1, :] = False            # one row with every key masked
    mask_bias = np.where(keep, 0.0, ta.NEG_INF).astype(np.float32)
    return q, k, v, tri_bias, mask_bias, keep


@pytest.mark.parametrize("j", [37, 1100])
def test_k6_plain_version_matches_jax(j):
    """K6's plain version against esm_tpu's triangle_attention_fused (which
    takes (B, I, H, d, J); J = 1100 runs its padded query-strip path), on
    every row with an unmasked key."""
    b, i, h, d = 2, 3, 2, 16
    q, k, v, tri_bias, mask_bias, keep = _k6_inputs(9, b, i, j, h, d)

    def dj(x):
        return jnp.asarray(x.transpose(0, 1, 3, 4, 2))

    want = jta.triangle_attention_fused(dj(q), dj(k), dj(v), jnp.asarray(tri_bias),
                                        jnp.asarray(mask_bias))
    want = np.asarray(want).transpose(0, 1, 4, 2, 3)  # (B, I, J, H, d)
    got = ta.triangle_attention_fused(*map(torch.from_numpy, (q, k, v, tri_bias, mask_bias)))
    real = keep.any(-1)  # (B, I): rows with a key to attend to
    assert got.shape == q.shape and got.dtype == torch.float32
    _assert_close(got.numpy()[real], want[real])
    # a row whose keys are all masked averages v over the J real keys
    mean_v = np.broadcast_to(v[-1, -1].mean(0), v[-1, -1].shape)
    np.testing.assert_allclose(got.numpy()[-1, -1], mean_v, atol=ATOL)


def test_k6_plain_version_chunks_rows():
    """The plain version's row chunking changes memory, not results."""
    q, k, v, tri_bias, mask_bias, _ = _k6_inputs(10, 1, 5, 24, 2, 8)
    args = list(map(torch.from_numpy, (q, k, v, tri_bias, mask_bias)))
    whole = ta.triangle_attention_reference(*args)
    prev = ta._PLAIN_SCORES
    ta._PLAIN_SCORES = 2 * 24 * 24  # one row at a time
    try:
        rows = ta.triangle_attention_reference(*args)
    finally:
        ta._PLAIN_SCORES = prev
    assert torch.equal(whole, rows)


def test_kernel_wrappers_check_their_inputs():
    q = torch.zeros(1, 2, 5, 2, 16)
    with pytest.raises(ValueError, match="tri_bias"):
        ta.triangle_attention_fused(q, q, q, torch.zeros(1, 2, 5, 4), torch.zeros(1, 2, 5))
    with pytest.raises(ValueError, match="head dim"):
        q = torch.zeros(1, 2, 5, 2, 12)
        ta.triangle_attention_fused(q, q, q, torch.zeros(1, 2, 5, 5), torch.zeros(1, 2, 5))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tm.tri_mul_stage1(torch.zeros(1, 2, 2, 32, dtype=torch.float16), None,
                          tri.TriangleMultiplication(32))
