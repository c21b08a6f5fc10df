"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a GPU every case skips. The module imports neither
JAX nor esm_tpu, so on a machine with a card and no JAX it runs without the
suite's conftest:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Tolerances: fp32 2e-5 absolute for the forward (fp32 FMA in the kernel, TF32
off in the plain version: summation order only), 1e-4 times the result's
magnitude for the lse and the gradients (longer sums); bf16 2e-2 times the
magnitude (the kernels round probabilities and dS to bf16 from fp32 values
that differ from the plain version's in the last bits, and round the result
to bf16).
"""

import numpy as np
import pytest
import torch

from esm_tpu_torch.kernels import flash_attention as fa

pytestmark = pytest.mark.cuda
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


def _inputs(b, h, t, s, d, dtype, device, seed=0, all_padding_row=True):
    rng = np.random.RandomState(seed)
    q = torch.from_numpy((rng.randn(b, h, t, d) * d ** -0.5).astype(np.float32))
    k = torch.from_numpy(rng.randn(b, h, s, d).astype(np.float32))
    v = torch.from_numpy(rng.randn(b, h, s, d).astype(np.float32))
    mask = torch.zeros(b, s, dtype=torch.bool)
    mask[-1, s - s // 3:] = True  # ragged
    if all_padding_row:           # every key padding: the row averages v over the S keys
        mask[0, :] = True
    return [x.to(device=device, dtype=dtype) for x in (q, k, v)] + [mask.to(device)]


def _rel_err(got, ref):
    return (got.float() - ref.float()).abs().max().item() / max(1.0, ref.float().abs().max().item())


# head widths: every multiple of 8 class the bf16 kernels pad differently
# (16-, 32-, 64- and 128-column tiles, two TMA boxes at 128); lengths around
# the 64- and 128-row tiles, T != S both ways
WIDTHS = [8, 16, 24, 32, 64, 96, 128]
LENGTHS = [(1, 1), (63, 65), (65, 63), (64, 64), (127, 129), (129, 127), (128, 128), (37, 37),
           (70, 300), (300, 70), (1000, 2100), (2100, 1000), (1024, 1024)]


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("t,s", LENGTHS + [(2100, 2100)])
def test_flash_attention_kernel_matches_plain(cuda, dtype, atol, d, t, s):
    q, k, v, mask = _inputs(2, 2, t, s, d, dtype, cuda)
    for rotary in (False, True):
        for m in (None, mask):
            before = fa.flash_attention.launches
            out = fa.flash_attention(q, k, v, key_padding_mask=m, rotary=rotary)
            ref = fa.flash_attention_reference(q, k, v, key_padding_mask=m, rotary=rotary)
            torch.cuda.synchronize()
            assert fa.flash_attention.launches == before + 1
            assert out.dtype == q.dtype and out.shape == q.shape
            err = (out.float() - ref.float()).abs().max().item()
            assert err <= atol, (rotary, m is not None, err)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
def test_flash_attention_kernel_at_the_esm1_shape(cuda, dtype, atol):
    """ESM-1's call: T = 1023 queries, S = T + 1 keys (the bias_kv row last,
    never masked), d = 64, no rotary; then, in fp32, the same through bias_kv
    self-attention: the flash path (K1) against the exact one."""
    from esm_tpu_torch.ops import attention as att

    t, s = 1023, 1024
    q, k, v, mask = _inputs(2, 20, t, s, 64, dtype, cuda, all_padding_row=False)
    mask[:, -1] = False
    for m in (None, mask):
        before = fa.flash_attention.launches
        out = fa.flash_attention(q, k, v, key_padding_mask=m)
        ref = fa.flash_attention_reference(q, k, v, key_padding_mask=m)
        torch.cuda.synchronize()
        assert fa.flash_attention.launches == before + 1
        assert (out.float() - ref.float()).abs().max().item() <= atol

    if dtype != torch.float32:
        return
    gen = torch.Generator(cuda).manual_seed(3)
    attn = att.SelfAttention(1280, 20, use_rotary=False, use_bias_kv=True, device=cuda)
    with torch.no_grad():
        for p in attn.parameters():
            p.copy_(torch.randn(p.shape, device=cuda, generator=gen) * p.shape[-1] ** -0.5)
        x = torch.randn(2, t, 1280, device=cuda, generator=gen)
        pad = torch.zeros(2, t, dtype=torch.bool, device=cuda)
        pad[1, 900:] = True
        kw = dict(num_heads=20, key_padding_mask=pad, use_bias_kv=True)
        before = fa.flash_attention.launches
        flash = att.multihead_attention(attn, x, use_flash=True, **kw).out
        assert fa.flash_attention.launches == before + 1
        exact = att.multihead_attention(attn, x, **kw).out
    assert _rel_err(flash, exact) <= 1e-4


def test_flash_attention_kernel_rejects_strided_input(cuda):
    q, k, v, _ = _inputs(1, 2, 16, 16, 16, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("t,s", LENGTHS)
def test_flash_backward_kernel_matches_plain(cuda, dtype, d, t, s):
    """K1 with the lse, then K2 (dq, dk, dv), against the plain versions on
    the same inputs, rotary off and on, mask off and ragged."""
    q, k, v, mask = _inputs(2, 2, t, s, d, dtype, cuda, seed=1)
    do = torch.randn(q.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(2))
    do = do.to(dtype)
    tol = GRAD_TOL[dtype]
    for rotary in (False, True):
        for m in (None, mask):
            before = fa.flash_attention_with_lse.launches
            out, lse, k_main = fa._forward(q, k, v, m, rotary, with_lse=True)
            ref_out, ref_lse = fa.flash_attention_reference(q, k, v, key_padding_mask=m,
                                                            rotary=rotary, return_lse=True)
            torch.cuda.synchronize()
            assert fa.flash_attention_with_lse.launches == before + 1
            assert _rel_err(out, ref_out) <= tol and _rel_err(lse, ref_lse) <= 1e-4
            n_dq, n_dkv = fa.flash_attention_bwd.launches_dq, fa.flash_attention_bwd.launches_dkv
            got = fa.flash_attention_bwd(q, k_main, v, out, lse, do, key_padding_mask=m,
                                         rotary=rotary)
            ref = fa.flash_attention_bwd_reference(q, k_main, v, out, lse, do,
                                                   key_padding_mask=m, rotary=rotary)
            torch.cuda.synchronize()
            assert fa.flash_attention_bwd.launches_dq == n_dq + 1
            assert fa.flash_attention_bwd.launches_dkv == n_dkv + 1
            for name, a, r in zip(("dq", "dk", "dv"), got, ref):
                assert a.dtype == dtype and a.shape == r.shape
                err = _rel_err(a, r)
                assert err <= tol, (name, rotary, m is not None, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_is_differentiable_on_cuda(cuda, dtype):
    """Outputs of inputs that require grad carry a grad_fn, and the gradients
    match autograd through the plain version."""
    # no all-padding row: there the kernels, like the TPU kernel and the plain
    # versions, recompute P = exp(s - lse) = 1 from an lse of -1e30 (the
    # log(S) term is lost in fp32), where autograd's softmax has 1 / S
    q, k, v, mask = _inputs(2, 4, 200, 200, 64, dtype, cuda, seed=3, all_padding_row=False)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    w = torch.randn(q.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(4))
    out = fa.flash_attention(q, k, v, key_padding_mask=mask, rotary=True)
    assert out.grad_fn is not None
    got = torch.autograd.grad((out.float() * w).sum(), (q, k, v))
    ref_out = fa.flash_attention_reference(q, k, v, key_padding_mask=mask, rotary=True)
    ref = torch.autograd.grad((ref_out.float() * w).sum(), (q, k, v))
    for name, a, r in zip("qkv", got, ref):
        assert _rel_err(a, r) <= GRAD_TOL[dtype], name
    with torch.no_grad():
        assert fa.flash_attention(q, k, v, key_padding_mask=mask).grad_fn is None


def test_flash_kernels_wrap_the_persistent_grid(cuda):
    """B.H = 80 heads of 8 query tiles: K1's persistent grid (one CTA per SM)
    walks 640 work tiles, more than twice round 132 SMs; K1 with and without
    the lse, and K2, against the plain versions."""
    dtype = torch.bfloat16
    q, k, v, mask = _inputs(4, 20, 1000, 1000, 64, dtype, cuda, seed=7)
    do = torch.randn(q.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(8))
    do = do.to(dtype)
    out = fa.flash_attention(q, k, v, key_padding_mask=mask, rotary=True)
    ref = fa.flash_attention_reference(q, k, v, key_padding_mask=mask, rotary=True)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    out, lse, k_main = fa._forward(q, k, v, mask, True, with_lse=True)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, key_padding_mask=mask, rotary=True,
                                                return_lse=True)
    assert _rel_err(out, ref) <= 2e-2 and _rel_err(lse, ref_lse) <= 1e-4
    got = fa.flash_attention_bwd(q, k_main, v, out, lse, do, key_padding_mask=mask, rotary=True)
    want = fa.flash_attention_bwd_reference(q, k_main, v, out, lse, do, key_padding_mask=mask,
                                            rotary=True)
    for name, a, r in zip(("dq", "dk", "dv"), got, want):
        assert _rel_err(a, r) <= GRAD_TOL[dtype], name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_are_deterministic(cuda, dtype):
    """The same call twice gives bitwise-equal K1 out and lse and K2 dq, dk
    and dv: no atomics, no dependence on the order blocks run in."""
    q, k, v, mask = _inputs(3, 20, 1000, 900, 64, dtype, cuda, seed=9)
    do = torch.randn(q.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(10))
    do = do.to(dtype)
    runs = []
    for _ in range(2):
        out, lse, k_main = fa._forward(q, k, v, mask, True, with_lse=True)
        grads = fa.flash_attention_bwd(q, k_main, v, out, lse, do, key_padding_mask=mask,
                                       rotary=True)
        runs.append((fa.flash_attention(q, k, v, key_padding_mask=mask, rotary=True), out, lse)
                    + tuple(grads))
    torch.cuda.synchronize()
    for name, a, b in zip(("out", "out (with lse)", "lse", "dq", "dk", "dv"), *runs):
        assert torch.equal(a, b), name


def test_k4_k5_entries_on_cuda(cuda):
    """K4 (forward with lse) and K5 (block backward): two key blocks' partials
    add up to the full gradients."""
    dtype = torch.float32
    q, k, v, mask = _inputs(2, 2, 150, 160, 32, dtype, cuda, seed=5)
    do = torch.randn(q.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(6))
    out, lse = fa.flash_attention_with_lse(q, k, v, key_padding_mask=mask)
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, key_padding_mask=mask,
                                                    return_lse=True)
    assert _rel_err(out, ref_out) <= 2e-5 and _rel_err(lse, ref_lse) <= 1e-4
    full = fa.flash_attention_block_bwd(q, k, v, out, lse, do, key_padding_mask=mask)
    parts = [
        fa.flash_attention_block_bwd(q, k[:, :, sl].contiguous(), v[:, :, sl].contiguous(), out,
                                     lse, do, key_padding_mask=mask[:, sl].contiguous())
        for sl in (slice(0, 64), slice(64, 160))
    ]
    assert _rel_err(parts[0][0] + parts[1][0], full[0]) <= 1e-4
    assert _rel_err(torch.cat([parts[0][1], parts[1][1]], 2), full[1]) <= 1e-4
    assert _rel_err(torch.cat([parts[0][2], parts[1][2]], 2), full[2]) <= 1e-4


# ---------------------------------------------------------------------------
# K6 (triangle attention), K7 and K8 (the tri-mul stages). Tolerances: fp32
# 2e-5 absolute for K6 (fp32 FMA, summation order only) and 5e-5 for K7/K8
# (the kernels' rsqrtf and expf against PyTorch's, C-term sums in another
# order); bf16 2e-2 times the result's magnitude (probabilities, normalized
# rows and outputs are rounded to bf16 from fp32 values that differ from the
# plain version's in the last bits).
# ---------------------------------------------------------------------------

from esm_tpu_torch.kernels import triangle_attention as ta  # noqa: E402
from esm_tpu_torch.kernels import triangle_mul as tm  # noqa: E402
from esm_tpu_torch.ops.triangle import TriangleMultiplication  # noqa: E402


def _k6_inputs(b, i, j, h, d, dtype, device, seed=0):
    rng = np.random.RandomState(seed)
    q = torch.from_numpy((rng.randn(b, i, j, h, d) * d ** -0.5).astype(np.float32))
    k = torch.from_numpy(rng.randn(b, i, j, h, d).astype(np.float32))
    v = torch.from_numpy(rng.randn(b, i, j, h, d).astype(np.float32))
    tri_bias = torch.from_numpy(rng.randn(b, h, j, j).astype(np.float32))
    keep = np.ones((b, i, j), bool)
    keep[-1, :, j - j // 3:] = False  # ragged keys
    keep[-1, -1, :] = False           # a padded residue: every key masked
    mask_bias = torch.from_numpy(np.where(keep, 0.0, ta.NEG_INF).astype(np.float32))
    return ([x.to(device=device, dtype=dtype) for x in (q, k, v)]
            + [tri_bias.to(device), mask_bias.to(device)])


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("j", [37, 256, 1000, 1100])
def test_triangle_attention_kernel_matches_plain(cuda, dtype, atol, d, j):
    args = _k6_inputs(1, 3, j, 4, d, dtype, cuda)
    before = ta.triangle_attention_fused.launches
    out = ta.triangle_attention_fused(*args)
    ref = ta.triangle_attention_reference(*args)
    torch.cuda.synchronize()
    assert ta.triangle_attention_fused.launches == before + 1
    assert out.dtype == dtype and out.shape == args[0].shape
    assert _rel_err(out, ref) <= atol


# The bf16 K6 kernel gives a CTA a group of rows i (2 at d = 32, 4 at d = 16,
# 1 at d = 128) and one 128-query tile, reads the bias by TMA (rows padded to
# a multiple of 4 floats when J is not) and takes 64-key tiles: J around those
# tiles and J % 4 != 0, every head-width class, B = 2 with the ragged mask on
# the last batch, and I that leaves the last group of each batch partial.
K6_WIDTHS = [8, 16, 32, 64, 128]
K6_LENGTHS = [1, 37, 63, 64, 65, 256, 1000, 1100]


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d", K6_WIDTHS)
@pytest.mark.parametrize("j", K6_LENGTHS)
def test_triangle_attention_kernel_shapes(cuda, dtype, atol, d, j):
    args = _k6_inputs(2, 5, j, 4, d, dtype, cuda, seed=j + d)
    out = ta.triangle_attention_fused(*args)
    ref = ta.triangle_attention_reference(*args)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == args[0].shape
    assert _rel_err(out, ref) <= atol


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("i", [1, 3, 5, 9])
@pytest.mark.parametrize("b", [1, 2])
def test_triangle_attention_kernel_row_groups(cuda, dtype, atol, d, i, b):
    """I not a multiple of the rows a CTA takes, so the last group of every
    batch is partial; with B = 2 a group never reaches into the next batch."""
    args = _k6_inputs(b, i, 65, 4, d, dtype, cuda, seed=10 * i + b)
    out = ta.triangle_attention_fused(*args)
    ref = ta.triangle_attention_reference(*args)
    torch.cuda.synchronize()
    assert _rel_err(out, ref) <= atol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_triangle_attention_kernel_all_masked_row(cuda, dtype):
    """A row i whose keys are all masked averages v over the J real keys."""
    q, k, v, tri, mask_bias = _k6_inputs(2, 5, 100, 4, 32, dtype, cuda, seed=3)
    out = ta.triangle_attention_fused(q, k, v, tri, mask_bias)
    torch.cuda.synchronize()
    want = v[-1, -1].float().mean(0, keepdim=True).expand(100, 4, 32)
    assert (out[-1, -1].float() - want).abs().max().item() <= 2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_triangle_attention_kernel_is_deterministic(cuda, dtype):
    """Two calls give bitwise-equal outputs: no atomics, no dependence on the
    order the CTAs run in."""
    args = _k6_inputs(2, 5, 1000, 4, 32, dtype, cuda, seed=4)
    a = ta.triangle_attention_fused(*args)
    b = ta.triangle_attention_fused(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def _tri_mul_module(c, device, seed):
    gen = torch.Generator().manual_seed(seed)
    mod = TriangleMultiplication(c)
    with torch.no_grad():
        for name, p in mod.named_parameters():
            scale = c ** -0.5 if name.endswith("weight") and p.dim() == 2 else 0.1
            p.normal_(generator=gen).mul_(scale)
            if name.startswith("layer_norm") and name.endswith("weight"):
                p.add_(1.0)
    return mod.to(device)


# K7 and K8 take C in {32, 64, 128}, read 64-row tiles (TMA zero-fills the
# rows past the end and clips the stores) on a persistent grid of one CTA per
# SM, two tiles at a time: row counts around the tile, and 16,901 rows, past
# one pass of the grid (132 x 2 x 64 = 16,896).
TRIMUL_ROWS = [1, 63, 64, 65, 127, 129, 231, 7474, 16901]


def _tri_mul_inputs(rows, c, dtype, mask, device, seed):
    rng = np.random.RandomState(seed)
    z = torch.from_numpy(rng.randn(1, rows, 1, c).astype(np.float32)).to(device, dtype)
    x = torch.from_numpy(rng.randn(1, rows, 1, c).astype(np.float32)).to(device, dtype)
    m = {"none": None,
         "ragged": (rng.rand(1, rows, 1) > 0.3).astype(np.float32),
         "zero": np.zeros((1, rows, 1), np.float32)}[mask]
    return z, x, None if m is None else torch.from_numpy(m).to(device, dtype)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("c", [32, 64, 128])
@pytest.mark.parametrize("rows", TRIMUL_ROWS)
@pytest.mark.parametrize("masked", ["none", "ragged", "zero"])
def test_tri_mul_kernels_match_plain(cuda, dtype, tol, c, rows, masked):
    """K7 with no mask, a ragged mask and an all-zero one (a and b exactly 0),
    and K8, against their plain versions. The module's weights require grad
    and the kernels have no backward, so the calls run under no_grad."""
    z, x, mask = _tri_mul_inputs(rows, c, dtype, masked, cuda, seed=c + rows)
    mod = _tri_mul_module(c, cuda, seed=c + 1)
    w4, b4, ln_s, ln_b = tm.stage1_weights(mod, dtype)
    n1, n2 = tm.tri_mul_stage1.launches, tm.tri_mul_epilogue.launches
    with torch.no_grad():
        a, b = tm.tri_mul_stage1(z, mask, mod)
        o = tm.tri_mul_epilogue(x, z, mod)
        ref_a, ref_b = tm.tri_mul_stage1_reference(
            z.reshape(rows, c), None if mask is None else mask.reshape(rows).to(torch.int8),
            w4, b4, ln_s, ln_b)
        ref_o = tm.tri_mul_epilogue_reference(x.reshape(rows, c), z.reshape(rows, c),
                                              *tm.epilogue_weights(mod, dtype))
    torch.cuda.synchronize()
    assert (tm.tri_mul_stage1.launches, tm.tri_mul_epilogue.launches) == (n1 + 1, n2 + 1)
    for got, ref in ((a, ref_a), (b, ref_b), (o, ref_o)):
        assert got.dtype == dtype and got.shape == z.shape
        assert _rel_err(got.reshape(rows, c), ref) <= tol
    if mask is not None:
        assert not a[mask == 0].any() and not b[mask == 0].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tri_mul_kernels_are_deterministic(cuda, dtype):
    """Two calls give bitwise-equal outputs: every element is written once."""
    z, x, mask = _tri_mul_inputs(16901, 128, dtype, "ragged", cuda, seed=9)
    mod = _tri_mul_module(128, cuda, seed=10)
    with torch.no_grad():
        first = (*tm.tri_mul_stage1(z, mask, mod), tm.tri_mul_epilogue(x, z, mod))
        second = (*tm.tri_mul_stage1(z, mask, mod), tm.tri_mul_epilogue(x, z, mod))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_triangle_kernels_refuse_gradients(cuda):
    """K6, K7 and K8 have no backward: on the card each raises, naming the
    kernel, when grad mode is on and an input or a weight requires grad, and
    runs under no_grad."""
    q, k, v, tri, mask_bias = _k6_inputs(1, 2, 64, 4, 32, torch.bfloat16, cuda)
    mod = _tri_mul_module(32, cuda, seed=3)  # its parameters require grad
    z, x, _ = _tri_mul_inputs(100, 32, torch.bfloat16, "none", cuda, seed=4)
    q_grad = q.clone().requires_grad_()
    z_grad = z.clone().requires_grad_()
    calls = [
        ("K6", lambda: ta.triangle_attention_fused(q_grad, k, v, tri, mask_bias)),
        ("K7", lambda: tm.tri_mul_stage1(z, None, mod)),        # a weight requires grad
        ("K7", lambda: tm.tri_mul_stage1(z_grad, None, mod)),   # and an input too
        ("K8", lambda: tm.tri_mul_epilogue(x, z, mod)),
        ("K8", lambda: tm.tri_mul_epilogue(x, z_grad, mod)),
    ]
    for name, call in calls:
        with pytest.raises(RuntimeError, match=rf"\({name}\).*no backward"):
            call()
        with torch.no_grad():
            call()
    torch.cuda.synchronize()


def test_if1_runs_on_cuda_by_default(cuda):
    """ESM-IF1 built with no device argument lives on the card: its
    parameters, the teacher-forced logits and the decoded tokens are CUDA
    tensors, and sample() draws the same sequence for the same seed."""
    from esm_tpu_torch import pretrained
    from esm_tpu_torch.models.inverse_folding import model as ifm

    handle, alphabet = pretrained.random_model_and_alphabet("esm_if1_gvp4_t16_142M_UR50", seed=1)
    assert all(p.device.type == "cuda" for p in handle.model.parameters())
    rng = np.random.RandomState(0)
    coords = np.cumsum(rng.normal(0, 1.0, (40, 3, 3)).astype(np.float32), axis=0) * 1.2
    bc, conf, _, tokens, pmask = ifm.CoordBatchConverter(alphabet)(
        [(coords, None, "A" * 40)], device="cuda")
    logits = handle.forward(bc, pmask, conf, tokens[:, :-1])
    assert logits.device.type == "cuda" and logits.shape == (1, len(alphabet), 40)
    assert torch.isfinite(logits).all()
    init = torch.full((2, 41), handle.cfg.mask_idx, dtype=torch.int64, device="cuda")
    init[:, 0] = handle.cfg.cath_idx
    drawn = ifm.sample_tokens(handle.model, bc, pmask, conf, init,
                              torch.Generator(device="cuda").manual_seed(0))
    assert drawn.device.type == "cuda" and drawn.shape == (2, 41)
    assert handle.sample(coords, seed=3) == handle.sample(coords, seed=3)


def test_lora_step_gradients_through_k1_k2(cuda):
    """A LoRA step's adapter gradients on the flash path (K1 with the lse
    forward, K2 backward, bf16) against the exact path's, nonzero b: cosine
    at least 0.99 and norm ratio within 5% (chip_smoke.py [train]'s
    bounds), with K2 launched once a layer."""
    import dataclasses

    from esm_tpu_torch import lora, training
    from esm_tpu_torch.data import Alphabet
    from esm_tpu_torch.models import esm2

    alphabet = Alphabet.from_architecture("ESM-1b")
    cfg = esm2.ESM2Config.from_alphabet(alphabet, num_layers=4, embed_dim=320,
                                        attention_heads=20, compute_dtype=torch.bfloat16,
                                        remat=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = esm2.init(cfg, gen, device="cuda")
    adapters = lora.init_lora(gen, model, rank=8)
    with torch.no_grad():
        for _, a in adapters.adapters():
            a.lora_b.normal_(0, 0.02, generator=gen)
    rng = np.random.RandomState(1)
    toks = torch.from_numpy(rng.randint(4, 24, (4, 200))).cuda()
    toks[:, 0] = alphabet.cls_idx
    toks[:, -1] = alphabet.eos_idx
    toks[1, 150:] = alphabet.padding_idx
    corrupted, target_mask = training._corrupt_batch(cfg, gen, toks)
    grads = {}
    for use_flash in (True, False):
        c = dataclasses.replace(cfg, use_flash=use_flash)
        fa.flash_attention_bwd.launches_dq = 0
        with training.frozen_and_patched(model, adapters, 1.0):
            loss, _ = training.mlm_loss(model, c, corrupted, toks, target_mask)
            loss.backward()
        if use_flash:
            assert fa.flash_attention_bwd.launches_dq == cfg.num_layers
        grads[use_flash] = torch.cat([p.grad.flatten().double() for p in adapters.parameters()])
        adapters.zero_grad(set_to_none=True)
    cos = torch.nn.functional.cosine_similarity(grads[True], grads[False], dim=0).item()
    ratio = (grads[True].norm() / grads[False].norm()).item()
    assert cos >= 0.99 and abs(ratio - 1) <= 0.05, (cos, ratio)


def test_int8_linear_on_cuda_equals_cpu(cuda):
    """The weight-only int8 linear (and its backward) on the card equals
    its CPU result (fp32, TF32 off: 1e-5 of the largest value)."""
    from esm_tpu_torch.ops.common import init_linear_torch_default, linear, new_linear
    from esm_tpu_torch.quantization import quantize_linear

    layer = quantize_linear(init_linear_torch_default(new_linear(256, 384),
                                                      torch.Generator().manual_seed(0)))
    x = torch.randn(8, 100, 256, generator=torch.Generator().manual_seed(1), requires_grad=True)
    y = linear(layer, x)
    y.square().sum().backward()
    layer_c = quantize_linear(init_linear_torch_default(new_linear(256, 384),
                                                        torch.Generator().manual_seed(0))).cuda()
    assert layer_c.weight.dtype == torch.int8
    xc = x.detach().cuda().requires_grad_()
    yc = linear(layer_c, xc)
    yc.square().sum().backward()
    assert _rel_err(yc.cpu(), y) <= 1e-5
    assert _rel_err(xc.grad.cpu(), x.grad) <= 1e-5
