#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (esm_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each raising on failure (nothing is caught):
  1. device   — the card's name and power limit;
  2. build    — builds the kernel libraries from the checkout's sources with
                nvcc, both at once: K1 (esm_tpu_torch/csrc/flash_attention.cu,
                the flash-attention forward, optionally writing the lse) and
                K2 (csrc/flash_attention_bwd.cu, the two-pass backward);
  3. kernels  — every kernel against its plain PyTorch version on the card,
                fp32 (TF32 off) and bf16, d in {16, 32, 64, 128}, T in {37,
                1000, 1024, 4096} and T != S, a ragged key-padding mask off
                and on, rotary off and on: K1 without the lse, K1 with it
                (output and lse), K2 (dq, dk, dv); then the K4 and K5 entries
                (a forward with the lse, and two key blocks' backward partials
                that add up to the whole);
  4. main     — the inference path: ESM2-650M (esm2_t33_650M_UR50D, 33 x
                1280, 20 heads; seeded random weights) in bf16 through LMHandle
                with the flash path at B=32, L=1022 (1024 tokens), as bench.py
                drives the JAX package: K1 must launch once per layer; logits
                held against the exact path and an fp32 forward; seq/s of both
                bf16 paths; then [k1], K1 timed at that shape;
  5. train    — the training path: ESM2-650M at full width and depth, fp32
                master weights, bf16 compute, flash attention and remat
                "dots", B=8 x 1024 tokens, AdamW (lr TRAIN_LR, warmup 1)
                for 6 steps on a fixed batch and corruption through
                esm_tpu_torch.training: the loss falls, K1-with-lse launches
                2 x 33 times a step (forward and recompute) and K2's dq and
                dk/dv passes 33 times each, the step-0 gradients of the flash
                path agree with the exact path's, seq/s and tok/s of both
                paths, peak memory, a profile of one step; then [k2], [k1-lse],
                [k4] and [k5], the kernels timed at that shape;
  6. cli      — esm-extract (esm_tpu_torch.cli.extract.run) on the card over a
                seeded FASTA with an esm2_t6_8M-shaped checkpoint written in
                the reference layout, its files checked against a CPU run; and
                a short esm_tpu_torch.cli.pretrain run on the card at the
                esm2_t6_8M shape (its defaults) with evaluation;
  7. summary  — the nvidia-smi line, a JSON line of the ported kernels, and
                as the last line {"ok": true, "device": {...}}.

Exits non-zero, with no result line, when there is no GPU or when the port's
package is not beside this file. Imports nothing of JAX or esm_tpu.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

H100_BF16_FLOPS = 989e12  # dense tensor-core peak, H100 SXM
H100_FP32_FLOPS = 67e12   # fp32 outside the tensor cores
H100_BYTES = 3.35e12      # HBM3 bytes/s
FP32_TOL = 2e-5           # K1 vs plain, fp32: summation order only
BF16_TOL = 2e-2           # K1 vs plain, bf16: P is rounded relative to the running max
# K1's lse and K2's gradients vs plain, as a share of the plain result's
# largest magnitude (at least 1): fp32 1e-4 (longer sums, exp2 against exp);
# bf16 2e-2 (P and dS are rounded to bf16 from fp32 values that differ from
# the plain version's in the last bits, and the results are rounded to bf16).
# The lse is fp32 in both dtypes: 1e-4.
GRAD_TOL = {"torch.float32": 1e-4, "torch.bfloat16": 2e-2}
LSE_TOL = 1e-4
TRAIN_STEPS = 6
TRAIN_LR = 1e-6  # larger rates raised the loss of this random init on a fixed batch (PERF.md)


def log(*a):
    print(*a, flush=True)


def cuda_time_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_inputs(b, h, t, d, dtype, masked, gen, s=None):
    import torch

    s = t if s is None else s
    q = (torch.randn(b, h, t, d, device="cuda", generator=gen) * d ** -0.5).to(dtype)
    k = torch.randn(b, h, s, d, device="cuda", generator=gen).to(dtype)
    v = torch.randn(b, h, s, d, device="cuda", generator=gen).to(dtype)
    mask = None
    if masked:
        mask = torch.zeros(b, s, dtype=torch.bool, device="cuda")
        mask[-1, s - s // 3:] = True  # ragged: the last row loses a third
    return q, k, v, mask


def rel_err(got, ref):
    """max |got - ref| over max(1, max |ref|)."""
    return ((got.float() - ref.float()).abs().max().item()
            / max(1.0, ref.float().abs().max().item()))


def phase_device():
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{name}; count {torch.cuda.device_count()}")
    log(f"[device] nvidia-smi: {smi}")
    return name, smi


def phase_build():
    from esm_tpu_torch.kernels import _build
    from esm_tpu_torch.kernels import flash_attention as fa

    t0 = time.perf_counter()
    fa.build()
    log(f"[build] K1 and K2 built/loaded in {time.perf_counter() - t0:.1f} s (nvcc, "
        + ", ".join(f"{n} {s:.1f} s" for n, s in _build.build_seconds.items()) + ")")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {name}: {line.strip()}")


def phase_kernels():
    import torch
    from esm_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 plain versions in full fp32
    cases = 0
    try:
        for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
            gtol = GRAD_TOL[str(dtype)]
            for d in (16, 32, 64, 128):
                for t, s in ((37, 37), (1000, 1000), (1024, 1024), (4096, 4096),
                             (1024, 300), (37, 1000)):
                    b, h = (1, 2) if max(t, s) == 4096 else (2, 4)
                    err = {"K1": 0.0, "out": 0.0, "lse": 0.0, "dq": 0.0, "dk": 0.0, "dv": 0.0}
                    for masked in (False, True):
                        q, k, v, mask = attention_inputs(b, h, t, d, dtype, masked, gen, s=s)
                        do = torch.randn(q.shape, device="cuda", generator=gen).to(dtype)
                        for rotary in (False, True):
                            where = (f"{dtype} d={d} T={t} S={s} masked={masked} "
                                     f"rotary={rotary}")
                            if t == s:  # K1 without the lse, as the inference path calls it
                                out = fa.flash_attention(q, k, v, key_padding_mask=mask,
                                                         rotary=rotary)
                                ref = fa.flash_attention_reference(q, k, v, key_padding_mask=mask,
                                                                   rotary=rotary)
                                torch.cuda.synchronize()
                                e = (out.float() - ref.float()).abs().max().item()
                                if not e <= tol:
                                    raise AssertionError(f"K1 {where}: max abs err {e} > {tol}")
                                err["K1"] = max(err["K1"], e)
                            # K1 with the lse, then K2 on its residuals
                            out, lse, k_main = fa._forward(q, k, v, mask, rotary, with_lse=True)
                            ref, ref_lse = fa.flash_attention_reference(
                                q, k, v, key_padding_mask=mask, rotary=rotary, return_lse=True)
                            torch.cuda.synchronize()
                            e_out = (out.float() - ref.float()).abs().max().item()
                            e_lse = rel_err(lse, ref_lse)
                            if not (e_out <= tol and e_lse <= LSE_TOL):
                                raise AssertionError(
                                    f"K1-lse {where}: out err {e_out} (<= {tol}), lse err "
                                    f"{e_lse} (<= {LSE_TOL})")
                            got = fa.flash_attention_bwd(q, k_main, v, out, lse, do,
                                                         key_padding_mask=mask, rotary=rotary)
                            want = fa.flash_attention_bwd_reference(
                                q, k_main, v, out, lse, do, key_padding_mask=mask, rotary=rotary)
                            torch.cuda.synchronize()
                            for name, a, r in zip(("dq", "dk", "dv"), got, want):
                                e = rel_err(a, r)
                                if not e <= gtol:
                                    raise AssertionError(f"K2 {name} {where}: err {e} > {gtol}")
                                err[name] = max(err[name], e)
                            err["out"] = max(err["out"], e_out)
                            err["lse"] = max(err["lse"], e_lse)
                            cases += 1
                    log(f"[kernels] {str(dtype):14s} d={d:3d} T={t:4d} S={s:4d} (B={b}, H={h}; "
                        f"mask off/ragged x rotary off/on): "
                        + ("" if t != s else f"K1 {err['K1']:.2e} <= {tol}; ")
                        + f"K1-lse out {err['out']:.2e} <= {tol}, lse {err['lse']:.2e} <= "
                        f"{LSE_TOL}; K2 dq {err['dq']:.2e} dk {err['dk']:.2e} "
                        f"dv {err['dv']:.2e} <= {gtol} (relative)")
        entries_check(gen)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    log(f"[kernels] K1, K1-lse and K2 match their plain versions at all {cases} cases")


def entries_check(gen):
    """K4 (forward with the lse, no rotary) and K5 (the backward against one
    key block from the global out/lse): against the plain versions, and two
    blocks' partials against the whole."""
    import torch
    from esm_tpu_torch.kernels import flash_attention as fa

    for dtype in (torch.float32, torch.bfloat16):
        tol, gtol = (FP32_TOL if dtype == torch.float32 else BF16_TOL), GRAD_TOL[str(dtype)]
        q, k, v, mask = attention_inputs(2, 4, 1000, 64, dtype, True, gen, s=1024)
        do = torch.randn(q.shape, device="cuda", generator=gen).to(dtype)
        out, lse = fa.flash_attention_with_lse(q, k, v, key_padding_mask=mask)
        ref, ref_lse = fa.flash_attention_reference(q, k, v, key_padding_mask=mask,
                                                    return_lse=True)
        e_out, e_lse = (out.float() - ref.float()).abs().max().item(), rel_err(lse, ref_lse)
        if not (e_out <= tol and e_lse <= LSE_TOL):
            raise AssertionError(f"K4 {dtype}: out err {e_out}, lse err {e_lse}")
        whole = fa.flash_attention_block_bwd(q, k, v, out, lse, do, key_padding_mask=mask)
        want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, key_padding_mask=mask)
        parts = [fa.flash_attention_block_bwd(q, k[:, :, sl].contiguous(),
                                              v[:, :, sl].contiguous(), out, lse, do,
                                              key_padding_mask=mask[:, sl].contiguous())
                 for sl in (slice(0, 320), slice(320, 1024))]
        torch.cuda.synchronize()
        joined = (parts[0][0].float() + parts[1][0].float(),
                  torch.cat([parts[0][1], parts[1][1]], 2), torch.cat([parts[0][2], parts[1][2]], 2))
        worst = 0.0
        for name, a, r, j in zip(("dq", "dk", "dv"), whole, want, joined):
            e, e_join = rel_err(a, r), rel_err(j, a)
            # dq of two bf16 partials is rounded twice: held to the bf16 tolerance
            if not (e <= gtol and e_join <= gtol):
                raise AssertionError(f"K5 {dtype} {name}: vs plain {e}, partials vs whole "
                                     f"{e_join} (<= {gtol})")
            worst = max(worst, e, e_join)
        log(f"[kernels] K4 {str(dtype):14s} B=2 H=4 T=1000 S=1024 d=64 ragged mask: out "
            f"{e_out:.2e} <= {tol}, lse {e_lse:.2e} <= {LSE_TOL}; K5 vs plain and two "
            f"blocks (320 + 704 keys) vs whole: {worst:.2e} <= {gtol} (relative)")


def bench_tokens(alphabet, b, length, seed=0):
    rng = np.random.RandomState(seed)
    toks = np.full((b, length + 2), alphabet.padding_idx, dtype=np.int64)
    toks[:, 0] = alphabet.cls_idx
    toks[:, 1:length + 1] = rng.randint(4, 24, size=(b, length))
    toks[:, length + 1] = alphabet.eos_idx
    return toks


def zero_counts():
    from esm_tpu_torch.kernels import flash_attention as fa

    fa.flash_attention.launches = 0
    fa.flash_attention_with_lse.launches = 0
    fa.flash_attention_bwd.launches_dq = 0
    fa.flash_attention_bwd.launches_dkv = 0


def read_counts():
    from esm_tpu_torch.kernels import flash_attention as fa

    return {"flash_attention": fa.flash_attention.launches,
            "flash_attention_with_lse": fa.flash_attention_with_lse.launches,
            "flash_attention_bwd.dq": fa.flash_attention_bwd.launches_dq,
            "flash_attention_bwd.dkv": fa.flash_attention_bwd.launches_dkv}


def phase_main(card):
    import torch
    from esm_tpu_torch import pretrained

    B, L = 32, 1022
    handle, alphabet = pretrained.random_model_and_alphabet(
        "esm2_t33_650M_UR50D", seed=0, device="cuda"
    )
    flash = handle.with_options(compute_dtype=torch.bfloat16, use_flash=True)
    exact = handle.with_options(compute_dtype=torch.bfloat16, use_flash=False)
    tokens = torch.from_numpy(bench_tokens(alphabet, B, L)).cuda()

    zero_counts()
    logits_flash = flash(tokens)["logits"]
    torch.cuda.synchronize()
    counts = read_counts()
    launches = counts["flash_attention"]
    log(f"[main] ESM2-650M bf16 flash forward B={B} T={L + 2}: K1 launched {launches} times "
        f"({handle.num_layers} layers); all counts {counts}")
    if launches != handle.num_layers or sum(counts.values()) != launches:
        raise AssertionError(f"launches {counts}, expected K1 x {handle.num_layers} only")

    logits_exact = exact(tokens)["logits"]
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    logits_f32 = handle(tokens)["logits"]
    torch.backends.cuda.matmul.allow_tf32 = prev
    scale = logits_f32.abs().max().item()
    diff = (logits_flash - logits_exact).abs().max().item()
    agree = (logits_flash.argmax(-1) == logits_exact.argmax(-1)).float().mean().item()
    err_flash = (logits_flash - logits_f32).abs().max().item()
    err_exact = (logits_exact - logits_f32).abs().max().item()
    log(f"[main] logits flash vs exact (bf16): max abs err {diff:.4f} (max |logit| {scale:.2f}), "
        f"argmax agreement {agree:.5f}")
    log(f"[main] against an fp32 exact forward: flash max abs err {err_flash:.4f}, "
        f"exact {err_exact:.4f}")
    # stated bf16 tolerances: the two routes differ only in how attention
    # rounds (exact rounds the scores to bf16, flash keeps them fp32), so the
    # flash route must stay within 5% of the logit range of the exact one,
    # pick the same token at >= 98% of positions, and be no further from fp32
    # than 1.5x the exact route's distance
    if not diff <= 0.05 * scale:
        raise AssertionError(f"flash vs exact logits differ by {diff} > {0.05 * scale}")
    if not agree >= 0.98:
        raise AssertionError(f"argmax agreement {agree} < 0.98")
    if not err_flash <= 1.5 * err_exact:
        raise AssertionError(f"flash route error {err_flash} > 1.5 x exact's {err_exact}")
    if not torch.isfinite(logits_flash).all():
        raise AssertionError("non-finite logits")

    rates = {}
    for name, h in (("flash", flash), ("exact", exact)):
        h(tokens)
        torch.cuda.synchronize()
        iters = 3
        t0 = time.perf_counter()
        for _ in range(iters):
            h(tokens)["logits"]
        torch.cuda.synchronize()
        rates[name] = B * iters / (time.perf_counter() - t0)
        log(f"[main] {name} path: {rates[name]:.3f} seq/s (ESM2-650M bf16, B={B}, L={L}; {card})")
    log(f"[main] flash / exact = {rates['flash'] / rates['exact']:.3f}")
    profile("one flash forward", lambda: flash(tokens))
    del handle, flash, exact, logits_flash, logits_exact, logits_f32
    torch.cuda.empty_cache()
    return launches


def profile(label, fn, top=8):
    """Device time by kernel over one call of ``fn`` (torch.profiler), and the
    share of its wall time during which some kernel ran (the union of the
    device events' intervals)."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in events):
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
        by_name[e.name][1] += 1
    total = sum(v[0] for v in by_name.values())
    log(f"[profile] {label}: wall {wall_ms:.2f} ms, device busy {busy_us / 1e3:.2f} ms "
        f"({100 * busy_us / 1e3 / wall_ms:.1f}%), kernel time {total:.2f} ms over "
        f"{len(events)} device events")
    for name, (ms, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"[profile]   {ms:9.3f} ms {100 * ms / max(total, 1e-9):5.1f}%  x{count:<5d} {name[:90]}")


def attention_bound_ms(flops, nbytes, peak=H100_BF16_FLOPS):
    t_ops, t_bytes = flops / peak * 1e3, nbytes / H100_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def measure_k1(launches):
    """K1 at the bench shape: the inference path's per-layer call; beside it
    the same call writing the lse (the training forward's variant)."""
    import torch
    import torch.nn.functional as F
    from esm_tpu_torch.kernels import flash_attention as fa
    from esm_tpu_torch.ops.rotary import apply_rotary, rotary_tables

    B, H, T, d = 32, 20, 1024, 64
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, _ = attention_inputs(B, H, T, d, torch.bfloat16, False, gen)
    mask = torch.zeros(B, T, dtype=torch.bool, device="cuda")  # as the main path passes it
    kernel = lambda: fa.flash_attention(q, k, v, key_padding_mask=mask, rotary=True)
    plain = lambda: fa.flash_attention_reference(q, k, v, key_padding_mask=mask, rotary=True)
    err = (kernel().float() - plain().float()).abs().max().item()
    cos, sin = rotary_tables(T, d, device="cuda")
    qr, kr = apply_rotary(q, cos, sin), apply_rotary(k, cos, sin)
    library = lambda: F.scaled_dot_product_attention(qr, kr, v, attn_mask=~mask[:, None, None, :],
                                                     scale=1.0)
    ms, plain_ms, lib_ms = cuda_time_ms(kernel), cuda_time_ms(plain), cuda_time_ms(library)
    lse_ms = cuda_time_ms(lambda: fa._forward(q, k, v, mask, True, with_lse=True))
    flops = 4 * B * H * T * T * d
    nbytes = 4 * B * H * T * d * 2 + B * T + 2 * T * d * 4  # q, k, v, o; mask; tables
    bound, by = attention_bound_ms(flops, nbytes)
    log(f"[k1] bench shape B={B} H={H} T=S={T} d={d} bf16 rotary: kernel {ms:.4f} ms, "
        f"with the lse {lse_ms:.4f} ms, plain {plain_ms:.4f} ms, scaled_dot_product_attention "
        f"(pre-rotated) {lib_ms:.4f} ms, bound {bound:.4f} ms; {flops / ms / 1e9:.1f} TFLOP/s; "
        f"max abs err {err:.3e}")

    q32, k32, v32 = q.float(), k.float(), v.float()
    ms32 = cuda_time_ms(lambda: fa.flash_attention(q32, k32, v32, key_padding_mask=mask,
                                                   rotary=True), iters=5)
    log(f"[k1] same shape fp32: kernel {ms32:.4f} ms, bound "
        f"{max(flops / H100_FP32_FLOPS, 2 * nbytes / H100_BYTES) * 1e3:.4f} ms (fp32 FMA)")
    if not err <= BF16_TOL:
        raise AssertionError(f"K1 at the bench shape: max abs err {err} > {BF16_TOL}")
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "esm_tpu_torch/csrc/flash_attention.cu",
        "replaces": "esm_tpu/kernels/flash_attention.py:394",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": lib_ms,
    }


def grads_of(model, cfg, batch):
    from esm_tpu_torch import training

    model.zero_grad(set_to_none=True)
    loss, _ = training.mlm_loss(model, cfg, *batch)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def phase_train(card):
    """ESM2-650M masked-LM training through esm_tpu_torch.training on the
    flash path (K1 with the lse forward, K2 backward) with remat "dots"."""
    import dataclasses

    import torch
    from esm_tpu_torch import pretrained, training

    B, L = 8, 1022
    handle, alphabet = pretrained.random_model_and_alphabet(
        "esm2_t33_650M_UR50D", seed=5, device="cuda"
    )
    model, n_layers = handle.model, handle.num_layers
    flash = dataclasses.replace(handle.cfg, compute_dtype=torch.bfloat16, use_flash=True,
                                remat=True, remat_policy="dots")
    exact = dataclasses.replace(flash, use_flash=False)
    tokens = torch.from_numpy(bench_tokens(alphabet, B, L, seed=6)).cuda()
    corrupted, target_mask = training._corrupt_batch(
        flash, torch.Generator(device="cuda").manual_seed(7), tokens)
    batch = (corrupted, tokens, target_mask)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[train] ESM2-650M ({n_params / 1e6:.1f}M parameters, fp32 master) bf16 compute, "
        f"remat 'dots', B={B} x {L + 2} tokens, {int(target_mask.sum())} masked targets")

    # step-0 gradients: flash path vs exact path, same weights and corruption
    loss_f, g_flash = grads_of(model, flash, batch)
    loss_e, g_exact = grads_of(model, exact, batch)
    worst_cos, worst_name, sq_f, sq_e = 2.0, "", 0.0, 0.0
    for name, gf in g_flash.items():
        ge = g_exact[name]
        sq_f += float(gf.double().pow(2).sum())
        sq_e += float(ge.double().pow(2).sum())
        if not name.endswith("weight"):
            continue
        cos = float(torch.nn.functional.cosine_similarity(gf.flatten().double(),
                                                          ge.flatten().double(), dim=0))
        if cos < worst_cos:
            worst_cos, worst_name = cos, name
    ratio = (sq_f / sq_e) ** 0.5
    log(f"[train] step-0 loss flash {loss_f:.5f} exact {loss_e:.5f}; gradients flash vs exact: "
        f"{len(g_flash)} tensors, lowest cosine over the weight tensors {worst_cos:.5f} "
        f"({worst_name}), global-norm ratio {ratio:.5f}")
    if g_flash.keys() != g_exact.keys():
        raise AssertionError("flash and exact paths give gradients to other parameters")
    if not (worst_cos >= 0.99 and abs(ratio - 1) <= 0.05):
        raise AssertionError(f"flash gradients disagree: cosine {worst_cos} ({worst_name}) "
                             f"< 0.99 or norm ratio {ratio} off by more than 5%")
    del g_flash, g_exact
    torch.cuda.empty_cache()

    tx = training.make_optimizer(TRAIN_LR, warmup_steps=1, total_steps=1000)
    state = training.init_state(model, tx)
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    zero_counts()
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = training.train_step_corrupted(state, flash, tx, *batch)
        losses.append(metrics["loss"].item())  # synchronises
        step_s.append(time.perf_counter() - t0)
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_step = {k: v / TRAIN_STEPS for k, v in counts.items()}
    want = {"flash_attention": 0, "flash_attention_with_lse": 2 * n_layers,
            "flash_attention_bwd.dq": n_layers, "flash_attention_bwd.dkv": n_layers}
    log(f"[train] flash path losses over {TRAIN_STEPS} steps: "
        + ", ".join(f"{x:.5f}" for x in losses))
    log(f"[train] launches per step {per_step} (expected {want}); whole run {counts}")
    if per_step != want:
        raise AssertionError(f"launches per step {per_step}, expected {want}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"losses not finite or not falling: {losses}")

    # one more step, split as train_step_corrupted runs it: the loss and its
    # gradients (forward, recompute, backward), then the AdamW update
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _ = training.mlm_loss(model, flash, *batch)
    loss.backward()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tx.update(model, state.opt_state)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    model.zero_grad(set_to_none=True)
    log(f"[train] one flash step split: loss and gradients {(t1 - t0) * 1e3:.1f} ms, AdamW "
        f"update {(t2 - t1) * 1e3:.1f} ms (host clock, synchronised)")

    exact_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        state, metrics = training.train_step_corrupted(state, exact, tx, *batch)
        metrics["loss"].item()
        exact_s.append(time.perf_counter() - t0)
    toks = B * (L + 2)
    rates = {}
    for name, times in (("flash", step_s[1:]), ("exact", exact_s[1:])):
        sec = sum(times) / len(times)
        rates[name] = sec
        log(f"[train] {name} path: {sec * 1e3:.1f} ms/step, {B / sec:.3f} seq/s, "
            f"{toks / sec:.1f} tok/s (ESM2-650M, remat dots, B={B}, L={L}; {card})")
    log(f"[train] flash / exact step time = {rates['flash'] / rates['exact']:.3f}; "
        f"peak memory over the flash steps {peak_gb:.2f} GB (torch.cuda.max_memory_allocated)")
    profile("one flash training step",
            lambda: training.train_step_corrupted(state, flash, tx, *batch)[1]["loss"].item(),
            top=12)
    del handle, model, state, tx, batch
    torch.cuda.empty_cache()
    return counts


def measure_backward(counts):
    """K1 with the lse (the training forward), K2, and the K4 and K5 entries,
    timed at the training path's attention shape."""
    import torch
    import torch.nn.functional as F
    from esm_tpu_torch.kernels import flash_attention as fa
    from esm_tpu_torch.ops.rotary import apply_rotary, rotary_tables

    B, H, T, d = 8, 20, 1024, 64
    gen = torch.Generator(device="cuda").manual_seed(8)
    q, k, v, _ = attention_inputs(B, H, T, d, torch.bfloat16, False, gen)
    do = torch.randn(q.shape, device="cuda", generator=gen).to(torch.bfloat16)
    mask = torch.zeros(B, T, dtype=torch.bool, device="cuda")  # as the training path passes it
    attn_mask = ~mask[:, None, None, :]
    cos, sin = rotary_tables(T, d, device="cuda")
    qr, kr = apply_rotary(q, cos, sin), apply_rotary(k, cos, sin)
    fwd_flops, bwd_flops = 4 * B * H * T * T * d, 10 * B * H * T * T * d
    act = B * H * T * d * 2  # one bf16 (B, H, T, d) tensor
    small = B * T + 2 * T * d * 4  # mask; rotary tables
    entries = []

    def sdpa_backward(qq, kk):
        qq, kk, vv = (x.detach().requires_grad_() for x in (qq, kk, v))
        o = F.scaled_dot_product_attention(qq, kk, vv, attn_mask=attn_mask, scale=1.0)
        return lambda: torch.autograd.grad(o, (qq, kk, vv), do, retain_graph=True)

    # K1 with the lse, rotary: the training forward's call
    out, lse, k_main = fa._forward(q, k, v, mask, True, with_lse=True)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, key_padding_mask=mask, rotary=True,
                                                return_lse=True)
    err = max((out.float() - ref.float()).abs().max().item(), rel_err(lse, ref_lse))
    ms = cuda_time_ms(lambda: fa._forward(q, k, v, mask, True, with_lse=True))
    plain_ms = cuda_time_ms(lambda: fa.flash_attention_reference(
        q, k, v, key_padding_mask=mask, rotary=True, return_lse=True))
    lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(qr, kr, v, attn_mask=attn_mask,
                                                                 scale=1.0))
    bound, by = attention_bound_ms(fwd_flops, 4 * act + B * H * T * 4 + small)
    log(f"[k1-lse] B={B} H={H} T=S={T} d={d} bf16 rotary: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, scaled_dot_product_attention (pre-rotated) {lib_ms:.4f} ms, bound "
        f"{bound:.4f} ms; {fwd_flops / ms / 1e9:.1f} TFLOP/s; {counts['flash_attention_with_lse']} "
        f"launches in the training run; err {err:.3e}")
    if not err <= BF16_TOL:
        raise AssertionError(f"K1-lse at the training shape: err {err}")
    entries.append({"name": "flash_attention_with_lse", "route": "cuda",
                    "source": "esm_tpu_torch/csrc/flash_attention.cu",
                    "replaces": "esm_tpu/kernels/flash_attention.py:938",
                    "launches": counts["flash_attention_with_lse"], "max_abs_err": err,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                    "library_ms": lib_ms})

    # K2 (rotate Q, delta, dq pass, dk/dv pass) on those residuals
    kernel = lambda: fa.flash_attention_bwd(q, k_main, v, out, lse, do, key_padding_mask=mask,
                                            rotary=True)
    plain = lambda: fa.flash_attention_bwd_reference(q, k_main, v, out, lse, do,
                                                     key_padding_mask=mask, rotary=True)
    err = max(rel_err(a, r) for a, r in zip(kernel(), plain()))
    ms, plain_ms, lib_ms = cuda_time_ms(kernel), cuda_time_ms(plain), cuda_time_ms(
        sdpa_backward(qr, kr))
    bound, by = attention_bound_ms(bwd_flops, 8 * act + B * H * T * 4 + small)
    log(f"[k2] B={B} H={H} T=S={T} d={d} bf16 rotary mask: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, scaled_dot_product_attention backward (pre-rotated, yardstick) "
        f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({by}); {bwd_flops / ms / 1e9:.1f} TFLOP/s of "
        f"the 10.B.H.T.S.d needed; {counts['flash_attention_bwd.dq'] / TRAIN_STEPS:.0f} dq and "
        f"{counts['flash_attention_bwd.dkv'] / TRAIN_STEPS:.0f} dk/dv launches per step; "
        f"err {err:.3e} (relative)")
    if not err <= GRAD_TOL["torch.bfloat16"]:
        raise AssertionError(f"K2 at the training shape: err {err}")
    entries.append({"name": "flash_attention_bwd", "route": "cuda",
                    "source": "esm_tpu_torch/csrc/flash_attention_bwd.cu",
                    "replaces": "esm_tpu/kernels/flash_attention.py:730",
                    "launches": counts["flash_attention_bwd.dq"], "max_abs_err": err,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                    "library_ms": lib_ms})

    # K4: the forward with the lse, no rotary (a measurement only: the entry
    # is not on the path, and its kernel is K1-lse's row above)
    ms = cuda_time_ms(lambda: fa.flash_attention_with_lse(q, k, v, key_padding_mask=mask))
    plain_ms = cuda_time_ms(lambda: fa.flash_attention_reference(q, k, v, key_padding_mask=mask,
                                                                 return_lse=True))
    lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                                                 scale=1.0))
    bound, by = attention_bound_ms(fwd_flops, 4 * act + B * H * T * 4 + B * T)
    log(f"[k4] flash_attention_with_lse B={B} H={H} T=S={T} d={d} bf16 no rotary: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, scaled_dot_product_attention {lib_ms:.4f} ms, "
        f"bound {bound:.4f} ms; 0 launches on the paths driven (not on them)")

    # K5: the backward against a key block, no rotary; timed with the whole key set
    out4, lse4 = fa.flash_attention_with_lse(q, k, v, key_padding_mask=mask)
    kernel = lambda: fa.flash_attention_block_bwd(q, k, v, out4, lse4, do, key_padding_mask=mask)
    plain = lambda: fa.flash_attention_bwd_reference(q, k, v, out4, lse4, do,
                                                     key_padding_mask=mask)
    err = max(rel_err(a, r) for a, r in zip(kernel(), plain()))
    ms, plain_ms, lib_ms = cuda_time_ms(kernel), cuda_time_ms(plain), cuda_time_ms(
        sdpa_backward(q, k))
    bound, by = attention_bound_ms(bwd_flops, 8 * act + B * H * T * 4 + B * T)
    log(f"[k5] flash_attention_block_bwd B={B} H={H} T=S={T} d={d} bf16 no rotary: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, scaled_dot_product_attention backward "
        f"{lib_ms:.4f} ms, bound {bound:.4f} ms; 0 launches on the paths driven (not on them); "
        f"err {err:.3e}")
    if not err <= GRAD_TOL["torch.bfloat16"]:
        raise AssertionError(f"K5 at the training shape: err {err}")
    entries.append({"name": "flash_attention_block_bwd", "route": "cuda",
                    "source": "esm_tpu_torch/csrc/flash_attention_bwd.cu",
                    "replaces": "esm_tpu/kernels/flash_attention.py:975",
                    "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound, "bound_by": by, "library_ms": lib_ms})
    return entries


def phase_cli():
    import torch
    from esm_tpu_torch import pretrained
    from esm_tpu_torch.cli import extract
    from esm_tpu_torch.io.export import save_esm2

    rng = np.random.RandomState(2)
    lengths = [30, 95, 257, 600, 1022]
    seqs = {f"p{i}": "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), n))
            for i, n in enumerate(lengths)}
    with tempfile.TemporaryDirectory() as tmp:
        handle, alphabet = pretrained.random_model_and_alphabet(
            "esm2_t6_8M_UR50D", seed=3, device="cpu"
        )
        gen = torch.Generator().manual_seed(4)
        with torch.no_grad():
            reg = handle.model.contact_head.regression
            reg.weight.normal_(generator=gen)
            reg.bias.fill_(-1.0)
        ckpt = os.path.join(tmp, "esm2_t6_8M_seeded.pt")
        save_esm2(handle.model, ckpt)
        fasta = os.path.join(tmp, "seqs.fasta")
        with open(fasta, "w") as f:
            for label, s in seqs.items():
                f.write(f">{label}\n{s}\n")
        out_dir = os.path.join(tmp, "out")
        args = extract.create_parser().parse_args(
            [ckpt, fasta, out_dir, "--include", "mean", "per_tok", "bos", "contacts",
             "--repr_layers", "0", "-1", "--fp32-precision"]
        )
        extract.run(args)

        cpu, _ = pretrained.load_model_and_alphabet_local(ckpt, device="cpu")
        conv = alphabet.get_batch_converter()
        worst = 0.0
        for label, s in seqs.items():
            got = torch.load(os.path.join(out_dir, f"{label}.pt"), weights_only=False)
            n = len(s)
            shapes = {
                "representations": (n, 320), "mean_representations": (320,),
                "bos_representations": (320,),
            }
            for key, shape in shapes.items():
                if sorted(got[key]) != [0, 6]:
                    raise AssertionError(f"{label}: {key} layers {sorted(got[key])}")
                for t in got[key].values():
                    if tuple(t.shape) != shape or not torch.isfinite(t).all():
                        raise AssertionError(f"{label}: bad {key} {tuple(t.shape)}")
            if tuple(got["contacts"].shape) != (n, n):
                raise AssertionError(f"{label}: contacts {tuple(got['contacts'].shape)}")
            if n <= 257:  # held against a CPU fp32 forward
                ref = cpu(conv([(label, s)])[2], repr_layers=[6], return_contacts=True)
                e1 = (got["mean_representations"][6]
                      - ref["representations"][6][0, 1:n + 1].mean(0)).abs().max().item()
                e2 = (got["contacts"] - ref["contacts"][0]).abs().max().item()
                worst = max(worst, e1, e2)
        if not worst <= 2e-4:
            raise AssertionError(f"extract on the card vs CPU: max abs err {worst} > 2e-4")
        log(f"[cli] esm-extract wrote {len(seqs)} files (lengths {lengths}); "
            f"vs a CPU forward: max abs err {worst:.2e} <= 2e-4")


def phase_cli_pretrain():
    """esm_tpu_torch.cli.pretrain on the card at its default size (the
    esm2_t6_8M shape: 6 x 320, 20 heads) with remat, evaluation and a saved
    checkpoint."""
    import torch
    from esm_tpu_torch.cli import pretrain
    from esm_tpu_torch.io.checkpoint import load_params

    rng = np.random.RandomState(9)
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name, n in (("train", 96), ("eval", 16)):
            paths[name] = os.path.join(tmp, f"{name}.fasta")
            with open(paths[name], "w") as f:
                for i in range(n):
                    seq = "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), rng.randint(50, 1100)))
                    f.write(f">{name}{i}\n{seq}\n")
        ckpt = os.path.join(tmp, "ckpt")
        args = pretrain.create_parser().parse_args(
            ["--fasta", paths["train"], "--steps", "8", "--log-every", "1", "--warmup-steps", "2",
             "--remat", "--eval-fasta", paths["eval"], "--eval-every", "4",
             "--checkpoint-dir", ckpt, "--seed", "3"])
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            state = pretrain.run(args)
        seconds = time.perf_counter() - t0
        out = buf.getvalue()
        for line in out.splitlines():
            log(f"[cli-pretrain] {line}")
        losses = [float(x) for x in re.findall(r"loss\s+([0-9.naif]+)", out)]
        ppl = [float(x) for x in re.findall(r"eval masked-ppl\s+([0-9.naif]+)", out)]
        params = load_params(ckpt)
        if state.model.embed_tokens.weight.device.type != "cuda":
            raise AssertionError("the pretrain CLI did not run on the card")
        if not (len(losses) == 8 and all(np.isfinite(losses)) and len(ppl) == 2
                and all(np.isfinite(p) and p > 1 for p in ppl)):
            raise AssertionError(f"pretrain CLI: losses {losses}, eval ppl {ppl}")
        if not all(torch.isfinite(t).all() for t in params.values()):
            raise AssertionError("pretrain CLI saved non-finite parameters")
        log(f"[cli-pretrain] 8 steps at the esm2_t6_8M shape in {seconds:.1f} s: losses "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}, eval masked-ppl {ppl}, {len(params)} saved "
            "tensors, all finite")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import esm_tpu_torch  # noqa: F401  (fails when run without the repo)

    t_start = time.perf_counter()
    card, smi = phase_device()
    phase_build()
    phase_kernels()
    k1 = measure_k1(phase_main(card))
    counts = phase_train(card)
    backward = measure_backward(counts)
    phase_cli()
    phase_cli_pretrain()
    log(f"[summary] all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": [k1] + backward}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
