"""esm-serve on the port: a long-lived embedding / scoring / folding /
design server with dynamic batching.

Port of esm_tpu/cli/serve.py, with the same flags. Concurrent requests
coalesce into shape-bucketed device batches (esm_tpu_torch/runtime/server.py).
Models load through the port's ``pretrained``, from the local cache only
(``ESM_TPU_CACHE``) or from a ``.pt`` path. Runs on the GPU; --nogpu runs on
the CPU, and without a GPU the run raises unless --nogpu is given. --bf16
computes the LM, and the fold trunk and its LM, in bfloat16; --flash
selects the flash-attention kernel (K1) for the LMs and the fused triangle
attention kernel (K6) for the trunk; --int8 quantizes the linear layers'
weights to int8; --fp32-precision turns TF32 off. Run it as

  python -m esm_tpu_torch.cli.serve esm2_t33_650M_UR50D --port 8080 --bf16 --flash
  curl -s localhost:8080/embed -d '{"sequences": ["MKTVRQERLK"], "include": ["mean"]}'
"""

from __future__ import annotations

import argparse
import time

import torch


def create_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument(
        "model_location", nargs="?", default=None,
        help="LM registry name (e.g. esm2_t33_650M_UR50D) or local checkpoint "
        "path; omit for a fold-only server",
    )
    p.add_argument(
        "--fold-model", default=None,
        help="also serve POST /fold from this ESMFold checkpoint name/path "
        "(e.g. esmfold_v1)",
    )
    p.add_argument(
        "--if-model", default=None,
        help="also serve POST /design (ESM-IF1 sequence design / backbone "
        "scoring) from this inverse-folding checkpoint name/path "
        "(e.g. esm_if1_gvp4_t16_142M_UR50)",
    )
    p.add_argument(
        "--max-fold-batch", type=int, default=4,
        help="max sequences per fold device batch (pair tensors are O(L^2))",
    )
    p.add_argument(
        "--fold-chunk-size", type=int, default=None,
        help="triangle-attention chunk size for long-sequence folds",
    )
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--max-batch", type=int, default=16, help="max sequences per device batch")
    p.add_argument(
        "--max-wait-ms", type=float, default=10.0,
        help="max time a request waits for batch-mates before dispatch",
    )
    p.add_argument(
        "--refill-wait-ms", type=float, default=80.0,
        help="the wait window used right after a FULL batch (saturation: its "
        "completion releases a wave of re-posts a short window would miss)",
    )
    p.add_argument(
        "--prewarm", action="store_true",
        help="run the embed path's standard (batch, length-bucket) shapes once "
        "at startup (builds the kernels, warms cuBLAS and the allocator)",
    )
    p.add_argument(
        "--prewarm-fold", default=None, metavar="L1,L2,...",
        help="also run the fold path once at these 64-bucketed lengths at startup",
    )
    p.add_argument(
        "--prewarm-design", default=None, metavar="L1,L2,...",
        help="also run the /design decode once at these (16-bucketed) backbone "
        "lengths at startup",
    )
    p.add_argument(
        "--batch-bucket", choices=["pow2", "max"], default="max",
        help="batch-dim padding: 'max' pads every multi-request batch to "
        "--max-batch (one shape per length bucket); 'pow2' pads to powers of two",
    )
    p.add_argument("--truncation-seq-length", type=int, default=1022)
    p.add_argument(
        "--max-fold-len", type=int, default=0,
        help="reject /fold sequences longer than this (folds cannot truncate). "
        "0 (the default) derives the cap from the memory plan for the loaded "
        "fold model's size, precision and device (memory_plan.max_fold_length "
        "at a full fold batch); a positive value overrides it",
    )
    p.add_argument(
        "--max-request-seqs", type=int, default=64,
        help="reject requests with more sequences than this (413-style guard)",
    )
    p.add_argument(
        "--max-queued-seqs", type=int, default=256,
        help="admission control: total admitted-but-unfinished sequences before "
        "new requests get 429 + Retry-After (bounds p95 under saturation)",
    )
    p.add_argument(
        "--max-queued-seconds", type=float, default=60.0,
        help="cost-weighted admission: cap on the ESTIMATED device-seconds of "
        "admitted-but-unfinished work (a fold costs hundreds of embeds, so "
        "this, not the sequence count, bounds drain time under mixed load); "
        "0 disables",
    )
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    p.add_argument("--flash", action="store_true",
                   help="the flash-attention (K1) and fused triangle-attention (K6) kernels")
    p.add_argument("--int8", action="store_true", help="weight-only int8 linear layers")
    p.add_argument(
        "--fp32-precision", action="store_true",
        help="turn TF32 off for matmuls and cuDNN (full fp32 numerics; slower)",
    )
    p.add_argument("--nogpu", action="store_true", help="run on the host CPU")
    return p


def start_server(args):
    """Build and start the InferenceServer from parsed CLI args (separate
    from run()'s blocking loop so tests and embedders can drive it)."""
    from .. import pretrained
    from ..runtime.server import InferenceServer

    device = pretrained.resolve_device("cpu" if args.nogpu else None)
    if args.fp32_precision:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    if args.model_location is None and args.fold_model is None and args.if_model is None:
        raise SystemExit(
            "esm-serve: give an LM model name and/or --fold-model/--if-model"
        )

    model = None
    if args.model_location is not None:
        model, _ = pretrained.load_model_and_alphabet(args.model_location, device=device)
        opts = {}
        if args.bf16:
            opts["compute_dtype"] = torch.bfloat16
        if args.flash:
            opts["use_flash"] = True
        if opts:
            model = model.with_options(**opts)
        if args.int8:
            model = model.quantized()

    fold_model = None
    if args.fold_model is not None:
        fold_model = pretrained.load_esmfold(args.fold_model, device=device)
        updates = {}
        if args.bf16:
            updates["compute_dtype"] = torch.bfloat16
            # the embedded LM dominates short-L fold compute: --bf16 casts it
            # too, not just the trunk
            updates["lm_dtype"] = torch.bfloat16
        if args.flash:
            updates["use_flash"] = True
            updates["use_flash_tri"] = True
        if args.fold_chunk_size is not None:
            updates["chunk_size"] = args.fold_chunk_size
        if updates:
            fold_model = fold_model.with_options(**updates)
        if args.int8:
            fold_model = fold_model.quantized()

    if_model = None
    if args.if_model is not None:
        if_model, _ = pretrained.load_model_and_alphabet(args.if_model, device=device)

    return InferenceServer(
        model,
        fold_model=fold_model,
        if_model=if_model,
        host=args.host,
        port=args.port,
        max_batch_seqs=args.max_batch,
        max_fold_batch_seqs=args.max_fold_batch,
        max_wait_ms=args.max_wait_ms,
        refill_wait_ms=args.refill_wait_ms,
        truncation_seq_length=args.truncation_seq_length,
        max_request_seqs=args.max_request_seqs,
        max_queued_seqs=args.max_queued_seqs,
        max_queued_seconds=args.max_queued_seconds or None,
        max_fold_seq_len=args.max_fold_len,
        batch_bucket=args.batch_bucket,
    ).start()


def run(args):
    server = start_server(args)
    for flag, fn, what in (
        (args.prewarm, lambda _: server.prewarm(), "(B, T)"),
        (args.prewarm_fold, server.prewarm_fold, "fold"),
        (args.prewarm_design, server.prewarm_design, "design"),
    ):
        if flag:
            lens = [int(x) for x in flag.split(",") if x.strip()] if isinstance(flag, str) else None
            t0 = time.perf_counter()
            n = fn(lens)
            print(f"esm-serve: prewarmed {n} {what} shapes in "
                  f"{time.perf_counter() - t0:.1f}s", flush=True)
    print(f"esm-serve: lm={args.model_location} fold={args.fold_model} "
          f"if={args.if_model} on "
          f"{server.url} (max_batch={args.max_batch}, wait={args.max_wait_ms}ms)", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        print("shutting down", flush=True)
        server.stop()


def main():
    run(create_parser().parse_args())


if __name__ == "__main__":
    main()
