"""Masked-LM pretraining / fine-tuning of ESM-2 on the port, on one device or
on a mesh of them.

Port of examples/pretrain_mlm.py with the same flags and defaults: FASTA
data with token-budget batching (sequence axis padded to a multiple of
128), BERT-style masking, AdamW (esm_tpu_torch.training), optional
rematerialization, gradient accumulation, global-norm clipping, bf16 first
moments, masked-perplexity evaluation, and checkpoints that resume bit for
bit: the batch order and each step's corruption generator are functions of
(seed, step) alone.

    python -m esm_tpu_torch.cli.pretrain --fasta seqs.fasta --steps 100

Under torchrun (or in a process group already joined) the run shards the
model over a (data, fsdp, tp) mesh (esm_tpu_torch.parallel.sharding):
``MeshConfig.for_devices(world)``, or --data/--fsdp/--tp. No rank's card
holds the whole model: it is drawn a layer at a time and each layer cut as
it comes (--init-from reads the checkpoint on the host). Every rank reads
the same batch and keeps its rows (the batch is padded to a multiple of
data x fsdp x accum-steps with copies of its first row), prints the memory
plan of a rank (``plan_train_lora`` for --lora, ``plan_train(factored=True)``
for --adafactor) and the mesh-scaling warnings, and checkpoints gather the
whole model (rank 0 writes; --resume re-shards onto any mesh). With --lora
the frozen base is sharded and the adapters are whole on every rank
(their checkpoints are written by rank 0). Rank 0 logs.

    torchrun --nproc_per_node 4 -m esm_tpu_torch.cli.pretrain --fasta seqs.fasta [--lora 16]

A one-process run without a launcher is the one-device run.

--lora RANK fine-tunes rank-RANK LoRA adapters (esm_tpu_torch.lora) on a
frozen base: bf16 compute, the flash path and remat "dots" ("full" with
--lora-full-remat), the base stored in bf16 (weight-only int8 with
--lora-int8-base), the adapters drawn from seed + 3, scaled by
alpha / rank; the final save is the merged model, or the adapters alone
over an int8 base. --adafactor trains with adafactor instead of AdamW.

Runs on the GPU (on a mesh, the GPU of each rank's LOCAL_RANK); --cpu
runs on the CPU (gloo on a mesh), and without a GPU the run raises unless
--cpu is given.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import math
import os
import time

import numpy as np
import torch
import torch.distributed as dist


def create_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--fasta", required=True, help="training sequences (FASTA)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--toks-per-batch", type=int, default=8192)
    p.add_argument("--truncation-seq-length", type=int, default=1022)
    p.add_argument("--num-layers", type=int, default=6)
    p.add_argument("--embed-dim", type=int, default=320)
    p.add_argument("--attention-heads", type=int, default=20)
    p.add_argument("--lr", type=float, default=4e-4)
    p.add_argument("--warmup-steps", type=int, default=10)
    p.add_argument(
        "--init-from", default=None,
        help="warm-start from a checkpoint in the reference's .pt layout (a "
        "path, or a registry name in the local cache) instead of random init",
    )
    p.add_argument(
        "--remat", action="store_true",
        help="rematerialize layer bodies on backward (activation memory "
        "independent of depth; ~constant-factor extra compute)",
    )
    p.add_argument("--checkpoint-dir", default=None, help="directory for the final params")
    p.add_argument(
        "--save-every", type=int, default=0,
        help="also save the FULL train state (params+optimizer+step) every N "
        "steps to the sibling dir <checkpoint-dir>-state for --resume",
    )
    p.add_argument(
        "--resume", action="store_true",
        help="restore <checkpoint-dir>-state and continue; the per-step "
        "generator is seeded from the step index, so the resumed run is bit-exact",
    )
    p.add_argument(
        "--accum-steps", type=int, default=1,
        help="gradient accumulation: split each batch into N sequential "
        "microbatches (exact big-batch equivalence)",
    )
    p.add_argument("--grad-clip", type=float, default=None, help="global-norm gradient clip")
    p.add_argument(
        "--lora", type=int, default=0, metavar="RANK",
        help="parameter-efficient fine-tuning: freeze the base model and train "
        "rank-RANK LoRA adapters on the attention/MLP linears (esm_tpu_torch.lora); "
        "the optimizer state covers only the adapters",
    )
    p.add_argument(
        "--lora-alpha", type=float, default=None,
        help="LoRA alpha; the adapter delta is scaled by alpha/rank (default: alpha = rank)",
    )
    p.add_argument(
        "--lora-int8-base", action="store_true",
        help="with --lora: store the frozen base weight-only int8 instead of bf16",
    )
    p.add_argument(
        "--lora-full-remat", action="store_true",
        help="with --lora: save nothing per layer on the forward (remat_policy 'full'): "
        "least activation memory, about a third more operations",
    )
    p.add_argument(
        "--adafactor", action="store_true",
        help="factored second-moment optimizer (state ~params/1000 instead of 2x params)",
    )
    p.add_argument(
        "--bf16-moments", action="store_true",
        help="store AdamW first moments in bfloat16 (halves their memory)",
    )
    p.add_argument(
        "--stop-after", type=int, default=0,
        help="exit after this step (simulated pre-emption; LR schedule still "
        "targets --steps, so a later --resume continues bit-exactly)",
    )
    p.add_argument("--eval-fasta", default=None, help="held-out FASTA for masked-ppl eval")
    p.add_argument("--eval-every", type=int, default=0, help="eval every N steps (and at the end)")
    p.add_argument(
        "--shuffle", action="store_true",
        help="deterministically shuffle batch order each epoch (seeded by "
        "(seed, epoch), so --resume stays bit-exact)",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--cpu", action="store_true", help="run on the CPU even when a GPU is present")
    for axis in ("data", "fsdp", "tp"):
        p.add_argument(f"--{axis}", type=int, default=None,
                       help=f"on a mesh: the {axis} axis's size (default: "
                       "MeshConfig.for_devices of the world size; give all three)")
    return p


def _mesh_config(args, world: int):
    from ..parallel.mesh import MeshConfig

    given = [getattr(args, a) for a in ("data", "fsdp", "tp")]
    if all(g is None for g in given):
        return MeshConfig.for_devices(world)
    return MeshConfig(*(g or 1 for g in given))


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, step) alone."""
    value = int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(value & ((1 << 63) - 1))


def _lora_base(args, cfg, model):
    """The --lora configuration (esm_tpu's measured LoRA recipe): bf16
    compute, flash attention and remat; the frozen base in bf16, or
    weight-only int8 over the fp32 weights. Returns (cfg, scale)."""
    from ..lora import store_base

    if args.accum_steps > 1:
        raise SystemExit(
            "--lora does not compose with --accum-steps yet; LoRA's memory savings "
            "usually make accumulation unnecessary"
        )
    cfg = dataclasses.replace(cfg, compute_dtype=torch.bfloat16, use_flash=True, remat=True,
                              remat_policy="full" if args.lora_full_remat else "dots")
    store_base(model, int8=args.lora_int8_base)
    alpha = args.lora_alpha if args.lora_alpha is not None else float(args.lora)
    return cfg, alpha / args.lora


def run(args):
    """Train as the flags say. Returns the final ``training.TrainState``."""
    from .. import pretrained, training
    from ..data import Alphabet, FastaBatchedDataset
    from .. import lora
    from ..io.checkpoint import load_train_state, save_params, save_train_state
    from ..models import esm2
    from ..parallel.sharding import batch_rows, dp_sum, sharding_of

    mesh = mesh_cfg = None
    say = print
    if "WORLD_SIZE" in os.environ or dist.is_initialized():
        from ..parallel.mesh import init_multihost, make_mesh

        device_type = "cpu" if args.cpu else None
        rank = init_multihost(device_type=device_type)
        mesh_cfg = _mesh_config(args, dist.get_world_size())
        mesh = make_mesh(mesh_cfg, device_type)
        if rank:
            say = lambda *a, **k: None  # noqa: E731  (rank 0 logs)
    device = pretrained.resolve_device("cpu" if args.cpu else None)
    # on a mesh no rank holds the whole model on its device: a warm start is
    # read on the host and its shards moved over, a random one drawn a layer
    # at a time and each layer cut as it comes (shard_params)
    if args.init_from:
        handle, alphabet = pretrained.load_model_and_alphabet(
            args.init_from, device="cpu" if mesh is not None else device)
        cfg = dataclasses.replace(handle.cfg, remat=args.remat)
        model = handle.model
        say(f"warm start from {args.init_from} ({cfg.num_layers} layers)")
    else:
        alphabet = Alphabet.from_architecture("ESM-1b")
        cfg = esm2.ESM2Config.from_alphabet(
            alphabet, num_layers=args.num_layers, embed_dim=args.embed_dim,
            attention_heads=args.attention_heads, remat=args.remat,
        )
        build = esm2.init if mesh is None else esm2.init_parts
        model = build(cfg, torch.Generator(device=device).manual_seed(args.seed), device=device)
    say(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})"
                               if device.type == "cuda" else ""))

    dataset = FastaBatchedDataset.from_file(args.fasta)
    batches = dataset.get_batch_indices(args.toks_per_batch, extra_toks_per_seq=2)
    converter = alphabet.get_batch_converter(args.truncation_seq_length, pad_to_multiple=128)
    say(f"{len(dataset)} sequences, {len(batches)} batches/epoch")
    dp = 1  # the batch's row shards: data x fsdp on a mesh
    if mesh is not None:
        from ..parallel.sharding import shard_params

        model = shard_params(model, mesh).to(device)
        dp = mesh_cfg.data * mesh_cfg.fsdp

    base = lora_scale = None
    if args.lora:
        cfg, lora_scale = _lora_base(args, cfg, model)
        base = model
    if mesh is not None:
        _print_plan(args, cfg, mesh_cfg, device, say)

    warmup = min(args.warmup_steps, max(1, args.steps // 5))
    tx = training.make_optimizer(
        args.lr, warmup_steps=warmup, total_steps=max(args.steps, warmup + 1),
        grad_clip_norm=args.grad_clip,
        mu_dtype=torch.bfloat16 if args.bf16_moments else None,
        factored=args.adafactor,
    )
    if args.lora:
        adapters = lora.init_lora(torch.Generator(device=device).manual_seed(args.seed + 3),
                                  base, rank=args.lora)
        shard = sharding_of(base)  # on a mesh, the whole base's parameters
        n_base = sum(math.prod(shard.whole_shape(n, p.shape)) if shard else p.numel()
                     for n, p in base.named_parameters())
        say(f"LoRA rank {args.lora}: {lora.num_params(adapters) / 1e6:.2f}M trainable "
            f"adapters on a frozen {n_base / 1e6:.0f}M base"
            + (" (int8)" if args.lora_int8_base else " (bf16)"))
        state = training.init_state(adapters, tx)
    else:
        state = training.init_state(model, tx)

    start_step = 0
    state_dir = f"{args.checkpoint_dir}-state" if args.checkpoint_dir else None
    if args.resume:
        if not (state_dir and os.path.isdir(state_dir)):
            raise SystemExit(f"--resume: no saved state at {state_dir}")
        state = load_train_state(state_dir, state)
        start_step = state.step
        say(f"resumed from {state_dir} at step {start_step}")

    eval_batches = None
    if args.eval_fasta:
        eval_ds = FastaBatchedDataset.from_file(args.eval_fasta)
        eval_idx = eval_ds.get_batch_indices(args.toks_per_batch, extra_toks_per_seq=2)
        eval_batches = [converter([eval_ds[i] for i in b])[2] for b in eval_idx]

    def run_eval(step):
        nll = cnt = 0.0
        patched = (lora.patch(base, state.model, scale=lora_scale) if args.lora
                   else contextlib.nullcontext(state.model))
        with patched as eval_model:
            for j, toks in enumerate(eval_batches):
                real = toks.shape[0]
                toks = pad_rows(toks, dp)  # eval never accumulates
                sums = training.eval_step(eval_model, cfg,
                                          step_generator(args.seed + 2, j, device),
                                          toks.to(device))
                keep = torch.arange(toks.shape[0], device=device) < real  # not the copies
                if mesh is not None:
                    keep = batch_rows(keep, sharding_of(eval_model))
                nll_cnt = torch.stack([sums["nll_sum"][keep].sum(), sums["count"][keep].sum()])
                if mesh is not None:
                    dp_sum(nll_cnt, sharding_of(eval_model))
                nll += float(nll_cnt[0])
                cnt += float(nll_cnt[1])
        say(f"step {step:5d}  eval masked-ppl {np.exp(nll / max(cnt, 1)):8.3f}")

    perm_cache = {}

    def batch_for_step(step):
        """Batch order is a pure function of (seed, step): epoch-seeded
        permutations with --shuffle, plain cycling otherwise."""
        epoch, idx = divmod(step, len(batches))
        if not args.shuffle:
            return batches[idx]
        if epoch not in perm_cache:
            perm_cache.clear()
            perm_cache[epoch] = np.random.default_rng((args.seed, epoch)).permutation(len(batches))
        return batches[perm_cache[epoch][idx]]

    t0 = time.perf_counter()
    tokens_seen = 0
    last_step = start_step
    for step in range(start_step, args.steps):
        last_step = step + 1
        toks = pad_rows(converter([dataset[i] for i in batch_for_step(step)])[2],
                        dp * args.accum_steps)
        toks = toks.to(device)
        gen = step_generator(args.seed + 1, step, device)
        if args.lora:
            state, metrics = training.train_step_lora(state, base, cfg, tx, gen, toks,
                                                      scale=lora_scale)
        elif args.accum_steps > 1:
            state, metrics = training.train_step_accum(state, cfg, tx, gen, toks,
                                                       accum_steps=args.accum_steps)
        else:
            state, metrics = training.train_step(state, cfg, tx, gen, toks)
        tokens_seen += toks.numel()
        if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
            loss = float(metrics["loss"])
            acc = float(metrics["acc"])
            rate = tokens_seen / (time.perf_counter() - t0)
            say(f"step {step + 1:5d}  loss {loss:7.4f}  masked-acc {acc:6.3f}  "
                f"{rate / 1e3:8.1f}k tok/s")
        if state_dir and args.save_every and (step + 1) % args.save_every == 0:
            save_train_state(state_dir, state)
            say(f"saved train state at step {step + 1}")
        if eval_batches is not None and args.eval_every and (step + 1) % args.eval_every == 0:
            run_eval(step + 1)
        if args.stop_after and step + 1 >= args.stop_after:
            say(f"stopping after step {step + 1} (--stop-after)")
            break

    if eval_batches is not None and (not args.eval_every or last_step % args.eval_every):
        run_eval(last_step)
    if args.checkpoint_dir:
        if not args.lora:
            save_params(args.checkpoint_dir, state.model)
            say(f"saved params to {args.checkpoint_dir}")
        elif args.lora_int8_base:
            # an int8 base is not merged (lora.merge refuses): ship the adapters,
            # which inference attaches to the frozen base with lora.patch
            save_params(args.checkpoint_dir, state.model)
            say(f"saved LoRA adapters to {args.checkpoint_dir} "
                "(int8 base stays unmerged; apply with lora.patch)")
        else:
            save_params(args.checkpoint_dir, lora.merge(base, state.model, scale=lora_scale))
            say(f"saved MERGED params to {args.checkpoint_dir}")
    return state


def pad_rows(toks: torch.Tensor, multiple: int) -> torch.Tensor:
    """``toks`` with copies of its first row appended up to a multiple of
    ``multiple`` rows."""
    if toks.shape[0] % multiple:
        pad = multiple - toks.shape[0] % multiple
        toks = torch.cat([toks, toks[:1].repeat(pad, 1)])
    return toks


def _print_plan(args, cfg, mesh_cfg, device, say):
    """Print the mesh, a rank's memory plan (esm_tpu's examples/pretrain_mlm.py
    :197-227: ``plan_train_lora`` for --lora, else ``plan_train``, factored
    for --adafactor) and the scaling model's warnings."""
    from ..parallel.memory_plan import plan_train, plan_train_lora
    from ..parallel.scaling import warn_if_inefficient

    say(f"mesh: data={mesh_cfg.data} fsdp={mesh_cfg.fsdp} tp={mesh_cfg.tp}")
    seqlen = args.truncation_seq_length + 2
    est_b = max(mesh_cfg.data * mesh_cfg.fsdp * args.accum_steps, args.toks_per_batch // seqlen)
    if args.lora:
        mp = plan_train_lora(cfg, mesh_cfg, est_b, seqlen, rank=args.lora,
                             base_dtype_bytes=1 if args.lora_int8_base else 2,
                             remat_policy=cfg.remat_policy, device=device)
        hint, what = "--lora-full-remat / --lora-int8-base", "LoRA, "
    else:
        mp = plan_train(cfg, mesh_cfg, est_b, seqlen, accum_steps=args.accum_steps,
                        mu_dtype_bytes=2 if args.bf16_moments else 4, factored=args.adafactor,
                        device=device)
        hint = "--accum-steps / --bf16-moments / more devices"
        what = "adafactor, " if args.adafactor else ""
    say(f"memory plan ({what}est. B={est_b}): {mp['per_device_bytes'] / 1e9:.1f} GB/rank of "
        f"{mp['hbm_bytes'] / 1e9:.1f} -> {mp['verdict']}"
        + (f"  (hint: {hint})" if mp["verdict"] != "fits" else ""))
    if say is print:  # the layout's warnings, once
        warn_if_inefficient(cfg, mesh_cfg, batch=est_b, seqlen=seqlen, mode="train")


def main():
    run(create_parser().parse_args())
    if dist.is_initialized():  # a launcher's group
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
