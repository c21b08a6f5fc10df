#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (esm_tpu_torch) on one GPU.

    python3 chip_smoke.py                                # every phase, on one card
    python3 chip_smoke.py --only ring,fold-shard,shard   # device, build, fasta, then any of
                                                         # these, in this order (e.g. on 4
                                                         # cards)
    python3 chip_smoke.py --only pp-profile              # ESM2-650M's steps on one card and
                                                         # through the pipeline at pp=1,
                                                         # profiled (never in the full run)

Phases, each raising on failure (nothing is caught):
  1. device   — the card's name and power limit;
  2. build    — builds the kernel libraries from the checkout's sources with
                nvcc, all at once: K1 (esm_tpu_torch/csrc/flash_attention.cu,
                the flash-attention forward, optionally writing the lse), K2
                (csrc/flash_attention_bwd.cu, the two-pass backward), K6
                (csrc/triangle_attention.cu) and K7/K8 (csrc/triangle_mul.cu);
                prints ptxas's registers, spills and shared memory of K1's,
                K2's, K6's, K7's and K8's wgmma kernels, and fails on a spill
                or a serialized wgmma;
 2b. fasta    — the native FASTA loader (esm_tpu_torch/native, g++ at first
                use) must build; a seeded 20,000-record file parsed by it
                and by the Python loop (equal records, both timed), its bulk
                tokenizer against the BatchConverter;
  3. kernels  — every kernel against its plain PyTorch version on the card,
                fp32 (TF32 off) and bf16, d in {16, 32, 64, 128}, T in {37,
                1000, 1024, 4096} and T != S, a ragged key-padding mask off
                and on, rotary off and on: K1 without the lse, K1 with it
                (output and lse), K2 (dq, dk, dv); then the K4 and K5 entries
                (a forward with the lse, and two key blocks' backward partials
                that add up to the whole); K6, fp32 and bf16, d in {16, 32,
                64}, J in {37, 256, 1000, 1100}, H=4, a ragged key mask, B=1
                and B=2 with I no multiple of the rows a CTA takes, on real
                rows; K7 (mask none, ragged and all zero) and K8, fp32 and
                bf16, C in {32, 64, 128}, 1 to 16,901 rows (around the 64-row
                tile, and past one pass of the persistent grid); then K6, K7
                and K8 refusing gradients: each raises under grad with an
                input or weight that requires it; and K1 without the lse at
                ESM-1's shape (T=1023 queries, S=1024 keys with the bias_kv
                key last, d=64, no rotary);
  4. main     — the inference path: ESM2-650M (esm2_t33_650M_UR50D, 33 x
                1280, 20 heads; seeded random weights) in bf16 through LMHandle
                with the flash path at B=32, L=1022 (1024 tokens), as bench.py
                drives the JAX package: K1 must launch once per layer; logits
                held against the exact path and an fp32 forward; seq/s of both
                bf16 paths; then [k1], K1 timed at that shape (and, like every
                [k*] line, its ratio to the library call and its TFLOP/s);
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
 5b. ring     — sequence parallelism: K4 with the ring's lse combine and K5
                with its dq sum and dk/dv placement over 4 blocks of a
                T=8192, H=20, d=64 bf16 sequence, held to K1 and K2 over the
                whole, K4 and K5 timed at a ring step's shape; then on a
                one-rank NCCL group of this card, ESM2-650M (bf16, flash,
                remat "dots") at B=2 x 4096: apply_seq_sharded against the
                one-card flash forward ([main]'s bounds, K4 33 launches and
                nothing else), step 0's loss and gradients
                (training.seq_loss_and_grads) against training's one-card
                step (66 K4 and 33 + 33 K5), two train_step_seq steps; with
                two or more cards present, the same at B=1 x 8192 over one
                NCCL rank per card (a power of two), three steps whose loss
                falls, each rank held to its own one-card run;
 5c. shard    — parameter sharding and the GPipe pipeline on a one-rank NCCL
                group of this card: ESM2-650M (bf16, flash, remat "dots")
                through parallel.sharding.shard_params on mesh (1, 1, 1): the
                B=32 x 1024 forward's logits equal the unsharded flash
                forward's bit for bit with K1 33 launches; step 0 at B=8 x
                1024 (training.sharded_loss_and_grads) equal to the
                unsharded step's loss and gradients bit for bit with 66
                K1-with-lse and 33 + 33 K2 launches; 3 sharded steps whose
                loss falls, their peak beside plan_train; apply_pipelined at
                pp=1, M=4 held to the unsharded forward by [main]'s rule
                (K1 132 launches) and pp_loss_and_grads' step 0 by PR 14's
                rule (loss within 1e-3, gradient cosine above 0.999, norm
                ratio within 1%; 264 K1-with-lse, 132 + 132 K2); an ESM2-3B
                step at B=8 x 1024, its peak beside plan_train (the act_units
                that fit both peaks printed); plan_model against the resident
                bytes; the bf16 GEMM rate at the LM's products (the scaling
                model's constant); a save of the AdamW train state of the 3
                steps (rank 0's host RSS growth beside the largest entry and
                the whole tree); LoRA rank 16 on a bf16 and an int8 base
                (stored after the cut), the LoRA recipe at B=8 x 1024: step
                0's loss and adapter gradients equal the unsharded step's
                bit for bit with 66 K1-with-lse and 33 + 33 K2 launches, 3
                steps whose loss falls, the peak beside plan_train_lora;
                adafactor: 2 steps equal to the unsharded ones bit for bit
                (parameters and statistics), the peak beside
                plan_train(factored=True); cli.pretrain under torchrun (one
                process) with AdamW, --lora 16 and --adafactor: each
                stopped and resumed run equal to the straight one bit for
                bit; examples.esm2_infer_sharded at ESM2-650M. With two or
                more cards (--only shard on 4): the NCCL all-reduce's bus
                bandwidth, ESM2-15B's bf16 forward at tp=4 against rank 0's
                one-card and fp32 forwards ([ring]'s rule), ESM2-3B step 0
                at (fsdp, tp) = (2, 2) and ESM2-650M (32 layers)
                train_step_pp at pp=4, M=8 against one-card steps, ESM2-3B
                LoRA step 0 (adapter gradients) and one adafactor update
                (parameter deltas) at (2, 2) against rank 0's one-card ones
                by PR 14's rule, ESM2-15B LoRA (bf16 base) at tp=4 for 3
                steps whose loss falls (each rank's peak beside
                plan_train_lora), the pp=4 ESM2-650M train state saved and
                reloaded on one card bit for bit, then full-parameter AdamW
                ESM2-15B steps at fsdp=4 (one row a rank, bf16 first
                moments; peak beside plan_train), each part's result
                printed by every rank as it ends;
  6. cli      — esm-extract (esm_tpu_torch.cli.extract.run) on the card over a
                seeded FASTA with an esm2_t6_8M-shaped checkpoint written in
                the reference layout, its files checked against a CPU
                forward, and with an ESM-1b-shaped one (1280 wide, 6 layers,
                save_esm1b) with --bucket against the same command on the
                CPU; and
                a short esm_tpu_torch.cli.pretrain run on the card at the
                esm2_t6_8M shape (its defaults) with evaluation;
  7. fold     — the ESMFold inference path: ESMFold v1 at full width and
                depth (ESM2-3B LM, 36 x 2560; 48 trunk blocks, c_s 1024, c_z
                128; seeded random weights, the zero-initialized layers
                re-drawn) through ESMFoldHandle.infer with the fast preset (bf16
                LM with K1, bf16 trunk with K6) at B=1, L=512, default
                recycles: K6 must launch 384 times and K1 36 times per fold;
                the fold held against the same fold with exact triangle
                attention and against an fp32 fold; folds/s at L=512 and
                L=1000, peak memory, a profile of one L=1000 fold; then [k6],
                K6 timed at B=1, I=J=1000, H=4, d=32 beside its bound and
                scaled_dot_product_attention, with its tiling and the bytes
                it stages, and [k6-variants], its other shapes and its
                measurement modes (loads alone, no exponentials, no bias
                loads) at that shape;
 7b. fold-shard — the sharded fold (esmfold.apply_sharded: the ring LM, the
                pair tensors row-sharded over tp) of [fold]'s handle and L=512
                sequence on a one-rank NCCL group of this card, through
                ESMFoldHandle.with_options(pair_spec=("tp",)).infer(mesh=):
                positions, pLDDT, pTM and PAE equal [fold]'s fast fold bit for
                bit, K4 36 and K6 384 launches and nothing else (K1 none), its
                time beside [fold]'s, max_memory_reserved beside plan_fold at
                one shard, plan_fold's verdicts at tp 1, 2, 4 for L 2048, 3072,
                4096; K4 and K6 timed at the shapes this fold gives them. With
                two or more cards (--only fold-shard on 4): one NCCL rank per
                card, ESMFold v1 at L=2048 with one recycle against rank 0's
                one-card fold ([fold]'s agreement rule), K6 192 launches a
                rank, each rank's peak beside plan_fold at N shards, the time
                beside the one-card fold and plan_scaling_fold; then one fold
                at the shortest multiple of 256 the one-card plan refuses;
  8. trimul   — triangle_multiplicative_update_fused (K7 + einsum + K8)
                against z + triangle_multiplicative_update at B=1, L=1000,
                C=128, bf16, with the trunk's mask, under torch.no_grad():
                agreement and both times; then [k7] and [k8] timed beside
                their bounds and the earlier mma.sync kernels' times, and
                [k7-variants] and [k8-variants], their measurement modes
                (loads alone, no stores, no sigmoids) at that shape;
  9. cli-fold — esm_tpu_torch.cli.fold on the card over a seeded FASTA with a
                reference-layout checkpoint (an esm2_t6_8M-shaped LM, a
                2-block trunk at ESMFold's widths), --fused-triangle, its PDBs
                held against a CPU run of the same command;
 10. serve    — the port's InferenceServer in this process with ESM2-650M
                (bf16, flash), [fold]'s ESMFold v1 handle (fast) and ESM-IF1,
                all seeded at their released sizes: the /embed load of
                scripts_dev/bench_serve_tpu.py (64 single-sequence requests
                from 8 closed-loop clients, lengths 250-1022, max_batch 16,
                max_wait 20 ms): seq/s, p50/p95, mean batch; K1 33 times a
                device batch and no other kernel; each batch's readback
                against the next batch's compute (a 48-sequence request of
                three chunks among them, each later chunk's readback held
                behind SERVE_HOLD_CYCLES of device spin so that host delays
                cannot pass for a waiting readback); a lone /embed bit for bit against
                a direct call on the batch the server formed, a co-batched
                one within SERVE_COBATCH_TOL of it; /score against
                wt_marginal_score on a direct call; /fold of 4 sequences and
                a multimer in chunks of 2 (K1 36 and K6 96 a pass, request
                order, [fold]'s bounds against direct folds); one-pass folds
                at buckets 256-2048: the fold cost polynomial fitted to their
                times (printed), the server's constants held within 11% at
                1024 and 2048, what each fold holds against plan_fold / 0.9,
                the server's default fold cap equal to the plan's; /design (1
                and 8 samples at L=250 against IFHandle.sample, the score
                path); the learned cost units; three 3 s /profile captures
                under load, each naming K1 (with its device batches, the
                windows the server took, CPU operators and CUDA runtime
                calls);
 11. cli-serve — python -m esm_tpu_torch.cli.serve as a process (--bf16
                --flash, a save_esm2 checkpoint in a temporary ESM_TPU_CACHE):
                its /embed against the in-process handle bit for bit, SIGINT;
 12. esm1     — the ESM-1 family at its released sizes, seeded random
                weights, bf16, through LMHandle: ESM-1b (esm1b_t33_650M_UR50S,
                33 x 1280) and ESM-1v (token dropout, <mask> tokens in the
                batch) at B=32, L=1022, K1 once a layer at S=T; ESM-1
                (esm1_t34_670M_UR50S, 34 x 1280, bias_kv) at T=1023, K1 once
                a layer at S=T+1; flash held against exact (and, for
                ESM-1b, an fp32 forward) as the main phase holds ESM-2, seq/s
                of both paths, ESM-1's streaming contacts against the
                stacked ones; then [k1-esm1b] and [k1-esm1], K1 timed at
                those shapes;
 13. msa      — the MSA Transformer (esm_msa1b_t12_100M_UR50S, 12 x 768) on a
                seeded MSA of 400 rows x 257 tokens: the chunked axial
                attentions (R*C > 2^14) against the unchunked forward in fp32,
                bf16 against fp32, time and peak memory of the forward;
 14. cli-variants — esm_tpu_torch.cli.predict_variants on the card against
                --nogpu runs of the same command: a seeded 250-residue
                sequence and 40-mutant DMS, an ESM-1v-shaped checkpoint
                (1280 wide, 3 layers) with wt-marginals, masked-marginals and
                pseudo-ppl, an MSA-1b-shaped one (768 wide, 2 layers) with
                masked-marginals over a seeded 64-row a3m with insertions,
                the two as an ensemble with --eval-column;
 15. if1      — ESM-IF1 at its released size (esm_if1_gvp4_t16_142M_UR50,
                seeded random weights, built with no device argument), fp32
                with TF32 off, on a seeded 500-residue backbone built from
                ideal geometry with a 5-residue gap: the encoder output, the
                teacher-forced logits and score_sequence against a CPU copy
                of the weights, a forward repeated bit for bit, every decode
                step against the teacher forcing of the decoded tokens,
                partial_seq, pad_to_multiple=64 against the unpadded call,
                20,000 draws against softmax(logits / T), the encoder's and
                a score's times, sample with 1 and 8 samples in residues/s,
                a profile of a sample (launches a decode step, busy share,
                top operators), a 220 + 160 residue complex; no kernel
                launches (the JAX package has none for IF1);
 16. cli-if   — esm_tpu_torch.cli.if_score and if_sample on the card with a
                save_if1 checkpoint of that model, a 250-residue backbone as
                PDB and mmCIF and a two-chain PDB, against --nogpu runs of
                the same commands (scores within 1e-4; one seed sampled twice
                on the card gives one FASTA);
 17. lora     — LoRA fine-tuning of ESM2-650M at full width and depth: rank
                16, alpha 16, the default targets (12,165,120 adapter
                parameters), bf16 compute, flash, remat "dots", B=8 x 1024
                tokens; the base stored in bf16, then weight-only int8. The
                adapter gradients of the flash path (K1 with the lse, K2)
                against the exact path's with seeded nonzero b; K1-lse 66 and
                K2 33 + 33 launches a step; 6 steps on one batch, the loss
                falls, the base bit-identical; the merged model's logits
                against the patched model's; the int8 base's first loss
                within 2% of the bf16 base's, its peak memory at least 0.5 GB
                lower, its merge refused; step time, tok/s, peak memory and
                the optimizer state against [train]'s AdamW state;
 18. int8     — the weight-only int8 ESM2-650M forward at [main]'s shape
                through LMHandle.quantized(): logits against the bf16 handle,
                parameter bytes below 0.27 of fp32's, 33 K1 launches, seq/s;
 19. train-msa — MSA-1b training at full size (B=1 x 128 rows x 257): 3 full
                and 3 LoRA steps in bf16; card vs CPU at 2 layers, fp32;
 20. train-if — ESM-IF1 training at its released size, fp32: card vs CPU on
                a 120-residue backbone, a step repeated bit for bit, 3 full
                and 3 LoRA steps on 4 x 250 residues;
 21. cli-pretrain-lora — cli.pretrain on the card with --lora 8, with
                --lora-int8-base and with --adafactor: a resumed run equals
                the uninterrupted one bit for bit, the saves load; the
                optimizer state of adafactor at ESM2-650M beside AdamW's.
                ([cli], [cli-fold] and [cli-variants] also run --int8 against
                the same command without it.)
 22. train-fold — ESMFold fine-tuning at ESMFold v1's released widths
                (ESM2-3B LM in bf16 through K1, frozen; 48 trunk blocks c_s
                1024 c_z 128 in fp32 on the plain triangle paths; seeded, the
                zero-initialized layers re-drawn), B=1, one seeded NeRF
                backbone of FOLD_TRAIN_L residues, training.train_step_fold
                with fold_optimizer: step 0 repeated bit for bit from one
                state, 6 steps whose loss falls, K1 36 launches a step and
                K6/K7/K8 none, ms a step (CUDA events) and peak memory, one
                step with 3 recycles, 4 LoRA steps (rank 8, the trunk and
                heads) with a lower peak and the base unchanged; card vs CPU
                gradients at 2 trunk blocks and 2 LM layers, fp32;
 23. cli-fold-finetune — esm_tpu_torch.examples.esmfold_finetune on three
                seeded PDB backbones of unequal length, --lora
                --lm-aux-weight 0.1, 4 steps on the card against --cpu;
 24. ss-finetune — esm_tpu_torch.examples.finetune_secondary_structure
                --synthetic 64 on the card: the frozen LM's loss falls (K1
                once a layer a step); --train-lm: K1 with the lse and K2's
                two passes once a layer a step;
 25. int8-15b — ESM2-15B (48 x 5120) on seeded weights built layer by layer
                in weight-only int8 beside a bf16 copy: a B=1 L=1022 forward
                through K1 (48 launches) held to the bf16 copy's and to a
                streamed fp32 forward's under esm_tpu's int8 bound of the
                largest error, and against fp32 no worse than the bf16 copy
                by INT8_ERR_RATIO (largest error) and INT8_AGREE_DROP
                (argmax agreement); parameter bytes, peak memory, seq/s;
 26. design   — LM design (esm_tpu_torch.apps.lm_design) with ESM2-650M at
                its released size (seeded), the lm-design example's
                65-residue seed sequence, batch 4: fp32 (TF32 off) MH chains
                of 50 steps on draws made once on a CPU generator, flash (K1)
                against exact (accept flags equal at every step, energies
                within DESIGN_TOL relative) and the first step against a CPU
                forward; a bf16 flash chain of 1000 steps at the reference's
                StepLR temperature through Designer.run under
                torch.cuda.set_sync_debug_mode("error") (K1 33 a step and
                nothing else, finite energies, accept rate in (0, 1)), ms a
                step, steps/s and a profile of 20 steps; 200 Gibbs and 40
                free-generation steps (a seeded distogram projection over the
                660 attention maps), K1 33 a step;
 27. ppl      — the protein programming language over ESMFold v1 at its
                released size (seeded, zero layers re-drawn, fast preset):
                ESMFoldCallback(num_recycles=1, bucket=16) on a 100-residue
                sequence against infer(pad_to_multiple=16) on the real rows
                (K1 36, K6 192 a fold); run_simulated_annealing on
                free_hallucination(100) for 10 steps and fixed_backbone of an
                80-residue NeRF template for 5, each step split into the fold
                (host clock and CUDA events) and the host energy terms;
 28. cli-design — the eight design examples' run(args) on the card:
                lm_design_fixedbb with an esm2_t6_8M-shaped checkpoint (K1 6
                a step), the seven ppl_* over [cli-fold]'s checkpoint shape
                under ESMFold v1's cache name (K1 6, K6 8 a fold);
 29. summary  — the nvidia-smi line, a JSON line of the ported kernels (K1
                also at the ESM-1b and ESM-1 shapes), and as the last line
                {"ok": true, "device": {...}}.

Exits non-zero, with no result line, when there is no GPU or when the port's
package is not beside this file. Imports nothing of JAX or esm_tpu.
"""

import collections
import contextlib
import functools
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
# K6 vs plain: fp32 2e-5 absolute (fp32 FMA, summation order only); bf16 2e-2
# relative (P rounded against the running max, outputs rounded to bf16).
# K7/K8 vs plain: fp32 5e-5 (rsqrtf and expf against PyTorch's, sums in
# another order); bf16 2e-2 relative (normalized rows and outputs rounded to
# bf16 from fp32 values that differ in the last bits).
TRI_TOL = {"torch.float32": 2e-5, "torch.bfloat16": 2e-2}
TRIMUL_TOL = {"torch.float32": 5e-5, "torch.bfloat16": 2e-2}
# The fast fold (bf16 trunk, K6) against the same fold with exact triangle
# attention (bf16 trunk, logits rounded to bf16 before the softmax): the two
# differ only in how attention rounds, so K6's fold must stay as close to an
# fp32 fold as the exact route is (CA-RMSD at most 1.5x the exact route's
# distance, plus 0.05 A for two distances that are both near zero), and the
# two bf16 folds must agree to 2 A CA-RMSD, 2 pLDDT points (mean) and 0.02 pTM.
FOLD_RMSD_RATIO, FOLD_RMSD_SLACK = 1.5, 0.05
FOLD_CA_RMSD, FOLD_PLDDT, FOLD_PTM = 2.0, 2.0, 0.02
# The fused tri-mul (K7 + einsum + K8) against z + the unfused op, bf16: the
# unfused op rounds the projections, gates and einsum inputs to bf16 at other
# places than the kernels, which gate in fp32: 5e-2 relative.
TRIMUL_AB_TOL = 5e-2
CLI_FOLD_TOL = 5e-3  # A, the fold CLI's PDBs on the card against a CPU run (fp32)
SERVE_PROFILES = 3  # [serve]'s /profile captures under load, each must name K1
TRAIN_STEPS = 6
MEASURED = {}  # [main]'s seq/s, printed beside [serve]'s
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


# the wgmma/TMA kernels of K1, K2, K6, K7 and K8, by their names in ptxas's
# report (template arguments: K1/K2 the tile width; K6 the tile width, the
# rows i a CTA takes, the rows a step takes and the mode, 0 the kernel and
# 1-3 the measurement variants of [k6]; K7 the channels, the mask flag and
# the mode, K8 the channels and the mode, 0 the kernel and 1-3 the
# measurement variants of [k7-variants] and [k8-variants])
HOPPER_KERNELS = re.compile(r"(flash_fwd_bf16|flash_dq_bf16|flash_dkv_bf16|tri_attn_bf16|"
                            r"tri_mul_stage1_bf16|tri_mul_epilogue_bf16)I((?:Li\d+E)+)")
SERIALIZED = re.compile(r"wgmma\.mma_async instructions are serialized.*?function '([^']+)'")


def kernel_name(mangled):
    m = HOPPER_KERNELS.search(mangled)
    return f"{m.group(1)}<{','.join(re.findall(r'Li(\d+)E', m.group(2)))}>" if m else None


def ptxas_report(text):
    """{kernel: (registers, spill bytes, static shared bytes)} of the K1, K2,
    K6, K7 and K8 wgmma kernels in one library's ``nvcc -Xptxas -v`` output."""
    report, current, spill = {}, None, 0
    for line in text.splitlines():
        if "Compiling entry function" in line:
            current = kernel_name(line)
            spill = 0
        elif current and "spill stores" in line:
            spill = sum(int(x) for x in re.findall(r"(\d+) bytes spill", line))
        elif current and "Used" in line and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            report[current] = (regs, spill, int(smem.group(1)) if smem else 0)
            current = None
    return report


def phase_build():
    from esm_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] K1, K2, K6 and K7/K8 built/loaded in {time.perf_counter() - t0:.1f} s (nvcc, "
        + ", ".join(f"{n} {s:.1f} s" for n, s in _build.build_seconds.items()) + ")")
    spilled, serialized = [], []
    for name, text in _build.build_logs.items():
        report = ptxas_report(text)
        for kernel, (regs, spill, smem) in sorted(report.items()):
            log(f"[build]   {name}: {kernel}: {regs} registers a thread, {spill} bytes spilled, "
                f"{smem} bytes static shared memory (+ the dynamic tile ring)")
            if spill:
                spilled.append(kernel)
        for line in text.splitlines():
            if ("registers" in line or "spill" in line) and not report:
                log(f"[build]   {name}: {line.strip()}")
            m = SERIALIZED.search(line)
            if m and kernel_name(m.group(1)):
                serialized.append(kernel_name(m.group(1)))
    if spilled or serialized:
        raise AssertionError(f"ptxas spilled registers in {spilled}, serialized wgmma in "
                             f"{serialized}")
    log("[build]   no spills and no serialized wgmma in the K1, K2, K6, K7 and K8 wgmma kernels")


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
        esm1_shape_check(gen)
        tri_cases = triangle_check(gen)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    log(f"[kernels] K1, K1-lse and K2 match their plain versions at all {cases} cases; "
        f"K6, K7 and K8 at all {tri_cases}")


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


def esm1_shape_check(gen):
    """K1 without the lse at ESM-1's shape: T = 1023 queries, S = T + 1 keys
    (the bias_kv row last, never masked), d = 64, no rotary; mask off and
    ragged, fp32 and bf16, against the plain version."""
    import torch
    from esm_tpu_torch.kernels import flash_attention as fa

    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        worst = 0.0
        for masked in (False, True):
            q, k, v, mask = attention_inputs(2, 20, 1023, 64, dtype, masked, gen, s=1024)
            if mask is not None:
                mask[:, -1] = False
            out = fa.flash_attention(q, k, v, key_padding_mask=mask)
            ref = fa.flash_attention_reference(q, k, v, key_padding_mask=mask)
            torch.cuda.synchronize()
            e = (out.float() - ref.float()).abs().max().item()
            if not e <= tol:
                raise AssertionError(f"K1 at the ESM-1 shape {dtype} masked={masked}: err {e}")
            worst = max(worst, e)
        log(f"[kernels] K1 at the ESM-1 shape {str(dtype):14s} B=2 H=20 T=1023 S=1024 d=64 no "
            f"rotary (mask off/ragged, bias_kv key unmasked): max abs err {worst:.2e} <= {tol}")


def tri_inputs(b, i, j, h, d, dtype, gen):
    """K6 inputs: q/k/v (B, I, J, H, d), tri bias (B, H, J, J) fp32, and a
    ragged key mask (the last batch row loses a third of its keys, and its
    last row i every key) as the (B, I, J) fp32 bias; with the (B, I) rows
    that have a key to attend to."""
    import torch

    q = (torch.randn(b, i, j, h, d, device="cuda", generator=gen) * d ** -0.5).to(dtype)
    k = torch.randn(b, i, j, h, d, device="cuda", generator=gen).to(dtype)
    v = torch.randn(b, i, j, h, d, device="cuda", generator=gen).to(dtype)
    tri = torch.randn(b, h, j, j, device="cuda", generator=gen)
    keep = torch.ones(b, i, j, dtype=torch.bool, device="cuda")
    keep[-1, :, j - j // 3:] = False
    keep[-1, -1, :] = False
    mask_bias = torch.where(keep, 0.0, -1e30).float()
    return (q, k, v, tri, mask_bias), keep.any(-1)


def tri_mul_module(c, seed):
    """A TriangleMultiplication with seeded weights of the init's scales
    (all layers non-zero), on the card."""
    import torch
    from esm_tpu_torch.ops.triangle import TriangleMultiplication

    gen = torch.Generator().manual_seed(seed)
    mod = TriangleMultiplication(c)
    with torch.no_grad():
        for name, p in mod.named_parameters():
            if name.startswith("layer_norm"):
                p.normal_(generator=gen).mul_(0.1).add_(1.0 if name.endswith("weight") else 0.0)
            else:
                p.uniform_(-c ** -0.5, c ** -0.5, generator=gen)
    return mod.cuda()


# K7/K8 card checks: every channel count the kernels take, row counts around
# the 64-row tile and one that wraps the persistent grid (> 132 x 2 x 64).
TRIMUL_CHANNELS = (32, 64, 128)
TRIMUL_ROWS = (1, 63, 64, 65, 127, 129, 231, 7474, 16901)


def triangle_check(gen):
    """K6 (fp32 and bf16, d in {16, 32, 64}, J in {37, 256, 1000, 1100}, H=4,
    ragged mask, real rows; B=1 and B=2 with I no multiple of the rows a CTA
    takes), K7 (mask off, ragged and all zero) and K8 (C in TRIMUL_CHANNELS,
    TRIMUL_ROWS rows) against their plain versions; then the three CUDA
    routes refusing gradients."""
    import torch
    from esm_tpu_torch.kernels import triangle_attention as ta
    from esm_tpu_torch.kernels import triangle_mul as tm

    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        tol = TRI_TOL[str(dtype)]
        for d in (16, 32, 64):
            worst = {}
            for j in (37, 256, 1000, 1100):
                # I=5 and 3 leave a partial row group at every R the kernel uses
                for b, i in ((1, 8 if j <= 256 else 2), (2, 5 if j <= 256 else 3)):
                    args, real = tri_inputs(b, i, j, 4, d, dtype, gen)
                    out = ta.triangle_attention_fused(*args)
                    ref = ta.triangle_attention_reference(*args)
                    torch.cuda.synchronize()
                    e = (rel_err(out[real], ref[real]) if dtype == torch.bfloat16
                         else (out[real] - ref[real]).abs().max().item())
                    if not e <= tol:
                        raise AssertionError(f"K6 {dtype} d={d} J={j} B={b} I={i}: err {e} > "
                                             f"{tol}")
                    worst[j] = max(worst.get(j, 0.0), e)
                    cases += 1
            log(f"[kernels] K6 {str(dtype):14s} d={d:2d} H=4 ragged mask, B=1 and B=2 (I no "
                f"multiple of the row group), real rows: "
                + ", ".join(f"J={j} {e:.2e}" for j, e in worst.items()) + f" <= {tol}")
    with torch.no_grad():  # the module's weights require grad; the kernels have no backward
        for dtype in (torch.float32, torch.bfloat16):
            tol = TRIMUL_TOL[str(dtype)]
            for c in TRIMUL_CHANNELS:
                mod = tri_mul_module(c, seed=c)
                w = tm.stage1_weights(mod, dtype)
                ew = tm.epilogue_weights(mod, dtype)
                errs = []
                for rows in TRIMUL_ROWS:
                    z = torch.randn(1, rows, 1, c, device="cuda", generator=gen).to(dtype)
                    x = torch.randn(1, rows, 1, c, device="cuda", generator=gen).to(dtype)
                    zf = z.reshape(rows, c)
                    masks = {"none": None,
                             "ragged": (torch.rand(1, rows, 1, device="cuda", generator=gen)
                                        > 0.3).to(dtype),
                             "zero": torch.zeros(1, rows, 1, device="cuda", dtype=dtype)}
                    for kind, mask in masks.items():
                        a, b = tm.tri_mul_stage1(z, mask, mod)
                        mf = None if mask is None else mask.reshape(rows).to(torch.int8)
                        ref_a, ref_b = tm.tri_mul_stage1_reference(zf, mf, *w)
                        torch.cuda.synchronize()
                        errs += [rel_err(a.reshape(rows, c), ref_a),
                                 rel_err(b.reshape(rows, c), ref_b)]
                        if kind == "zero" and (a.any() or b.any()):
                            raise AssertionError(f"K7 {dtype} C={c} rows={rows}: a or b not 0 "
                                                 f"under an all-zero mask")
                        cases += 1
                    o = tm.tri_mul_epilogue(x, z, mod)
                    ref_o = tm.tri_mul_epilogue_reference(x.reshape(rows, c), zf, *ew)
                    torch.cuda.synchronize()
                    errs.append(rel_err(o.reshape(rows, c), ref_o))
                    cases += 1
                if not max(errs) <= tol:
                    raise AssertionError(f"K7/K8 {dtype} C={c}: errors {errs} > {tol}")
                log(f"[kernels] K7 (mask none, ragged, all zero) and K8 {str(dtype):14s} "
                    f"C={c:3d}, rows {', '.join(map(str, TRIMUL_ROWS))}: max err "
                    f"{max(errs):.2e} <= {tol} (relative)")
    grad_refusal_check(gen)
    return cases


def grad_refusal_check(gen):
    """K6, K7 and K8 have no backward: on the card each raises under grad when
    an input (K6's q) or a weight (the tri-mul module's) requires grad, and
    runs under torch.no_grad()."""
    import torch
    from esm_tpu_torch.kernels import triangle_attention as ta
    from esm_tpu_torch.kernels import triangle_mul as tm

    args, _ = tri_inputs(1, 2, 64, 4, 32, torch.bfloat16, gen)
    q = args[0].clone().requires_grad_()
    mod = tri_mul_module(32, seed=5)  # its parameters require grad
    z = torch.randn(1, 8, 8, 32, device="cuda", generator=gen).bfloat16()
    calls = {"K6": lambda: ta.triangle_attention_fused(q, *args[1:]),
             "K7": lambda: tm.tri_mul_stage1(z, None, mod),
             "K8": lambda: tm.tri_mul_epilogue(z, z, mod)}
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            if f"({name})" not in str(e) or "no backward" not in str(e):
                raise
        else:
            raise AssertionError(f"{name} ran under grad with an input or weight requiring it")
        with torch.no_grad():
            call()
    torch.cuda.synchronize()
    log("[kernels] K6, K7 and K8 raise under grad with an input or weight that requires it, "
        "and run under torch.no_grad()")


def bench_tokens(alphabet, b, length, seed=0):
    """(B, 1 + length (+ 1 with an eos)) tokens: bos, random residues, eos
    where the alphabet appends one (ESM-1's does not)."""
    rng = np.random.RandomState(seed)
    toks = np.full((b, length + 1 + int(alphabet.append_eos)), alphabet.padding_idx,
                   dtype=np.int64)
    toks[:, 0] = alphabet.cls_idx
    toks[:, 1:length + 1] = rng.randint(4, 24, size=(b, length))
    if alphabet.append_eos:
        toks[:, length + 1] = alphabet.eos_idx
    return toks


def zero_counts():
    from esm_tpu_torch.kernels import flash_attention as fa
    from esm_tpu_torch.kernels import triangle_attention as ta
    from esm_tpu_torch.kernels import triangle_mul as tm

    fa.flash_attention.launches = 0
    fa.flash_attention_with_lse.launches = 0
    fa.flash_attention_bwd.launches_dq = 0
    fa.flash_attention_bwd.launches_dkv = 0
    ta.triangle_attention_fused.launches = 0
    tm.tri_mul_stage1.launches = 0
    tm.tri_mul_epilogue.launches = 0


def read_counts():
    from esm_tpu_torch.kernels import flash_attention as fa
    from esm_tpu_torch.kernels import triangle_attention as ta
    from esm_tpu_torch.kernels import triangle_mul as tm

    return {"flash_attention": fa.flash_attention.launches,
            "flash_attention_with_lse": fa.flash_attention_with_lse.launches,
            "flash_attention_bwd.dq": fa.flash_attention_bwd.launches_dq,
            "flash_attention_bwd.dkv": fa.flash_attention_bwd.launches_dkv,
            "triangle_attention_fused": ta.triangle_attention_fused.launches,
            "tri_mul_stage1": tm.tri_mul_stage1.launches,
            "tri_mul_epilogue": tm.tri_mul_epilogue.launches}


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

    hold_flash("main", logits_flash, exact(tokens)["logits"], f32_logits(handle, tokens))
    rates = seq_rates("main", f"ESM2-650M bf16, B={B}, L={L}; {card}", flash, exact, tokens)
    MEASURED["main_seq_s"] = rates["flash"]
    profile("one flash forward", lambda: flash(tokens))
    del handle, flash, exact, logits_flash
    torch.cuda.empty_cache()
    return launches


def f32_logits(handle, tokens):
    """The fp32 exact forward's logits, TF32 off."""
    import torch

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return handle.with_options(compute_dtype=torch.float32, use_flash=False)(tokens)["logits"]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def hold_flash(tag, logits_flash, logits_exact, logits_f32=None):
    """The bf16 flash logits against the bf16 exact ones (and an fp32 forward's).
    Stated bf16 tolerances: the two routes differ only in how attention
    rounds (exact rounds the scores to bf16, flash keeps them fp32), so the
    flash route must stay within 5% of the logit range of the exact one,
    pick the same token at >= 98% of positions, and be no further from fp32
    than 1.5x the exact route's distance."""
    import torch

    if not torch.isfinite(logits_flash).all():
        raise AssertionError(f"[{tag}] non-finite logits")
    scale = (logits_exact if logits_f32 is None else logits_f32).abs().max().item()
    diff = (logits_flash - logits_exact).abs().max().item()
    agree = (logits_flash.argmax(-1) == logits_exact.argmax(-1)).float().mean().item()
    log(f"[{tag}] logits flash vs exact (bf16): max abs err {diff:.4f} (max |logit| "
        f"{scale:.2f}), argmax agreement {agree:.5f}")
    if not diff <= 0.05 * scale:
        raise AssertionError(f"[{tag}] flash vs exact logits differ by {diff} > {0.05 * scale}")
    if not agree >= 0.98:
        raise AssertionError(f"[{tag}] argmax agreement {agree} < 0.98")
    if logits_f32 is not None:
        err_flash = (logits_flash - logits_f32).abs().max().item()
        err_exact = (logits_exact - logits_f32).abs().max().item()
        log(f"[{tag}] against an fp32 exact forward: flash max abs err {err_flash:.4f}, "
            f"exact {err_exact:.4f}")
        if not err_flash <= 1.5 * err_exact:
            raise AssertionError(f"[{tag}] flash route error {err_flash} > 1.5 x exact's "
                                 f"{err_exact}")


def seq_rates(tag, what, flash, exact, tokens, iters=3):
    """seq/s of the flash and exact handles on ``tokens`` (host clock,
    synchronised, after a warm-up call)."""
    import torch

    rates = {}
    for name, h in (("flash", flash), ("exact", exact)):
        h(tokens)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            h(tokens)["logits"]
        torch.cuda.synchronize()
        rates[name] = tokens.shape[0] * iters / (time.perf_counter() - t0)
        log(f"[{tag}] {name} path: {rates[name]:.3f} seq/s ({what})")
    log(f"[{tag}] flash / exact = {rates['flash'] / rates['exact']:.3f}")
    return rates


def profile(label, fn, top=8, by_op=False):
    """Device time by kernel over one call of ``fn`` (torch.profiler), and the
    share of its wall time during which some kernel ran (the union of the
    device events' intervals); with ``by_op`` also the device time of the
    PyTorch operators that launched the kernels. Returns (wall ms, busy ms,
    device events)."""
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
    if by_op:
        ops = [((getattr(e, "self_device_time_total", 0)
                 or getattr(e, "self_cuda_time_total", 0)) / 1e3, e.count, e.key)
               for e in prof.key_averages() if e.key.startswith("aten::")]
        for ms, count, key in sorted(ops, reverse=True)[:top]:
            log(f"[profile]   by operator: {ms:9.3f} ms {100 * ms / max(total, 1e-9):5.1f}%  "
                f"x{count:<5d} {key[:60]}")
    return wall_ms, busy_us / 1e3, len(events)


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
        f"kernel / library {ms / lib_ms:.3f}; max abs err {err:.3e}")

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
    worst_cos, worst_name, ratio = grad_agreement(g_flash, g_exact,
                                                  names=lambda n: n.endswith("weight"))
    log(f"[train] step-0 loss flash {loss_f:.5f} exact {loss_e:.5f}; gradients flash vs exact: "
        f"{len(g_flash)} tensors, lowest cosine over the weight tensors {worst_cos:.5f} "
        f"({worst_name}), global-norm ratio {ratio:.5f}")
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
            "flash_attention_bwd.dq": n_layers, "flash_attention_bwd.dkv": n_layers,
            "triangle_attention_fused": 0, "tri_mul_stage1": 0, "tri_mul_epilogue": 0}
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
        f"{bound:.4f} ms; {fwd_flops / ms / 1e9:.1f} TFLOP/s; kernel / library "
        f"{ms / lib_ms:.3f}; {counts['flash_attention_with_lse']} launches in the training run; "
        f"err {err:.3e}")
    if not err <= BF16_TOL:
        raise AssertionError(f"K1-lse at the training shape: err {err}")
    entries.append({"name": "flash_attention_with_lse", "route": "cuda",
                    "source": "esm_tpu_torch/csrc/flash_attention.cu",
                    "replaces": "esm_tpu/kernels/flash_attention.py:394",
                    "launches": counts["flash_attention_with_lse"], "max_abs_err": err,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                    "library_ms": lib_ms})

    # K2 (rotate Q, the dq pass with delta, the dk/dv pass) on those residuals
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
        f"the 10.B.H.T.S.d needed ({1.4 * bwd_flops / ms / 1e9:.1f} of the 14.B.H.T.S.d the two "
        f"passes run); kernel / library {ms / lib_ms:.3f}; "
        f"{counts['flash_attention_bwd.dq'] / TRAIN_STEPS:.0f} dq and "
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

    # K4: the forward with the lse, no rotary, at the training shape (its
    # entry in the kernels line is [ring]'s, at a ring step's shape)
    ms = cuda_time_ms(lambda: fa.flash_attention_with_lse(q, k, v, key_padding_mask=mask))
    plain_ms = cuda_time_ms(lambda: fa.flash_attention_reference(q, k, v, key_padding_mask=mask,
                                                                 return_lse=True))
    lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                                                 scale=1.0))
    bound, by = attention_bound_ms(fwd_flops, 4 * act + B * H * T * 4 + B * T)
    log(f"[k4] flash_attention_with_lse B={B} H={H} T=S={T} d={d} bf16 no rotary: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, scaled_dot_product_attention {lib_ms:.4f} ms, "
        f"bound {bound:.4f} ms; {fwd_flops / ms / 1e9:.1f} TFLOP/s; kernel / library "
        f"{ms / lib_ms:.3f}")

    # K5: the backward against a key block, no rotary, timed with the whole key
    # set (its entry in the kernels line is [ring]'s)
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
        f"{lib_ms:.4f} ms, bound {bound:.4f} ms; {bwd_flops / ms / 1e9:.1f} TFLOP/s of the "
        f"10.B.H.T.S.d needed; kernel / library {ms / lib_ms:.3f}; err {err:.3e}")
    if not err <= GRAD_TOL["torch.bfloat16"]:
        raise AssertionError(f"K5 at the training shape: err {err}")
    return entries


RING_T = 4096         # [ring] on one card: ESM2-650M at B=2 x 4096 tokens, a ring of one
RING_MULTI_T = 8192   # [ring] on several cards: B=1 x 8192 tokens over one rank per card
RING_BLOCK = (1, 20, 8192, 64, 4)  # B, H, T, d, N: the block check, at ESM2-650M's heads
RING_LOSS_TOL = 1e-2  # ring vs one-card step-0 loss, relative (bf16 compute, rotary rounding)
RING_TIMEOUT = 900    # seconds the ranks of the several-card part may take together


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def ring_block_check(gen):
    """K4 and K5 composed over N key blocks exactly as each rank of a ring of
    N composes them (ring_attention's ``_combine`` and ``_zero_dead_rows``,
    dq summed and each block's dk/dv summed in fp32 over the query blocks),
    held to K1 (no rotary) and K2 over the whole sequence; K4 and K5 timed
    at the block shape. Returns the two kernels' timing entries."""
    import torch
    import torch.nn.functional as F
    from esm_tpu_torch.kernels import flash_attention as fa
    from esm_tpu_torch.parallel import ring_attention as ra

    B, H, T, d, N = RING_BLOCK
    n = T // N
    q, k, v, mask = attention_inputs(B, H, T, d, torch.bfloat16, True, gen)
    do = torch.randn(q.shape, device="cuda", generator=gen).to(torch.bfloat16)
    cut = lambda x, i: x[..., i * n:(i + 1) * n, :].contiguous()
    qs, ks, vs, dos = ([cut(x, i) for i in range(N)] for x in (q, k, v, do))
    ms = [mask[:, i * n:(i + 1) * n].contiguous() for i in range(N)]
    outs, lses = [], []
    for i in range(N):  # rank i meets blocks i, i - 1, ... as they rotate
        out = torch.zeros(qs[i].shape, dtype=torch.float32, device="cuda")
        lse = torch.full(qs[i].shape[:3], ra.NEG_INF, dtype=torch.float32, device="cuda")
        for s in range(N):
            j = (i - s) % N
            out, lse = ra._combine(out, lse, *fa.flash_attention_with_lse(
                qs[i], ks[j], vs[j], key_padding_mask=ms[j]))
        outs.append(ra._zero_dead_rows(out, lse).to(q.dtype))
        lses.append(lse)
    dq = [torch.zeros(x.shape, dtype=torch.float32, device="cuda") for x in qs]
    dk = [torch.zeros(x.shape, dtype=torch.float32, device="cuda") for x in ks]
    dv = [torch.zeros(x.shape, dtype=torch.float32, device="cuda") for x in vs]
    for i in range(N):
        for s in range(N):
            j = (i - s) % N
            a, b, c = fa.flash_attention_block_bwd(qs[i], ks[j], vs[j], outs[i], lses[i], dos[i],
                                                   key_padding_mask=ms[j])
            dq[i] += a.float()
            dk[j] += b.float()
            dv[j] += c.float()
    whole = fa.flash_attention(q, k, v, key_padding_mask=mask)  # K1, no rotary
    whole_lse_out, whole_lse = fa.flash_attention_with_lse(q, k, v, key_padding_mask=mask)
    want = fa.flash_attention_bwd(q, k, v, whole_lse_out, whole_lse, do, key_padding_mask=mask)
    torch.cuda.synchronize()
    cat = lambda xs: torch.cat(xs, dim=2)
    e_out = (cat(outs).float() - whole.float()).abs().max().item()
    e_lse = rel_err(cat(lses), whole_lse)
    e_grad = {name: rel_err(cat(g).to(q.dtype), w)
              for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want)}
    log(f"[ring] block check, B={B} H={H} T={T} d={d} bf16, a ragged mask (the last block all "
        f"padding), {N} blocks of {n}: K4 + lse combine vs K1 out {e_out:.3e} <= {BF16_TOL}, "
        f"lse {e_lse:.3e} <= {LSE_TOL}; K5 partials vs K2 "
        + ", ".join(f"{k_} {e:.3e}" for k_, e in e_grad.items())
        + f" <= {GRAD_TOL['torch.bfloat16']} (relative)")
    if not (e_out <= BF16_TOL and e_lse <= LSE_TOL
            and max(e_grad.values()) <= GRAD_TOL["torch.bfloat16"]):
        raise AssertionError(f"[ring] block composition disagrees: out {e_out}, lse {e_lse}, "
                             f"gradients {e_grad}")

    # K4 and K5 timed at one ring step's shape: rank 0's queries against block 1
    qb, kb, vb, mb = qs[0], ks[1], vs[1], ms[1]
    act = B * H * n * d * 2
    attn_mask = ~mb[:, None, None, :]
    k4 = lambda: fa.flash_attention_with_lse(qb, kb, vb, key_padding_mask=mb)
    k4_plain = lambda: fa.flash_attention_reference(qb, kb, vb, key_padding_mask=mb,
                                                    return_lse=True)
    o4, l4 = k4()
    r4, rl4 = k4_plain()
    err4 = max((o4.float() - r4.float()).abs().max().item(), rel_err(l4, rl4))
    ms4, plain4 = cuda_time_ms(k4), cuda_time_ms(k4_plain)
    lib4 = cuda_time_ms(lambda: F.scaled_dot_product_attention(qb, kb, vb, attn_mask=attn_mask,
                                                                scale=1.0))
    flops4 = 4 * B * H * n * n * d
    bound4, by4 = attention_bound_ms(flops4, 4 * act + B * H * n * 4 + B * n)
    k5 = lambda: fa.flash_attention_block_bwd(qb, kb, vb, outs[0], lses[0], dos[0],
                                              key_padding_mask=mb)
    k5_plain = lambda: fa.flash_attention_bwd_reference(qb, kb, vb, outs[0], lses[0], dos[0],
                                                        key_padding_mask=mb)
    err5 = max(rel_err(a, r) for a, r in zip(k5(), k5_plain()))
    ms5, plain5 = cuda_time_ms(k5), cuda_time_ms(k5_plain)
    qq, kk, vv = (x.detach().requires_grad_() for x in (qb, kb, vb))
    o = F.scaled_dot_product_attention(qq, kk, vv, attn_mask=attn_mask, scale=1.0)
    lib5 = cuda_time_ms(lambda: torch.autograd.grad(o, (qq, kk, vv), dos[0], retain_graph=True))
    flops5 = 10 * B * H * n * n * d
    bound5, by5 = attention_bound_ms(flops5, 8 * act + B * H * n * 4 + B * n)
    for tag, ms, plain, lib, bound, by, flops in (
            ("k4", ms4, plain4, lib4, bound4, by4, flops4),
            ("k5", ms5, plain5, lib5, bound5, by5, flops5)):
        log(f"[ring] {tag} at one ring step's shape (B={B} H={H} {n} queries x {n} keys, d={d}, "
            f"bf16, no rotary): kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"scaled_dot_product_attention{' backward' if tag == 'k5' else ''} {lib:.4f} ms, "
            f"bound {bound:.4f} ms ({by}); {flops / ms / 1e9:.1f} TFLOP/s; kernel / library "
            f"{ms / lib:.3f}")
    if not (err4 <= BF16_TOL and err5 <= GRAD_TOL["torch.bfloat16"]):
        raise AssertionError(f"[ring] K4 / K5 at the step shape: err {err4}, {err5}")
    return [
        {"name": "flash_attention_with_lse/ring", "route": "cuda",
         "source": "esm_tpu_torch/csrc/flash_attention.cu",
         "replaces": "esm_tpu/kernels/flash_attention.py:938", "launches": 0,
         "max_abs_err": err4, "ms": ms4, "plain_ms": plain4, "bound_ms": bound4,
         "bound_by": by4, "library_ms": lib4},
        {"name": "flash_attention_block_bwd", "route": "cuda",
         "source": "esm_tpu_torch/csrc/flash_attention_bwd.cu",
         "replaces": "esm_tpu/kernels/flash_attention.py:975", "launches": 0,
         "max_abs_err": err5, "ms": ms5, "plain_ms": plain5, "bound_ms": bound5,
         "bound_by": by5, "library_ms": lib5},
    ]


def ring_want(n_layers, ring, step):
    """Launches of a sequence-parallel forward (``step`` False) or remat
    "dots" training step on a rank of a ring of ``ring``: K4 once a layer a
    ring step (twice in a step: the forward and the recompute), K5's two
    passes once a layer a ring step."""
    return {"flash_attention": 0, "flash_attention_with_lse": (2 if step else 1) * n_layers * ring,
            "flash_attention_bwd.dq": n_layers * ring if step else 0,
            "flash_attention_bwd.dkv": n_layers * ring if step else 0,
            "triangle_attention_fused": 0, "tri_mul_stage1": 0, "tri_mul_epilogue": 0}


def ring_model(device, seed=21):
    """ESM2-650M (seeded) with the options of the ring runs: bf16 compute,
    flash, remat "dots" (which only a backward reads)."""
    import dataclasses

    import torch
    from esm_tpu_torch import pretrained

    handle, alphabet = pretrained.random_model_and_alphabet("esm2_t33_650M_UR50D", seed=seed,
                                                            device=device)
    cfg = dataclasses.replace(handle.cfg, compute_dtype=torch.bfloat16, use_flash=True,
                              remat=True, remat_policy="dots")
    return handle.model, cfg, alphabet


def ring_tokens(alphabet, b, t, seed, device):
    """(B, T) bench tokens with <mask> at 5% of the residues, crowded into
    the first quarter of each row, so that the shards' mask shares differ."""
    import torch

    toks = bench_tokens(alphabet, b, t - 2, seed=seed)
    rng = np.random.RandomState(seed)
    cols = rng.choice(np.arange(1, t // 4), size=(b, t // 20))
    np.put_along_axis(toks, cols, alphabet.mask_idx, axis=1)
    return torch.from_numpy(toks).to(device)


def ring_run(mesh, model, cfg, tokens, steps, lr_warmup=0):
    """The main path of [ring] on ``mesh``: apply_seq_sharded, then step 0's
    loss and gradients through training.seq_loss_and_grads, then ``steps``
    train_step_seq_corrupted steps, each window's launch counts read alone;
    beside them the one-card forward and step-0 gradients on the same batch
    (this rank's shard of them). Returns a dict of results."""
    import dataclasses

    import torch
    from esm_tpu_torch import training
    from esm_tpu_torch.models import esm2
    from esm_tpu_torch.parallel.mesh import local_shard

    ring = mesh.size(mesh.mesh_dim_names.index("tp"))
    res = {"ring": ring}
    with torch.no_grad():
        # warm-up calls first: the ring's first call also sets up NCCL's
        # communicators
        esm2.apply_seq_sharded(model, cfg, tokens, mesh=mesh)
        esm2.apply(model, cfg, tokens)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        logits = esm2.apply_seq_sharded(model, cfg, tokens, mesh=mesh)["logits"]
        torch.cuda.synchronize()
        res["forward_s"] = time.perf_counter() - t0
        res["forward_counts"] = read_counts()
        t0 = time.perf_counter()
        whole = esm2.apply(model, cfg, tokens)["logits"]
        torch.cuda.synchronize()
        res["one_card_forward_s"] = time.perf_counter() - t0
        want = local_shard(whole, mesh)
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:  # an fp32 one-card forward: what both bf16 routes are held to
            f32 = local_shard(esm2.apply(model, dataclasses.replace(
                cfg, compute_dtype=torch.float32), tokens)["logits"], mesh)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
    agree = lambda a, b: (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    res["logits_scale"] = want.abs().max().item()
    res["logits_err"] = (logits - want).abs().max().item()
    res["argmax_agree"] = agree(logits, want)
    res["f32_err"] = (logits.float() - f32).abs().max().item()
    res["one_card_f32_err"] = (want.float() - f32).abs().max().item()
    res["f32_agree"], res["one_card_f32_agree"] = agree(logits, f32), agree(want, f32)
    res["logits_finite"] = bool(torch.isfinite(logits).all())
    del logits, whole, want, f32

    corrupted, target_mask = training._corrupt_batch(
        cfg, torch.Generator(device=tokens.device).manual_seed(23), tokens)
    batch = (corrupted, tokens, target_mask)
    model.zero_grad(set_to_none=True)
    zero_counts()
    metrics = training.seq_loss_and_grads(model, cfg, *batch, mesh=mesh)
    torch.cuda.synchronize()
    res["step_counts"] = read_counts()
    res["ring_loss"] = metrics["loss"].item()
    g_ring = {n: p.grad.detach().clone() for n, p in model.named_parameters()
              if p.grad is not None}
    model.zero_grad(set_to_none=True)
    res["one_card_loss"], g_one = grads_of(model, cfg, batch)
    cos, name, ratio = grad_agreement(g_ring, g_one, names=lambda n: n.endswith("weight"))
    res.update(grad_cos=cos, grad_cos_name=name, grad_norm_ratio=ratio)
    del g_ring, g_one
    torch.cuda.empty_cache()

    tx = training.make_optimizer(TRAIN_LR, warmup_steps=lr_warmup, total_steps=1000)
    state = training.init_state(model, tx)
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    zero_counts()
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = training.train_step_seq_corrupted(state, cfg, tx, *batch, mesh=mesh)
        losses.append(m["loss"].item())  # synchronises
        secs.append(time.perf_counter() - t0)
    res["train_counts"] = read_counts()
    res.update(losses=losses, step_s=secs, peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    one_card = []  # the same steps on one card, on the whole batch, for their time
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = training.train_step_corrupted(state, cfg, tx, *batch)
        m["loss"].item()
        one_card.append(time.perf_counter() - t0)
    res["one_card_step_s"] = one_card
    del state, tx
    torch.cuda.empty_cache()
    return res


def check_ring_run(tag, res, n_layers, steps, falling):
    """Raises unless a ring_run result holds: exact launch counts in each
    window; the forward within 5% of the largest logit of the one-card bf16
    forward and, against an fp32 forward, no further than 1.5x the one-card
    bf16 forward ([main]'s bounds) with an argmax agreement no more than
    0.02 below the one-card forward's (two bf16 routes that round in other
    places disagree with each other more than either does with fp32);
    step-0 gradients as [train] holds flash to exact; the loss within
    RING_LOSS_TOL; finite (with ``falling``, falling) losses."""
    ring = res["ring"]
    fwd, step = ring_want(n_layers, ring, False), ring_want(n_layers, ring, True)
    per_step = {k: v / steps for k, v in res["train_counts"].items()}
    log(f"[ring] {tag}: forward {res['forward_s'] * 1e3:.1f} ms (one card "
        f"{res['one_card_forward_s'] * 1e3:.1f} ms), logits vs the one-card forward max abs err "
        f"{res['logits_err']:.4f} (max |logit| {res['logits_scale']:.2f}), argmax agreement "
        f"{res['argmax_agree']:.5f}; vs an fp32 forward: ring {res['f32_err']:.4f} / agreement "
        f"{res['f32_agree']:.5f}, one card {res['one_card_f32_err']:.4f} / "
        f"{res['one_card_f32_agree']:.5f}; launches {res['forward_counts']}")
    log(f"[ring] {tag}: step-0 loss ring {res['ring_loss']:.5f} one card "
        f"{res['one_card_loss']:.5f}; gradients lowest cosine {res['grad_cos']:.5f} "
        f"({res['grad_cos_name']}), norm ratio {res['grad_norm_ratio']:.5f}; launches "
        f"{res['step_counts']}")
    log(f"[ring] {tag}: {steps} train_step_seq steps, losses "
        + ", ".join(f"{x:.5f}" for x in res["losses"]) + "; ms a step "
        + ", ".join(f"{s * 1e3:.1f}" for s in res["step_s"])
        + " (one card, the whole batch: "
        + ", ".join(f"{s * 1e3:.1f}" for s in res["one_card_step_s"])
        + f"); peak over the ring steps {res['peak_gb']:.2f} GB; launches a step {per_step}")
    failed = []
    if res["forward_counts"] != fwd:
        failed.append(f"forward launches {res['forward_counts']} != {fwd}")
    if res["step_counts"] != step or per_step != step:
        failed.append(f"step launches {res['step_counts']}, {per_step} != {step}")
    if not (res["logits_finite"] and res["logits_err"] <= 0.05 * res["logits_scale"]
            and res["f32_err"] <= 1.5 * res["one_card_f32_err"]
            and res["f32_agree"] >= res["one_card_f32_agree"] - 0.02):
        failed.append("logits off the one-card and fp32 forwards")
    if not (res["grad_cos"] >= 0.99 and abs(res["grad_norm_ratio"] - 1) <= 0.05):
        failed.append("gradients off the one-card step's")
    if not abs(res["ring_loss"] - res["one_card_loss"]) <= RING_LOSS_TOL * abs(
            res["one_card_loss"]):
        failed.append("step-0 loss off the one-card step's")
    losses = res["losses"]
    if not (np.isfinite(losses).all() and (not falling or losses[-1] < losses[0])):
        failed.append(f"losses {losses}")
    if failed:
        raise AssertionError(f"[ring] {tag}: " + "; ".join(failed))


def ring_rank(rank, world, port, out_dir):
    """One rank of [ring]'s several-card part (spawned, one per card)."""
    import datetime

    import torch
    import torch.distributed as dist
    from esm_tpu_torch.models import esm2
    from esm_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=RING_TIMEOUT))
    try:
        mesh = make_mesh(MeshConfig(1, 1, world))
        model, cfg, alphabet = ring_model(f"cuda:{rank}")
        with torch.no_grad():
            for p in model.parameters():  # one set of weights on every rank
                dist.broadcast(p, src=0)
        tokens = ring_tokens(alphabet, 1, RING_MULTI_T, seed=22, device=f"cuda:{rank}")
        res = ring_run(mesh, model, cfg, tokens, steps=3)
        res["n_layers"] = len(model.layers)
        with torch.no_grad():  # every rank runs the forward; rank 0 under the profiler
            forward = lambda: esm2.apply_seq_sharded(model, cfg, tokens, mesh=mesh)
            if rank == 0:
                profile(f"one ring forward, rank 0 of {world}, B=1 x {RING_MULTI_T}", forward,
                        top=10)
            else:
                forward()
                torch.cuda.synchronize()
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def ring_several_cards(n_cards):
    """One NCCL rank per card (the largest power of two not above the card
    count): ESM2-650M at B=1 x RING_MULTI_T over the ring."""
    import torch.multiprocessing as mp

    world = 1 << (n_cards.bit_length() - 1)
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.start_processes(ring_rank, args=(world, free_port(), out_dir), nprocs=world,
                                 join=False, start_method="spawn")
        deadline = time.monotonic() + RING_TIMEOUT
        while not ctx.join(timeout=5):  # raises when a rank fails
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise AssertionError(f"[ring] the {world} ranks did not end in {RING_TIMEOUT} s")
        results = []
        for rank in range(world):
            with open(os.path.join(out_dir, f"rank{rank}.json")) as f:
                results.append(json.load(f))
    for rank, res in enumerate(results):
        check_ring_run(f"{world} cards, rank {rank}, T={RING_MULTI_T}", res, res["n_layers"],
                       steps=3, falling=True)
    return world, results


def phase_ring(card):
    """Sequence parallelism: the K4/K5 block check; ESM2-650M through
    apply_seq_sharded and train_step_seq on a one-rank NCCL group of this
    card; with two or more cards, a ring over one rank per card."""
    import torch
    import torch.distributed as dist
    from esm_tpu_torch.models import esm2
    from esm_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    t_phase = time.perf_counter()
    entries = ring_block_check(torch.Generator(device="cuda").manual_seed(20))
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", world_size=1,
                            rank=0)
    try:
        mesh = make_mesh(MeshConfig(1, 1, 1))
        model, cfg, alphabet = ring_model("cuda")
        n_layers = len(model.layers)
        tokens = ring_tokens(alphabet, 2, RING_T, seed=22, device="cuda")
        res = ring_run(mesh, model, cfg, tokens, steps=2)
        check_ring_run(f"one-rank NCCL group on {card}, B=2 x {RING_T}", res, n_layers, steps=2,
                       falling=False)
        with torch.no_grad():
            profile(f"one ring forward, a one-rank group, B=2 x {RING_T}",
                    lambda: esm2.apply_seq_sharded(model, cfg, tokens, mesh=mesh), top=10)
        del model
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    windows = ("forward_counts", "step_counts", "train_counts")
    k4_launches = sum(res[w]["flash_attention_with_lse"] for w in windows)
    k5_launches = sum(res[w]["flash_attention_bwd.dq"] for w in windows)
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        world, results = ring_several_cards(n_cards)
        log(f"[ring] ran: the block check, a one-rank NCCL group, and a ring of {world} ranks "
            f"over {n_cards} cards (T={RING_MULTI_T})")
    else:
        log("[ring] ran: the block check and a one-rank NCCL group (one card present: no "
            "multi-card ring)")
    entries[0]["launches"], entries[1]["launches"] = k4_launches, k5_launches
    log(f"[ring] took {time.perf_counter() - t_phase:.1f} s; K4 {k4_launches} and K5 "
        f"{k5_launches} launches on the one-rank main path (a forward, step 0's gradients and "
        f"2 steps)")
    return entries


# --------------------------------------------------------------------------
# Parameter sharding and the GPipe pipeline ([shard])
# --------------------------------------------------------------------------

SHARD_B, SHARD_TRAIN_B = 32, 8   # [main]'s and [train]'s rows (x 1024 tokens)
SHARD_STEPS = 3
SHARD_M = 4                      # microbatches of the one-card pipeline checks
SHARD_3B_B = 8                   # rows of the ESM2-3B step (plan_train: fits)
SHARD_PP_LOSS_TOL = 1e-3         # pipelined vs one-card step-0 loss, relative
SHARD_TIMEOUT = 1200             # seconds the ranks of the several-card part may take
SHARD_15B_FWD = (4, 510)         # [shard] tp=4: ESM2-15B bf16 forward, B x L residues
SHARD_PP_CARDS_M = 8             # pp=4: microbatches of the ESM2-650M step
# [shard] fsdp=4: the ESM2-15B steps' learning rate. At TRAIN_LR (1e-6) this
# random init's loss rose on every rank, 126.40 -> 175.43 -> 216.55 (PERF.md §6);
# a smaller step tells a step too large from a wrong update (which no step
# size makes fall).
SHARD_15B_LR = 1e-7
SHARD_LORA_STEPS = 3             # [shard] LoRA steps on the one-rank group
SHARD_ADAFACTOR_STEPS = 2        # [shard] adafactor steps, sharded against unsharded
SHARD_UPDATE_LR = 1e-3           # four cards: the adafactor update compared (no decay): at
                                 # TRAIN_LR an fp32 weight's rounding is ~3% of its change
# four cards: the ESM2-15B LoRA rate. At 1e-3 this random init's loss rose
# 110.82 -> 176.19 -> 1033.63 on every rank (PERF.md §6).
SHARD_15B_LORA_LR = 1e-5         # [lora]'s LORA_LR
SHARD_15B_LORA_B = 4             # rows of the ESM2-15B LoRA steps (x 1024 tokens)


def shard_model(device, name="esm2_t33_650M_UR50D", seed=30, num_layers=None):
    """A seeded ESM-2 at a released size (``num_layers`` cuts its depth) with
    [train]'s options: fp32 master weights, bf16 compute, flash, remat "dots"."""
    import torch
    from esm_tpu_torch.models import esm2
    from esm_tpu_torch.pretrained import _esm2_alphabet

    size = dict(esm2.ESM2_SIZES[name])
    if num_layers is not None:
        size["num_layers"] = num_layers
    alphabet = _esm2_alphabet()
    cfg = esm2.ESM2Config.from_alphabet(alphabet, **size, compute_dtype=torch.bfloat16,
                                        use_flash=True, remat=True, remat_policy="dots")
    model = esm2.init(cfg, torch.Generator(device=device).manual_seed(seed), device=device)
    return model, cfg, alphabet


def flash_counts(n_layers, fwd=0, lse=0, bwd=0):
    return {"flash_attention": fwd * n_layers, "flash_attention_with_lse": lse * n_layers,
            "flash_attention_bwd.dq": bwd * n_layers, "flash_attention_bwd.dkv": bwd * n_layers,
            "triangle_attention_fused": 0, "tri_mul_stage1": 0, "tri_mul_epilogue": 0}


def timed_s(fn, iters=3):
    """Host seconds of ``fn`` (synchronised), the mean of ``iters`` after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters


def fitted_act_units(cfg, peak, plan, b, t):
    """The act_units that make plan_train's activations the measured peak's
    rest (peak less parameters, moments and gradients, and the logits)."""
    d, n = cfg.embed_dim, cfg.num_layers
    logits = b * t * cfg.alphabet_size * 4
    rest = peak - plan["params_bytes"] - plan["optimizer_bytes"] - plan["grads_bytes"] - logits
    return rest / (n * d * t * b * 2)


def fitted_lora_units(cfg, peak, plan, b, t):
    """The activation units that make plan_train_lora's activations the
    measured peak's rest (peak less the base, the adapters' state and the
    int8 transients, and the logits)."""
    logits = b * t * cfg.alphabet_size * 4
    rest = (peak - plan["params_bytes"] - plan["adapter_bytes"] - plan["optimizer_bytes"]
            - plan["grads_bytes"] - plan["weight_transient_bytes"] - logits)
    return rest / (cfg.num_layers * cfg.embed_dim * t * b * 2)


def shard_gemm_rate(card):
    """The bf16 GEMM rate at the LM's products: ESM2-650M's q/k/v/out, fc1 and
    fc2 at [train]'s 8 x 1024 tokens (and ESM2-15B's at 1 x 1024), timed with
    CUDA events; the scaling model's measured constant."""
    import torch
    import torch.nn.functional as F

    rates = {}
    for label, tokens, d in (("ESM2-650M", 8 * 1024, 1280), ("ESM2-15B", 1024, 5120)):
        gen = torch.Generator(device="cuda").manual_seed(40)
        flops = ms = 0.0
        for k_in, n_out, count in ((d, d, 4), (d, 4 * d, 1), (4 * d, d, 1)):
            x = torch.randn(tokens, k_in, device="cuda", generator=gen).bfloat16()
            w = torch.randn(n_out, k_in, device="cuda", generator=gen).bfloat16()
            ms += count * cuda_time_ms(lambda: F.linear(x, w))
            flops += count * 2 * tokens * k_in * n_out
        rates[label] = flops / ms / 1e9
        log(f"[shard] bf16 GEMM rate at {label}'s layer products ({tokens} tokens, "
            f"F.linear): {rates[label]:.1f} TFLOP/s over {ms:.3f} ms a layer "
            f"({rates[label] / (H100_BF16_FLOPS / 1e12):.3f} of the published 989; {card})")
    return rates


def shard_one_card(card):
    """[shard]'s main path on a one-rank NCCL group of this card. Returns the
    launch counts of its windows and the numbers it printed."""
    import dataclasses

    import torch
    from esm_tpu_torch import training
    from esm_tpu_torch.models import esm2
    from esm_tpu_torch.parallel import memory_plan
    from esm_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from esm_tpu_torch.parallel.pipeline import make_pp_mesh
    from esm_tpu_torch.parallel.sharding import batch_rows, resident_bytes, shard_params

    model, cfg, alphabet = shard_model("cuda")
    n = cfg.num_layers
    fwd_cfg = dataclasses.replace(cfg, remat=False)
    tokens = torch.from_numpy(bench_tokens(alphabet, SHARD_B, 1022)).cuda()
    train_toks = torch.from_numpy(bench_tokens(alphabet, SHARD_TRAIN_B, 1022, seed=31)).cuda()
    corrupted, target_mask = training._corrupt_batch(
        cfg, torch.Generator(device="cuda").manual_seed(32), train_toks)
    batch = (corrupted, train_toks, target_mask)
    res = {}

    # the unsharded model first: its logits, forward time and step-0 gradients
    with torch.no_grad():
        whole = esm2.apply(model, fwd_cfg, tokens)["logits"]
        res["one_card_forward_s"] = timed_s(lambda: esm2.apply(model, fwd_cfg, tokens))
    loss0, g0 = grads_of(model, cfg, batch)
    mesh_cfg = MeshConfig(1, 1, 1)
    planned = memory_plan.plan_model(cfg, mesh_cfg)["per_device_bytes"]

    mesh = make_mesh(mesh_cfg)
    shard_params(model, mesh)
    held = resident_bytes(model)
    log(f"[shard] ESM2-650M sharded on a one-rank NCCL group of {card}, mesh {mesh_cfg.shape}: "
        f"{held} parameter bytes resident, plan_model {planned}")
    if held != planned:
        raise AssertionError(f"[shard] resident {held} != plan_model {planned}")

    with torch.no_grad():
        zero_counts()
        logits = esm2.apply(model, fwd_cfg, batch_rows(tokens, mesh))["logits"]
        torch.cuda.synchronize()
        res["forward_counts"] = read_counts()
        res["forward_s"] = timed_s(lambda: esm2.apply(model, fwd_cfg, tokens))
    res["forward_equal"] = bool(torch.equal(logits, whole))
    log(f"[shard] forward B={SHARD_B} x 1024 through shard_params: logits equal to the unsharded "
        f"flash forward bit for bit: {res['forward_equal']}; {res['forward_s'] * 1e3:.1f} ms "
        f"(unsharded {res['one_card_forward_s'] * 1e3:.1f} ms; [main] "
        f"{SHARD_B / MEASURED.get('main_seq_s', float('nan')) * 1e3:.1f} ms); launches "
        f"{res['forward_counts']}")
    del logits

    model.zero_grad(set_to_none=True)
    zero_counts()
    metrics = training.sharded_loss_and_grads(model, cfg, *batch)
    torch.cuda.synchronize()
    res["step_counts"] = read_counts()
    g1 = {n_: p.grad.detach().clone() for n_, p in model.named_parameters()
          if p.grad is not None and n_ in g0}
    res["grads_equal"] = g1.keys() == g0.keys() and all(torch.equal(g1[k], g0[k]) for k in g0)
    res["loss_equal"] = metrics["loss"].item() == loss0
    model.zero_grad(set_to_none=True)
    log(f"[shard] step 0 (B={SHARD_TRAIN_B} x 1024, remat dots): loss {metrics['loss'].item():.6f} "
        f"vs unsharded {loss0:.6f}, equal {res['loss_equal']}; gradients equal bit for bit "
        f"({len(g0)} tensors): {res['grads_equal']}; launches {res['step_counts']}")
    del g1

    # the pipeline: one stage, SHARD_M microbatches
    shard_params(model, make_pp_mesh(1))
    with torch.no_grad():
        zero_counts()
        logits_pp = esm2.apply_pipelined(model, fwd_cfg, tokens,
                                         num_microbatches=SHARD_M)["logits"]
        torch.cuda.synchronize()
        res["pp_forward_counts"] = read_counts()
        res["pp_forward_s"] = timed_s(lambda: esm2.apply_pipelined(
            model, fwd_cfg, tokens, num_microbatches=SHARD_M))
    log(f"[shard] apply_pipelined pp=1, M={SHARD_M}: {res['pp_forward_s'] * 1e3:.1f} ms; "
        f"launches {res['pp_forward_counts']}")
    hold_flash("shard", logits_pp, whole)
    del logits_pp, whole
    zero_counts()
    t0 = time.perf_counter()
    metrics = training.pp_loss_and_grads(model, cfg, *batch, num_microbatches=SHARD_M)
    torch.cuda.synchronize()
    res["pp_step_s"] = time.perf_counter() - t0
    res["pp_step_counts"] = read_counts()
    g_pp = {n_: p.grad.detach().clone() for n_, p in model.named_parameters()
            if p.grad is not None and n_ in g0}
    cos, name, ratio = grad_agreement(g_pp, g0, names=lambda n_: n_.endswith("weight"))
    res.update(pp_loss=metrics["loss"].item(), pp_cos=cos, pp_ratio=ratio)
    log(f"[shard] pp_loss_and_grads pp=1, M={SHARD_M}: loss {res['pp_loss']:.6f} vs one card "
        f"{loss0:.6f}; gradients lowest cosine {cos:.6f} ({name}), norm ratio {ratio:.6f}; "
        f"{res['pp_step_s'] * 1e3:.1f} ms (host clock, first call); launches "
        f"{res['pp_step_counts']}")
    res["loss0"] = loss0
    del g0, g_pp
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    # SHARD_STEPS steps on the (1, 1, 1) mesh again, their peak against the plan
    shard_params(model, mesh)
    tx = training.make_optimizer(TRAIN_LR, warmup_steps=0, total_steps=1000)
    state = training.init_state(model, tx)
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    zero_counts()
    for _ in range(SHARD_STEPS):
        t0 = time.perf_counter()
        state, m = training.train_step_corrupted(state, cfg, tx, *batch)
        losses.append(m["loss"].item())
        secs.append(time.perf_counter() - t0)
    res["train_counts"] = read_counts()
    peak = torch.cuda.max_memory_allocated()
    plan = memory_plan.plan_train(cfg, mesh_cfg, SHARD_TRAIN_B, 1024)
    esm_tpu_plan = memory_plan.plan_train(cfg, mesh_cfg, SHARD_TRAIN_B, 1024, act_units=10)
    res.update(losses=losses, step_s=secs, peak=peak, plan=plan["per_device_bytes"],
               fit_650m=fitted_act_units(cfg, peak, plan, SHARD_TRAIN_B, 1024))
    log(f"[shard] {SHARD_STEPS} sharded train steps: losses "
        + ", ".join(f"{x:.5f}" for x in losses) + "; ms a step "
        + ", ".join(f"{s * 1e3:.1f}" for s in secs)
        + f"; peak {peak / 1e9:.3f} GB (max_memory_allocated), plan_train "
        f"{plan['per_device_bytes'] / 1e9:.3f} GB ({plan['verdict']}; with esm_tpu's activation "
        f"terms {esm_tpu_plan['per_device_bytes'] / 1e9:.3f} GB); act_units that fit this "
        f"peak {res['fit_650m']:.2f} (plan: {memory_plan.ACT_UNITS}); launches {res['train_counts']}")
    res["save"] = shard_save_host(card, state)
    del model, state, tx
    torch.cuda.empty_cache()

    # ESM2-3B: one sharded step that fits, its peak against the plan
    model, cfg3, alphabet = shard_model("cuda", "esm2_t36_3B_UR50D", seed=33)
    shard_params(model, make_mesh(mesh_cfg))
    toks3 = torch.from_numpy(bench_tokens(alphabet, SHARD_3B_B, 1022, seed=34)).cuda()
    c3, m3 = training._corrupt_batch(cfg3, torch.Generator(device="cuda").manual_seed(35), toks3)
    tx = training.make_optimizer(TRAIN_LR, warmup_steps=0, total_steps=1000)
    state = training.init_state(model, tx)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    state, m = training.train_step_corrupted(state, cfg3, tx, c3, toks3, m3)
    loss3 = m["loss"].item()
    res["3b_step_s"] = time.perf_counter() - t0
    res["3b_counts"] = read_counts()
    peak3 = torch.cuda.max_memory_allocated()
    plan3 = memory_plan.plan_train(cfg3, mesh_cfg, SHARD_3B_B, 1024)
    res.update(peak_3b=peak3, plan_3b=plan3["per_device_bytes"],
               fit_3b=fitted_act_units(cfg3, peak3, plan3, SHARD_3B_B, 1024))
    log(f"[shard] ESM2-3B ({sum(p.numel() for p in model.parameters()) / 1e6:.1f}M parameters) "
        f"sharded step B={SHARD_3B_B} x 1024: loss {loss3:.5f}, {res['3b_step_s'] * 1e3:.1f} ms "
        f"(first step), peak {peak3 / 1e9:.3f} GB, plan_train {plan3['per_device_bytes'] / 1e9:.3f} "
        f"GB ({plan3['verdict']}); act_units that fit {res['fit_3b']:.2f}; launches "
        f"{res['3b_counts']}")
    if not np.isfinite(loss3):
        raise AssertionError(f"[shard] ESM2-3B step loss {loss3}")
    del model, state, tx
    torch.cuda.empty_cache()
    res["n_layers"], res["n_layers_3b"] = n, cfg3.num_layers
    return res


def host_rss_bytes():
    """This process's resident set, from /proc/self/statm."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def save_host_growth(save):
    """Run ``save()`` with a thread sampling the resident set every ms:
    (peak growth over the resident set before it, seconds)."""
    import threading

    before = host_rss_bytes()
    peak, stop = [before], threading.Event()

    def sample():
        while not stop.is_set():
            peak[0] = max(peak[0], host_rss_bytes())
            time.sleep(0.001)

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    t0 = time.perf_counter()
    try:
        save()
    finally:
        seconds = time.perf_counter() - t0
        stop.set()
        thread.join()
    return max(peak[0], host_rss_bytes()) - before, seconds


def shard_save_host(card, state):
    """A save of ESM2-650M's AdamW train state from the one-rank group: rank
    0's peak host RSS growth beside the largest entry's bytes and the whole
    tree's (the writer holds one host copy at a time)."""
    from esm_tpu_torch.io import checkpoint
    from esm_tpu_torch.training import tensor_fields

    tensors = [state.model.state_dict()] + list(tensor_fields(state.opt_state).values())
    sizes = [t.numel() * t.element_size() for d in tensors for t in d.values()]
    with tempfile.TemporaryDirectory() as tmp:
        growth, seconds = save_host_growth(lambda: checkpoint.save_train_state(tmp, state))
    out = {"growth": growth, "largest": max(sizes), "tree": sum(sizes), "save_s": seconds}
    log(f"[shard] save of ESM2-650M's AdamW train state ({len(sizes)} entries): rank 0's host "
        f"RSS grew {growth / 1e6:.1f} MB at its peak (sampled every ms); the largest entry "
        f"{out['largest'] / 1e6:.1f} MB, the whole tree {out['tree'] / 1e9:.3f} GB; "
        f"{seconds:.1f} s ({card})")
    return out


def _lora_bases(kind, mesh, seed):
    """ESM2-650M as --lora stores it, twice from one seed: whole, and
    sharded on ``mesh`` before it is stored (the sharded int8 path)."""
    from esm_tpu_torch import lora
    from esm_tpu_torch.parallel.sharding import shard_params

    whole, cfg, alphabet = shard_model("cuda", seed=seed)
    lora.store_base(whole, int8=kind == "int8")
    sharded, _, _ = shard_model("cuda", seed=seed)
    lora.store_base(shard_params(sharded, mesh), int8=kind == "int8")
    return whole, sharded, cfg, alphabet


def shard_train_one_card(card, mesh_cfg):
    """LoRA (rank 16, bf16 and int8 bases) and adafactor on [shard]'s
    one-rank group at ESM2-650M's full width and depth, B=8 x 1024, against
    the unsharded steps bit for bit; the peaks beside plan_train_lora and
    plan_train(factored=True). Returns the launch counts and numbers."""
    import torch
    from esm_tpu_torch import lora, training
    from esm_tpu_torch.parallel import memory_plan
    from esm_tpu_torch.parallel.mesh import make_mesh
    from esm_tpu_torch.parallel.sharding import shard_params

    mesh = make_mesh(mesh_cfg)
    res = {"lora": {}}
    for kind in ("bf16", "int8"):
        whole, sharded, cfg, alphabet = _lora_bases(kind, mesh, seed=50)
        same_base = all(torch.equal(a, b) for a, b in zip(whole.state_dict().values(),
                                                          sharded.state_dict().values()))
        toks = torch.from_numpy(bench_tokens(alphabet, SHARD_TRAIN_B, 1022, seed=51)).cuda()
        corrupted, target_mask = training._corrupt_batch(
            cfg, torch.Generator(device="cuda").manual_seed(52), toks)
        batch = (corrupted, toks, target_mask)
        adapters = lora.init_lora(torch.Generator(device="cuda").manual_seed(53), whole,
                                  rank=LORA_RANK)
        with torch.no_grad():  # nonzero b, so that every factor has a gradient
            gen = torch.Generator(device="cuda").manual_seed(54)
            for _, a in adapters.adapters():
                a.lora_b.normal_(0.0, 0.02, generator=gen)
        loss_u, g_u = adapter_grads(whole, adapters, cfg, batch)
        del whole
        torch.cuda.empty_cache()
        zero_counts()
        with training.frozen_and_patched(sharded, adapters, 1.0):
            metrics = training.sharded_loss_and_grads(sharded, cfg, *batch, adapters=adapters)
        torch.cuda.synchronize()
        step_counts = read_counts()
        g_s = {n: p.grad.detach().clone() for n, p in adapters.named_parameters()}
        adapters.zero_grad(set_to_none=True)
        equal = (metrics["loss"].item() == loss_u and g_s.keys() == g_u.keys()
                 and all(torch.equal(g_s[k], g_u[k]) for k in g_u))
        del g_s, g_u, adapters
        # SHARD_LORA_STEPS steps from fresh adapters (b = 0), AdamW at LORA_LR
        adapters = lora.init_lora(torch.Generator(device="cuda").manual_seed(55), sharded,
                                  rank=LORA_RANK)
        tx = training.make_optimizer(LORA_LR, warmup_steps=0, total_steps=1000)
        state = training.init_state(adapters, tx)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        losses, secs = [], []
        for _ in range(SHARD_LORA_STEPS):
            t0 = time.perf_counter()
            state, m = training.train_step_lora_corrupted(state, sharded, cfg, tx, *batch)
            losses.append(m["loss"].item())
            secs.append(time.perf_counter() - t0)
        steps_counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        plan = memory_plan.plan_train_lora(cfg, mesh_cfg, SHARD_TRAIN_B, 1024, rank=LORA_RANK,
                                           base_dtype_bytes=1 if kind == "int8" else 2)
        res["lora"][kind] = dict(equal=equal, same_base=same_base, step_counts=step_counts,
                                 steps_counts=steps_counts, losses=losses, peak=peak,
                                 plan=plan["per_device_bytes"])
        log(f"[shard] LoRA rank {LORA_RANK}, {kind} base stored after the cut (equal to the "
            f"whole model's stored base: {same_base}), B={SHARD_TRAIN_B} x 1024 on the one-rank "
            f"group: step 0 loss {loss_u:.6f}, loss and adapter gradients equal to the "
            f"unsharded step's bit for bit: {equal}; launches {step_counts}; "
            f"{SHARD_LORA_STEPS} steps (lr {LORA_LR}): losses "
            + ", ".join(f"{x:.5f}" for x in losses) + "; ms a step "
            + ", ".join(f"{x * 1e3:.1f}" for x in secs)
            + f"; peak {peak / 1e9:.3f} GB (max_memory_allocated), plan_train_lora "
            f"{plan['per_device_bytes'] / 1e9:.3f} GB ({plan['verdict']}; activations "
            f"{plan['activations_bytes'] / 1e9:.3f} GB of it); activation units that fit this "
            f"peak {fitted_lora_units(cfg, peak, plan, SHARD_TRAIN_B, 1024):.2f} (plan: "
            f"{memory_plan.LORA_ACT_UNITS}); launches {steps_counts} ({card})")
        del sharded, state, adapters, tx, batch
        torch.cuda.empty_cache()

    # adafactor: SHARD_ADAFACTOR_STEPS steps unsharded, then sharded
    runs = {}
    for sharded in (False, True):
        model, cfg, alphabet = shard_model("cuda", seed=56)
        if sharded:
            shard_params(model, mesh)
        toks = torch.from_numpy(bench_tokens(alphabet, SHARD_TRAIN_B, 1022, seed=57)).cuda()
        corrupted, target_mask = training._corrupt_batch(
            cfg, torch.Generator(device="cuda").manual_seed(58), toks)
        tx = training.make_optimizer(TRAIN_LR, warmup_steps=0, total_steps=1000, factored=True)
        state = training.init_state(model, tx)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        losses = []
        for _ in range(SHARD_ADAFACTOR_STEPS):
            state, m = training.train_step_corrupted(state, cfg, tx, corrupted, toks, target_mask)
            losses.append(m["loss"].item())
        counts = read_counts()
        tensors = {"params": model.state_dict(), **training.tensor_fields(state.opt_state)}
        runs[sharded] = dict(losses=losses, counts=counts, peak=torch.cuda.max_memory_allocated(),
                             tensors={k: {n: t.cpu() for n, t in d.items()}
                                      for k, d in tensors.items()})
        del model, state, tx, tensors
        torch.cuda.empty_cache()
    a, b = runs[False], runs[True]
    equal = a["losses"] == b["losses"] and all(
        a["tensors"][k].keys() == b["tensors"][k].keys()
        and all(torch.equal(a["tensors"][k][n], b["tensors"][k][n]) for n in a["tensors"][k])
        for k in a["tensors"])
    plan = memory_plan.plan_train(cfg, mesh_cfg, SHARD_TRAIN_B, 1024, factored=True)
    res["adafactor"] = dict(equal=equal, counts=b["counts"], losses=b["losses"], peak=b["peak"],
                            plan=plan["per_device_bytes"])
    log(f"[shard] adafactor, ESM2-650M B={SHARD_TRAIN_B} x 1024, {SHARD_ADAFACTOR_STEPS} steps "
        f"(lr {TRAIN_LR}) on the one-rank group: losses " + ", ".join(f"{x:.5f}" for x in b["losses"])
        + f"; parameters, v_row, v_col and v equal to the unsharded steps' bit for bit: {equal}; "
        f"peak {b['peak'] / 1e9:.3f} GB (unsharded {a['peak'] / 1e9:.3f}), plan_train(factored) "
        f"{plan['per_device_bytes'] / 1e9:.3f} GB ({plan['verdict']}); launches {b['counts']} "
        f"({card})")
    return res


def check_shard_train(res, n):
    """Raises unless [shard]'s LoRA and adafactor parts hold: bit for bit
    against the unsharded steps, the launch counts, the LoRA losses falling."""
    failed = []
    for kind, r in res["lora"].items():
        if not (r["equal"] and r["same_base"]):
            failed.append(f"LoRA {kind}: the sharded step 0 or base is not the unsharded one's")
        for label, got, want in (("step 0", r["step_counts"], flash_counts(n, lse=2, bwd=1)),
                                 ("steps", r["steps_counts"],
                                  flash_counts(n, lse=2 * SHARD_LORA_STEPS, bwd=SHARD_LORA_STEPS))):
            if got != want:
                failed.append(f"LoRA {kind} {label} launches {got} != {want}")
        if not (np.isfinite(r["losses"]).all() and r["losses"][-1] < r["losses"][0]):
            failed.append(f"LoRA {kind} losses {r['losses']}")
    r = res["adafactor"]
    want = flash_counts(n, lse=2 * SHARD_ADAFACTOR_STEPS, bwd=SHARD_ADAFACTOR_STEPS)
    if r["counts"] != want:
        failed.append(f"adafactor launches {r['counts']} != {want}")
    if not (r["equal"] and np.isfinite(r["losses"]).all()):
        failed.append("the sharded adafactor steps are not the unsharded ones")
    if failed:
        raise AssertionError("[shard] " + "; ".join(failed))


SHARD_MSA = (400, 256)           # [msa]'s MSA: R rows x C residues (257 tokens a row)
SHARD_MSA_TRAIN = (128, 256)     # [train-msa]'s
SHARD_MSA_LR = 1e-5              # [train-msa]'s rate
SHARD_FAMILY_STEPS = 3           # the MSA steps on the one-rank group, four cards' steps


def family_model(name, seed, **options):
    """A seeded ESM-1-family model or MSA Transformer at its released size on
    the card (fp32 weights, bf16 compute, ``options``): (model, cfg,
    alphabet, apply)."""
    import torch
    from esm_tpu_torch import pretrained

    handle, alphabet = pretrained.random_model_and_alphabet(
        name, seed=seed, device="cuda", compute_dtype=torch.bfloat16, **options)
    return handle.model, handle.cfg, alphabet, pretrained._APPLY[handle.kind]


def family_adapter_grads(base, adapters, cfg, batch, apply):
    """Loss and adapter gradients of one LoRA loss over a family's frozen base."""
    from esm_tpu_torch import training

    adapters.zero_grad(set_to_none=True)
    with training.frozen_and_patched(base, adapters, 1.0):
        loss, _ = training.mlm_loss(base, cfg, *batch, apply_fn=apply)
        loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in adapters.named_parameters()}
    adapters.zero_grad(set_to_none=True)
    return loss.item(), grads


def shard_families_one_card(card, mesh_cfg):
    """The ESM-1 family and the MSA Transformer on [shard]'s one-rank group at
    their released sizes (seeded, bf16 compute): ESM-1b at B=32 x 1024 and
    ESM-1 t34 (bias_kv, S = T + 1) through K1, MSA-1b on [msa]'s 400 x 257
    MSA, each sharded forward against the unsharded one bit for bit; MSA-1b's
    step 0 at [train-msa]'s 128 x 257 against the unsharded step bit for bit,
    then train_step_msa steps; a rank-16 LoRA step over a sharded ESM-1b base
    (bf16, int8; flash, no remat: esm_tpu's ESM-1 has none) against the
    unsharded step bit for bit;
    ESM2-650M's LoRA step through the pipeline at pp=1, M=SHARD_M, against
    one card's step. Returns the launch counts of its windows and numbers."""
    import dataclasses

    import torch
    from esm_tpu_torch import lora, training
    from esm_tpu_torch.parallel import memory_plan
    from esm_tpu_torch.parallel.mesh import make_mesh
    from esm_tpu_torch.parallel.pipeline import make_pp_mesh
    from esm_tpu_torch.parallel.sharding import batch_rows, resident_bytes, shard_params

    mesh = make_mesh(mesh_cfg)
    res = {"forward": {}, "lora": {}}
    for path, name, seed in (("esm1b", "esm1b_t33_650M_UR50S", 80),
                             ("esm1", "esm1_t34_670M_UR50S", 82)):
        model, cfg, alphabet, apply = family_model(name, seed, use_flash=True)
        tokens = torch.from_numpy(bench_tokens(alphabet, SHARD_B, 1022, seed=seed + 1)).cuda()
        with torch.no_grad():
            whole = apply(model, cfg, tokens)["logits"]
            one_s = timed_s(lambda: apply(model, cfg, tokens))
        shard_params(model, mesh)
        with torch.no_grad():
            zero_counts()
            with k1_shapes() as shapes:
                logits = apply(model, cfg, batch_rows(tokens, mesh))["logits"]
                torch.cuda.synchronize()
            counts = read_counts()
            sharded_s = timed_s(lambda: apply(model, cfg, tokens))
        t = tokens.shape[1]
        r = dict(counts=counts, shapes=sorted(set(shapes)), equal=bool(torch.equal(logits, whole)),
                 n=cfg.num_layers, want_shapes=[(t, t + int(path == "esm1"), False)],
                 sharded_s=sharded_s, one_s=one_s)
        res["forward"][path] = r
        log(f"[shard] {name} sharded on the one-rank group, bf16 flash, B={SHARD_B} x {t}: logits "
            f"equal to the unsharded forward's bit for bit: {r['equal']}; {sharded_s * 1e3:.1f} ms "
            f"(unsharded {one_s * 1e3:.1f} ms); K1 at (T, S, rotary) {r['shapes']}; launches "
            f"{counts} ({card})")
        del model, whole, logits
        torch.cuda.empty_cache()

    # MSA-1b: [msa]'s forward, then [train-msa]'s step 0
    model, cfg, alphabet, apply = family_model("esm_msa1b_t12_100M_UR50S", 84)
    rows, length = SHARD_MSA
    tokens = alphabet.get_batch_converter()([seeded_msa(rows, length, seed=85)])[2].cuda()
    with torch.no_grad():
        whole = apply(model, cfg, tokens)["logits"]
        one_s = timed_s(lambda: apply(model, cfg, tokens), iters=2)
        shard_params(model, mesh)
        zero_counts()
        logits = apply(model, cfg, batch_rows(tokens, mesh))["logits"]
        torch.cuda.synchronize()
        counts = read_counts()
        sharded_s = timed_s(lambda: apply(model, cfg, tokens), iters=2)
    res["msa"] = dict(equal=bool(torch.equal(logits, whole)), counts=counts)
    log(f"[shard] MSA-1b sharded on the one-rank group, bf16, B=1 x R={rows} x C={length + 1} "
        f"(chunked): logits equal to the unsharded forward's bit for bit: {res['msa']['equal']}; "
        f"{sharded_s * 1e3:.1f} ms (unsharded {one_s * 1e3:.1f} ms); launches {counts} (no "
        f"kernel: esm_tpu has none for axial attention)")
    del model, whole, logits
    rows, length = SHARD_MSA_TRAIN
    tokens = msa_tokens(alphabet, rows, length, seed=86).cuda()
    corrupted, target_mask = training._corrupt_batch(
        cfg, torch.Generator(device="cuda").manual_seed(87), tokens)
    batch = (corrupted, tokens, target_mask)
    model, cfg, _, apply = family_model("esm_msa1b_t12_100M_UR50S", 88)
    model.zero_grad(set_to_none=True)
    loss0, _ = training.mlm_loss(model, cfg, *batch, apply_fn=apply)
    loss0.backward()
    g0 = {n: p.grad.detach().clone() for n, p in model.named_parameters() if p.grad is not None}
    loss0 = loss0.item()
    model.zero_grad(set_to_none=True)
    shard_params(model, mesh)
    metrics = training.sharded_loss_and_grads(model, cfg, *batch, apply_fn=apply)
    g1 = {n: p.grad.detach().clone() for n, p in model.named_parameters() if n in g0}
    equal = metrics["loss"].item() == loss0 and all(torch.equal(g1[k], g0[k]) for k in g0)
    model.zero_grad(set_to_none=True)
    del g0, g1
    tx = training.make_optimizer(SHARD_MSA_LR, warmup_steps=0, total_steps=1000)
    state = training.init_state(model, tx)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    for _ in range(SHARD_FAMILY_STEPS):  # one corruption, redrawn from its seed each step
        t0 = time.perf_counter()
        state, m = training.train_step_msa(state, cfg, tx,
                                           torch.Generator(device="cuda").manual_seed(87), tokens)
        losses.append(m["loss"].item())
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    held = resident_bytes(model)
    planned = memory_plan.plan(type(model)(cfg, device="meta"), mesh_cfg)["per_device_bytes"]
    res["msa_step"] = dict(equal=equal, losses=losses, peak=peak)
    log(f"[shard] MSA-1b step 0 on the one-rank group (bf16 compute, B=1 x R={rows} x "
        f"C={length + 1}): loss {loss0:.6f}, loss and gradients equal to the unsharded step's bit "
        f"for bit: {equal}; {SHARD_FAMILY_STEPS} train_step_msa steps (lr {SHARD_MSA_LR}, one "
        f"corruption): losses " + ", ".join(f"{x:.5f}" for x in losses) + "; ms a step "
        + ", ".join(f"{x * 1e3:.1f}" for x in secs) + f"; peak {peak / 1e9:.3f} GB "
        f"(max_memory_allocated; parameters {held / 1e9:.3f} GB, plan {planned / 1e9:.3f} GB; "
        f"AdamW moments and gradients 3x the parameters) ({card})")
    del model, state, tx, batch
    torch.cuda.empty_cache()

    # LoRA over a sharded ESM-1b base, flash (no remat: esm_tpu's ESM-1 has none)
    for kind in ("bf16", "int8"):
        whole, cfg, alphabet, apply = family_model("esm1b_t33_650M_UR50S", 89, use_flash=True)
        lora.store_base(whole, int8=kind == "int8")
        sharded, _, _, _ = family_model("esm1b_t33_650M_UR50S", 89, use_flash=True)
        lora.store_base(shard_params(sharded, mesh), int8=kind == "int8")
        same_base = all(torch.equal(a, b) for a, b in zip(whole.state_dict().values(),
                                                          sharded.state_dict().values()))
        toks = torch.from_numpy(bench_tokens(alphabet, SHARD_TRAIN_B, 1022, seed=90)).cuda()
        corrupted, target_mask = training._corrupt_batch(
            cfg, torch.Generator(device="cuda").manual_seed(91), toks)
        batch = (corrupted, toks, target_mask)
        adapters = _lora_adapters(whole, 92)
        loss_u, g_u = family_adapter_grads(whole, adapters, cfg, batch, apply)
        del whole
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        with training.frozen_and_patched(sharded, adapters, 1.0):
            metrics = training.sharded_loss_and_grads(sharded, cfg, *batch, apply_fn=apply,
                                                      adapters=adapters)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        g_s = {n: p.grad.detach().clone() for n, p in adapters.named_parameters()}
        equal = (metrics["loss"].item() == loss_u and g_s.keys() == g_u.keys()
                 and all(torch.equal(g_s[k], g_u[k]) for k in g_u))
        # plan_train_lora models an ESM-2 of these widths (ESM-1b adds its
        # 1026 learned positions)
        plan = memory_plan.plan_train_lora(cfg, mesh_cfg, SHARD_TRAIN_B, 1024, rank=LORA_RANK,
                                           base_dtype_bytes=1 if kind == "int8" else 2)
        res["lora"][kind] = dict(equal=equal, same_base=same_base, counts=counts)
        log(f"[shard] ESM-1b LoRA rank {LORA_RANK}, {kind} base stored after the cut (equal to "
            f"the whole model's: {same_base}), B={SHARD_TRAIN_B} x 1024, flash: step 0 "
            f"loss {loss_u:.6f}, loss and adapter gradients equal to the unsharded step's bit for "
            f"bit: {equal}; {step_s * 1e3:.1f} ms (host clock, first call); peak {peak / 1e9:.3f} "
            f"GB, plan_train_lora {plan['per_device_bytes'] / 1e9:.3f} GB ({plan['verdict']}); "
            f"launches {counts} ({card})")
        del sharded, adapters, g_s, g_u, batch
        torch.cuda.empty_cache()

    # LoRA over ESM2-650M through the GPipe schedule at pp=1
    model, cfg, alphabet = shard_model("cuda", seed=93)
    lora.store_base(model)
    toks = torch.from_numpy(bench_tokens(alphabet, SHARD_TRAIN_B, 1022, seed=94)).cuda()
    corrupted, target_mask = training._corrupt_batch(
        cfg, torch.Generator(device="cuda").manual_seed(95), toks)
    batch = (corrupted, toks, target_mask)
    adapters = _lora_adapters(model, 96)
    loss1, g1 = adapter_grads(model, adapters, cfg, batch)
    shard_params(model, make_pp_mesh(1))
    adapters = lora.on_stage(adapters, model)
    zero_counts()
    t0 = time.perf_counter()
    with training.frozen_and_patched(model, adapters, 1.0):
        metrics = training.pp_loss_and_grads(model, cfg, *batch, num_microbatches=SHARD_M,
                                             adapters=adapters)
    torch.cuda.synchronize()
    pp_s = time.perf_counter() - t0
    counts = read_counts()
    grads = {n: p.grad.detach().clone() for n, p in adapters.named_parameters()}
    adapters.zero_grad(set_to_none=True)
    cos, worst, ratio = grad_agreement(grads, g1)
    tx = training.make_optimizer(LORA_LR, warmup_steps=0, total_steps=1000)
    state = training.init_state(adapters, tx)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    losses, secs = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        state, m = training.train_step_lora_corrupted(state, model, cfg, tx, *batch,
                                                      num_microbatches=SHARD_M)
        losses.append(m["loss"].item())
        secs.append(time.perf_counter() - t0)
    steps_counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    plan = memory_plan.plan_train_lora(cfg, mesh_cfg, SHARD_TRAIN_B, 1024, rank=LORA_RANK)
    res["pp_lora"] = dict(loss=metrics["loss"].item(), one_card_loss=loss1, cos=cos, ratio=ratio,
                          counts=counts, steps_counts=steps_counts, losses=losses,
                          n=cfg.num_layers)
    log(f"[shard] ESM2-650M LoRA rank {LORA_RANK} (bf16 base) through the pipeline, pp=1, "
        f"M={SHARD_M}, B={SHARD_TRAIN_B} x 1024: step 0 loss {res['pp_lora']['loss']:.6f} vs one "
        f"card {loss1:.6f}; adapter gradients lowest cosine {cos:.6f} ({worst}), norm ratio "
        f"{ratio:.6f}; {pp_s * 1e3:.1f} ms (host clock, first call); launches {counts}; 2 "
        f"train_step_lora steps (num_microbatches={SHARD_M}): losses "
        + ", ".join(f"{x:.5f}" for x in losses) + "; ms a step "
        + ", ".join(f"{x * 1e3:.1f}" for x in secs) + f"; peak {peak / 1e9:.3f} GB, "
        f"plan_train_lora {plan['per_device_bytes'] / 1e9:.3f} GB ({plan['verdict']}); launches "
        f"{steps_counts} ({card})")
    del model, adapters, state, tx, g1, grads, batch
    torch.cuda.empty_cache()
    return res


def check_shard_families(res):
    """Raises unless the families' one-rank parts hold: the forwards and step
    0s bit for bit, K1 once a layer at the family's (T, S), the LoRA step's
    K1-with-lse and K2 launches, the pipelined LoRA step within [shard]'s
    rule for pipelined steps (loss within SHARD_PP_LOSS_TOL, cosine above
    0.999, norm ratio within 1% of the one-card step's)."""
    failed = []
    for path, r in res["forward"].items():
        if not r["equal"]:
            failed.append(f"{path}: the sharded forward is not the unsharded one")
        if r["counts"] != flash_counts(r["n"], fwd=1) or r["shapes"] != r["want_shapes"]:
            failed.append(f"{path}: K1 launches {r['counts']} at {r['shapes']}")
    if not res["msa"]["equal"] or any(res["msa"]["counts"].values()):
        failed.append(f"MSA-1b: sharded forward equal {res['msa']['equal']}, launches "
                      f"{res['msa']['counts']}")
    step = res["msa_step"]
    if not (step["equal"] and np.isfinite(step["losses"]).all()
            and step["losses"][-1] < step["losses"][0]):
        failed.append(f"MSA-1b step: equal {step['equal']}, losses {step['losses']}")
    n = res["forward"]["esm1b"]["n"]
    for kind, r in res["lora"].items():
        if not (r["equal"] and r["same_base"]):
            failed.append(f"ESM-1b LoRA {kind}: the sharded step 0 or base is not the unsharded's")
        if r["counts"] != flash_counts(n, lse=1, bwd=1):
            failed.append(f"ESM-1b LoRA {kind} launches {r['counts']}")
    r = res["pp_lora"]
    if not (abs(r["loss"] - r["one_card_loss"]) <= SHARD_PP_LOSS_TOL * abs(r["one_card_loss"])
            and r["cos"] > 0.999 and abs(r["ratio"] - 1) <= 0.01):
        failed.append("the pipelined LoRA step 0 is off the one-card step's")
    for label, got, m in (("step 0", r["counts"], SHARD_M), ("steps", r["steps_counts"],
                                                            2 * SHARD_M)):
        if got != flash_counts(r["n"], lse=2 * m, bwd=m):
            failed.append(f"pipelined LoRA {label} launches {got}")
    if not (np.isfinite(r["losses"]).all()):
        failed.append(f"pipelined LoRA losses {r['losses']}")
    if failed:
        raise AssertionError("[shard] " + "; ".join(failed))


def check_shard_one_card(res):
    """Raises unless the one-card [shard] run holds: bit-for-bit forward and
    step 0, exact launch counts in every window, a falling loss, the
    pipeline within [main]'s bounds (checked where printed) and PR 14's
    rule for its step 0."""
    n = res["n_layers"]
    failed = []
    windows = (("forward", res["forward_counts"], flash_counts(n, fwd=1)),
               ("step 0", res["step_counts"], flash_counts(n, lse=2, bwd=1)),
               ("train steps", res["train_counts"], flash_counts(n, lse=2 * SHARD_STEPS,
                                                                  bwd=SHARD_STEPS)),
               ("pipeline forward", res["pp_forward_counts"], flash_counts(n, fwd=SHARD_M)),
               ("pipeline step", res["pp_step_counts"], flash_counts(n, lse=2 * SHARD_M,
                                                                     bwd=SHARD_M)),
               ("3B step", res["3b_counts"], flash_counts(res["n_layers_3b"], lse=2, bwd=1)))
    for label, got, want in windows:
        if got != want:
            failed.append(f"{label} launches {got} != {want}")
    if not (res["forward_equal"] and res["loss_equal"] and res["grads_equal"]):
        failed.append("the one-rank sharded forward or step 0 is not the unsharded one's")
    losses = res["losses"]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        failed.append(f"sharded losses {losses}")
    if not (abs(res["pp_loss"] - res["loss0"]) <= SHARD_PP_LOSS_TOL * abs(res["loss0"])
            and res["pp_cos"] > 0.999 and abs(res["pp_ratio"] - 1) <= 0.01):
        failed.append("the pipelined step 0 is off the one-card step's")
    if failed:
        raise AssertionError("[shard] " + "; ".join(failed))


def shard_entry_points(card):
    """cli.pretrain under torchrun (one process), with AdamW, with --lora 16
    and with --adafactor: 4 steps straight, and 2 steps, stopped, then
    resumed to 4: the saved train states equal bit for bit;
    examples.esm2_infer_sharded at ESM2-650M on seeded weights."""
    import torch
    from esm_tpu_torch.io.checkpoint import read_train_state

    here = os.path.dirname(os.path.abspath(__file__))
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", "1"]
    rng = np.random.RandomState(36)
    variants = {"adamw": [], "lora": ["--lora", "16"], "adafactor": ["--adafactor"]}
    with tempfile.TemporaryDirectory() as tmp:
        fasta = os.path.join(tmp, "train.fasta")
        with open(fasta, "w") as f:
            for i in range(64):
                seq = "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), rng.randint(50, 500)))
                f.write(f">s{i}\n{seq}\n")
        base = ["-m", "esm_tpu_torch.cli.pretrain", "--fasta", fasta, "--steps", "4",
                "--log-every", "1", "--warmup-steps", "1", "--remat", "--toks-per-batch", "4096"]
        runs = {"straight": ["--save-every", "4"],
                "first half": ["--save-every", "2", "--stop-after", "2"],
                "resumed": ["--save-every", "4", "--resume"]}
        example = torchrun + ["-m", "esm_tpu_torch.examples.esm2_infer_sharded", "--random-seed",
                              "0", "--model", "esm2_t33_650M_UR50D"]
        launch = lambda argv: subprocess.Popen(  # noqa: E731
            argv, cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        t0 = time.perf_counter()
        # every straight run, every first half and the example at once (each
        # launch spends most of its time starting), then the resumed runs
        outs, codes = {}, {}

        def finish(procs):
            for label, proc in procs.items():
                outs[label] = proc.communicate(timeout=300)
                codes[label] = proc.returncode

        def pretrain(variant, label, ck):
            return launch(torchrun + base + variants[variant] + runs[label]
                          + ["--checkpoint-dir", os.path.join(tmp, f"{variant}-{ck}")])

        first = {(v, label): pretrain(v, label, ck) for v in variants
                 for label, ck in (("straight", "a"), ("first half", "b"))}
        finish({**first, "example": launch(example)})
        finish({(v, "resumed"): pretrain(v, "resumed", "b") for v in variants})
        seconds = time.perf_counter() - t0
        for label, (stdout, stderr) in outs.items():
            if codes[label]:
                raise AssertionError(f"[shard] torchrun {label} failed ({card}):\n"
                                     f"{stdout[-3000:]}\n{stderr[-3000:]}")
            if label != "example":
                for line in stdout.splitlines():
                    if line.startswith(("mesh", "memory plan", "step", "resumed", "device", "LoRA")):
                        log(f"[shard] pretrain ({label[0]}, {label[1]}): {line}")
        equal = {}
        for v in variants:
            a, b = (read_train_state(os.path.join(tmp, f"{v}-{x}-state")) for x in ("a", "b"))
            flat = lambda d: dict(d["params"]) | {  # noqa: E731
                f"{m}.{k}": t for m, ts in d["opt_state"].items() if isinstance(ts, dict)
                for k, t in ts.items()}
            fa, fb = flat(a), flat(b)
            equal[v] = (a["step"] == b["step"] == 4 and fa.keys() == fb.keys()
                        and all(torch.equal(fa[k], fb[k]) for k in fa))
        log(f"[shard] torchrun cli.pretrain and the example: {2 * len(variants) + 1} launches at "
            f"once, then {len(variants)}, in {seconds:.1f} s; each resumed run's train state "
            f"equals its straight run's bit for bit: {equal}")
        if not all(equal.values()):
            raise AssertionError(f"[shard] a torchrun resume is not bit for bit: {equal}")
        stdout, stderr = outs["example"]
        norms = [float(x) for x in re.findall(r"mean embedding norm: ([0-9.naif]+)", stdout)]
        for line in stdout.splitlines():
            log(f"[shard] esm2_infer_sharded: {line}")
        if len(norms) != 2 or not np.isfinite(norms).all():
            raise AssertionError(f"[shard] esm2_infer_sharded failed ({card}):\n{stdout[-3000:]}"
                                 f"\n{stderr[-3000:]}")


def shard_rank(rank, world, port, out_dir):
    """One rank of [shard]'s several-card part (spawned, one per card)."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=SHARD_TIMEOUT))
    res = {"seconds": {}}
    pp_checkpoint = functools.partial(shard_cards_pp_checkpoint, out_dir=out_dir)
    functools.update_wrapper(pp_checkpoint, shard_cards_pp_checkpoint)
    pp_lora = functools.partial(shard_cards_pp_lora, out_dir=out_dir)
    functools.update_wrapper(pp_lora, shard_cards_pp_lora)
    # the 15B AdamW step last: it has run out of memory on four cards
    for part in (shard_cards_allreduce, shard_cards_15b_forward, shard_cards_3b, shard_cards_pp,
                 shard_cards_3b_lora, shard_cards_3b_adafactor, shard_cards_15b_lora,
                 pp_checkpoint, shard_cards_families_forward, shard_cards_msa_step,
                 shard_cards_esm1b_lora, pp_lora, shard_cards_15b_step):
        t0 = time.perf_counter()
        try:
            res[part.__name__] = part(rank, world)
        except BaseException:
            # leave at once: destroying the group would wait on the other
            # ranks' collectives, and the parent would see a hang, not this
            import traceback

            log(f"[shard] rank {rank}: {part.__name__} failed after "
                f"{time.perf_counter() - t0:.1f} s:\n{traceback.format_exc()}")
            os._exit(1)
        res["seconds"][part.__name__] = time.perf_counter() - t0
        log(f"[shard] rank {rank}: {part.__name__} ended in "
            f"{res['seconds'][part.__name__]:.1f} s: {json.dumps(res[part.__name__])[:600]}")
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def shard_cards_allreduce(rank, world):
    """NCCL all-reduce bus bandwidth at the tp all-reduce's sizes (ESM2-650M's
    and ESM2-15B's (8 x 1024, d) bf16 activation), CUDA events."""
    import torch
    import torch.distributed as dist

    out = {}
    for d in (1280, 5120):
        x = torch.randn(8 * 1024, d, device="cuda").bfloat16()
        ms = cuda_time_ms(lambda: dist.all_reduce(x), iters=20, warmup=5)
        nbytes = x.numel() * x.element_size()
        out[str(d)] = {"bytes": nbytes, "ms": ms,
                       "bus_gbps": 2 * (world - 1) / world * nbytes / ms / 1e6}
    return out


def _seeded_sharded(name, seed, mesh, dtype=None):
    import dataclasses

    import torch
    from esm_tpu_torch.examples.esm2_15b_int8_single_chip import seeded_parts
    from esm_tpu_torch.parallel.sharding import shard_params

    parts = seeded_parts(name, seed, "cuda")
    model = shard_params(parts, mesh, dtype=dtype)
    cfg = dataclasses.replace(model.cfg, compute_dtype=torch.bfloat16, use_flash=True,
                              remat=True, remat_policy="dots")
    return model, cfg


def shard_cards_15b_forward(rank, world):
    """tp=world: the ESM2-15B bf16 forward, seeded, built layer by layer, each
    rank keeping its shard; rank 0 also runs the one-card bf16 forward and a
    streamed fp32 forward of the same weights, and the logits are held by
    [ring]'s rule (check_ring_run): the tp all-reduce sums bf16 partial
    products in another order than one card does, so near-ties split
    between the two bf16 routes more than either splits from fp32."""
    import dataclasses

    import torch
    from esm_tpu_torch.examples.esm2_15b_int8_single_chip import seeded_parts
    from esm_tpu_torch.lora import store_base
    from esm_tpu_torch.models import esm2
    from esm_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from esm_tpu_torch.pretrained import _esm2_alphabet

    mesh = make_mesh(MeshConfig(1, 1, world))
    model, cfg = _seeded_sharded("esm2_t48_15B_UR50D", 37, mesh, dtype=torch.bfloat16)
    cfg = dataclasses.replace(cfg, remat=False)
    b, length = SHARD_15B_FWD
    tokens = torch.from_numpy(bench_tokens(_esm2_alphabet(), b, length, seed=38)).cuda()
    out = {"resident_gb": sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9}
    with torch.no_grad():
        logits = esm2.apply(model, cfg, tokens)["logits"]
        out["forward_s"] = timed_s(lambda: esm2.apply(model, cfg, tokens), iters=2)
    del model
    torch.cuda.empty_cache()
    if rank == 0:
        parts = seeded_parts("esm2_t48_15B_UR50D", 37, "cuda")
        _, whole = next(parts)
        store_base(whole)
        for layer in parts:
            whole.layers.append(store_base(layer))
        with torch.no_grad():
            want = esm2.apply(whole, cfg, tokens)["logits"]
            out["one_card_forward_s"] = timed_s(lambda: esm2.apply(whole, cfg, tokens), iters=2)
        del whole
        torch.cuda.empty_cache()
        f32 = streamed_fp32_logits("esm2_t48_15B_UR50D", 37, tokens)
        agree = lambda a, b: (a.argmax(-1) == b.argmax(-1)).float().mean().item()  # noqa: E731
        out.update(scale=want.abs().max().item(), err=(logits - want).abs().max().item(),
                   agree=agree(logits, want), finite=bool(torch.isfinite(logits).all()),
                   f32_err=(logits.float() - f32).abs().max().item(),
                   f32_agree=agree(logits, f32),
                   one_card_f32_err=(want.float() - f32).abs().max().item(),
                   one_card_f32_agree=agree(want, f32))
        del want, f32
    return out


def shard_cards_15b_step(rank, world):
    """fsdp=world: full-parameter AdamW ESM2-15B steps at B x 1024, one row a
    rank, first moments in bf16, 3 steps; this rank's peak beside the plan,
    and what the train state holds before step 0. With fp32 moments the
    step does not fit four 80 GB cards: 64.77 GB a rank before step 0, and
    rank 0 ran out of memory in step 0's backward at 4 and at 12 rows
    (79.2 GB allocated; plan_train 64.6 and 72.6 GB; NVIDIA H100 80GB HBM3,
    PERF.md §6)."""
    import torch
    from esm_tpu_torch import training
    from esm_tpu_torch.parallel import memory_plan
    from esm_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from esm_tpu_torch.pretrained import _esm2_alphabet

    mesh_cfg = MeshConfig(1, world, 1)
    model, cfg = _seeded_sharded("esm2_t48_15B_UR50D", 39, make_mesh(mesh_cfg))
    b = world
    plan = memory_plan.plan_train(cfg, mesh_cfg, b, 1024, mu_dtype_bytes=2)
    toks = torch.from_numpy(bench_tokens(_esm2_alphabet(), b, 1022, seed=40)).cuda()
    batch = training._corrupt_batch(cfg, torch.Generator(device="cuda").manual_seed(41), toks)
    tx = training.make_optimizer(SHARD_15B_LR, warmup_steps=0, total_steps=1000,
                                 mu_dtype=torch.bfloat16)
    state = training.init_state(model, tx)
    torch.cuda.synchronize()
    log(f"[shard] rank {rank}: ESM2-15B fsdp={world} B={b}: {torch.cuda.memory_allocated() / 1e9:.2f}"
        f" GB allocated before step 0 (plan_train: parameters {plan['params_bytes'] / 1e9:.2f}, "
        f"AdamW state {plan['optimizer_bytes'] / 1e9:.2f}, gradients "
        f"{plan['grads_bytes'] / 1e9:.2f}, activations {plan['activations_bytes'] / 1e9:.2f} GB)")
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        state, m = training.train_step_corrupted(state, cfg, tx, batch[0], toks, batch[1])
        losses.append(m["loss"].item())
        secs.append(time.perf_counter() - t0)
    no_fsdp = memory_plan.plan_train(cfg, mesh_cfg, b, 1024, mu_dtype_bytes=2,
                                          port_terms=False)
    return {"batch": b, "losses": losses, "step_s": secs,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "plan_gb": plan["per_device_bytes"] / 1e9, "verdict": plan["verdict"],
            "fsdp_gb": plan["fsdp_bytes"] / 1e9,
            "plan_without_fsdp_gb": no_fsdp["per_device_bytes"] / 1e9}


def _compare_to_one_card(model, metrics, loss1, g1):
    """Rank 0's check of a sharded step 0 against the one-card one by PR 14's
    rule: every rank gathers the whole gradients, rank 0 compares."""
    from esm_tpu_torch.parallel.sharding import whole_state

    grads = whole_state(model, {n: p.grad for n, p in model.named_parameters()})
    if g1 is None:
        return {}
    grads = {k: v for k, v in grads.items() if k in g1}
    cos, name, ratio = grad_agreement(grads, g1, names=lambda n: n.endswith("weight"))
    return {"loss": metrics["loss"].item(), "one_card_loss": loss1, "cos": cos,
            "cos_name": name, "ratio": ratio}


def shard_cards_3b(rank, world):
    """(fsdp, tp) = (2, world / 2): ESM2-3B step 0 against a one-card step."""
    import torch
    from esm_tpu_torch import training
    from esm_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from esm_tpu_torch.parallel.sharding import shard_params

    model, cfg, alphabet = shard_model("cuda", "esm2_t36_3B_UR50D", 42)
    toks = torch.from_numpy(bench_tokens(alphabet, 4, 1022, seed=43)).cuda()
    c, m = training._corrupt_batch(cfg, torch.Generator(device="cuda").manual_seed(44), toks)
    loss1, g1 = grads_of(model, cfg, (c, toks, m)) if rank == 0 else (None, None)
    shard_params(model, make_mesh(MeshConfig(1, 2, world // 2)))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    metrics = training.sharded_loss_and_grads(model, cfg, c, toks, m)
    out = _compare_to_one_card(model, metrics, loss1, g1)
    out["step0_s"] = time.perf_counter() - t0
    return out


def shard_cards_pp(rank, world):
    """pp=world: ESM2-650M train_step_pp at M=SHARD_PP_CARDS_M, step 0 against
    a one-card step."""
    import torch
    from esm_tpu_torch import training
    from esm_tpu_torch.parallel.pipeline import make_pp_mesh
    from esm_tpu_torch.parallel.sharding import shard_params

    # ESM2-650M's 33 layers do not split over 4 stages: its depth is cut to
    # the largest multiple of the stage count (32 on 4)
    n = 33 - 33 % world
    model, cfg, alphabet = shard_model("cuda", seed=45, num_layers=n)
    toks = torch.from_numpy(bench_tokens(alphabet, 8, 1022, seed=46)).cuda()
    c, m = training._corrupt_batch(cfg, torch.Generator(device="cuda").manual_seed(47), toks)
    loss1, g1 = grads_of(model, cfg, (c, toks, m)) if rank == 0 else (None, None)
    shard_params(model, make_pp_mesh(world))
    torch.cuda.empty_cache()
    zero_counts()
    t0 = time.perf_counter()
    metrics = training.pp_loss_and_grads(model, cfg, c, toks, m,
                                         num_microbatches=SHARD_PP_CARDS_M)
    torch.cuda.synchronize()
    out = {"step0_s": time.perf_counter() - t0, "counts": read_counts(), "layers": n}
    if rank == 0:  # stage 0's layers and the replicated parameters
        grads = {k: p.grad for k, p in model.named_parameters() if k in g1}
        cos, name, ratio = grad_agreement(grads, {k: g1[k] for k in grads},
                                          names=lambda n_: n_.endswith("weight"))
        out.update(loss=metrics["loss"].item(), one_card_loss=loss1, cos=cos, cos_name=name,
                   ratio=ratio)
    return out


def _lora_adapters(base, seed, nonzero_b=True):
    """Seeded rank-LORA_RANK adapters over ``base`` (the same on every card:
    a CUDA generator's draws do not depend on the card); b seeded noise, so
    that every factor has a gradient."""
    import torch
    from esm_tpu_torch import lora

    adapters = lora.init_lora(torch.Generator(device="cuda").manual_seed(seed), base,
                              rank=LORA_RANK)
    if nonzero_b:
        with torch.no_grad():
            gen = torch.Generator(device="cuda").manual_seed(seed + 1)
            for _, a in adapters.adapters():
                a.lora_b.normal_(0.0, 0.02, generator=gen)
    return adapters


def shard_cards_3b_lora(rank, world):
    """(fsdp, tp) = (2, world / 2): ESM2-3B LoRA (rank 16, bf16 base, the
    LoRA recipe) step 0 against rank 0's one-card LoRA step."""
    import torch
    from esm_tpu_torch import lora, training
    from esm_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from esm_tpu_torch.parallel.sharding import shard_params

    model, cfg, alphabet = shard_model("cuda", "esm2_t36_3B_UR50D", 60)
    lora.store_base(model)
    toks = torch.from_numpy(bench_tokens(alphabet, 4, 1022, seed=61)).cuda()
    batch = training._corrupt_batch(cfg, torch.Generator(device="cuda").manual_seed(62), toks)
    batch = (batch[0], toks, batch[1])
    adapters = _lora_adapters(model, 63)
    loss1, g1 = adapter_grads(model, adapters, cfg, batch) if rank == 0 else (None, None)
    shard_params(model, make_mesh(MeshConfig(1, 2, world // 2)))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with training.frozen_and_patched(model, adapters, 1.0):
        metrics = training.sharded_loss_and_grads(model, cfg, *batch, adapters=adapters)
    out = {"step0_s": time.perf_counter() - t0}
    if rank == 0:
        grads = {n: p.grad for n, p in adapters.named_parameters()}
        cos, name, ratio = grad_agreement(grads, g1)
        out.update(loss=metrics["loss"].item(), one_card_loss=loss1, cos=cos, cos_name=name,
                   ratio=ratio)
    return out


def shard_cards_3b_adafactor(rank, world):
    """(fsdp, tp) = (2, world / 2): one ESM2-3B adafactor update (no weight
    decay, lr SHARD_UPDATE_LR) on the shards against the one-card update on
    the same gradients (every rank computes the one-card step, each then
    cuts its shards of its gradients), by the parameter deltas. Fed each
    side's own gradients, the first update divides them by their row and
    column RMS, which amplifies the bf16 sums' differences in small rows:
    the deltas' cosine read 0.9919 where the gradients' read 0.9998."""
    import torch
    from esm_tpu_torch import training
    from esm_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from esm_tpu_torch.parallel.sharding import shard_params, whole_state

    tx = training.make_optimizer(SHARD_UPDATE_LR, weight_decay=0.0, warmup_steps=0,
                                 total_steps=1000, factored=True)
    model, cfg, alphabet = shard_model("cuda", "esm2_t36_3B_UR50D", 64)
    toks = torch.from_numpy(bench_tokens(alphabet, 4, 1022, seed=65)).cuda()
    c, m = training._corrupt_batch(cfg, torch.Generator(device="cuda").manual_seed(66), toks)
    state = training.init_state(model, tx)
    loss, _ = training.mlm_loss(model, cfg, c, toks, m)
    loss.backward()
    grads = training._grads(dict(model.named_parameters()))  # zeros where none
    one = None
    if rank == 0:
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        tx.update(model, state.opt_state)
        one = {n: p.detach() - before[n] for n, p in model.named_parameters()}
        del before
    model.zero_grad(set_to_none=True)
    del model, state, loss
    torch.cuda.empty_cache()
    model, _, _ = shard_model("cuda", "esm2_t36_3B_UR50D", 64)
    shard_params(model, make_mesh(MeshConfig(1, 2, world // 2)))
    shard = model.__dict__["_sharding"]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = training.init_state(model, tx)
    for n, p in model.named_parameters():
        p.grad = shard.cut(n, grads[n])
    del grads
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tx.update(model, state.opt_state)
    torch.cuda.synchronize()
    out = {"update_s": time.perf_counter() - t0}
    deltas = whole_state(model, {n: p.detach() - before[n] for n, p in model.named_parameters()})
    if rank == 0:  # the contact head takes no gradient from the loss: its delta is 0
        cos, name, ratio = grad_agreement(deltas, one,
                                          names=lambda n_: not n_.startswith("contact_head"))
        out.update(cos=cos, cos_name=name, ratio=ratio)
    return out


def shard_cards_15b_lora(rank, world):
    """tp=world: ESM2-15B LoRA (rank 16) on a bf16 base, built layer by layer
    and cut to bf16 shards, SHARD_LORA_STEPS steps at SHARD_15B_LORA_B x 1024;
    this rank's peak beside plan_train_lora."""
    import torch
    from esm_tpu_torch import training
    from esm_tpu_torch.parallel import memory_plan
    from esm_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from esm_tpu_torch.pretrained import _esm2_alphabet

    mesh_cfg = MeshConfig(1, 1, world)
    model, cfg = _seeded_sharded("esm2_t48_15B_UR50D", 67, make_mesh(mesh_cfg),
                                 dtype=torch.bfloat16)
    b = SHARD_15B_LORA_B
    toks = torch.from_numpy(bench_tokens(_esm2_alphabet(), b, 1022, seed=68)).cuda()
    c, m = training._corrupt_batch(cfg, torch.Generator(device="cuda").manual_seed(69), toks)
    adapters = _lora_adapters(model, 70, nonzero_b=False)
    tx = training.make_optimizer(SHARD_15B_LORA_LR, warmup_steps=0, total_steps=1000)
    state = training.init_state(adapters, tx)
    plan = memory_plan.plan_train_lora(cfg, mesh_cfg, b, 1024, rank=LORA_RANK)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    for _ in range(SHARD_LORA_STEPS):
        t0 = time.perf_counter()
        state, metrics = training.train_step_lora_corrupted(state, model, cfg, tx, c, toks, m)
        losses.append(metrics["loss"].item())
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    return {"batch": b, "losses": losses, "step_s": secs, "peak_gb": peak / 1e9,
            "plan_gb": plan["per_device_bytes"] / 1e9, "verdict": plan["verdict"],
            "units": fitted_lora_units(cfg, peak, plan, b, 1024)}


def shard_cards_pp_checkpoint(rank, world, out_dir):
    """pp=world: ESM2-650M (its depth cut to a multiple of the stages) after
    one train_step_pp (AdamW), its train state saved (each stage's layers
    gathered over pp), then on rank 0 reloaded on one card: equal to the
    gathered tensors bit for bit; rank 0's host RSS growth during the save."""
    import torch
    import torch.distributed as dist
    from esm_tpu_torch import training
    from esm_tpu_torch.io import checkpoint
    from esm_tpu_torch.models import esm2
    from esm_tpu_torch.parallel.pipeline import make_pp_mesh
    from esm_tpu_torch.parallel.sharding import shard_params, whole_state

    n = 33 - 33 % world
    model, cfg, alphabet = shard_model("cuda", seed=71, num_layers=n)
    shard_params(model, make_pp_mesh(world))
    toks = torch.from_numpy(bench_tokens(alphabet, 8, 1022, seed=72)).cuda()
    tx = training.make_optimizer(TRAIN_LR, warmup_steps=0, total_steps=1000)
    state = training.init_state(model, tx)
    state, _ = training.train_step_pp(state, cfg, tx, torch.Generator(device="cuda").manual_seed(73),
                                      toks, num_microbatches=SHARD_PP_CARDS_M)
    path = os.path.join(out_dir, "pp_state")
    growth, seconds = save_host_growth(lambda: checkpoint.save_train_state(path, state))
    gathered = {"params": whole_state(model)}
    gathered.update({k: whole_state(model, d) for k, d in training.tensor_fields(
        state.opt_state).items()})
    out = {"layers": n, "save_s": seconds, "host_growth": growth}
    if rank == 0:
        one = esm2.ESM2(cfg, device="cuda")
        fresh = checkpoint.load_train_state(path, training.init_state(one, tx))
        got = {"params": one.state_dict(), **training.tensor_fields(fresh.opt_state)}
        out["equal"] = (fresh.step == 1 and fresh.opt_state.count == 1 and all(
            got[k].keys() == gathered[k].keys()
            and all(torch.equal(got[k][x], gathered[k][x]) for x in gathered[k])
            for k in gathered))
        sizes = [t.numel() * t.element_size() for d in gathered.values() for t in d.values()]
        out.update(largest=max(sizes), tree=sum(sizes))
    dist.barrier()
    return out


SHARD_CARDS_FAMILY_B = 8         # four cards: rows of the ESM-1 family's tp forwards


def shard_cards_families_forward(rank, world):
    """tp=world: ESM-1b and ESM-1 t34 bf16 flash forwards at B x 1024 and
    MSA-1b's on [msa]'s MSA, seeded, each rank keeping its shard; rank 0
    also runs the one-card bf16 and an fp32 forward of the same weights, and
    the logits are held by [shard]'s rule for bf16 forwards (the 15B tp
    forward's)."""
    import dataclasses

    import torch
    from esm_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from esm_tpu_torch.parallel.sharding import batch_rows, shard_params

    mesh = make_mesh(MeshConfig(1, 1, world))
    agree = lambda a, b: (a.argmax(-1) == b.argmax(-1)).float().mean().item()  # noqa: E731
    out = {}
    for path, name, seed in (("esm1b", "esm1b_t33_650M_UR50S", 100),
                             ("esm1", "esm1_t34_670M_UR50S", 102),
                             ("msa", "esm_msa1b_t12_100M_UR50S", 104)):
        msa = path == "msa"
        model, cfg, alphabet, apply = family_model(name, seed, **({} if msa else
                                                                  {"use_flash": True}))
        if msa:
            tokens = alphabet.get_batch_converter()([seeded_msa(*SHARD_MSA, seed=seed + 1)])[2]
        else:
            tokens = torch.from_numpy(bench_tokens(alphabet, SHARD_CARDS_FAMILY_B, 1022,
                                                   seed=seed + 1))
        tokens = tokens.cuda()
        r = {}
        with torch.no_grad():
            if rank == 0:
                want = apply(model, cfg, tokens)["logits"]
                r["one_card_s"] = timed_s(lambda: apply(model, cfg, tokens), iters=2)
                f32_cfg = dataclasses.replace(cfg, compute_dtype=torch.float32,
                                              **({} if msa else {"use_flash": False}))
                f32 = apply(model, f32_cfg, tokens)["logits"]
            shard_params(model, mesh)
            zero_counts()
            logits = apply(model, cfg, batch_rows(tokens, mesh))["logits"]
            torch.cuda.synchronize()
            r["counts"] = read_counts()
            r["s"] = timed_s(lambda: apply(model, cfg, tokens), iters=2)
        r["n"] = cfg.num_layers
        if rank == 0:
            r.update(scale=want.abs().max().item(), err=(logits - want).abs().max().item(),
                     agree=agree(logits, want), finite=bool(torch.isfinite(logits).all()),
                     f32_err=(logits.float() - f32).abs().max().item(),
                     f32_agree=agree(logits, f32),
                     one_card_f32_err=(want.float() - f32).abs().max().item(),
                     one_card_f32_agree=agree(want, f32))
            del want, f32
        out[path] = r
        del model, logits
        torch.cuda.empty_cache()
    return out


def shard_cards_msa_step(rank, world):
    """(fsdp, tp) = (2, world / 2): MSA-1b's train_step_msa on two MSAs of
    64 x 257 (one a (data, fsdp) row), SHARD_FAMILY_STEPS steps at
    SHARD_MSA_LR on one corruption; this rank's peak."""
    import torch
    from esm_tpu_torch import training
    from esm_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from esm_tpu_torch.parallel.sharding import shard_params

    model, cfg, alphabet, _ = family_model("esm_msa1b_t12_100M_UR50S", 106)
    shard_params(model, make_mesh(MeshConfig(1, 2, world // 2)))
    tokens = torch.cat([msa_tokens(alphabet, 64, 256, seed=107),
                        msa_tokens(alphabet, 64, 256, seed=108)]).cuda()
    tx = training.make_optimizer(SHARD_MSA_LR, warmup_steps=0, total_steps=1000)
    state = training.init_state(model, tx)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    for _ in range(SHARD_FAMILY_STEPS):
        t0 = time.perf_counter()
        state, m = training.train_step_msa(state, cfg, tx,
                                           torch.Generator(device="cuda").manual_seed(109), tokens)
        losses.append(m["loss"].item())
        secs.append(time.perf_counter() - t0)
    return {"losses": losses, "step_s": secs, "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def shard_cards_esm1b_lora(rank, world):
    """tp=world: ESM-1b LoRA (rank 16, bf16 base stored after the cut, flash),
    SHARD_FAMILY_STEPS steps at LORA_LR on B=4 x 1024."""
    import torch
    from esm_tpu_torch import lora, training
    from esm_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from esm_tpu_torch.parallel.sharding import shard_params

    model, cfg, alphabet, apply = family_model("esm1b_t33_650M_UR50S", 110, use_flash=True)
    lora.store_base(shard_params(model, make_mesh(MeshConfig(1, 1, world))))
    toks = torch.from_numpy(bench_tokens(alphabet, 4, 1022, seed=111)).cuda()
    c, m = training._corrupt_batch(cfg, torch.Generator(device="cuda").manual_seed(112), toks)
    adapters = _lora_adapters(model, 113, nonzero_b=False)
    tx = training.make_optimizer(LORA_LR, warmup_steps=0, total_steps=1000)
    state = training.init_state(adapters, tx)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    losses, secs = [], []
    for _ in range(SHARD_FAMILY_STEPS):
        t0 = time.perf_counter()
        state, metrics = training.train_step_lora_corrupted(state, model, cfg, tx, c, toks, m,
                                                            apply_fn=apply)
        losses.append(metrics["loss"].item())
        secs.append(time.perf_counter() - t0)
    return {"losses": losses, "step_s": secs, "counts": read_counts(), "n": cfg.num_layers,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def shard_cards_pp_lora(rank, world, out_dir):
    """pp=world: LoRA (rank 16, bf16 base) over ESM2-650M, its depth cut to a
    multiple of the stages, through the GPipe schedule at
    M=SHARD_PP_CARDS_M: step 0 against rank 0's one-card LoRA step (the
    stages' adapter gradients gathered over pp), SHARD_FAMILY_STEPS steps at
    LORA_LR, the adapters' train state saved and, on rank 0, reloaded on one
    card: equal to the gathered tensors bit for bit."""
    import torch
    import torch.distributed as dist
    from esm_tpu_torch import lora, training
    from esm_tpu_torch.io import checkpoint
    from esm_tpu_torch.parallel.pipeline import make_pp_mesh
    from esm_tpu_torch.parallel.sharding import shard_params, whole_state

    n = 33 - 33 % world
    model, cfg, alphabet = shard_model("cuda", seed=114, num_layers=n)
    lora.store_base(model)
    toks = torch.from_numpy(bench_tokens(alphabet, 8, 1022, seed=115)).cuda()
    c, m = training._corrupt_batch(cfg, torch.Generator(device="cuda").manual_seed(116), toks)
    batch = (c, toks, m)
    adapters = _lora_adapters(model, 117)
    loss1, g1 = adapter_grads(model, adapters, cfg, batch) if rank == 0 else (None, None)
    shard_params(model, make_pp_mesh(world))
    stage = lora.on_stage(adapters, model)
    del adapters
    torch.cuda.empty_cache()
    zero_counts()
    t0 = time.perf_counter()
    with training.frozen_and_patched(model, stage, 1.0):
        metrics = training.pp_loss_and_grads(model, cfg, *batch,
                                             num_microbatches=SHARD_PP_CARDS_M, adapters=stage)
    torch.cuda.synchronize()
    out = {"step0_s": time.perf_counter() - t0, "counts": read_counts(), "layers": n}
    grads = whole_state(stage, {k: p.grad for k, p in stage.named_parameters()})
    stage.zero_grad(set_to_none=True)
    if rank == 0:
        cos, name, ratio = grad_agreement(grads, g1)
        out.update(loss=metrics["loss"].item(), one_card_loss=loss1, cos=cos, cos_name=name,
                   ratio=ratio)
    del grads, g1
    tx = training.make_optimizer(LORA_LR, warmup_steps=0, total_steps=1000)
    state = training.init_state(stage, tx)
    losses = []
    for _ in range(SHARD_FAMILY_STEPS):
        state, metrics = training.train_step_lora_corrupted(
            state, model, cfg, tx, *batch, num_microbatches=SHARD_PP_CARDS_M)
        losses.append(metrics["loss"].item())
    out["losses"] = losses
    path = os.path.join(out_dir, "pp_lora_state")
    checkpoint.save_train_state(path, state)
    gathered = {"params": whole_state(stage), "mu": whole_state(stage, state.opt_state.mu),
                "nu": whole_state(stage, state.opt_state.nu)}
    if rank == 0:
        paths = dict.fromkeys(k.rpartition(".")[0] for k in gathered["params"])
        one = lora.LoRA({p: (torch.empty_like(gathered["params"][f"{p}.lora_a"]),
                             torch.empty_like(gathered["params"][f"{p}.lora_b"])) for p in paths})
        fresh = checkpoint.load_train_state(path, training.init_state(one, tx))
        got = {"params": one.state_dict(), "mu": fresh.opt_state.mu, "nu": fresh.opt_state.nu}
        out["equal"] = (fresh.step == SHARD_FAMILY_STEPS and all(
            got[k].keys() == gathered[k].keys()
            and all(torch.equal(got[k][x], gathered[k][x]) for x in gathered[k])
            for k in gathered))
    dist.barrier()
    return out


def check_shard_cards_families(world, res, rank):
    """Logs and checks a rank's four-card family parts; returns the failures."""
    failed = []
    for path, r in res["shard_cards_families_forward"].items():
        log(f"[shard] {world} cards, rank {rank}: {path} tp={world} bf16 forward: "
            f"{r['s'] * 1e3:.1f} ms; launches {r['counts']}"
            + (f" (one card {r['one_card_s'] * 1e3:.1f} ms; logits max abs err {r['err']:.4f} of "
               f"max |logit| {r['scale']:.2f}, argmax agreement {r['agree']:.5f}; vs an fp32 "
               f"forward: tp {r['f32_err']:.4f} / agreement {r['f32_agree']:.5f}, one card "
               f"{r['one_card_f32_err']:.4f} / {r['one_card_f32_agree']:.5f})" if rank == 0
               else ""))
        want = flash_counts(r["n"], fwd=0 if path == "msa" else 1)
        if r["counts"] != want:
            failed.append(f"rank {rank}: {path} tp launches {r['counts']} != {want}")
        if rank == 0 and not (r["finite"] and r["err"] <= 0.05 * r["scale"]
                              and r["f32_err"] <= 1.5 * r["one_card_f32_err"]
                              and r["f32_agree"] >= r["one_card_f32_agree"] - 0.02):
            failed.append(f"{path} tp forward off the one-card and fp32 forwards")
    for key, label in (("shard_cards_msa_step", f"MSA-1b train_step_msa (fsdp, tp) = (2, "
                        f"{world // 2})"), ("shard_cards_esm1b_lora",
                                            f"ESM-1b LoRA rank {LORA_RANK} tp={world}")):
        r = res[key]
        log(f"[shard] {world} cards, rank {rank}: {label}: losses "
            + ", ".join(f"{x:.5f}" for x in r["losses"]) + "; s a step "
            + ", ".join(f"{x:.2f}" for x in r["step_s"]) + f"; peak {r['peak_gb']:.2f} GB"
            + (f"; launches {r['counts']}" if "counts" in r else ""))
        if not (np.isfinite(r["losses"]).all() and r["losses"][-1] < r["losses"][0]):
            failed.append(f"rank {rank}: {label} losses {r['losses']}")
    r = res["shard_cards_esm1b_lora"]
    want = flash_counts(r["n"], lse=SHARD_FAMILY_STEPS, bwd=SHARD_FAMILY_STEPS)
    if r["counts"] != want:
        failed.append(f"rank {rank}: ESM-1b LoRA launches {r['counts']} != {want}")
    r = res["shard_cards_pp_lora"]
    log(f"[shard] {world} cards, rank {rank}: ESM2-650M ({r['layers']} layers) LoRA pp={world} "
        f"M={SHARD_PP_CARDS_M}: step 0 {r['step0_s']:.2f} s, launches {r['counts']}; losses "
        + ", ".join(f"{x:.5f}" for x in r["losses"])
        + (f"; step 0 loss {r['loss']:.6f} vs one card {r['one_card_loss']:.6f}, adapter "
           f"gradients lowest cosine {r['cos']:.6f} ({r['cos_name']}), norm ratio "
           f"{r['ratio']:.6f}; the adapter state reloaded on one card equal to the gathered "
           f"tensors bit for bit: {r['equal']}" if rank == 0 else ""))
    want = flash_counts(r["layers"] // world, lse=2 * SHARD_PP_CARDS_M, bwd=SHARD_PP_CARDS_M)
    if r["counts"] != want:
        failed.append(f"rank {rank}: pipelined LoRA stage launches {r['counts']} != {want}")
    if not (np.isfinite(r["losses"]).all() and r["losses"][-1] < r["losses"][0]):
        failed.append(f"rank {rank}: pipelined LoRA losses {r['losses']}")
    if rank == 0 and not (r["equal"] and abs(r["loss"] - r["one_card_loss"])
                          <= SHARD_PP_LOSS_TOL * abs(r["one_card_loss"])
                          and r["cos"] > 0.999 and abs(r["ratio"] - 1) <= 0.01):
        failed.append("the pipelined LoRA step 0 or its reload is off the one-card step")
    return failed


def shard_several_cards(n_cards):
    """One NCCL rank per card (the largest power of two not above the count)."""
    import torch.multiprocessing as mp

    world = 1 << (n_cards.bit_length() - 1)
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.start_processes(shard_rank, args=(world, free_port(), out_dir), nprocs=world,
                                 join=False, start_method="spawn")
        deadline = time.monotonic() + SHARD_TIMEOUT
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise AssertionError(f"[shard] the {world} ranks did not end in {SHARD_TIMEOUT} s")
        results = []
        for rank in range(world):
            with open(os.path.join(out_dir, f"rank{rank}.json")) as f:
                results.append(json.load(f))
    failed = []
    for rank, res in enumerate(results):
        ar, fwd, step = (res["shard_cards_allreduce"], res["shard_cards_15b_forward"],
                         res["shard_cards_15b_step"])
        log(f"[shard] {world} cards, rank {rank}: NCCL all-reduce "
            + ", ".join(f"{v['bytes'] / 1e6:.1f} MB {v['ms']:.4f} ms ({v['bus_gbps']:.1f} GB/s bus)"
                        for v in ar.values())
            + f"; ESM2-15B tp={world} bf16 forward B={SHARD_15B_FWD[0]} x "
            f"{SHARD_15B_FWD[1] + 2}: {fwd['forward_s'] * 1e3:.1f} ms, {fwd['resident_gb']:.2f} GB "
            f"of parameters on the rank"
            + (f" (one card {fwd['one_card_forward_s'] * 1e3:.1f} ms; logits max abs err "
               f"{fwd['err']:.4f} of max |logit| {fwd['scale']:.2f}, argmax agreement "
               f"{fwd['agree']:.5f}; vs a streamed fp32 forward: tp {fwd['f32_err']:.4f} / "
               f"agreement {fwd['f32_agree']:.5f}, one card {fwd['one_card_f32_err']:.4f} / "
               f"{fwd['one_card_f32_agree']:.5f})" if rank == 0 else ""))
        log(f"[shard] {world} cards, rank {rank}: ESM2-15B fsdp={world} AdamW (bf16 first "
            f"moments) steps at B={step['batch']} x 1024: losses " + ", ".join(f"{x:.5f}" for x in step["losses"])
            + "; s a step " + ", ".join(f"{s:.2f}" for s in step["step_s"])
            + f"; peak {step['peak_gb']:.2f} GB, plan_train {step['plan_gb']:.2f} GB "
            f"({step['verdict']}; {step['fsdp_gb']:.2f} GB of it the fsdp gather's transients, "
            f"{step['plan_without_fsdp_gb']:.2f} GB without that term)")
        if not (np.isfinite(step["losses"]).all() and step["losses"][-1] < step["losses"][0]):
            failed.append(f"rank {rank}: 15B losses {step['losses']}")
        if rank == 0:
            if not (fwd["finite"] and fwd["err"] <= 0.05 * fwd["scale"]
                    and fwd["f32_err"] <= 1.5 * fwd["one_card_f32_err"]
                    and fwd["f32_agree"] >= fwd["one_card_f32_agree"] - 0.02):
                failed.append("15B tp forward off the one-card and fp32 forwards")
            for key, label in (("shard_cards_3b", "ESM2-3B (fsdp, tp) = (2, "
                                f"{world // 2}) step 0"),
                               ("shard_cards_pp", f"ESM2-650M pp={world} M={SHARD_PP_CARDS_M} "
                                "step 0"),
                               ("shard_cards_3b_lora", f"ESM2-3B LoRA rank {LORA_RANK} (fsdp, "
                                f"tp) = (2, {world // 2}) step 0 (adapter gradients)")):
                r = res[key]
                log(f"[shard] {world} cards: {label}: loss {r['loss']:.6f} vs one card "
                    f"{r['one_card_loss']:.6f}; lowest cosine {r['cos']:.6f} "
                    f"({r['cos_name']}), norm ratio {r['ratio']:.6f}; "
                    f"{r['step0_s']:.2f} s")
                if not (abs(r["loss"] - r["one_card_loss"]) <= SHARD_PP_LOSS_TOL
                        * abs(r["one_card_loss"]) and r["cos"] > 0.999
                        and abs(r["ratio"] - 1) <= 0.01):
                    failed.append(f"{label} off the one-card step")
        if rank == 0:
            r = res["shard_cards_3b_adafactor"]
            log(f"[shard] {world} cards: ESM2-3B adafactor (fsdp, tp) = (2, {world // 2}) update "
                f"on the one-card gradients (parameter deltas against the one-card update): "
                f"lowest cosine {r['cos']:.6f} ({r['cos_name']}), norm ratio {r['ratio']:.6f}; "
                f"{r['update_s'] * 1e3:.1f} ms")
            if not (r["cos"] > 0.999 and abs(r["ratio"] - 1) <= 0.01):
                failed.append("the ESM2-3B adafactor update is off the one-card update")
        lo = res["shard_cards_15b_lora"]
        log(f"[shard] {world} cards, rank {rank}: ESM2-15B LoRA rank {LORA_RANK} on a bf16 base, "
            f"tp={world}, B={lo['batch']} x 1024, lr {SHARD_15B_LORA_LR}: losses "
            + ", ".join(f"{x:.5f}" for x in lo["losses"]) + "; s a step "
            + ", ".join(f"{x:.2f}" for x in lo["step_s"])
            + f"; peak {lo['peak_gb']:.2f} GB, plan_train_lora {lo['plan_gb']:.2f} GB "
            f"({lo['verdict']}; activation units that fit {lo['units']:.2f})")
        if not (np.isfinite(lo["losses"]).all() and lo["losses"][-1] < lo["losses"][0]):
            failed.append(f"rank {rank}: 15B LoRA losses {lo['losses']}")
        ck = res["shard_cards_pp_checkpoint"]
        log(f"[shard] {world} cards, rank {rank}: ESM2-650M ({ck['layers']} layers) pp={world} "
            f"train state saved in {ck['save_s']:.1f} s, host RSS growth "
            f"{ck['host_growth'] / 1e6:.1f} MB"
            + (f" (largest entry {ck['largest'] / 1e6:.1f} MB, whole tree {ck['tree'] / 1e9:.3f} "
               f"GB); reloaded on one card equal to the gathered tensors bit for bit: "
               f"{ck['equal']}" if rank == 0 else ""))
        if rank == 0 and not ck["equal"]:
            failed.append("the pp train state reloaded on one card is not the gathered one")
        pp = res["shard_cards_pp"]
        want = flash_counts(pp["layers"] // world, lse=2 * SHARD_PP_CARDS_M, bwd=SHARD_PP_CARDS_M)
        if pp["counts"] != want:
            failed.append(f"rank {rank}: pipeline stage launches {pp['counts']} != {want}")
        failed += check_shard_cards_families(world, res, rank)
    if failed:
        raise AssertionError("[shard] " + "; ".join(failed))
    return world


def shard_counts(res):
    """K1's, K1-with-the-lse's and K2's launches on [shard]'s one-card main
    path, summed over its windows (forward, step 0, the steps, the pipeline's
    forward and step, the 3B step, the LoRA steps on both bases, the
    adafactor steps, the ESM-1b LoRA steps, the pipelined LoRA steps); the
    ESM-1 family's forwards are counted at their own shapes
    (:func:`shard_family_entries`)."""
    windows = [res[w] for w in ("forward_counts", "step_counts", "train_counts",
                                "pp_forward_counts", "pp_step_counts", "3b_counts")]
    train = res["train"]
    windows += [r[w] for r in train["lora"].values() for w in ("step_counts", "steps_counts")]
    windows.append(train["adafactor"]["counts"])
    families = res["families"]
    windows += [r["counts"] for r in families["lora"].values()]
    windows += [families["pp_lora"]["counts"], families["pp_lora"]["steps_counts"]]
    total = {k: sum(w[k] for w in windows) for k in res["forward_counts"]}
    log(f"[shard] launches on the one-card main path: {total}")
    return total


def shard_entries(k1, backward, total):
    """The kernels line's entries of [shard]'s path: K1, K1 with the lse and
    K2 with this path's launches, and the times measured at [main]'s and
    [train]'s shapes (the shapes [shard] runs them at)."""
    by_name = {e["name"]: e for e in [k1] + backward}
    return [dict(by_name["flash_attention"], name="flash_attention/shard",
                 launches=total["flash_attention"]),
            dict(by_name["flash_attention_with_lse"], name="flash_attention_with_lse/shard",
                 launches=total["flash_attention_with_lse"]),
            dict(by_name["flash_attention_bwd"], name="flash_attention_bwd/shard",
                 launches=total["flash_attention_bwd.dq"])]


def shard_family_entries(k1_esm1, res):
    """The kernels line's entries of K1 at the ESM-1 family's shapes on
    [shard]'s path: [k1-esm1b]'s and [k1-esm1]'s times (the shapes the
    one-rank sharded forwards run), with those forwards' launches."""
    forward = res["families"]["forward"]
    return [dict(e, name=f"{e['name']}/shard",
                 launches=forward[e["name"].split("/")[1]]["counts"]["flash_attention"])
            for e in k1_esm1]


def phase_pp_profile(card):
    """Where the pipelined steps' time goes (run alone: --only pp-profile):
    ESM2-650M at B=SHARD_TRAIN_B x 1024 on a one-rank NCCL group, the
    full-parameter step (fp32 weights, remat "dots") and the rank-16 LoRA
    step (bf16 base), each on the (1, 1, 1) mesh and through the GPipe
    schedule at pp=1, M=SHARD_M: one warm-up call, then one profiled call
    (wall, device busy, device events, the top kernels)."""
    import torch
    import torch.distributed as dist
    from esm_tpu_torch import lora, training
    from esm_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from esm_tpu_torch.parallel.pipeline import make_pp_mesh
    from esm_tpu_torch.parallel.sharding import shard_params

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", world_size=1,
                            rank=0)
    try:
        model, cfg, alphabet = shard_model("cuda", seed=93)
        toks = torch.from_numpy(bench_tokens(alphabet, SHARD_TRAIN_B, 1022, seed=94)).cuda()
        corrupted, target_mask = training._corrupt_batch(
            cfg, torch.Generator(device="cuda").manual_seed(95), toks)
        batch = (corrupted, toks, target_mask)
        meshes = (("one card", make_mesh(MeshConfig(1, 1, 1))), (f"pp=1, M={SHARD_M}",
                                                                  make_pp_mesh(1)))
        rows = []

        def step(adapters, pp):
            (model if adapters is None else adapters).zero_grad(set_to_none=True)
            if pp:
                training.pp_loss_and_grads(model, cfg, *batch, num_microbatches=SHARD_M,
                                           adapters=adapters)
            else:
                training.sharded_loss_and_grads(model, cfg, *batch, adapters=adapters)

        for label, mesh in meshes:
            shard_params(model, mesh)
            step(None, "pp" in label)
            rows.append((f"full-parameter step, {label}",
                         profile(f"full-parameter step, {label}", lambda: step(None, "pp" in label))))
        model.zero_grad(set_to_none=True)
        lora.store_base(model)
        adapters = _lora_adapters(model, 96)
        for label, mesh in meshes:
            shard_params(model, mesh)
            with training.frozen_and_patched(model, adapters, 1.0):
                step(adapters, "pp" in label)
                rows.append((f"LoRA step, {label}", profile(
                    f"LoRA rank {LORA_RANK} step, {label}", lambda: step(adapters, "pp" in label))))
    finally:
        dist.destroy_process_group()
    for label, (wall, busy, events) in rows:
        log(f"[pp-profile] ESM2-650M B={SHARD_TRAIN_B} x 1024, {label}: wall {wall:.1f} ms, "
            f"device busy {busy:.1f} ms ({100 * busy / wall:.1f}%), {events} device events, "
            f"{1e3 * (wall - busy) / events:.1f} us of idle wall a device event ({card})")


def phase_shard(card):
    """Parameter sharding and the pipeline: on a one-rank NCCL group of this
    card, ESM2-650M through shard_params (forward and step 0 bit for bit
    against the unsharded model, the launch counts, 3 steps), the pipeline
    at pp=1, an ESM2-3B step, the plans against the peaks, the GEMM rate;
    the ESM-1 family and the MSA Transformer sharded (forwards, MSA-1b's
    step, ESM-1b LoRA) and ESM2-650M's LoRA through the pipeline;
    cli.pretrain and the sharded example under torchrun; with two or more
    cards, tp/fsdp/pp over one rank per card."""
    import torch
    import torch.distributed as dist
    from esm_tpu_torch.parallel.mesh import MeshConfig

    t_phase = time.perf_counter()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", world_size=1,
                            rank=0)
    try:
        res = shard_one_card(card)
        res["train"] = shard_train_one_card(card, MeshConfig(1, 1, 1))
        t_families = time.perf_counter()
        res["families"] = shard_families_one_card(card, MeshConfig(1, 1, 1))
        log(f"[shard] the families' one-rank parts took {time.perf_counter() - t_families:.1f} s")
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    check_shard_one_card(res)
    check_shard_train(res["train"], res["n_layers"])
    check_shard_families(res["families"])
    if not res["save"]["growth"] < res["save"]["tree"] / 2:
        raise AssertionError(f"[shard] the save's host RSS grew {res['save']['growth']} bytes "
                             f"for a tree of {res['save']['tree']}")
    res["gemm"] = shard_gemm_rate(card)
    shard_entry_points(card)
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        world = shard_several_cards(n_cards)
        log(f"[shard] ran: the one-rank group, the entry points, and {world} ranks over "
            f"{n_cards} cards")
    else:
        log("[shard] ran: the one-rank group and the entry points (one card present: no "
            "several-card part)")
    log(f"[shard] took {time.perf_counter() - t_phase:.1f} s")
    return res


def phase_fasta():
    """The native FASTA loader (esm_tpu_torch.native, built with g++ here):
    a seeded 20,000-record file parsed natively and by the Python loop
    (equal records, both timed), and the bulk tokenizer against the
    BatchConverter."""
    from esm_tpu_torch import native
    from esm_tpu_torch.data import Alphabet, FastaBatchedDataset

    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("[fasta] the native FASTA loader did not build (g++)")
    build_s = time.perf_counter() - t0
    rng = np.random.RandomState(30)
    aas = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "seqs.fasta")
        with open(path, "w") as f:
            for i in range(20_000):
                s = bytes(aas[rng.randint(0, 20, int(rng.randint(30, 1000)))]).decode()
                f.write(f">rec{i} seeded\n" + "".join(s[j:j + 60] + "\n"
                                                      for j in range(0, len(s), 60)))
        t0 = time.perf_counter()
        ds = FastaBatchedDataset.from_file(path)
        native_s = time.perf_counter() - t0
        parse = native.parse_fasta
        native.parse_fasta = lambda _: None
        try:
            t0 = time.perf_counter()
            py = FastaBatchedDataset.from_file(path)
            python_s = time.perf_counter() - t0
        finally:
            native.parse_fasta = parse
    if not (hasattr(ds, "_seq_buf") and ds.sequence_labels == py.sequence_labels
            and ds.sequence_strs == py.sequence_strs):
        raise AssertionError("[fasta] native and Python records differ")
    alphabet = Alphabet.from_architecture("ESM-1b")
    idx = np.arange(256)
    want = alphabet.get_batch_converter(1022)([ds[i] for i in idx])[2].numpy()
    t0 = time.perf_counter()
    toks = native.tokenize_batch(ds._seq_buf, ds._seq_off, idx, alphabet.byte_lut(),
                                 truncation=1022, bos=alphabet.cls_idx, eos=alphabet.eos_idx,
                                 pad=alphabet.padding_idx, stride=want.shape[1])
    tok_s = time.perf_counter() - t0
    if toks is None or not np.array_equal(toks, want):
        raise AssertionError("[fasta] tokenize_batch differs from the BatchConverter")
    log(f"[fasta] native loader built/loaded in {build_s:.2f} s; 20,000 records "
        f"({sum(len(s) for s in ds.sequence_strs)} residues): native {native_s:.3f} s, Python loop {python_s:.3f} s, records equal; tokenize_batch "
        f"of 256 records {tok_s * 1e3:.2f} ms, equal to the BatchConverter")


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

        # --int8 on the card against the same command without it
        int8_dir = os.path.join(tmp, "out_int8")
        extract.run(extract.create_parser().parse_args(
            [ckpt, fasta, int8_dir, "--include", "mean", "per_tok", "bos", "contacts",
             "--repr_layers", "0", "-1", "--fp32-precision", "--int8"]))
        ratio = 0.0
        for label in seqs:
            got = torch.load(os.path.join(int8_dir, f"{label}.pt"), weights_only=False)
            ref = torch.load(os.path.join(out_dir, f"{label}.pt"), weights_only=False)
            for key in ("representations", "mean_representations"):
                r, g = ref[key][6], got[key][6]
                ratio = max(ratio, (g - r).abs().max().item() / (0.15 * (r.abs().max().item() + 1)))
        log(f"[cli] esm-extract --int8 against the run without it: the representations' largest "
            f"error is {ratio:.4f} of the bound 0.15 (max|ref| + 1)")
        if not 0 < ratio < 1:
            raise AssertionError(f"[cli] esm-extract --int8: error {ratio} x the bound")

        # ESM-1b: full width, 6 of its 33 layers, --bucket (the 1022-residue
        # sequence takes 1024 tokens, the learned positions' last rows), on
        # the card against the same command on the CPU
        ckpt = seeded_lm_checkpoint(tmp, "esm1b_t6_seeded.pt", "esm1b_t33_650M_UR50S", 6, seed=44)
        outs = {}
        for where in ("cuda", "cpu"):
            argv = [ckpt, fasta, os.path.join(tmp, f"esm1b_{where}"), "--include", "mean",
                    "per_tok", "bos", "contacts", "--repr_layers", "0", "-1", "--bucket",
                    "--fp32-precision"]
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                extract.run(extract.create_parser().parse_args(
                    argv + (["--nogpu"] if where == "cpu" else [])))
            log(f"[cli] esm-extract, ESM-1b-shaped checkpoint (1280 wide, 6 layers), --bucket, "
                f"{where}: {time.perf_counter() - t0:.1f} s")
            outs[where] = {label: torch.load(os.path.join(tmp, f"esm1b_{where}", f"{label}.pt"),
                                             weights_only=False) for label in seqs}
        worst = 0.0
        for label, s in seqs.items():
            got, ref = outs["cuda"][label], outs["cpu"][label]
            if tuple(got["contacts"].shape) != (len(s), len(s)):
                raise AssertionError(f"ESM-1b extract {label}: contacts {got['contacts'].shape}")
            worst = max(worst, (got["contacts"] - ref["contacts"]).abs().max().item())
            for key in ("representations", "mean_representations", "bos_representations"):
                if len(got[key]) != 2 or sorted(got[key]) != sorted(ref[key]):
                    raise AssertionError(f"ESM-1b extract {label}: {key} {sorted(got[key])}")
                for layer, t in got[key].items():
                    if not torch.isfinite(t).all():
                        raise AssertionError(f"ESM-1b extract {label}: non-finite {key}")
                    worst = max(worst, (t - ref[key][layer]).abs().max().item())
        if not worst <= 2e-4:
            raise AssertionError(f"ESM-1b extract on the card vs CPU: max abs err {worst} > 2e-4")
        log(f"[cli] esm-extract with the ESM-1b-shaped checkpoint, {len(seqs)} files: card vs "
            f"CPU max abs err {worst:.2e} <= 2e-4 (representations, means, bos, contacts)")


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


def redraw_zero_layers(model, seed, device="cuda"):
    """Every all-zero parameter of the trunk and heads (the init's
    zero-initialized residual-branch outputs, g_proj, the IPA head weights,
    LN biases), re-drawn with seeded noise: weight matrices ~ N(0,
    1/(4 fan_in)), the rest ~ N(0, 0.01); without it the triangle ops would
    add exactly zero. The LM is left as it is. ``device``: the model's.
    Returns the count."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    n = 0
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith("esm.") or p.any():
                continue
            scale = 0.5 * p.shape[1] ** -0.5 if p.dim() == 2 else 0.1
            p.normal_(generator=gen).mul_(scale)
            n += 1
    return n


def random_protein(length, seed):
    rng = np.random.RandomState(seed)
    return "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), length))


def fold_agreement(a, b):
    """(max atom position error in A, CA-RMSD in A, |mean pLDDT delta|,
    |pTM delta|) between two single-sequence fold outputs."""
    exists = a["atom14_atom_exists"][0].bool()
    pa, pb = a["positions"][-1][0], b["positions"][-1][0]  # (L, 14, 3)
    err = (pa - pb).norm(dim=-1)[exists].max().item()
    rmsd = (pa[:, 1] - pb[:, 1]).pow(2).sum(-1).mean().sqrt().item()
    return (err, rmsd, abs(a["mean_plddt"].item() - b["mean_plddt"].item()),
            abs(a["ptm"].item() - b["ptm"].item()))


def timed_fold(handle, seq, n=2):
    """Seconds per fold over ``n`` folds (host clock, synchronised)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        handle.infer([seq])["positions"]
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n


def phase_fold(card):
    """ESMFold v1 at full width and depth through the fast preset (K1 in the
    ESM2-3B LM, K6 in the 48-block trunk)."""
    import torch
    from esm_tpu_torch import pretrained

    t0 = time.perf_counter()
    handle = pretrained.random_esmfold("esmfold_v1", seed=11, device="cuda", fast=True)
    redrawn = redraw_zero_layers(handle.model, seed=12)
    cfg = handle.cfg
    n_lm = sum(p.numel() for p in handle.model.esm.parameters())
    n_all = sum(p.numel() for p in handle.model.parameters())
    log(f"[fold] ESMFold v1, seeded: ESM2-3B LM ({cfg.esm.num_layers} x {cfg.esm.embed_dim}, "
        f"{cfg.esm.attention_heads} heads; {n_lm / 1e6:.1f}M parameters), trunk "
        f"{cfg.trunk.num_blocks} blocks c_s {cfg.trunk.sequence_state_dim} c_z "
        f"{cfg.trunk.pairwise_state_dim} ({(n_all - n_lm) / 1e6:.1f}M parameters with the heads); "
        f"{redrawn} zero-initialized tensors re-drawn; built in {time.perf_counter() - t0:.1f} s")
    seq = random_protein(512, seed=13)
    passes = cfg.trunk.max_recycles

    zero_counts()
    fast = handle.infer([seq])
    torch.cuda.synchronize()
    counts = read_counts()
    ref = fold_reference(fast)  # [fold-shard]'s one-rank fold must equal it
    want_k6 = 2 * cfg.trunk.num_blocks * passes
    log(f"[fold] fast preset (bf16 LM with K1, bf16 trunk with K6), B=1 L=512, {passes} passes: "
        f"launches {counts}")
    if (counts["triangle_attention_fused"] != want_k6
            or counts["flash_attention"] != cfg.esm.num_layers):
        raise AssertionError(f"launches {counts}: expected K6 x {want_k6}, K1 x "
                             f"{cfg.esm.num_layers}")
    if sum(counts.values()) != want_k6 + cfg.esm.num_layers:
        raise AssertionError(f"unexpected kernel launches in the fold: {counts}")

    exact = handle.with_options(use_flash_tri=False).infer([seq])
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = handle.with_options(lm_dtype=torch.float32, use_flash=False,
                              compute_dtype=torch.float32, use_flash_tri=False).infer([seq])
    torch.backends.cuda.matmul.allow_tf32 = prev
    for name, out in (("fast", fast), ("exact", exact), ("fp32", f32)):
        finite = all(torch.isfinite(out[k]).all() for k in
                     ("positions", "plddt", "ptm", "predicted_aligned_error"))
        pl, tm_ = out["mean_plddt"].item(), out["ptm"].item()
        if not (finite and 0 <= pl <= 100 and 0 <= tm_ <= 1):
            raise AssertionError(f"{name} fold: finite {finite}, mean pLDDT {pl}, pTM {tm_}")
    err, rmsd, dpl, dtm = fold_agreement(fast, exact)
    _, rmsd_fast, _, _ = fold_agreement(fast, f32)
    _, rmsd_exact, _, _ = fold_agreement(exact, f32)
    span = fast["positions"][-1][0, :, 1].std(0).norm().item()
    log(f"[fold] fast vs exact triangle attention (both bf16): max atom position error "
        f"{err:.4f} A, CA-RMSD {rmsd:.4f} A (CA radius of gyration {span:.2f} A), |d mean pLDDT| "
        f"{dpl:.4f}, |d pTM| {dtm:.5f}; bounds {FOLD_CA_RMSD} A, {FOLD_PLDDT}, {FOLD_PTM}")
    log(f"[fold] CA-RMSD to an fp32 fold (fp32 LM and trunk, exact attention, TF32 off): fast "
        f"{rmsd_fast:.4f} A, exact {rmsd_exact:.4f} A (bound: fast <= {FOLD_RMSD_RATIO} x exact "
        f"+ {FOLD_RMSD_SLACK} A); mean pLDDT fast {fast['mean_plddt'].item():.3f} exact "
        f"{exact['mean_plddt'].item():.3f} fp32 {f32['mean_plddt'].item():.3f}; pTM fast "
        f"{fast['ptm'].item():.4f} exact {exact['ptm'].item():.4f} fp32 {f32['ptm'].item():.4f}")
    if not (rmsd <= FOLD_CA_RMSD and dpl <= FOLD_PLDDT and dtm <= FOLD_PTM):
        raise AssertionError(f"fast and exact folds disagree: CA-RMSD {rmsd}, pLDDT {dpl}, "
                             f"pTM {dtm}")
    if not rmsd_fast <= FOLD_RMSD_RATIO * rmsd_exact + FOLD_RMSD_SLACK:
        raise AssertionError(f"the K6 fold is {rmsd_fast} A from fp32, the exact route "
                             f"{rmsd_exact} A")
    del fast, exact, f32

    for length in (512, 1000):
        s = random_protein(length, seed=14 + length)
        handle.infer([s])  # warm-up at this length
        torch.cuda.reset_peak_memory_stats()
        sec = timed_fold(handle, s)
        MEASURED[f"fold_{length}_s"] = sec
        peak = torch.cuda.max_memory_allocated() / 1e9
        log(f"[fold] fast preset B=1 L={length}: {sec:.3f} s per fold, {1 / sec:.4f} folds/s, "
            f"peak memory {peak:.2f} GB (torch.cuda.max_memory_allocated; {card})")
    s = random_protein(1000, seed=1014)
    profile("one L=1000 fold (fast preset)", lambda: handle.infer([s])["positions"], top=12,
            by_op=True)
    return counts, handle, ref


# esm_triangle_attention_variant's shapes and modes, measured beside the kernel
K6_VARIANTS = ("one row a CTA (R=1, bias not shared)", "R=2, one row a step",
               "the loads alone", "no exponentials", "no bias loads from shared memory")


def measure_k6(counts):
    """K6 at the trunk's shape at L=1000: B=1, I=J=1000, H=4, d=32, bf16; then
    the kernel's other shapes and its measurement modes at that shape."""
    import ctypes

    import torch
    import torch.nn.functional as F
    from esm_tpu_torch.kernels import triangle_attention as ta

    B, I, H, d = 1, 1000, 4, 32
    J = I
    gen = torch.Generator(device="cuda").manual_seed(15)
    q = (torch.randn(B, I, J, H, d, device="cuda", generator=gen) * d ** -0.5).bfloat16()
    k = torch.randn(B, I, J, H, d, device="cuda", generator=gen).bfloat16()
    v = torch.randn(B, I, J, H, d, device="cuda", generator=gen).bfloat16()
    tri = torch.randn(B, H, J, J, device="cuda", generator=gen)
    mask_bias = torch.zeros(B, I, J, device="cuda")  # one full-length sequence, as in the fold
    kernel = lambda: ta.triangle_attention_fused(q, k, v, tri, mask_bias)
    plain = lambda: ta.triangle_attention_reference(q, k, v, tri, mask_bias)
    err = rel_err(kernel(), plain())
    ms, plain_ms = cuda_time_ms(kernel), cuda_time_ms(plain, iters=3, warmup=1)
    # yardstick: scaled_dot_product_attention over (B.I, H, J, d), the tri bias
    # (bf16) broadcast over the rows
    qs, ks, vs = (x.reshape(B * I, J, H, d).transpose(1, 2).contiguous() for x in (q, k, v))
    bias = tri.bfloat16().expand(B * I, H, J, J)
    lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=bias,
                                                                 scale=1.0), iters=5)
    flops = 4 * B * I * H * J * J * d
    nbytes = 4 * B * I * J * H * d * 2 + B * H * J * J * 4 + B * I * J * 4
    bound, by = attention_bound_ms(flops, nbytes)
    exps = B * I * H * J * J
    log(f"[k6] B={B} I=J={J} H={H} d={d} bf16: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
        f"plain {plain_ms:.4f} ms, scaled_dot_product_attention (B.I rows, broadcast bias) "
        f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({by}: {flops / H100_BF16_FLOPS * 1e3:.4f} ms of "
        f"operations, {nbytes / H100_BYTES * 1e3:.4f} ms of bytes; {exps:.2e} exponentials would "
        f"take {exps / (132 * 16 * 1.98e9) * 1e3:.4f} ms at 16 per SM-clock, 1.98 GHz); "
        f"{counts['triangle_attention_fused']} launches per fold; err {err:.3e} (relative)")
    lib = ta._library()
    lib.esm_triangle_attention_staged_bytes.restype = ctypes.c_longlong
    rows = ctypes.c_int(0)
    staged = lib.esm_triangle_attention_staged_bytes(B, I, J, H, d, ctypes.byref(rows))
    log(f"[k6] tiling: {rows.value} rows i and 128 queries a CTA, 64-key tiles; "
        f"{staged / 1e9:.3f} GB staged per call ({staged / (B * I * H * J * J):.3f} bytes a "
        f"score), {staged / ms / 1e9:.1f} TB/s from L2 at the kernel's time")
    if not err <= TRI_TOL["torch.bfloat16"]:
        raise AssertionError(f"K6 at the fold's shape: err {err}")
    fn = lib.esm_triangle_attention_variant
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(q)
    times = []
    for variant, what in enumerate(K6_VARIANTS):
        call = lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), tri.data_ptr(),
                          mask_bias.data_ptr(), out.data_ptr(), B, I, J, H, d, J, variant,
                          torch.cuda.current_stream().cuda_stream)
        rc = call()
        torch.cuda.synchronize()
        if rc != 0:
            raise RuntimeError(f"K6 variant {variant}: CUDA error {rc}")
        v_ms = cuda_time_ms(call)
        times.append(f"{what} {v_ms:.4f} ms" + (f" (err {rel_err(out, kernel()):.2e})"
                                                if variant < 2 else ""))
    log(f"[k6-variants] at that shape, the kernel {cuda_time_ms(kernel):.4f} ms; "
        + "; ".join(times))
    return {"name": "triangle_attention_fused", "route": "cuda",
            "source": "esm_tpu_torch/csrc/triangle_attention.cu",
            "replaces": "esm_tpu/kernels/triangle_attention.py:96",
            "launches": counts["triangle_attention_fused"], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}


# --------------------------------------------------------------------------
# The sharded fold ([fold-shard])
# --------------------------------------------------------------------------

FOLD_SHARD_L = 512                       # [fold]'s fast fold, sharded on one rank
FOLD_SHARD_PLAN_LENGTHS = (2048, 3072, 4096)
FOLD_SHARD_PLAN_TP = (1, 2, 4)
FOLD_SHARD_CARDS_L = 2048                # the several-card fold (num_recycles=1)
FOLD_SHARD_TIMEOUT = 900                 # seconds the several-card ranks may take
FOLD_OUTPUTS = ("positions", "plddt", "ptm", "predicted_aligned_error")


def fold_reference(out):
    """The outputs [fold-shard] holds a sharded fold to, copied."""
    return {k: out[k].clone() for k in FOLD_OUTPUTS + ("mean_plddt", "atom14_atom_exists")}


def seeded_fold_handle(device="cuda"):
    """[fold]'s ESMFold v1: seeded, fast preset, the zero layers re-drawn."""
    from esm_tpu_torch import pretrained

    handle = pretrained.random_esmfold("esmfold_v1", seed=11, device=device, fast=True)
    redraw_zero_layers(handle.model, seed=12, device=device)
    return handle


def fold_plan_lines(cfg, params):
    """plan_fold's verdicts for the sharded fold at tp x L on this card."""
    from esm_tpu_torch.parallel.memory_plan import plan_fold
    from esm_tpu_torch.parallel.mesh import MeshConfig

    parts = []
    for length in FOLD_SHARD_PLAN_LENGTHS:
        for tp in FOLD_SHARD_PLAN_TP:
            p = plan_fold(cfg, length, MeshConfig(1, 1, tp), params_bytes=params)
            parts.append(f"L={length} tp={tp} {p['per_device_bytes'] / 1e9:.1f} GB {p['verdict']}")
    return "; ".join(parts)


def phase_fold_shard(card, handle=None, ref=None):
    """The sharded fold (esmfold.apply_sharded) of [fold]'s L=512 fast fold on
    a one-rank NCCL group of this card: equal to the unsharded fold bit for
    bit, K4 36 and K6 384 launches (K1 none), its time and peak beside the
    plan; with two or more cards, the several-card part. ``handle`` and
    ``ref``: [fold]'s handle and fast fold (built here when None)."""
    import torch
    import torch.distributed as dist
    from esm_tpu_torch.parallel.memory_plan import plan_fold
    from esm_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    t_phase = time.perf_counter()
    seq = random_protein(FOLD_SHARD_L, seed=13)  # [fold]'s sequence
    own = handle is None
    if own:
        handle = seeded_fold_handle()
        ref = fold_reference(handle.infer([seq]))
        handle.infer([seq])
        MEASURED["fold_512_s"] = timed_fold(handle, seq)
    cfg = handle.cfg
    sharded = handle.with_options(pair_spec=("tp",))
    passes = cfg.trunk.max_recycles
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", world_size=1,
                            rank=0)
    try:
        mesh = make_mesh(MeshConfig(1, 1, 1))
        zero_counts()
        out = sharded.infer([seq], mesh=mesh)
        torch.cuda.synchronize()
        counts = read_counts()
        same = {k: torch.equal(out[k], ref[k]) for k in FOLD_OUTPUTS}
        torch.cuda.reset_peak_memory_stats()
        sec = timed_fold(_MeshFold(sharded, mesh), seq)
        reserved = torch.cuda.max_memory_reserved()
    finally:
        dist.destroy_process_group()
    want = {"flash_attention_with_lse": cfg.esm.num_layers,
            "triangle_attention_fused": 2 * cfg.trunk.num_blocks * passes}
    log(f"[fold-shard] one-rank NCCL group, ESMFold v1 fast, pair_spec ('tp',), B=1 L="
        f"{FOLD_SHARD_L}, {passes} passes: launches {counts}; bit for bit against [fold]'s fast "
        f"fold: {same}")
    params = param_bytes(handle.model)
    plan = plan_fold(sharded.cfg, FOLD_SHARD_L, MeshConfig(1, 1, 1), params_bytes=params)
    log(f"[fold-shard] {sec:.3f} s per sharded fold against {MEASURED['fold_512_s']:.3f} s "
        f"unsharded ([fold], L={FOLD_SHARD_L}); max_memory_reserved {reserved / 1e9:.3f} GB, "
        f"plan_fold at one shard {plan['per_device_bytes'] / 1e9:.3f} GB ({plan['verdict']}; "
        f"{card})")
    log(f"[fold-shard] plan_fold on this card's {plan['hbm_bytes'] / 1e9:.1f} GB (fast, "
        f"{params / 1e9:.2f} GB of weights): " + fold_plan_lines(sharded.cfg, params))
    if not all(same.values()):
        raise AssertionError(f"[fold-shard] the one-rank sharded fold differs from [fold]'s: "
                             f"{same}")
    if (any(counts[k] != v for k, v in want.items()) or counts["flash_attention"]
            or sum(counts.values()) != sum(want.values())):
        raise AssertionError(f"[fold-shard] launches {counts}, expected {want} and no other")
    entries = measure_fold_shard_kernels(cfg, counts)
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        if own:
            del handle, sharded, out
            torch.cuda.empty_cache()
        world = fold_shard_several_cards(n_cards)
        log(f"[fold-shard] ran: the one-rank group and {world} ranks over {n_cards} cards")
    else:
        log("[fold-shard] ran: the one-rank group (one card present: no several-card part)")
    log(f"[fold-shard] took {time.perf_counter() - t_phase:.1f} s")
    return entries


def measure_fold_shard_kernels(cfg, counts):
    """K4 and K6 at the shapes the one-rank sharded fold gives them: the ring
    LM's (B=1, H=40, T=L+2, d=64, no rotary, no padding) and a trunk block's
    (B=1, I=J=L, H=4, d=32), bf16, each against its plain version, timed
    beside scaled_dot_product_attention and the bound."""
    import torch
    import torch.nn.functional as F
    from esm_tpu_torch.kernels import flash_attention as fa
    from esm_tpu_torch.kernels import triangle_attention as ta

    gen = torch.Generator(device="cuda").manual_seed(24)
    b, h, t = 1, cfg.esm.attention_heads, FOLD_SHARD_L + 2
    d = cfg.esm.embed_dim // h
    q, k, v = (torch.randn(b, h, t, d, device="cuda", generator=gen).bfloat16()
               for _ in range(3))
    q = q * d ** -0.5
    k4 = lambda: fa.flash_attention_with_lse(q, k, v)
    o4, l4 = k4()
    r4, rl4 = fa.flash_attention_reference(q, k, v, return_lse=True)
    err4 = max((o4.float() - r4.float()).abs().max().item(), rel_err(l4, rl4))
    ms4 = cuda_time_ms(k4)
    plain4 = cuda_time_ms(lambda: fa.flash_attention_reference(q, k, v, return_lse=True))
    lib4 = cuda_time_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0))
    flops4 = 4 * b * h * t * t * d
    bound4, by4 = attention_bound_ms(flops4, 4 * b * h * t * d * 2 + b * h * t * 4)

    i = j = FOLD_SHARD_L
    th, td = cfg.trunk.pair_heads, cfg.trunk.pairwise_head_width
    qt = (torch.randn(b, i, j, th, td, device="cuda", generator=gen) * td ** -0.5).bfloat16()
    kt, vt = (torch.randn(b, i, j, th, td, device="cuda", generator=gen).bfloat16()
              for _ in range(2))
    tri = torch.randn(b, th, j, j, device="cuda", generator=gen)
    mask_bias = torch.zeros(b, i, j, device="cuda")
    k6 = lambda: ta.triangle_attention_fused(qt, kt, vt, tri, mask_bias)
    err6 = rel_err(k6(), ta.triangle_attention_reference(qt, kt, vt, tri, mask_bias))
    ms6 = cuda_time_ms(k6)
    plain6 = cuda_time_ms(lambda: ta.triangle_attention_reference(qt, kt, vt, tri, mask_bias),
                          iters=3, warmup=1)
    qs, ks, vs = (x.reshape(b * i, j, th, td).transpose(1, 2).contiguous() for x in (qt, kt, vt))
    bias = tri.bfloat16().expand(b * i, th, j, j)
    lib6 = cuda_time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=bias,
                                                                scale=1.0), iters=5)
    flops6 = 4 * b * i * th * j * j * td
    bound6, by6 = attention_bound_ms(flops6, 4 * b * i * j * th * td * 2 + b * th * j * j * 4
                                     + b * i * j * 4)
    for tag, shape, ms, plain, lib, bound, by, err in (
            ("k4", f"B={b} H={h} T={t} d={d}", ms4, plain4, lib4, bound4, by4, err4),
            ("k6", f"B={b} I=J={i} H={th} d={td}", ms6, plain6, lib6, bound6, by6, err6)):
        log(f"[fold-shard] {tag} at the one-rank sharded fold's shape ({shape}, bf16): kernel "
            f"{ms:.4f} ms, plain {plain:.4f} ms, scaled_dot_product_attention {lib:.4f} ms, "
            f"bound {bound:.4f} ms ({by}); err {err:.3e}")
    if not (err4 <= BF16_TOL and err6 <= TRI_TOL["torch.bfloat16"]):
        raise AssertionError(f"[fold-shard] K4 / K6 at the fold's shapes: err {err4}, {err6}")
    return [
        {"name": "flash_attention_with_lse/fold-shard", "route": "cuda",
         "source": "esm_tpu_torch/csrc/flash_attention.cu",
         "replaces": "esm_tpu/kernels/flash_attention.py:938",
         "launches": counts["flash_attention_with_lse"], "max_abs_err": err4, "ms": ms4,
         "plain_ms": plain4, "bound_ms": bound4, "bound_by": by4, "library_ms": lib4},
        {"name": "triangle_attention_fused/fold-shard", "route": "cuda",
         "source": "esm_tpu_torch/csrc/triangle_attention.cu",
         "replaces": "esm_tpu/kernels/triangle_attention.py:96",
         "launches": counts["triangle_attention_fused"], "max_abs_err": err6, "ms": ms6,
         "plain_ms": plain6, "bound_ms": bound6, "bound_by": by6, "library_ms": lib6},
    ]


class _MeshFold:
    """A handle whose infer folds on ``mesh`` (timed_fold's interface)."""

    def __init__(self, handle, mesh):
        self.handle, self.mesh = handle, mesh

    def infer(self, seqs, **kw):
        return self.handle.infer(seqs, mesh=self.mesh, **kw)


def fold_shard_rank(rank, world, port, out_dir):
    """One rank of [fold-shard]'s several-card part (spawned, one per card)."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=FOLD_SHARD_TIMEOUT))
    res = {"seconds": {}}
    for part in (fold_shard_cards_2048, fold_shard_cards_long):
        t0 = time.perf_counter()
        try:
            res[part.__name__] = part(rank, world, res)
        except BaseException:
            # leave at once: the other ranks' collectives would wait on this one
            import traceback

            log(f"[fold-shard] rank {rank}: {part.__name__} failed after "
                f"{time.perf_counter() - t0:.1f} s:\n{traceback.format_exc()}")
            os._exit(1)
        res["seconds"][part.__name__] = time.perf_counter() - t0
        log(f"[fold-shard] rank {rank}: {part.__name__} ended in "
            f"{res['seconds'][part.__name__]:.1f} s")
    res.pop("handle", None)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def _sharded_fold(handle, mesh, seq, num_recycles):
    """(output, seconds, peak allocated GB, peak reserved GB) of one sharded
    fold on this rank, with the launch counts of the fold."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    out = handle.infer([seq], mesh=mesh, num_recycles=num_recycles)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    return (out, sec, torch.cuda.max_memory_allocated() / 1e9,
            torch.cuda.max_memory_reserved() / 1e9, read_counts())


def fold_shard_cards_2048(rank, world, res):
    """ESMFold v1 fast at L=2048, one recycle, pair rows over every rank,
    against rank 0's one-card fold of the same weights ([fold]'s agreement
    rule); each rank's peak beside plan_fold at N shards; the time beside
    the one-card fold and plan_scaling_fold."""
    import torch
    from esm_tpu_torch.parallel.memory_plan import plan_fold
    from esm_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from esm_tpu_torch.parallel.scaling import plan_scaling_fold

    handle = seeded_fold_handle(f"cuda:{rank}")
    res["handle"] = handle
    seq = random_protein(FOLD_SHARD_CARDS_L, seed=17)
    out = {}
    if rank == 0:
        handle.infer([random_protein(256, seed=18)], num_recycles=0)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one = handle.infer([seq], num_recycles=1)
        torch.cuda.synchronize()
        out["one_card_s"] = time.perf_counter() - t0
    mesh = make_mesh(MeshConfig(1, 1, world))
    sharded = handle.with_options(pair_spec=("tp",))
    sharded.infer([random_protein(256, seed=18)], mesh=mesh, num_recycles=0)  # warm-up
    got, sec, peak, reserved, counts = _sharded_fold(sharded, mesh, seq, 1)
    plan = plan_fold(sharded.cfg, FOLD_SHARD_CARDS_L, MeshConfig(1, 1, world),
                     params_bytes=param_bytes(handle.model))
    pred = plan_scaling_fold(sharded.cfg, MeshConfig(1, 1, world), FOLD_SHARD_CARDS_L,
                             num_recycles=1)
    out.update(sharded_s=sec, peak_gb=peak, reserved_gb=reserved, counts=counts,
               want_k6=2 * handle.cfg.trunk.num_blocks * 2,
               plan_gb=plan["per_device_bytes"] / 1e9, verdict=plan["verdict"],
               pred_compute_s=pred["t_compute_ms"] / 1e3, pred_link_s=pred["t_link_ms"] / 1e3,
               finite=bool(all(torch.isfinite(got[k]).all() for k in FOLD_OUTPUTS)))
    if rank == 0:
        err, rmsd, dpl, dtm = fold_agreement(got, one)
        out.update(err=err, rmsd=rmsd, dpl=dpl, dtm=dtm, plddt=got["mean_plddt"].item(),
                   one_plddt=one["mean_plddt"].item(), ptm=got["ptm"].item(),
                   one_ptm=one["ptm"].item())
    del got
    torch.cuda.empty_cache()
    return out


def fold_shard_cards_long(rank, world, res):
    """One fold (no recycle) at the shortest multiple of 256 that the one-card
    plan refuses, sharded over every rank: each rank's peak beside the plan."""
    import torch
    from esm_tpu_torch.parallel.memory_plan import plan_fold
    from esm_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    handle = res["handle"]
    params = param_bytes(handle.model)
    length = FOLD_SHARD_CARDS_L
    while plan_fold(handle.cfg, length, params_bytes=params)["verdict"] == "fits":
        length += 256
    mesh = make_mesh(MeshConfig(1, 1, world))
    sharded = handle.with_options(pair_spec=("tp",))
    got, sec, peak, reserved, counts = _sharded_fold(sharded, mesh,
                                                     random_protein(length, seed=19), 0)
    one = plan_fold(handle.cfg, length, params_bytes=params)
    plan = plan_fold(sharded.cfg, length, MeshConfig(1, 1, world), params_bytes=params)
    return {"length": length, "sharded_s": sec, "peak_gb": peak, "reserved_gb": reserved,
            "counts": counts, "plan_gb": plan["per_device_bytes"] / 1e9,
            "verdict": plan["verdict"], "one_card_plan_gb": one["per_device_bytes"] / 1e9,
            "one_card_verdict": one["verdict"],
            "finite": bool(all(torch.isfinite(got[k]).all() for k in FOLD_OUTPUTS))}


def fold_shard_several_cards(n_cards):
    """One NCCL rank per card (the largest power of two not above the count)."""
    import torch.multiprocessing as mp

    world = 1 << (n_cards.bit_length() - 1)
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.start_processes(fold_shard_rank, args=(world, free_port(), out_dir),
                                 nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + FOLD_SHARD_TIMEOUT
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise AssertionError(f"[fold-shard] the {world} ranks did not end in "
                                     f"{FOLD_SHARD_TIMEOUT} s")
        results = []
        for rank in range(world):
            with open(os.path.join(out_dir, f"rank{rank}.json")) as f:
                results.append(json.load(f))
    failed = []
    for rank, res in enumerate(results):
        a, b = res["fold_shard_cards_2048"], res["fold_shard_cards_long"]
        log(f"[fold-shard] {world} cards, rank {rank}: ESMFold v1 fast L={FOLD_SHARD_CARDS_L}, "
            f"one recycle, pair tp={world}: {a['sharded_s']:.2f} s"
            + (f" (one card {a['one_card_s']:.2f} s)" if rank == 0 else "")
            + f", plan_scaling_fold compute {a['pred_compute_s']:.3f} s + link "
            f"{a['pred_link_s']:.3f} s; peak {a['peak_gb']:.2f} GB allocated, "
            f"{a['reserved_gb']:.2f} GB reserved, plan_fold {a['plan_gb']:.2f} GB "
            f"({a['verdict']}); launches {a['counts']}")
        log(f"[fold-shard] {world} cards, rank {rank}: L={b['length']} (the one-card plan: "
            f"{b['one_card_plan_gb']:.2f} GB, {b['one_card_verdict']}), no recycle: "
            f"{b['sharded_s']:.2f} s; peak {b['peak_gb']:.2f} GB allocated, "
            f"{b['reserved_gb']:.2f} GB reserved, plan_fold {b['plan_gb']:.2f} GB "
            f"({b['verdict']})")
        if not (a["finite"] and b["finite"]):
            failed.append(f"rank {rank}: non-finite outputs")
        if (a["counts"]["triangle_attention_fused"] != a["want_k6"]
                or a["counts"]["flash_attention"]):
            failed.append(f"rank {rank}: launches {a['counts']} (K6 x {a['want_k6']}, no K1)")
        if rank == 0:
            log(f"[fold-shard] {world} cards against one card: max atom position error "
                f"{a['err']:.4f} A, CA-RMSD {a['rmsd']:.4f} A, mean pLDDT {a['plddt']:.3f} vs "
                f"{a['one_plddt']:.3f}, pTM {a['ptm']:.4f} vs {a['one_ptm']:.4f}; bounds "
                f"{FOLD_CA_RMSD} A, {FOLD_PLDDT}, {FOLD_PTM}")
            if not (a["rmsd"] <= FOLD_CA_RMSD and a["dpl"] <= FOLD_PLDDT
                    and a["dtm"] <= FOLD_PTM):
                failed.append("the sharded fold is off the one-card fold")
    if failed:
        raise AssertionError("[fold-shard] " + "; ".join(failed))
    return world


# K7's and K8's times at 10^6 rows, C=128, bf16, before the Hopper redesign
# (the earlier mma.sync kernels; chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W).
TRIMUL_MMA_SYNC_MS = {"tri_mul_stage1": 1.6851, "tri_mul_epilogue": 2.0394}
# esm_tri_mul_variant's measurement modes, timed beside each kernel
TRIMUL_VARIANTS = ("loads alone", "no stores", "no sigmoids")


def phase_trimul():
    """The A/B left open at esm_tpu/models/esmfold/blocks.py:127-130, on the
    card: the fused tri-mul (K7 + einsum + K8) against z + the unfused op at
    the trunk's width; then K7 and K8 timed, and their measurement modes.
    Under torch.no_grad(), as the fold runs: the kernels have no backward."""
    import torch

    with torch.no_grad():
        return trimul_measure()


def trimul_measure():
    import ctypes

    import torch
    from esm_tpu_torch.kernels import triangle_mul as tm
    from esm_tpu_torch.ops import triangle as tri

    L, C = 1000, 128
    gen = torch.Generator(device="cuda").manual_seed(16)
    mod = tri_mul_module(C, seed=17)
    z = torch.randn(1, L, L, C, device="cuda", generator=gen).bfloat16()
    mask = torch.ones(1, L, L, device="cuda", dtype=torch.bfloat16)  # the trunk's tri_mask
    zero_counts()
    fused = {o: tri.triangle_multiplicative_update_fused(mod, z, outgoing=o, mask=mask)
             for o in (True, False)}
    torch.cuda.synchronize()
    counts = read_counts()
    if counts["tri_mul_stage1"] != 2 or counts["tri_mul_epilogue"] != 2:
        raise AssertionError(f"fused tri-mul launches {counts}: expected K7 x 2, K8 x 2")
    errs = {}
    times = {}
    for o in (True, False):
        unfused = z + tri.triangle_multiplicative_update(mod, z, outgoing=o, mask=mask)
        errs[o] = rel_err(fused[o], unfused)
        times[o] = (cuda_time_ms(lambda: tri.triangle_multiplicative_update_fused(
                        mod, z, outgoing=o, mask=mask), iters=10),
                    cuda_time_ms(lambda: z + tri.triangle_multiplicative_update(
                        mod, z, outgoing=o, mask=mask), iters=10))
    del fused, unfused
    for o in (True, False):
        log(f"[trimul] {'outgoing' if o else 'incoming'} B=1 L={L} C={C} bf16, trunk mask: "
            f"fused (K7 + einsum + K8) {times[o][0]:.4f} ms, z + unfused {times[o][1]:.4f} ms "
            f"(fused / unfused {times[o][0] / times[o][1]:.3f}); agreement {errs[o]:.3e} <= "
            f"{TRIMUL_AB_TOL} (relative)")
    if not max(errs.values()) <= TRIMUL_AB_TOL:
        raise AssertionError(f"fused and unfused tri-mul disagree: {errs}")

    rows = L * L
    entries = []
    w = tm.stage1_weights(mod, z.dtype)
    zf, mf = z.reshape(rows, C), mask.reshape(rows).to(torch.int8)
    x = torch.randn(1, L, L, C, device="cuda", generator=gen).bfloat16()
    xf = x.reshape(rows, C)
    ew = tm.epilogue_weights(mod, z.dtype)
    lib = tm._library()
    variant = lib.esm_tri_mul_variant
    variant.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                        ctypes.c_longlong, ctypes.c_void_p]
    variant.restype = ctypes.c_int
    outs = [torch.empty_like(zf) for _ in range(2)]
    for index, (name, kernel, plain, ops, nbytes, line, launches, ptrs) in enumerate((
        ("tri_mul_stage1", lambda: tm.tri_mul_stage1(z, mask, mod),
         lambda: tm.tri_mul_stage1_reference(zf, mf, *w),
         2 * rows * C * 4 * C, 3 * rows * C * 2 + rows + 4 * C * C * 2, 147,
         counts["tri_mul_stage1"], [zf, mf, *w, *outs]),
        ("tri_mul_epilogue", lambda: tm.tri_mul_epilogue(x, z, mod),
         lambda: tm.tri_mul_epilogue_reference(xf, zf, *ew),
         2 * 2 * rows * C * C, 3 * rows * C * 2 + 2 * C * C * 2, 186,
         counts["tri_mul_epilogue"], [xf, zf, *ew, outs[0]]),
    )):
        got, ref = kernel(), plain()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        err = max(rel_err(g.reshape(rows, C), r) for g, r in zip(got, ref))
        ms, plain_ms = cuda_time_ms(kernel), cuda_time_ms(plain, iters=3, warmup=1)
        bound, by = attention_bound_ms(ops, nbytes)
        tag = "k7" if name == "tri_mul_stage1" else "k8"
        log(f"[{tag}] {name} B=1 L={L} ({rows} rows) C={C} bf16: kernel {ms:.4f} ms "
            f"({nbytes / ms / 1e6:.1f} GB/s, {bound / ms:.3f} of the bound; the mma.sync "
            f"kernel's {TRIMUL_MMA_SYNC_MS[name]:.4f} ms), plain {plain_ms:.4f} ms, bound "
            f"{bound:.4f} ms "
            f"({by}); {launches} launches in the [trimul] run; err {err:.3e} (relative)")
        if not err <= TRIMUL_TOL["torch.bfloat16"]:
            raise AssertionError(f"{name} at the trunk's width: err {err}")
        args = (ctypes.c_void_p * len(ptrs))(*[t.data_ptr() for t in ptrs])
        stream = torch.cuda.current_stream().cuda_stream
        parts = []
        for mode, what in enumerate(TRIMUL_VARIANTS, start=1):
            call = lambda: variant(index, mode, args, rows, stream)
            rc = call()
            torch.cuda.synchronize()
            if rc != 0:
                raise RuntimeError(f"{name} variant {mode}: CUDA error {rc}")
            parts.append(f"{what} {cuda_time_ms(call):.4f} ms")
        log(f"[{tag}-variants] at that shape, the kernel {cuda_time_ms(kernel):.4f} ms; "
            + "; ".join(parts))
        entries.append({"name": name, "route": "cuda",
                        "source": "esm_tpu_torch/csrc/triangle_mul.cu",
                        "replaces": f"esm_tpu/kernels/triangle_mul.py:{line}",
                        "launches": launches, "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                        "library_ms": None})
    return entries


def phase_cli_fold():
    """esm_tpu_torch.cli.fold on the card (--fused-triangle) with a
    reference-layout checkpoint, its PDBs against a CPU run."""
    import torch
    from esm_tpu_torch.cli import fold
    from esm_tpu_torch.io.export import save_esm2, save_esmfold
    from esm_tpu_torch.kernels import triangle_attention as ta
    from esm_tpu_torch.models import esm2
    from esm_tpu_torch.models import esmfold as ef
    from esm_tpu_torch.pretrained import _esm2_alphabet

    cfg = ef.ESMFoldConfig(
        esm=esm2.ESM2Config.from_alphabet(_esm2_alphabet(), **esm2.ESM2_SIZES["esm2_t6_8M_UR50D"]),
        trunk=ef.FoldingTrunkConfig(num_blocks=2), esm_type="esm2_8M")
    model = ef.init_esmfold(cfg, torch.Generator().manual_seed(18), device="cpu")
    redraw = {n: p for n, p in model.named_parameters() if not n.startswith("esm.") and not p.any()}
    gen = torch.Generator().manual_seed(19)
    with torch.no_grad():
        for p in redraw.values():
            p.normal_(generator=gen).mul_(0.5 * p.shape[1] ** -0.5 if p.dim() == 2 else 0.1)
    seqs = {f"p{n}": random_protein(n, seed=n) for n in (40, 120, 257)}
    seqs["dimer"] = random_protein(60, seed=60) + ":" + random_protein(50, seed=50)
    prev_cache = os.environ.get("ESM_TPU_CACHE")
    with tempfile.TemporaryDirectory() as tmp:
        cache = os.path.join(tmp, "cache")
        os.makedirs(cache)
        save_esm2(model.esm, os.path.join(cache, "esm2_t6_8M_UR50D_500K.pt"))
        ckpt = save_esmfold(model, os.path.join(tmp, "esmfold_small.pt"))
        fasta = os.path.join(tmp, "seqs.fasta")
        with open(fasta, "w") as f:
            f.write("".join(f">{k}\n{v}\n" for k, v in seqs.items()))
        os.environ["ESM_TPU_CACHE"] = cache
        try:
            outs = {}
            for where in ("cuda", "cpu"):
                out_dir = os.path.join(tmp, where)
                argv = ["-i", fasta, "-o", out_dir, "-m", ckpt, "--fused-triangle",
                        "--num-recycles", "0"]
                zero_counts()
                t0 = time.perf_counter()
                n = fold.run(fold.create_parser().parse_args(
                    argv + (["--cpu-only"] if where == "cpu" else [])))
                seconds = time.perf_counter() - t0
                launches = ta.triangle_attention_fused.launches
                outs[where] = {k: open(os.path.join(out_dir, f"{k}.pdb")).read() for k in seqs}
                log(f"[cli-fold] {where}: {n} PDBs in {seconds:.1f} s, K6 launched {launches} times")
                if n != len(seqs) or (where == "cuda") != (launches > 0):
                    raise AssertionError(f"cli.fold on {where}: {n} PDBs, K6 x {launches}")
            # --int8 on the card against the run without it (random weights: no bound)
            out_dir = os.path.join(tmp, "cuda_int8")
            zero_counts()
            n = fold.run(fold.create_parser().parse_args(
                ["-i", fasta, "-o", out_dir, "-m", ckpt, "--fused-triangle", "--num-recycles",
                 "0", "--int8"]))
            launches = ta.triangle_attention_fused.launches
            int8 = {k: open(os.path.join(out_dir, f"{k}.pdb")).read() for k in seqs}
            if n != len(seqs) or launches == 0:
                raise AssertionError(f"cli.fold --int8: {n} PDBs, K6 x {launches}")
            for k in seqs:
                ca, ca_ref = pdb_ca(int8[k]), pdb_ca(outs["cuda"][k])
                if not (np.isfinite(ca).all() and ca.shape == ca_ref.shape):
                    raise AssertionError(f"cli.fold --int8 {k}: CA atoms {ca.shape}")
                rmsd = float(np.sqrt(((ca[:, :3] - ca_ref[:, :3]) ** 2).sum(-1).mean()))
                log(f"[cli-fold] --int8 {k}: CA-RMSD {rmsd:.3f} A from the run without it, mean "
                    f"pLDDT {ca[:, 3].mean():.2f} vs {ca_ref[:, 3].mean():.2f}; K6 x {launches}")
        finally:
            if prev_cache is None:
                os.environ.pop("ESM_TPU_CACHE", None)
            else:
                os.environ["ESM_TPU_CACHE"] = prev_cache
    worst = 0.0
    for k in seqs:
        a, b = outs["cuda"][k].splitlines(), outs["cpu"][k].splitlines()
        if len(a) != len(b) or any(x[:30] != y[:30] for x, y in zip(a, b)):
            raise AssertionError(f"cli.fold {k}: card and CPU PDBs differ in their records")
        for x, y in zip(a, b):
            if x.startswith("ATOM"):
                worst = max(worst, max(abs(float(x[i:i + 8]) - float(y[i:i + 8]))
                                       for i in (30, 38, 46)))
    # fp32 on both (K6's fp32 kernel against the plain version), one pass:
    # sums in another order through 2 blocks and the structure module, and
    # the last printed digit. (With recycles, a CB distance at a distogram
    # bin edge can fall into another bin on the two machines and move the
    # next pass by ~0.01 A.)
    if not worst <= CLI_FOLD_TOL:
        raise AssertionError(f"cli.fold card vs CPU coordinates differ by {worst} A > "
                             f"{CLI_FOLD_TOL}")
    log(f"[cli-fold] {len(seqs)} sequences (lengths 40, 120, 257 and a 60:50 dimer), esm2_t6_8M "
        f"LM and a 2-block trunk at ESMFold's widths, fp32, one pass, --fused-triangle: card vs "
        f"CPU coordinates within {worst:.4f} A <= {CLI_FOLD_TOL} A, same atoms and records")


# [serve]: the embed load of esm_tpu's scripts_dev/bench_serve_tpu.py
SERVE_LENGTHS = (250, 380, 500, 1000, 1022)
SERVE_REQUESTS, SERVE_CLIENTS = 64, 8
SERVE_HOLD_CYCLES = 1_000_000_000  # device spin before a pipelined chunk's readback (~0.5 s)
# A co-batched answer (B=16, T of its longest member) against the same
# sequence's lone answer (B=1): the two differ only in the GEMMs' shapes, so
# in how bf16 rounds. Each field within 1e-3 of the lone answer's largest
# magnitude (at least 1): the card read 0 for the mean and the contacts and
# 7.4e-7 for the logits, and another row of the batch is checked to lie
# beyond the bound, so a misplaced row fails.
SERVE_COBATCH_TOL = 1e-3
FOLD_COST_BUCKETS = (256, 512, 1024, 2048)  # one trunk pass each, B=1
# the server's fold cost constants against this run's pass times where the
# pass is not host-bound, at their best unit: tests/test_server.py's bound
FOLD_COST_HELD, FOLD_COST_TOL = (1024, 2048), 0.11
PLAN_SHARE = 0.9  # a fold may hold at most plan / 0.9 (the cap's 10% headroom)


def http_post(url, payload, path="/embed", timeout=600):
    import urllib.request

    req = urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.read()


def http_json(url, payload=None, path="/stats"):
    import urllib.request

    if payload is not None:
        return json.loads(http_post(url, payload, path))
    with urllib.request.urlopen(url + path, timeout=60) as resp:
        return json.loads(resp.read())


def count_delta(before, after):
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def param_bytes(module):
    return sum(t.numel() * t.element_size()
               for t in list(module.parameters()) + list(module.buffers()))


def fit_fold_cost(seconds):
    """a*y^2 + b*y^3 + c fitted to the pass times by bucket (y = bucket /
    512), minimizing the largest relative error (a linear program), and
    normalized to the 512 bucket. Returns ((a, b, c) with a + b + c = 1, the
    unit: seconds of the 512-bucket pass, the relative error at each
    bucket)."""
    from scipy.optimize import linprog

    buckets = sorted(seconds)
    y = np.array(buckets, float) / 512
    t = np.array([seconds[b] for b in buckets])
    a = np.stack([y ** 2, y ** 3, np.ones_like(y)], 1)
    rel = np.hstack([a / t[:, None], -np.ones((len(t), 1))])  # (a x) / t - e
    neg = np.hstack([-a / t[:, None], -np.ones((len(t), 1))])
    res = linprog([0, 0, 0, 1], A_ub=np.vstack([rel, neg]),
                  b_ub=np.concatenate([np.ones(len(t)), -np.ones(len(t))]),
                  bounds=[(None, None)] * 3 + [(0, None)])
    if not res.success:
        raise AssertionError(f"the fold cost fit failed: {res.message}")
    coef = res.x[:3]
    unit = coef.sum()
    coef = coef / unit
    return coef, unit, dict(zip(buckets, unit * (a @ coef) / t - 1))


def phase_serve(card, fold):
    """The port's InferenceServer in this process on the card with three
    seeded models at their released sizes: ESM2-650M (bf16, flash), ESMFold
    v1 ([fold]'s handle: fast preset) and ESM-IF1. The /embed load of
    bench_serve_tpu.py, K1 per device batch, readback against the next
    batch's compute, agreement with direct handle calls, /score, /fold
    (launches a chunk, order, direct folds), the fold cost fit and the
    memory-plan check, /design, /profile and /stats."""
    import threading

    import torch
    from esm_tpu_torch import pretrained
    from esm_tpu_torch.cli.predict_variants import wt_marginal_score
    from esm_tpu_torch.models.esmfold.esmfold import FOLD_LENGTH_BUCKET
    from esm_tpu_torch.parallel.memory_plan import max_fold_length, plan_fold
    from esm_tpu_torch.runtime import server as sv

    t_phase = time.perf_counter()
    lm, alphabet = pretrained.random_model_and_alphabet("esm2_t33_650M_UR50D", seed=0,
                                                        device="cuda")
    lm = lm.with_options(compute_dtype=torch.bfloat16, use_flash=True)
    if1, _ = pretrained.random_model_and_alphabet("esm_if1_gvp4_t16_142M_UR50", seed=60,
                                                  device="cuda")
    other_bytes = param_bytes(lm.model) + param_bytes(if1.model)
    srv = sv.InferenceServer(lm, fold_model=fold, if_model=if1, max_batch_seqs=16,
                             max_wait_ms=20.0, max_fold_batch_seqs=2, batch_bucket="max")
    t0 = time.perf_counter()
    srv.start()
    shapes = srv.prewarm()
    log(f"[serve] InferenceServer on {srv.url}: ESM2-650M bf16 flash, ESMFold v1 fast, "
        f"ESM-IF1; started (kernels {srv.build_kernels()}) and prewarmed {shapes} (B, T) "
        f"shapes in {time.perf_counter() - t0:.1f} s; /healthz "
        f"{http_json(srv.url, path='/healthz')['endpoints']}")
    try:
        # ---- /embed: every device batch's launches, and its readback against
        # the next batch's compute
        records, lock = [], threading.Lock()
        real_dispatch = srv._dispatch_embed_chunk

        real_readback, held = sv._readback, threading.local()
        hold = [False]  # set for the 48-sequence request below

        def readback(tensors):
            if getattr(held, "on", False):
                # SERVE_HOLD_CYCLES of device spin between this batch's
                # compute and its readback: the batch stays unfinished on
                # the card past any host delay before the previous batch's
                # readback is read, while a readback that waited on work
                # queued after it (a stream or device sync) ends after the
                # spin and fails. A spin ahead of the compute would not do:
                # the host blocks once the card's queue of pending launches
                # is full, so the dispatch itself would wait it out.
                torch.cuda._sleep(SERVE_HOLD_CYCLES)
            return real_readback(tensors)

        sv._readback = readback

        def dispatch(pairs, layers, include):
            with lock:
                follows = bool(records) and records[-1] is not None
            held.on = hold[0] and follows
            t_d = time.perf_counter()
            before = read_counts()
            try:
                fin = real_dispatch(pairs, layers, include)
            finally:
                held.on = False
            rec = {"n": len(pairs), "launches": count_delta(before, read_counts()),
                   "ready": fin.ready, "next": None, "overlap": None,
                   "dispatch_ms": 1e3 * (time.perf_counter() - t_d), "finalize_ms": None}
            with lock:
                if records and records[-1] is not None:
                    records[-1]["next"] = rec
                records.append(rec)

            def finalize():
                t_f = time.perf_counter()
                items = fin()
                rec["finalize_ms"] = 1e3 * (time.perf_counter() - t_f)
                with lock:
                    nxt = rec["next"]
                # None: no later batch was queued; True: its compute was still
                # running when this batch's readback had ended and its items
                # were built
                rec["overlap"] = None if nxt is None else not nxt["ready"].query()
                return items

            return finalize

        srv._dispatch_embed_chunk = dispatch
        rng = np.random.RandomState(70)
        lens = rng.choice(SERVE_LENGTHS, SERVE_REQUESTS)
        seqs = [random_protein(int(n), seed=700 + i) for i, n in enumerate(lens)]
        latencies, order = [None] * SERVE_REQUESTS, iter(range(SERVE_REQUESTS))

        def client():
            while True:
                with lock:
                    i = next(order, None)
                if i is None:
                    return
                t = time.perf_counter()
                out = http_json(srv.url, {"sequences": [seqs[i]], "include": ["mean"]}, "/embed")
                latencies[i] = time.perf_counter() - t
                if not np.isfinite(out["results"][0]["mean_representations"]["33"]).all():
                    raise AssertionError(f"request {i}: non-finite mean")

        before = http_json(srv.url)
        zero_counts()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client) for _ in range(SERVE_CLIENTS)]
        [t.start() for t in threads]
        [t.join() for t in threads]
        wall = time.perf_counter() - t0
        stats = http_json(srv.url)
        if any(x is None for x in latencies):
            raise AssertionError("some /embed requests got no answer")
        lat = sorted(latencies)
        n_batches = stats["batches"] - before["batches"]
        mean_b = (stats["batched_sequences"] - before["batched_sequences"]) / n_batches
        main_rate = MEASURED.get("main_seq_s")
        log(f"[serve] /embed load: {SERVE_REQUESTS} single-sequence requests (lengths "
            f"{SERVE_LENGTHS}, include mean) from {SERVE_CLIENTS} closed-loop clients, "
            f"max_batch_seqs 16, max_wait_ms 20, batch_bucket max: {wall:.3f} s, "
            f"{SERVE_REQUESTS / wall:.3f} seq/s, p50 {1e3 * lat[len(lat) // 2]:.1f} ms, p95 "
            f"{1e3 * lat[int(0.95 * (len(lat) - 1))]:.1f} ms (client side), server p50/p95 "
            f"{stats['latency_embed_p50_ms']:.1f}/{stats['latency_embed_p95_ms']:.1f} ms, "
            f"{n_batches} device batches, mean_batch_seqs {mean_b:.3f} ({card}); [main]'s "
            f"direct forward {main_rate if main_rate is None else f'{main_rate:.3f}'} seq/s "
            f"at B=32 x 1022")
        # one request of 48 sequences: three chunks, each dispatched before
        # the previous chunk's readback (the case the overlap is built for)
        with lock:
            records.append(None)  # no "next" across the two runs
        hold[0] = True
        long_seqs = [random_protein(1022, seed=800 + i) for i in range(48)]
        http_post(srv.url, {"sequences": long_seqs, "include": ["mean", "logits"],
                            "format": "npz"})
        totals = read_counts()
        records = [r for r in records if r is not None]
        want = {"flash_attention": lm.num_layers}
        if count_delta(dict.fromkeys(totals, 0), totals) != {
                "flash_attention": lm.num_layers * len(records)}:
            raise AssertionError(f"launches over the /embed runs {totals}, expected K1 x "
                                 f"{lm.num_layers} x {len(records)} batches only")
        bad = [r["launches"] for r in records if r["launches"] != want]
        overlapped = [r["overlap"] for r in records if r["overlap"] is not None]
        log(f"[serve] {len(records)} device batches: K1 launches a batch "
            f"{sorted({r['launches'].get('flash_attention', 0) for r in records})} and no other "
            f"kernel of the port {'(all)' if not bad else bad}; readback ended before the next "
            f"batch's compute ended: " + " ".join(
                f"b{i}:{r['n']}:{'-' if r['overlap'] is None else 'yes' if r['overlap'] else 'NO'}"
                for i, r in enumerate(records))
            + f" ({sum(overlapped)} of {len(overlapped)} batches with a later batch in flight;"
            f" the 48-sequence request's later chunks held behind {SERVE_HOLD_CYCLES:,} "
            f"cycles of device spin before their readback; host ms dispatch/finalize "
            + " ".join(f"b{i}:{r['dispatch_ms']:.1f}/{r['finalize_ms']:.1f}"
                       for i, r in enumerate(records) if r["overlap"] is not None) + ")")
        if bad:
            raise AssertionError(f"device batches launched {bad}, expected {want} each")
        if not overlapped or not all(overlapped):
            raise AssertionError(f"a readback waited for the next batch: {overlapped}")
        srv._dispatch_embed_chunk, sv._readback = real_dispatch, real_readback

        # ---- agreement: a lone request against a direct call on the batch
        # the server formed (B=1, T padded to 128), bit for bit
        seq = random_protein(500, seed=900)
        payload = {"sequences": [["lone", seq]], "include": ["mean", "logits", "contacts"],
                   "format": "npz"}
        lone = np.load(io.BytesIO(http_post(srv.url, payload)))
        toks, real_b = srv._tokens([("lone", seq)])
        out = lm(toks, repr_layers=(33,), return_contacts=True)
        lens_dev = torch.tensor([len(seq)], device="cuda")
        direct = {"0/mean/33": sv._device_mean(out["representations"][33], lens_dev, 1),
                  "0/logits": out["logits"][:, 1:len(seq) + 1],
                  "0/contacts": out["contacts"][:, :len(seq), :len(seq)]}
        for k, v in direct.items():
            ref = sv._numpy(v[0].cpu())
            if not (lone[k].shape == ref.shape and np.array_equal(lone[k], ref)):
                raise AssertionError(f"lone /embed {k} differs from the direct call: max "
                                     f"{np.abs(lone[k] - ref).max()}")
        log(f"[serve] a lone /embed (L=500: B={toks.shape[0]}, T={toks.shape[1]}) equals a "
            f"direct LMHandle call on that batch bit for bit (mean, logits, contacts)")
        others = [["o%d" % i, random_protein(int(n), seed=950 + i)]
                  for i, n in enumerate(rng.choice(SERVE_LENGTHS, 15))]
        co = np.load(io.BytesIO(http_post(srv.url, {**payload, "sequences": others[:7]
                                                    + [["lone", seq]] + others[7:]})))
        errs = {}
        for k in ("mean/33", "logits", "contacts"):
            a, b = co[f"7/{k}"], lone[f"0/{k}"]
            errs[k] = float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))
        b = lone["0/mean/33"]
        neighbour = min(float(np.abs(co[f"{i}/mean/33"] - b).max() / max(1.0, np.abs(b).max()))
                        for i in range(16) if i != 7)
        log(f"[serve] the same sequence co-batched with 15 others (B=16) against its "
            f"lone answer: max error over the largest magnitude (at least 1) "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f"; bound {SERVE_COBATCH_TOL} (bf16 GEMMs of other shapes); the nearest other "
            f"row's mean is {neighbour:.3e} from it")
        if not max(errs.values()) <= SERVE_COBATCH_TOL:
            raise AssertionError(f"co-batched vs lone: {errs}")
        if not neighbour > SERVE_COBATCH_TOL:
            raise AssertionError(f"another row's mean lies within the bound: {neighbour}")

        # /score against wt_marginal_score on a direct call
        wt = random_protein(300, seed=901)
        muts = [f"{wt[i]}{i + 1}{'A' if wt[i] != 'A' else 'G'}" for i in (0, 57, 150, 299)]
        got = http_json(srv.url, {"sequence": wt, "mutations": muts, "offset_idx": 1},
                        "/score")["results"][0]["scores"]
        toks, _ = srv._tokens([("seq0", wt)])
        logp = sv.log_softmax_np(sv._numpy(lm(toks)["logits"][0].cpu()))
        want_scores = {m: round(wt_marginal_score(logp, int(m[1:-1]) - 1,
                                                  alphabet.get_idx(m[0]),
                                                  alphabet.get_idx(m[-1])), 6) for m in muts}
        log(f"[serve] /score (L=300, 4 mutations): {got}; wt_marginal_score on a direct call "
            f"{'equal' if got == want_scores else want_scores}")
        if got != want_scores:
            raise AssertionError(f"/score {got} != direct {want_scores}")
        del out, direct, lone, co

        # ---- /fold: 4 sequences and a multimer in chunks of 2, one recycle
        fold_seqs = [[f"f{n}", random_protein(n, seed=1100 + n)] for n in (64, 200, 384, 512)]
        fold_seqs.insert(2, ["dimer", random_protein(100, seed=1201) + ":"
                             + random_protein(80, seed=1202)])
        chunk_counts, real_fold = [], srv.fold_model

        class CountingFold:
            def infer(self, seqs, **kw):
                before = read_counts()
                out = real_fold.infer(seqs, **kw)
                chunk_counts.append((len(seqs), count_delta(before, read_counts())))
                return out

            def __getattr__(self, name):
                return getattr(real_fold, name)

        srv.fold_model = CountingFold()
        zero_counts()
        t0 = time.perf_counter()
        res = http_json(srv.url, {"sequences": fold_seqs, "num_recycles": 1},
                        "/fold")["results"]
        fold_wall = time.perf_counter() - t0
        totals = read_counts()
        srv.fold_model = real_fold
        passes = 2
        want = {"flash_attention": fold.cfg.esm.num_layers,
                "triangle_attention_fused": 2 * fold.cfg.trunk.num_blocks * passes}
        log(f"[serve] /fold of 5 sequences (64, 200, 100:80, 384, 512), max_fold_batch_seqs 2, "
            f"num_recycles 1: {fold_wall:.2f} s; launches per chunk {chunk_counts} (want "
            f"{want}: K1 36, K6 96 a pass)")
        if [lab for lab, _ in fold_seqs] != [r["label"] for r in res]:
            raise AssertionError(f"/fold order: {[r['label'] for r in res]}")
        if (len(chunk_counts) != 3 or any(c != want for _, c in chunk_counts)
                or count_delta(dict.fromkeys(totals, 0), totals)
                != {k: 3 * v for k, v in want.items()}):
            raise AssertionError(f"fold chunk launches {chunk_counts} (in all {totals}), "
                                 f"want {want} a chunk")
        worst = [0.0, 0.0, 0.0]
        for r, (lab, s) in zip(res, fold_seqs):
            d = fold.infer([s], num_recycles=1, frugal=True, pad_to_multiple=FOLD_LENGTH_BUCKET)
            real = d["atom37_atom_exists"][0].amax(-1) > 0
            ca = torch.from_numpy(pdb_ca(r["pdb"])[:, :3]).float()
            ca_direct = d["positions"][-1][0][real][:, 1].float().cpu()
            rmsd = (ca - ca_direct).pow(2).sum(-1).mean().sqrt().item()
            dpl = abs(r["mean_plddt"] - d["mean_plddt"].item())
            dtm = abs(r["ptm"] - d["ptm"].item())
            worst = [max(worst[0], rmsd), max(worst[1], dpl), max(worst[2], dtm)]
            if not (r["length"] == ca.shape[0] and rmsd <= FOLD_CA_RMSD and dpl <= FOLD_PLDDT
                    and dtm <= FOLD_PTM):
                raise AssertionError(f"/fold {lab}: length {r['length']} CA {ca.shape}, "
                                     f"CA-RMSD {rmsd}, pLDDT {dpl}, pTM {dtm}")
        log(f"[serve] /fold results in request order; against a direct infer of each sequence "
            f"alone: worst CA-RMSD {worst[0]:.4f} A, |d mean pLDDT| {worst[1]:.4f}, |d pTM| "
            f"{worst[2]:.5f} (bounds {FOLD_CA_RMSD} A, {FOLD_PLDDT}, {FOLD_PTM})")

        # ---- the fold cost fit and the memory-plan check: one pass a bucket
        fold_bytes = param_bytes(fold.model)
        seconds, rows = {}, []
        fold.infer(["A" * 256], num_recycles=0, frugal=True)  # warm
        for bucket in FOLD_COST_BUCKETS:
            s = random_protein(bucket, seed=1300 + bucket)
            times = []
            # the median of 3 passes below 2048 (the short ones are host-bound
            # and vary most); the memory of the first
            for rep in range(3 if bucket < 2048 else 1):
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                out = fold.infer([s], num_recycles=0, frugal=True,
                                 pad_to_multiple=FOLD_LENGTH_BUCKET)
                float(out["ptm"][0])
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                del out
                if rep == 0:
                    reserved = torch.cuda.max_memory_reserved()
            seconds[bucket] = float(np.median(times))
            held = reserved - other_bytes
            plan = plan_fold(fold.cfg, bucket, params_bytes=fold_bytes, frugal=True,
                             device="cuda")
            rows.append((bucket, held, plan["per_device_bytes"]))
            log(f"[serve] fold B=1 L={bucket}, one pass: {seconds[bucket]:.4f} s (of "
                f"{', '.join(f'{x:.4f}' for x in times)}); the fold holds {held / 1e9:.3f} GB "
                f"(max_memory_reserved {reserved / 1e9:.3f} GB "
                f"less {other_bytes / 1e9:.3f} GB of ESM-2 and IF1 weights), plan_fold "
                f"{plan['per_device_bytes'] / 1e9:.3f} GB ({plan['verdict']}; held / plan "
                f"{held / plan['per_device_bytes']:.3f}, limit {1 / PLAN_SHARE:.3f})")
        coef, unit, errs = fit_fold_cost(seconds)
        committed = np.array([srv._FOLD_UNIT_L2, srv._FOLD_UNIT_L3, srv._FOLD_UNIT_FIXED])
        y = np.array(sorted(seconds), float) / 512
        p = np.stack([y ** 2, y ** 3, np.ones_like(y)], 1) @ committed
        t = np.array([seconds[b] for b in sorted(seconds)])
        steady = np.isin(sorted(seconds), FOLD_COST_HELD)
        c_unit = min((np.max(np.abs(u * p[steady] / t[steady] - 1)), u) for u in np.linspace(
            0.5 * t[1], 1.5 * t[1], 2001))[1]  # the unit of least largest error there
        c_errs = {b: c_unit * pi / ti - 1 for b, pi, ti in zip(sorted(seconds), p, t)}
        log(f"[serve] fold cost fit (least largest relative error, normalized to the 512 "
            f"bucket): "
            f"_FOLD_UNIT_L2 {coef[0]:.4f}, _FOLD_UNIT_L3 {coef[1]:.4f}, _FOLD_UNIT_FIXED "
            f"{coef[2]:.4f}, unit {unit:.6f} s; errors "
            + ", ".join(f"{b}: {100 * e:+.2f}%" for b, e in errs.items())
            + f"; the server's constants {tuple(float(x) for x in committed)} at their best "
            f"unit over {FOLD_COST_HELD} {c_unit:.6f} s: "
            + ", ".join(f"{b}: {100 * e:+.2f}%" for b, e in c_errs.items())
            + f" (held within {100 * FOLD_COST_TOL:.0f}% at {FOLD_COST_HELD}; the shorter "
            f"passes follow the host); pass times "
            f"{json.dumps({b: seconds[b] for b in sorted(seconds)})}")
        if any(abs(c_errs[b]) > FOLD_COST_TOL for b in FOLD_COST_HELD):
            raise AssertionError(f"the server's fold cost constants are off the card's pass "
                                 f"times: {c_errs}")
        over = [(b, h, pl) for b, h, pl in rows if h > pl / PLAN_SHARE]
        if over:
            raise AssertionError(f"folds hold more than plan / {PLAN_SHARE}: {over}")
        caps = {b: max_fold_length(fold.cfg, params_bytes=fold_bytes, frugal=True,
                                   held_outputs=2, batch=b, device="cuda") for b in (1, 2, 4)}
        log(f"[serve] memory plan: every measured fold within plan / {PLAN_SHARE}; derived cap "
            f"(ESMFold v1 bf16, {fold_bytes / 1e9:.3f} GB of weights, frugal, two outputs held) "
            f"at max_fold_batch_seqs 1/2/4: {caps[1]}/{caps[2]}/{caps[4]} on "
            f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.2f} GB; the server's "
            f"default cap (max_fold_batch_seqs 2) {srv.max_fold_seq_len}")
        if srv.max_fold_seq_len != caps[2]:
            raise AssertionError(f"the server's default fold cap {srv.max_fold_seq_len} is not "
                                 f"the plan's {caps[2]}")

        # ---- /design: 1 and 8 samples at L=250, and the score path
        coords = ideal_backbone(250, seed=1400)
        for n in (1, 8):
            t0 = time.perf_counter()
            r = http_json(srv.url, {"coords": coords.tolist(), "seed": 5, "num_samples": n},
                          "/design")["results"][0]
            sec = time.perf_counter() - t0
            direct_s = if1.sample(coords, seed=5, num_samples=n, pad_to_multiple=16)
            direct_s = [direct_s] if n == 1 else direct_s
            log(f"[serve] /design L=250, {n} sample(s): {sec:.3f} s, {250 * n / sec:.1f} "
                f"residues/s; equal to IFHandle.sample (seed 5, bucket 16): "
                f"{r['sequences'] == direct_s}")
            if r["sequences"] != direct_s:
                raise AssertionError(f"/design {n} samples differ from the direct sample")
        seq = random_protein(250, seed=1401)
        r = http_json(srv.url, {"coords": coords.tolist(), "seq": seq}, "/design")["results"][0]
        ll = tuple(round(x, 6) for x in if1.score_sequence(coords, seq))
        log(f"[serve] /design score path: ll_fullseq {r['ll_fullseq']}, ll_withcoord "
            f"{r['ll_withcoord']} (direct score_sequence {ll})")
        if (r["ll_fullseq"], r["ll_withcoord"]) != ll:
            raise AssertionError(f"/design score {r} != direct {ll}")

        # the learned cost units of a normal serving window (the priors),
        # before the profiler's overhead enters them
        stats = http_json(srv.url)
        log(f"[serve] /stats learned cost units before /profile {stats['cost_unit_s']} "
            f"(priors {sv._COST_PRIORS})")

        # ---- /profile: a 3 s capture under /embed load
        stop = threading.Event()

        def load():
            i = 0
            while not stop.is_set():
                http_json(srv.url, {"sequences": [seqs[i % len(seqs)]]}, "/embed")
                i += 1

        # several captures: captures have held no kernel at all, which the
        # server now takes again (its "attempts")
        loaders = [threading.Thread(target=load) for _ in range(4)]
        [t.start() for t in loaders]
        time.sleep(0.5)
        try:
            for capture in range(SERVE_PROFILES):
                with tempfile.TemporaryDirectory() as tmp:
                    t0 = time.perf_counter()
                    prof = http_json(srv.url, {"seconds": 3, "dir": tmp}, "/profile")
                    sec = time.perf_counter() - t0
                    with open(os.path.join(tmp, "trace.json")) as f:
                        events = json.load(f)["traceEvents"]
                cats = collections.Counter(e.get("cat") for e in events)
                kernels = [e for e in events if e.get("cat") == "kernel"]
                k1 = [e for e in kernels if "flash_fwd_bf16" in e.get("name", "")]
                log(f"[serve] /profile {capture + 1} of {SERVE_PROFILES}: {prof['batches']} "
                    f"device batches in {sec:.2f} s ({prof['attempts']} of "
                    f"{srv.PROFILE_ATTEMPTS} windows) under /embed load: {len(events)} trace "
                    f"events ({cats.get('cpu_op', 0)} CPU operators, "
                    f"{cats.get('cuda_runtime', 0)} CUDA runtime calls), {len(kernels)} kernels, "
                    f"{len(k1)} of K1 ({k1[0]['name'][:60] if k1 else '-'})")
                if not k1:
                    raise AssertionError("the /profile trace names no K1 kernel")
        finally:
            stop.set()
            [t.join() for t in loaders]

        stats = http_json(srv.url)
        log(f"[serve] /stats learned cost units after /profile {stats['cost_unit_s']}; requests {stats['requests']}, errors {stats['errors']}, "
            f"rejected {stats['rejected']}, latency p50/p95 {stats['latency_p50_ms']}/"
            f"{stats['latency_p95_ms']} ms")
    finally:
        srv.stop()
    del lm, if1, srv
    torch.cuda.empty_cache()
    log(f"[serve] took {time.perf_counter() - t_phase:.1f} s")


def phase_cli_serve():
    """python -m esm_tpu_torch.cli.serve as a process on the card with a
    save_esm2 checkpoint (6 x 320) in a temporary ESM_TPU_CACHE, --bf16
    --flash: its /embed answer against the in-process handle, then SIGINT."""
    import signal

    import torch
    from esm_tpu_torch import pretrained
    from esm_tpu_torch.io.export import save_esm2
    from esm_tpu_torch.runtime import server as sv
    from esm_tpu_torch.utils.device import host_to_device

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    handle, _ = pretrained.random_model_and_alphabet("esm2_t6_8M_UR50D", seed=1500,
                                                     device="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        path, _ = save_esm2(handle.model, os.path.join(tmp, "esm2_t6_8M_UR50D.pt"))
        env = dict(os.environ, ESM_TPU_CACHE=tmp, PYTHONUNBUFFERED="1",
                   PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
        proc = subprocess.Popen(
            [sys.executable, "-m", "esm_tpu_torch.cli.serve", "esm2_t6_8M_UR50D", "--port", "0",
             "--bf16", "--flash", "--max-wait-ms", "20"],
            cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            url, lines, deadline = None, [], time.monotonic() + 300
            while url is None and time.monotonic() < deadline:
                line = proc.stdout.readline()
                if not line:
                    break
                lines.append(line)
                if " on http://" in line:
                    url = line.split(" on ")[1].split()[0]
            if url is None:
                raise AssertionError("the serve CLI did not start:\n" + "".join(lines))
            seqs = [random_protein(n, seed=1500 + n) for n in (120, 300)]
            got = np.load(io.BytesIO(http_post(url, {
                "sequences": seqs, "include": ["mean", "logits"], "format": "npz"})))
            model = pretrained.load_model_and_alphabet(path, device="cuda")[0].with_options(
                compute_dtype=torch.bfloat16, use_flash=True)
            conv = model.alphabet.get_batch_converter(1022, pad_to_multiple=128)
            toks = host_to_device(sv._pad_batch_rows(
                np.asarray(conv([("a", s) for s in seqs])[2]), 16)[0], torch.device("cuda"))
            out = model(toks, repr_layers=(6,))
            lens = torch.tensor([len(s) for s in seqs] + [1] * (toks.shape[0] - 2),
                                device="cuda")
            mean = sv._numpy(sv._device_mean(out["representations"][6], lens, 1).cpu())
            logits = out["logits"].cpu().numpy()
            for i, s in enumerate(seqs):
                if not (np.array_equal(got[f"{i}/mean/6"], mean[i])
                        and np.array_equal(got[f"{i}/logits"], logits[i, 1:len(s) + 1])):
                    raise AssertionError(f"serve CLI /embed row {i} differs from the handle")
            proc.send_signal(signal.SIGINT)
            tail, _ = proc.communicate(timeout=60)
            if proc.returncode != 0:
                raise AssertionError(f"serve CLI exited {proc.returncode}: {tail}")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    log(f"[cli-serve] python -m esm_tpu_torch.cli.serve esm2_t6_8M_UR50D --bf16 --flash (a "
        f"save_esm2 checkpoint in ESM_TPU_CACHE) on the card: /embed of 2 sequences (B=16 "
        f"'max' bucket, T=384) equals the in-process handle's call on that batch bit for bit "
        f"(mean, logits); stopped by SIGINT, exit 0; {time.perf_counter() - t_phase:.1f} s")


def pdb_ca(pdb):
    """(n, 4) x, y, z and B-factor (the pLDDT) of a PDB text's CA atoms."""
    return np.array([[float(line[i:i + w]) for i, w in ((30, 8), (38, 8), (46, 8), (60, 6))]
                     for line in pdb.splitlines()
                     if line.startswith("ATOM") and line[12:16] == " CA "])


@contextlib.contextmanager
def k1_shapes():
    """Records (T, S, rotary) of every K1 launch made inside the block (the
    query and key lengths K1's wrapper is handed)."""
    from esm_tpu_torch.kernels import flash_attention as fa

    shapes, forward = [], fa._forward

    def recording(q, k, v, key_padding_mask, rotary, with_lse):
        shapes.append((q.shape[2], k.shape[2], rotary))
        return forward(q, k, v, key_padding_mask, rotary, with_lse)

    fa._forward = recording
    try:
        yield shapes
    finally:
        fa._forward = forward


def drive_k1(tag, what, flash, tokens, n_layers, want_s):
    """One flash forward with the counts zeroed just before and read just
    after: K1 must launch once a layer, at S = ``want_s`` keys and no rotary,
    and nothing else may launch. Returns (logits, launches)."""
    import torch

    zero_counts()
    with k1_shapes() as shapes:
        logits = flash(tokens)["logits"]
        torch.cuda.synchronize()
    counts = read_counts()
    launches = counts["flash_attention"]
    t = tokens.shape[1]
    log(f"[{tag}] {what} bf16 flash forward B={tokens.shape[0]} T={t}: K1 launched {launches} "
        f"times ({n_layers} layers) at (T, S, rotary) {sorted(set(shapes))}; all counts {counts}")
    if launches != n_layers or sum(counts.values()) != launches:
        raise AssertionError(f"[{tag}] launches {counts}, expected K1 x {n_layers} only")
    if set(shapes) != {(t, want_s, False)}:
        raise AssertionError(f"[{tag}] K1 shapes {set(shapes)}, expected {(t, want_s, False)}")
    return logits, launches


def phase_esm1(card):
    """The ESM-1 family at its released sizes, seeded random weights, bf16,
    through LMHandle: ESM-1b (esm1b_t33_650M_UR50S) and ESM-1v
    (esm1v_t33_650M_UR90S_1, token dropout, <mask> tokens in the batch) at
    B=32, L=1022 (1024 tokens), K1 once a layer at S = T; ESM-1
    (esm1_t34_670M_UR50S) at T = 1023 (no eos), K1 once a layer at S = T + 1.
    Flash against exact (and, for ESM-1b, an fp32 forward), seq/s of both
    paths; ESM-1's streaming contacts against the stacked ones. Returns the
    K1 launches of the ESM-1b and ESM-1 forwards."""
    import torch
    from esm_tpu_torch import pretrained

    B, L = 32, 1022
    bf16 = dict(compute_dtype=torch.bfloat16)
    launches = {}

    handle, alphabet = pretrained.random_model_and_alphabet("esm1b_t33_650M_UR50S", seed=20,
                                                            device="cuda")
    flash, exact = handle.with_options(use_flash=True, **bf16), handle.with_options(**bf16)
    tokens = torch.from_numpy(bench_tokens(alphabet, B, L, seed=21)).cuda()
    logits, launches["esm1b"] = drive_k1("esm1", "ESM-1b 650M", flash, tokens,
                                         handle.num_layers, tokens.shape[1])
    hold_flash("esm1", logits, exact(tokens)["logits"], f32_logits(handle, tokens))
    seq_rates("esm1", f"ESM-1b 650M bf16, B={B}, L={L}; {card}", flash, exact, tokens)
    del handle, flash, exact, logits

    handle, alphabet = pretrained.random_model_and_alphabet("esm1v_t33_650M_UR90S_1", seed=22,
                                                            device="cuda")
    flash, exact = handle.with_options(use_flash=True, **bf16), handle.with_options(**bf16)
    toks = bench_tokens(alphabet, B, L, seed=23)
    masked = np.random.RandomState(24).rand(B, L) < 0.15
    toks[:, 1:L + 1][masked] = alphabet.mask_idx
    tokens = torch.from_numpy(toks).cuda()
    logits, _ = drive_k1("esm1", f"ESM-1v 650M ({int(masked.sum())} <mask> tokens)", flash,
                         tokens, handle.num_layers, tokens.shape[1])
    hold_flash("esm1", logits, exact(tokens)["logits"])
    del handle, flash, exact, logits

    handle, alphabet = pretrained.random_model_and_alphabet("esm1_t34_670M_UR50S", seed=25,
                                                            device="cuda")
    flash, exact = handle.with_options(use_flash=True, **bf16), handle.with_options(**bf16)
    tokens = torch.from_numpy(bench_tokens(alphabet, B, L, seed=26)).cuda()
    logits, launches["esm1"] = drive_k1("esm1", "ESM-1 670M (bias_kv)", flash, tokens,
                                        handle.num_layers, tokens.shape[1] + 1)
    hold_flash("esm1", logits, exact(tokens)["logits"])
    seq_rates("esm1", f"ESM-1 670M bf16, B={B}, L={L}; {card}", flash, exact, tokens)
    del flash, exact, logits
    torch.cuda.empty_cache()

    # streaming contacts (one layer's maps at a time, the bias_kv column
    # stripped in the loop) against the stacked ones, fp32 with TF32 off:
    # the same maps summed in another order, 1e-4 on the probabilities
    gen = torch.Generator(device="cuda").manual_seed(27)
    with torch.no_grad():
        reg = handle.model.contact_head.regression
        reg.weight.normal_(generator=gen).mul_(0.1)
        reg.bias.fill_(-1.0)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        small = tokens[:2]
        streamed = handle(small, return_contacts=True)["contacts"]
        stacked = handle(small, need_head_weights=True, return_contacts=True)["contacts"]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    err = (streamed - stacked).abs().max().item()
    log(f"[esm1] ESM-1 contacts, fp32, B=2 T={small.shape[1]}: streaming vs stacked max abs err "
        f"{err:.2e} <= 1e-4; shape {tuple(streamed.shape)}")
    if not (err <= 1e-4 and streamed.shape == (2, L, L) and torch.isfinite(streamed).all()):
        raise AssertionError(f"[esm1] streaming contacts err {err}, shape {streamed.shape}")
    del handle, streamed, stacked
    torch.cuda.empty_cache()
    return launches


def measure_k1_esm1(launches):
    """K1 at the ESM-1 family's shapes, no rotary: ESM-1b's B=32 H=20 T=S=1024
    and ESM-1's T=1023, S=1024 (the bias_kv key), d=64, bf16, with an
    all-False key-padding mask as those paths pass it."""
    import torch
    import torch.nn.functional as F
    from esm_tpu_torch.kernels import flash_attention as fa

    entries = []
    gen = torch.Generator(device="cuda").manual_seed(28)
    for path, t, s in (("esm1b", 1024, 1024), ("esm1", 1023, 1024)):
        B, H, d = 32, 20, 64
        q, k, v, _ = attention_inputs(B, H, t, d, torch.bfloat16, False, gen, s=s)
        mask = torch.zeros(B, s, dtype=torch.bool, device="cuda")
        kernel = lambda: fa.flash_attention(q, k, v, key_padding_mask=mask)
        plain = lambda: fa.flash_attention_reference(q, k, v, key_padding_mask=mask)
        library = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=~mask[:, None, None],
                                                         scale=1.0)
        err = (kernel().float() - plain().float()).abs().max().item()
        ms, plain_ms, lib_ms = cuda_time_ms(kernel), cuda_time_ms(plain), cuda_time_ms(library)
        flops = 4 * B * H * t * s * d
        bound, by = attention_bound_ms(flops, 2 * B * H * (t + s) * d * 2 + B * s)
        log(f"[k1-{path}] B={B} H={H} T={t} S={s} d={d} bf16 no rotary: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, scaled_dot_product_attention {lib_ms:.4f} ms, bound "
            f"{bound:.4f} ms; {flops / ms / 1e9:.1f} TFLOP/s; kernel / library {ms / lib_ms:.3f}; "
            f"{launches[path]} launches a forward; max abs err {err:.3e}")
        if not err <= BF16_TOL:
            raise AssertionError(f"K1 at the {path} shape: max abs err {err} > {BF16_TOL}")
        entries.append({"name": f"flash_attention/{path}", "route": "cuda",
                        "source": "esm_tpu_torch/csrc/flash_attention.cu",
                        "replaces": "esm_tpu/kernels/flash_attention.py:394",
                        "launches": launches[path], "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                        "library_ms": lib_ms})
    return entries


def seeded_msa(rows, length, seed, first=None):
    """An aligned MSA: a query row (``first`` or random residues) and rows that
    differ from it at ~30% of the columns (residues and gaps)."""
    rng = np.random.RandomState(seed)
    aas = list("ACDEFGHIKLMNPQRSTVWY")
    query = np.array(list(first)) if first else rng.choice(aas, length)
    msa = [("query", "".join(query))]
    for i in range(1, rows):
        row = query.copy()
        sub = rng.rand(length) < 0.3
        row[sub] = rng.choice(aas + ["-"], int(sub.sum()))
        msa.append((f"r{i}", "".join(row)))
    return msa


def phase_msa(card):
    """The MSA Transformer (esm_msa1b_t12_100M_UR50S, 12 x 768, 12 heads,
    seeded random weights) on a seeded MSA of R=400 rows x C=257 tokens: R*C
    is past max_tokens_per_msa (2^14), so the row logits are summed over
    63-row chunks and the columns run 40 at a time; held against the
    unchunked forward in fp32 (TF32 off), and the bf16 forward against fp32.
    Time and peak memory of the forward. No kernel of the port is on this
    path (the JAX package has none for it)."""
    import torch
    from esm_tpu_torch import pretrained

    R, C = 400, 256
    handle, alphabet = pretrained.random_model_and_alphabet("esm_msa1b_t12_100M_UR50S", seed=30,
                                                            device="cuda")
    tokens = alphabet.get_batch_converter()([seeded_msa(R, C, seed=31)])[2].cuda()
    whole = handle.with_options(max_tokens_per_msa=tokens.numel())
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    zero_counts()
    try:
        chunked = handle(tokens, repr_layers=[-1])
        unchunked = whole(tokens, repr_layers=[-1])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    scale = unchunked["logits"].abs().max().item()
    err = max((chunked["logits"] - unchunked["logits"]).abs().max().item() / scale,
              rel_err(chunked["representations"][handle.num_layers],
                      unchunked["representations"][handle.num_layers]))
    log(f"[msa] MSA-1b fp32 (TF32 off), B=1 R={R} C={C + 1}: chunked (rows "
        f"{2 ** 14 // (C + 1)}, columns {2 ** 14 // R}) vs unchunked logits and last representation: max err {err:.2e} <= 1e-4 of the largest "
        f"value (max |logit| {scale:.2f})")
    if not err <= 1e-4:
        raise AssertionError(f"[msa] chunked vs unchunked: err {err}")

    bf16 = handle.with_options(compute_dtype=torch.bfloat16)
    logits16 = bf16(tokens)["logits"]
    f32 = chunked["logits"]
    diff = (logits16 - f32).abs().max().item()
    agree = (logits16.argmax(-1) == f32.argmax(-1)).float().mean().item()
    log(f"[msa] bf16 vs fp32 logits: max abs err {diff:.4f} (max |logit| {scale:.2f}), argmax "
        f"agreement {agree:.5f}")
    # bf16 rounds every product and activation (~0.4% each) through 12
    # layers: within 5% of the logit range, the same token at >= 95% of
    # the positions
    if not (torch.isfinite(logits16).all() and diff <= 0.05 * scale and agree >= 0.95):
        raise AssertionError(f"[msa] bf16 vs fp32: err {diff}, agreement {agree}")
    del chunked, unchunked, logits16, f32
    for name, h in (("bf16", bf16), ("fp32", handle)):
        h(tokens)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(3):
            h(tokens)["logits"]
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / 3
        log(f"[msa] {name} forward B=1 R={R} C={C + 1}: {sec * 1e3:.1f} ms, "
            f"{R * (C + 1) / sec:.0f} tokens/s, peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB (torch.cuda.max_memory_allocated; "
            f"{card})")
    profile("one MSA-1b bf16 forward (R=400, C=257)", lambda: bf16(tokens), top=10, by_op=True)
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"[msa] a kernel launched on the MSA path: {counts}")
    del handle, bf16, whole
    torch.cuda.empty_cache()


# esm-predict-variants card vs CPU (fp32 on both, TF32 off), absolute bounds
# on the scores: a marginal score is a difference of two log-probs, each
# within ~2e-4 of fp64 on the CPU at this shape (the seeded 6-layer ESM-1v
# puts log-probs near -70 to -230); a pseudo-ppl score sums ~248 of them
VARIANT_TOL = 2e-3
PPPL_TOL = 1e-2
PPPL_CPU_ROWS = 1  # pseudo-ppl runs ~15 TFLOP a mutant, ~41 s on the CPU: the first row
# rows of the masked-marginals MSA: its CPU run takes one MSA-1b forward a
# position (250), most of [cli-variants]' time (the ensemble's CPU run took
# 56.9 s at 64 rows on the H100 machine's host)
VARIANT_MSA_ROWS = 16


def seeded_lm_checkpoint(tmp, name, size, layers, seed):
    """A full-width ESM-1b-family checkpoint cut to ``layers`` layers, seeded
    random weights (the <mask> row zero, as the v1 loader makes it; a random
    contact regression), written by save_esm1b. Returns its path."""
    import torch
    from esm_tpu_torch.data import Alphabet
    from esm_tpu_torch.io.export import save_esm1b
    from esm_tpu_torch.models import esm1

    cfg = esm1.ESM1Config.from_alphabet(Alphabet.from_architecture("ESM-1b"),
                                        **dict(esm1.ESM1_SIZES[size], num_layers=layers))
    model = esm1.init(cfg, torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    with torch.no_grad():
        model.embed_tokens.weight[cfg.mask_idx] = 0
        model.contact_head.regression.weight.normal_(generator=gen).mul_(0.1)
        model.contact_head.regression.bias.fill_(-1.0)
    path = os.path.join(tmp, name)
    save_esm1b(model, path)
    return path


def run_variants(argv, where):
    """esm_tpu_torch.cli.predict_variants on the card or (--nogpu) the CPU, TF32
    off. Returns (header, rows, printed lines, seconds)."""
    import csv

    import torch
    from esm_tpu_torch.cli import predict_variants

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            predict_variants.run(predict_variants.create_parser().parse_args(
                argv + (["--nogpu"] if where == "cpu" else [])))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    seconds = time.perf_counter() - t0
    out = argv[argv.index("--dms-output") + 1]
    with open(out, newline="") as f:
        table = list(csv.reader(f))
    return table[0], table[1:], buf.getvalue().splitlines(), seconds


def phase_cli_variants():
    """esm-predict-variants (esm_tpu_torch.cli.predict_variants) on the card
    against --nogpu runs of the same command: a seeded 250-residue sequence,
    a seeded DMS of 40 single mutants (two at each of 20 sites) with a
    measurement column; an ESM-1v-shaped checkpoint (full width, 3 of its 33
    layers) for wt-marginals, masked-marginals and pseudo-ppl; an MSA-1b-shaped
    one (full width, 2 of its 12 layers, save_msa) with masked-marginals over a
    seeded a3m of VARIANT_MSA_ROWS rows with lower-case insertions and '.'
    characters, both
    models in one run with --eval-column (the ensemble). No pandas."""
    import csv

    import torch
    from esm_tpu_torch.data import Alphabet
    from esm_tpu_torch.io.export import save_msa
    from esm_tpu_torch.models import msa_transformer as msa

    if "pandas" in sys.modules:
        raise AssertionError("pandas is imported")
    L, n_sites = 250, 20
    rng = np.random.RandomState(40)
    aas = list("ACDEFGHIKLMNPQRSTVWY")
    seq = "".join(rng.choice(aas, L))
    sites = sorted(rng.choice(np.arange(1, L + 1), n_sites, replace=False))
    mutants = [f"{seq[site - 1]}{site}{mt}" for site in sites
               for mt in rng.choice([a for a in aas if a != seq[site - 1]], 2, replace=False)]
    with tempfile.TemporaryDirectory() as tmp:
        dms = os.path.join(tmp, "dms.csv")
        with open(dms, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["mutant", "DMS_score"])
            w.writerows([m, f"{rng.randn():.5f}"] for m in mutants)
        dms_head = os.path.join(tmp, "dms_head.csv")
        with open(dms, newline="") as f, open(dms_head, "w", newline="") as g:
            g.writelines(f.readlines()[:1 + PPPL_CPU_ROWS])
        esm1v = seeded_lm_checkpoint(tmp, "esm1v_t3_seeded.pt", "esm1v_t33_650M_UR90S_1", 3,
                                     seed=41)
        mcfg = msa.MSATransformerConfig.from_alphabet(
            Alphabet.from_architecture("msa_transformer"),
            **dict(msa.MSA_SIZES["esm_msa1b_t12_100M_UR50S"], num_layers=2))
        msa_ckpt, _ = save_msa(msa.init(mcfg, torch.Generator(device="cuda").manual_seed(42),
                                        device="cuda"), os.path.join(tmp, "esm_msa1b_t2_seeded.pt"))
        a3m = os.path.join(tmp, "seeded.a3m")
        with open(a3m, "w") as f:
            msa_rows = seeded_msa(VARIANT_MSA_ROWS, L, seed=43, first=seq)
            for i, (label, row) in enumerate(msa_rows):
                if i:  # insertions relative to the query: lower case and '.'
                    cut = 20 + 3 * i
                    row = row[:cut] + "gak" + row[cut:cut + 50] + ".." + row[cut + 50:]
                f.write(f">{label}\n{row}\n")

        def argv(models, strategy, out, dms_in, *extra):
            return ["--model-location", *models, "--sequence", seq, "--dms-input", dms_in,
                    "--dms-output", os.path.join(tmp, out), "--offset-idx", "1",
                    "--scoring-strategy", strategy, *extra]

        ensemble = ["--msa-path", a3m, "--eval-column", "DMS_score"]
        runs = [  # (what, models, strategy, extra flags, the CPU run's DMS, bound)
            ("masked-marginals, ESM-1v + MSA-1b ensemble", [esm1v, msa_ckpt], "masked-marginals",
             ensemble, dms, VARIANT_TOL),
            ("wt-marginals, ESM-1v", [esm1v], "wt-marginals", [], dms, VARIANT_TOL),
            ("pseudo-ppl, ESM-1v", [esm1v], "pseudo-ppl", [], dms_head, PPPL_TOL),
        ]
        card_scores = {}
        for i, (what, models, strategy, extra, cpu_dms, tol) in enumerate(runs):
            header, rows, printed, sec = run_variants(
                argv(models, strategy, f"card{i}.csv", dms, *extra), "cuda")
            card_scores[what] = [float(r[3]) for r in rows]
            cheader, crows, cprinted, csec = run_variants(
                argv(models, strategy, f"cpu{i}.csv", cpu_dms, *extra), "cpu")
            scores = np.asarray([[float(x) for x in r[3:]] for r in rows])
            cscores = np.asarray([[float(x) for x in r[3:]] for r in crows])
            err = np.abs(scores[:len(crows)] - cscores).max()
            for line in printed:
                log(f"[cli-variants] card: {line}")
            log(f"[cli-variants] {what}: {len(rows)} mutants on the card in {sec:.1f} s, "
                f"{len(crows)} on the CPU in {csec:.1f} s; columns {header}; card vs CPU max abs "
                f"err {err:.2e} <= {tol}")
            if not (header == cheader == ["", "mutant", "DMS_score", *models]
                    and len(rows) == len(mutants)
                    and [r[:3] for r in rows[:len(crows)]] == [r[:3] for r in crows]
                    and np.isfinite(scores).all() and err <= tol):
                raise AssertionError(f"[cli-variants] {what}: card and CPU runs disagree "
                                     f"(err {err}, header {header} / {cheader})")
            if extra:  # |rho| of each model and of the ensemble, card against CPU
                rho = [float(x) for x in re.findall(r"= ([0-9.]+)$", "\n".join(printed), re.M)]
                crho = [float(x) for x in re.findall(r"= ([0-9.]+)$", "\n".join(cprinted), re.M)]
                if not (len(rho) == len(crho) == 3 and np.allclose(rho, crho, atol=1e-3)):
                    raise AssertionError(f"[cli-variants] {what}: |rho| {rho} vs CPU {crho}")

        # --int8 on the card against the run without it (random small weights: no bound)
        from esm_tpu_torch.metrics import spearman

        header, rows, _, sec = run_variants(
            argv([esm1v], "wt-marginals", "card_int8.csv", dms, "--int8"), "cuda")
        q = np.asarray([float(r[3]) for r in rows])
        ref = np.asarray(card_scores["wt-marginals, ESM-1v"])
        if not (len(q) == len(ref) and np.isfinite(q).all()):
            raise AssertionError(f"[cli-variants] --int8: {len(q)} scores, finite "
                                 f"{np.isfinite(q).all()}")
        log(f"[cli-variants] wt-marginals, ESM-1v, --int8 on the card in {sec:.1f} s: largest "
            f"score difference from the run without it {np.abs(q - ref).max():.4f} (scores up "
            f"to {np.abs(ref).max():.3f}), Spearman over the {len(q)} mutants "
            f"{spearman(q, ref):.4f}")


# ESM-IF1 card vs CPU (fp32 on both, TF32 off): the encoder output, the
# logits and the decode's step logits as a share of the largest value (GEMMs
# and reductions in other orders through 4 GVP and 16 transformer layers);
# the average log-likelihoods absolutely (sums of ~500 log-probs, divided by
# the count); the sampling distribution by total variation (20,000 draws:
# sampling noise alone is ~0.01 there)
IF1_TOL = 1e-4
IF1_SCORE_TOL = 1e-4
IF1_TV = 0.03
IF1_PARAMS = 141_662_150  # esm_if1_gvp4_t16_142M_UR50, counted from esm_tpu's init shapes
IF1_CPU_ROWS = 3  # the CPU reference of [cli-if] scores the first 3 of 10 variants


def ideal_backbone(length, seed, gap=None, offset=(0.0, 0.0, 0.0)):
    """(length, 3, 3) N/CA/C built atom by atom (NeRF) from ideal bond lengths
    (N-CA 1.458, CA-C 1.525, C-N 1.329 A) and angles (N-CA-C 111.2, CA-C-N
    116.2, C-N-CA 121.7 degrees) and seeded torsions: phi/psi in runs of 4-14
    residues around the helix (-57, -47) or strand (-119, 113) basins with
    8-degree spread, omega around 180 with 4. (An exactly planar omega would
    put the dihedral features' sign(0) at the mercy of rounding: they jump
    from cos 1 to cos -1 there, in the reference too.) NaN rows at ``gap``
    (a slice), as a structure's missing residues read back."""
    rng = np.random.RandomState(seed)
    phi, psi = np.empty(length), np.empty(length)
    i = 0
    while i < length:
        n = min(rng.randint(4, 15), length - i)
        centre = (-57.0, -47.0) if rng.rand() < 0.5 else (-119.0, 113.0)
        phi[i:i + n] = centre[0] + 8.0 * rng.randn(n)
        psi[i:i + n] = centre[1] + 8.0 * rng.randn(n)
        i += n
    phi, psi = np.radians(phi), np.radians(psi)
    omega = np.radians(180.0 + 4.0 * rng.randn(length))

    def place(a, b, c, bond, angle, torsion):
        bc = (c - b) / np.linalg.norm(c - b)
        n = np.cross(b - a, bc)
        n /= np.linalg.norm(n)
        d = (-bond * np.cos(angle), bond * np.sin(angle) * np.cos(torsion),
             bond * np.sin(angle) * np.sin(torsion))
        return c + d[0] * bc + d[1] * np.cross(n, bc) + d[2] * n

    ang = {k: np.radians(v) for k, v in (("ncac", 111.2), ("cacn", 116.2), ("cnca", 121.7))}
    out = np.zeros((length, 3, 3))
    out[0, 1] = (1.458, 0.0, 0.0)
    out[0, 2] = out[0, 1] + 1.525 * np.array([-np.cos(ang["ncac"]), np.sin(ang["ncac"]), 0.0])
    for i in range(1, length):
        n0, ca0, c0 = out[i - 1]
        out[i, 0] = place(n0, ca0, c0, 1.329, ang["cacn"], psi[i - 1])
        out[i, 1] = place(ca0, c0, out[i, 0], 1.458, ang["cnca"], omega[i])
        out[i, 2] = place(c0, out[i, 0], out[i, 1], 1.525, ang["ncac"], phi[i])
    out = (out + np.asarray(offset)).astype(np.float32)
    if gap is not None:
        out[gap] = np.nan
    return out


def write_backbone(path, chains, fmt):
    """Writes {chain id: (coords, sequence)} as PDB or mmCIF ATOM records of
    N/CA/C; NaN atoms are left out (a residue with none is missing)."""
    three = {v: k for k, v in {"ALA": "A", "CYS": "C", "ASP": "D", "GLU": "E", "PHE": "F",
                                "GLY": "G", "HIS": "H", "ILE": "I", "LYS": "K", "LEU": "L",
                                "MET": "M", "ASN": "N", "PRO": "P", "GLN": "Q", "ARG": "R",
                                "SER": "S", "THR": "T", "VAL": "V", "TRP": "W",
                                "TYR": "Y"}.items()}
    rows = [(chain, i + 1, three[aa], name, coords[i, a])
            for chain, (coords, seq) in chains.items() for i, aa in enumerate(seq)
            for a, name in enumerate(("N", "CA", "C")) if np.isfinite(coords[i, a]).all()]
    if fmt == "pdb":
        lines = [f"ATOM  {k + 1:5d} {name:<4s} {res:>3s} {chain}{num:4d}    "
                 f"{x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00           {name[0]}"
                 for k, (chain, num, res, name, (x, y, z)) in enumerate(rows)] + ["END"]
    else:
        tags = ["group_PDB", "id", "type_symbol", "label_atom_id", "label_comp_id",
                "label_asym_id", "label_seq_id", "Cartn_x", "Cartn_y", "Cartn_z", "auth_seq_id",
                "auth_asym_id", "pdbx_PDB_model_num"]
        lines = ["data_seeded", "loop_"] + [f"_atom_site.{t}" for t in tags]
        lines += [f"ATOM {k + 1} {name[0]} {name} {res} {chain} {num} {x:.3f} {y:.3f} {z:.3f} "
                  f"{num} {chain} 1" for k, (chain, num, res, name, (x, y, z)) in enumerate(rows)]
        lines.append("#")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def host_seconds(fn, iters=3, warmup=True):
    """Host clock around ``iters`` calls, synchronised, after a warm-up call."""
    import torch

    if warmup:
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters


def phase_if1(card):
    """ESM-IF1 at its released size (esm_if1_gvp4_t16_142M_UR50, seeded random
    weights), fp32 with TF32 off, built with no device argument, on a seeded
    L=500 backbone with a 5-residue gap: the encoder output, the
    teacher-forced logits and score_sequence against the port's CPU forward
    of the same weights; a forward repeated bit for bit; every decode step's
    logits against the teacher forcing of the decoded tokens; partial_seq;
    pad_to_multiple=64 against the unpadded call; one position's sampling
    distribution (20,000 draws); the times of the encoder, a score and
    sample with 1 and 8 samples; a profile of one sample (of the first 64
    residues); a 220 + 160 residue complex sampled and scored. No kernel of
    the port is on this path (the JAX package has no Pallas kernel for it).
    Returns the handle's model."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from esm_tpu_torch import pretrained
    from esm_tpu_torch.models.inverse_folding import model as ifm
    from esm_tpu_torch.models.inverse_folding import multichain

    L, gap = 500, slice(240, 245)
    t0 = time.perf_counter()
    handle, alphabet = pretrained.random_model_and_alphabet("esm_if1_gvp4_t16_142M_UR50", seed=50)
    model = handle.model
    n_params = sum(p.numel() for p in model.parameters())
    n_gvp = sum(p.numel() for p in model.encoder.gvp_encoder.parameters())
    if handle.device.type != "cuda" or n_params != IF1_PARAMS:
        raise AssertionError(f"[if1] built on {handle.device} with {n_params} parameters")
    cpu = pretrained.IFHandle(handle.cfg, ifm.GVPTransformerModel(handle.cfg, device="cpu"),
                              alphabet)
    cpu.model.load_state_dict(model.state_dict())
    coords = ideal_backbone(L, 51, gap=gap)
    native = random_protein(L, seed=52)
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    zero_counts()
    try:
        log(f"[if1] esm_if1_gvp4_t16_142M_UR50: {n_params:,} parameters ({n_gvp:,} in the GVP "
            f"encoder), on {handle.device}, fp32, TF32 off; backbone L={L}, residues "
            f"{gap.start}-{gap.stop - 1} missing (built and copied to the CPU in "
            f"{time.perf_counter() - t0:.1f} s)")
        enc = handle.get_encoder_output(coords)
        again = handle.get_encoder_output(coords)
        err = rel_err(enc.cpu(), cpu.get_encoder_output(coords))
        log(f"[if1] encoder output {tuple(enc.shape)}: card vs CPU max err {err:.2e} of the "
            f"largest value (<= {IF1_TOL}); repeated on the card bit for bit: {torch.equal(enc, again)} "
            f"(t={time.perf_counter() - t0:.1f} s)")
        if not (err <= IF1_TOL and torch.isfinite(enc).all() and torch.equal(enc, again)):
            raise AssertionError(f"[if1] encoder output: err {err}")

        bc, conf, _, toks, pmask = ifm.CoordBatchConverter(alphabet)([(coords, None, native)])
        logits = handle.forward(bc, pmask, conf, toks[:, :-1])
        err = rel_err(logits.cpu(), cpu.forward(bc, pmask, conf, toks[:, :-1]))
        log(f"[if1] teacher-forced logits {tuple(logits.shape)}: card vs CPU max err {err:.2e} of "
            f"the largest (max |logit| {logits.abs().max().item():.2f}; <= {IF1_TOL})")
        if not (err <= IF1_TOL and logits.shape == (1, len(alphabet), L)):
            raise AssertionError(f"[if1] logits: err {err}")
        score = handle.score_sequence(coords, native)
        score_cpu = cpu.score_sequence(coords, native)
        err = float(np.abs(np.subtract(score, score_cpu)).max())
        log(f"[if1] score_sequence (ll, ll with coords): card {score[0]:.6f}, {score[1]:.6f}; "
            f"CPU {score_cpu[0]:.6f}, {score_cpu[1]:.6f}; max abs diff {err:.2e} "
            f"(<= {IF1_SCORE_TOL})")
        if not err <= IF1_SCORE_TOL:
            raise AssertionError(f"[if1] score card vs CPU: {err}")

        # the decode against the teacher forcing of what it decoded, 2 rows
        dev = handle.device
        bc, conf, pmask = bc.to(dev), conf.to(dev), pmask.to(dev)
        init = torch.full((2, L + 1), handle.cfg.mask_idx, dtype=torch.int64, device=dev)
        init[:, 0] = handle.cfg.cath_idx
        steps = []
        decoded = ifm.sample_tokens(model, bc, pmask, conf, init,
                                    torch.Generator(device=dev).manual_seed(54), 1.0,
                                    step_logits=steps)
        forced = handle.forward(bc.expand(2, -1, -1, -1), pmask.expand(2, -1),
                                conf.expand(2, -1), decoded[:, :-1])
        err = rel_err(torch.stack(steps, dim=-1), forced)
        log(f"[if1] incremental decode, 2 rows x {L} steps: every step's logits vs the teacher "
            f"forcing of the decoded tokens, max err {err:.2e} of the largest (<= {IF1_TOL}) "
            f"(t={time.perf_counter() - t0:.1f} s)")
        if not err <= IF1_TOL:
            raise AssertionError(f"[if1] decode vs teacher forcing: err {err}")

        keep = {i: native[i] for i in range(0, L, 3)}
        partial = [keep.get(i, "<mask>") for i in range(L)]
        got = handle.sample(coords, partial_seq=partial, seed=55, return_tokens=True)
        kept = all(alphabet.get_tok(int(got[i])) == c for i, c in keep.items())
        plain = handle.sample(coords, seed=56, num_samples=8, return_tokens=True)
        padded = handle.sample(coords, seed=56, num_samples=8, pad_to_multiple=64,
                               return_tokens=True)
        log(f"[if1] partial_seq: {len(keep)} given positions kept: {kept}; pad_to_multiple=64 "
            f"(L {L} -> {L + (-L) % 64}), 8 samples: the same tokens as unpadded: "
            f"{np.array_equal(plain, padded)} (t={time.perf_counter() - t0:.1f} s)")
        if not (kept and np.array_equal(plain, padded) and plain.shape == (8, L)):
            raise AssertionError("[if1] partial_seq or pad_to_multiple changed the sample")

        temperature, n = 0.7, 20000
        first = steps[0][0]
        draws = ifm.draw_tokens(first.expand(n, -1), temperature,
                                torch.Generator(device=dev).manual_seed(57))
        p = torch.softmax(first.double() / temperature, -1).cpu().numpy()
        freq = np.bincount(draws.cpu().numpy(), minlength=len(p)) / n
        tv = 0.5 * np.abs(freq - p).sum()
        log(f"[if1] sampling distribution at the first position, T={temperature}, {n} draws on "
            f"the card: total variation {tv:.4f} against softmax(logits / T) (<= {IF1_TV})")
        if not tv <= IF1_TV:
            raise AssertionError(f"[if1] sampling distribution: TV {tv}")

        with FlopCounterMode(display=False) as fc:
            ifm.encoder_apply(model.encoder, handle.cfg, bc, pmask, conf)
        enc_flops = fc.get_total_flops()
        with FlopCounterMode(display=False) as fc:
            handle.forward(bc, pmask, conf, toks[:, :-1].to(dev))
        fwd_flops = fc.get_total_flops()
        enc_s = host_seconds(lambda: ifm.encoder_apply(model.encoder, handle.cfg, bc, pmask, conf))
        score_s = host_seconds(lambda: handle.score_sequence(coords, native))
        log(f"[if1] encoder forward L={L}: {enc_s * 1e3:.1f} ms, {enc_flops / 1e9:.1f} GFLOP "
            f"(torch FlopCounterMode), {enc_flops / enc_s / 1e12:.2f} TFLOP/s fp32; "
            f"score_sequence (host conversion, forward of {fwd_flops / 1e9:.1f} GFLOP, "
            f"log-softmax, copy back): {score_s * 1e3:.1f} ms ({card}) "
            f"(t={time.perf_counter() - t0:.1f} s)")
        for num in (1, 8):
            # (the decode is warm: the samples above ran it)
            sec = host_seconds(lambda: handle.sample(coords, seed=58, num_samples=num), iters=1,
                               warmup=False)
            log(f"[if1] sample num_samples={num}, L={L}: {sec:.3f} s, {num * L / sec:.1f} "
                f"residues/s ({card})")
        # the profile: the first 64 residues (the profiler's post-processing of
        # a 500-step decode's ~600,000 events took minutes); launches a step
        # and the busy share do not depend on the length
        short = coords[:64]
        sb, sc, _, _, sp = ifm.CoordBatchConverter(alphabet)([(short, None, None)], device=dev)
        _, _, enc_events = profile("one IF1 encoder forward (L=64)",
                                   lambda: ifm.encoder_apply(model.encoder, handle.cfg, sb, sp,
                                                             sc), top=6)
        wall, busy, events = profile("one IF1 sample (num_samples=1, L=64)",
                                     lambda: handle.sample(short, seed=58), top=10, by_op=True)
        log(f"[if1] decode: {(events - enc_events) / len(short):.1f} device launches a step "
            f"({events} in the sample, {enc_events} in its encoder forward), device busy "
            f"{100 * busy / wall:.1f}% of the sample's wall time "
            f"(t={time.perf_counter() - t0:.1f} s)")

        # a two-chain complex: chain A designed and scored in the presence of B
        chains = {"A": ideal_backbone(220, 59), "B": ideal_backbone(160, 60, offset=(25, 0, 0))}
        seqs = {"A": random_protein(220, seed=61), "B": random_protein(160, seed=62)}
        worst = 0.0
        for target in ("A", "B"):
            got = multichain.score_sequence_in_complex(model, alphabet, chains, target,
                                                       seqs[target])
            want = multichain.score_sequence_in_complex(cpu.model, alphabet, chains, target,
                                                        seqs[target])
            worst = max(worst, float(np.abs(np.subtract(got, want)).max()))
        # (a random model draws special tokens too, so the designed string is
        # not scored: sliced to the chain's length it can cut a token)
        designed = multichain.sample_sequence_in_complex(model, alphabet, chains, "A", seed=63)
        again = multichain.sample_sequence_in_complex(model, alphabet, chains, "A", seed=63)
        log(f"[if1] complex A (220) + B (160): score_sequence_in_complex card vs CPU, both "
            f"targets, max abs diff {worst:.2e} (<= {IF1_SCORE_TOL}); "
            f"sample_sequence_in_complex repeated with its seed: {designed == again} "
            f"(t={time.perf_counter() - t0:.1f} s)")
        if not (worst <= IF1_SCORE_TOL and designed == again):
            raise AssertionError(f"[if1] complex: diff {worst}, repeat {designed == again}")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"[if1] a kernel launched on the IF1 path: {counts}")
    del cpu, handle
    return model


def run_if_cli(module, argv, where):
    """An IF1 CLI's ``run`` on the card or (--nogpu) the CPU, TF32 off.
    Returns (printed lines, seconds)."""
    import torch

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            module.run(module.create_parser().parse_args(
                argv + (["--nogpu"] if where == "cpu" else [])))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return buf.getvalue().splitlines(), time.perf_counter() - t0


def phase_cli_if(model):
    """esm-if-score and esm-if-sample (esm_tpu_torch.cli.if_score, if_sample)
    on the card against --nogpu runs of the same commands, with a save_if1
    checkpoint of the [if1] model (released size): a seeded 250-residue
    backbone (3 residues with N only) as PDB and mmCIF, a second chain of 160
    for --multichain-backbone, a seeded FASTA of 10 variants. Scores within
    IF1_SCORE_TOL of the CPU's (the CPU scores the first IF1_CPU_ROWS
    variants: a full-width forward takes seconds there) and the mmCIF's of
    the PDB's; one seed sampled twice on the card gives the same FASTA; the
    CPU's sample run prints the same native sequence and format."""
    import csv

    from esm_tpu_torch.cli import if_sample, if_score
    from esm_tpu_torch.io.export import save_if1

    L = 250
    t0 = time.perf_counter()
    coords = ideal_backbone(L, 70)
    coords[120:123, 1:] = np.nan  # CA and C missing
    native = random_protein(L, seed=71)
    rng = np.random.RandomState(72)
    variants = [native]
    for _ in range(9):
        v = np.array(list(native))
        at = rng.rand(L) < 0.1
        v[at] = rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), int(at.sum()))
        variants.append("".join(v))
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, _ = save_if1(model, os.path.join(tmp, "esm_if1_gvp4_t16_142M_UR50_seeded.pt"))
        log(f"[cli-if] save_if1 wrote {os.path.getsize(ckpt) / 1e6:.0f} MB "
            f"(t={time.perf_counter() - t0:.1f} s)")
        single = {"A": (coords, native)}
        pair = dict(single, B=(ideal_backbone(160, 73, offset=(25, 0, 0)),
                               random_protein(160, seed=74)))
        paths = {}
        for name, chains, fmt in (("a.pdb", single, "pdb"), ("a.cif", single, "cif"),
                                  ("ab.pdb", pair, "pdb")):
            paths[name] = os.path.join(tmp, name)
            write_backbone(paths[name], chains, fmt)
        fastas = {}
        for where, n in (("cuda", len(variants)), ("cpu", IF1_CPU_ROWS)):
            fastas[where] = os.path.join(tmp, f"variants_{where}.fasta")
            with open(fastas[where], "w") as f:
                f.write("".join(f">variant_{i}\n{s}\n" for i, s in enumerate(variants[:n])))

        def scores(structure, where, *extra):
            out = os.path.join(tmp, f"{where}_{os.path.basename(structure)}{len(extra)}.csv")
            _, sec = run_if_cli(if_score, [structure, fastas[where], "--model", ckpt, "--chain",
                                           "A", "--outpath", out, *extra], where)
            with open(out, newline="") as f:
                rows = list(csv.reader(f))
            n = len(variants) if where == "cuda" else IF1_CPU_ROWS
            if rows[0] != ["seqid", "log_likelihood", "log_likelihood_withcoord"] or \
                    [r[0] for r in rows[1:]] != [f"variant_{i}" for i in range(n)]:
                raise AssertionError(f"[cli-if] if_score {where}: CSV {rows[:2]}")
            return np.asarray([r[1:] for r in rows[1:]], float), sec

        for structure, extra in ((paths["a.pdb"], []),
                                 (paths["ab.pdb"], ["--multichain-backbone"])):
            card, sec = scores(structure, "cuda", *extra)
            cpu_scores, csec = scores(structure, "cpu", *extra)
            err = np.abs(card[:IF1_CPU_ROWS] - cpu_scores).max()
            what = "multichain A|B" if extra else "single chain"
            log(f"[cli-if] if_score {what}: {len(card)} variants on the card in {sec:.1f} s, "
                f"{IF1_CPU_ROWS} on the CPU in {csec:.1f} s; card vs CPU max abs diff {err:.2e} "
                f"(<= {IF1_SCORE_TOL})")
            if not (np.isfinite(card).all() and err <= IF1_SCORE_TOL):
                raise AssertionError(f"[cli-if] if_score {what}: card vs CPU {err}")
            if not extra:
                cif, _ = scores(paths["a.cif"], "cuda")
                err = np.abs(cif - card).max()
                log(f"[cli-if] if_score from the mmCIF vs the PDB on the card: max abs diff "
                    f"{err:.2e}")
                if not err <= IF1_SCORE_TOL:
                    raise AssertionError(f"[cli-if] mmCIF vs PDB: {err}")

        for structure, extra in ((paths["a.pdb"], []),
                                 (paths["ab.pdb"], ["--multichain-backbone"])):
            fastas = []
            # the CPU samples once, single chain (its draws come from another
            # generator, so only the output is compared)
            runs = (("cuda", "s1", 2), ("cuda", "s2", 2)) + ((("cpu", "s3", 1),) if not extra
                                                            else ())
            for where, out, num in runs:
                outpath = os.path.join(tmp, f"{out}{len(extra)}.fasta")
                printed, sec = run_if_cli(if_sample, [structure, "--model", ckpt, "--chain", "A",
                                                      "--num-samples", str(num), "--seed", "7",
                                                      "--outpath", outpath, *extra], where)
                with open(outpath) as f:
                    records = f.read().splitlines()
                recovery = re.findall(r"^Sequence recovery: ([0-9.]+)$", "\n".join(printed), re.M)
                recovery = [float(x) for x in recovery]
                if not (native in printed and len(recovery) == num
                        and records[0::2] == [f">sampled_seq_{i + 1}" for i in range(num)]):
                    raise AssertionError(f"[cli-if] if_sample {where}: {printed[:4]}, "
                                         f"{records[:2]}")
                fastas.append(records)
                log(f"[cli-if] if_sample {' '.join(extra) or 'single chain'} on {where}: {num} "
                    f"samples in {sec:.1f} s, recovery {recovery}")
            if fastas[0] != fastas[1]:
                raise AssertionError("[cli-if] if_sample: one seed gave two FASTAs on the card")
        log("[cli-if] if_sample: the same seed gave the same FASTA twice on the card, single "
            "chain and --multichain-backbone; the CPU run printed the same native sequence "
            f"(t={time.perf_counter() - t0:.1f} s)")


# ---------------------------------------------------------------------------
# Weight-only int8, LoRA and the fine-tuning trainers
# ---------------------------------------------------------------------------

LORA_RANK = 16
LORA_LR = 1e-5  # the adapters' AdamW rate on the random init's fixed batch (PERF.md)
LORA_PARAMS_650M = 12_165_120  # 33 x (4 x 16 x 2560 + 2 x 16 x 6400)
INT8_PARAM_RATIO = 0.27  # int8 / fp32 parameter bytes of ESM2-650M: the linears at 1/4
INT8_MEMORY_SAVING = 0.5e9  # the int8 base's LoRA step peak below the bf16 base's, bytes
TRAIN_TOL = 1e-4  # [train-msa], [train-if]: card vs CPU gradients, share of the largest


def grad_agreement(g_a, g_b, names=None):
    """(lowest cosine over the tensors that ``names`` selects, its name,
    global-norm ratio |g_a| / |g_b|) of two gradient dicts."""
    import torch

    if g_a.keys() != g_b.keys():
        raise AssertionError("the two paths give gradients to other parameters")
    worst_cos, worst_name, sq_a, sq_b = 2.0, "", 0.0, 0.0
    for name, ga in g_a.items():
        gb = g_b[name]
        sq_a += float(ga.double().pow(2).sum())
        sq_b += float(gb.double().pow(2).sum())
        if names is not None and not names(name):
            continue
        cos = float(torch.nn.functional.cosine_similarity(ga.flatten().double(),
                                                          gb.flatten().double(), dim=0))
        if cos < worst_cos:
            worst_cos, worst_name = cos, name
    return worst_cos, worst_name, (sq_a / sq_b) ** 0.5


def adapter_grads(base, adapters, cfg, batch):
    """Loss and adapter gradients of one LoRA loss over the frozen base."""
    from esm_tpu_torch import training

    adapters.zero_grad(set_to_none=True)
    with training.frozen_and_patched(base, adapters, 1.0):
        loss, _ = training.mlm_loss(base, cfg, *batch)
        loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in adapters.named_parameters()}
    adapters.zero_grad(set_to_none=True)
    return loss.item(), grads


def lora_steps(tag, base, cfg, batch, steps, apply_fn=None):
    """``steps`` LoRA steps (rank 16, the default targets, AdamW at LORA_LR)
    on one batch and corruption. Returns (losses, seconds a step after the
    first, peak bytes, adapters, state)."""
    import torch
    from esm_tpu_torch import lora, training

    adapters = lora.init_lora(torch.Generator(device="cuda").manual_seed(8), base,
                              rank=LORA_RANK)
    tx = training.make_optimizer(LORA_LR, warmup_steps=1, total_steps=1000)
    state = training.init_state(adapters, tx)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = training.train_step_lora_corrupted(state, base, cfg, tx, *batch,
                                                            apply_fn=apply_fn)
        losses.append(metrics["loss"].item())  # synchronises
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    log(f"[{tag}] LoRA losses over {steps} steps: " + ", ".join(f"{x:.5f}" for x in losses))
    return losses, float(np.mean(step_s[1:])), peak, adapters, state


def phase_lora(card):
    """LoRA fine-tuning of ESM2-650M at full width and depth (seeded): the base
    stored in bf16, then weight-only int8 (--lora-int8-base's configuration);
    bf16 compute, flash attention and remat "dots", rank 16, alpha 16, the
    default targets, B=8 x 1024 tokens ([train]'s shape)."""
    import dataclasses

    import torch
    from esm_tpu_torch import lora, pretrained, training
    from esm_tpu_torch.models import esm2

    B, L = 8, 1022
    runs = {}
    for kind in ("bf16", "int8"):
        handle, alphabet = pretrained.random_model_and_alphabet(
            "esm2_t33_650M_UR50D", seed=5, device="cuda")
        base, n_layers = lora.store_base(handle.model, int8=kind == "int8"), handle.num_layers
        del handle
        cfg = dataclasses.replace(base.cfg, compute_dtype=torch.bfloat16, use_flash=True,
                                  remat=True, remat_policy="dots")
        tokens = torch.from_numpy(bench_tokens(alphabet, B, L, seed=6)).cuda()
        corrupted, target_mask = training._corrupt_batch(
            cfg, torch.Generator(device="cuda").manual_seed(7), tokens)
        batch = (corrupted, tokens, target_mask)
        before = {k: v.cpu().clone() for k, v in base.state_dict().items()}
        if kind == "bf16":
            probe = lora.init_lora(torch.Generator(device="cuda").manual_seed(8), base,
                                   rank=LORA_RANK)
            n_adapters = lora.num_params(probe)
            log(f"[lora] ESM2-650M, bf16 base, rank {LORA_RANK}: {n_adapters:,} adapter "
                f"parameters (expected {LORA_PARAMS_650M:,}); B={B} x {L + 2} tokens, "
                f"{int(target_mask.sum())} masked targets")
            if n_adapters != LORA_PARAMS_650M:
                raise AssertionError(f"[lora] {n_adapters} adapter parameters")
            with torch.no_grad():
                gen = torch.Generator(device="cuda").manual_seed(9)
                for _, a in probe.adapters():
                    a.lora_b.normal_(0.0, 0.02, generator=gen)
            loss_f, g_flash = adapter_grads(base, probe, cfg, batch)
            loss_e, g_exact = adapter_grads(base, probe, dataclasses.replace(cfg, use_flash=False),
                                            batch)
            cos, worst, ratio = grad_agreement(g_flash, g_exact)
            log(f"[lora] adapter gradients, seeded nonzero b, flash vs exact: loss {loss_f:.5f} / "
                f"{loss_e:.5f}, lowest cosine {cos:.5f} ({worst}), global-norm ratio {ratio:.5f}")
            if not (cos >= 0.99 and abs(ratio - 1) <= 0.05):
                raise AssertionError(f"[lora] flash gradients disagree: cosine {cos} ({worst}), "
                                     f"ratio {ratio}")
            del g_flash, g_exact
            # merge against patch with these adapters: a few steps' deltas at LORA_LR
            # are below a bf16 weight's resolution, and merging rounds them away
            with torch.no_grad():
                plain = dataclasses.replace(cfg, remat=False)
                with lora.patch(base, probe):
                    patched = esm2.apply(base, plain, tokens)["logits"]
                merged = lora.merge(base, probe)
                hold_flash("lora", esm2.apply(merged, plain, tokens)["logits"], patched)
            log("[lora] the merged bf16 model's logits (seeded nonzero b) held against the "
                "patched model's")
            del probe, merged, patched
            torch.cuda.empty_cache()
        zero_counts()
        losses, sec, peak, adapters, state = lora_steps(f"lora {kind}", base, cfg, batch,
                                                        TRAIN_STEPS)
        counts = read_counts()
        per_step = {k: v / TRAIN_STEPS for k, v in counts.items()}
        want = {"flash_attention": 0, "flash_attention_with_lse": 2 * n_layers,
                "flash_attention_bwd.dq": n_layers, "flash_attention_bwd.dkv": n_layers,
                "triangle_attention_fused": 0, "tri_mul_stage1": 0, "tri_mul_epilogue": 0}
        log(f"[lora] {kind} base: launches per step {per_step} (expected {want})")
        if per_step != want:
            raise AssertionError(f"[lora] launches per step {per_step}, expected {want}")
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"[lora] {kind} base: losses not finite or not falling: {losses}")
        if not all(torch.equal(t.cpu(), before[k]) for k, t in base.state_dict().items()):
            raise AssertionError(f"[lora] the {kind} base changed during the steps")
        n_base = sum(p.numel() for p in base.parameters())
        log(f"[lora] {kind} base: {sec * 1e3:.1f} ms/step, {B * (L + 2) / sec:.1f} tok/s, peak "
            f"memory {peak / 1e9:.3f} GB (torch.cuda.max_memory_allocated), optimizer state "
            f"{state.opt_state_bytes() / 1e6:.1f} MB against [train]'s AdamW state "
            f"{8 * n_base / 1e9:.3f} GB; the base bit-identical after the steps "
            f"(ESM2-650M, B={B}, L={L}; {card})")
        runs[kind] = dict(losses=losses, peak=peak, sec=sec)
        if kind == "bf16":
            with torch.no_grad():
                plain = dataclasses.replace(cfg, remat=False)
                with lora.patch(base, adapters):
                    patched = esm2.apply(base, plain, tokens)["logits"]
                merged = esm2.apply(lora.merge(base, adapters), plain, tokens)["logits"]
            err = (merged - patched).abs().max().item()
            agree = (merged.argmax(-1) == patched.argmax(-1)).float().mean().item()
            log(f"[lora] the trained adapters merged into the bf16 base against the patched "
                f"model (no bound): max abs err {err:.4f}, argmax agreement {agree:.5f}")
            del merged, patched
        else:
            try:
                lora.merge(base, adapters)
            except ValueError as err:
                log(f"[lora] merge over the int8 base refuses: {err}")
            else:
                raise AssertionError("[lora] merge over an int8 base did not refuse")
        del base, adapters, state, batch, before
        torch.cuda.empty_cache()
    first = runs["int8"]["losses"][0] / runs["bf16"]["losses"][0]
    saved = runs["bf16"]["peak"] - runs["int8"]["peak"]
    log(f"[lora] int8 base against the bf16 base: first loss ratio {first:.5f}, peak memory "
        f"{saved / 1e9:.3f} GB lower, step time ratio "
        f"{runs['int8']['sec'] / runs['bf16']['sec']:.3f}")
    if not abs(first - 1) <= 0.02:
        raise AssertionError(f"[lora] the int8 base's first loss is {first} x the bf16 base's")
    if not saved >= INT8_MEMORY_SAVING:
        raise AssertionError(f"[lora] the int8 base saves {saved / 1e9} GB of peak memory")


def phase_int8(card):
    """The weight-only int8 ESM2-650M forward at [main]'s shape (B=32, 1024
    tokens, bf16, flash) through LMHandle.quantized(), against the bf16
    handle in the same run."""
    import torch
    from esm_tpu_torch import pretrained
    from esm_tpu_torch.quantization import param_bytes

    B, L = 32, 1022
    handle, alphabet = pretrained.random_model_and_alphabet(
        "esm2_t33_650M_UR50D", seed=0, device="cuda")
    quant = handle.quantized()
    ratio = param_bytes(quant.model) / param_bytes(handle.model)
    flash = handle.with_options(compute_dtype=torch.bfloat16, use_flash=True)
    qflash = quant.with_options(compute_dtype=torch.bfloat16, use_flash=True)
    tokens = torch.from_numpy(bench_tokens(alphabet, B, L)).cuda()
    zero_counts()
    logits_q = qflash(tokens)["logits"]
    torch.cuda.synchronize()
    counts = read_counts()
    logits = flash(tokens)["logits"]
    scale = logits.abs().max().item()
    err = (logits_q - logits).abs().max().item()
    agree = (logits_q.argmax(-1) == logits.argmax(-1)).float().mean().item()
    log(f"[int8] ESM2-650M int8 forward B={B} T={L + 2}: K1 launched "
        f"{counts['flash_attention']} times; parameter bytes int8 / fp32 {ratio:.4f} "
        f"(< {INT8_PARAM_RATIO}); logits vs the bf16 handle: max abs err {err:.4f} (bound "
        f"{0.15 * (scale + 1):.3f}), argmax agreement {agree:.5f}")
    if counts["flash_attention"] != handle.num_layers or sum(counts.values()) != handle.num_layers:
        raise AssertionError(f"[int8] launches {counts}")
    if not (torch.isfinite(logits_q).all() and err < 0.15 * (scale + 1) and agree > 0.95):
        raise AssertionError(f"[int8] logits off: err {err}, agreement {agree}")
    if not ratio < INT8_PARAM_RATIO:
        raise AssertionError(f"[int8] parameter bytes ratio {ratio}")
    rates = {}
    for name, h in (("bf16", flash), ("int8", qflash)):
        h(tokens)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            h(tokens)["logits"]
        torch.cuda.synchronize()
        rates[name] = B * 3 / (time.perf_counter() - t0)
    log(f"[int8] flash path: int8 {rates['int8']:.3f} seq/s, bf16 {rates['bf16']:.3f} seq/s "
        f"([main]'s handle, this run); int8 / bf16 = {rates['int8'] / rates['bf16']:.3f} "
        f"(ESM2-650M, B={B}, L={L}; {card})")
    del handle, quant, flash, qflash, logits, logits_q
    torch.cuda.empty_cache()


def msa_tokens(alphabet, rows, length, seed):
    from esm_tpu_torch.data import MSABatchConverter

    return MSABatchConverter(alphabet)([seeded_msa(rows, length, seed)])[2]


def timed_steps(step, n):
    """Losses and seconds a step (after the first) of ``n`` calls of ``step()``,
    which returns (state, metrics), and the peak memory over them."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        losses.append(step()[1]["loss"].item())
        step_s.append(time.perf_counter() - t0)
    return losses, float(np.mean(step_s[1:])), torch.cuda.max_memory_allocated()


def card_and_cpu_grads(cpu_model, card_model, loss_fn):
    """One loss and its gradients on the CPU and on the card (fp32, TF32 off),
    and the same on the card again. The CPU runs on one thread, so its sums
    take one order whatever the machine's core count: with all cores the
    reference's own gradients moved by up to 1.5e-4 of the largest between
    machines ([train-if]). Returns (CPU loss, CPU gradients, card loss, card
    gradients, whether the card repeated itself bit for bit)."""
    import torch

    prev = torch.backends.cuda.matmul.allow_tf32, torch.get_num_threads()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)
    try:
        results = []
        for model in (cpu_model, card_model, card_model):
            model.zero_grad(set_to_none=True)
            loss = loss_fn(model)
            loss.backward()
            results.append((loss.item(), {
                n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().cpu().clone()
                for n, p in model.named_parameters()}))
            model.zero_grad(set_to_none=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.set_num_threads(prev[1])
    (l_cpu, g_cpu), (l_card, g_card), (l_again, g_again) = results
    repeat = l_card == l_again and all(torch.equal(g, g_again[n]) for n, g in g_card.items())
    return l_cpu, g_cpu, l_card, g_card, repeat


def card_vs_cpu_grads(tag, cpu_model, card_model, loss_fn, tol):
    """:func:`card_and_cpu_grads`, logged. Returns (loss error relative to
    the CPU's loss, largest gradient error as a share of the largest value,
    whether the card repeated itself bit for bit)."""
    l_cpu, g_cpu, l_card, g_card, repeat = card_and_cpu_grads(cpu_model, card_model, loss_fn)
    loss_err = abs(l_card - l_cpu) / abs(l_cpu)
    grad_err, where = max((rel_err(g_card[n], g), n) for n, g in g_cpu.items())
    log(f"[{tag}] card vs CPU (fp32, TF32 off, the CPU on one thread): loss {l_card:.7f} vs "
        f"{l_cpu:.7f} (relative err {loss_err:.2e}), gradients {grad_err:.2e} of the largest "
        f"(worst {where}; <= {tol}); the card's step repeated bit for bit: {repeat}")
    return loss_err, grad_err, repeat


def phase_train_msa(card):
    """MSA Transformer training at MSA-1b's size (12 x 768, seeded), B=1 x
    R=128 rows x C=257: 3 train_step_msa steps (bf16 compute, fp32 master
    weights), 3 LoRA steps with msa_transformer.apply over the bf16 base;
    one loss and its gradients on the card against the CPU at 2 of 12
    layers, R=16, C=65, fp32."""
    import copy
    import dataclasses

    import torch
    from esm_tpu_torch import lora, pretrained, training
    from esm_tpu_torch.models import msa_transformer as msa

    handle, alphabet = pretrained.random_model_and_alphabet(
        "esm_msa1b_t12_100M_UR50S", seed=50, device="cuda")
    cfg = dataclasses.replace(handle.cfg, compute_dtype=torch.bfloat16)
    tokens = msa_tokens(alphabet, 128, 256, seed=51).cuda()
    corrupted, target_mask = training._corrupt_batch(
        cfg, torch.Generator(device="cuda").manual_seed(52), tokens)
    batch = (corrupted, tokens, target_mask)
    tx = training.make_optimizer(1e-5, warmup_steps=1, total_steps=1000)
    state = training.init_state(handle.model, tx)
    losses, sec, peak = timed_steps(lambda: training.train_step_corrupted(
        state, cfg, tx, *batch, apply_fn=msa.apply), 3)
    log(f"[train-msa] MSA-1b, full parameters, bf16 compute, B=1 x R={tokens.shape[1]} x "
        f"C={tokens.shape[2]}: losses " + ", ".join(f"{x:.5f}" for x in losses)
        + f"; {sec * 1e3:.1f} ms/step, peak memory {peak / 1e9:.3f} GB ({card})")
    lora.store_base(handle.model)
    llosses, lsec, lpeak, _, _ = lora_steps("train-msa", handle.model, cfg, batch, 3,
                                            apply_fn=msa.apply)
    log(f"[train-msa] LoRA over the bf16 base: {lsec * 1e3:.1f} ms/step, peak memory "
        f"{lpeak / 1e9:.3f} GB")
    if not (all(np.isfinite(losses)) and all(np.isfinite(llosses))):
        raise AssertionError(f"[train-msa] losses {losses}, LoRA {llosses}")
    del handle, state, batch
    torch.cuda.empty_cache()

    small = dataclasses.replace(cfg, num_layers=2, compute_dtype=torch.float32)
    cpu_model = msa.init(small, torch.Generator().manual_seed(53), device="cpu")
    toks = msa_tokens(alphabet, 16, 64, seed=54)
    c, m = training._corrupt_batch(small, torch.Generator().manual_seed(55), toks)

    def loss_fn(model):
        d = next(model.parameters()).device
        return training.mlm_loss(model, small, c.to(d), toks.to(d), m.to(d), msa.apply)[0]

    loss_err, grad_err, _ = card_vs_cpu_grads("train-msa", cpu_model,
                                              copy.deepcopy(cpu_model).cuda(), loss_fn, TRAIN_TOL)
    if not (loss_err <= TRAIN_TOL and grad_err <= TRAIN_TOL):
        raise AssertionError(f"[train-msa] card vs CPU: loss {loss_err}, gradients {grad_err}")


def if_batch(alphabet, lengths, seed, device):
    from esm_tpu_torch.models.inverse_folding import util

    items = [(ideal_backbone(n, seed + i), None, random_protein(n, seed + 100 + i))
             for i, n in enumerate(lengths)]
    coords, conf, _, tokens, pmask = util.CoordBatchConverter(alphabet)(items, device=device)
    return coords, pmask, conf, tokens


def phase_train_if(card):
    """ESM-IF1 fine-tuning at its released size (seeded), fp32 with TF32 off:
    one loss and its gradients on the card against the CPU on a 120-residue
    backbone, repeated bit for bit on the card; 3 train_step_if and 3
    train_step_if_lora steps on 4 synthetic backbones of 250 residues."""
    import copy

    import torch
    from esm_tpu_torch import lora, pretrained, training

    handle, alphabet = pretrained.random_model_and_alphabet(
        "esm_if1_gvp4_t16_142M_UR50", seed=60, device="cuda")
    model, cfg = handle.model, handle.cfg
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != IF1_PARAMS:
        raise AssertionError(f"[train-if] {n_params} parameters, expected {IF1_PARAMS}")
    one = if_batch(alphabet, [120], seed=61, device="cpu")

    def loss_fn(m):
        return training._if_loss(m, cfg, tuple(t.to(m.device) for t in one))[0]

    loss_err, grad_err, repeat = card_vs_cpu_grads(
        "train-if", copy.deepcopy(model).cpu(), model, loss_fn, TRAIN_TOL)
    if not (loss_err <= 1e-5 and grad_err <= TRAIN_TOL and repeat):
        raise AssertionError(f"[train-if] card vs CPU: loss {loss_err}, gradients {grad_err}, "
                             f"repeat {repeat}")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        batch = if_batch(alphabet, [250] * 4, seed=62, device="cuda")
        tx = training.make_optimizer(1e-5, warmup_steps=1, total_steps=1000)
        state = training.init_state(model, tx)
        losses, sec, peak = timed_steps(
            lambda: training.train_step_if(state, cfg, tx, *batch), 3)
        log(f"[train-if] full parameters, 4 x 250 residues, fp32: losses "
            + ", ".join(f"{x:.5f}" for x in losses)
            + f"; {sec * 1e3:.1f} ms/step, peak memory {peak / 1e9:.3f} GB ({card})")
        before = {k: v.clone() for k, v in model.state_dict().items()}
        adapters = lora.init_lora(torch.Generator(device="cuda").manual_seed(63), model,
                                  rank=LORA_RANK)
        ltx = training.make_optimizer(LORA_LR, warmup_steps=1, total_steps=1000)
        lstate = training.init_state(adapters, ltx)
        llosses, lsec, lpeak = timed_steps(
            lambda: training.train_step_if_lora(lstate, model, cfg, ltx, *batch), 3)
        log(f"[train-if] LoRA, rank {LORA_RANK} ({lora.num_params(adapters):,} adapter "
            f"parameters): losses " + ", ".join(f"{x:.5f}" for x in llosses)
            + f"; {lsec * 1e3:.1f} ms/step, peak memory {lpeak / 1e9:.3f} GB")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    if not (all(np.isfinite(losses)) and all(np.isfinite(llosses))):
        raise AssertionError(f"[train-if] losses {losses}, LoRA {llosses}")
    if not all(torch.equal(v, before[k]) for k, v in model.state_dict().items()):
        raise AssertionError("[train-if] the LoRA steps changed the base")
    del handle, model, state, lstate, batch, before
    torch.cuda.empty_cache()


def run_pretrain(argv):
    from esm_tpu_torch.cli import pretrain

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        state = pretrain.run(pretrain.create_parser().parse_args(argv))
    return state, buf.getvalue(), time.perf_counter() - t0


def same_state(a, b):
    """Whether two TrainStates hold the same tensors, bit for bit."""
    import dataclasses

    import torch

    sa, sb = a.model.state_dict(), b.model.state_dict()
    if sa.keys() != sb.keys() or a.step != b.step or a.opt_state.count != b.opt_state.count:
        return False
    for f in dataclasses.fields(a.opt_state):
        da, db = getattr(a.opt_state, f.name), getattr(b.opt_state, f.name)
        if isinstance(da, dict) and (da.keys() != db.keys()
                                     or not all(torch.equal(da[k], db[k]) for k in da)):
            return False
    return all(torch.equal(sa[k], sb[k]) for k in sa)


def phase_cli_pretrain_lora():
    """esm_tpu_torch.cli.pretrain on the card at its default model (6 x 320),
    4 steps each with --lora 8, --lora 8 --lora-int8-base and --adafactor:
    --save-every 2 --stop-after 2, then --resume, equals the uninterrupted
    run bit for bit; the merged bf16-base save loads into an ESM2, the int8
    run saves the adapters. Then adafactor's optimizer state at ESM2-650M
    beside AdamW's, computed at init on the meta device."""
    from esm_tpu_torch import lora, training
    from esm_tpu_torch.io.checkpoint import load_params
    from esm_tpu_torch.models import esm2

    rng = np.random.RandomState(70)
    with tempfile.TemporaryDirectory() as tmp:
        fasta = os.path.join(tmp, "train.fasta")
        with open(fasta, "w") as f:
            for i in range(48):
                seq = "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), rng.randint(50, 600)))
                f.write(f">s{i}\n{seq}\n")
        for name, flags in (("lora", ["--lora", "8"]),
                            ("lora-int8", ["--lora", "8", "--lora-int8-base"]),
                            ("adafactor", ["--adafactor"])):
            common = ["--fasta", fasta, "--steps", "4", "--log-every", "1", "--warmup-steps", "1",
                      "--toks-per-batch", "4096", "--seed", "4"] + flags
            straight, out, sec = run_pretrain(
                common + ["--checkpoint-dir", os.path.join(tmp, name, "a")])
            ckpt_b = os.path.join(tmp, name, "b")
            run_pretrain(common + ["--checkpoint-dir", ckpt_b, "--save-every", "2",
                                   "--stop-after", "2"])
            resumed, out_b, _ = run_pretrain(common + ["--checkpoint-dir", ckpt_b, "--resume"])
            losses = [float(x) for x in re.findall(r"loss\s+([0-9.naif]+)", out)]
            same = same_state(straight, resumed)
            saved = load_params(os.path.join(tmp, name, "a"))
            if name == "lora":
                cli_size = esm2.ESM2Config(**esm2.ESM2_SIZES["esm2_t6_8M_UR50D"])  # the defaults
                esm2.ESM2(cli_size, device="cuda").load_state_dict(saved, strict=True)
                what = f"the merged bf16 model saved ({len(saved)} tensors, loads into an ESM2)"
            elif name == "lora-int8":
                if saved.keys() != straight.model.state_dict().keys():
                    raise AssertionError("[cli-pretrain-lora] the int8 run did not save adapters")
                what = f"the adapters saved ({lora.num_params(straight.model):,} parameters)"
            else:
                what = f"adafactor's state {straight.opt_state_bytes() / 1e3:.1f} kB"
            on_card = next(straight.model.parameters()).device.type == "cuda"
            log(f"[cli-pretrain-lora] {' '.join(flags)}: 4 steps in {sec:.1f} s, losses "
                + ", ".join(f"{x:.4f}" for x in losses)
                + f"; resumed after step 2 equals the uninterrupted run bit for bit: {same}; "
                f"{what}; on the card: {on_card}")
            if not (same and on_card and len(losses) == 4 and all(np.isfinite(losses))
                    and "resumed from" in out_b):
                raise AssertionError(f"[cli-pretrain-lora] {flags}: losses {losses}, resume "
                                     f"equal {same}, on the card {on_card}")

    meta = esm2.ESM2(esm2.ESM2Config(**esm2.ESM2_SIZES["esm2_t33_650M_UR50D"]), device="meta")
    sizes = {}
    for name, factored in (("AdamW", False), ("adafactor", True)):
        sizes[name] = training.init_state(
            meta, training.make_optimizer(factored=factored)).opt_state_bytes()
    n = sum(p.numel() for p in meta.parameters())
    log(f"[cli-pretrain-lora] optimizer state of ESM2-650M ({n / 1e6:.1f}M parameters, at "
        f"init): AdamW {sizes['AdamW'] / 1e9:.3f} GB, adafactor {sizes['adafactor'] / 1e6:.2f} "
        f"MB ({sizes['adafactor'] / sizes['AdamW']:.5f} of AdamW's)")


# ---------------------------------------------------------------------------
# ESMFold fine-tuning, the fine-tuning examples and ESM2-15B in int8
# ---------------------------------------------------------------------------

FOLD_TRAIN_L = 128     # the largest of L in {128, 256} whose step fits the card (PERF.md)
FOLD_TRAIN_LR = 1e-5   # fold_optimizer's rate in [train-fold]: at 1e-4 the loss of this
                       # random init jumped 2.82 -> 9.05 at step 2 (PERF.md §6)
FOLD_LORA_LR = 1e-4    # the adapters' rate: 1e-3 raised the loss at step 1 (PERF.md §6)
FOLD_LORA_RANK = 8
# [train-fold] card vs CPU at 2 trunk blocks and 2 LM layers, fp32, TF32 off:
# per tensor, the largest gradient error over the tensor's largest |gradient|
# (or 1e-3 of the largest over all tensors, for tensors whose gradient is zero
# but for rounding); the loss relative
FOLD_GRAD_TOL = 2e-4
# [cli-fold-finetune]: the example's printed losses, card vs --cpu, relative
# (fp32 on both; Adam's first update lr g / (|g| + 1e-8) lets the rounding of
# near-zero gradients decide a share of lr on those elements)
FINETUNE_LOSS_TOL = 1e-3
ESM2_15B_PARAMS = 15_129_100_194  # esm2_t48_15B_UR50D, counted from the port's module shapes
# [int8-15b], both against a streamed fp32 forward of the same weights: the
# int8 logits' largest error at most INT8_ERR_RATIO times the bf16 copy's, and
# their argmax agreement at most INT8_AGREE_DROP below the bf16 copy's (read
# 1.187x and 0.042 on the H100, PERF.md §6). esm_tpu's agreement above 0.95
# (its 2-layer test's) cannot hold at 48 random layers: the bf16 copy itself
# agrees with fp32 at 0.959.
INT8_ERR_RATIO = 1.4
INT8_AGREE_DROP = 0.06


def fold_train_batch(length, seed, device):
    """(aa, mask, coords, coord_mask) of one seeded NeRF backbone and a random
    sequence of ``length`` residues, B=1."""
    import torch
    from esm_tpu_torch.models import esmfold as ef

    aa, mask, _, _, _ = ef.batch_encode_sequences([random_protein(length, seed + 1)],
                                                  residue_index_offset=None, chain_linker=None)
    coords = ideal_backbone(length, seed)[None]
    return tuple(torch.from_numpy(np.asarray(x)).to(device) for x in
                 (aa, mask.astype(np.float32), coords, np.ones((1, length), np.float32)))


def fold_grad_errors(got, want):
    """Per-tensor errors as FOLD_GRAD_TOL measures them; returns (worst, its name)."""
    scale = max(g.abs().max().item() for g in want.values())
    worst, where = 0.0, ""
    for name, g in want.items():
        err = (got[name] - g).abs().max().item() / max(g.abs().max().item(), 1e-3 * scale)
        if err > worst:
            worst, where = err, name
    return worst, where


def plain_pair_ops_ms(model, cfg, length):
    """ms of one forward + backward of the trunk's plain triangle attention
    (starting node) and of its tri-mul (outgoing), block 0's weights, on a
    seeded (1, L, L, c_z) fp32 pair tensor with the trunk's mask: what each
    of their 96 calls a step costs the fold step (CUDA events)."""
    import torch
    from esm_tpu_torch.ops import triangle

    block = model.trunk.blocks[0]
    gen = torch.Generator(device="cuda").manual_seed(87)
    z = torch.randn(1, length, length, cfg.trunk.pairwise_state_dim, device="cuda",
                    generator=gen).requires_grad_(True)
    mask = torch.ones(1, length, length, device="cuda")
    calls = {
        "tri_att": lambda: triangle.triangle_attention(
            block.tri_att_start, z, num_heads=cfg.trunk.pair_heads, starting=True, mask=mask),
        "tri_mul": lambda: triangle.triangle_multiplicative_update(
            block.tri_mul_out, z, outgoing=True, mask=mask),
    }
    out = {k: cuda_time_ms(lambda: fn().sum().backward(), iters=10, warmup=2)
           for k, fn in calls.items()}
    model.zero_grad(set_to_none=True)
    return out


def phase_train_fold(card):
    """ESMFold fine-tuning at ESMFold v1's released widths (ESM2-3B LM in bf16
    through K1, 48 trunk blocks c_s 1024 c_z 128 in fp32 on the plain
    triangle paths, 8 structure-module blocks; seeded, the zero-initialized
    layers re-drawn), B=1 on one NeRF backbone of FOLD_TRAIN_L residues:
    one step from a saved state twice (bit for bit), 5 more steps (the loss
    falls; K1 36 launches a step, K6/K7/K8 none), one step with 3 recycles,
    4 LoRA steps (rank 8) over the trained weights; then card vs CPU
    gradients at 2 trunk blocks and 2 LM layers, fp32."""
    import copy
    import dataclasses

    import torch
    from esm_tpu_torch import lora, pretrained, training
    from esm_tpu_torch.models import esmfold as ef
    from esm_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    handle = pretrained.random_esmfold("esmfold_v1", seed=80, device="cuda",
                                       lm_dtype=torch.bfloat16, use_flash=True)
    cfg, model = handle.cfg, handle.model
    redraw_zero_layers(model, seed=81)
    trainable = training.split_fold_params(model)
    n_train = sum(p.numel() for p in trainable.values())
    L = FOLD_TRAIN_L
    batch = fold_train_batch(L, seed=82, device="cuda")
    log(f"[train-fold] ESMFold v1 (ESM2-3B LM bf16 with K1, frozen; trunk {cfg.trunk.num_blocks} "
        f"blocks c_s {cfg.trunk.sequence_state_dim} c_z {cfg.trunk.pairwise_state_dim} fp32, "
        f"plain triangle paths; {n_train / 1e6:.1f}M trainable parameters), B=1 L={L}, "
        f"fold_optimizer lr {FOLD_TRAIN_LR}; built in {time.perf_counter() - t0:.1f} s")
    if cfg.trunk.use_flash_tri or cfg.trunk.compute_dtype != torch.float32:
        raise AssertionError(f"[train-fold] trunk options {cfg.trunk}")
    tx = training.fold_optimizer(FOLD_TRAIN_LR)
    state = training.init_state(model, tx)

    def step(num_recycles=0):
        nonlocal state
        sec, (state, metrics) = profiling.timed(
            lambda: training.train_step_fold(state, cfg, tx, *batch, num_recycles=num_recycles),
            iters=1, warmup=0)
        return metrics["loss"].item(), sec

    # step 0 twice from one state: bit for bit
    saved = {n: p.detach().clone() for n, p in trainable.items()}
    zero_counts()
    loss0, _ = step()
    counts0 = read_counts()
    first = {n: p.detach().clone() for n, p in trainable.items()}
    first_mu = {n: m.clone() for n, m in state.opt_state.mu.items()}
    with torch.no_grad():
        for n, p in trainable.items():
            p.copy_(saved[n])
    state = training.init_state(model, tx)
    loss_again, _ = step()
    repeat = (loss_again == loss0
              and all(torch.equal(p, first[n]) for n, p in trainable.items())
              and all(torch.equal(m, first_mu[n]) for n, m in state.opt_state.mu.items()))
    del saved, first, first_mu
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    losses, secs = [loss0], []
    for _ in range(TRAIN_STEPS - 1):
        loss, sec = step()
        losses.append(loss)
        secs.append(sec)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: v / (TRAIN_STEPS - 1) for k, v in counts.items()}
    want = {"flash_attention": cfg.esm.num_layers, "flash_attention_with_lse": 0,
            "flash_attention_bwd.dq": 0, "flash_attention_bwd.dkv": 0,
            "triangle_attention_fused": 0, "tri_mul_stage1": 0, "tri_mul_epilogue": 0}
    ms = 1e3 * float(np.mean(secs))
    log(f"[train-fold] losses over {TRAIN_STEPS} steps: " + ", ".join(f"{x:.5f}" for x in losses)
        + f"; step 0 repeated bit for bit from the same state: {repeat}")
    log(f"[train-fold] launches per step {per_step} (step 0: {counts0}; expected {want})")
    log(f"[train-fold] full step, num_recycles 0: {ms:.1f} ms a step (CUDA events, mean of "
        f"steps 1-{len(secs)}), peak memory {peak / 1e9:.3f} GB over them "
        f"(torch.cuda.max_memory_allocated; ESMFold v1 B=1 L={L}; {card})")
    if per_step != want or counts0 != want:
        raise AssertionError(f"[train-fold] launches per step {per_step}, step 0 {counts0}")
    if not (repeat and all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"[train-fold] repeat {repeat}, losses {losses}")

    profile(f"one [train-fold] step (L={L})", lambda: step(), top=12, by_op=True)
    pair_ms = plain_pair_ops_ms(model, cfg, L)
    log(f"[train-fold] the plain pair ops at B=1, L={L}, c_z {cfg.trunk.pairwise_state_dim}, "
        f"fp32, forward + backward a call: triangle attention {pair_ms['tri_att']:.3f} ms, "
        f"tri-mul {pair_ms['tri_mul']:.3f} ms; 96 calls of each a step: "
        f"{96 * pair_ms['tri_att']:.1f} ms and {96 * pair_ms['tri_mul']:.1f} ms of the "
        f"{ms:.1f} ms step ({card})")
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    loss_r, sec_r = step(num_recycles=3)
    counts_r = read_counts()
    peak_r = torch.cuda.max_memory_allocated()
    log(f"[train-fold] full step, num_recycles 3: {1e3 * sec_r:.1f} ms, peak memory "
        f"{peak_r / 1e9:.3f} GB, loss {loss_r:.5f}, launches {counts_r}")
    if counts_r != want or not np.isfinite(loss_r):
        raise AssertionError(f"[train-fold] 3 recycles: launches {counts_r}, loss {loss_r}")
    del state, tx
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    before = {n: p.detach().cpu() for n, p in trainable.items()}  # off the card: not in the peak
    adapters = lora.init_lora(torch.Generator(device="cuda").manual_seed(83), model,
                              rank=FOLD_LORA_RANK, targets=lora.fold_targets)
    ltx = training.fold_optimizer(FOLD_LORA_LR)
    lstate = training.init_state(adapters, ltx)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    llosses, lsecs = [], []
    for _ in range(4):
        sec, (lstate, m) = profiling.timed(
            lambda: training.train_step_fold_lora(lstate, model, cfg, ltx, *batch),
            iters=1, warmup=0)
        llosses.append(m["loss"].item())
        lsecs.append(sec)
    lcounts = read_counts()
    lpeak = torch.cuda.max_memory_allocated()
    unchanged = all(torch.equal(p.cpu(), before[n]) for n, p in trainable.items())
    log(f"[train-fold] LoRA rank {FOLD_LORA_RANK} over the trunk and heads "
        f"({lora.num_params(adapters):,} adapter parameters), lr {FOLD_LORA_LR}: losses "
        + ", ".join(f"{x:.5f}" for x in llosses)
        + f"; {1e3 * float(np.mean(lsecs[1:])):.1f} ms a step, peak memory {lpeak / 1e9:.3f} GB "
        f"(full step {peak / 1e9:.3f} GB); base unchanged: {unchanged}; launches {lcounts}")
    if not (unchanged and lpeak < peak and llosses[-1] < llosses[0]
            and lcounts["flash_attention"] == 4 * cfg.esm.num_layers):
        raise AssertionError(f"[train-fold] LoRA: base unchanged {unchanged}, peak {lpeak} vs "
                             f"{peak}, losses {llosses}, launches {lcounts}")
    del handle, model, adapters, lstate, before, trainable
    torch.cuda.empty_cache()

    # card vs CPU at a cut depth, fp32 with TF32 off
    small = dataclasses.replace(
        cfg, esm=dataclasses.replace(cfg.esm, num_layers=2, compute_dtype=torch.float32,
                                     use_flash=False),
        trunk=dataclasses.replace(cfg.trunk, num_blocks=2))
    cpu_model = ef.init_esmfold(small, torch.Generator().manual_seed(84), device="cpu")
    redraw_zero_layers(cpu_model, seed=85, device="cpu")
    training.split_fold_params(cpu_model)
    cpu_batch = fold_train_batch(48, seed=86, device="cpu") + (None,)

    def loss_fn(m):
        return training._fold_loss(m, small, tuple(None if t is None else t.to(m.device)
                                                   for t in cpu_batch), None, 1)[0]

    l_cpu, g_cpu, l_card, g_card, repeat_small = card_and_cpu_grads(
        cpu_model, copy.deepcopy(cpu_model).cuda(), loss_fn)
    loss_err = abs(l_card - l_cpu) / abs(l_cpu)
    err, where = fold_grad_errors(g_card, g_cpu)
    log(f"[train-fold] card vs CPU, 2 trunk blocks and 2 LM layers at the released widths, "
        f"L=48, 1 recycle, fp32 (TF32 off, the CPU on one thread): loss {l_card:.7f} vs "
        f"{l_cpu:.7f} (relative {loss_err:.2e}), gradients per tensor {err:.2e} of the "
        f"tensor's largest (worst {where}; bound {FOLD_GRAD_TOL}); the card repeated bit for "
        f"bit: {repeat_small}")
    if not (loss_err <= 1e-5 and err <= FOLD_GRAD_TOL and repeat_small):
        raise AssertionError(f"[train-fold] card vs CPU: loss {loss_err}, gradients {err}, "
                             f"repeat {repeat_small}")
    return dict(L=L, ms=ms, peak=peak, ms_r3=1e3 * sec_r, peak_r3=peak_r, lora_peak=lpeak,
                lora_ms=1e3 * float(np.mean(lsecs[1:])))


def run_fold_finetune(argv):
    from esm_tpu_torch.examples import esmfold_finetune

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        _, losses = esmfold_finetune.main(esmfold_finetune.create_parser().parse_args(argv))
    return losses, buf.getvalue(), time.perf_counter() - t0


def phase_cli_fold_finetune():
    """esm_tpu_torch.examples.esmfold_finetune on three seeded NeRF backbones
    of unequal length written as PDB files, 4 steps with --lora and
    --lm-aux-weight 0.1 on the card and with --cpu (the tiny default model):
    the printed losses agree within FINETUNE_LOSS_TOL."""
    with tempfile.TemporaryDirectory() as tmp:
        for i, n in enumerate((40, 57, 73)):
            write_backbone(os.path.join(tmp, f"b{i}.pdb"),
                           {"A": (ideal_backbone(n, 90 + i), random_protein(n, 95 + i))}, "pdb")
        common = ["--pdbs", tmp, "--steps", "4", "--log-every", "1", "--batch-size", "2",
                  "--lora", "--lm-aux-weight", "0.1", "--lr", "1e-3"]
        card, out, sec = run_fold_finetune(common)
        cpu, _, sec_cpu = run_fold_finetune(common + ["--cpu"])
    err = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    log(f"[cli-fold-finetune] 3 PDB backbones (40, 57, 73 residues), B=2, --lora "
        f"--lm-aux-weight 0.1, 4 steps: card {sec:.1f} s, losses "
        + ", ".join(f"{x:.6f}" for x in card) + f"; CPU {sec_cpu:.1f} s, losses "
        + ", ".join(f"{x:.6f}" for x in cpu)
        + f"; largest relative difference {err:.2e} (bound {FINETUNE_LOSS_TOL})")
    if not ("merged LoRA adapters" in out and len(card) == 4 and all(np.isfinite(card))
            and err <= FINETUNE_LOSS_TOL):
        raise AssertionError(f"[cli-fold-finetune] card {card}, CPU {cpu}")


def phase_ss_finetune(card):
    """esm_tpu_torch.examples.finetune_secondary_structure on the card with
    --synthetic 64 at its default LM (6 x 320, seeded): the frozen LM (K1 once
    a layer a step) for 40 steps, the loss falls; --train-lm for 4 steps: K1
    with the lse once a layer and K2's dq and dk/dv passes once a layer a
    step."""
    from esm_tpu_torch.examples import finetune_secondary_structure as ss

    runs = {}
    for name, flags, steps in (("frozen LM", [], 40), ("--train-lm", ["--train-lm"], 4)):
        args = ss.create_parser().parse_args(
            ["--synthetic", "64", "--steps", str(steps), "--log-every", str(steps)] + flags)
        buf = io.StringIO()
        zero_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            model, _, losses = ss.run(args)
        sec = time.perf_counter() - t0
        counts = read_counts()
        n_layers = model.lm.cfg.num_layers
        per_step = {k: v / steps for k, v in counts.items() if v}
        want = ({"flash_attention": n_layers} if not flags else
                {"flash_attention_with_lse": n_layers, "flash_attention_bwd.dq": n_layers,
                 "flash_attention_bwd.dkv": n_layers})
        log(f"[ss-finetune] {name}: {steps} steps in {sec:.1f} s, loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f} (mean of the first and last 5 steps: {np.mean(losses[:5]):.4f} "
            f"-> {np.mean(losses[-5:]):.4f}); launches per step {per_step} (expected {want}; "
            f"{card})")
        if per_step != want or not all(np.isfinite(losses)):
            raise AssertionError(f"[ss-finetune] {name}: launches {per_step}, losses {losses}")
        runs[name] = losses
    frozen = runs["frozen LM"]
    if not np.mean(frozen[-5:]) < np.mean(frozen[:5]):
        raise AssertionError(f"[ss-finetune] the frozen-LM loss did not fall: {frozen}")


def streamed_fp32_logits(model_name, seed, tokens):
    """The fp32 logits of seeded_esm2's weights (TF32 off, exact attention),
    drawing the weights again from the seed one layer at a time, so no fp32
    copy of the model is held."""
    import dataclasses

    import torch
    from esm_tpu_torch.examples.esm2_15b_int8_single_chip import seeded_parts
    from esm_tpu_torch.models import esm2
    from esm_tpu_torch.models.lm_common import transformer_layer_apply
    from esm_tpu_torch.ops.common import layer_norm
    from esm_tpu_torch.ops.heads import roberta_lm_head

    parts = seeded_parts(model_name, seed, "cuda")
    cfg, shell = next(parts)
    cfg = dataclasses.replace(cfg, compute_dtype=torch.float32, use_flash=False)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            x = esm2.embed_tokens(shell, cfg, tokens)
            pad = tokens == cfg.padding_idx
            for layer in parts:
                x, _ = transformer_layer_apply(layer, x, static=cfg.layer_static(),
                                               key_padding_mask=pad)
                del layer
            x = layer_norm(shell.emb_layer_norm_after, x)
            return roberta_lm_head(shell.lm_head, x.float(), shell.embed_tokens.weight)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def phase_int8_15b(card):
    """ESM2-15B (48 x 5120, 40 heads) on seeded weights built one layer at a
    time on the card (esm_tpu_torch.examples.esm2_15b_int8_single_chip: no
    fp32 copy of the model), in weight-only int8, beside a bf16 copy of the
    same weights: one B=1, L=1022 forward of each through K1 (48 launches),
    the int8 logits held to the bf16 ones, and to an fp32 forward of the same
    weights, under esm_tpu's int8 bound of the largest error, 0.15 (max|ref|
    + 1); against fp32, the int8 error and argmax agreement are held to the
    bf16 copy's within INT8_ERR_RATIO and INT8_AGREE_DROP."""
    import torch
    from esm_tpu_torch.examples.esm2_15b_int8_single_chip import seeded_esm2
    from esm_tpu_torch.quantization import param_bytes

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    handle, twin, alphabet = seeded_esm2("esm2_t48_15B_UR50D", 100, "cuda", bf16_copy=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated()
    n = sum(p.numel() for p in handle.model.parameters())
    tokens = torch.from_numpy(bench_tokens(alphabet, 1, 1022, seed=101)).cuda()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    with torch.no_grad():
        got = handle(tokens)["logits"]
        torch.cuda.synchronize()
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        ref = twin(tokens)["logits"]
        scale = ref.float().abs().max().item()
        err = (got.float() - ref.float()).abs().max().item()
        agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
        sec = cuda_time_ms(lambda: handle(tokens)["logits"], iters=3, warmup=1) / 1e3
        sec_bf16 = cuda_time_ms(lambda: twin(tokens)["logits"], iters=3, warmup=1) / 1e3
    f32 = streamed_fp32_logits("esm2_t48_15B_UR50D", 100, tokens)
    scale32 = f32.abs().max().item()
    err32 = (got.float() - f32).abs().max().item()
    agree32 = (got.argmax(-1) == f32.argmax(-1)).float().mean().item()
    err16 = (ref.float() - f32).abs().max().item()
    agree16 = (ref.argmax(-1) == f32.argmax(-1)).float().mean().item()
    top2 = ref.float().topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1])[0]
    flips = (got.argmax(-1) != ref.argmax(-1))[0]
    pb, pb16 = param_bytes(handle.model), param_bytes(twin.model)
    log(f"[int8-15b] ESM2-15B ({n:,} parameters), seeded, built layer by layer in "
        f"{build_s:.1f} s (peak {build_peak / 1e9:.2f} GB with the bf16 copy); parameter "
        f"bytes int8 {pb / 1e9:.3f} GB, bf16 copy {pb16 / 1e9:.3f} GB")
    log(f"[int8-15b] B=1 T=1024 forward: K1 launched {counts['flash_attention']} times; "
        f"peak memory {peak / 1e9:.3f} GB (both models resident); int8 {1 / sec:.3f} seq/s "
        f"({sec * 1e3:.1f} ms), bf16 {1 / sec_bf16:.3f} seq/s ({sec_bf16 * 1e3:.1f} ms) ({card})")
    log(f"[int8-15b] int8 logits against the bf16 copy: max abs err {err:.4f} (bound "
        f"{0.15 * (scale + 1):.3f}), argmax agreement {agree:.5f}; against an fp32 forward of "
        f"the same weights (drawn again one layer at a time, TF32 off): max abs err "
        f"{err32:.4f} (bound {0.15 * (scale32 + 1):.3f}), argmax agreement {agree32:.5f}; the "
        f"bf16 copy against fp32: {err16:.4f}, {agree16:.5f}")
    log(f"[int8-15b] against fp32, int8 vs the bf16 copy: largest error {err32 / err16:.4f}x "
        f"(bound {INT8_ERR_RATIO}x), argmax agreement {agree16 - agree32:.5f} lower (bound "
        f"{INT8_AGREE_DROP}); the bf16 logits' top-2 margin has median "
        f"{margin.median().item():.4f}, and the int8 flips lie at margins up to "
        f"{margin[flips].max().item() if flips.any() else 0.0:.4f}")
    if n != ESM2_15B_PARAMS:
        raise AssertionError(f"[int8-15b] {n} parameters, expected {ESM2_15B_PARAMS}")
    if counts["flash_attention"] != 48 or sum(counts.values()) != 48:
        raise AssertionError(f"[int8-15b] launches {counts}")
    if not (torch.isfinite(got).all() and err < 0.15 * (scale + 1)
            and err32 < 0.15 * (scale32 + 1) and err32 <= INT8_ERR_RATIO * err16
            and agree32 >= agree16 - INT8_AGREE_DROP):
        raise AssertionError(f"[int8-15b] logits off: err {err} (bf16), {err32} (fp32, bf16's "
                             f"{err16}), agreement with fp32 {agree32} (bf16's {agree16})")
    del handle, twin, got, ref
    torch.cuda.empty_cache()
    return dict(bytes=pb, peak=peak, seq_s=1 / sec)


# [design]: the lm-design example's seed sequence (examples/lm_design_fixedbb.py)
DESIGN_SEED_SEQ = "MKTVRQERLKSIVRILERSKEPVSGAQLAEELSVSRQVIVQDIAYLRSLGYNIVATPRGYVLAGG"
DESIGN_BATCH = 4
DESIGN_TOL = 1e-4          # relative, fp32 chain energies: flash vs exact, card vs CPU
DESIGN_AGREE_STEPS = 50    # the fp32 flash chain against the exact one
DESIGN_STEPS = 1000        # the bf16 flash chain under sync-debug "error"
DESIGN_STEPLR = {"scheduler": "StepLR", "initial": 8, "step_size": 10000, "gamma": 0.5}
GIBBS_STEPS = 200
FREE_GEN_STEPS, FREE_GEN_EVERY = 40, 10
PPL_FOLD_TOL = 1e-3        # callback CA vs infer's, share of the largest magnitude
PPL_CONF_TOL = 1e-4        # callback pLDDT (0-1) and pTM vs infer's


class ReplayDraws:
    """Pre-drawn MH draws, (steps, B) each, handed out one step at a time."""

    def __init__(self, pos, prop, u):
        self.rows = iter(zip(pos, prop, u))

    def mh(self, b, L):
        return next(self.rows)


@contextlib.contextmanager
def sync_errors():
    """torch.cuda.set_sync_debug_mode("error") inside: any synchronizing call
    (.item(), .cpu(), a pageable copy, a nonzero) raises."""
    import torch

    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def rel_err_max(got, want):
    """max |got - want| / |want| elementwise (want nonzero here)."""
    return ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()


def phase_design(card):
    """LM design (esm_tpu_torch.apps.lm_design) with ESM2-650M at its released
    size (seeded), the example's 65-residue seed sequence, batch 4 (2·B = 8
    rows of T = 67 a step): (a) fp32 with TF32 off, 50 MH steps on draws
    made once on a CPU generator: the flash chain (K1) against the exact one
    (accept flags, so tokens, equal at every step; energies within
    DESIGN_TOL relative), its first step against a CPU fp32 forward of the
    same weights; (b) bf16 flash, Designer.run for 1000 steps at the
    reference's StepLR temperature under sync-debug "error" (the readback
    after it): K1 33 launches a step and nothing else, finite energies, an
    accept rate in (0, 1); ms a step, steps/s, a profile of 20 steps; then
    200 Gibbs steps and 40 free-generation steps (a seeded distogram
    projection over the 33 x 20 maps, targets resampled every 10), both
    under sync-debug "error", K1 33 a step."""
    import copy
    import dataclasses

    import torch
    from esm_tpu_torch import pretrained
    from esm_tpu_torch.apps import lm_design as ld

    t_phase = time.perf_counter()
    handle, alphabet = pretrained.random_model_and_alphabet("esm2_t33_650M_UR50D", seed=21,
                                                            device="cuda")
    model, n_layers, B = handle.model, handle.num_layers, DESIGN_BATCH
    toks = alphabet.get_batch_converter()(
        [(f"seed{i}", DESIGN_SEED_SEQ) for i in range(B)])[2].cuda()
    L = toks.shape[1] - 2

    # (a) fp32, flash against exact, on the same injected draws
    gen = torch.Generator().manual_seed(22)
    draws = [ld.draw_mh(gen, B, L, "cpu") for _ in range(DESIGN_AGREE_STEPS)]
    pos, prop, u = (torch.stack(x).cuda() for x in zip(*draws))
    dcfg = ld.DesignConfig(num_iter=DESIGN_AGREE_STEPS, temperature=0.1)
    cfgs = {name: dataclasses.replace(handle.cfg, compute_dtype=torch.float32, use_flash=flash)
            for name, flash in (("flash", True), ("exact", False))}
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    chains = {}
    for name, cfg in cfgs.items():
        zero_counts()
        chains[name] = ld.run_chain(model, cfg, None, dcfg, toks, ReplayDraws(pos, prop, u))
        torch.cuda.synchronize()
        if name == "flash" and read_counts()["flash_attention"] != n_layers * DESIGN_AGREE_STEPS:
            raise AssertionError(f"[design] fp32 flash chain launches {read_counts()}")
    with torch.no_grad():
        proposal = toks.scatter(1, pos[0][:, None], prop[0][:, None])
        stacked, pos2 = torch.cat([toks, proposal]), torch.cat([pos[0], pos[0]])
        e_card = ld.total_energy(model, cfgs["flash"], None, dcfg, stacked, pos2)
        cpu_model = copy.deepcopy(model).cpu()
        e_cpu = ld.total_energy(cpu_model, cfgs["exact"], None, dcfg, stacked.cpu(), pos2.cpu())
        del cpu_model
    torch.backends.cuda.matmul.allow_tf32 = prev
    (tok_f, e_f, acc_f), (tok_e, e_e, acc_e) = chains["flash"], chains["exact"]
    same_acc = torch.equal(acc_f, acc_e)
    err = rel_err_max(e_f, e_e)
    err_abs = (e_f - e_e).abs().max().item()
    err_cpu = rel_err_max(e_card.cpu(), e_cpu)
    log(f"[design] ESM2-650M fp32 (TF32 off), B={B} (2·B = {2 * B} rows, T={toks.shape[1]}), "
        f"T=0.1, {DESIGN_AGREE_STEPS} MH steps on draws made once on a CPU generator: accept "
        f"flags flash vs exact equal at every step {same_acc} (accept rate "
        f"{acc_f.float().mean().item():.3f}), final tokens equal {torch.equal(tok_f, tok_e)}, "
        f"energies max rel err {err:.3e} (max abs err {err_abs:.3e}, energies "
        f"{e_e.abs().min().item():.3e}-{e_e.abs().max().item():.3e}); the first step's 2·B energies on the card (flash) "
        f"against a CPU fp32 forward: max rel err {err_cpu:.3e} (bound {DESIGN_TOL})")
    if not (same_acc and torch.equal(tok_f, tok_e) and err <= DESIGN_TOL
            and err_cpu <= DESIGN_TOL and torch.allclose(e_card[:B], e_f[0], rtol=DESIGN_TOL)):
        raise AssertionError(f"[design] fp32 flash vs exact chain: accepts equal {same_acc}, "
                             f"energy err {err}, card vs CPU {err_cpu}")
    del chains, e_card, e_cpu

    # (b) bf16 flash through Designer, no host sync inside the loop
    bf16 = handle.with_options(compute_dtype=torch.bfloat16, use_flash=True)
    designer = ld.Designer(bf16)
    dcfg = ld.DesignConfig(num_iter=DESIGN_STEPS, temperature=DESIGN_STEPLR, seed=23)
    designer.run(DESIGN_SEED_SEQ, dataclasses.replace(dcfg, num_iter=3), batch=B)  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    with sync_errors():
        tokens, energies, accepts = designer.run(DESIGN_SEED_SEQ, dcfg, batch=B)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = read_counts()
    seqs = ld.sequences(alphabet, tokens)
    energies, rate = energies.cpu().numpy(), accepts.float().mean().item()
    ms_step = sec / DESIGN_STEPS * 1e3
    wall, busy, _ = profile(f"[design] 20 bf16 MH steps (B={B}, 2·B rows of T={L + 2})",
                            lambda: designer.run(DESIGN_SEED_SEQ,
                                                 dataclasses.replace(dcfg, num_iter=20),
                                                 batch=B))
    log(f"[design] bf16 flash Designer.run, {DESIGN_STEPS} steps at StepLR(8, 10000, 0.5) "
        f"under sync-debug \"error\": {ms_step:.3f} ms a step, {1e3 / ms_step:.2f} steps/s "
        f"({card}); a profile of 20 steps: device busy {100 * busy / wall:.1f}% of its "
        f"{wall / 20:.3f} ms a step, {busy / 20:.3f} ms of device time a step, "
        f"{100 * busy / 20 / ms_step:.1f}% of the unprofiled step; K1 launched {counts['flash_attention']} times "
        f"({counts['flash_attention'] / DESIGN_STEPS:.1f} a step); accept rate {rate:.4f}; "
        f"energies {energies[0].mean():.4f} -> {energies[-1].mean():.4f} (mean over the batch)")
    log(f"[design] design 0: {seqs[0]}")
    want = n_layers * DESIGN_STEPS
    if counts["flash_attention"] != want or sum(counts.values()) != want:
        raise AssertionError(f"[design] launches {counts}, expected K1 x {want} only")
    if not (np.isfinite(energies).all() and 0.0 < rate < 1.0 and energies.shape == (DESIGN_STEPS, B)
            and all(len(s) == L and set(s) <= set("ACDEFGHIKLMNPQRSTVWY") for s in seqs)):
        raise AssertionError(f"[design] energies finite {np.isfinite(energies).all()}, accept "
                             f"rate {rate}, designs {seqs}")

    # Gibbs and free generation, bf16 flash
    zero_counts()
    t0 = time.perf_counter()
    with sync_errors():
        gibbs = ld.gibbs_free_generation(bf16.model, bf16.cfg, toks, GIBBS_STEPS, seed=24)
    torch.cuda.synchronize()
    gibbs_ms = (time.perf_counter() - t0) / GIBBS_STEPS * 1e3
    gibbs_counts = read_counts()
    designed = gibbs[:, 1:-1]
    log(f"[design] Gibbs, {GIBBS_STEPS} bf16 steps under sync-debug \"error\": {gibbs_ms:.3f} "
        f"ms a step; K1 {gibbs_counts['flash_attention']} launches; designs of standard "
        f"residues only {bool(((designed >= 4) & (designed < 24)).all().item())}")
    if (gibbs_counts["flash_attention"] != n_layers * GIBBS_STEPS
            or sum(gibbs_counts.values()) != n_layers * GIBBS_STEPS
            or not ((designed >= 4) & (designed < 24)).all()):
        raise AssertionError(f"[design] Gibbs: launches {gibbs_counts}, tokens {gibbs}")

    proj = ld.DistogramProjection(n_layers * handle.attention_heads, device="cuda")
    pgen = torch.Generator(device="cuda").manual_seed(25)
    with torch.no_grad():
        for p in proj.parameters():
            p.normal_(generator=pgen).mul_(0.5)
    zero_counts()
    t0 = time.perf_counter()
    with sync_errors():
        free_tokens, free_e = ld.free_generation(bf16.model, bf16.cfg, proj, toks,
                                                 num_iter=FREE_GEN_STEPS,
                                                 resample_y_every=FREE_GEN_EVERY, seed=26)
    torch.cuda.synchronize()
    free_ms = (time.perf_counter() - t0) / FREE_GEN_STEPS * 1e3
    free_counts = read_counts()
    free_e = free_e.cpu().numpy()
    log(f"[design] free generation, {FREE_GEN_STEPS} MH steps (targets resampled every "
        f"{FREE_GEN_EVERY}; the projection's forwards take the exact path) under sync-debug "
        f"\"error\": {free_ms:.3f} ms a step; K1 {free_counts['flash_attention']} launches; "
        f"energies {free_e.shape} finite {np.isfinite(free_e).all()}, "
        f"{free_e[0, 0].mean():.4f} -> {free_e[-1, -1].mean():.4f}")
    if (free_counts["flash_attention"] != n_layers * FREE_GEN_STEPS
            or sum(free_counts.values()) != n_layers * FREE_GEN_STEPS
            or free_e.shape != (FREE_GEN_STEPS // FREE_GEN_EVERY, FREE_GEN_EVERY, B)
            or not np.isfinite(free_e).all() or free_tokens.shape != toks.shape):
        raise AssertionError(f"[design] free generation: launches {free_counts}, energies "
                             f"{free_e}")
    del handle, bf16, designer, model, proj
    torch.cuda.empty_cache()
    log(f"[design] took {time.perf_counter() - t_phase:.1f} s")


class TimedFolds:
    """A folding callback that times each fold: host clock (the fold ends in
    its readback) and CUDA events around it."""

    def __init__(self, inner):
        self.inner, self.wall, self.device_ms = inner, [], []

    def fold(self, sequence, residue_indices):
        import torch

        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        result = self.inner.fold(sequence, residue_indices)
        end.record()
        end.synchronize()
        self.wall.append(time.perf_counter() - t0)
        self.device_ms.append(start.elapsed_time(end))
        return result


def timed_anneal(tag, program, callback, steps):
    """run_simulated_annealing over a TimedFolds: its state, seconds a step,
    and the fold's and the rest's (the host energy terms: SASA, RMSDs, SSE;
    the program copies) seconds a step."""
    from esm_tpu_torch.apps import ppl

    timed = TimedFolds(callback)
    np.random.seed(35)
    t0 = time.perf_counter()
    state = ppl.run_simulated_annealing(program, timed, total_num_steps=steps,
                                        display_progress=False)
    sec = (time.perf_counter() - t0) / steps
    fold_s, fold_dev = np.mean(timed.wall), np.mean(timed.device_ms) / 1e3
    log(f"[ppl] {tag}: {steps} steps, {sec:.4f} s a step: the fold {fold_s:.4f} s (CUDA events "
        f"{fold_dev:.4f} s), the host energy terms and the rest {sec - fold_s:.4f} s; energies "
        f"{state.energy_trace[0]:.4f} -> {state.energy_trace[-1]:.4f}, current "
        f"{state.current_energy:.4f}, best {state.best_energy:.4f}, {state.num_accepts} accepts")
    if not (state.num_steps == steps and len(timed.wall) == steps
            and np.isfinite(state.energy_trace).all()
            and state.best_energy <= state.current_energy):
        raise AssertionError(f"[ppl] {tag}: steps {state.num_steps}, energies "
                             f"{state.energy_trace}, best {state.best_energy}, current "
                             f"{state.current_energy}")


def phase_ppl(card):
    """The protein programming language (esm_tpu_torch.apps.ppl) over ESMFold
    v1 at its released size (seeded, zero layers re-drawn, fast preset) with
    ESMFoldCallback(num_recycles=1, bucket=16): a 100-residue fold through
    the callback against infer(num_recycles=1, pad_to_multiple=16) on the
    real rows (K1 36 and K6 192 a fold); then run_simulated_annealing on
    free_hallucination(100) for 10 steps and on fixed_backbone of an
    80-residue NeRF template for 5, each step's time split into the fold and
    the host energy terms."""
    import torch
    from esm_tpu_torch import pretrained
    from esm_tpu_torch.apps import ppl
    from esm_tpu_torch.models.esmfold.protein import atom14_to_atom37

    t_phase = time.perf_counter()
    handle = pretrained.random_esmfold("esmfold_v1", seed=31, device="cuda", fast=True)
    redraw_zero_layers(handle.model, seed=32)
    callback = ppl.ESMFoldCallback(handle, num_recycles=1, bucket=16)
    seq = random_protein(100, seed=33)
    zero_counts()
    res = callback.fold(seq, list(range(len(seq))))
    counts = read_counts()
    out = handle.infer([seq], num_recycles=1, pad_to_multiple=16)
    ca = torch.from_numpy(res.atoms.coord[res.atoms.atom_name == "CA"])
    ca_ref = atom14_to_atom37(out["positions"][-1], out["aatype"])[0, :len(seq), 1].float().cpu()
    err = (ca - ca_ref).abs().max().item() / ca_ref.abs().max().item()
    d_plddt = abs(res.plddt - out["plddt"][0, :len(seq), 1].mean().item() / 100)
    d_ptm = abs(res.ptm - out["ptm"][0].item())
    log(f"[ppl] ESMFold v1 (fast), ESMFoldCallback(num_recycles=1, bucket=16), L=100 (bucket "
        f"112): launches {counts}; against infer(num_recycles=1, pad_to_multiple=16) on the "
        f"real rows: CA max abs err {err:.3e} of the largest magnitude (bound {PPL_FOLD_TOL}), "
        f"|d pLDDT| {d_plddt:.2e}, |d pTM| {d_ptm:.2e} (bound {PPL_CONF_TOL}); pLDDT "
        f"{res.plddt:.4f}, pTM {res.ptm:.4f}, {len(res.atoms)} atoms")
    want_k6 = 2 * handle.cfg.trunk.num_blocks * 2
    if (counts["flash_attention"] != handle.cfg.esm.num_layers
            or counts["triangle_attention_fused"] != want_k6
            or sum(counts.values()) != want_k6 + handle.cfg.esm.num_layers):
        raise AssertionError(f"[ppl] fold launches {counts}: expected K1 x "
                             f"{handle.cfg.esm.num_layers}, K6 x {want_k6}")
    if not (err <= PPL_FOLD_TOL and d_plddt <= PPL_CONF_TOL and d_ptm <= PPL_CONF_TOL):
        raise AssertionError(f"[ppl] callback vs infer: CA {err}, pLDDT {d_plddt}, pTM {d_ptm}")
    del out

    np.random.seed(34)
    timed_anneal(f"free_hallucination(100) ({card})", ppl.free_hallucination(100),
                        callback, 10)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "template.pdb")
        write_backbone(path, {"A": (ideal_backbone(80, seed=36), random_protein(80, seed=37))},
                       "pdb")
        np.random.seed(34)
        program = ppl.fixed_backbone(ppl.pdb_file_to_atomview(path))
    timed_anneal(f"fixed_backbone of an 80-residue NeRF template ({card})", program,
                         callback, 5)
    del handle, callback
    torch.cuda.empty_cache()
    log(f"[ppl] took {time.perf_counter() - t_phase:.1f} s")


# example: its flags (beside --steps); "{pdb}" is an 80-residue template. Lengths of
# 60-87 residues: the host SASA (numpy, as in esm_tpu) is O(atoms^2) on the collapsed
# folds of random weights, seconds a call at ~800 atoms (PERF.md)
CLI_DESIGN_PPL = {
    "ppl_fixed_backbone": ["{pdb}"],
    "ppl_free_hallucination": ["--length", "60"],
    "ppl_secondary_structure": ["--segment-length", "30"],
    "ppl_site_scaffolding": ["{pdb}", "--flank-length", "20"],
    "ppl_symmetric_binding": ["{pdb}", "--flank-length", "10"],
    "ppl_symmetric_design": ["--protomer-length", "20"],
    "ppl_two_level_multimer": ["--protomer-length", "10"],
}
CLI_DESIGN_STEPS = 3


def phase_cli_design():
    """The eight design examples through their run(args) on the card:
    lm_design_fixedbb with an esm2_t6_8M-shaped checkpoint (seeded) in a
    temporary ESM_TPU_CACHE, 50 iterations at batch 4 (K1 6 a step); the
    ppl_* examples for 3 steps each, over ESMFold v1's
    cache name holding [cli-fold]'s checkpoint shape (an esm2_t6_8M LM, a
    2-block trunk at ESMFold's widths; seeded) at 60-87 residues: K1 6 and
    K6 8 a fold."""
    import importlib

    import torch
    from esm_tpu_torch import pretrained
    from esm_tpu_torch.examples import lm_design_fixedbb
    from esm_tpu_torch.io.export import save_esm2, save_esmfold
    from esm_tpu_torch.models import esm2
    from esm_tpu_torch.models import esmfold as ef
    from esm_tpu_torch.pretrained import _esm2_alphabet

    t_phase = time.perf_counter()
    lm, _ = pretrained.random_model_and_alphabet("esm2_t6_8M_UR50D", seed=41, device="cpu")
    cfg = ef.ESMFoldConfig(
        esm=esm2.ESM2Config.from_alphabet(_esm2_alphabet(), **esm2.ESM2_SIZES["esm2_t6_8M_UR50D"]),
        trunk=ef.FoldingTrunkConfig(num_blocks=2), esm_type="esm2_8M")
    fold_model = ef.init_esmfold(cfg, torch.Generator().manual_seed(42), device="cpu")
    redraw_zero_layers(fold_model, seed=43, device="cpu")
    prev_cache = os.environ.get("ESM_TPU_CACHE")
    with tempfile.TemporaryDirectory() as tmp:
        save_esm2(lm.model, os.path.join(tmp, "esm2_t6_8M_UR50D.pt"))
        save_esm2(fold_model.esm, os.path.join(tmp, "esm2_t6_8M_UR50D_500K.pt"))
        save_esmfold(fold_model, os.path.join(tmp, "esmfold_3B_v1.pt"))
        pdb = os.path.join(tmp, "template.pdb")
        write_backbone(pdb, {"A": (ideal_backbone(80, seed=44), random_protein(80, seed=45))},
                       "pdb")
        os.environ["ESM_TPU_CACHE"] = tmp
        try:
            argv = ["--model", "esm2_t6_8M_UR50D", "--num-iter", "50", "--batch", "4"]
            buf = io.StringIO()
            zero_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                seqs, energies, acc = lm_design_fixedbb.run(
                    lm_design_fixedbb.create_parser().parse_args(argv))
            counts = read_counts()
            log(f"[cli-design] lm_design_fixedbb {' '.join(argv)}: {time.perf_counter() - t0:.1f} "
                f"s, K1 {counts['flash_attention']} launches; "
                + "; ".join(buf.getvalue().strip().splitlines()[:2]))
            if (counts["flash_attention"] != 6 * 50 or sum(counts.values()) != 6 * 50
                    or not np.isfinite(energies).all()
                    or not all(set(s) <= set("ACDEFGHIKLMNPQRSTVWY") for s in seqs)):
                raise AssertionError(f"[cli-design] lm_design_fixedbb: launches {counts}, "
                                     f"designs {seqs}")
            for k, (name, flags) in enumerate(CLI_DESIGN_PPL.items()):
                example = importlib.import_module(f"esm_tpu_torch.examples.{name}")
                argv = [a.format(pdb=pdb) for a in flags] + ["--steps", str(CLI_DESIGN_STEPS)]
                buf = io.StringIO()
                np.random.seed(50 + k)
                zero_counts()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    state = example.run(example.create_parser().parse_args(argv))
                counts = read_counts()
                folds = CLI_DESIGN_STEPS
                log(f"[cli-design] {name} (length {len(state.best_sequence)}): "
                    f"{time.perf_counter() - t0:.1f} s, K1 {counts['flash_attention']} and K6 "
                    f"{counts['triangle_attention_fused']} launches ({folds} folds); "
                    + "; ".join(buf.getvalue().strip().splitlines()))
                if not (counts["flash_attention"] == 6 * folds
                        and counts["triangle_attention_fused"] == 8 * folds
                        and sum(counts.values()) == 14 * folds
                        and np.isfinite(state.energy_trace).all()
                        and set(state.best_sequence) <= set("ACDEFGHIKLMNPQRSTVWY")):
                    raise AssertionError(f"[cli-design] {name}: launches {counts}, energies "
                                         f"{state.energy_trace}, best {state.best_sequence}")
        finally:
            if prev_cache is None:
                os.environ.pop("ESM_TPU_CACHE", None)
            else:
                os.environ["ESM_TPU_CACHE"] = prev_cache
    torch.cuda.empty_cache()
    log(f"[cli-design] took {time.perf_counter() - t_phase:.1f} s")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import esm_tpu_torch  # noqa: F401  (fails when run without the repo)

    # --only ring,fold-shard,shard,pp-profile: those phases alone, in that
    # order (after device, build and fasta), e.g. on 4 cards; pp-profile
    # runs only so
    only = None
    if sys.argv[1:]:
        only = sys.argv[2].split(",") if len(sys.argv) == 3 and sys.argv[1] == "--only" else []
        if not only or not set(only) <= {"ring", "fold-shard", "shard", "pp-profile"}:
            print(f"chip_smoke: unknown arguments {sys.argv[1:]} (--only takes a comma-separated "
                  "list of ring, fold-shard, shard and pp-profile)", file=sys.stderr)
            return 2
    t_start = time.perf_counter()
    card, smi = phase_device()
    phase_build()
    phase_fasta()
    if only:
        kernels = []
        if "ring" in only:
            kernels += phase_ring(card)
        if "fold-shard" in only:
            kernels += phase_fold_shard(card)
        if "shard" in only:
            shard_counts(phase_shard(card))
        if "pp-profile" in only:
            phase_pp_profile(card)
        log(f"[summary] [build], [fasta] and [{'], ['.join(only)}] passed in "
            f"{time.perf_counter() - t_start:.1f} s")
        log(smi)
        log(json.dumps({"kernels": kernels}))
        log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                               "count": torch.cuda.device_count()}}))
        return 0
    phase_kernels()
    k1 = measure_k1(phase_main(card))
    counts = phase_train(card)
    backward = measure_backward(counts)
    ring = phase_ring(card)
    shard_res = phase_shard(card)
    shard = shard_entries(k1, backward, shard_counts(shard_res))
    phase_cli()
    phase_cli_pretrain()
    fold_counts, fold_handle, fold_ref = phase_fold(card)
    k6 = measure_k6(fold_counts)
    fold_shard = phase_fold_shard(card, fold_handle, fold_ref)
    del fold_ref
    trimul = phase_trimul()
    phase_cli_fold()
    t_serve = time.perf_counter()
    phase_serve(card, fold_handle)  # [fold]'s ESMFold v1, then freed
    del fold_handle
    torch.cuda.empty_cache()
    phase_cli_serve()
    log(f"[serve] [serve] and [cli-serve] took {time.perf_counter() - t_serve:.1f} s")
    k1_esm1 = measure_k1_esm1(phase_esm1(card))
    shard += shard_family_entries(k1_esm1, shard_res)
    del shard_res
    phase_msa(card)
    phase_cli_variants()
    t_if1 = time.perf_counter()
    phase_cli_if(phase_if1(card))
    log(f"[if1] [if1] and [cli-if] took {time.perf_counter() - t_if1:.1f} s")
    t_new = time.perf_counter()
    phase_lora(card)
    phase_int8(card)
    phase_train_msa(card)
    phase_train_if(card)
    phase_cli_pretrain_lora()
    log(f"[lora] [lora], [int8], [train-msa], [train-if] and [cli-pretrain-lora] took "
        f"{time.perf_counter() - t_new:.1f} s")
    t_fold = time.perf_counter()
    phase_train_fold(card)
    phase_cli_fold_finetune()
    phase_ss_finetune(card)
    phase_int8_15b(card)
    log(f"[train-fold] [train-fold], [cli-fold-finetune], [ss-finetune] and [int8-15b] took "
        f"{time.perf_counter() - t_fold:.1f} s")
    t_design = time.perf_counter()
    phase_design(card)
    phase_ppl(card)
    phase_cli_design()
    log(f"[design] [design], [ppl] and [cli-design] took {time.perf_counter() - t_design:.1f} s")
    log(f"[summary] all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(smi)
    kernels = [k1] + k1_esm1 + backward + ring + shard + [k6] + fold_shard + trimul
    for entry in kernels:
        lib = entry["library_ms"]
        entry["vs_library"] = entry["ms"] / lib if lib else None
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
