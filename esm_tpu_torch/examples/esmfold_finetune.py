"""ESMFold structure fine-tuning on custom backbones.

Port of examples/esmfold_finetune.py: the AF2-style losses (backbone FAPE,
distogram and pLDDT supervision, esm_tpu_torch/models/esmfold/losses.py) on
(sequence, backbone) pairs read from PDB/mmCIF files, against the frozen
ESM-2 LM, with optional LoRA adapters over the trunk and heads.

A random-init tiny model (the default), on the CPU:
  python -m esm_tpu_torch.examples.esmfold_finetune --pdbs my_structures/ --steps 10 --cpu

From a checkpoint in the local cache (ESM_TPU_CACHE), on the card:
  python -m esm_tpu_torch.examples.esmfold_finetune --pdbs my_structures/ \\
      --init-from esmfold_3B_v1 --lora --steps 500

Two faults of the JAX example are avoided here: its LM-auxiliary masking
pattern also marks padded columns, which the LM's input then counts as
residues, so a shorter sequence's eos lands past its end; and its batches
take slices of one shuffled order at offsets that drift off the epoch's
reshuffle when B does not divide the set. Here the pattern is zero on
padded columns, and each epoch reshuffles once and takes contiguous B-sized
slices of that order.
"""

from __future__ import annotations

import argparse
import glob
import os
import time
from typing import Iterator, List, Tuple

import numpy as np
import torch


def create_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--pdbs", required=True,
                   help="directory of (or glob over) .pdb/.cif backbone files")
    p.add_argument("--chain", default=None, help="chain id (default: all atoms)")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--num-recycles", type=int, default=0)
    p.add_argument("--init-from", default=None,
                   help="warm-start from an ESMFold checkpoint (a .pt path, or a name in the "
                   "local cache: pretrained.load_esmfold) instead of a random-init tiny model")
    p.add_argument("--lora", action="store_true", help="train LoRA adapters only")
    p.add_argument("--lora-rank", type=int, default=8)
    p.add_argument("--lm-aux-weight", type=float, default=0.0,
                   help=">0 adds the masked-LM auxiliary (15%% masking)")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    return p


def load_backbones(pattern: str, chain) -> Tuple[List[str], List[np.ndarray]]:
    """(sequences, (L, 3, 3) N/CA/C coordinates) from PDB/mmCIF files; NaN
    (missing) atoms become coord_mask zeros."""
    from esm_tpu_torch.models.inverse_folding.util import load_coords

    paths = (sorted(glob.glob(os.path.join(pattern, "*"))) if os.path.isdir(pattern)
             else sorted(glob.glob(pattern)))
    seqs, coords = [], []
    for path in paths:
        if not path.endswith((".pdb", ".cif", ".mmcif")):
            continue
        xyz, seq = load_coords(path, chain)
        seqs.append(seq)
        coords.append(xyz)
    if not seqs:
        raise SystemExit(f"no .pdb/.cif files under {pattern}")
    return seqs, coords


def tiny_config(num_recycles: int):
    """The random-init model of esm_tpu's example: LM 3 x 64, 2 trunk blocks."""
    from esm_tpu_torch.data import Alphabet
    from esm_tpu_torch.models import esm2
    from esm_tpu_torch.models import esmfold as ef

    return ef.ESMFoldConfig(
        esm=esm2.ESM2Config.from_alphabet(Alphabet.from_architecture("ESM-1b"), num_layers=3,
                                          embed_dim=64, attention_heads=4),
        trunk=ef.FoldingTrunkConfig(
            num_blocks=2, sequence_state_dim=64, pairwise_state_dim=32, sequence_head_width=16,
            pairwise_head_width=16, max_recycles=max(1, num_recycles + 1),
            structure_module=ef.StructureModuleConfig(c_s=64, c_z=32, c_ipa=8, c_resnet=16,
                                                      no_heads_ipa=4, no_blocks=2)),
    )


def encode(seqs: List[str], raw_coords: List[np.ndarray]):
    """Single-chain encodings aligned with the coordinates (no linker or
    offset): aa, mask (B, L); coords (B, L, 3, 3); coord_mask (B, L)."""
    from esm_tpu_torch.models import esmfold as ef

    aa, mask, _, _, _ = ef.batch_encode_sequences(seqs, residue_index_offset=None,
                                                  chain_linker=None)
    L = aa.shape[1]
    coords = np.zeros((len(seqs), L, 3, 3), np.float32)
    coord_mask = np.zeros((len(seqs), L), np.float32)
    for i, xyz in enumerate(raw_coords):
        n = xyz.shape[0]
        coords[i, :n] = np.nan_to_num(xyz)
        coord_mask[i, :n] = np.isfinite(xyz).all((-2, -1))
    return aa, mask.astype(np.float32), coords, coord_mask


def batch_indices(rng: np.random.RandomState, n: int, batch_size: int) -> Iterator[np.ndarray]:
    """Batches of ``batch_size`` indices into ``n`` items: each epoch
    reshuffles once and yields contiguous slices of that order (a set
    smaller than the batch is repeated to fill it)."""
    order = np.arange(n)
    while True:
        rng.shuffle(order)
        if n < batch_size:
            yield np.resize(order, batch_size)
            continue
        for start in range(0, n - batch_size + 1, batch_size):
            yield order[start:start + batch_size]


def lm_aux_pattern(rng: np.random.RandomState, mask: np.ndarray) -> np.ndarray:
    """The masked-LM auxiliary's 15% pattern, zero on padded columns (a
    masked pad column would count as a residue in the LM's input and move
    eos past a shorter sequence's end)."""
    return ((rng.rand(*mask.shape) < 0.15) & (mask > 0)).astype(np.int64)


def main(args):
    from esm_tpu_torch import lora, pretrained, training
    from esm_tpu_torch.models import esmfold as ef
    from esm_tpu_torch.models.esmfold import losses as fl

    device = pretrained.resolve_device("cpu" if args.cpu else None)
    seqs, raw_coords = load_backbones(args.pdbs, args.chain)
    print(f"loaded {len(seqs)} backbones, lengths {[len(s) for s in seqs]}")

    # weights (and adapters) are drawn or loaded on the CPU, then moved: the
    # same run on the card and on the CPU starts from the same numbers
    if args.init_from:
        cfg, model, _ = pretrained.load_esmfold(args.init_from, device="cpu")
    else:
        cfg = tiny_config(args.num_recycles)
        model = ef.init_esmfold(cfg, torch.Generator().manual_seed(0), device="cpu")
    trainable = training.split_fold_params(model)
    adapters = None
    if args.lora:
        adapters = lora.init_lora(torch.Generator().manual_seed(1), model, rank=args.lora_rank,
                                  targets=lora.fold_targets).to(device)
        n_full = sum(p.numel() for p in trainable.values())
        print(f"LoRA: {lora.num_params(adapters):,} adapter params over {n_full:,} frozen")
    model.to(device)

    aa, mask, coords, coord_mask = encode(seqs, raw_coords)
    tx = training.fold_optimizer(args.lr)
    weights = fl.FoldLossWeights(lm=args.lm_aux_weight)
    state = training.init_state(adapters if args.lora else model, tx)

    rng = np.random.RandomState(0)
    batches = batch_indices(rng, len(seqs), args.batch_size)
    losses = []
    t0 = time.time()
    for step in range(args.steps):
        idx = next(batches)
        batch = [torch.from_numpy(x[idx]).to(device) for x in (aa, mask, coords, coord_mask)]
        pattern = None
        if args.lm_aux_weight > 0:
            pattern = torch.from_numpy(lm_aux_pattern(rng, mask[idx])).to(device)
        kw = dict(masking_pattern=pattern, weights=weights, num_recycles=args.num_recycles)
        if args.lora:
            state, m = training.train_step_fold_lora(state, model, cfg, tx, *batch, **kw)
        else:
            state, m = training.train_step_fold(state, cfg, tx, *batch, **kw)
        losses.append(m["loss"].item())
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss {losses[-1]:.6f} fape {m['fape'].item():.4f} "
                  f"disto {m['distogram_ce'].item():.4f} lddt_ca {m['lddt_ca'].item():.3f} "
                  f"({time.time() - t0:.1f}s)")

    if args.lora:
        merged = lora.merge(model, state.model)
        print("merged LoRA adapters into the trunk for deployment "
              f"({sum(p.numel() for p in merged.parameters()):,} params)")
    return state, losses


if __name__ == "__main__":
    main(create_parser().parse_args())
