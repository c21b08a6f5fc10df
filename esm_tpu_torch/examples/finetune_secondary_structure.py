"""Supervised fine-tuning: per-residue secondary-structure prediction.

Port of examples/finetune_secondary_structure.py: a per-token classifier
over the LM's final hidden states, trained on the SCOPe structural split
dataset (esm_tpu_torch/data/structural.py, read from a local root) or on
synthetic (sequence, structure) pairs.

  python -m esm_tpu_torch.examples.finetune_secondary_structure --root-path DATA ...
  python -m esm_tpu_torch.examples.finetune_secondary_structure --synthetic 64 --cpu

By default only the head trains (the LM is frozen: one forward without
autograd); --train-lm fine-tunes end to end. On the card the LM runs in
bf16 through the flash-attention kernel (K1; with --train-lm its backward
is K2); on the CPU, in fp32 through the plain attention.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch
from torch import nn


def create_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--split-level", default="superfamily")
    p.add_argument("--cv-partition", default="4")
    p.add_argument("--root-path", default=None, help="the dataset's local root")
    p.add_argument("--download", action="store_true",
                   help="not ported: raises, saying where the files must be placed")
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="skip the dataset: N synthetic (seq, ssp) pairs whose structure "
                   "label is a function of local residue identity")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--num-layers", type=int, default=6)
    p.add_argument("--embed-dim", type=int, default=320)
    p.add_argument("--attention-heads", type=int, default=20)
    p.add_argument("--init-from", default=None,
                   help="warm-start the LM from a checkpoint (a .pt path or a name in the "
                   "local cache)")
    p.add_argument("--train-lm", action="store_true", help="fine-tune the LM too (default: frozen)")
    p.add_argument("--truncation-seq-length", type=int, default=1022)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    return p


def synthetic_items(n, seed=0, min_len=30, max_len=80):
    """Residue-driven labels: helix formers -> H, strand formers -> E, else C
    (a learnable stand-in for real DSSP strings)."""
    rng = np.random.default_rng(seed)
    aas = "LAGVSERTIDPKQNFYMHWC"
    to_ss = {c: ("H" if c in "AELM" else "E" if c in "VIYFW" else "C") for c in aas}
    items = []
    for _ in range(n):
        L = int(rng.integers(min_len, max_len))
        seq = "".join(aas[i] for i in rng.integers(0, 20, L))
        items.append({"seq": seq, "ssp": "".join(to_ss[c] for c in seq)})
    return items


class SSPModel(nn.Module):
    """The LM and a linear head over its final hidden states."""

    def __init__(self, lm: nn.Module, head: nn.Linear):
        super().__init__()
        self.lm = lm
        self.head = head


def run(args):
    from esm_tpu_torch import pretrained, training
    from esm_tpu_torch.data import Alphabet
    from esm_tpu_torch.models import esm2

    device = pretrained.resolve_device("cpu" if args.cpu else None)
    alphabet = Alphabet.from_architecture("ESM-1b")
    if args.init_from:
        handle, alphabet = pretrained.load_model_and_alphabet(args.init_from, device=device)
        cfg, lm = handle.cfg, handle.model
    else:
        cfg = esm2.ESM2Config.from_alphabet(alphabet, num_layers=args.num_layers,
                                            embed_dim=args.embed_dim,
                                            attention_heads=args.attention_heads)
        lm = esm2.init(cfg, torch.Generator(device=device).manual_seed(args.seed), device=device)
    if device.type == "cuda":
        cfg = dataclasses.replace(cfg, compute_dtype=torch.bfloat16, use_flash=True)

    if args.synthetic:
        items = synthetic_items(args.synthetic, args.seed)
    else:
        from esm_tpu_torch.data.structural import ESMStructuralSplitDataset

        kw = dict(root_path=args.root_path) if args.root_path else {}
        ds = ESMStructuralSplitDataset(split_level=args.split_level,
                                       cv_partition=args.cv_partition, split="train",
                                       download=args.download, **kw)
        items = [ds[i] for i in range(len(ds))]
    classes = sorted({c for it in items for c in it["ssp"]})
    cls_idx = {c: i for i, c in enumerate(classes)}
    print(f"{len(items)} chains, {len(classes)} SS classes: {''.join(classes)}")

    converter = alphabet.get_batch_converter(args.truncation_seq_length, pad_to_multiple=32)

    def make_batch(batch_items):
        _, _, toks = converter([("x", it["seq"]) for it in batch_items])
        labels = np.full(toks.shape, -1, np.int64)  # -1: ignored (pad, bos, eos)
        for i, it in enumerate(batch_items):
            ssp = it["ssp"][:args.truncation_seq_length]
            labels[i, 1:1 + len(ssp)] = [cls_idx[c] for c in ssp]
        return toks.to(device), torch.from_numpy(labels).to(device)

    d, n_cls = cfg.embed_dim, len(classes)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    head = nn.Linear(d, n_cls, device=device)
    with torch.no_grad():
        head.weight.copy_(torch.randn((n_cls, d), generator=gen, device=device) * d ** -0.5)
        head.bias.zero_()
    model = SSPModel(lm, head)
    lm.requires_grad_(args.train_lm)

    def loss_fn(tokens, labels):
        with torch.set_grad_enabled(args.train_lm):
            out = esm2.apply(lm, cfg, tokens, repr_layers=(cfg.num_layers,))
        reps = out["representations"][cfg.num_layers].float()
        logits = torch.nn.functional.linear(reps, head.weight, head.bias)
        w = (labels >= 0).float()
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, labels.clamp_min(0)[..., None])[..., 0]
        denom = w.sum().clamp_min(1.0)
        loss = (nll * w).sum() / denom
        acc = ((logits.argmax(-1) == labels) * w).sum() / denom
        return loss, {"loss": loss, "acc": acc}

    # optax.adamw(lr, weight_decay=0.01, mask=decay_mask): b2 0.999
    tx = training.AdamW(lambda count: args.lr, weight_decay=0.01, b2=0.999)
    state = training.init_state(model, tx)
    rng = np.random.default_rng(args.seed + 2)
    losses = []
    for i in range(args.steps):
        idx = rng.integers(0, len(items), args.batch_size)
        tokens, labels = make_batch([items[j] for j in idx])
        state, m = training._step(state, tx, lambda: loss_fn(tokens, labels))
        losses.append(m["loss"].item())
        if (i + 1) % args.log_every == 0 or i + 1 == args.steps:
            print(f"step {i + 1:5d}  loss {losses[-1]:.4f}  Q{n_cls}-acc {m['acc'].item():.3f}")
    return model, classes, losses


if __name__ == "__main__":
    run(create_parser().parse_args())
