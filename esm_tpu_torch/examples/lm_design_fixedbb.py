"""Fixed-backbone LM design (the script form of the reference's
examples/lm-design): an MCMC chain over the masked-LM energy.

Port of examples/lm_design_fixedbb.py. The model comes from the local cache
(ESM_TPU_CACHE) or a .pt path; on the card the LM runs in bf16 with the
flash-attention kernel (K1), and the chain stays on the device until it
ends:

  python -m esm_tpu_torch.examples.lm_design_fixedbb --model esm2_t33_650M_UR50D \\
      --num-iter 5000 --batch 4
"""

from __future__ import annotations

import argparse

import torch


def create_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="esm2_t33_650M_UR50D")
    p.add_argument("--seed-seq",
                   default="MKTVRQERLKSIVRILERSKEPVSGAQLAEELSVSRQVIVQDIAYLRSLGYNIVATPRGYVLAGG")
    p.add_argument("--num-iter", type=int, default=5000)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--temperature", type=float, default=0.1)
    return p


def run(args, device=None):
    """Returns (designs, energy trace (num_iter, batch), acceptance rate).
    ``device``: the card unless "cpu" is asked for."""
    from esm_tpu_torch import pretrained
    from esm_tpu_torch.apps import lm_design

    device = pretrained.resolve_device(device)
    model, alphabet = pretrained.load_model_and_alphabet(args.model, device=device)
    if device.type == "cuda":
        model = model.with_options(compute_dtype=torch.bfloat16, use_flash=True)
    designer = lm_design.Designer(model)
    seqs, energies, acc = designer.design(
        args.seed_seq,
        lm_design.DesignConfig(num_iter=args.num_iter, temperature=args.temperature),
        batch=args.batch,
    )
    print(f"acceptance rate: {acc:.2%}")
    for i, s in enumerate(seqs):
        # energies[t] is the energy of the state ENTERING step t; the final
        # accepted design's energy is one step ahead of the trace
        print(f"design {i}: E_trace_end={float(energies[-1, i]):.4f}  {s}")
    return seqs, energies, acc


if __name__ == "__main__":
    run(create_parser().parse_args())
