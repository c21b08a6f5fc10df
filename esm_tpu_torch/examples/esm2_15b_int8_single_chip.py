"""ESM2-15B inference on one card through weight-only int8.

Port of examples/esm2_15b_int8_single_chip.py: every linear weight
symmetric per-output-channel int8, cast in the product and scaled after it
(esm_tpu_torch/quantization.py), bf16 compute, the flash-attention kernel
(K1) on the card. The weights take ~15 GB where bf16 takes ~30 GB.

  python -m esm_tpu_torch.examples.esm2_15b_int8_single_chip            # the local cache
  python -m esm_tpu_torch.examples.esm2_15b_int8_single_chip --random-seed 0

``--random-seed`` builds the model at its released widths with seeded random
weights, one layer at a time (each layer drawn in fp32 and quantized before
the next is drawn), so no fp32 copy of the whole model exists.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import warnings

import numpy as np
import torch


def seeded_parts(model_name: str, seed: int, device):
    """The seeded random weights of an ESM-2 at a released size
    (``esm2.ESM2_SIZES``), drawn in fp32 on ``device`` from one generator:
    yields (the config, the shell: embedding, final layer norm, LM head and
    zero contact regression, with no layers), then each layer in order
    (esm2.init's per-layer init). Drawn again from the same seed, the same
    weights come back, one layer at a time."""
    from esm_tpu_torch.models import esm2
    from esm_tpu_torch.models.lm_common import TransformerLayer
    from esm_tpu_torch.ops.heads import ContactPredictionHead
    from esm_tpu_torch.pretrained import _esm2_alphabet

    cfg = esm2.ESM2Config.from_alphabet(_esm2_alphabet(), **esm2.ESM2_SIZES[model_name],
                                        compute_dtype=torch.bfloat16, use_flash=True)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad(), warnings.catch_warnings():
        # the layerless shell's contact head has no inputs; it is replaced below
        warnings.filterwarnings("ignore", "Initializing zero-element tensors")
        shell = esm2.init(dataclasses.replace(cfg, num_layers=0), gen, device=device)
        shell.cfg = cfg
        shell.contact_head = ContactPredictionHead(cfg.num_layers * cfg.attention_heads,
                                                   device=device)
        shell.contact_head.regression.weight.zero_()
        shell.contact_head.regression.bias.zero_()
    yield cfg, shell
    for _ in range(cfg.num_layers):
        with torch.no_grad():
            yield TransformerLayer(cfg.embed_dim, cfg.ffn_embed_dim, cfg.attention_heads,
                                   device=device).init_(gen)


def seeded_esm2(model_name: str, seed: int, device, *, bf16_copy: bool = False):
    """An ESM-2 with :func:`seeded_parts`' weights, built one layer at a time
    on ``device``: each fp32 layer is optionally copied with its parameters
    in bf16 (``lora.store_base``; the rotary buffers stay fp32) and
    quantized to weight-only int8 before the next is drawn,
    so no fp32 copy of the whole model exists. Returns (an LMHandle with
    bf16 compute and flash attention, the bf16 copy's LMHandle or None, the
    alphabet). Each layer is quantized on its own: ``quantize_params``'
    65,536-element threshold selects what it selects over the whole model
    wherever one layer's linears reach it (every ESM-2 from 650M up)."""
    from esm_tpu_torch.lora import store_base
    from esm_tpu_torch.pretrained import LMHandle, _esm2_alphabet
    from esm_tpu_torch.quantization import quantize_params

    parts = seeded_parts(model_name, seed, device)
    cfg, model = next(parts)
    with torch.no_grad():
        twin = store_base(copy.deepcopy(model)) if bf16_copy else None
        quantize_params(model.lm_head)
        for layer in parts:
            if twin is not None:
                twin.layers.append(store_base(copy.deepcopy(layer)))
            model.layers.append(quantize_params(layer))
    model.requires_grad_(False)
    alphabet = _esm2_alphabet()
    handle = LMHandle("esm2", cfg, model, alphabet)
    return handle, (LMHandle("esm2", cfg, twin, alphabet) if twin is not None else None), alphabet


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--model", default="esm2_t48_15B_UR50D")
    parser.add_argument("--random-seed", type=int, default=None,
                        help="seeded random weights at the model's released widths "
                        "instead of the checkpoint in the local cache")
    parser.add_argument("--sequence",
                        default="MKTVRQERLKSIVRILERSKEPVSGAQLAEELSVSRQVIVQDIAYLRSLGYNIVATPRGYVLAGG")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    args = parser.parse_args(argv)

    from esm_tpu_torch import pretrained

    device = pretrained.resolve_device("cpu" if args.cpu else None)
    if args.random_seed is not None:
        model, _, alphabet = seeded_esm2(args.model, args.random_seed, device)
    else:
        model, alphabet = pretrained.load_model_and_alphabet(args.model, device=device)
        model = model.quantized().with_options(compute_dtype=torch.bfloat16, use_flash=True)

    _, _, tokens = alphabet.get_batch_converter()([("protein", args.sequence)])
    with torch.no_grad():
        out = model(tokens, repr_layers=[model.num_layers])
    emb = out["representations"][model.num_layers].float().cpu().numpy()
    print(f"logits {tuple(out['logits'].shape)}; mean embedding[:4] =",
          np.round(emb[0, 1:-1].mean(0)[:4], 5))
    return out


if __name__ == "__main__":
    main()
