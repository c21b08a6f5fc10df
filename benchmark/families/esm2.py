"""ESM-2: its weights in the reference layout, the program built from a
configuration file, and the plain reference beside it.

The weights follow the port's ``esm2.init`` scales (the published model's
init, esm/model/esm2.py and esm/multihead_attention.py): N(0, 1) token
embedding with a zero padding row; xavier-uniform q/k/v (gain 1/sqrt 2) and
out-projection with zero biases; torch's default U(±1/sqrt(fan_in)) FFN and
LM-head dense layer, weights and biases; unit LayerNorms; zero LM-head bias
and contact regression.
"""

from __future__ import annotations

import math

import torch

from .. import weights as W
from ..reference import esm2 as reference  # noqa: F401  (the configuration's reference)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def layout(cfg: dict, prefix: str = "") -> list:
    d, n, heads = cfg["embed_dim"], cfg["num_layers"], cfg["attention_heads"]
    v, f = cfg["alphabet_size"], 4 * cfg["embed_dim"]
    p = prefix
    qkv = math.sqrt(6.0 / (2 * d)) / math.sqrt(2.0)
    out = [(f"{p}embed_tokens.weight", (v, d), "normal", 1.0)]
    for i in range(n):
        li = f"{p}layers.{i}"
        for proj in ("k_proj", "v_proj", "q_proj"):
            out += W.linear(f"{li}.self_attn.{proj}", d, d, ("uniform", qkv), ("const", 0.0))
        out += W.linear(f"{li}.self_attn.out_proj", d, d, ("uniform", math.sqrt(6.0 / (2 * d))),
                        ("const", 0.0))
        out.append((f"{li}.self_attn.rot_emb.inv_freq", (d // heads // 2,), "inv_freq", None))
        out += W.layer_norm(f"{li}.self_attn_layer_norm", d)
        out += W.linear(f"{li}.fc1", d, f, ("uniform", d ** -0.5), ("uniform", d ** -0.5))
        out += W.linear(f"{li}.fc2", f, d, ("uniform", f ** -0.5), ("uniform", f ** -0.5))
        out += W.layer_norm(f"{li}.final_layer_norm", d)
    out += W.linear(f"{p}contact_head.regression", n * heads, 1, ("const", 0.0), ("const", 0.0))
    out += W.layer_norm(f"{p}emb_layer_norm_after", d)
    out += [(f"{p}lm_head.weight", (v, d), "tie", f"{p}embed_tokens.weight"),
            (f"{p}lm_head.bias", (v,), "const", 0.0)]
    out += W.linear(f"{p}lm_head.dense", d, d, ("uniform", d ** -0.5), ("uniform", d ** -0.5))
    out += W.layer_norm(f"{p}lm_head.layer_norm", d)
    return out


def zero_padding_row(state: dict, cfg: dict, prefix: str = "") -> dict:
    state[f"{prefix}embed_tokens.weight"][cfg["padding_idx"]] = 0.0
    return state


def weights(cfg: dict, seed: int, device) -> dict:
    """The configuration's weights from ``seed``, in the reference layout."""
    with torch.no_grad():
        return zero_padding_row(W.draw(layout(cfg), seed, device), cfg)


def program_config(cfg: dict):
    """The port's ``ESM2Config`` for a configuration file's dict."""
    from esm_tpu_torch.data.alphabet import Alphabet
    from esm_tpu_torch.models import esm2

    return esm2.ESM2Config.from_alphabet(
        Alphabet.from_architecture("ESM-1b"), num_layers=cfg["num_layers"],
        embed_dim=cfg["embed_dim"], attention_heads=cfg["attention_heads"],
        compute_dtype=DTYPES[cfg["compute_dtype"]], use_flash=cfg["use_flash"],
        remat=cfg.get("remat", False), remat_policy=cfg.get("remat_policy", "dots"))


def program(cfg: dict, state: dict, device):
    """The port's ``LMHandle`` on ``state``, loaded through its checkpoint
    loader (``io.convert.load_lm_state``, the reference layout)."""
    from esm_tpu_torch.data.alphabet import Alphabet
    from esm_tpu_torch.io.convert import load_lm_state
    from esm_tpu_torch.models import esm2
    from esm_tpu_torch.pretrained import LMHandle

    pcfg = program_config(cfg)
    model = esm2.ESM2(pcfg, device=device)
    load_lm_state(model, state)
    return LMHandle("esm2", pcfg, model, Alphabet.from_architecture("ESM-1b"))
