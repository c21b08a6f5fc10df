"""Plain ESM-2 in float32: the yardstick the benchmark holds the port to.

Written out from the published model (Lin et al., Science 2023;
facebookresearch/esm ``esm/model/esm2.py``, ``esm/modules.py``,
``esm/multihead_attention.py``, ``esm/rotary_embedding.py``): token
embedding with the mask-token rescale, pre-LN rotary self-attention and
GELU blocks, the final LayerNorm, the tied LM head. It runs on a flat
state dict in the reference checkpoint's layout (``embed_tokens.weight``,
``layers.{i}.self_attn.q_proj.weight``, ...), with exact attention, no
kernel and no batching trick. It imports nothing of the program.

``mm`` is every matrix product's function: plain ``torch.matmul`` for the
reference, :func:`fp8_matmul` for the lower-precision control. The caller
turns TF32 off (``float32_exact``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Sequence

import torch

# The ESM-1b alphabet that ESM-2 uses (esm/data.py, esm/constants.py): four
# prepended specials, the residue letters, one filler, then <mask>.
TOKENS = ("<cls>", "<pad>", "<eos>", "<unk>",
          "L", "A", "G", "V", "S", "E", "R", "T", "I", "D", "P", "K", "Q", "N", "F",
          "Y", "M", "H", "W", "C", "X", "B", "U", "Z", "O", ".", "-", "<null_1>", "<mask>")
IDX = {t: i for i, t in enumerate(TOKENS)}
CLS, PAD, EOS, MASK = IDX["<cls>"], IDX["<pad>"], IDX["<eos>"], IDX["<mask>"]
AMINO = "ACDEFGHIKLMNPQRSTVWY"


@contextlib.contextmanager
def float32_exact():
    """Float32 matrix products without TF32, for the span of the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def tokenize(seqs: Sequence[str], device=None) -> torch.Tensor:
    """<cls> residues <eos>, padded with <pad> to the longest: (B, T) int64."""
    t = max(len(s) for s in seqs) + 2
    out = torch.full((len(seqs), t), PAD, dtype=torch.int64)
    for i, s in enumerate(seqs):
        out[i, 0] = CLS
        out[i, 1:len(s) + 1] = torch.tensor([IDX[c] for c in s], dtype=torch.int64)
        out[i, len(s) + 1] = EOS
    return out.to(device)


class _RoundFP8(torch.autograd.Function):
    """x rounded through float8 (e4m3 forward, e5m2 for its gradient), each
    with a per-tensor scale that maps the largest magnitude to the format's
    largest finite value."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


def _round(x, dtype, top):
    scale = x.detach().abs().amax().float().clamp_min(1e-30) / top
    return ((x.float() / scale).to(dtype).float() * scale).to(x.dtype)


def fp8_matmul(a, b):
    """The control's matrix product: both operands rounded to fp8 first."""
    return torch.matmul(_RoundFP8.apply(a), _RoundFP8.apply(b))


def linear(w: Dict[str, torch.Tensor], name: str, x, mm: Callable = torch.matmul):
    return mm(x, w[f"{name}.weight"].t()) + w[f"{name}.bias"]


def layer_norm(w, name, x, eps=1e-5):
    return torch.nn.functional.layer_norm(x, x.shape[-1:], w[f"{name}.weight"],
                                          w[f"{name}.bias"], eps)


def gelu(x):
    return x * 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def rotary(x, t: int):
    """Rotary embedding over (B, H, T, d), positions 0..t-1."""
    d = x.shape[-1]
    inv = 1.0 / (10000.0 ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    f = torch.outer(torch.arange(t, dtype=torch.float32, device=x.device), inv)
    emb = torch.cat([f, f], dim=-1)
    x1, x2 = x.chunk(2, dim=-1)
    return x * emb.cos() + torch.cat([-x2, x1], dim=-1) * emb.sin()


def forward(w: Dict[str, torch.Tensor], cfg: dict, tokens: torch.Tensor,
            mm: Callable = torch.matmul, hiddens: bool = False) -> Dict[str, torch.Tensor]:
    """tokens (B, T) -> {"final": (B, T, D) after the final LN, "logits": (B, T, V)}.
    ``cfg``: num_layers, embed_dim, attention_heads. With ``hiddens`` also
    "hiddens": the embedding's output, each layer's, the last after the
    final LN ((L + 1) tensors of (B, T, D)); no logits then."""
    n_layers, d, heads = cfg["num_layers"], cfg["embed_dim"], cfg["attention_heads"]
    b, t = tokens.shape
    hd = d // heads
    pad = tokens == PAD
    x = w["embed_tokens.weight"][tokens]
    is_mask = tokens == MASK
    x = x.masked_fill(is_mask[..., None], 0.0)
    observed = is_mask.sum(-1).float() / (~pad).sum(-1).float()
    x = x * (1 - 0.15 * 0.8) / (1 - observed)[:, None, None]
    x = x * (~pad)[..., None].float()
    kept = [x]
    for i in range(n_layers):
        p = f"layers.{i}"
        h = layer_norm(w, f"{p}.self_attn_layer_norm", x)

        def heads_of(y):
            return y.view(b, t, heads, hd).transpose(1, 2)

        q = heads_of(linear(w, f"{p}.self_attn.q_proj", h, mm) * hd ** -0.5)
        k = heads_of(linear(w, f"{p}.self_attn.k_proj", h, mm))
        v = heads_of(linear(w, f"{p}.self_attn.v_proj", h, mm))
        q, k = rotary(q, t), rotary(k, t)
        logits = mm(q, k.transpose(-1, -2)).masked_fill(pad[:, None, None, :], float("-inf"))
        o = mm(torch.softmax(logits, dim=-1), v).transpose(1, 2).reshape(b, t, d)
        x = x + linear(w, f"{p}.self_attn.out_proj", o, mm)
        h = layer_norm(w, f"{p}.final_layer_norm", x)
        x = x + linear(w, f"{p}.fc2", gelu(linear(w, f"{p}.fc1", h, mm)), mm)
        kept.append(x)
    x = layer_norm(w, "emb_layer_norm_after", x)
    if hiddens:
        return {"final": x, "hiddens": kept[:-1] + [x]}
    h = layer_norm(w, "lm_head.layer_norm", gelu(linear(w, "lm_head.dense", x, mm)))
    logits = mm(h, w["embed_tokens.weight"].t()) + w["lm_head.bias"]
    return {"final": x, "logits": logits}


def masked_means(final: torch.Tensor, lengths: Sequence[int]) -> torch.Tensor:
    """The mean of each row's residue positions 1..n: (B, D)."""
    return torch.stack([final[i, 1:n + 1].mean(0) for i, n in enumerate(lengths)])


def mlm_sums(w, cfg, corrupted, targets, target_mask, mm=torch.matmul):
    """(sum of the masked positions' NLL, their count)."""
    logp = torch.log_softmax(forward(w, cfg, corrupted, mm)["logits"], dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    m = target_mask.float()
    return (nll * m).sum(), m.sum()


def learning_rate(cfg: dict, count: int) -> float:
    """Linear warm-up from 0 to ``lr`` over ``warmup_steps``, then cosine decay
    to 0 at ``total_steps`` (optax.warmup_cosine_decay_schedule)."""
    peak, warm, total = cfg["lr"], cfg["warmup_steps"], cfg["total_steps"]
    if count < warm:
        return peak * count / warm
    t = min(count - warm, total - warm)
    return peak * 0.5 * (1.0 + math.cos(math.pi * t / (total - warm)))


def decays(name: str, p: torch.Tensor) -> bool:
    """AdamW's weight decay covers the linear layers' 2-D weights, not the
    embedding (nor the tied output projection), norms or biases."""
    return name.endswith(".weight") and p.dim() == 2 and not name.startswith(
        ("embed_tokens", "lm_head.weight"))


@torch.no_grad()
def adamw_update(params: Dict[str, torch.Tensor], grads, state: dict, cfg: dict) -> None:
    """One AdamW step (b1, b2, eps, weight decay from ``cfg``), in place."""
    b1, b2, eps, wd = cfg["b1"], cfg["b2"], cfg["eps"], cfg["weight_decay"]
    count = state["count"] + 1
    lr = learning_rate(cfg, state["count"])
    for name, p in params.items():
        g = grads[name]
        m = state["mu"][name] = b1 * state["mu"][name] + (1 - b1) * g
        v = state["nu"][name] = b2 * state["nu"][name] + (1 - b2) * g * g
        u = (m / (1 - b1 ** count)) / (torch.sqrt(v / (1 - b2 ** count)) + eps)
        if decays(name, p):
            u = u + wd * p
        p.add_(-lr * u)
    state["count"] = count
