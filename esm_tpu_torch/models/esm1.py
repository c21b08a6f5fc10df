"""ESM-1, ESM-1b and ESM-1v protein language models.

Port of esm_tpu/models/esm1.py (reference semantics: esm/model/esm1.py,
ProteinBertModel):
  * ESM-1b (arch "roberta_large"): learned positional embedding, optional
    pre-embedding LN, final LN, tied RobertaLMHead, LayerNorm eps 1e-5;
  * ESM-1 (arch "protein_bert_base"): sinusoidal positions, embed_scale
    sqrt(d), the bias_kv key/value row in every attention (stripped from
    the returned attention maps), an untied ``embed_out`` projection with
    its bias, LayerNorm eps 1e-12 inside the layers;
  * ESM-1v is the ESM-1b architecture with token dropout.
The forward contract is the reference's: ``{"logits", "representations",
"attentions", "contacts"}``. ``ESM1`` holds the parameters under the
reference's names, so a reference state dict loads with ``load_state_dict``.
On the flash path every layer runs kernel K1: ESM-1b/1v without rotary at
S = T, ESM-1 at S = T + 1 (the bias_kv row appended to the keys).

A model sharded by ``parallel.sharding.shard_params`` runs through
:func:`apply` as it is (tensor parallelism and ZeRO-3 over the (data, fsdp,
tp) mesh, each tp rank's heads, K1 on them; ``tokens`` are this rank's
rows). :func:`init_parts` draws :func:`init`'s weights one layer at a time,
so a released size is sharded without ever sitting whole on a rank.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..data.alphabet import Alphabet
from ..ops.common import (
    init_embedding,
    init_layer_norm,
    init_linear_torch_default,
    layer_norm,
    new_embedding,
    new_layer_norm,
)
from ..ops.heads import ContactPredictionHead, RobertaLMHead, contact_head, roberta_lm_head
from ..ops.positional import (
    SinusoidalPositionalEmbedding,
    learned_positional_embedding,
    sinusoidal_positional_embedding,
)
from ..parallel.sharding import sharding_of
from ..parallel.tensor_parallel import gather_from_tp
from .lm_common import (
    LayerStatic,
    TransformerLayer,
    embedding_lookup,
    normalize_repr_layers,
    transformer_stack_apply,
)


@dataclass(frozen=True)
class ESM1Config:
    model_version: str = "ESM-1b"   # "ESM-1b" (also ESM-1v) or "ESM-1"
    num_layers: int = 33
    embed_dim: int = 1280
    ffn_embed_dim: int = 5120
    attention_heads: int = 20
    max_positions: int = 1024
    emb_layer_norm_before: bool = True
    token_dropout: bool = False
    final_bias: bool = True          # ESM-1 only: the bias of embed_out
    # Alphabet-derived; None = filled from the architecture's alphabet
    # (ESM-1 and ESM-1b have different token layouts)
    alphabet_size: int = 33
    padding_idx: int = 1
    mask_idx: Optional[int] = None
    cls_idx: Optional[int] = None
    eos_idx: int = 2
    prepend_bos: bool = True
    append_eos: Optional[bool] = None
    # Execution options (not part of checkpoint identity)
    compute_dtype: torch.dtype = torch.float32
    use_flash: bool = False

    def __post_init__(self):
        if self.mask_idx is None or self.cls_idx is None or self.append_eos is None:
            a = Alphabet.from_architecture(self.model_version)
            for name in ("mask_idx", "cls_idx", "append_eos"):
                if getattr(self, name) is None:
                    object.__setattr__(self, name, getattr(a, name))

    @property
    def is_1b(self) -> bool:
        return self.model_version == "ESM-1b"

    @classmethod
    def from_alphabet(cls, alphabet: Alphabet, **kw) -> "ESM1Config":
        return cls(
            alphabet_size=len(alphabet),
            padding_idx=alphabet.padding_idx,
            mask_idx=alphabet.mask_idx,
            cls_idx=alphabet.cls_idx,
            eos_idx=alphabet.eos_idx,
            prepend_bos=alphabet.prepend_bos,
            append_eos=alphabet.append_eos,
            **kw,
        )

    def layer_static(self) -> LayerStatic:
        return LayerStatic(
            num_heads=self.attention_heads,
            use_rotary=False,
            use_bias_kv=not self.is_1b,
            ln_eps=1e-5 if self.is_1b else 1e-12,
            use_flash=self.use_flash,
        )


# Released sizes of the ESM-1 family, by registry name: depth, width and
# parameter count from the reference's model table (facebookresearch/esm
# README.md, "Available models": t34 670M at 1280 wide, t12 85M and t6 43M
# at 768 wide, ESM-1b and ESM-1v 650M at 1280 wide); 64-wide heads (20 at
# 1280, 12 at 768) and FFN 4 x width, as the released checkpoints' args set
# them. ESM-1v is ESM-1b's shape with token dropout (the reference's
# esm1v args). A loaded checkpoint's own args always win over this table.
_ESM1 = dict(model_version="ESM-1", attention_heads=20, embed_dim=1280, ffn_embed_dim=5120)
_ESM1_768 = dict(model_version="ESM-1", attention_heads=12, embed_dim=768, ffn_embed_dim=3072)
_ESM1B = dict(model_version="ESM-1b", num_layers=33, embed_dim=1280, ffn_embed_dim=5120,
              attention_heads=20)
ESM1_SIZES = {
    "esm1_t34_670M_UR50S": dict(_ESM1, num_layers=34),
    "esm1_t34_670M_UR50D": dict(_ESM1, num_layers=34),
    "esm1_t34_670M_UR100": dict(_ESM1, num_layers=34),
    "esm1_t12_85M_UR50S": dict(_ESM1_768, num_layers=12),
    "esm1_t6_43M_UR50S": dict(_ESM1_768, num_layers=6),
    "esm1b_t33_650M_UR50S": dict(_ESM1B),
    **{f"esm1v_t33_650M_UR90S_{i}": dict(_ESM1B, token_dropout=True) for i in range(1, 6)},
}


class ESM1(nn.Module):
    """ESM-1/1b/1v parameters, named as the reference's ProteinBertModel.
    Built without init: call :func:`init` for seeded random weights, or load
    a state dict."""

    def __init__(self, cfg: ESM1Config, device=None, *, with_layers: bool = True):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.embed_tokens = new_embedding(cfg.alphabet_size, d, padding_idx=cfg.padding_idx,
                                          device=device)
        self.layers = nn.ModuleList(
            new_layer(cfg, device) for _ in range(cfg.num_layers if with_layers else 0))
        self.contact_head = ContactPredictionHead(cfg.num_layers * cfg.attention_heads,
                                                  device=device)
        if cfg.is_1b:
            self.embed_positions = new_embedding(cfg.max_positions + cfg.padding_idx + 1, d,
                                                 padding_idx=cfg.padding_idx, device=device)
            if cfg.emb_layer_norm_before:
                self.emb_layer_norm_before = new_layer_norm(d, device=device)
            self.emb_layer_norm_after = new_layer_norm(d, device=device)
            self.lm_head = RobertaLMHead(d, cfg.alphabet_size, self.embed_tokens.weight,
                                         device=device)
        else:
            self.embed_positions = SinusoidalPositionalEmbedding(device=device)
            # stored (V, D), embedding-style (reference esm/model/esm1.py:92-97)
            self.embed_out = nn.Parameter(torch.empty(cfg.alphabet_size, d, device=device))
            if cfg.final_bias:
                self.embed_out_bias = nn.Parameter(torch.empty(cfg.alphabet_size,
                                                               device=device))

    def forward(self, tokens: torch.Tensor, **kw):
        return apply(self, self.cfg, tokens, **kw)


def new_layer(cfg: ESM1Config, device=None) -> TransformerLayer:
    """One uninitialised transformer layer of ``cfg``'s widths (ESM-1's with
    its bias_kv row)."""
    return TransformerLayer(cfg.embed_dim, cfg.ffn_embed_dim, cfg.attention_heads,
                            use_rotary=False, use_bias_kv=not cfg.is_1b, device=device)


def init(cfg: ESM1Config, generator: torch.Generator, device=None) -> ESM1:
    """ESM1 with seeded random weights (esm_tpu/models/esm1.py:85-127): N(0, 1)
    embeddings with zero padding rows, the reference's layer init, unit LNs,
    a torch-default LM-head dense layer, zero biases and zero contact
    regression. ESM-1's ``embed_out`` is drawn N(0, 1/D) (esm_tpu's init
    leaves it zero, which makes every logit of a random model zero; at this
    scale the logits of the un-normalized sqrt(D)-scaled features are about
    as large as ESM-1b's). ``generator`` must live on ``device``."""
    parts = init_parts(cfg, generator, device)
    _, model = next(parts)
    model.layers.extend(parts)
    return model


def init_parts(cfg: ESM1Config, generator: torch.Generator, device=None):
    """:func:`init`'s weights one layer at a time, drawn in its order, as
    ``parallel.sharding.shard_params`` takes a builder: yields (cfg, the
    shell: the model without layers), then each layer. The shell's heads
    and ESM-1b's positions and LNs are set once the last layer has been
    taken (they are drawn after the layers), so a consumer reads them only
    when the iteration has ended."""
    shell = ESM1(cfg, device=device, with_layers=False)
    with torch.no_grad():
        init_embedding(shell.embed_tokens, generator, padding_idx=cfg.padding_idx)
    yield cfg, shell
    for _ in range(cfg.num_layers):
        with torch.no_grad():
            layer = new_layer(cfg, device).init_(generator)
        yield layer
    with torch.no_grad():
        shell.contact_head.regression.weight.zero_()
        shell.contact_head.regression.bias.zero_()
        if cfg.is_1b:
            init_embedding(shell.embed_positions, generator, padding_idx=cfg.padding_idx)
            if cfg.emb_layer_norm_before:
                init_layer_norm(shell.emb_layer_norm_before)
            init_layer_norm(shell.emb_layer_norm_after)
            init_linear_torch_default(shell.lm_head.dense, generator)
            init_layer_norm(shell.lm_head.layer_norm)
            shell.lm_head.bias.zero_()
        else:
            shell.embed_out.normal_(generator=generator).mul_(cfg.embed_dim ** -0.5)
            if cfg.final_bias:
                shell.embed_out_bias.zero_()


def embed(model: ESM1, cfg: ESM1Config, tokens: torch.Tensor) -> torch.Tensor:
    """Token embedding (scaled by sqrt(d) for ESM-1), token dropout, and the
    positions (reference esm/model/esm1.py:116-140). Runs in fp32, returns
    the compute dtype. On a sharded model each tp rank looks up its columns
    of the features, which are then gathered."""
    padding_mask = tokens == cfg.padding_idx
    x = embedding_lookup(model.embed_tokens.weight, tokens)
    shard = sharding_of(model)
    if shard is not None:
        x = gather_from_tp(x, -1, shard.tp)
    if not cfg.is_1b:
        x = x * math.sqrt(cfg.embed_dim)
    if cfg.token_dropout:
        is_mask = (tokens == cfg.mask_idx)[..., None]
        x = x.masked_fill(is_mask, 0.0)
        mask_ratio_train = 0.15 * 0.8
        src_lengths = (~padding_mask).sum(-1)
        mask_ratio_observed = is_mask[..., 0].sum(-1).to(x.dtype) / src_lengths
        x = x * (1 - mask_ratio_train) / (1 - mask_ratio_observed)[:, None, None]
    if cfg.is_1b:
        x = x + learned_positional_embedding(model.embed_positions, tokens, cfg.padding_idx,
                                             cfg.max_positions)
        if cfg.emb_layer_norm_before:
            x = layer_norm(model.emb_layer_norm_before, x)
        x = x * (1 - padding_mask[..., None].to(x.dtype))
    else:
        x = x + sinusoidal_positional_embedding(tokens, cfg.embed_dim, cfg.padding_idx)
    return x.to(cfg.compute_dtype)


def apply(
    model: ESM1,
    cfg: ESM1Config,
    tokens: torch.Tensor,
    *,
    need_head_weights: bool = False,
    return_contacts: bool = False,
    return_representations: bool = False,
    repr_layers=None,
):
    """Forward pass (esm_tpu/models/esm1.py:137-261). tokens: (B, T) integer
    tensor on the model's device. Returns a dict:
      logits:          (B, T, V) fp32
      representations: (L+1, B, T, D) when ``return_representations`` (ESM-1b:
                       layer L after the final LN; ESM-1 has none), else with
                       ``repr_layers`` a dict of just those layers
      attentions:      (B, L, H, T, T) when need_head_weights (ESM-1's bias_kv
                       key column stripped)
      contacts:        (B, T', T') when return_contacts
    With ``return_contacts`` and no head weights the contact regression is
    accumulated inside the layer loop (one (B, H, T, S) map at a time).

    A sharded model (``parallel.sharding.shard_params``): ``tokens`` are this
    rank's rows (``parallel.sharding.batch_rows``; the tp ranks of a row
    group pass the same rows), and every output is those rows', whole in T
    and in the features; attention maps carry every head."""
    from .esm2 import _stack_with_streaming_contacts

    shard = sharding_of(model)
    static = dataclasses.replace(cfg.layer_static(), shard=shard)
    streaming_contacts = return_contacts and not need_head_weights
    padding_mask = tokens == cfg.padding_idx
    x = embed(model, cfg, tokens)
    h0 = x

    repr_layers = normalize_repr_layers(repr_layers, cfg.num_layers)
    # ESM-1b's last representation is post-final-LN, so it is not collected
    mid_cut = cfg.num_layers - 1 if cfg.is_1b else cfg.num_layers
    mid_layers = (
        tuple(i for i in repr_layers if 1 <= i <= mid_cut)
        if (repr_layers is not None and not return_representations)
        else None
    )

    contact_acc = attn = None
    if streaming_contacts:
        if mid_layers:
            raise NotImplementedError(
                "repr_layers selection with streaming contacts: pass "
                "need_head_weights=True or return_representations=True"
            )
        x, hiddens, contact_acc = _stack_with_streaming_contacts(
            model, cfg, x, tokens, padding_mask, return_representations,
            strip_last_key=not cfg.is_1b, static=static,
        )
    else:
        x, hiddens, attn = transformer_stack_apply(
            model.layers,
            x,
            static=static,
            key_padding_mask=padding_mask,
            collect_hiddens=return_representations,
            collect_layer_ids=mid_layers,
            need_head_weights=need_head_weights,
        )

    result = {}
    reps = None
    if repr_layers is not None and not return_representations:
        reps = {layer_id: hiddens[j] for j, layer_id in enumerate(mid_layers or ())}
        if 0 in repr_layers:
            reps[0] = h0
    if cfg.is_1b:
        x = layer_norm(model.emb_layer_norm_after, x)
        if return_representations:
            result["representations"] = torch.cat(
                [h0[None], hiddens[:-1], x[None].to(hiddens.dtype)], dim=0)
        elif reps is not None:
            if cfg.num_layers in repr_layers:
                reps[cfg.num_layers] = x  # post-final-LN
        logits = roberta_lm_head(model.lm_head, x.float(), model.embed_tokens.weight, shard)
    else:
        if return_representations:
            result["representations"] = torch.cat([h0[None], hiddens], dim=0)
        w = model.embed_out.float()  # replicated, as esm_tpu leaves it
        if model.embed_out.dtype == torch.int8:  # weight-only int8 (quantization.py)
            w = w * model.embed_out_scale[:, None]
        logits = torch.matmul(x.float(), w.t())
        if cfg.final_bias:
            logits = logits + model.embed_out_bias.float()
    if reps is not None:
        result["representations"] = reps
    result["logits"] = logits

    if need_head_weights:
        attentions = attn.permute(1, 0, 2, 3, 4).float()
        if not cfg.is_1b:
            attentions = attentions[..., :-1]  # the bias_kv key column
        keep = 1.0 - padding_mask.float()
        pair_mask = keep[:, None, :] * keep[:, :, None]
        attentions = attentions * pair_mask[:, None, None, :, :]
        result["attentions"] = attentions
        if return_contacts:
            result["contacts"] = contact_head(
                model.contact_head, tokens, attentions,
                prepend_bos=cfg.prepend_bos, append_eos=cfg.append_eos, eos_idx=cfg.eos_idx,
            )
    elif streaming_contacts:
        logits_c = contact_acc
        bias = model.contact_head.regression.bias
        if bias is not None:
            logits_c = logits_c + bias.float()[0]
        result["contacts"] = torch.sigmoid(logits_c)
    return result
