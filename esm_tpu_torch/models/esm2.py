"""ESM-2 protein language model.

Port of esm_tpu/models/esm2.py (reference semantics: esm/model/esm2.py):
token embedding with mask-token dropout rescale, N pre-LN rotary transformer
layers, final LN, tied-weight LM head, contact head over the attention maps.
The forward contract is the reference's:
``{"logits", "representations", "attentions", "contacts"}``.

``ESM2`` holds the parameters under the reference's names, so a reference
state dict loads with ``load_state_dict``. :func:`apply` takes the options
(compute dtype, flash path) from an explicit ``ESM2Config``, so one set of
weights serves several configurations (``LMHandle.with_options``).
:func:`apply_seq_sharded` is the sequence-parallel forward (the T axis split
over a mesh dimension, ring attention in every layer). A model sharded by
``parallel.sharding.shard_params`` runs through :func:`apply` as it is
(tensor parallelism and ZeRO-3 over the mesh; ``tokens`` are this rank's
rows), and through :func:`apply_pipelined` when its layers are split into
pipeline stages (GPipe, ``parallel/pipeline.py``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch import nn

from ..data.alphabet import Alphabet
from ..ops.common import (
    init_embedding,
    init_layer_norm,
    init_linear_torch_default,
    layer_norm,
    materialize_weight,
    new_embedding,
    new_layer_norm,
)
from ..ops.heads import (
    ContactPredictionHead,
    RobertaLMHead,
    contact_head,
    roberta_lm_head,
    weighted_apc_symmetrize,
)
from ..parallel.mesh import local_shard
from ..parallel.sharding import sharding_of
from ..parallel.tensor_parallel import gather_from_tp
from .lm_common import (
    LayerStatic,
    embedding_lookup,
    TransformerLayer,
    normalize_repr_layers,
    transformer_layer_apply,
    transformer_stack_apply,
)


@dataclass(frozen=True)
class ESM2Config:
    num_layers: int = 33
    embed_dim: int = 1280
    attention_heads: int = 20
    token_dropout: bool = True
    # Alphabet-derived (ESM-1b alphabet; reference esm/model/esm2.py:27-36)
    alphabet_size: int = 33
    padding_idx: int = 1
    mask_idx: int = 32
    cls_idx: int = 0
    eos_idx: int = 2
    prepend_bos: bool = True
    append_eos: bool = True
    # Execution options (not part of checkpoint identity)
    compute_dtype: torch.dtype = torch.float32
    use_flash: bool = False
    remat: bool = False  # recompute layer bodies on the backward (training)
    # "dots" (keep matrix-product outputs) or "full" (save only layer inputs)
    remat_policy: str = "dots"

    @property
    def ffn_embed_dim(self) -> int:
        return 4 * self.embed_dim

    @classmethod
    def from_alphabet(cls, alphabet: Alphabet, **kw) -> "ESM2Config":
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
            use_rotary=True,
            use_bias_kv=False,
            ln_eps=1e-5,
            use_flash=self.use_flash,
            remat=self.remat,
            remat_policy=self.remat_policy,
        )


# ESM-2 released sizes (reference README.md:475-496).
ESM2_SIZES = {
    "esm2_t6_8M_UR50D": dict(num_layers=6, embed_dim=320, attention_heads=20),
    "esm2_t12_35M_UR50D": dict(num_layers=12, embed_dim=480, attention_heads=20),
    "esm2_t30_150M_UR50D": dict(num_layers=30, embed_dim=640, attention_heads=20),
    "esm2_t33_650M_UR50D": dict(num_layers=33, embed_dim=1280, attention_heads=20),
    "esm2_t36_3B_UR50D": dict(num_layers=36, embed_dim=2560, attention_heads=40),
    "esm2_t48_15B_UR50D": dict(num_layers=48, embed_dim=5120, attention_heads=40),
}


class ESM2(nn.Module):
    """ESM-2 parameters, named as the reference's ESM2 module. Built without
    init: call :func:`init` for seeded random weights, or load a state dict."""

    def __init__(self, cfg: ESM2Config, device=None, *, with_layers: bool = True):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.embed_tokens = new_embedding(
            cfg.alphabet_size, d, padding_idx=cfg.padding_idx, device=device
        )
        self.layers = nn.ModuleList(
            new_layer(cfg, device) for _ in range(cfg.num_layers if with_layers else 0)
        )
        self.contact_head = ContactPredictionHead(
            cfg.num_layers * cfg.attention_heads, device=device
        )
        self.emb_layer_norm_after = new_layer_norm(d, device=device)
        self.lm_head = RobertaLMHead(d, cfg.alphabet_size, self.embed_tokens.weight,
                                     device=device)

    def forward(self, tokens: torch.Tensor, **kw):
        return apply(self, self.cfg, tokens, **kw)


def new_layer(cfg: ESM2Config, device=None) -> TransformerLayer:
    """One uninitialised transformer layer of ``cfg``'s widths."""
    return TransformerLayer(cfg.embed_dim, cfg.ffn_embed_dim, cfg.attention_heads, device=device)


def init(cfg: ESM2Config, generator: torch.Generator, device=None) -> ESM2:
    """ESM2 with seeded random weights (esm_tpu/models/esm2.py:93-115): N(0, 1)
    embedding with a zero padding row, the reference's layer init, torch
    default LM-head dense layer, unit LNs, zero LM-head bias and zero
    contact regression. ``generator`` must live on ``device``."""
    parts = init_parts(cfg, generator, device)
    _, model = next(parts)
    model.layers.extend(parts)
    return model


def init_parts(cfg: ESM2Config, generator: torch.Generator, device=None):
    """:func:`init`'s weights one layer at a time, drawn in its order, as
    ``parallel.sharding.shard_params`` takes a builder: yields (cfg, the
    shell: the model without layers), then each layer. The shell's final
    LN, LM head and contact regression are set once the last layer has been
    taken (the dense layer is drawn after the layers), so a consumer reads
    them only when the iteration has ended."""
    shell = ESM2(cfg, device=device, with_layers=False)
    with torch.no_grad():
        init_embedding(shell.embed_tokens, generator, padding_idx=cfg.padding_idx)
    yield cfg, shell
    for _ in range(cfg.num_layers):
        with torch.no_grad():
            layer = new_layer(cfg, device).init_(generator)
        yield layer
    with torch.no_grad():
        init_layer_norm(shell.emb_layer_norm_after)
        init_linear_torch_default(shell.lm_head.dense, generator)
        init_layer_norm(shell.lm_head.layer_norm)
        shell.lm_head.bias.zero_()
        shell.contact_head.regression.weight.zero_()
        shell.contact_head.regression.bias.zero_()


def _sequence_counts(is_mask, padding_mask, ring):
    """Per-sequence (<mask> count, length), summed over the ring when the
    sequence is split over it."""
    counts = torch.stack([is_mask.sum(-1), (~padding_mask).sum(-1)])
    if ring is not None:
        mesh, axis_name = ring
        dist.all_reduce(counts, group=mesh.get_group(axis_name))
    return counts[0], counts[1]


def embed_tokens(model: ESM2, cfg: ESM2Config, tokens: torch.Tensor, ring=None) -> torch.Tensor:
    """Token embedding with mask-token dropout rescale (reference
    esm/model/esm2.py:84-95). Runs in fp32, returns the compute dtype. With
    ``ring`` = (mesh, axis_name) ``tokens`` is this rank's block of columns:
    the rescale's counts are the whole sequence's. On a sharded model each
    tp rank looks up its columns of the features, which are then gathered."""
    padding_mask = tokens == cfg.padding_idx
    x = embedding_lookup(model.embed_tokens.weight, tokens)
    shard = sharding_of(model)
    if shard is not None:
        x = gather_from_tp(x, -1, shard.tp)

    if cfg.token_dropout:
        is_mask = (tokens == cfg.mask_idx)[..., None]
        x = x.masked_fill(is_mask, 0.0)
        mask_ratio_train = 0.15 * 0.8
        n_mask, src_lengths = _sequence_counts(is_mask[..., 0], padding_mask, ring)
        mask_ratio_observed = n_mask.to(x.dtype) / src_lengths
        x = x * (1 - mask_ratio_train) / (1 - mask_ratio_observed)[:, None, None]

    x = x * (1 - padding_mask[..., None].to(x.dtype))
    return x.to(cfg.compute_dtype)


def apply(
    model: ESM2,
    cfg: ESM2Config,
    tokens: torch.Tensor,
    *,
    need_head_weights: bool = False,
    return_contacts: bool = False,
    return_representations: bool = False,
    repr_layers=None,
    ring=None,
):
    """Forward pass. tokens: (B, T) integer tensor on the model's device.

    Returns a dict:
      logits:          (B, T, V) fp32
      representations: (L+1, B, T, D) stacked hidden states (layer 0 = embedding
                       output, layer L = final-LN output) when
                       ``return_representations``; else, with ``repr_layers``,
                       a dict of just those layers
      attentions:      (B, L, H, T, T) when need_head_weights
      contacts:        (B, T', T') when return_contacts

    With ``return_contacts=True, need_head_weights=False`` the contact
    regression is accumulated inside the layer loop: the peak is one
    (B, H, T, T) map instead of the reference's (B, L, H, T, T) stack
    (esm/model/esm2.py:133-141).

    ``ring`` = (mesh, axis_name): ``tokens`` is this rank's block of columns
    of a sequence split over that mesh dimension (see
    :func:`apply_seq_sharded`); no attention maps or contacts then.

    A sharded model (``parallel.sharding.shard_params``): ``tokens`` are this
    rank's rows (``parallel.sharding.batch_rows``; the tp ranks of a row
    group pass the same rows), and every output is those rows', whole in T
    and in the features; attention maps carry every head.
    """
    if ring is not None:
        _ring_takes(model)
    shard = sharding_of(model)
    if shard is not None and ring is not None:
        raise ValueError("a sharded model runs without ring attention (sequence parallelism "
                         "keeps its parameters replicated)")
    if shard is not None and shard.stages > 1:
        raise ValueError("this model's layers are split into pipeline stages: run "
                         "apply_pipelined")
    if ring is not None and (need_head_weights or return_contacts):
        raise ValueError(
            "sequence-parallel (ring) forward cannot materialize T x T attention maps; "
            "request representations/logits only")
    streaming_contacts = return_contacts and not need_head_weights
    repr_layers = normalize_repr_layers(repr_layers, cfg.num_layers)
    # 1-based mid-stack layer ids collected inside the loop
    mid_layers = (
        tuple(i for i in repr_layers if 1 <= i <= cfg.num_layers - 1)
        if (repr_layers is not None and not return_representations)
        else None
    )

    padding_mask = tokens == cfg.padding_idx
    x = embed_tokens(model, cfg, tokens, ring=ring)
    h0 = x

    contact_acc = None
    attn = None
    if streaming_contacts:
        if mid_layers:
            raise NotImplementedError(
                "repr_layers selection with streaming contacts: pass "
                "need_head_weights=True or return_representations=True"
            )
        x, hiddens, contact_acc = _stack_with_streaming_contacts(
            model, cfg, x, tokens, padding_mask, return_representations,
            static=dataclasses.replace(cfg.layer_static(), shard=shard),
        )
    else:
        x, hiddens, attn = transformer_stack_apply(
            model.layers,
            x,
            static=dataclasses.replace(cfg.layer_static(), ring=ring, shard=shard),
            key_padding_mask=padding_mask,
            collect_hiddens=return_representations,
            collect_layer_ids=mid_layers,
            need_head_weights=need_head_weights,
        )

    x = layer_norm(model.emb_layer_norm_after, x)

    result = {}
    if return_representations:
        # (L+1, B, T, D): embedding output, then per-layer outputs; the final
        # layer's entry is the post-LN value (reference esm/model/esm2.py:123-128)
        result["representations"] = torch.cat(
            [h0[None], hiddens[:-1], x[None].to(hiddens.dtype)], dim=0
        )
    elif repr_layers is not None:
        reps = {layer_id: hiddens[j] for j, layer_id in enumerate(mid_layers or ())}
        if 0 in repr_layers:
            reps[0] = h0
        if cfg.num_layers in repr_layers:
            reps[cfg.num_layers] = x  # already post-final-LN
        result["representations"] = reps

    result["logits"] = roberta_lm_head(
        model.lm_head, x.float(), model.embed_tokens.weight, shard
    )

    if need_head_weights:
        # (L, B, H, T, T) -> (B, L, H, T, T); zero maps at padded query/key
        # positions (reference esm/model/esm2.py:133-138)
        attentions = attn.permute(1, 0, 2, 3, 4).float()
        keep = 1.0 - padding_mask.float()
        pair_mask = keep[:, None, :] * keep[:, :, None]
        attentions = attentions * pair_mask[:, None, None, :, :]
        result["attentions"] = attentions
        if return_contacts:
            result["contacts"] = contact_head(
                model.contact_head,
                tokens,
                attentions,
                prepend_bos=cfg.prepend_bos,
                append_eos=cfg.append_eos,
                eos_idx=cfg.eos_idx,
            )
    elif streaming_contacts:
        logits_c = contact_acc
        bias = model.contact_head.regression.bias
        if bias is not None:
            logits_c = logits_c + bias.float()[0]
        result["contacts"] = torch.sigmoid(logits_c)
    return result


def apply_seq_sharded(model: ESM2, cfg: ESM2Config, tokens: torch.Tensor, *, mesh,
                      seq_axis: str = "tp", **kw):
    """Sequence-parallel forward (esm_tpu/models/esm2.py:265): every rank of
    ``mesh`` passes the same full (B, T) tokens and gets its own shard of each
    output: its rows of B over the mesh's other dimensions and its T/N
    columns over ``seq_axis``, as :func:`parallel.mesh.local_shard` cuts them
    (logits (B', T/N, V); representations (L+1, B', T/N, D), or a dict of
    (B', T/N, D)). Every attention runs as a ring with key/value blocks
    rotating between the ranks (parallel/ring_attention.py), so activations
    and attention state are O(T/N) per rank. T must divide by the
    ``seq_axis`` size. Attention maps and contacts raise (they are T x T)."""
    _ring_takes(model)
    local = local_shard(tokens, mesh, seq_axis=seq_axis)
    return apply(model, cfg, local, ring=(mesh, seq_axis), **kw)


def _ring_takes(model) -> None:
    if not isinstance(model, ESM2):
        raise ValueError(f"sequence parallelism (ring attention) runs ESM-2 only, as in "
                         f"esm_tpu, not {type(model).__name__}: shard its parameters instead "
                         "(parallel.sharding.shard_params)")


def apply_pipelined(model: ESM2, cfg: ESM2Config, tokens: torch.Tensor, *,
                    num_microbatches: int):
    """Logits-only forward with the layer stack pipelined over the mesh's
    ``pp`` axis (esm_tpu/models/esm2.py:279; GPipe microbatching,
    parallel/pipeline.py). ``model`` is sharded over a
    ``pipeline.make_pp_mesh`` mesh: each rank holds its stage's layers, with
    tp and fsdp inside the stage. The embedding, final LN and LM head run on
    every stage; the last stage's output is sent to all of them, so every
    rank returns the logits of ``tokens``, this rank's rows (over data and
    fsdp; every stage passes the same). A forward only: training runs
    through ``training.train_step_pp``."""
    from ..parallel.pipeline import pipeline_transformer_stack

    shard = sharding_of(model)
    if shard is None:
        raise ValueError("apply_pipelined runs a model sharded over a pp mesh "
                         "(parallel.sharding.shard_params with pipeline.make_pp_mesh)")
    with torch.no_grad():
        padding_mask = tokens == cfg.padding_idx
        x = embed_tokens(model, cfg, tokens)
        x = pipeline_transformer_stack(
            [model.layers[i] for i in shard.layer_ids], x,
            static=dataclasses.replace(cfg.layer_static(), shard=shard), shard=shard,
            num_microbatches=num_microbatches, key_padding_mask=padding_mask)
        x = layer_norm(model.emb_layer_norm_after, x)
        logits = roberta_lm_head(model.lm_head, x.float(), model.embed_tokens.weight, shard)
    return {"logits": logits}


def _stack_with_streaming_contacts(
    model, cfg, x, tokens, padding_mask, collect_hiddens: bool,
    strip_last_key: bool = False, static=None,
):
    """Layer loop with the contact regression folded in: each layer's
    (B, H, T, S) map is masked, bos/eos-stripped, symmetrized + APC'd and
    contracted with that layer's regression weights into a (B, T', T') sum
    (esm_tpu/models/esm2.py:312-366). ``strip_last_key`` first drops the
    bias_kv key column (ESM-1, reference esm/model/esm1.py:181-183).
    ``model`` is an ESM2 or ESM1 module, ``cfg`` its config; ``static``
    the layers' options (``cfg.layer_static()`` by default)."""
    static = static or cfg.layer_static()
    keep = 1.0 - padding_mask.float()
    pair_mask = keep[:, None, :] * keep[:, :, None]              # (B, T, T)
    if cfg.append_eos:
        eos_keep = (tokens != cfg.eos_idx).float()
        eos_pair = eos_keep[:, None, :] * eos_keep[:, :, None]
    reg_w = materialize_weight(model.contact_head.regression, torch.float32).reshape(
        cfg.num_layers, cfg.attention_heads
    )

    b, t = tokens.shape
    t_out = t - int(cfg.append_eos) - int(cfg.prepend_bos)
    acc = torch.zeros((b, t_out, t_out), dtype=torch.float32, device=x.device)
    hiddens = []
    for layer, w_l in zip(model.layers, reg_w):
        x, probs = transformer_layer_apply(
            layer, x, static=static, key_padding_mask=padding_mask, need_head_weights=True
        )
        a = probs.float()
        if strip_last_key:
            a = a[..., :-1]
        a = a * pair_mask[:, None]
        if cfg.append_eos:
            a = (a * eos_pair[:, None])[..., :-1, :-1]
        if cfg.prepend_bos:
            a = a[..., 1:, 1:]
        acc = acc + weighted_apc_symmetrize(a, w_l)
        if collect_hiddens:
            hiddens.append(x)
    return x, (torch.stack(hiddens) if collect_hiddens else None), acc
