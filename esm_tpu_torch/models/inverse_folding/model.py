"""The GVP-Transformer inverse-folding model (ESM-IF1).

Port of esm_tpu/models/inverse_folding/model.py (reference semantics:
esm/inverse_folding/gvp_transformer.py, gvp_transformer_encoder.py). The
encoder embedding is the sum of the scaled mask-token embedding, the
dihedral embedding, the GVP encoder's output rotated into each residue's
local frame, an RBF embedding of the confidence and the raw GVP input
features in the local frame; then sinusoidal positions and the transformer
encoder layers. The decoder is autoregressive from the ``<cath>`` token.

``GVPTransformerModel`` holds the parameters under the reference's
state-dict keys. ``sample`` decodes with a Python loop over positions on the
in-place KV cache of transformer.py (no torch.compile, no CUDA graph); each
step draws one (n, V) block of uniforms from a ``torch.Generator`` on the
model's device, so the tokens drawn at a position depend only on the seed
and the logits, whatever the length the backbone was padded to.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from ...data.alphabet import Alphabet
from ...ops.common import layer_norm, linear, new_embedding, new_layer_norm, new_linear
from ...ops.positional import SinusoidalPositionalEmbedding, sinusoidal_positional_embedding
from .features import DihedralFeatures, node_features
from .gvp import GVPEncoder
from .transformer import (
    TransformerDecoder,
    TransformerEncoderLayer,
    decoder_apply,
    decoder_step,
    encoder_layer_apply,
    init_decode_cache,
)
from .util import CoordBatchConverter, get_rotation_frames, nan_to_num, rbf, rotate


@dataclass(frozen=True)
class GVPTransformerConfig:
    """The defaults are the released esm_if1_gvp4_t16_142M_UR50."""
    encoder_embed_dim: int = 512
    encoder_layers: int = 8
    encoder_attention_heads: int = 8
    encoder_ffn_embed_dim: int = 2048
    decoder_embed_dim: int = 512
    decoder_layers: int = 8
    decoder_attention_heads: int = 8
    decoder_ffn_embed_dim: int = 2048
    # GVP encoder
    gvp_top_k_neighbors: int = 30
    gvp_node_hidden_dim_scalar: int = 1024
    gvp_node_hidden_dim_vector: int = 256
    gvp_edge_hidden_dim_scalar: int = 32
    gvp_edge_hidden_dim_vector: int = 1
    gvp_num_encoder_layers: int = 4
    # alphabet (invariant_gvp: 31 prepend+standard tokens padded to 32 with
    # <null_1>, then <mask>=32, <cath>=33, <af2>=34)
    alphabet_size: int = 35
    padding_idx: int = 1
    mask_idx: int = 32
    cath_idx: int = 33

    @classmethod
    def from_alphabet(cls, alphabet: Alphabet, **kw) -> "GVPTransformerConfig":
        return cls(alphabet_size=len(alphabet), padding_idx=alphabet.padding_idx,
                   mask_idx=alphabet.mask_idx, cath_idx=alphabet.get_idx("<cath>"), **kw)


# Released sizes by registry name: the config's defaults (the released args
# of esm_if1_gvp4_t16_142M_UR50, reference README "Available models").
IF1_SIZES = {"esm_if1_gvp4_t16_142M_UR50": {}}


class GVPTransformerEncoder(nn.Module):
    def __init__(self, cfg: GVPTransformerConfig, device=None):
        super().__init__()
        c = cfg.encoder_embed_dim
        ns, nv = cfg.gvp_node_hidden_dim_scalar, cfg.gvp_node_hidden_dim_vector
        self.embed_tokens = new_embedding(cfg.alphabet_size, c, padding_idx=cfg.padding_idx,
                                          device=device)
        self.embed_positions = SinusoidalPositionalEmbedding(device=device)
        self.embed_gvp_input_features = new_linear(15, c, device=device)
        self.embed_confidence = new_linear(16, c, device=device)
        self.embed_dihedrals = DihedralFeatures(c, device=device)
        self.gvp_encoder = GVPEncoder(
            (ns, nv), (cfg.gvp_edge_hidden_dim_scalar, cfg.gvp_edge_hidden_dim_vector),
            cfg.gvp_top_k_neighbors, cfg.gvp_num_encoder_layers, device=device)
        self.embed_gvp_output = new_linear(ns + 3 * nv, c, device=device)
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(c, cfg.encoder_ffn_embed_dim, device)
            for _ in range(cfg.encoder_layers))
        self.layer_norm = new_layer_norm(c, device=device)


class GVPTransformerModel(nn.Module):
    """ESM-IF1's parameters, named as the reference's module. Built without
    init: call :func:`init.init` or load a state dict."""

    def __init__(self, cfg: GVPTransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.encoder = GVPTransformerEncoder(cfg, device)
        self.decoder = TransformerDecoder(
            cfg.alphabet_size, cfg.decoder_embed_dim, cfg.encoder_embed_dim,
            cfg.decoder_ffn_embed_dim, cfg.decoder_layers, cfg.padding_idx, device)

    @property
    def device(self) -> torch.device:
        return self.decoder.embed_tokens.weight.device

    def forward(self, coords, padding_mask, confidence, prev_output_tokens):
        """Teacher-forced forward (reference gvp_transformer.py:66-86).
        Returns logits (B, V, T)."""
        cfg = self.cfg
        enc = encoder_apply(self.encoder, cfg, coords, padding_mask, confidence)
        return decoder_apply(self.decoder, prev_output_tokens, enc,
                             num_heads=cfg.decoder_attention_heads, padding_idx=cfg.padding_idx,
                             enc_padding_mask=padding_mask)


def encoder_embedding(encoder: GVPTransformerEncoder, cfg: GVPTransformerConfig, coords,
                      padding_mask, confidence):
    """forward_embedding (reference gvp_transformer_encoder.py:73-121)."""
    coord_mask = torch.isfinite(coords).all(dim=-1).all(dim=-1)
    coords = nan_to_num(coords)
    mask_tokens = torch.where(padding_mask, cfg.padding_idx, cfg.mask_idx)

    components = {}
    components["tokens"] = (encoder.embed_tokens.weight[mask_tokens]
                            * math.sqrt(cfg.encoder_embed_dim))
    components["diherals"] = encoder.embed_dihedrals(coords)

    gvp_s, gvp_v = encoder.gvp_encoder(coords, coord_mask, padding_mask, confidence)
    r_t = get_rotation_frames(coords).transpose(-2, -1)
    gvp_feats = torch.cat([gvp_s, rotate(gvp_v, r_t).flatten(-2)], dim=-1)
    components["gvp_out"] = linear(encoder.embed_gvp_output, gvp_feats)
    components["confidence"] = linear(encoder.embed_confidence, rbf(confidence, 0.0, 1.0))

    scalar_f, vector_f = node_features(coords, coord_mask, with_coord_mask=False)
    features = torch.cat([scalar_f, rotate(vector_f, r_t).flatten(-2)], dim=-1)
    components["gvp_input_features"] = linear(encoder.embed_gvp_input_features, features)

    embed = sum(components.values())
    return embed + sinusoidal_positional_embedding(mask_tokens, cfg.encoder_embed_dim,
                                                   cfg.padding_idx)


def encoder_apply(encoder: GVPTransformerEncoder, cfg: GVPTransformerConfig, coords,
                  padding_mask, confidence):
    """GVPTransformerEncoder.forward (reference gvp_transformer_encoder.py:
    123-184). Returns the (B, T, C) encoder output."""
    x = encoder_embedding(encoder, cfg, coords, padding_mask, confidence)
    x = x * (1 - padding_mask[..., None].to(x.dtype))
    for layer in encoder.layers:
        x = encoder_layer_apply(layer, x, num_heads=cfg.encoder_attention_heads,
                                padding_mask=padding_mask)
    return layer_norm(encoder.layer_norm, x)


def _batch(model: GVPTransformerModel, alphabet: Alphabet, coords, confidence=None, seq=None):
    converter = CoordBatchConverter(alphabet)
    return converter([(coords, confidence, seq)], device=model.device)


@torch.no_grad()
def get_sequence_loss(model: GVPTransformerModel, alphabet: Alphabet, coords, seq: str):
    """Per-position cross entropy (reference esm/inverse_folding/util.py:
    106-121). Returns numpy (loss (T-1,), target_padding_mask (T-1,))."""
    batch_coords, conf, _, tokens, padding_mask = _batch(model, alphabet, coords, seq=seq)
    logits = model(batch_coords, padding_mask, conf, tokens[:, :-1])  # (B, V, T)
    logp = torch.log_softmax(logits.float(), dim=1)
    target = tokens[:, 1:]
    loss = -logp[0].gather(0, target[0][None])[0]
    return loss.cpu().numpy(), (target[0] == alphabet.padding_idx).cpu().numpy()


def score_sequence(model: GVPTransformerModel, alphabet: Alphabet, coords, seq: str):
    """Average log-likelihood over the whole sequence and over the positions
    with coordinates (reference esm/inverse_folding/util.py:123-130)."""
    loss, target_padding_mask = get_sequence_loss(model, alphabet, coords, seq)
    ll_fullseq = -np.sum(loss * ~target_padding_mask) / np.sum(~target_padding_mask)
    coord_mask = np.all(np.isfinite(np.asarray(coords, np.float32)), axis=(-1, -2))
    ll_withcoord = -np.sum(loss * coord_mask) / np.sum(coord_mask)
    return float(ll_fullseq), float(ll_withcoord)


def draw_tokens(logits: torch.Tensor, temperature: float,
                generator: torch.Generator) -> torch.Tensor:
    """One categorical draw per row of softmax(logits / temperature), by the
    Gumbel-max trick on one (n, V) block of uniforms from ``generator``."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits.float() / temperature + gumbel, dim=-1)


@torch.no_grad()
def sample_tokens(model: GVPTransformerModel, coords, padding_mask, confidence,
                  init_tokens: torch.Tensor, generator: torch.Generator,
                  temperature: float = 1.0, step_logits: Optional[List] = None) -> torch.Tensor:
    """The batched incremental decode. ``init_tokens`` (n, 1 + T): ``<cath>``
    then ``<mask>`` where a token is to be drawn and any other token where it
    is given (kept, as the reference keeps them, gvp_transformer.py:126-137).
    A batch of one backbone is encoded once for all n rows. Returns the
    (n, 1 + T) tokens; ``step_logits``, a list, collects each step's (n, V)
    logits."""
    cfg = model.cfg
    heads = cfg.decoder_attention_heads
    n, max_len = init_tokens.shape[0], init_tokens.shape[1] - 1
    enc = encoder_apply(model.encoder, cfg, coords, padding_mask, confidence)
    if enc.shape[0] != n:
        enc = enc.expand(n, -1, -1)
        padding_mask = padding_mask.expand(n, -1)
    cache = init_decode_cache(model.decoder, enc, num_heads=heads, max_len=max_len,
                              padding_idx=cfg.padding_idx, dtype=enc.dtype)
    tokens = init_tokens.clone()
    for i in range(1, max_len + 1):
        logits, cache = decoder_step(model.decoder, tokens[:, i - 1], i - 1, cache,
                                     num_heads=heads, padding_idx=cfg.padding_idx,
                                     enc_padding_mask=padding_mask)
        if step_logits is not None:
            step_logits.append(logits)
        drawn = draw_tokens(logits, temperature, generator)
        given = tokens[:, i]
        tokens[:, i] = torch.where(given != cfg.mask_idx, given, drawn)
    return tokens


def sample(model: GVPTransformerModel, alphabet: Alphabet, coords, *,
           partial_seq=None, temperature: float = 1.0, confidence=None, seed: int = 0,
           generator: Optional[torch.Generator] = None, return_tokens: bool = False,
           num_samples: int = 1, pad_to_multiple: Optional[int] = None):
    """Sequence design for a backbone (reference gvp_transformer.py:88-140).

    ``partial_seq``: a string or a list of tokens fixing positions
    (``<mask>`` to draw). ``num_samples > 1`` draws that many sequences in
    one batched decode and returns a list. ``pad_to_multiple`` pads the
    residues to a multiple of that length with the converter's batch
    padding, after the eos residue, so that the residues' logits are those
    of the unpadded call and the sampled prefix is the same for the same
    seed; the padded tail is stripped. (esm_tpu NaN-pads the coordinates
    before conversion, which moves the eos residue and changes the logits.)
    ``generator`` (on the model's device) overrides ``seed``."""
    cfg = model.cfg
    L = len(coords)
    batch_coords, conf, _, _, padding_mask = _batch(model, alphabet, coords, confidence)
    padn = (-L) % int(pad_to_multiple) if pad_to_multiple else 0
    if padn:
        batch_coords = nn.functional.pad(batch_coords, (0, 0, 0, 0, 0, padn), value=float("nan"))
        conf = nn.functional.pad(conf, (0, padn), value=-1.0)
        padding_mask = nn.functional.pad(padding_mask, (0, padn), value=True)

    tokens = torch.full((1, 1 + L + padn), cfg.mask_idx, dtype=torch.int64)
    tokens[0, 0] = cfg.cath_idx
    if partial_seq is not None:
        for i, c in enumerate(partial_seq):
            tokens[0, i + 1] = alphabet.get_idx(c)

    n = max(int(num_samples), 1)
    if generator is None:
        generator = torch.Generator(device=model.device).manual_seed(int(seed))
    out = sample_tokens(model, batch_coords, padding_mask, conf,
                        tokens.to(model.device).expand(n, -1), generator, temperature)
    out = out[:, 1:1 + L].cpu().numpy()  # strip <cath> and the padded tail
    if return_tokens:
        return out if num_samples > 1 else out[0]
    seqs = ["".join(alphabet.get_tok(int(a)) for a in row) for row in out]
    return seqs if num_samples > 1 else seqs[0]


@torch.no_grad()
def get_encoder_output(model: GVPTransformerModel, alphabet: Alphabet, coords) -> torch.Tensor:
    """Encoder representations of a backbone, bos/eos stripped (reference
    esm/inverse_folding/util.py:133-143). Returns (L, C)."""
    batch_coords, conf, _, _, padding_mask = _batch(model, alphabet, coords)
    enc = encoder_apply(model.encoder, model.cfg, batch_coords, padding_mask, conf)
    return enc[0, 1:-1]

