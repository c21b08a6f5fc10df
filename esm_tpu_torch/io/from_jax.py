"""Weights carried across from the JAX package.

``esm2_state_dict_from_jax`` takes an ESM-2 parameter pytree of esm_tpu's
layout, as numpy arrays (no JAX needed here), and returns this port's state
dict: the reference's canonical key layout, so ``ESM2.load_state_dict``
takes it strictly; ``esmfold_state_dict_from_jax`` does the same for
ESMFold. They are the port's own copy of the rules in
esm_tpu/io/export.py:128-169 and :572-676:
  * ``kernel`` (in, out) -> Linear ``weight`` (out, in), transposed;
  * LN ``scale``/``bias`` -> LayerNorm ``weight``/``bias``;
  * the stacked layer axis -> per-layer ``layers.{i}.*`` keys;
  * ``lm_head.weight`` tied to the token embedding;
  * the analytic rotary ``rot_emb.inv_freq`` buffers;
  * the contact regression (``contact_head.regression.*``).
``esm1_state_dict_from_jax`` (ESM-1 and ESM-1b/1v) and
``msa_state_dict_from_jax`` follow esm_tpu/io/export.py:224-261 and
:323-425: ESM-1's (D,) bias_k/bias_v become (1, 1, D), its ``embed_out``
kernel (D, V) is stored (V, D), its sinusoidal table leaves only the
``embed_positions._float_tensor`` buffer; the MSA position embedding
(1024, 1, D) becomes (1, 1024, 1, D). ``if1_state_dict_from_jax`` turns
ESM-IF1's tree into the port's ``GVPTransformerModel`` state dict by the
rules of esm_tpu/io/export.py:445-505: each GVP's wh/ws/wv/wg as present,
tuple LNs under ``scalar_norm``, the GVP conv layers' ``norm0``/``norm1``
as ``norm.0``/``norm.1``, the embedding GVP and its LN as ``.0``/``.1``,
and the two ``embed_positions._float_tensor`` buffers.

A weight-only int8 kernel (esm_tpu/quantization.py) becomes an int8
``weight`` beside its fp32 ``scale``: load such a state dict into a model
given the int8 layout by ``quantization.adopt_int8_layout``.
``lora_from_jax`` carries a LoRA adapter tree (esm_tpu/lora.py) onto the
port's ``lora.LoRA`` module, and :func:`jax_leaf` names the esm_tpu
parameter leaf that each of the port's modules belongs to.
``distogram_projection_from_jax`` turns lm-design's distogram projection
(esm_tpu/apps/lm_design.py:204-253, per-pair linears (C, bins)) into the
state dict of the port's ``DistogramProjection`` (1x1 Conv2d weights
(bins, C, 1, 1)).
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    a = np.asarray(x)
    if np.issubdtype(a.dtype, np.floating):
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a))


def _linear(sd: Dict, key: str, p, i: Optional[int] = None) -> None:
    k = np.asarray(p["kernel"])
    if i is not None:
        k = k[i]
    sd[f"{key}.weight"] = _t(k.T)
    for name in ("bias", "scale"):  # "scale": a weight-only int8 kernel's
        if name in p:
            a = np.asarray(p[name])
            sd[f"{key}.{name}"] = _t(a[i] if i is not None else a)


def _ln(sd: Dict, key: str, p, i: Optional[int] = None) -> None:
    for src, dst in (("scale", "weight"), ("bias", "bias")):
        a = np.asarray(p[src])
        sd[f"{key}.{dst}"] = _t(a[i] if i is not None else a)


def rotary_inv_freq(head_dim: int) -> torch.Tensor:
    """The analytic rotary buffer, in fp32 end to end (reference
    esm/rotary_embedding.py:34-36)."""
    exp = np.arange(0, head_dim, 2, dtype=np.float32) / np.float32(head_dim)
    return torch.from_numpy(np.float32(1.0) / np.float32(10000.0) ** exp)


def _transformer_layers(sd: Dict, layers, *, inv_freq: Optional[torch.Tensor] = None,
                        bias_kv: bool = False) -> None:
    """The stacked pre-LN layers -> ``layers.{i}.*`` keys, with the rotary
    buffer (ESM-2) or the (1, 1, D) bias_k/bias_v (ESM-1)."""
    n = int(np.asarray(layers["fc1"]["kernel"]).shape[0])
    for i in range(n):
        p = f"layers.{i}"
        attn = layers["self_attn"]
        for name in ("k_proj", "v_proj", "q_proj", "out_proj"):
            _linear(sd, f"{p}.self_attn.{name}", attn[name], i)
        if inv_freq is not None:
            sd[f"{p}.self_attn.rot_emb.inv_freq"] = inv_freq.clone()
        if bias_kv:
            for name in ("bias_k", "bias_v"):
                sd[f"{p}.self_attn.{name}"] = _t(np.asarray(attn[name])[i]).reshape(1, 1, -1)
        _ln(sd, f"{p}.self_attn_layer_norm", layers["self_attn_layer_norm"], i)
        _linear(sd, f"{p}.fc1", layers["fc1"], i)
        _linear(sd, f"{p}.fc2", layers["fc2"], i)
        _ln(sd, f"{p}.final_layer_norm", layers["final_layer_norm"], i)


def _lm_head(sd: Dict, head, emb: torch.Tensor) -> None:
    _linear(sd, "lm_head.dense", head["dense"])
    _ln(sd, "lm_head.layer_norm", head["layer_norm"])
    sd["lm_head.weight"] = emb  # tied projection (reference esm/modules.py:303-308)
    sd["lm_head.bias"] = _t(head["bias"])


def esm2_state_dict_from_jax(params, cfg) -> Dict[str, torch.Tensor]:
    emb = _t(params["embed_tokens"]["weight"])
    sd: Dict[str, torch.Tensor] = {"embed_tokens.weight": emb}
    _transformer_layers(sd, params["layers"],
                        inv_freq=rotary_inv_freq(cfg.embed_dim // cfg.attention_heads))
    _ln(sd, "emb_layer_norm_after", params["emb_layer_norm_after"])
    _lm_head(sd, params["lm_head"], emb)
    _linear(sd, "contact_head.regression", params["contact_head"]["regression"])
    return sd


def esm1_state_dict_from_jax(params, cfg) -> Dict[str, torch.Tensor]:
    """An ESM-1/1b/1v parameter pytree of esm_tpu's layout (numpy) -> the
    port's ``ESM1`` state dict (esm_tpu/io/export.py:343-425). ``cfg`` is
    the ESM1Config (its ``model_version`` picks the layout)."""
    emb = _t(params["embed_tokens"]["weight"])
    sd: Dict[str, torch.Tensor] = {"embed_tokens.weight": emb}
    is_1b = cfg.model_version == "ESM-1b"
    _transformer_layers(sd, params["layers"], bias_kv=not is_1b)
    _linear(sd, "contact_head.regression", params["contact_head"]["regression"])
    if is_1b:
        sd["embed_positions.weight"] = _t(params["embed_positions"]["weight"])
        if "emb_layer_norm_before" in params:
            _ln(sd, "emb_layer_norm_before", params["emb_layer_norm_before"])
        _ln(sd, "emb_layer_norm_after", params["emb_layer_norm_after"])
        _lm_head(sd, params["lm_head"], emb)
    else:
        sd["embed_positions._float_tensor"] = torch.zeros(1)
        sd["embed_out"] = _t(np.asarray(params["embed_out"]["kernel"]).T)  # stored (V, D)
        if "scale" in params["embed_out"]:  # a weight-only int8 kernel
            sd["embed_out_scale"] = _t(params["embed_out"]["scale"])
        if "bias" in params["embed_out"]:
            sd["embed_out_bias"] = _t(params["embed_out"]["bias"])
    return sd


def msa_state_dict_from_jax(params, cfg) -> Dict[str, torch.Tensor]:
    """An MSA Transformer parameter pytree of esm_tpu's layout (numpy) -> the
    port's ``MSATransformer`` state dict, canonical (unswapped) row/column
    keys (esm_tpu/io/export.py:224-261)."""
    emb = _t(params["embed_tokens"]["weight"])
    sd: Dict[str, torch.Tensor] = {
        "embed_tokens.weight": emb,
        "embed_positions.weight": _t(params["embed_positions"]["weight"]),
    }
    if "msa_position_embedding" in params:
        sd["msa_position_embedding"] = _t(params["msa_position_embedding"])[None]
    layers = params["layers"]
    n = int(np.asarray(layers["feed_forward_layer"]["layer"]["fc1"]["kernel"]).shape[0])
    for i in range(n):
        p = f"layers.{i}"
        for attn in ("row_self_attention", "column_self_attention"):
            for name in ("k_proj", "v_proj", "q_proj", "out_proj"):
                _linear(sd, f"{p}.{attn}.layer.{name}", layers[attn]["layer"][name], i)
            _ln(sd, f"{p}.{attn}.layer_norm", layers[attn]["layer_norm"], i)
        ffn = layers["feed_forward_layer"]
        _linear(sd, f"{p}.feed_forward_layer.layer.fc1", ffn["layer"]["fc1"], i)
        _linear(sd, f"{p}.feed_forward_layer.layer.fc2", ffn["layer"]["fc2"], i)
        _ln(sd, f"{p}.feed_forward_layer.layer_norm", ffn["layer_norm"], i)
    _ln(sd, "emb_layer_norm_before", params["emb_layer_norm_before"])
    _ln(sd, "emb_layer_norm_after", params["emb_layer_norm_after"])
    _lm_head(sd, params["lm_head"], emb)
    _linear(sd, "contact_head.regression", params["contact_head"]["regression"])
    return sd


def esmfold_state_dict_from_jax(params, cfg) -> Dict[str, torch.Tensor]:
    """An ESMFold parameter pytree of esm_tpu's layout (numpy) -> the port's
    ``ESMFold`` state dict: the reference checkpoint's keys (the port's own
    copy of esm_tpu/io/export.py:572-676, ``export_esmfold_state_dict``), plus
    the LM under ``esm.*`` (:func:`esm2_state_dict_from_jax` on
    ``params["esm"]``). ``cfg`` is the ESMFold config (its ``esm`` part sizes
    the LM's rotary buffers)."""
    sd: Dict[str, torch.Tensor] = {
        f"esm.{k}": v for k, v in esm2_state_dict_from_jax(params["esm"], cfg.esm).items()
    }
    sd["esm_s_combine"] = _t(params["esm_s_combine"])

    def mlp3(key: str, p) -> None:  # Sequential(LayerNorm, Linear, ReLU, Linear)
        _ln(sd, f"{key}.0", p["norm"])
        _linear(sd, f"{key}.1", p["fc1"])
        _linear(sd, f"{key}.3", p["fc2"])

    mlp3("esm_s_mlp", params["esm_s_mlp"])
    if "esm_z_mlp" in params:
        mlp3("esm_z_mlp", params["esm_z_mlp"])
    sd["embedding.weight"] = _t(params["embedding"]["weight"])
    for name in ("distogram_head", "ptm_head", "lm_head"):
        _linear(sd, name, params[name])
    lddt = params["lddt_head"]
    _ln(sd, "lddt_head.0", lddt["norm"])
    for i, name in enumerate(("fc1", "fc2", "fc3"), start=1):
        _linear(sd, f"lddt_head.{i}", lddt[name])

    trunk = params["trunk"]
    sd["trunk.pairwise_positional_embedding.embedding.weight"] = _t(
        trunk["pairwise_positional_embedding"]["embedding"]["weight"])
    _ln(sd, "trunk.recycle_s_norm", trunk["recycle_s_norm"])
    _ln(sd, "trunk.recycle_z_norm", trunk["recycle_z_norm"])
    sd["trunk.recycle_disto.weight"] = _t(trunk["recycle_disto"]["weight"])
    _linear(sd, "trunk.trunk2sm_s", trunk["trunk2sm_s"])
    _linear(sd, "trunk.trunk2sm_z", trunk["trunk2sm_z"])

    blocks = trunk["blocks"]
    n_blocks = 0 if blocks is None else int(np.asarray(blocks["layernorm_1"]["scale"]).shape[0])
    for i in range(n_blocks):
        p = f"trunk.blocks.{i}"
        _ln(sd, f"{p}.layernorm_1", blocks["layernorm_1"], i)
        s2p = blocks["sequence_to_pair"]
        _ln(sd, f"{p}.sequence_to_pair.layernorm", s2p["layernorm"], i)
        _linear(sd, f"{p}.sequence_to_pair.proj", s2p["proj"], i)
        _linear(sd, f"{p}.sequence_to_pair.o_proj", s2p["o_proj"], i)
        p2s = blocks["pair_to_sequence"]
        _ln(sd, f"{p}.pair_to_sequence.layernorm", p2s["layernorm"], i)
        _linear(sd, f"{p}.pair_to_sequence.linear", p2s["linear"], i)
        for name in ("proj", "o_proj", "g_proj"):
            _linear(sd, f"{p}.seq_attention.{name}", blocks["seq_attention"][name], i)
        for tm in ("tri_mul_out", "tri_mul_in"):
            t = blocks[tm]
            _ln(sd, f"{p}.{tm}.layer_norm_in", t["layer_norm_in"], i)
            _ln(sd, f"{p}.{tm}.layer_norm_out", t["layer_norm_out"], i)
            for name in ("linear_a_p", "linear_a_g", "linear_b_p", "linear_b_g", "linear_g",
                         "linear_z"):
                _linear(sd, f"{p}.{tm}.{name}", t[name], i)
        for ta in ("tri_att_start", "tri_att_end"):
            t = blocks[ta]
            _ln(sd, f"{p}.{ta}.layer_norm", t["layer_norm"], i)
            _linear(sd, f"{p}.{ta}.linear", t["linear"], i)
            for name in ("linear_q", "linear_k", "linear_v", "linear_o", "linear_g"):
                _linear(sd, f"{p}.{ta}.mha.{name}", t["mha"][name], i)
        for mlp in ("mlp_seq", "mlp_pair"):
            m = blocks[mlp]
            _ln(sd, f"{p}.{mlp}.mlp.0", m["norm"], i)
            _linear(sd, f"{p}.{mlp}.mlp.1", m["fc1"], i)
            _linear(sd, f"{p}.{mlp}.mlp.3", m["fc2"], i)

    sm = trunk["structure_module"]
    p = "trunk.structure_module"
    _ln(sd, f"{p}.layer_norm_s", sm["layer_norm_s"])
    _ln(sd, f"{p}.layer_norm_z", sm["layer_norm_z"])
    _linear(sd, f"{p}.linear_in", sm["linear_in"])
    for name in ("linear_q", "linear_kv", "linear_q_points", "linear_kv_points", "linear_b",
                 "linear_out"):
        _linear(sd, f"{p}.ipa.{name}", sm["ipa"][name])
    sd[f"{p}.ipa.head_weights"] = _t(sm["ipa"]["head_weights"])
    _ln(sd, f"{p}.layer_norm_ipa", sm["layer_norm_ipa"])
    for i, layer in enumerate(sm["transition"]["layers"]):
        for name in ("linear_1", "linear_2", "linear_3"):
            _linear(sd, f"{p}.transition.layers.{i}.{name}", layer[name])
    _ln(sd, f"{p}.transition.layer_norm", sm["transition"]["layer_norm"])
    _linear(sd, f"{p}.bb_update.linear", sm["bb_update"]["linear"])
    ar = sm["angle_resnet"]
    _linear(sd, f"{p}.angle_resnet.linear_in", ar["linear_in"])
    _linear(sd, f"{p}.angle_resnet.linear_initial", ar["linear_initial"])
    for i, layer in enumerate(ar["layers"]):
        for name in ("linear_1", "linear_2"):
            _linear(sd, f"{p}.angle_resnet.layers.{i}.{name}", layer[name])
    _linear(sd, f"{p}.angle_resnet.linear_out", ar["linear_out"])
    return sd


def if1_state_dict_from_jax(params, cfg) -> Dict[str, torch.Tensor]:
    """An ESM-IF1 parameter tree of esm_tpu's layout (numpy) -> the port's
    ``GVPTransformerModel`` state dict (esm_tpu/io/export.py:445-505)."""
    sd: Dict[str, torch.Tensor] = {}

    def gvp(key: str, p) -> None:
        for name in ("wh", "ws", "wv", "wg"):
            if name in p:
                _linear(sd, f"{key}.{name}", p[name])

    def attn(key: str, p) -> None:
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear(sd, f"{key}.{name}", p[name])

    def layer(key: str, p) -> None:
        attn(f"{key}.self_attn", p["self_attn"])
        _ln(sd, f"{key}.self_attn_layer_norm", p["self_attn_layer_norm"])
        if "encoder_attn" in p:
            attn(f"{key}.encoder_attn", p["encoder_attn"])
            _ln(sd, f"{key}.encoder_attn_layer_norm", p["encoder_attn_layer_norm"])
        _linear(sd, f"{key}.fc1", p["fc1"])
        _linear(sd, f"{key}.fc2", p["fc2"])
        _ln(sd, f"{key}.final_layer_norm", p["final_layer_norm"])

    enc, dec = params["encoder"], params["decoder"]
    sd["encoder.embed_tokens.weight"] = _t(enc["embed_tokens"]["weight"])
    sd["encoder.embed_positions._float_tensor"] = torch.zeros(1)
    _linear(sd, "encoder.embed_gvp_input_features", enc["embed_gvp_input_features"])
    _linear(sd, "encoder.embed_confidence", enc["embed_confidence"])
    dih = enc["embed_dihedrals"]
    _linear(sd, "encoder.embed_dihedrals.node_embedding", dih["node_embedding"])
    sd["encoder.embed_dihedrals.norm_nodes.gain"] = _t(dih["norm_nodes"]["gain"])
    sd["encoder.embed_dihedrals.norm_nodes.bias"] = _t(dih["norm_nodes"]["bias"])
    g, eg = "encoder.gvp_encoder.embed_graph", enc["gvp_encoder"]["embed_graph"]
    gvp(f"{g}.embed_node.0", eg["embed_node_gvp"])
    _ln(sd, f"{g}.embed_node.1.scalar_norm", eg["embed_node_norm"]["scalar_norm"])
    gvp(f"{g}.embed_edge.0", eg["embed_edge_gvp"])
    _ln(sd, f"{g}.embed_edge.1.scalar_norm", eg["embed_edge_norm"]["scalar_norm"])
    _linear(sd, f"{g}.embed_confidence", eg["embed_confidence"])
    for i, lp in enumerate(enc["gvp_encoder"]["encoder_layers"]):
        key = f"encoder.gvp_encoder.encoder_layers.{i}"
        for j, m in enumerate(lp["conv"]["message_func"]):
            gvp(f"{key}.conv.message_func.{j}", m)
        _ln(sd, f"{key}.norm.0.scalar_norm", lp["norm0"]["scalar_norm"])
        _ln(sd, f"{key}.norm.1.scalar_norm", lp["norm1"]["scalar_norm"])
        for j, m in enumerate(lp["ff_func"]):
            gvp(f"{key}.ff_func.{j}", m)
    _linear(sd, "encoder.embed_gvp_output", enc["embed_gvp_output"])
    for i, lp in enumerate(enc["layers"]):
        layer(f"encoder.layers.{i}", lp)
    _ln(sd, "encoder.layer_norm", enc["layer_norm"])

    sd["decoder.embed_tokens.weight"] = _t(dec["embed_tokens"]["weight"])
    sd["decoder.embed_positions._float_tensor"] = torch.zeros(1)
    for i, lp in enumerate(dec["layers"]):
        layer(f"decoder.layers.{i}", lp)
    _ln(sd, "decoder.layer_norm", dec["layer_norm"])
    _linear(sd, "decoder.output_projection", dec["output_projection"])
    return sd

def distogram_projection_from_jax(proj_params) -> Dict[str, torch.Tensor]:
    """{"conv1": {"kernel" (C, 36), "bias"}, "conv2": ...} -> the
    ``DistogramProjection`` state dict: ``conv{1,2}.weight`` (out, C, 1, 1)
    and ``.bias``, the released checkpoint's layout."""
    sd = {}
    for name in ("conv1", "conv2"):
        _linear(sd, name, proj_params[name])
        sd[f"{name}.weight"] = sd[f"{name}.weight"][:, :, None, None].contiguous()
    return sd



# The port's module lists that esm_tpu stacks into one leaf with a leading
# layer axis (driven by lax.scan): the language models' layers (also those
# of ESMFold's LM) and ESMFold's trunk blocks. ESM-IF1's layers and the
# structure module's stay Python lists there, one leaf per layer.
_STACKED = ("layers", "esm.layers", "trunk.blocks")
# Port module names that esm_tpu spells otherwise: the Sequential indices of
# ESMFold's MLPs and pLDDT head, ESM-IF1's graph-embedding GVPs.
_RENAMES = (
    (re.compile(r"^(esm_[sz]_mlp)\.0(?=\.|$)"), r"\1.norm"),
    (re.compile(r"^(esm_[sz]_mlp)\.1(?=\.|$)"), r"\1.fc1"),
    (re.compile(r"^(esm_[sz]_mlp)\.3(?=\.|$)"), r"\1.fc2"),
    (re.compile(r"^lddt_head\.0(?=\.|$)"), r"lddt_head.norm"),
    (re.compile(r"^lddt_head\.([123])(?=\.|$)"), r"lddt_head.fc\1"),
    (re.compile(r"(^|\.)(mlp_seq|mlp_pair)\.mlp\.0(?=\.|$)"), r"\1\2.norm"),
    (re.compile(r"(^|\.)(mlp_seq|mlp_pair)\.mlp\.1(?=\.|$)"), r"\1\2.fc1"),
    (re.compile(r"(^|\.)(mlp_seq|mlp_pair)\.mlp\.3(?=\.|$)"), r"\1\2.fc2"),
    (re.compile(r"(^|\.)embed_(node|edge)\.0(?=\.|$)"), r"\1embed_\2_gvp"),
)


def jax_leaf(name: str) -> Tuple[Tuple, Optional[int]]:
    """The esm_tpu node that the port's module or parameter ``name`` (relative
    to a model's root) belongs to: (its path as esm_tpu/lora.py spells paths,
    dict keys as str and list indices as int; the layer's index within a
    stacked leaf, or None). ``layers.3.self_attn.q_proj`` is
    (("layers", "self_attn", "q_proj"), 3). Rules that esm_tpu applies per
    leaf (quantize_params' ``min_size``, init_lora's order of draws,
    adafactor's block RMS) take the port's tensors in groups by this path."""
    layer = None
    for prefix in _STACKED:
        head, sep, rest = name.partition(prefix + ".")
        if head == "" and sep:
            idx, _, tail = rest.partition(".")
            if idx.isdigit():
                layer = int(idx)
                name = prefix + ("." + tail if tail else "")
            break
    for pattern, repl in _RENAMES:
        name = pattern.sub(repl, name)
    return tuple(int(p) if p.isdigit() else p for p in name.split(".")), layer


def lora_from_jax(adapters, model):
    """A LoRA adapter tree of esm_tpu/lora.py (numpy or JAX arrays; stacked
    (num_layers, d_in, r) factors, list-stacked layers with ``{}`` in the
    slots left out) -> the port's ``lora.LoRA`` for ``model``, one
    (d_in, r) / (r, d_out) pair per adapted ``nn.Linear``. Raises KeyError
    when an adapter has no linear in ``model``."""
    from ..lora import LoRA

    nodes = {}

    def collect(path, node):
        if isinstance(node, dict) and "lora_a" in node:
            nodes[path] = node
        elif isinstance(node, dict):
            for k, v in node.items():
                collect(path + (k,), v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                collect(path + (i,), v)

    collect((), adapters)
    factors, used = {}, set()
    for name, module in model.named_modules():
        if not isinstance(module, torch.nn.Linear):
            continue
        path, layer = jax_leaf(name)
        node = nodes.get(path)
        if node is None:
            continue
        used.add(path)
        a, b = (np.asarray(node[k]) for k in ("lora_a", "lora_b"))
        if layer is not None:
            a, b = a[layer], b[layer]
        factors[name] = (_t(a), _t(b))
    missing = sorted(set(nodes) - used, key=str)
    if missing:
        raise KeyError(f"adapters with no linear in the model: {missing}")
    return LoRA(factors)
