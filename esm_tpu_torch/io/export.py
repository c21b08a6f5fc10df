"""Write the port's models in the reference's released checkpoint layouts.

Port of esm_tpu/io/export.py's ``save_esm2`` (reference loader:
esm/pretrained.py:164-219): ``<name>.pt`` holds ``{"cfg": {"model":
Namespace}, "model": state}`` with the released ``encoder.sentence_encoder.``
/ ``encoder.`` key prefixes, and the contact regression goes to the
co-located ``<name>-contact-regression.pt``. The file stem must start with
``esm2``: that is how the loaders route a file to the ESM-2 path.
``save_esmfold`` writes ESMFold's trunk and heads in the reference's
esmfold format. ``save_esm1b``, ``save_esm1`` and ``save_msa`` write the
fairseq-era v1 layout (esm_tpu/io/export.py:272, :364, :773; reference
loader esm/pretrained.py:85-132): ``{"args": Namespace(arch=...), "model":
state}`` with the fairseq prefixes on the size args (``encoder_`` for
roberta_large and msa_transformer, ``decoder_`` for protein_bert_base) and
on the keys (``{stem}.sentence_encoder.``, ``{stem}.`` for the heads), the
MSA Transformer's row and column attention keys swapped as the released
files have them, and the contact regression in ``-contact-regression.pt``.
``save_if1`` writes ESM-IF1 as esm_tpu/io/export.py:508-560 does: arch
"vt_invariant_gvp_transformer", the constructor's sizes in the args, the
canonical keys, no regression file.
"""

from __future__ import annotations

import argparse
import os
import warnings
from typing import Dict, Optional, Tuple

import torch


def save_esm2(model, path) -> Tuple[str, str]:
    """Write ``path`` and its ``-contact-regression.pt``; returns both paths."""
    path = os.fspath(path)
    if not os.path.basename(path).startswith("esm2"):
        raise ValueError(f"file name {os.path.basename(path)!r} must start with 'esm2'")
    cfg = model.cfg
    state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    regression = {k: state.pop(k) for k in list(state) if k.startswith("contact_head.")}
    prefixed = {
        (("encoder." + k) if k.startswith("lm_head") else ("encoder.sentence_encoder." + k)): v
        for k, v in state.items()
    }
    torch.save(
        {
            "cfg": {
                "model": argparse.Namespace(
                    encoder_layers=cfg.num_layers,
                    encoder_embed_dim=cfg.embed_dim,
                    encoder_attention_heads=cfg.attention_heads,
                    token_dropout=cfg.token_dropout,
                )
            },
            "model": prefixed,
        },
        path,
    )
    reg_path = os.path.splitext(path)[0] + "-contact-regression.pt"
    torch.save({"model": regression}, reg_path)
    return path, reg_path


# The LM registry name of an ESM-2 size by depth (reference
# esm/esmfold/v1/esmfold.py:35-47).
_ESM_TYPE_BY_LAYERS = {6: "esm2_8M", 12: "esm2_35M", 30: "esm2_150M", 33: "esm2_650M",
                       36: "esm2_3B", 48: "esm2_15B"}


def _namespace(d):
    return argparse.Namespace(**{k: _namespace(v) if isinstance(v, dict) else v
                                 for k, v in d.items()})


def save_esmfold(model, path, esm_type: Optional[str] = None) -> str:
    """Write the port's ``ESMFold`` to ``path`` in the reference's esmfold
    checkpoint format (esm_tpu/io/export.py:683-770; reference loader
    esm/esmfold/v1/pretrained.py:13-38): ``{"cfg": {"model": cfg}, "model":
    state}`` with the ``esm.*`` LM keys left out (the LM rides its own
    checkpoint, named by ``cfg.esm_type``) and the cfg as nested
    ``argparse.Namespace``. Returns the path."""
    path = os.fspath(path)
    cfg = model.cfg
    esm_type = esm_type or cfg.esm_type or _ESM_TYPE_BY_LAYERS.get(cfg.esm.num_layers)
    if esm_type is None:
        raise ValueError(f"no reference esm_type for a {cfg.esm.num_layers}-layer LM; pass "
                         "esm_type= (reference esm/esmfold/v1/esmfold.py:35-47)")
    tc, smc = cfg.trunk, cfg.trunk.structure_module
    sm_keys = ("c_s", "c_z", "c_ipa", "c_resnet", "no_heads_ipa", "no_qk_points", "no_v_points",
               "dropout_rate", "no_blocks", "no_transition_layers", "no_resnet_blocks",
               "no_angles", "trans_scale_factor", "epsilon", "inf")
    cfg_dict = {
        "_name": "ESMFoldConfig",
        "esm_type": esm_type,
        "fp16_esm": True,  # the reference default (esmfold.py:62)
        "use_esm_attn_map": bool(cfg.use_esm_attn_map),
        "esm_ablate_pairwise": False,
        "esm_ablate_sequence": False,
        "esm_input_dropout": 0,
        "trunk": {
            "_name": "FoldingTrunkConfig",
            "num_blocks": tc.num_blocks,
            "sequence_state_dim": tc.sequence_state_dim,
            "pairwise_state_dim": tc.pairwise_state_dim,
            "sequence_head_width": tc.sequence_head_width,
            "pairwise_head_width": tc.pairwise_head_width,
            "position_bins": tc.position_bins,
            "dropout": 0,
            "layer_drop": 0,
            "cpu_grad_checkpoint": False,
            "max_recycles": tc.max_recycles,
            "chunk_size": tc.chunk_size,
            "structure_module": {k: getattr(smc, k) for k in sm_keys},
        },
        "lddt_head_hid_dim": cfg.lddt_head_hid_dim,
    }
    state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()
             if not k.startswith("esm.")}
    torch.save({"cfg": {"model": _namespace(cfg_dict)}, "model": state}, path)
    return path


def _v1_save(model, path, stem: str, args: Dict, rename=lambda k: k) -> Tuple[str, str]:
    """Write ``path`` in the v1 layout and its ``-contact-regression.pt``."""
    state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    regression = {k: state.pop(k) for k in list(state) if k.startswith("contact_head.")}
    heads = ("lm_head", "embed_out")
    prefixed = {
        (f"{stem}." if k.startswith(heads) else f"{stem}.sentence_encoder.") + rename(k): v
        for k, v in state.items()
    }
    torch.save({"args": argparse.Namespace(**args), "model": prefixed}, path)
    reg_path = os.path.splitext(path)[0] + "-contact-regression.pt"
    torch.save({"model": regression}, reg_path)
    return path, reg_path


def _sizes(cfg, prefix: str) -> Dict:
    return {f"{prefix}layers": cfg.num_layers, f"{prefix}embed_dim": cfg.embed_dim,
            f"{prefix}ffn_embed_dim": cfg.ffn_embed_dim,
            f"{prefix}attention_heads": cfg.attention_heads,
            "max_positions": cfg.max_positions}


def save_esm1b(model, path) -> Tuple[str, str]:
    """Write the port's ESM-1b/1v ``ESM1`` as arch "roberta_large"; the file
    stem must start with ``esm1``, as esm_tpu's saver requires. The v1
    loader zeroes the ``<mask>`` embedding row (esm/pretrained.py:100), so a
    model whose row is not zero does not round-trip that row: warned."""
    path = os.fspath(path)
    if not os.path.basename(path).startswith("esm1"):
        raise ValueError(f"file name {os.path.basename(path)!r} must start with 'esm1'")
    cfg = model.cfg
    if not cfg.is_1b:
        raise ValueError("save_esm1b is for model_version='ESM-1b'; ESM-1 saves with save_esm1")
    if model.embed_tokens.weight[cfg.mask_idx].any():
        warnings.warn("embed_tokens row for <mask> is nonzero; the v1 loader zeroes it at "
                      "load time (reference esm/pretrained.py:100)")
    args = dict(arch="roberta_large", **_sizes(cfg, "encoder_"), final_bias=True,
                token_dropout=cfg.token_dropout)
    return _v1_save(model, path, "encoder", args)


def save_esm1(model, path) -> Tuple[str, str]:
    """Write the port's ESM-1 ``ESM1`` as arch "protein_bert_base"."""
    path = os.fspath(path)
    if os.path.basename(path).startswith("esm2"):
        raise ValueError(f"file name {os.path.basename(path)!r} must not start with 'esm2' "
                         "(that routes a file to the ESM-2 loader)")
    cfg = model.cfg
    if cfg.is_1b:
        raise ValueError("save_esm1 is for model_version='ESM-1'; ESM-1b saves with save_esm1b")
    args = dict(arch="protein_bert_base", **_sizes(cfg, "decoder_"), final_bias=cfg.final_bias)
    return _v1_save(model, path, "decoder", args)


def _swap_row_column(key: str) -> str:
    """The released msa_transformer files name the row and column attentions
    the other way round; the v1 loader swaps them back (reference
    esm/pretrained.py:121-125). The swap is its own inverse."""
    if "row" in key:
        return key.replace("row", "column")
    return key.replace("column", "row")


def save_msa(model, path) -> Tuple[str, str]:
    """Write the port's ``MSATransformer`` as arch "msa_transformer"."""
    path = os.fspath(path)
    if os.path.basename(path).startswith("esm2"):
        raise ValueError(f"file name {os.path.basename(path)!r} must not start with 'esm2' "
                         "(that routes a file to the ESM-2 loader)")
    cfg = model.cfg
    args = dict(arch="msa_transformer", **_sizes(cfg, "encoder_"), dropout=0.1,
                attention_dropout=0.1, activation_dropout=0.1,
                max_tokens_per_msa=cfg.max_tokens_per_msa, max_tokens=cfg.max_tokens_per_msa,
                embed_positions_msa=cfg.embed_positions_msa)
    return _v1_save(model, path, "encoder", args, rename=_swap_row_column)


def save_if1(model, path) -> Tuple[str, None]:
    """Write the port's ``GVPTransformerModel`` as the reference's v1
    invariant_gvp checkpoint (reference loader esm/pretrained.py:134-161).
    The file name must contain ``esm_if``: that is how the loaders know to
    look for no contact-regression file (esm/pretrained.py:18-21). Returns
    (path, None), the regression path of the other savers being absent."""
    path = os.fspath(path)
    stem = os.path.basename(path)
    if "esm_if" not in stem:
        raise ValueError(
            f"file name {stem!r} must contain 'esm_if' — that marker is how the "
            "reference loader knows to skip the contact-regression file "
            "(esm/pretrained.py:18-21)")
    cfg = model.cfg
    args = argparse.Namespace(
        arch="vt_invariant_gvp_transformer",
        **{k: getattr(cfg, k) for k in (
            "encoder_embed_dim", "encoder_layers", "encoder_attention_heads",
            "encoder_ffn_embed_dim", "decoder_embed_dim", "decoder_layers",
            "decoder_attention_heads", "decoder_ffn_embed_dim")},
        dropout=0.1,
        attention_dropout=0.1,
        **{k: getattr(cfg, k) for k in (
            "gvp_top_k_neighbors", "gvp_node_hidden_dim_scalar", "gvp_node_hidden_dim_vector",
            "gvp_edge_hidden_dim_scalar", "gvp_edge_hidden_dim_vector",
            "gvp_num_encoder_layers")},
        gvp_dropout=0.1,
    )
    state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    torch.save({"args": args, "model": state}, path)
    return path, None
