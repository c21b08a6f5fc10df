"""ESMFold: its weights in the reference layout, the program built from a
configuration file, and the plain reference beside it.

The LM's weights are drawn as ``families/esm2.py`` draws ESM-2's (under
``esm.``). The trunk and heads follow the port's ``init_esmfold`` scales
(torch's default U(±1/sqrt(fan_in)) linears, unit LayerNorms, 0.02·N(0, 1)
embeddings, the gated attention's g_proj bias at one), except that every
tensor that init sets to zero (the residual branches' last layers, g_proj's
weight, the IPA head weights, ``esm_s_combine``, the LayerNorm biases) is
drawn as the port's on-card smoke test draws it: weights N(0, 1/(4 fan_in)),
the rest 0.1·N(0, 1). With zeros there the triangle ops, the sequence
attention and the MLPs would add exactly nothing, and the comparison would
not see them.
"""

from __future__ import annotations

import torch

from .. import weights as W
from ..reference import esmfold as reference  # noqa: F401  (the configuration's reference)
from . import esm2 as esm2_family

# the residual branches' last layers, zero at init (port models/esmfold/init.py)
ZERO_LAST = {"sequence_to_pair.o_proj", "pair_to_sequence.linear", "seq_attention.o_proj",
             "mlp_seq.mlp.3", "mlp_pair.mlp.3", "tri_mul_out.linear_z", "tri_mul_in.linear_z",
             "tri_att_start.mha.linear_o", "tri_att_end.mha.linear_o"}


def _lin(name, i, o, zero=False, bias=True):
    w = ("normal", 0.5 * i ** -0.5) if zero else ("uniform", i ** -0.5)
    b = ("normal", 0.1) if zero else ("uniform", i ** -0.5)
    return W.linear(name, i, o, w, b if bias else None)


def _ln(name, dim):
    return W.layer_norm(name, dim, bias=("normal", 0.1))


def layout(cfg: dict) -> list:
    lm, tc, sm = cfg["esm"], cfg["trunk"], cfg["structure_module"]
    d, c_s, c_z = lm["embed_dim"], tc["sequence_state_dim"], tc["pairwise_state_dim"]
    seq_heads = c_s // tc["sequence_head_width"]
    pair_heads = c_z // tc["pairwise_head_width"]
    n_tok, lddt_hid, sm_c = 23, cfg["lddt_head_hid_dim"], sm["c_s"]
    out = esm2_family.layout(lm, prefix="esm.")
    out.append(("esm_s_combine", (lm["num_layers"] + 1,), "normal", 0.1))
    out += _ln("esm_s_mlp.0", d) + _lin("esm_s_mlp.1", d, c_s) + _lin("esm_s_mlp.3", c_s, c_s)
    out.append(("embedding.weight", (n_tok, c_s), "normal", 0.02))
    out.append(("trunk.pairwise_positional_embedding.embedding.weight",
                (2 * tc["position_bins"] + 2, c_z), "normal", 0.02))
    for i in range(tc["num_blocks"]):
        p = f"trunk.blocks.{i}"

        def lin(name, fi, fo, bias=True):
            return _lin(f"{p}.{name}", fi, fo, zero=name in ZERO_LAST, bias=bias)

        out += _ln(f"{p}.layernorm_1", c_s)
        out += _ln(f"{p}.sequence_to_pair.layernorm", c_s)
        out += lin("sequence_to_pair.proj", c_s, c_z) + lin("sequence_to_pair.o_proj", c_z, c_z)
        out += _ln(f"{p}.pair_to_sequence.layernorm", c_z)
        out += lin("pair_to_sequence.linear", c_z, seq_heads, bias=False)
        out += lin("seq_attention.proj", c_s, 3 * c_s, bias=False)
        out += lin("seq_attention.o_proj", c_s, c_s)
        out += W.linear(f"{p}.seq_attention.g_proj", c_s, c_s, ("normal", 0.5 * c_s ** -0.5),
                        ("const", 1.0))
        for t in ("tri_mul_out", "tri_mul_in"):
            out += _ln(f"{p}.{t}.layer_norm_in", c_z) + _ln(f"{p}.{t}.layer_norm_out", c_z)
            for n in ("linear_a_p", "linear_a_g", "linear_b_p", "linear_b_g", "linear_g",
                      "linear_z"):
                out += lin(f"{t}.{n}", c_z, c_z)
        for t in ("tri_att_start", "tri_att_end"):
            out += _ln(f"{p}.{t}.layer_norm", c_z) + lin(f"{t}.linear", c_z, pair_heads,
                                                          bias=False)
            for n in ("linear_q", "linear_k", "linear_v"):
                out += lin(f"{t}.mha.{n}", c_z, c_z, bias=False)
            out += lin(f"{t}.mha.linear_o", c_z, c_z) + lin(f"{t}.mha.linear_g", c_z, c_z)
        for t, c in (("mlp_seq", c_s), ("mlp_pair", c_z)):
            out += _ln(f"{p}.{t}.mlp.0", c) + lin(f"{t}.mlp.1", c, 4 * c) + lin(
                f"{t}.mlp.3", 4 * c, c)
    out += _ln("trunk.recycle_s_norm", c_s) + _ln("trunk.recycle_z_norm", c_z)
    out.append(("trunk.recycle_disto.weight", (15, c_z), "normal", 0.02))
    s = "trunk.structure_module"
    h, ci, pq, pv = sm["no_heads_ipa"], sm["c_ipa"], sm["no_qk_points"], sm["no_v_points"]
    out += _ln(f"{s}.layer_norm_s", sm_c) + _ln(f"{s}.layer_norm_z", sm["c_z"])
    out += _lin(f"{s}.linear_in", sm_c, sm_c)
    out += _lin(f"{s}.ipa.linear_q", sm_c, h * ci) + _lin(f"{s}.ipa.linear_kv", sm_c, 2 * h * ci)
    out += _lin(f"{s}.ipa.linear_q_points", sm_c, h * pq * 3)
    out += _lin(f"{s}.ipa.linear_kv_points", sm_c, h * (pq + pv) * 3)
    out += _lin(f"{s}.ipa.linear_b", sm["c_z"], h)
    out.append((f"{s}.ipa.head_weights", (h,), "normal", 0.1))
    out += _lin(f"{s}.ipa.linear_out", h * (sm["c_z"] + ci + pv * 4), sm_c, zero=True)
    out += _ln(f"{s}.layer_norm_ipa", sm_c)
    for i in range(sm["no_transition_layers"]):
        out += _lin(f"{s}.transition.layers.{i}.linear_1", sm_c, sm_c)
        out += _lin(f"{s}.transition.layers.{i}.linear_2", sm_c, sm_c)
        out += _lin(f"{s}.transition.layers.{i}.linear_3", sm_c, sm_c, zero=True)
    out += _ln(f"{s}.transition.layer_norm", sm_c)
    out += _lin(f"{s}.bb_update.linear", sm_c, 6, zero=True)
    r = sm["c_resnet"]
    out += _lin(f"{s}.angle_resnet.linear_in", sm_c, r)
    out += _lin(f"{s}.angle_resnet.linear_initial", sm_c, r)
    for i in range(sm["no_resnet_blocks"]):
        out += _lin(f"{s}.angle_resnet.layers.{i}.linear_1", r, r)
        out += _lin(f"{s}.angle_resnet.layers.{i}.linear_2", r, r)
    out += _lin(f"{s}.angle_resnet.linear_out", r, sm["no_angles"] * 2)
    out += _lin("trunk.trunk2sm_s", c_s, sm_c) + _lin("trunk.trunk2sm_z", c_z, sm["c_z"])
    out += _lin("distogram_head", c_z, cfg["distogram_bins"])
    out += _lin("ptm_head", c_z, cfg["distogram_bins"])
    out += _lin("lm_head", c_s, n_tok)
    out += _ln("lddt_head.0", sm_c) + _lin("lddt_head.1", sm_c, lddt_hid)
    out += _lin("lddt_head.2", lddt_hid, lddt_hid)
    out += _lin("lddt_head.3", lddt_hid, 37 * cfg["lddt_bins"])
    return out


def weights(cfg: dict, seed: int, device) -> dict:
    """The configuration's weights from ``seed``, in the reference layout."""
    with torch.no_grad():
        return esm2_family.zero_padding_row(W.draw(layout(cfg), seed, device), cfg["esm"],
                                            prefix="esm.")


def program(cfg: dict, state: dict, device):
    """The port's ``ESMFoldHandle`` on ``state``: the LM through the port's
    checkpoint loader, the rest by ``load_state_dict``, as ``load_esmfold``
    loads a released checkpoint; the execution options from ``cfg``."""
    from esm_tpu_torch.data.alphabet import Alphabet
    from esm_tpu_torch.io.convert import load_lm_state
    from esm_tpu_torch.models import esm2
    from esm_tpu_torch.models.esmfold.esmfold import ESMFold, ESMFoldConfig
    from esm_tpu_torch.models.esmfold.structure_module import StructureModuleConfig
    from esm_tpu_torch.models.esmfold.trunk import FoldingTrunkConfig
    from esm_tpu_torch.pretrained import ESMFoldHandle

    tc, sm = cfg["trunk"], cfg["structure_module"]
    lm_cfg = esm2_family.program_config(cfg["esm"])
    fcfg = ESMFoldConfig(
        esm=lm_cfg,
        trunk=FoldingTrunkConfig(
            num_blocks=tc["num_blocks"], sequence_state_dim=tc["sequence_state_dim"],
            pairwise_state_dim=tc["pairwise_state_dim"],
            sequence_head_width=tc["sequence_head_width"],
            pairwise_head_width=tc["pairwise_head_width"], position_bins=tc["position_bins"],
            max_recycles=tc["max_recycles"],
            compute_dtype=esm2_family.DTYPES[tc["compute_dtype"]],
            use_flash_tri=tc["use_flash_tri"],
            structure_module=StructureModuleConfig(**{
                k: sm[k] for k in ("c_s", "c_z", "c_ipa", "c_resnet", "no_heads_ipa",
                                   "no_qk_points", "no_v_points", "no_blocks",
                                   "no_transition_layers", "no_resnet_blocks", "no_angles",
                                   "trans_scale_factor")})),
        lddt_head_hid_dim=cfg["lddt_head_hid_dim"], distogram_bins=cfg["distogram_bins"],
        lddt_bins=cfg["lddt_bins"], esm_type=cfg.get("esm_type"))
    lm = esm2.ESM2(lm_cfg, device=device)
    load_lm_state(lm, {k[4:]: v for k, v in state.items() if k.startswith("esm.")})
    model = ESMFold(fcfg, esm=lm, device=device)
    rest = {k: v for k, v in state.items() if not k.startswith("esm.")}
    missing, unexpected = model.load_state_dict(rest, strict=False)
    missing = [k for k in missing if not k.startswith("esm.")]
    if missing or unexpected:
        raise RuntimeError(f"ESMFold weights: missing {missing}, unexpected {unexpected}")
    return ESMFoldHandle(fcfg, model, Alphabet.from_architecture("ESM-1b"))
