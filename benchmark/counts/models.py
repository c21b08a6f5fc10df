"""Matrix-product operations of the models (2 per multiply-add), counted
from the configuration and the inputs. Elementwise work, normalisations and
softmaxes are not counted: they are memory-bound and the share of the bf16
peak is a share of the tensor cores' work."""

from __future__ import annotations

from typing import Iterable


def esm2_layers(cfg: dict, n: int) -> float:
    """ESM-2's transformer layers over one sequence of ``n`` tokens: the
    q, k, v, out projections (4·d²), the FFN (2·d·4d), and q·kᵀ and p·v over
    the n keys."""
    d, layers = cfg["embed_dim"], cfg["num_layers"]
    return layers * (2 * n * (4 * d * d + 8 * d * d) + 4 * n * n * d)


def esm2_head(cfg: dict, n: int) -> float:
    """The LM head over ``n`` tokens: the dense layer and the tied projection."""
    d, v = cfg["embed_dim"], cfg["alphabet_size"]
    return 2 * n * (d * d + d * v)


def esm2_embed(cfg: dict, lengths: Iterable[int]) -> float:
    """An embedding job's work: the layers over each sequence's real residues
    (the padding, BOS, EOS and the logits the user does not take are not
    useful work)."""
    return sum(esm2_layers(cfg, n) for n in lengths)


def esm2_train_step(cfg: dict, batch: int, length: int) -> float:
    """A training step: forward and backward (three times the forward's
    products) of the layers and the LM head over every token; the remat
    recompute is not counted."""
    return 3 * batch * (esm2_layers(cfg, length) + esm2_head(cfg, length))


def esmfold_fold(cfg: dict, length: int) -> float:
    """One fold of one chain: the LM over L + 2 tokens, then each pass's
    trunk blocks, the structure module and the heads."""
    lm, tc, sm = cfg["esm"], cfg["trunk"], cfg["structure_module"]
    L = length
    c_s, c_z = tc["sequence_state_dim"], tc["pairwise_state_dim"]
    seq_heads = c_s // tc["sequence_head_width"]
    pair_heads = c_z // tc["pairwise_head_width"]
    P = L * L
    lin_z = 2 * P * c_z * c_z  # one c_z -> c_z linear over the pair tensor
    block = (
        2 * P * c_z * seq_heads                     # pair -> sequence bias
        + 2 * L * c_s * 3 * c_s + 4 * P * c_s       # gated attention: proj, q·kᵀ, p·v
        + 2 * (2 * L * c_s * c_s)                   # its gate and output
        + 2 * (2 * L * c_s * 4 * c_s)               # sequence MLP
        + 2 * L * c_s * c_z + lin_z                 # sequence -> pair
        + 2 * (6 * lin_z + 2 * L * P * c_z)         # two triangle multiplications
        + 2 * (2 * P * c_z * pair_heads + 5 * lin_z + 4 * L * P * c_z)  # two triangle attentions
        + 2 * (2 * P * c_z * 4 * c_z)               # pair MLP
    )
    h, ci, pq, pv, c = (sm["no_heads_ipa"], sm["c_ipa"], sm["no_qk_points"], sm["no_v_points"],
                        sm["c_s"])
    ipa = (2 * L * c * (h * ci * 3 + h * (2 * pq + pv) * 3)      # projections
           + 2 * P * sm["c_z"] * h                                # pair bias
           + 2 * P * h * ci * 2 + 2 * P * h * (pq + pv) * 3       # q·kᵀ, p·v, the points
           + 2 * P * h * sm["c_z"]                                # the pair output
           + 2 * L * h * (sm["c_z"] + ci + pv * 4) * c)           # the output projection
    sm_block = ipa + 3 * 2 * L * c * c + 2 * L * c * 6 + 2 * L * (
        2 * c * sm["c_resnet"] + 4 * sm["c_resnet"] ** 2 + sm["c_resnet"] * 14)
    per_pass = (tc["num_blocks"] * block
                + 2 * L * c_s * c + 2 * P * c_z * sm["c_z"] + 2 * L * c * c  # into the module
                + sm["no_blocks"] * sm_block)
    heads = (2 * 2 * P * c_z * cfg["distogram_bins"]                        # distogram, pTM
             + 2 * L * c * cfg["lddt_head_hid_dim"] * 2
             + 2 * L * cfg["lddt_head_hid_dim"] * 37 * cfg["lddt_bins"])
    lm_in = 2 * L * lm["embed_dim"] * c_s + 2 * L * c_s * c_s            # esm_s MLP
    return (esm2_layers(lm, L + 2) + lm_in + tc["max_recycles"] * per_pass + heads)
