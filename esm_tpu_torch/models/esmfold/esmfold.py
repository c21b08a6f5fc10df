"""ESMFold: the frozen ESM-2 language model, the folding trunk and the heads.

Port of esm_tpu/models/esmfold/esmfold.py (reference semantics:
esm/esmfold/v1/esmfold.py): the LM over AF2-indexed tokens (bos/eos added,
then stripped), a softmax-weighted combination of its layers, the s (and,
for v0, z) MLPs, the folding trunk, and the distogram / LM / pLDDT / pTM /
PAE heads; multimer inference through the ':' linker encoding;
:func:`apply_sharded`, one fold over a mesh with the pair tensors
row-sharded and the LM sequence-parallel.

``ESMFold`` holds the parameters under the reference checkpoint's names
(the key layout of esm_tpu/io/export.py:572-676, plus the LM under
``esm.*``), so a released state dict with the LM's keys loads strictly. The
execution options (LM and trunk dtypes, flash attention, K6, chunking) live
in ``ESMFoldConfig`` and are passed to :func:`apply`, so one set of weights
serves several configurations (``ESMFoldHandle.with_options``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ...data import residue_constants as rc
from ...data.alphabet import Alphabet
from ...ops.common import layer_norm, linear, new_embedding, new_layer_norm, new_linear
from .. import esm2
from ..lm_common import embedding_lookup
from .blocks import mlp_apply, mlp_layers
from .protein import (
    categorical_lddt,
    compute_predicted_aligned_error,
    compute_tm,
    make_atom14_masks,
    output_to_pdb,
)
from .trunk import FoldingTrunk, FoldingTrunkConfig, folding_trunk_apply


@dataclass(frozen=True)
class ESMFoldConfig:
    esm: esm2.ESM2Config = field(default_factory=esm2.ESM2Config)
    trunk: FoldingTrunkConfig = field(default_factory=FoldingTrunkConfig)
    lddt_head_hid_dim: int = 128
    use_esm_attn_map: bool = False
    distogram_bins: int = 64
    lddt_bins: int = 50
    # the checkpoint's LM registry name (reference esm/esmfold/v1/esmfold.py:
    # 35-47,59), kept so io/export.save_esmfold writes it back
    esm_type: Optional[str] = None

    @property
    def n_tokens_embed(self) -> int:
        return rc.restype_num + 3  # 0 = pad, 21 = unk (X), 22 = mask


def af2_to_esm_table(alphabet: Alphabet) -> np.ndarray:
    """AF2 residue index (shifted by 1; 0 = padding) -> ESM token id
    (reference esm/esmfold/v1/esmfold.py:106-112)."""
    return np.asarray([alphabet.padding_idx] + [alphabet.get_idx(v) for v in rc.restypes_with_x()],
                      dtype=np.int64)


class ESMFold(nn.Module):
    """ESMFold's parameters under the reference's names: ``esm`` (the ESM-2
    LM), ``esm_s_combine``, ``esm_s_mlp`` (and ``esm_z_mlp`` for v0),
    ``embedding``, ``trunk``, ``distogram_head``, ``ptm_head``, ``lm_head``,
    ``lddt_head``. Built without init: :func:`init.init_esmfold` draws seeded
    weights, or a state dict is loaded."""

    def __init__(self, cfg: ESMFoldConfig, esm: Optional[esm2.ESM2] = None, device=None):
        super().__init__()
        self.cfg = cfg
        tc = cfg.trunk
        c_s, c_z, d = tc.sequence_state_dim, tc.pairwise_state_dim, cfg.esm.embed_dim
        self.esm = esm if esm is not None else esm2.ESM2(cfg.esm, device=device)
        self.esm_s_combine = nn.Parameter(torch.zeros(cfg.esm.num_layers + 1, device=device))
        self.esm_s_mlp = mlp_layers(d, c_s, c_s, device=device)
        if cfg.use_esm_attn_map:
            self.esm_z_mlp = mlp_layers(cfg.esm.num_layers * cfg.esm.attention_heads, c_z, c_z,
                                        device=device)
        self.embedding = new_embedding(cfg.n_tokens_embed, c_s, device=device)
        self.trunk = FoldingTrunk(tc, device=device)
        self.distogram_head = new_linear(c_z, cfg.distogram_bins, device=device)
        self.ptm_head = new_linear(c_z, cfg.distogram_bins, device=device)
        self.lm_head = new_linear(c_s, cfg.n_tokens_embed, device=device)
        c_sm = tc.structure_module.c_s
        self.lddt_head = nn.Sequential(
            new_layer_norm(c_sm, device=device),
            new_linear(c_sm, cfg.lddt_head_hid_dim, device=device),
            new_linear(cfg.lddt_head_hid_dim, cfg.lddt_head_hid_dim, device=device),
            new_linear(cfg.lddt_head_hid_dim, 37 * cfg.lddt_bins, device=device),
        )
        self.register_buffer(
            "af2_to_esm",
            torch.from_numpy(af2_to_esm_table(Alphabet.from_architecture("ESM-1b"))).to(device or "cpu"),
            persistent=False,
        )

    @property
    def device(self) -> torch.device:
        return self.embedding.weight.device


def _lm_representations(model: esm2.ESM2, esm_cfg: esm2.ESM2Config, esmaa: torch.Tensor,
                        combine: torch.Tensor, need_attn_map: bool = False, ring=None):
    """Run the frozen LM with bos/eos handling (reference
    esm/esmfold/v1/esmfold.py:118-145) and combine its layers with the
    weights ``combine`` (layers+1,) (esmfold.py:200). Returns ((B, L, C)
    fp32, the (B, L, L, layers*H) attention stack or None).

    ``ring=(mesh, axis_name)`` runs the LM sequence-parallel (ring attention
    over the axis, ``esm2.apply`` on this rank's block of T): T = L+2 is
    padded with <pad> columns to a multiple of the ring size, as esm_tpu
    pads it (esm_tpu/models/esmfold/esmfold.py:117-123); padded keys are
    masked everywhere. Each rank combines its block's layers, and the
    (B, T, C) result is gathered once."""
    b, l = esmaa.shape
    bos = esmaa.new_full((b, 1), esm_cfg.cls_idx)
    pad = esmaa.new_full((b, 1), esm_cfg.padding_idx)
    esmaa = torch.cat([bos, esmaa, pad], dim=1)
    # the first padding slot becomes eos
    eos_pos = (esmaa != esm_cfg.padding_idx).sum(1)
    positions = torch.arange(esmaa.shape[1], device=esmaa.device)[None, :]
    esmaa = torch.where(positions == eos_pos[:, None], esm_cfg.eos_idx, esmaa)

    # the LM is frozen: no gradient reaches it (esm_tpu stops it at esm_s
    # and esm_z), so its activations are not kept
    with torch.no_grad():
        if ring is None:
            res = esm2.apply(model, esm_cfg, esmaa, return_representations=True,
                             need_head_weights=need_attn_map)
        else:
            from ...parallel.pair_sharding import gather_rows, pair_shard

            mesh, axis_name = ring
            n = mesh.size(mesh.mesh_dim_names.index(axis_name))
            esmaa = torch.cat([esmaa, esmaa.new_full((b, (-esmaa.shape[1]) % n),
                                                     esm_cfg.padding_idx)], dim=1)
            blocks = pair_shard(mesh, axis_name, esmaa.shape[1])
            res = esm2.apply(model, esm_cfg, blocks.local(esmaa), return_representations=True,
                             ring=ring)
    # (L+1, B, T, C) -> (B, T, layers+1, C), combined over the layers in fp32
    # (the combination weights' gradient is kept)
    esm_s = torch.einsum("k,btkc->btc", combine, res["representations"].permute(1, 2, 0, 3).float())
    if ring is not None:
        esm_s = gather_rows(esm_s, blocks)
    esm_z = None
    if need_attn_map:
        # (B, layers, H, T, T) -> (B, Tk, Tq, layers*H), bos/eos stripped
        # (reference esmfold.py:140-144)
        att = res["attentions"]
        bb, nl, nh, t, _ = att.shape
        esm_z = att.permute(0, 4, 3, 1, 2).reshape(bb, t, t, nl * nh)[:, 1:-1, 1:-1, :]
    return esm_s[:, 1:l + 1], esm_z


def apply(
    model: ESMFold,
    cfg: ESMFoldConfig,
    aa: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    residx: Optional[torch.Tensor] = None,
    masking_pattern: Optional[torch.Tensor] = None,
    num_recycles: Optional[int] = None,
    frugal: bool = False,
) -> Dict[str, torch.Tensor]:
    """Forward pass on AF2-indexed tokens aa (B, L) (reference
    esmfold.py:152-278). ``frugal=True`` drops the O(L²) diagnostic outputs
    (s_z, distogram/pTM logits, aligned-confidence probabilities, the
    per-block lddt head and states); coordinates, pLDDT, pTM and PAE are
    unchanged. A config with ``trunk.pair_spec`` folds through
    :func:`apply_sharded` on a mesh."""
    if cfg.trunk.pair_spec is not None:
        raise ValueError(f"trunk.pair_spec={cfg.trunk.pair_spec!r} shards the pair tensor over "
                         "a mesh: fold with apply_sharded(..., mesh=...)")
    return _apply(model, cfg, aa, mask, residx, masking_pattern, num_recycles, frugal)


# the outputs indexed (B, L, L, ...): a rank's rows under apply_sharded
PAIR_OUTPUTS = ("s_z", "distogram_logits", "ptm_logits", "aligned_confidence_probs",
                "predicted_aligned_error")


def _apply(model, cfg, aa, mask, residx, masking_pattern, num_recycles, frugal,
           pair=None, ring=None):
    """:func:`apply`'s body; with ``pair`` every pair tensor is this rank's
    rows, and ``ring`` runs the LM sequence-parallel."""
    if mask is None:
        mask = torch.ones_like(aa)
    b, l = aa.shape
    if residx is None:
        residx = torch.arange(l, device=aa.device).expand(b, l)

    esmaa = model.af2_to_esm[torch.where(mask == 1, aa + 1, torch.zeros_like(aa))]
    if masking_pattern is not None:
        esmaa = torch.where(masking_pattern == 1, cfg.esm.mask_idx, esmaa)
    # the LM's layers, combined with softmax weights (esmfold.py:200)
    esm_s, esm_z = _lm_representations(model.esm, cfg.esm, esmaa,
                                       torch.softmax(model.esm_s_combine, dim=0),
                                       need_attn_map=cfg.use_esm_attn_map, ring=ring)
    s_s_0 = mlp_apply(model.esm_s_mlp, esm_s)
    if cfg.use_esm_attn_map:
        # pair features from the LM's attention maps (esmfold.py:78-84,203-208)
        if pair is not None:
            esm_z = pair.local(esm_z)
        s_z_0 = mlp_apply(model.esm_z_mlp, esm_z.float())
    else:
        rows = l if pair is None else pair.rows
        s_z_0 = s_s_0.new_zeros((b, rows, l, cfg.trunk.pairwise_state_dim))
    s_s_0 = s_s_0 + embedding_lookup(model.embedding.weight, aa)

    structure = folding_trunk_apply(model.trunk, cfg.trunk, s_s_0, s_z_0, aa, residx, mask,
                                    no_recycles=num_recycles, pair=pair)

    disto = linear(model.distogram_head, structure["s_z"])
    if pair is None:
        disto_t = disto.transpose(1, 2)
    else:
        from ...parallel.pair_sharding import transpose_rows

        disto_t = transpose_rows(disto, pair)
    structure["distogram_logits"] = (disto + disto_t) / 2
    structure["lm_logits"] = linear(model.lm_head, structure["s_s"])
    structure["aatype"] = aa
    structure.update(make_atom14_masks(aa))
    for k in ("atom14_atom_exists", "atom37_atom_exists"):
        structure[k] = structure[k] * mask[..., None]
    structure["residue_index"] = residx

    states = structure["states"]  # (K, B, L, c_s)
    lh = layer_norm(model.lddt_head[0], states)
    for fc in model.lddt_head[1:]:
        lh = linear(fc, lh)
    lddt_head = lh.reshape(states.shape[0], b, l, -1, cfg.lddt_bins)
    structure["lddt_head"] = lddt_head
    structure["plddt"] = 100 * categorical_lddt(lddt_head[-1], bins=cfg.lddt_bins)

    ptm_logits = linear(model.ptm_head, structure["s_z"])
    structure["ptm_logits"] = ptm_logits
    structure["ptm"] = compute_tm(ptm_logits, residue_weights=mask.to(ptm_logits.dtype),
                                  max_bin=31, no_bins=cfg.distogram_bins, pair=pair)
    structure.update(compute_predicted_aligned_error(ptm_logits, max_bin=31,
                                                     no_bins=cfg.distogram_bins))
    if frugal:
        for k in ("s_z", "distogram_logits", "ptm_logits", "lddt_head",
                  "aligned_confidence_probs", "states"):
            structure.pop(k, None)
    return structure


@torch.no_grad()
def apply_sharded(
    model: ESMFold,
    cfg: ESMFoldConfig,
    aa: torch.Tensor,
    *,
    mesh,
    seq_axis: str = "tp",
    mask: Optional[torch.Tensor] = None,
    residx: Optional[torch.Tensor] = None,
    masking_pattern: Optional[torch.Tensor] = None,
    num_recycles: Optional[int] = None,
    frugal: bool = False,
) -> Dict[str, torch.Tensor]:
    """The multi-device fold (esm_tpu/models/esmfold/esmfold.py:268-306):
    every rank of ``mesh`` passes the same (B, L) inputs. The LM runs
    sequence-parallel (ring attention over ``seq_axis``; replicated for v0,
    ``use_esm_attn_map``, whose T x T maps the ring cannot give), and the
    trunk's and heads' (B, L, L, ·) pair tensors are row-sharded over
    ``seq_axis`` (FastFold's Dynamic Axial Parallelism): rank r of that
    dimension holds rows [r·L/N, (r+1)·L/N) with every column, and the
    collectives of ``parallel.pair_sharding`` run inside each trunk op. The
    batch is replicated over the mesh's other dimensions. A forward only
    (under ``torch.no_grad()``).

    The residues are padded to Lp = ⌈L/N⌉·N with mask 0, which keeps them
    out of every real residue's numbers, and the padding is stripped from
    every output. The pair outputs (``PAIR_OUTPUTS``: s_z, the distogram
    and pTM logits, the aligned-confidence probabilities and the PAE) are
    this rank's real rows, rows [r·Lp/N, min((r+1)·Lp/N, L)) of the whole
    (:func:`gather_pair_outputs` gathers them); every other output is whole.
    On a group of one rank every collective is the identity, and the fold
    equals :func:`apply`'s (the LM through K4 rather than K1: the same
    kernel and numbers).

    ``cfg.trunk.pair_spec`` must name ``seq_axis``, e.g. ("tp",);
    ``chunk_size`` chunks triangle attention's rows within the shard. Budget
    memory with ``parallel.memory_plan.plan_fold(cfg, L, mesh_cfg)`` and
    time with ``parallel.scaling.plan_scaling_fold``: pair sharding is a
    long-L tool, since at short L the per-block collectives outweigh the
    triangle compute (``scaling.fold_crossover_length``)."""
    spec = cfg.trunk.pair_spec
    if spec is None:
        raise ValueError(
            "apply_sharded needs cfg.trunk.pair_spec set (e.g. "
            f"({seq_axis!r},)) so the trunk/pair heads shard; without it only the LM "
            "would be sequence-parallel")
    if seq_axis not in spec:
        raise ValueError(f"trunk.pair_spec {spec!r} must shard the pair rows over "
                         f"seq_axis={seq_axis!r}")
    from ...parallel.pair_sharding import pair_shard

    b, l = aa.shape
    n = mesh.size(mesh.mesh_dim_names.index(seq_axis))
    lp = -(-l // n) * n
    if mask is None:
        mask = torch.ones_like(aa)
    if residx is None:
        residx = torch.arange(l, device=aa.device).expand(b, l)

    def pad(x):
        return torch.nn.functional.pad(x, (0, lp - l)) if lp != l else x

    if lp != l:
        # padded residues carry mask 0; their residue index repeats the last
        # (any value does: they are masked everywhere)
        residx = torch.cat([residx, residx[:, -1:].expand(b, lp - l)], dim=1)
    pair = pair_shard(mesh, seq_axis, lp)
    ring = None if cfg.use_esm_attn_map else (mesh, seq_axis)
    out = _apply(model, cfg, pad(aa), pad(mask), residx,
                 None if masking_pattern is None else pad(masking_pattern),
                 num_recycles, frugal, pair=pair, ring=ring)
    if lp == l:
        return out
    real = max(0, min(pair.rows, l - pair.rank * pair.rows))  # this rank's real rows
    for k, v in out.items():
        if k in PAIR_OUTPUTS:
            out[k] = v[:, :real, :l]
        elif k in ("positions", "frames", "sidechain_frames", "unnormalized_angles", "angles",
                   "states", "lddt_head"):
            out[k] = v[:, :, :l]  # (K, B, L, ...)
        elif v.dim() >= 2 and v.shape[1] == lp:
            out[k] = v[:, :l]
    return out


def gather_pair_outputs(output: Dict[str, torch.Tensor], mesh, seq_axis: str = "tp"):
    """The whole (B, L, L, ...) pair outputs of an :func:`apply_sharded`
    result, gathered from every rank of ``seq_axis`` (every rank must call
    it). Returns a new dict; the other entries are shared."""
    from ...parallel.pair_sharding import gather_rows, pair_shard

    l = output["aatype"].shape[1]
    n = mesh.size(mesh.mesh_dim_names.index(seq_axis))
    shard = pair_shard(mesh, seq_axis, -(-l // n) * n)
    out = dict(output)
    for k in PAIR_OUTPUTS:
        if k in out:
            v = out[k]
            v = torch.nn.functional.pad(v, (0, 0) * (v.dim() - 2) + (0, shard.rows - v.shape[1]))
            out[k] = gather_rows(v, shard)[:, :l]
    return out


# ---------------------------------------------------------------------------
# Host-side sequence encoding and the inference entry points
# ---------------------------------------------------------------------------


def encode_sequence(
    seq: str,
    residue_index_offset: Optional[int] = 512,
    chain_linker: Optional[str] = "G" * 25,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Multimer-aware AF2 encoding (reference esm/esmfold/v1/misc.py:18-58):
    chains split on ':' are joined by ``chain_linker``, each chain's residue
    index is offset by ``residue_index_offset``, and the linker is masked."""
    chain_linker = chain_linker or ""
    residue_index_offset = residue_index_offset or 0
    chains = seq.split(":")
    seq = chain_linker.join(chains)
    order = rc.restype_order_with_x()
    encoded = np.asarray([order.get(a, order["X"]) for a in seq], np.int64)
    residx = np.arange(len(encoded), dtype=np.int64)
    if residue_index_offset > 0:
        start = 0
        for i, chain in enumerate(chains):
            residx[start:start + len(chain) + len(chain_linker)] += i * residue_index_offset
            start += len(chain) + len(chain_linker)

    linker_mask = np.ones_like(encoded, dtype=np.float32)
    chain_index: List[int] = []
    offset = 0
    for i, chain in enumerate(chains):
        if i > 0:
            chain_index.extend([i - 1] * len(chain_linker))
        chain_index.extend([i] * len(chain))
        offset += len(chain)
        linker_mask[offset:offset + len(chain_linker)] = 0
        offset += len(chain_linker)
    return encoded, residx, linker_mask, np.asarray(chain_index, np.int64)


def batch_encode_sequences(
    sequences: Sequence[str],
    residue_index_offset: Optional[int] = 512,
    chain_linker: Optional[str] = "G" * 25,
):
    """Encode and pad to the longest (reference esm/esmfold/v1/misc.py:61-90).
    Returns aatype, mask, residx, linker_mask, chain_index (B, L) numpy."""
    parts = [encode_sequence(s, residue_index_offset, chain_linker) for s in sequences]
    max_len = max(p[0].shape[0] for p in parts)

    def collate(arrs, pad=0):
        out = np.full((len(arrs), max_len), pad, arrs[0].dtype)
        for i, a in enumerate(arrs):
            out[i, :a.shape[0]] = a
        return out

    return (collate([p[0] for p in parts]), collate([np.ones_like(p[0]) for p in parts]),
            collate([p[1] for p in parts]), collate([p[2] for p in parts]),
            collate([p[3] for p in parts], pad=-1))


# The padded-length granularity of bucketed folds (``pad_to_multiple``), as
# in esm_tpu, where it is the serving and CLI bucket.
FOLD_LENGTH_BUCKET = 64

# infer()'s frugal=None default: drop the O(L²) diagnostics when they would
# hold more than 1.5 GB (1284 bytes per (i, j) pair). This is esm_tpu's
# output contract (esm_tpu/models/esmfold/esmfold.py:395-398), not a memory
# figure of this card: which keys infer returns must not depend on the card,
# so both packages return the same keys for the same batch and length.
_AUTO_FRUGAL_HELD_BYTES = 1_500_000_000
_NON_FRUGAL_BYTES_PER_PAIR = 1284


def auto_frugal(batch: int, L: int) -> bool:
    return batch * L * L * _NON_FRUGAL_BYTES_PER_PAIR > _AUTO_FRUGAL_HELD_BYTES


@torch.no_grad()
def infer(
    model: ESMFold,
    cfg: ESMFoldConfig,
    sequences,
    *,
    num_recycles: Optional[int] = None,
    residue_index_offset: Optional[int] = 512,
    chain_linker: Optional[str] = "G" * 25,
    frugal: Optional[bool] = None,
    pad_to_multiple: Optional[int] = None,
    mesh=None,
    seq_axis: str = "tp",
) -> Dict[str, torch.Tensor]:
    """Sequence(s) -> structure output on the model's device (reference
    esmfold.py:281-339). ``frugal=None`` resolves through :func:`auto_frugal`.
    ``pad_to_multiple`` rounds the padded length up to a bucket; padded
    positions carry mask 0, so outputs on real rows are unchanged. With
    ``cfg.trunk.pair_spec`` set the fold runs through :func:`apply_sharded`
    on ``mesh`` (every rank calls infer with the same sequences; the pair
    outputs are the rank's rows)."""
    if cfg.trunk.pair_spec is not None and mesh is None:
        raise ValueError(f"trunk.pair_spec={cfg.trunk.pair_spec!r} shards the fold over a "
                         "mesh, and no mesh was given: pass mesh=parallel.mesh.make_mesh(...)")
    if mesh is not None and cfg.trunk.pair_spec is None:
        raise ValueError("a mesh was given, but the config has no trunk.pair_spec: set it "
                         f"(e.g. with_options(pair_spec=({seq_axis!r},))) to fold on the mesh")
    if isinstance(sequences, str):
        sequences = [sequences]
    aatype, mask, residx, linker_mask, chain_index = batch_encode_sequences(
        sequences, residue_index_offset, chain_linker)
    if pad_to_multiple:
        L = aatype.shape[1]
        Lp = -(-L // pad_to_multiple) * pad_to_multiple
        if Lp != L:
            pad = ((0, 0), (0, Lp - L))
            aatype, mask, linker_mask = (np.pad(x, pad) for x in (aatype, mask, linker_mask))
            residx = np.pad(residx, pad, mode="edge")  # masked everywhere: any value does
            chain_index = np.pad(chain_index, pad, constant_values=-1)
    if frugal is None:
        frugal = auto_frugal(*aatype.shape)
    dev = model.device

    def t(x):
        return torch.from_numpy(x).to(dev)

    if mesh is None:
        output = apply(model, cfg, t(aatype), mask=t(mask), residx=t(residx),
                       num_recycles=num_recycles, frugal=frugal)
    else:
        output = apply_sharded(model, cfg, t(aatype), mesh=mesh, seq_axis=seq_axis,
                               mask=t(mask), residx=t(residx), num_recycles=num_recycles,
                               frugal=frugal)
    output["atom37_atom_exists"] = output["atom37_atom_exists"] * t(linker_mask)[..., None]
    exists = output["atom37_atom_exists"]
    output["mean_plddt"] = (output["plddt"] * exists).sum((1, 2)) / exists.sum((1, 2))
    output["chain_index"] = t(chain_index)
    return output


def infer_pdbs(model: ESMFold, cfg: ESMFoldConfig, seqs: List[str], **kw) -> List[str]:
    return output_to_pdb(infer(model, cfg, seqs, **kw))


def infer_pdb(model: ESMFold, cfg: ESMFoldConfig, seq: str, **kw) -> str:
    return infer_pdbs(model, cfg, [seq], **kw)[0]
