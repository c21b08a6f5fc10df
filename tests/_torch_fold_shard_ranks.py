"""Rank bodies of the sharded-fold tests (tests/test_torch_fold_shard.py).

Each body runs in one of ``world`` gloo processes spawned by
``_torch_shard_ranks.spawn`` (one CPU thread each, a FileStore in the
test's temporary directory). This module imports no JAX: the parent passes
the weights (carried across from esm_tpu) and the inputs in, and each rank
returns what the parent asserts on. Every rank passes the same inputs, as
``esmfold.apply_sharded`` requires; rank 0 gathers the pair outputs
(``gather_pair_outputs``) and returns them with the whole outputs.
"""

import dataclasses

import torch

from esm_tpu_torch.models import esmfold as ef
from esm_tpu_torch.models.esmfold import blocks, structure_module as sm
from esm_tpu_torch.ops import rigid as rg
from esm_tpu_torch.ops import triangle
from esm_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from esm_tpu_torch.parallel.pair_sharding import gather_rows, pair_shard

# what a fold case returns (and the parent compares)
FOLD_KEYS = ("positions", "s_s", "s_z", "distogram_logits", "ptm_logits",
             "predicted_aligned_error", "plddt", "ptm", "mean_plddt")


def _model(case):
    model = ef.ESMFold(case["cfg"], device="cpu")
    model.load_state_dict(case["state_dict"], strict=True)
    return model


def _sharded(cfg, seq_axis="tp"):
    return dataclasses.replace(cfg, trunk=dataclasses.replace(cfg.trunk, pair_spec=(seq_axis,)))


def _fold(model, cfg, inp, mesh=None):
    args = dict(mask=inp["mask"], residx=inp.get("residx"), num_recycles=inp["num_recycles"])
    if mesh is None:
        with torch.no_grad():
            return ef.apply(model, cfg, inp["aa"], **args)
    return ef.gather_pair_outputs(ef.apply_sharded(model, _sharded(cfg), inp["aa"], mesh=mesh,
                                                   **args), mesh)


def _keep(out):
    exists = out["atom37_atom_exists"]
    out = dict(out, mean_plddt=(out["plddt"] * exists).sum((1, 2)) / exists.sum((1, 2)))
    return {k: out[k] for k in FOLD_KEYS if k in out}


def fold_body(inp: dict, rank: int) -> dict:
    """Each case of ``inp["folds"]``: the sharded fold on its mesh (gathered);
    with ``unsharded`` also this rank's unsharded ``apply`` of the same
    weights, and with ``handle`` the fold through ``ESMFoldHandle.infer``
    with ``mesh=``. Rank 0 returns every output; the others their positions
    (every rank must hold the same whole outputs)."""
    out = {}
    for name, case in inp["folds"].items():
        mesh = make_mesh(MeshConfig(*case["mesh"]), device_type="cpu")
        model = _model(case)
        got = _keep(_fold(model, case["cfg"], case, mesh))
        res = {"sharded": got}
        if case.get("unsharded"):
            res["unsharded"] = _keep(_fold(model, case["cfg"], case))
            res["equal"] = {k: torch.equal(got[k], res["unsharded"][k]) for k in got}
        if case.get("handle"):
            from esm_tpu_torch.data import Alphabet
            from esm_tpu_torch.pretrained import ESMFoldHandle

            handle = ESMFoldHandle(case["cfg"], model, Alphabet.from_architecture("ESM-1b"))
            sharded = handle.with_options(pair_spec=("tp",))
            res["handle"] = {"positions": sharded.infer(case["seqs"], mesh=mesh,
                                                        num_recycles=case["num_recycles"])[
                "positions"],
                "whole": handle.infer(case["seqs"], num_recycles=case["num_recycles"])[
                    "positions"]}
        out[name] = res if rank == 0 else {"sharded": {"positions": got["positions"]}}
    if "ops" in inp:
        out["ops"] = ops_body(inp["ops"], rank)
    return out


def _seeded(module, gen):
    for p in module.parameters():
        p.data.normal_(generator=gen).mul_(0.3)
    return module


@torch.no_grad()
def ops_body(inp: dict, rank: int) -> dict:
    """Each sharded trunk op on this rank's rows of a seeded (B, L, L, C) pair
    tensor with a ragged mask, gathered, beside the unsharded port op on the
    whole tensor: both tri-muls, both triangle attentions (exact, chunked
    and the K6 plain version), the sequence attention with its pair bias, a
    whole trunk block, IPA, the relative positions and the recycle bins."""
    mesh = make_mesh(MeshConfig(*inp["mesh"]), device_type="cpu")
    gen = torch.Generator().manual_seed(inp["seed"])
    b, l, c, c_s, heads = 2, inp["length"], 32, 64, 2
    pair = pair_shard(mesh, "tp", l)
    z = torch.randn(b, l, l, c, generator=gen)
    mask = torch.ones(b, l)
    mask[1, l - 5:] = 0
    tri_mask = mask[:, :, None] * mask[:, None, :]
    zl, ml = pair.local(z), pair.local(tri_mask)
    res = {}

    def both(name, whole, rows):
        res[name] = (gather_rows(rows, pair), whole)

    mul = _seeded(triangle.TriangleMultiplication(c), gen)
    for outgoing in (True, False):
        both(f"tri_mul_{'out' if outgoing else 'in'}",
             triangle.triangle_multiplicative_update(mul, z, outgoing=outgoing, mask=tri_mask),
             triangle.triangle_multiplicative_update(mul, zl, outgoing=outgoing, mask=ml,
                                                     pair=pair))
    att = _seeded(triangle.TriangleAttention(c, heads), gen)
    for starting in (True, False):
        for path, kw in (("exact", {}), ("chunked", dict(chunk_size=3)),
                         ("fused", dict(use_flash=True))):
            both(f"tri_att_{'start' if starting else 'end'}_{path}",
                 triangle.triangle_attention(att, z, num_heads=heads, starting=starting,
                                             mask=tri_mask, **kw),
                 triangle.triangle_attention(att, zl, num_heads=heads, starting=starting,
                                             mask=ml, pair=pair, **kw))
    block = _seeded(blocks.TriangularSelfAttentionBlock(c_s, c, 16, 16), gen)
    s = torch.randn(b, l, c_s, generator=gen)
    bias = blocks.pair_to_sequence(block.pair_to_sequence, z)
    x = torch.randn(b, l, c_s, generator=gen)
    res["seq_attention"] = (
        blocks.gated_attention(block.seq_attention, x, num_heads=4, mask=mask,
                               bias=pair.local(bias), pair=pair),
        blocks.gated_attention(block.seq_attention, x, num_heads=4, mask=mask, bias=bias))
    ws, wz = blocks.triangular_self_attention_block(block, s, z, seq_heads=4, pair_heads=2,
                                                    mask=mask)
    gs, gz = blocks.triangular_self_attention_block(block, s, zl, seq_heads=4, pair_heads=2,
                                                    mask=mask, pair=pair)
    res["block_s"] = (gs, ws)
    both("block_z", wz, gz)
    rp = _seeded(blocks.RelativePosition(8, c), gen)
    residx = torch.arange(l).expand(b, l)
    both("relative_position", blocks.relative_position(rp, residx, mask, bins=8),
         blocks.relative_position(rp, residx, mask, bins=8, pair=pair))
    from esm_tpu_torch.models.esmfold.trunk import distogram_bins

    coords = torch.randn(b, l, 3, 3, generator=gen) * 5
    both("recycle_bins", distogram_bins(coords), distogram_bins(coords, pair=pair))
    cfg = sm.StructureModuleConfig(c_s=32, c_z=c, c_ipa=8, c_resnet=16, no_heads_ipa=4,
                                   no_blocks=2)
    ipa = _seeded(sm.InvariantPointAttention(cfg), gen)
    quat = torch.randn(b, l, 4, generator=gen)
    frames = rg.Rigid(rg.quat_to_rot(quat / quat.norm(dim=-1, keepdim=True)),
                      torch.randn(b, l, 3, generator=gen))
    s32 = torch.randn(b, l, 32, generator=gen)
    res["ipa"] = (sm.invariant_point_attention(ipa, cfg, s32, zl, frames, mask, pair),
                  sm.invariant_point_attention(ipa, cfg, s32, z, frames, mask))
    return res if rank == 0 else {}
