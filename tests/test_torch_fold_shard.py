"""The port's sharded fold (esm_tpu_torch.models.esmfold.apply_sharded, the
collectives of esm_tpu_torch.parallel.pair_sharding) against esm_tpu's
apply_sharded and apply, on the CPU.

The port's ranks are processes spawned over a gloo group
(tests/_torch_fold_shard_ranks.py, which imports no JAX), one spawn per
world size; esm_tpu runs its apply_sharded on the 8-device virtual mesh
(tests/conftest.py) in this process. The model is tests/test_torch_esmfold.py's
seeded tiny ESMFold (LM 2 x 32, 2 trunk blocks, c_s 64, c_z 32, head width
16, structure module 2 blocks) with its zero-initialized layers re-drawn,
carried across by ``esmfold_state_dict_from_jax``.

  * world 4, L=30 (padded to Lp=32 over tp=4; the ring LM's T=34 to 36),
    one recycle: against esm_tpu's apply_sharded on MeshConfig(1, 2, 4) and
    esm_tpu's apply, within tests/test_sharding.py:218-232's tolerances
    (positions 2e-3 Å; s_s, s_z, distogram and pTM logits 1e-4; PAE and
    pLDDT 5e-3; pTM 1e-4), the pair outputs gathered first;
  * world 4, v0 (use_esm_attn_map: the LM replicated) on mesh (1, 2, 2),
    the batch replicated over fsdp, as tests/test_sharding.py:235-298;
  * world 2, chunk_size=8 with use_flash_tri (K6's plain version on the
    CPU), 2 recycles, a ragged batch of two, against esm_tpu's apply on the
    real rows; and ESMFoldHandle.infer with mesh= against the whole fold;
  * world 1: every output equal (torch.equal) to the port's unsharded
    apply, fp32 and with the fast preset's options (flash LM: the ring's K4
    plain version equals K1's; bf16 trunk with K6's plain version);
  * world 4, per op: each sharded trunk op against the unsharded port op
    (1e-5), so a fault names its op;
  * the plans: _pair_shards, plan_fold and max_fold_length on a mesh,
    plan_scaling_fold and fold_scaling_table, equal to esm_tpu's at the
    settings that give esm_tpu's formulas (PAIR_TEMPS 4, port_terms=False;
    esm_tpu's rates, esm_tpu_bytes=True), and the port's terms beside them.
"""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as PS

from _torch_fold_shard_ranks import FOLD_KEYS, fold_body
from _torch_shard_ranks import spawn
from esm_tpu.data import Alphabet as JaxAlphabet
from esm_tpu.models import esmfold as jef
from esm_tpu.parallel import memory_plan as jplan
from esm_tpu.parallel import scaling as jscaling
from esm_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from esm_tpu.parallel.mesh import make_mesh as jax_make_mesh
from esm_tpu.parallel.sharding import shard_params
from esm_tpu_torch.data import Alphabet
from esm_tpu_torch.io.from_jax import esmfold_state_dict_from_jax
from esm_tpu_torch.models import esmfold as tef
from esm_tpu_torch.parallel import memory_plan as tplan
from esm_tpu_torch.parallel import pair_sharding
from esm_tpu_torch.parallel import scaling
from esm_tpu_torch.parallel.mesh import MeshConfig
from test_torch_esmfold import _sizes, redraw_zeros

ROOT = pathlib.Path(__file__).resolve().parents[1]
# tests/test_sharding.py:218-232
TOL = {"positions": 2e-3, "s_s": 1e-4, "s_z": 1e-4, "distogram_logits": 1e-4,
       "ptm_logits": 1e-4, "predicted_aligned_error": 5e-3, "plddt": 5e-3, "ptm": 1e-4}
PAIR = ("s_z", "distogram_logits", "ptm_logits", "predicted_aligned_error")
OP_TOL = 1e-5


def _build(seed, attn_map=False, **trunk):
    """esm_tpu's config and params (zero layers re-drawn) and the port's
    config and state dict of the same weights."""
    jalpha = JaxAlphabet.from_architecture("ESM-1b")
    jcfg = _sizes(jef, jalpha, attn_map)
    tcfg = _sizes(tef, Alphabet.from_architecture("ESM-1b"), attn_map)
    tcfg = dataclasses.replace(tcfg, trunk=dataclasses.replace(tcfg.trunk, **trunk))
    params = redraw_zeros(jax.tree.map(np.asarray, jef.init_esmfold(
        jax.random.PRNGKey(seed), jcfg, jalpha)), seed + 1)
    return jcfg, params, tcfg, esmfold_state_dict_from_jax(params, tcfg)


def _jax(jcfg, params, aa, mask, num_recycles, mesh_shape=None):
    """esm_tpu's apply, or its apply_sharded on a mesh of the virtual devices."""
    aa, mask = jnp.asarray(aa), jnp.asarray(mask)
    if mesh_shape is None:
        out = jef.apply(jax.tree.map(jnp.asarray, params), jcfg, aa, mask=mask,
                        num_recycles=num_recycles)
    else:
        mesh = jax_make_mesh(JaxMeshConfig(*mesh_shape))
        cfg = dataclasses.replace(jcfg, trunk=dataclasses.replace(jcfg.trunk,
                                                                  pair_spec=PS(None, "tp")))
        sharded = {k: (shard_params(mesh, v) if k == "esm" else jax.tree.map(jnp.asarray, v))
                   for k, v in params.items()}
        out = jef.apply_sharded(sharded, cfg, aa, mesh=mesh, seq_axis="tp", mask=mask,
                                num_recycles=num_recycles)
    exists = out["atom37_atom_exists"]
    out = dict(out, mean_plddt=(out["plddt"] * exists).sum((1, 2)) / exists.sum((1, 2)))
    return {k: np.asarray(out[k]) for k in FOLD_KEYS}


def _aa(seed, b, l):
    return np.random.RandomState(seed).randint(0, 20, (b, l)).astype(np.int64)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """The ring-LM fold on mesh (1, 1, 4) and v0 on (1, 2, 2), with esm_tpu's
    references, and the per-op comparisons, from one spawn of 4 ranks."""
    ring = _build(20)
    v0 = _build(22, attn_map=True)
    aa, mask = _aa(21, 1, 30), np.ones((1, 30), np.int64)
    want = {
        "ring": {"sharded": _jax(ring[0], ring[1], aa, mask, 1, (1, 2, 4)),
                 "whole": _jax(ring[0], ring[1], aa, mask, 1)},
        "v0": {"sharded": _jax(v0[0], v0[1], aa, mask, 0, (1, 2, 4)),
               "whole": _jax(v0[0], v0[1], aa, mask, 0)},
    }
    case = lambda built, mesh, recycles: dict(  # noqa: E731
        cfg=built[2], state_dict=built[3], mesh=mesh, aa=torch.from_numpy(aa),
        mask=torch.from_numpy(mask), num_recycles=recycles)
    inputs = {"folds": {"ring": case(ring, (1, 1, 4), 1), "v0": case(v0, (1, 2, 2), 0)},
              "ops": {"mesh": (1, 1, 4), "length": 32, "seed": 23}}
    return want, spawn(fold_body, 4, inputs, tmp_path_factory.mktemp("fold4"))


@pytest.mark.parametrize("case", ["ring", "v0"])
@pytest.mark.parametrize("ref", ["sharded", "whole"])
@pytest.mark.parametrize("key", list(TOL))
def test_world4_fold_matches_esm_tpu(world4, case, ref, key):
    want, ranks = world4
    got = ranks[0][case]["sharded"][key].numpy()
    np.testing.assert_allclose(got, want[case][ref][key], atol=TOL[key], rtol=0,
                               err_msg=f"{case} {key} vs esm_tpu's {ref} fold")


@pytest.mark.parametrize("case", ["ring", "v0"])
def test_world4_ranks_hold_the_same_structure(world4, case):
    _, ranks = world4
    first = ranks[0][case]["sharded"]["positions"]
    assert first.shape[-3] == 30  # the padding to Lp=32 stripped
    for r in ranks[1:]:
        assert torch.equal(r[case]["sharded"]["positions"], first)


OPS = ["tri_mul_out", "tri_mul_in"] + [
    f"tri_att_{side}_{path}" for side in ("start", "end")
    for path in ("exact", "chunked", "fused")] + [
    "seq_attention", "block_s", "block_z", "relative_position", "recycle_bins", "ipa"]


@pytest.mark.parametrize("op", OPS)
def test_sharded_op_matches_unsharded(world4, op):
    got, want = world4[1][0]["ops"][op]
    assert got.shape == want.shape
    np.testing.assert_allclose(got.double().numpy(), want.double().numpy(), atol=OP_TOL,
                               rtol=0, err_msg=op)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Chunked triangle attention and K6's plain version, 2 recycles, a
    ragged batch of two, and the handle with mesh=, on 2 ranks."""
    built = _build(30, chunk_size=8, use_flash_tri=True)
    aa = _aa(31, 2, 30)
    mask = np.ones((2, 30), np.int64)
    mask[1, 24:] = 0
    want = _jax(built[0], built[1], aa, mask, 2)
    seqs = ["MKTVRQERLKAYTRQELAEWLSGK", "MKTAY:RQELSG"]
    inputs = {"folds": {"chunked": dict(
        cfg=built[2], state_dict=built[3], mesh=(1, 1, 2), aa=torch.from_numpy(aa),
        mask=torch.from_numpy(mask), num_recycles=2, handle=True, seqs=seqs)}}
    return want, mask, spawn(fold_body, 2, inputs, tmp_path_factory.mktemp("fold2"))


@pytest.mark.parametrize("key", list(TOL))
def test_world2_chunked_fused_fold_matches_esm_tpu(world2, key):
    want, mask, ranks = world2
    got = ranks[0]["chunked"]["sharded"][key].numpy()
    for i, n in enumerate(mask.sum(1)):
        if key == "ptm":
            g, w = got[i], want[key][i]
        elif key == "positions":
            g, w = got[-1, i, :n], want[key][-1, i, :n]
        elif key in PAIR:
            g, w = got[i, :n, :n], want[key][i, :n, :n]
        else:
            g, w = got[i, :n], want[key][i, :n]
        np.testing.assert_allclose(g, w, atol=TOL[key], rtol=0, err_msg=f"{key}, sequence {i}")


def test_world2_handle_folds_on_the_mesh(world2):
    res = world2[2][0]["chunked"]["handle"]
    np.testing.assert_allclose(res["positions"].numpy(), res["whole"].numpy(),
                               atol=TOL["positions"], rtol=0)


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """One rank: every collective is the identity, so the sharded fold is the
    unsharded one, bit for bit (fp32, and the fast preset's options)."""
    fp32 = _build(40)
    fast = _build(40, compute_dtype=torch.bfloat16, use_flash_tri=True)
    v0 = _build(42, attn_map=True)
    flash = lambda cfg: dataclasses.replace(  # noqa: E731
        cfg, esm=dataclasses.replace(cfg.esm, use_flash=True))
    aa, mask = _aa(41, 1, 30), np.ones((1, 30), np.int64)
    case = lambda built, cfg: dict(  # noqa: E731
        cfg=cfg, state_dict=built[3], mesh=(1, 1, 1), aa=torch.from_numpy(aa),
        mask=torch.from_numpy(mask), num_recycles=1, unsharded=True)
    inputs = {"folds": {"fp32": case(fp32, flash(fp32[2])), "fast": case(fast, flash(fast[2])),
                        "v0": case(v0, v0[2])}}
    return spawn(fold_body, 1, inputs, tmp_path_factory.mktemp("fold1"))[0]


@pytest.mark.parametrize("case", ["fp32", "fast", "v0"])
def test_world1_equals_the_unsharded_fold(world1, case):
    res = world1[case]
    assert res["equal"] == {k: True for k in res["sharded"]}, res["equal"]


def test_apply_sharded_needs_pair_spec_and_a_mesh():
    _, _, tcfg, sd = _build(50)
    model = tef.ESMFold(tcfg, device="cpu")
    model.load_state_dict(sd)
    aa = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="needs cfg.trunk.pair_spec"):
        tef.apply_sharded(model, tcfg, aa, mesh=None)
    sharded = dataclasses.replace(tcfg, trunk=dataclasses.replace(tcfg.trunk, pair_spec=("tp",)))
    with pytest.raises(ValueError, match="apply_sharded"):
        tef.apply(model, sharded, aa)
    with pytest.raises(ValueError, match="no mesh was given"):
        tef.infer(model, sharded, "MKTV")


def test_collectives_refuse_gradients():
    shard = pair_sharding.PairShard(None, 1, 0, 4)
    x = torch.zeros(1, 4, 4, 2, requires_grad=True)
    for fn in (pair_sharding.gather_rows, pair_sharding.rows_to_cols,
               pair_sharding.cols_to_rows, pair_sharding.all_reduce_max):
        with pytest.raises(RuntimeError, match="no backward"):
            fn(x, shard)
        with torch.no_grad():
            assert fn(x, shard) is x  # one rank: the identity


# ---- the plans


def _plan_configs(attn_map=False, **trunk):
    """esm_tpu's and the port's ESMFold v1 configs with the pair rows over tp."""
    from esm_tpu.models import esm2 as jesm2
    from esm_tpu_torch.models import esm2 as tesm2

    lm = dict(num_layers=36, embed_dim=2560, attention_heads=40)
    jtrunk = dict(trunk, compute_dtype={torch.bfloat16: jnp.bfloat16}.get(
        trunk.get("compute_dtype"), jnp.float32))
    jcfg = jef.ESMFoldConfig(
        esm=jesm2.ESM2Config.from_alphabet(JaxAlphabet.from_architecture("ESM-1b"), **lm),
        trunk=jef.FoldingTrunkConfig(pair_spec=PS(None, "tp"), **jtrunk),
        use_esm_attn_map=attn_map)
    tcfg = tef.ESMFoldConfig(
        esm=tesm2.ESM2Config.from_alphabet(Alphabet.from_architecture("ESM-1b"), **lm),
        trunk=tef.FoldingTrunkConfig(pair_spec=("tp",), **trunk), use_esm_attn_map=attn_map)
    return jcfg, tcfg


HBM = 80_000_000_000
MESHES = [(1, 1, 1), (1, 1, 2), (1, 2, 4), (2, 1, 4), (1, 1, 8)]
PLAN_CASES = [
    (dict(compute_dtype=torch.bfloat16, use_flash_tri=True), dict(L=2048)),
    (dict(compute_dtype=torch.bfloat16, use_flash_tri=True),
     dict(L=3072, batch=2, held_outputs=2, frugal=True, lm_dtype_bytes=1)),
    (dict(chunk_size=64), dict(L=1500, frugal=False)),
    (dict(), dict(L=700)),
    (dict(attn_map=True, compute_dtype=torch.bfloat16), dict(L=300, batch=2)),
]


@pytest.mark.parametrize("shape", MESHES)
def test_pair_shards_match_esm_tpu(shape):
    jcfg, tcfg = _plan_configs()
    assert tplan._pair_shards(tcfg.trunk.pair_spec, MeshConfig(*shape)) == \
        jplan._pair_shards(jcfg.trunk.pair_spec, JaxMeshConfig(*shape)) == shape[2]
    assert tplan._pair_shards(None, MeshConfig(*shape)) == 1


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("opts,kw", PLAN_CASES)
def test_plan_fold_on_a_mesh_matches_esm_tpu(monkeypatch, shape, opts, kw):
    """PAIR_TEMPS 4 and port_terms=False: esm_tpu's plan on the mesh, exactly;
    the port's terms add the whole parameters, the gathered tri-mul operand
    and triangle bias (and v0's maps) once the pair rows are sharded."""
    opts, kw = dict(opts), dict(kw)
    jcfg, tcfg = _plan_configs(opts.pop("attn_map", False), **opts)
    L = kw.pop("L")
    monkeypatch.setattr(tplan, "PAIR_TEMPS", 4)
    want = jplan.plan_fold(jcfg, L, JaxMeshConfig(*shape), hbm_bytes=HBM, **kw)
    got = tplan.plan_fold(tcfg, L, MeshConfig(*shape), hbm_bytes=HBM, port_terms=False, **kw)
    assert got == want
    port = tplan.plan_fold(tcfg, L, MeshConfig(*shape), hbm_bytes=HBM, **kw)
    assert port["pair_shards"] == shape[2]
    one = tplan.plan_fold(tcfg, L, hbm_bytes=HBM, **kw)
    assert port["params_bytes"] == one["params_bytes"]  # the fold keeps every weight
    if shape[2] == 1:
        assert port["per_device_bytes"] == one["per_device_bytes"]
    else:
        b, c_z = kw.get("batch", 1), tcfg.trunk.pairwise_state_dim
        gathered = b * L * L * (c_z * tcfg.trunk.compute_dtype.itemsize
                                + tcfg.trunk.pair_heads * 4)
        assert port["pair_bytes"] - got["pair_bytes"] == gathered
        assert port["per_device_bytes"] < one["per_device_bytes"]


@pytest.mark.parametrize("shape", [(1, 1, 2), (1, 2, 4), (1, 1, 8)])
def test_max_fold_length_on_a_mesh_matches_esm_tpu(monkeypatch, shape):
    jcfg, tcfg = _plan_configs(compute_dtype=torch.bfloat16, use_flash_tri=True)
    monkeypatch.setattr(tplan, "PAIR_TEMPS", 4)
    want = jplan.max_fold_length(jcfg, JaxMeshConfig(*shape), hbm_bytes=HBM, frugal=True)
    assert tplan.max_fold_length(tcfg, MeshConfig(*shape), hbm_bytes=HBM, frugal=True,
                                 port_terms=False) == want
    monkeypatch.undo()
    one = tplan.max_fold_length(tcfg, hbm_bytes=HBM, frugal=True)
    assert tplan.max_fold_length(tcfg, MeshConfig(*shape), hbm_bytes=HBM, frugal=True) > one


KEYS = {"t_mxu_ms": "t_compute_ms", "t_ici_ms": "t_link_ms", "ici_bytes": "link_bytes"}
JAX_RATES = dict(gemm_tflops=jscaling.MXU_TFLOPS_MEASURED, link_gbps=jscaling.ICI_GBPS,
                 nominal_tflops=jscaling.MXU_TFLOPS_NOMINAL, esm_tpu_bytes=True)
KINDS = (("comm-bound", "link-bound"), ("no nominal-MXU headroom", "no headroom"),
         ("marginal", "marginal"))


def _port_row(kw):
    fcfg = scaling._fold_dims(kw["fcfg"].esm.embed_dim, kw["fcfg"].esm.num_layers)
    return dict(kw, fcfg=fcfg, mesh_cfg=MeshConfig(*kw["mesh_cfg"].shape))


@pytest.mark.parametrize("row", range(len(jscaling.FOLD_DOC_ROWS)))
@pytest.mark.parametrize("num_recycles", [None, 0, 3])
@pytest.mark.parametrize("seqlen", [None, 256, 4096])
def test_plan_scaling_fold_matches_esm_tpu(row, num_recycles, seqlen):
    _, kw = jscaling.FOLD_DOC_ROWS[row]
    kw = dict(kw, num_recycles=num_recycles, seqlen=seqlen or kw["seqlen"])
    want = jscaling.plan_scaling_fold(**kw)
    got = scaling.plan_scaling_fold(**_port_row(kw), **JAX_RATES)
    for key, value in want.items():
        if key == "recommendations":
            kinds = [[next(i for i, k in enumerate(KINDS) if r.startswith(k[side]))
                      for r in recs] for side, recs in ((0, value), (1, got[key]))]
            assert kinds[0] == kinds[1], (got[key], value)
        else:
            assert got[KEYS.get(key, key)] == value, key
    assert got["pass_gather_bytes"] == got["lm_gather_bytes"] == 0


def test_plan_scaling_fold_counts_the_ports_collectives():
    """The port's bytes: both tri-muls gather b, the incoming one also moves
    a; both triangle attentions gather their bias, the ending one moves z,
    its mask and its output; per pass IPA's gathers; the LM's gather."""
    fcfg, mesh = scaling._fold_dims(2560, 36), MeshConfig(1, 1, 4)
    p = scaling.plan_scaling_fold(fcfg, mesh, 1024)
    l, zb, spread, swap = 1024, 2, 3 / 4, 3 / 16
    assert p["block_gather_bytes"] == int(spread * zb * (2 * l * l * 128 + 2 * l * l * 4
                                                         + l * 1024))
    assert p["block_a2a_bytes"] == int(swap * zb * l * l * (3 * 128 + 1))
    assert p["pass_gather_bytes"] == int(8 * spread * l * 384 * 4)
    assert p["head_a2a_bytes"] == int(swap * l * l * 64 * 4)
    one = scaling.plan_scaling_fold(fcfg, MeshConfig(1, 1, 1), 1024)
    assert one["link_bytes"] == 0 and one["r"] == 0
    v1 = scaling._fold_dims(2560, 36)
    cross = scaling.fold_crossover_length(v1, mesh)
    assert scaling.plan_scaling_fold(v1, mesh, cross)["r"] < 1
    assert scaling.plan_scaling_fold(v1, mesh, cross - 64)["r"] >= 1


def test_fold_scaling_table_matches_esm_tpu():
    """esm_tpu's rows at esm_tpu's rates and byte formula: the same r and
    efficiency per row (the port's table prints more columns)."""
    rows = [(label, _port_row(kw)) for label, kw in jscaling.FOLD_DOC_ROWS]
    ours = scaling.fold_scaling_table(rows, **JAX_RATES).splitlines()[2:]
    theirs = jscaling.fold_scaling_table().splitlines()[2:]
    assert len(ours) == len(theirs) == len(rows)
    cells = lambda line: [c.strip() for c in line.strip("|").split("|")]  # noqa: E731
    for a, b in zip(ours, theirs):
        a, b = cells(a), cells(b)
        # label, link GB (gather / a2a / LM ring), r, overlapped efficiency
        assert (a[0], a[3], a[4], a[5]) == (b[0], b[3], b[4], b[5])


def test_perf_md_carries_the_fold_table():
    """PERF.md embeds the port's fold table at the card's rates, generated."""
    assert scaling.fold_scaling_table() in (ROOT / "PERF.md").read_text()
