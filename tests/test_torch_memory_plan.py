"""The port's one-device fold memory plan (esm_tpu_torch.parallel.memory_plan)
against esm_tpu's (esm_tpu/parallel/memory_plan.py) on the CPU.

With ``PAIR_TEMPS`` set to 4 (esm_tpu's trunk working set) and an explicit
``hbm_bytes``, ``plan_fold`` and ``max_fold_length`` must equal esm_tpu's on
the same configuration, exactly: it is integer arithmetic on the configs. The
port's default charges ``PAIR_TEMPS`` compute-dtype pair tensors instead, and
differs from esm_tpu's by exactly that term. ``hbm_bytes=None`` takes the
named device's memory. The server derives its fold cap from the plan: from
parameter and buffer bytes (int8 scales are buffers), a cap that chunking
raises, an explicit cap honoured.
"""

import dataclasses
import os

import jax.numpy as jnp
import pytest
import torch

from esm_tpu.data import Alphabet as JaxAlphabet
from esm_tpu.models import esm2 as jesm2
from esm_tpu.models import esmfold as jef
from esm_tpu.parallel import memory_plan as jplan
from esm_tpu_torch.data import Alphabet
from esm_tpu_torch.models import esm2 as tesm2
from esm_tpu_torch.models import esmfold as tef
from esm_tpu_torch.parallel import memory_plan as tplan

HBM = 15_750_000_000  # an explicit device size, the same to both packages

# (LM size, trunk size): ESMFold v1's released widths, and a tiny one
SIZES = {
    "v1": (dict(num_layers=36, embed_dim=2560, attention_heads=40), dict(num_blocks=48)),
    "tiny": (dict(num_layers=2, embed_dim=32, attention_heads=2),
             dict(num_blocks=1, sequence_state_dim=64, pairwise_state_dim=32,
                  sequence_head_width=16, pairwise_head_width=16)),
}


def _configs(size, *, bf16=False, chunk_size=None, flash_tri=False, attn_map=False):
    lm, trunk = SIZES[size]
    jtrunk = dict(trunk, chunk_size=chunk_size, use_flash_tri=flash_tri,
                  compute_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    ttrunk = dict(trunk, chunk_size=chunk_size, use_flash_tri=flash_tri,
                  compute_dtype=torch.bfloat16 if bf16 else torch.float32)
    jcfg = jef.ESMFoldConfig(
        esm=jesm2.ESM2Config.from_alphabet(JaxAlphabet.from_architecture("ESM-1b"), **lm),
        trunk=jef.FoldingTrunkConfig(**jtrunk), use_esm_attn_map=attn_map)
    tcfg = tef.ESMFoldConfig(
        esm=tesm2.ESM2Config.from_alphabet(Alphabet.from_architecture("ESM-1b"), **lm),
        trunk=tef.FoldingTrunkConfig(**ttrunk), use_esm_attn_map=attn_map)
    return jcfg, tcfg


CASES = [
    ("v1", dict(bf16=True, flash_tri=True), dict(L=1024)),
    ("v1", dict(bf16=True, flash_tri=True), dict(L=2048, batch=4, held_outputs=2, frugal=True,
                                                 params_bytes=14_126_405_696)),
    ("v1", dict(), dict(L=700, frugal=False, lm_dtype_bytes=4)),
    ("v1", dict(chunk_size=64), dict(L=1500, lm_dtype_bytes=1)),
    ("v1", dict(attn_map=True, bf16=True), dict(L=300, batch=2)),
    ("tiny", dict(), dict(L=64)),
    ("tiny", dict(bf16=True), dict(L=900, frugal=None, batch=3)),
]


@pytest.fixture
def jax_working_set(monkeypatch):
    monkeypatch.setattr(tplan, "PAIR_TEMPS", 4)


@pytest.mark.parametrize("size,opts,kw", CASES)
def test_plan_fold_matches_jax(jax_working_set, size, opts, kw):
    jcfg, tcfg = _configs(size, **opts)
    kw = dict(kw)
    L = kw.pop("L")
    want = jplan.plan_fold(jcfg, L, hbm_bytes=HBM, **kw)
    got = tplan.plan_fold(tcfg, L, hbm_bytes=HBM, **kw)
    assert got == want


@pytest.mark.parametrize("size,opts,kw", [
    ("v1", dict(bf16=True, flash_tri=True), dict(batch=4, held_outputs=2, frugal=True,
                                                 params_bytes=14_126_405_696)),
    ("v1", dict(bf16=True), dict()),
    ("tiny", dict(), dict(frugal=True)),
    ("tiny", dict(chunk_size=16), dict()),
])
def test_max_fold_length_matches_jax(jax_working_set, size, opts, kw):
    jcfg, tcfg = _configs(size, **opts)
    want = jplan.max_fold_length(jcfg, hbm_bytes=HBM, **kw)
    assert tplan.max_fold_length(tcfg, hbm_bytes=HBM, **kw) == want
    assert tplan.max_fold_length(tcfg, hbm_bytes=HBM, include_close=True,
                                 **kw) == jplan.max_fold_length(jcfg, hbm_bytes=HBM,
                                                                include_close=True, **kw)


@pytest.mark.parametrize("bf16", [False, True])
def test_port_working_set_term(bf16, monkeypatch):
    """The default plan charges PAIR_TEMPS compute-dtype pair tensors where
    esm_tpu charges 4; nothing else differs, and the cap can only fall."""
    jcfg, tcfg = _configs("v1", bf16=bf16, flash_tri=True)
    L, batch = 1000, 2
    want = jplan.plan_fold(jcfg, L, batch=batch, hbm_bytes=HBM)
    got = tplan.plan_fold(tcfg, L, batch=batch, hbm_bytes=HBM)
    extra = (tplan.PAIR_TEMPS - 4) * batch * L * L * 128 * (2 if bf16 else 4)
    assert got["pair_bytes"] - want["pair_bytes"] == extra
    assert got["per_device_bytes"] - want["per_device_bytes"] == extra
    for k in ("params_bytes", "lm_bytes", "output_bytes", "frugal", "hbm_bytes"):
        assert got[k] == want[k], k
    cap = tplan.max_fold_length(tcfg, hbm_bytes=80 * 10**9)
    monkeypatch.setattr(tplan, "PAIR_TEMPS", 4)
    assert cap < tplan.max_fold_length(tcfg, hbm_bytes=80 * 10**9)


def test_hbm_bytes_default_is_the_named_device():
    _, tcfg = _configs("tiny")
    host = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    assert tplan.device_memory_bytes("cpu") == host
    assert tplan.plan_fold(tcfg, 128, device="cpu")["hbm_bytes"] == host
    assert tplan.max_fold_length(tcfg, device="cpu") == tplan.max_fold_length(
        tcfg, hbm_bytes=host)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tplan.device_memory_bytes()


def _fold_handle(chunk_size=None):
    from esm_tpu_torch.pretrained import ESMFoldHandle

    _, tcfg = _configs("tiny", chunk_size=chunk_size)
    model = tef.init_esmfold(tcfg, torch.Generator().manual_seed(0), device="cpu")
    return ESMFoldHandle(tcfg, model, Alphabet.from_architecture("ESM-1b"))


def test_fold_cap_from_memory_plan():
    """max_fold_seq_len=None derives the cap from plan_fold for this model's
    config, precision and device (the CPU's memory here), for a full fold
    batch with two outputs held, from the live parameter bytes."""
    from esm_tpu_torch.runtime.server import InferenceServer

    handle = _fold_handle()
    srv = InferenceServer(fold_model=handle, max_fold_seq_len=None, max_fold_batch_seqs=2)
    srv._httpd.server_close()
    nbytes = sum(p.numel() * p.element_size() for p in handle.model.parameters())
    assert srv.max_fold_seq_len == tplan.max_fold_length(
        handle.cfg, params_bytes=nbytes, frugal=True, held_outputs=2, batch=2, device="cpu")
    # unchunked triangle attention is O(L^3): even a tiny model gets a finite cap
    assert isinstance(srv.max_fold_seq_len, int) and srv.max_fold_seq_len > 256
    # chunking removes the O(L^3) term -> the derived cap grows
    handle.set_chunk_size(64)
    chunked = InferenceServer(fold_model=handle, max_fold_seq_len=None, max_fold_batch_seqs=2)
    chunked._httpd.server_close()
    assert chunked.max_fold_seq_len > srv.max_fold_seq_len
    # explicit cap still honoured
    explicit = InferenceServer(fold_model=handle, max_fold_seq_len=777)
    explicit._httpd.server_close()
    assert explicit.max_fold_seq_len == 777


def test_default_fold_cap_is_the_plans():
    """With no cap given, the server and esm-serve derive it from the memory
    plan at a full fold batch (no fixed default length is kept)."""
    from esm_tpu_torch.cli.serve import create_parser
    from esm_tpu_torch.runtime.server import InferenceServer

    handle = _fold_handle()
    srv = InferenceServer(fold_model=handle)
    srv._httpd.server_close()
    nbytes = sum(p.numel() * p.element_size() for p in handle.model.parameters())
    assert srv.max_fold_seq_len == tplan.max_fold_length(
        handle.cfg, params_bytes=nbytes, frugal=True, held_outputs=2, batch=4, device="cpu")
    assert create_parser().parse_args(["m"]).max_fold_len == 0


def test_fold_cap_counts_int8_scale_buffers(monkeypatch):
    """The cap's parameter bytes are the module's parameters AND buffers: an
    int8 handle's per-row scales are buffers (as they are leaves in
    esm_tpu's params tree)."""
    from esm_tpu_torch.runtime import server as srv_mod
    from esm_tpu_torch.parallel import memory_plan

    handle = _fold_handle().quantized(min_size=1)
    buffers = sum(b.numel() * b.element_size() for b in handle.model.buffers())
    params = sum(p.numel() * p.element_size() for p in handle.model.parameters())
    assert buffers > 0 and any(p.dtype == torch.int8 for p in handle.model.parameters())
    seen = {}
    real = memory_plan.max_fold_length

    def spy(cfg, **kw):
        seen.update(kw)
        return real(cfg, **kw)

    monkeypatch.setattr(memory_plan, "max_fold_length", spy)
    srv = srv_mod.InferenceServer(fold_model=handle, max_fold_seq_len=0)
    srv._httpd.server_close()
    assert seen["params_bytes"] == params + buffers
    assert seen["batch"] == 4 and seen["held_outputs"] == 2 and seen["frugal"] is True
    assert srv.max_fold_seq_len == real(handle.cfg, **seen)


def test_no_length_fits_refuses_to_start(monkeypatch):
    from esm_tpu_torch.parallel import memory_plan
    from esm_tpu_torch.runtime.server import InferenceServer

    monkeypatch.setattr(memory_plan, "device_memory_bytes", lambda device=None: 10**6)
    with pytest.raises(ValueError, match="no fold length fits"):
        InferenceServer(fold_model=_fold_handle(), max_fold_seq_len=None)


def test_configs_carry_the_same_fields():
    """The plan reads the same fields of both packages' configs."""
    jcfg, tcfg = _configs("v1", bf16=True)
    for f in ("pairwise_state_dim", "sequence_state_dim", "num_blocks", "chunk_size",
              "use_flash_tri", "pair_heads"):
        assert getattr(jcfg.trunk, f) == getattr(tcfg.trunk, f), f
    for f in ("no_blocks", "c_s", "c_z"):
        assert getattr(jcfg.trunk.structure_module, f) == getattr(tcfg.trunk.structure_module, f)
    for f in ("distogram_bins", "lddt_bins", "use_esm_attn_map"):
        assert getattr(jcfg, f) == getattr(tcfg, f), f


# ---------------------------------------------------------------------------
# The mesh half: plan, plan_model, plan_train, plan_train_lora against
# esm_tpu's, with esm_tpu's activation constants passed in (read from no
# module: they are the defaults of its signatures) and an explicit device size.

def _lm_cfgs(name):
    size = jesm2.ESM2_SIZES[name]
    return (jesm2.ESM2Config.from_alphabet(JaxAlphabet.from_architecture("ESM-1b"), **size),
            tesm2.ESM2Config.from_alphabet(Alphabet.from_architecture("ESM-1b"), **size))


def _mesh_cfgs(shape):
    from esm_tpu.parallel.mesh import MeshConfig as JMesh
    from esm_tpu_torch.parallel.mesh import MeshConfig as TMesh

    return JMesh(*shape), TMesh(*shape)


def _grid():
    """Every ESM-2 size on esm_tpu's documented layouts (scaling.DOC_ROWS:
    (1, 1, 1), (1, 1, 4), (1, 4, 2)) and (2, 2, 2)."""
    from esm_tpu.parallel.scaling import DOC_ROWS

    shapes = sorted({kw["mesh_cfg"].shape for _, kw in DOC_ROWS} | {(2, 2, 2)})
    return [(n, s) for n in jesm2.ESM2_SIZES for s in shapes]


@pytest.fixture
def jax_plan_model_once(monkeypatch):
    """esm_tpu's plan_model traces an init per call: once per argument set here."""
    import functools

    monkeypatch.setattr(jplan, "plan_model", functools.lru_cache(maxsize=None)(jplan.plan_model))


@pytest.mark.parametrize("name,shape", _grid())
def test_mesh_plans_match_jax(jax_plan_model_once, name, shape):
    import inspect

    jcfg, tcfg = _lm_cfgs(name)
    jmesh_cfg, tmesh_cfg = _mesh_cfgs(shape)
    acts = inspect.signature(jplan.plan_train).parameters  # esm_tpu's constants live inline
    assert "act_units" not in acts
    esm_tpu_train = dict(act_units=10, port_terms=False)
    assert tplan.plan_model(tcfg, tmesh_cfg) == jplan.plan_model(jcfg, jmesh_cfg)
    assert tplan.plan_model(tcfg, tmesh_cfg, dtype=torch.bfloat16) == jplan.plan_model(
        jcfg, jmesh_cfg, dtype=jnp.bfloat16)
    for batch, seqlen, kw in ((8, 1024, {}), (1, 8192, dict(mu_dtype_bytes=2, seq_shards=4)),
                              (16, 512, dict(accum_steps=2)), (4, 1024, dict(factored=True))):
        assert tplan.plan_train(tcfg, tmesh_cfg, batch, seqlen, hbm_bytes=HBM, **kw,
                                **esm_tpu_train) == jplan.plan_train(
            jcfg, jmesh_cfg, batch, seqlen, hbm_bytes=HBM, **kw)
    for kw in (dict(rank=16), dict(rank=8, base_dtype_bytes=1), dict(rank=4, remat_policy="full"),
               dict(rank=16, base_dtype_bytes=4, seq_shards=2)):
        assert tplan.plan_train_lora(tcfg, tmesh_cfg, 8, 1024, hbm_bytes=HBM, port_terms=False,
                                     **kw) == \
            jplan.plan_train_lora(jcfg, jmesh_cfg, 8, 1024, hbm_bytes=HBM, **kw)


def test_plan_of_a_module_matches_jax_params():
    """plan() of a model (on the meta device, or an int8 one) against
    esm_tpu's plan() of the same parameters."""
    import jax

    from esm_tpu.quantization import quantize_params as jquantize
    from esm_tpu_torch.quantization import quantize_params

    jcfg, tcfg = _lm_cfgs("esm2_t6_8M_UR50D")
    params = jesm2.init(jax.random.PRNGKey(0), jcfg)
    model = tesm2.init(tcfg, torch.Generator(), device="cpu")
    for shape in ((1, 1, 1), (1, 2, 2), (2, 1, 4)):
        jm, tm = _mesh_cfgs(shape)
        assert tplan.plan(model, tm) == jplan.plan(params, jm)
        assert tplan.plan(model, tm, dtype_bytes=2) == jplan.plan(params, jm, dtype_bytes=2)
    quantize_params(model, min_size=1)
    for shape in ((1, 1, 1), (2, 2, 2)):
        jm, tm = _mesh_cfgs(shape)
        assert tplan.plan(model, tm) == jplan.plan(jquantize(params, min_size=1), jm)


def test_port_activation_terms():
    """The port's default charges its own activation term (ACT_UNITS): only
    the activations differ from esm_tpu's plan, and the device size
    defaults to the named device's memory."""
    jcfg, tcfg = _lm_cfgs("esm2_t33_650M_UR50D")
    jm, tm = _mesh_cfgs((1, 1, 1))
    want = jplan.plan_train(jcfg, jm, 8, 1024, hbm_bytes=HBM)
    got = tplan.plan_train(tcfg, tm, 8, 1024, hbm_bytes=HBM)
    extra = 33 * (tplan.ACT_UNITS - 10) * 1280 * 1024 * 8 * 2
    assert got["activations_bytes"] - want["activations_bytes"] == extra
    for k in ("params_bytes", "optimizer_bytes", "grads_bytes"):
        assert got[k] == want[k], k
    assert tplan.plan_train(tcfg, tm, 8, 1024, device="cpu")["hbm_bytes"] == \
        tplan.device_memory_bytes("cpu")


@pytest.mark.parametrize("shape", [(1, 1, 1), (1, 4, 1), (1, 4, 2), (2, 2, 2)])
def test_port_terms_on_an_fsdp_mesh(shape):
    """The port's terms beside esm_tpu's formula: an fsdp mesh charges one
    layer's linear weights (their tp shard) gathered twice in the compute
    dtype and its whole gradient (compute dtype, then fp32), a LoRA step
    the frozen base's gathers (int8 or the compute dtype) and
    LORA_ACT_UNITS of activations for esm_tpu's 15; nothing else moves."""
    _, tcfg = _lm_cfgs("esm2_t48_15B_UR50D")
    tcfg = dataclasses.replace(tcfg, compute_dtype=torch.bfloat16)
    _, tm = _mesh_cfgs(shape)
    layer = 12 * 5120 * 5120 // tm.tp
    fsdp = tm.fsdp > 1
    port = tplan.plan_train(tcfg, tm, 8, 1024, hbm_bytes=HBM, mu_dtype_bytes=2)
    plain = tplan.plan_train(tcfg, tm, 8, 1024, hbm_bytes=HBM, mu_dtype_bytes=2,
                             port_terms=False)
    assert port["fsdp_bytes"] == (layer * (2 * 2 + 2 + 4) if fsdp else 0)
    assert port["per_device_bytes"] - plain["per_device_bytes"] == port["fsdp_bytes"]
    assert "fsdp_bytes" not in plain
    b_local = -(-8 // (tm.data * tm.fsdp))
    acts = 48 * (tplan.LORA_ACT_UNITS - 15) * 5120 * 1024 * b_local * 2
    for base_bytes, gathered in ((2, 2), (1, 1)):
        port = tplan.plan_train_lora(tcfg, tm, 8, 1024, rank=16, base_dtype_bytes=base_bytes,
                                     hbm_bytes=HBM)
        plain = tplan.plan_train_lora(tcfg, tm, 8, 1024, rank=16, base_dtype_bytes=base_bytes,
                                      hbm_bytes=HBM, port_terms=False)
        assert port["fsdp_bytes"] == (layer * 2 * gathered if fsdp else 0)
        assert port["activations_bytes"] - plain["activations_bytes"] == acts
        assert port["per_device_bytes"] - plain["per_device_bytes"] == port["fsdp_bytes"] + acts
