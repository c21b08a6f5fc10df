"""Parameter sharding of the port (esm_tpu_torch.parallel.sharding, the
collectives of parallel.tensor_parallel, a sharded esm2.apply and training
step, sharded checkpoints) against esm_tpu on the CPU.

The port's ranks are processes spawned over a gloo group
(tests/_torch_shard_ranks.py, which imports no JAX); esm_tpu runs on its
8-device virtual mesh (tests/conftest.py) with its own shard_params. One
8-rank group runs the (2, 2, 2) mesh, one 4-rank group the (1, 1, 4),
(1, 4, 1), (4, 1, 1) and (1, 2, 2) meshes. The other families (ESM-1,
ESM-1b, ESM-1v, the MSA Transformer) are sharded in
tests/test_torch_shard_family.py; training on a sharded model is in
tests/test_torch_shard_train.py, LoRA on a pipeline in
tests/test_torch_pipeline.py.

Tolerances: esm_tpu's own for a sharded forward, atol 2e-5 and rtol 1e-5
(tests/test_sharding.py:35), for the logits, representations, attention
maps and contacts, the step's loss, gradients and updated parameters.
The flash path (the plain version of K1, and of K2 in the backward) is
held to esm_tpu's exact sharded forward, as tests/test_torch_ring.py does.
The gradients are held against jax.grad of esm_tpu's one-device loss (its
mesh step is marked slow; tests/test_sharding.py shows the two agree); the
global norm the sharded clip sees against optax's; the updated parameters
against esm_tpu's AdamW update, both optimizers given esm_tpu's gradients
(Adam's first step divides each gradient by its magnitude + 1e-8, so fed
each side's own gradients it would turn roundoff-level gradients into
updates of up to the learning rate).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_shard_ranks import checkpoint_body, forward_body, spawn, train_body
from esm_tpu import training as jtraining
from esm_tpu.data import Alphabet as JaxAlphabet
from esm_tpu.models import esm2 as jesm2
from esm_tpu.parallel import memory_plan as jplan
from esm_tpu.parallel import mesh as jmesh
from esm_tpu.parallel import sharding as jsharding
from esm_tpu.quantization import quantize_params as jquantize
from esm_tpu_torch import training
from esm_tpu_torch.data import Alphabet
from esm_tpu_torch.io import checkpoint
from esm_tpu_torch.io.from_jax import esm2_state_dict_from_jax, jax_leaf
from esm_tpu_torch.models import esm2
from esm_tpu_torch.parallel import sharding

SIZE = dict(num_layers=2, embed_dim=64, attention_heads=4)
TOL = dict(atol=2e-5, rtol=1e-5)
MESHES8 = ((2, 2, 2),)
MESHES4 = ((1, 1, 4), (1, 4, 1), (4, 1, 1))
LR = 1e-3


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _lm_setup():
    jalpha = JaxAlphabet.from_architecture("ESM-1b")
    jcfg = jesm2.ESM2Config.from_alphabet(jalpha, **SIZE)
    params = jesm2.init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.RandomState(1)
    params["lm_head"]["bias"] = jnp.asarray(rng.randn(len(jalpha)).astype(np.float32) * 0.1)
    params["contact_head"]["regression"]["kernel"] = jnp.asarray(
        rng.randn(SIZE["num_layers"] * SIZE["attention_heads"], 1).astype(np.float32))
    seqs = [("s%d" % i, "KALTARQQEVFDLIRDHISQTGMPPTRAEIA"[: 8 + 2 * i]) for i in range(8)]
    toks = np.array(jalpha.get_batch_converter(pad_to_multiple=8)(seqs)[2])
    toks[0, 2:5] = jalpha.mask_idx  # token dropout's rescale on a sharded row
    return jcfg, params, toks, esm2_state_dict_from_jax(_np(params), jcfg)


@pytest.fixture(scope="module")
def lm():
    jcfg, params, toks, state_dict = _lm_setup()
    return dict(jcfg=jcfg, params=params, toks=toks, state_dict=state_dict)


def _jax_sharded(lm, shape, params=None, **kw):
    mesh = jmesh.make_mesh(jmesh.MeshConfig(*shape))
    placed = jsharding.shard_params(mesh, lm["params"] if params is None else params)
    toks = jax.device_put(jnp.asarray(lm["toks"]), jsharding.batch_sharding(mesh))
    return _np(jesm2.apply(placed, lm["jcfg"], toks, **kw))


def _want(lm, meshes):
    out = {}
    for shape in meshes:
        res = _jax_sharded(lm, shape, return_representations=True)
        out[shape] = {"logits": _t(res["logits"]), "reps": _t(res["representations"])}
    return out


def _inputs(lm, **kw):
    return dict(size=SIZE, state_dict=lm["state_dict"], tokens=_t(lm["toks"]).long(), **kw)


@pytest.fixture(scope="module")
def forward8(lm, tmp_path_factory):
    whole = _np(jesm2.apply(lm["params"], lm["jcfg"], jnp.asarray(lm["toks"]),
                            need_head_weights=True, return_contacts=True))
    int8 = _jax_sharded(lm, (2, 2, 2), params=jquantize(lm["params"], min_size=1))
    inputs = _inputs(lm, want=_want(lm, MESHES8), int8_mesh=(2, 2, 2), int8_logits=_t(int8["logits"]),
                     maps=(2, 2, 2), attentions=_t(whole["attentions"]),
                     contacts=_t(whole["contacts"]))
    return spawn(forward_body, 8, inputs, tmp_path_factory.mktemp("fwd8"))


@pytest.fixture(scope="module")
def forward4(lm, tmp_path_factory):
    inputs = _inputs(lm, want=_want(lm, MESHES4),
                     uneven=((1, 1, 4), dict(num_layers=1, embed_dim=90, attention_heads=4)))
    return spawn(forward_body, 4, inputs, tmp_path_factory.mktemp("fwd4"))


@pytest.mark.parametrize("shape", MESHES8 + MESHES4)
@pytest.mark.parametrize("path", ["exact", "flash"])
def test_sharded_forward_matches_esm_tpu(forward8, forward4, shape, path):
    for rank, res in enumerate(forward8 if shape in MESHES8 else forward4):
        got = res[f"{shape}/{path}"]
        np.testing.assert_allclose(got["logits"].numpy(), got["want_logits"].numpy(), **TOL,
                                   err_msg=f"rank {rank}")
        np.testing.assert_allclose(got["reps"].numpy(), got["want_reps"].numpy(), **TOL,
                                   err_msg=f"rank {rank}")


def test_sharded_int8_forward_matches_esm_tpu(forward8):
    """Weight-only int8 weights shard (their scales follow the bias rules)
    and the (2, 2, 2) forward equals esm_tpu's sharded int8 forward."""
    for rank, res in enumerate(forward8):
        assert res["int8"]["dtype"] == torch.int8
        np.testing.assert_allclose(res["int8"]["logits"].numpy(),
                                   res["int8"]["want_logits"].numpy(), **TOL,
                                   err_msg=f"rank {rank}")


def test_sharded_attention_maps_and_contacts(forward8):
    """At tp=2 each rank computes half the heads: the maps come back with
    every head, and both contact paths equal esm_tpu's."""
    for rank, res in enumerate(forward8):
        got = res["maps"]
        np.testing.assert_allclose(got["attentions"].numpy(), got["want_attentions"].numpy(),
                                   **TOL, err_msg=f"rank {rank}")
        for key in ("contacts", "streamed"):
            np.testing.assert_allclose(got[key].numpy(), got["want_contacts"].numpy(), **TOL,
                                       err_msg=f"rank {rank} {key}")


@pytest.mark.parametrize("shape", MESHES8 + MESHES4)
def test_resident_bytes_equal_esm_tpu_plan(lm, forward8, forward4, shape):
    """Each rank keeps exactly what esm_tpu's plan charges a device."""
    want = jplan.plan(lm["params"], jmesh.MeshConfig(*shape))["per_device_bytes"]
    for rank, res in enumerate(forward8 if shape in MESHES8 else forward4):
        assert res[f"{shape}/bytes"] == want, rank


def test_uneven_shards_are_refused(forward4):
    for res in forward4:
        assert "does not split evenly" in res["uneven"], res["uneven"]


def test_param_specs_are_esm_tpu_rules(lm):
    """Every entry's spec is esm_tpu's (a linear's weight is its kernel
    transposed), int8 scales included."""
    cfg = esm2.ESM2Config.from_alphabet(Alphabet.from_architecture("ESM-1b"), **SIZE)
    for int8 in (False, True):
        model = esm2.ESM2(cfg, device="meta")
        params = lm["params"]
        if int8:
            from esm_tpu_torch.quantization import quantize_params

            model = esm2.init(cfg, torch.Generator(), device="cpu")
            quantize_params(model, min_size=1)
            params = jquantize(params, min_size=1)
        jspecs = {jax.tree_util.keystr(p, simple=True, separator="."): tuple(s) for p, s in
                  jax.tree_util.tree_leaves_with_path(
                      jsharding.param_specs(params), is_leaf=lambda x: hasattr(x, "index"))}
        for name, spec in sharding.param_specs(model).items():
            if name == "lm_head.weight":
                continue  # the embedding itself
            path, layer = jax_leaf(name)
            owner = model.get_submodule(name.rpartition(".")[0])
            leaf = path[-1]
            if leaf == "weight" and not isinstance(owner, torch.nn.Embedding):
                leaf = "kernel" if isinstance(owner, torch.nn.Linear) else "scale"
            want = jspecs[".".join(path[:-1] + (leaf,))]
            want = want[1:] if layer is not None else want
            want = want + (None,) * (len(spec) - len(want))
            if leaf == "kernel":
                want = want[::-1]
            assert spec == want, (name, spec, want)


# --------------------------------------------------------------------- training

CASES8 = (("222", (2, 2, 2), {}, None),
          ("222-flash-remat-clip", (2, 2, 2), {"use_flash": True, "remat": True}, "bind"))
CASES4 = (("122-clip", (1, 2, 2), {}, "bind"),)


@pytest.fixture(scope="module")
def jax_step(lm):
    """esm_tpu's corruption, jax.grad of its one-device loss, and its AdamW
    update (the decay mask, esm_tpu's make_optimizer) without a clip and
    with a clip at half the gradient norm, so that it binds."""
    jcfg, toks = lm["jcfg"], jnp.asarray(lm["toks"])
    corrupted, target_mask = jtraining._corrupt_batch(jcfg, jax.random.PRNGKey(5), toks)
    (loss, _), grads = jax.value_and_grad(jtraining.mlm_loss, has_aux=True)(
        lm["params"], jcfg, corrupted, toks, target_mask)
    norm = float(optax.global_norm(grads))
    out = dict(corrupted=corrupted, target_mask=target_mask, loss=float(loss), norm=norm,
               grads=esm2_state_dict_from_jax(_np(grads), jcfg), updated={})
    for clip in (None, norm / 2):
        tx = jtraining.make_optimizer(LR, warmup_steps=0, total_steps=10, grad_clip_norm=clip)
        state = jtraining.init_state(jax.tree.map(jnp.array, lm["params"]), tx)
        updates, _ = tx.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        out["updated"][clip is not None] = esm2_state_dict_from_jax(_np(params), jcfg)
    return out


def _train_inputs(lm, jax_step, cases):
    cases = tuple((tag, shape, opts, jax_step["norm"] / 2 if clip else None)
                  for tag, shape, opts, clip in cases)
    return _inputs(lm, corrupted=_t(jax_step["corrupted"]).long(),
                   target_mask=_t(jax_step["target_mask"]), cases=cases,
                   grads=jax_step["grads"])


@pytest.fixture(scope="module")
def train8(lm, jax_step, tmp_path_factory):
    return spawn(train_body, 8, _train_inputs(lm, jax_step, CASES8),
                 tmp_path_factory.mktemp("train8"))


@pytest.fixture(scope="module")
def train4(lm, jax_step, tmp_path_factory):
    return spawn(train_body, 4, _train_inputs(lm, jax_step, CASES4),
                 tmp_path_factory.mktemp("train4"))


@pytest.mark.parametrize("case", CASES8 + CASES4, ids=lambda c: c[0])
def test_sharded_train_step_matches_esm_tpu(jax_step, train8, train4, case):
    """Step 0 on the mesh with esm_tpu's corruption: the loss, the gathered
    gradients against jax.grad of esm_tpu's loss, the global norm (each
    shard once: counting every rank's copy of the replicated parameters
    would inflate it), and the gathered updated parameters against esm_tpu's
    AdamW update with the decay mask (and the clip binding), on every rank."""
    tag, clip = case[0], case[3] is not None
    for rank, res in enumerate(train8 if case in CASES8 else train4):
        got = res[tag]
        np.testing.assert_allclose(got["loss"], jax_step["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["norm"], jax_step["norm"], rtol=1e-5)
        for name, g in got["grads"].items():
            np.testing.assert_allclose(g.numpy(), jax_step["grads"][name].numpy(), **TOL,
                                       err_msg=f"rank {rank} grad {name}")
        want = jax_step["updated"][clip]
        for name, p in got["params"].items():
            np.testing.assert_allclose(p.numpy(), want[name].numpy(), **TOL,
                                       err_msg=f"rank {rank} {name}")
        assert got["loss1"] < got["loss"]  # the second step's loss is lower


# ------------------------------------------------------------------ checkpoints


@pytest.fixture(scope="module")
def saved(lm, jax_step, tmp_path_factory):
    """(1, 2, 2) saves its parameters and train state after one step; the
    parent's one-device save (another model, one step) is loaded onto the
    mesh and returned gathered."""
    tmp = tmp_path_factory.mktemp("ckpt")
    cfg = esm2.ESM2Config.from_alphabet(Alphabet.from_architecture("ESM-1b"), **SIZE)
    model = esm2.init(cfg, torch.Generator().manual_seed(9), device="cpu")
    tx = training.make_optimizer(LR, warmup_steps=0, total_steps=10)
    state = training.init_state(model, tx)
    batch = (_t(jax_step["corrupted"]).long(), _t(lm["toks"]).long(),
             _t(jax_step["target_mask"]))
    state, _ = training.train_step_corrupted(state, cfg, tx, *batch)
    checkpoint.save_params(tmp / "one_device", model)
    checkpoint.save_train_state(tmp / "one_device_state", state)
    inputs = _inputs(lm, corrupted=batch[0], target_mask=batch[2], mesh=(1, 2, 2), dir=str(tmp))
    ranks = spawn(checkpoint_body, 4, inputs, tmp)
    return dict(tmp=tmp, model=model, state=state, cfg=cfg, tx=tx, batch=batch, ranks=ranks)


def _equal_trees(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_checkpoint_from_a_mesh_resumes_on_one_device(saved):
    """The (1, 2, 2) train state resumes on one device bit for bit: the
    parameters and both moments the ranks held, and the step and count."""
    model = esm2.ESM2(saved["cfg"])
    template = checkpoint.load_train_state(saved["tmp"] / "state",
                                           training.init_state(model, saved["tx"]))
    assert template.step == 1 and template.opt_state.count == 1
    for rank, res in enumerate(saved["ranks"]):
        mine = res["saved"]
        _equal_trees(model.state_dict(), mine["params"])
        _equal_trees(template.opt_state.mu, mine["mu"])
        _equal_trees(template.opt_state.nu, mine["nu"])
    _equal_trees(checkpoint.load_params(saved["tmp"] / "params"), model.state_dict())


def test_sharded_save_gathers_one_entry_at_a_time(saved):
    """A rank's gathered whole tensors during the saves never exceed the
    largest entry of the model: the tree is gathered an entry at a time and
    each let go before the next, never the whole model at once; nor do the
    host copies that rank 0 writes (the writer lets each go before the next
    entry is gathered), and the other ranks copy nothing to the host."""
    whole = saved["model"].state_dict()
    largest = max(t.numel() * t.element_size() for t in whole.values())
    total = sum(t.numel() * t.element_size() for t in whole.values())
    for rank, res in enumerate(saved["ranks"]):
        peak = res["saved"]["save_peak_bytes"]
        assert 0 < peak <= largest < total / 4, (rank, peak, largest, total)
        host = res["saved"]["host_peak_bytes"]
        assert (0 < host <= largest) if rank == 0 else host == 0, (rank, host, largest)


def test_checkpoint_from_one_device_loads_onto_a_mesh(saved):
    """The one-device save, loaded onto (1, 2, 2) and gathered back, is the
    same tree bit for bit, moments and counters included."""
    want = saved["model"].state_dict()
    for rank, res in enumerate(saved["ranks"]):
        _equal_trees(res["params"], want)
        _equal_trees(res["mu"], saved["state"].opt_state.mu)
        assert (res["step"], res["count"]) == (1, 1), rank
