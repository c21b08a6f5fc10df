"""The ESM-1 family (ESM-1, ESM-1b, ESM-1v) and the MSA Transformer sharded
over the (data, fsdp, tp) mesh (esm_tpu_torch.parallel.sharding on
models.esm1 and models.msa_transformer; LoRA over their sharded bases;
their checkpoints, plans and refusals; examples.esm2_infer_sharded on
their registry names) against esm_tpu on the CPU.

The port's ranks are processes spawned over gloo (tests/_torch_shard_ranks.py's
``spawn``; the bodies are in tests/_torch_shard_family_ranks.py, which
imports no JAX): one 4-rank group runs the (1, 1, 4), (1, 4, 1), (4, 1, 1)
and (1, 2, 2) meshes. Every oracle is esm_tpu on one device (its sharded
results equal its unsharded ones, tests/test_sharding.py), its weights
carried across with io.from_jax and its adapters with lora_from_jax.

Tolerances: esm_tpu's own for a sharded forward, atol 2e-5 and rtol 1e-5
(tests/test_sharding.py:35), for the logits, representations, attention
maps (row and column for the MSA Transformer), contacts (ESM-1's stacked and
streamed), the flash path (K1's plain version, held to esm_tpu's exact
forward as tests/test_torch_sharding.py holds ESM-2's), the MSA step's loss,
gradients and updated parameters, and the LoRA steps' loss, adapter
gradients and updated adapters; the int8 bases, the merges and the
checkpoints bit for bit.

One divergence is named: ESM-1's bias_kv row (``bias_k``, ``bias_v``) holds
its features over tp, as the keys and values do; esm_tpu replicates it
(ROADMAP Queue 3, "Deliberate divergences"). So a rank's resident bytes are
esm_tpu's plan less (tp - 1) / tp of that row's bytes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_shard_family_ranks import family_body
from _torch_shard_ranks import spawn
from esm_tpu import lora as jlora
from esm_tpu import training as jtraining
from esm_tpu.data import Alphabet as JaxAlphabet
from esm_tpu.models import esm1 as jesm1
from esm_tpu.models import msa_transformer as jmsa
from esm_tpu.parallel import memory_plan as jplan
from esm_tpu.parallel import mesh as jmesh
from esm_tpu.parallel import sharding as jsharding
from esm_tpu.quantization import quantize_params as jquantize
from esm_tpu_torch import training
from esm_tpu_torch.data import Alphabet
from esm_tpu_torch.io import checkpoint
from esm_tpu_torch.io.from_jax import (
    esm1_state_dict_from_jax,
    jax_leaf,
    lora_from_jax,
    msa_state_dict_from_jax,
)
from esm_tpu_torch.models import esm1, msa_transformer
from esm_tpu_torch.parallel import sharding

TOL = dict(atol=2e-5, rtol=1e-5)
MESHES = ((1, 1, 4), (1, 4, 1), (4, 1, 1), (1, 2, 2))
EXTRA_MESH = (1, 2, 2)  # the int8 bases, merges and checkpoints
SIZE = dict(num_layers=2, embed_dim=64, attention_heads=4, ffn_embed_dim=128, max_positions=64)
MSA_SIZE = dict(num_layers=2, embed_dim=64, ffn_embed_dim=128, attention_heads=4)
VERSIONS = {"esm1b": ("ESM-1b", {}), "esm1v": ("ESM-1b", {"token_dropout": True}),
            "esm1": ("ESM-1", {})}
SEQS = ["MKTAYIAKQRQISFVKSHFSRQ", "MKT<mask>YIAK", "GAV<mask>LIEK<mask>W", "KALTARQQEVFD",
        "LIRDHISQ<mask>GMPPTRAE", "AQRLGFRS", "PNAAEEHLKALARK", "GVIEIVSGASRG"]
AAS = "ACDEFGHIKLMNPQRSTVWY"
MSA_CASES = {"msa": (3, 2 ** 14), "msa_chunked": (3, 8), "msa_r1": (1, 2 ** 14)}
LORA = ("esm1b", "msa")
SCALE = 2.0
LR = 1e-3
EXAMPLE_MODELS = ("esm1b_t33_650M_UR50S", "esm1_t6_43M_UR50S", "esm_msa1b_t12_100M_UR50S")


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _esm1_case(tag):
    arch, extra = VERSIONS[tag]
    jalpha = JaxAlphabet.from_architecture(arch)
    jcfg = jesm1.ESM1Config.from_alphabet(jalpha, model_version=arch, **SIZE, **extra)
    params = jesm1.init(jax.random.PRNGKey(len(tag)), jcfg)
    rng = np.random.RandomState(len(tag) + 1)
    n = jcfg.num_layers * jcfg.attention_heads
    params["contact_head"]["regression"]["kernel"] = jnp.asarray(
        rng.randn(n, 1).astype(np.float32))
    params["contact_head"]["regression"]["bias"] = jnp.asarray([0.3], jnp.float32)
    if jcfg.is_1b:
        params["lm_head"]["bias"] = jnp.asarray(rng.randn(jcfg.alphabet_size).astype(np.float32))
    else:
        params["embed_out"]["kernel"] = jnp.asarray(
            (rng.randn(jcfg.embed_dim, jcfg.alphabet_size) / 8).astype(np.float32))
        params["embed_out"]["bias"] = jnp.asarray(rng.randn(jcfg.alphabet_size).astype(np.float32))
    alphabet = Alphabet.from_architecture(arch)
    cfg = esm1.ESM1Config.from_alphabet(alphabet, model_version=arch, **SIZE, **extra)
    tokens = alphabet.get_batch_converter()([(f"s{i}", s) for i, s in enumerate(SEQS)])[2]
    want = _np(jesm1.apply(params, jcfg, jnp.asarray(tokens.numpy()), need_head_weights=True,
                           return_contacts=True, return_representations=True))
    streamed = _np(jesm1.apply(params, jcfg, jnp.asarray(tokens.numpy()), return_contacts=True))
    np.testing.assert_allclose(streamed["contacts"], want["contacts"], atol=1e-6)
    return dict(jcfg=jcfg, params=params, cfg=cfg, tokens=tokens,
                state_dict=esm1_state_dict_from_jax(_np(params), jcfg),
                want={"logits": _t(want["logits"]),
                      "representations": _t(want["representations"]),
                      "attentions": _t(want["attentions"]), "contacts": _t(want["contacts"]),
                      "streamed": _t(want["contacts"])})


def _msa_params():
    jcfg = jmsa.MSATransformerConfig.from_alphabet(
        JaxAlphabet.from_architecture("msa_transformer"), **MSA_SIZE)
    params = jmsa.init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.RandomState(2)
    params["contact_head"]["regression"]["kernel"] = jnp.asarray(
        rng.randn(MSA_SIZE["num_layers"] * MSA_SIZE["attention_heads"], 1).astype(np.float32))
    params["contact_head"]["regression"]["bias"] = jnp.asarray([0.2], jnp.float32)
    params["lm_head"]["bias"] = jnp.asarray(rng.randn(jcfg.alphabet_size).astype(np.float32))
    params["msa_position_embedding"] = params["msa_position_embedding"] * 50  # make it count
    return jcfg, params


def _msa_case(jcfg, params, rows, max_tokens):
    """Four MSAs of ``rows`` rows: two lengths, so columns are padded; with
    3 rows, one MSA of 2 (a padded row)."""
    jcfg = dataclasses.replace(jcfg, max_tokens_per_msa=max_tokens)
    alphabet = Alphabet.from_architecture("msa_transformer")
    cfg = msa_transformer.MSATransformerConfig.from_alphabet(alphabet, **MSA_SIZE,
                                                             max_tokens_per_msa=max_tokens)
    rng = np.random.RandomState(rows)
    msas = []
    for i, (depth, length) in enumerate(((rows, 12), (max(rows - 1, 1), 9), (rows, 12),
                                         (rows, 10))):
        msas.append([(f"m{i}r{j}", "".join(rng.choice(list(AAS), length)))
                     for j in range(depth)])
    tokens = alphabet.get_batch_converter()(msas)[2]
    want = _np(jmsa.apply(params, jcfg, jnp.asarray(tokens.numpy()), return_contacts=True,
                          return_representations=True))
    return dict(jcfg=jcfg, params=params, cfg=cfg, tokens=tokens,
                state_dict=msa_state_dict_from_jax(_np(params), jcfg),
                want={k: _t(want[k]) for k in ("logits", "representations", "row_attentions",
                                                "col_attentions", "contacts")})


def _lora_ref(case, apply_fn, key):
    """esm_tpu's side of a LoRA step over the case's (fp32) base: its
    corruption, seeded adapters (nonzero b), jax.grad of its LoRA loss, the
    AdamW update with a clip at half the gradients' norm (so that it binds)."""
    jcfg, params = case["jcfg"], case["params"]
    toks = jnp.asarray(case["tokens"].numpy())
    corrupted, target_mask = jtraining._corrupt_batch(jcfg, jax.random.PRNGKey(key), toks)
    jad = jlora.init_lora(jax.random.PRNGKey(key + 1), params, rank=4)
    rng = np.random.RandomState(key)
    jad = jax.tree_util.tree_map_with_path(
        lambda path, x: (rng.randn(*x.shape) * 0.05).astype(np.float32)
        if path[-1].key == "lora_b" else np.asarray(x), jad)

    def loss_fn(a):
        patched = jlora.patch(jax.lax.stop_gradient(params), a, scale=SCALE)
        return jtraining.mlm_loss(patched, jcfg, corrupted, toks, target_mask, apply_fn)

    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jad)
    clip = float(optax.global_norm(grads)) / 2
    tx = jtraining.make_optimizer(LR, warmup_steps=0, total_steps=10, grad_clip_norm=clip)
    updated = optax.apply_updates(jad, tx.update(grads, tx.init(jad), jad)[0])
    cls = esm1.ESM1 if apply_fn is jesm1.apply else msa_transformer.MSATransformer
    model = cls(case["cfg"])
    adapters = lora_from_jax(jad, model)
    return dict(corrupted=_t(corrupted).long(), target_mask=_t(target_mask), clip=clip,
                loss=float(loss), jad=jad,
                adapters={p: (a.lora_a.detach(), a.lora_b.detach())
                          for p, a in adapters.adapters()},
                grads=lora_from_jax(_np(grads), model).state_dict(),
                updated=lora_from_jax(_np(updated), model).state_dict())


def _msa_step_ref(case):
    """esm_tpu's corruption of the MSAs, jax.grad of its MLM loss and its
    AdamW update (decay mask, a binding clip)."""
    jcfg, params = case["jcfg"], case["params"]
    toks = jnp.asarray(case["tokens"].numpy())
    corrupted, target_mask = jtraining._corrupt_batch(jcfg, jax.random.PRNGKey(7), toks)
    def loss_fn(p):
        return jtraining.mlm_loss(p, jcfg, corrupted, toks, target_mask, jmsa.apply)

    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    norm = float(optax.global_norm(grads))
    tx = jtraining.make_optimizer(LR, warmup_steps=0, total_steps=10, grad_clip_norm=norm / 2)
    state = jtraining.init_state(jax.tree.map(jnp.array, params), tx)
    updates, _ = tx.update(grads, state.opt_state, state.params)
    updated = optax.apply_updates(state.params, updates)
    return dict(corrupted=_t(corrupted).long(), target_mask=_t(target_mask), clip=norm / 2,
                loss=float(loss), norm=norm,
                grads=msa_state_dict_from_jax(_np(grads), jcfg),
                updated=msa_state_dict_from_jax(_np(updated), jcfg))


@pytest.fixture(scope="module")
def ref():
    cases = {tag: _esm1_case(tag) for tag in VERSIONS}
    jcfg, params = _msa_params()
    for tag, (rows, max_tokens) in MSA_CASES.items():
        cases[tag] = _msa_case(jcfg, params, rows, max_tokens)
    return dict(cases=cases, msa_step=_msa_step_ref(cases["msa"]),
                lora={"esm1b": _lora_ref(cases["esm1b"], jesm1.apply, 11),
                      "msa": _lora_ref(cases["msa"], jmsa.apply, 13)})


def _port_case(case):
    return {k: case[k] for k in ("cfg", "state_dict", "tokens", "want")}


def _one_device_saves(ref, tmp):
    """The parent's one-device saves: ESM-1's parameters (another seed) and
    the MSA Transformer's AdamW train state after one step."""
    cfg = ref["cases"]["esm1"]["cfg"]
    model = esm1.init(cfg, torch.Generator().manual_seed(9), device="cpu")
    checkpoint.save_params(tmp / "one_device_esm1", model)
    case, step = ref["cases"]["msa"], ref["msa_step"]
    msa = msa_transformer.init(case["cfg"], torch.Generator().manual_seed(9), device="cpu")
    tx = training.make_optimizer(LR, warmup_steps=0, total_steps=10)
    state = training.init_state(msa, tx)
    state, _ = training.train_step_corrupted(state, case["cfg"], tx, step["corrupted"],
                                             case["tokens"], step["target_mask"],
                                             apply_fn=msa_transformer.apply)
    checkpoint.save_train_state(tmp / "one_device_msa_state", state)
    return {"esm1": model.state_dict(),
            "msa": {"params": state.model.state_dict(), "mu": state.opt_state.mu}}


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("family")
    one = _one_device_saves(ref, tmp)
    msa_step = {k: ref["msa_step"][k] for k in ("corrupted", "target_mask", "clip", "grads")}
    lora = {tag: {k: ref["lora"][tag][k] for k in ("corrupted", "target_mask", "clip",
                                                   "adapters", "grads")} for tag in LORA}
    example = [["--random-seed", "0", "--cpu", "--model", name] for name in EXAMPLE_MODELS]
    inputs = dict(cases={tag: _port_case(c) for tag, c in ref["cases"].items()}, meshes=MESHES,
                  flash=("esm1b", "esm1"), msa_step=msa_step, lora=lora, scale=SCALE,
                  extra_mesh=EXTRA_MESH, dir=str(tmp), example=example)
    return dict(ranks=spawn(family_body, 4, inputs, tmp), tmp=tmp, one=one)


def _close(got, want, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL, err_msg=what)


def _equal_trees(a, b, what=""):
    assert a.keys() == b.keys(), what
    for k in a:
        assert torch.equal(a[k], b[k]), (what, k)


# ------------------------------------------------------------------ forwards


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("tag", list(VERSIONS) + list(MSA_CASES))
def test_sharded_family_forward_matches_esm_tpu(ranks, shape, tag):
    """ESM-1b, ESM-1 (its bias_kv row a tp rank's features), ESM-1v (<mask>
    tokens on sharded rows), the MSA Transformer unchunked, chunked and at
    R = 1: every output on every rank against esm_tpu's one-device apply
    (the attention maps carry every head)."""
    for rank, res in enumerate(ranks["ranks"]):
        got = res[f"{shape}/{tag}"]
        assert got["got"].keys() == got["want"].keys()
        for key in got["want"]:
            _close(got["got"][key], got["want"][key], f"rank {rank} {key}")


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("tag", ("esm1b", "esm1"))
def test_sharded_family_flash_forward_matches_esm_tpu(ranks, shape, tag):
    """The flash path (K1's plain version on a tp rank's heads; ESM-1 at
    S = T + 1 with this rank's slice of the bias_kv key) against esm_tpu's
    exact forward."""
    for rank, res in enumerate(ranks["ranks"]):
        got = res[f"{shape}/{tag}/flash"]
        for key in got["want"]:
            _close(got["got"][key], got["want"][key], f"rank {rank} {key}")


# ------------------------------------------------------------ specs and bytes


def _jax_specs(params):
    return {jax.tree_util.keystr(p, simple=True, separator="."): tuple(s) for p, s in
            jax.tree_util.tree_leaves_with_path(jsharding.param_specs(params),
                                                is_leaf=lambda x: hasattr(x, "index"))}


# the port's names of ESM-1's untied output projection, as esm_tpu's leaves
ESM1_HEAD = {"embed_out": "embed_out.kernel", "embed_out_bias": "embed_out.bias"}


@pytest.mark.parametrize("tag", ["esm1b", "esm1", "msa"])
def test_family_specs_are_esm_tpu_rules(ref, tag):
    """Every entry's spec is esm_tpu's spec_for_param of its leaf (a linear's
    weight its kernel transposed, stacked layers' leading axis dropped), but
    ESM-1's bias_k/bias_v, split over tp where esm_tpu replicates them."""
    case = ref["cases"][tag]
    cls = esm1.ESM1 if tag.startswith("esm1") else msa_transformer.MSATransformer
    model = cls(case["cfg"], device="meta")
    jspecs = _jax_specs(case["params"])
    diverged = []
    for name, spec in sharding.param_specs(model).items():
        if name == "lm_head.weight":
            continue  # the embedding itself
        path, layer = jax_leaf(name)
        key = ESM1_HEAD.get(name)
        if key is None:
            owner = model.get_submodule(name.rpartition(".")[0])
            leaf = path[-1]
            if leaf == "weight" and not isinstance(owner, torch.nn.Embedding):
                leaf = "kernel" if isinstance(owner, torch.nn.Linear) else "scale"
            key = ".".join(map(str, path[:-1] + (leaf,)))
        want = jspecs[key]
        want = want[1:] if layer is not None else want
        want = want + (None,) * (len(spec) - len(want))
        if key.endswith("kernel") and len(spec) == 2:
            want = want[::-1]
        if path[-1] in ("bias_k", "bias_v"):
            assert all(a is None for a in want) and spec == (None, None, "tp"), (name, spec)
            diverged.append(name)
            continue
        assert spec == want, (name, spec, want)
    assert len(diverged) == (2 * SIZE["num_layers"] if tag == "esm1" else 0), diverged


def _bias_kv_term(model, tp):
    """Bytes a rank holds less than esm_tpu's plan: (tp - 1) / tp of ESM-1's
    bias_kv rows."""
    return sum(p.numel() * p.element_size() * (tp - 1) // tp
               for n, p in model.named_parameters() if n.endswith(("bias_k", "bias_v")))


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("tag", ["esm1b", "esm1", "msa"])
def test_family_resident_bytes_equal_esm_tpu_plan(ref, ranks, shape, tag):
    """Each rank keeps what esm_tpu's plan charges a device (less the bias_kv
    divergence), and what the port's memory_plan.plan of the model says."""
    case = ref["cases"][tag]
    cls = esm1.ESM1 if tag.startswith("esm1") else msa_transformer.MSATransformer
    want = (jplan.plan(case["params"], jmesh.MeshConfig(*shape))["per_device_bytes"]
            - _bias_kv_term(cls(case["cfg"], device="meta"), shape[2]))
    for rank, res in enumerate(ranks["ranks"]):
        got = res[f"{shape}/{tag}"]
        assert got["bytes"] == got["plan"] == want, (rank, got["bytes"], got["plan"], want)


# ----------------------------------------------------------------- training


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_msa_step_matches_esm_tpu(ref, ranks, shape):
    """train_step_msa's step 0 on the mesh with esm_tpu's corruption: the
    loss, the gathered gradients against jax.grad of esm_tpu's loss, the
    global norm the clip sees (Sharding.norm_sq), the gathered parameters
    after AdamW's update (decay mask, binding clip) on esm_tpu's gradients;
    the next step's loss is lower and train_step_msa runs on the mesh."""
    step = ref["msa_step"]
    for rank, res in enumerate(ranks["ranks"]):
        got = res[f"{shape}/msa_step"]
        np.testing.assert_allclose(got["loss"], step["loss"], **TOL)
        np.testing.assert_allclose(got["norm"], step["norm"], **TOL)
        for name, g in got["grads"].items():
            _close(g, step["grads"][name], f"rank {rank} grad {name}")
        for name, p in got["params"].items():
            _close(p, step["updated"][name], f"rank {rank} {name}")
        assert got["loss1"] < got["loss"] and np.isfinite(got["msa_step_loss"])


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("tag", LORA)
def test_sharded_family_lora_step_matches_esm_tpu(ref, ranks, shape, tag):
    """LoRA over a sharded ESM-1b and MSA Transformer base, step 0 with
    esm_tpu's corruption and adapters: the loss and the adapter gradients
    (summed over the mesh) against jax.grad of esm_tpu's LoRA loss, the
    adapters after AdamW's update (binding clip) against optax's; the next
    step's loss is lower."""
    want = ref["lora"][tag]
    for rank, res in enumerate(ranks["ranks"]):
        got = res[f"{shape}/lora/{tag}"]
        np.testing.assert_allclose(got["loss"], want["loss"], **TOL)
        assert got["grads"].keys() == want["grads"].keys()
        for name, g in got["grads"].items():
            _close(g, want["grads"][name], f"rank {rank} grad {name}")
        for name, p in got["updated"].items():
            _close(p, want["updated"][name], f"rank {rank} {name}")
        assert got["loss1"] < got["loss"]


@pytest.mark.parametrize("tag", LORA)
def test_sharded_family_int8_base_and_merge(ref, ranks, tag):
    """On (1, 2, 2): the int8 base quantized on the shards equals esm_tpu's
    quantize_params of the whole tree bit for bit; lora.merge over the
    sharded base gathers to the unsharded merge bit for bit."""
    case = ref["cases"][tag]
    to_sd = esm1_state_dict_from_jax if tag.startswith("esm1") else msa_state_dict_from_jax
    int8 = to_sd(_np(jquantize(case["params"], min_size=1)), case["jcfg"])
    results = ranks["ranks"]
    for rank, res in enumerate(results):
        got = res[f"base/{tag}"]
        quantized = [n for n, t in got["int8"].items() if t.dtype == torch.int8]
        assert quantized, "nothing quantized"
        for name, t in got["int8"].items():
            if name.endswith("scale") or t.dtype == torch.int8:
                assert torch.equal(t, int8[name]), (rank, name)
        _equal_trees(got["merged"], results[0][f"base/{tag}"]["unsharded_merge"],
                     f"rank {rank} merge")


# --------------------------------------------------------------- checkpoints


def test_family_checkpoints_reload_on_one_device(ref, ranks):
    """ESM-1's parameters and the MSA Transformer's AdamW train state, saved
    from (1, 2, 2), reload on one device bit for bit; the one-device saves
    load onto the mesh and gather back bit for bit."""
    tmp, results = ranks["tmp"], ranks["ranks"]
    cfg = ref["cases"]["esm1"]["cfg"]
    saved = results[0]["checkpoints"]
    one = checkpoint.load_params(tmp / "esm1_params", esm1.ESM1(cfg))
    _equal_trees(one.state_dict(), saved["esm1"], "esm1")
    msa_cfg = ref["cases"]["msa"]["cfg"]
    tx = training.make_optimizer(LR, warmup_steps=0, total_steps=10)
    state = checkpoint.load_train_state(
        tmp / "msa_state", training.init_state(msa_transformer.MSATransformer(msa_cfg), tx))
    assert state.step == 1 and state.opt_state.count == 1
    _equal_trees(state.model.state_dict(), saved["msa"]["params"], "msa params")
    _equal_trees(state.opt_state.mu, saved["msa"]["mu"], "msa mu")
    _equal_trees(state.opt_state.nu, saved["msa"]["nu"], "msa nu")
    for rank, res in enumerate(results):
        got = res["checkpoints"]
        _equal_trees(got["esm1"], saved["esm1"], f"rank {rank}")
        _equal_trees(got["esm1_loaded"], ranks["one"]["esm1"], f"rank {rank} esm1 loaded")
        loaded = got["msa_loaded"]
        _equal_trees(loaded["params"], ranks["one"]["msa"]["params"], f"rank {rank} msa")
        _equal_trees(loaded["mu"], ranks["one"]["msa"]["mu"], f"rank {rank} msa mu")
        assert (loaded["step"], loaded["count"]) == (1, 1), rank


# ----------------------------------------------------------------- refusals


def test_families_refuse_a_pipeline_and_the_ring(ranks):
    """esm_tpu pipelines ESM-2 alone and runs the ring on ESM-2 alone: a pp
    mesh refuses ESM-1b and the MSA Transformer, the ring ESM-1."""
    for res in ranks["ranks"]:
        got = res["refusals"]
        for tag in ("esm1b", "msa"):
            assert "pipeline ('pp') mesh takes ESM-2 only" in got[tag], got[tag]
        assert "runs ESM-2 only" in got["ring"], got["ring"]


def test_unsupported_models_are_refused():
    """shard_params takes the language models only."""
    with pytest.raises(TypeError, match="parameter sharding takes"):
        sharding.shard_params(torch.nn.Linear(2, 2), mesh=None)


# ------------------------------------------------------------------ example


def test_sharded_example_runs_the_esm1_family(ranks):
    """examples.esm2_infer_sharded on the 4 ranks (the default mesh, tp=4)
    with seeded ESM-1b at its released size and a seeded ESM-1 (t6): rank 0
    prints each sequence's finite mean-embedding norm; an MSA Transformer's
    name is refused with a pointer to the API."""
    logs = ranks["ranks"][0]["example"]
    for log in logs[:2]:
        norms = [float(line.rsplit(":", 1)[1]) for line in log.splitlines()
                 if "mean embedding norm" in line]
        assert len(norms) == 2 and np.isfinite(norms).all(), log
    for res in ranks["ranks"]:
        assert "is an MSA Transformer" in res["example"][2]
        assert "msa_transformer.apply" in res["example"][2]
    assert ranks["ranks"][1]["example"][0] == ""  # rank 0 alone prints


def test_esm1_init_parts_draws_init(ref):
    """esm1.init_parts yields init's weights, one layer at a time."""
    for tag in ("esm1b", "esm1"):
        cfg = ref["cases"][tag]["cfg"]
        whole = esm1.init(cfg, torch.Generator().manual_seed(4), device="cpu")
        parts = esm1.init_parts(cfg, torch.Generator().manual_seed(4), device="cpu")
        _, shell = next(parts)
        shell.layers.extend(parts)
        _equal_trees(shell.state_dict(), whole.state_dict(), tag)
