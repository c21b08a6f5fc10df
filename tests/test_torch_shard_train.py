"""Training on a sharded model (the port's LoRA over a sharded base, adafactor
on shards, checkpoints of sharded and pipeline-sharded states, cli.pretrain's
--lora and --adafactor on a mesh) against esm_tpu on the CPU.

The port's ranks are processes spawned over gloo (tests/_torch_shard_ranks.py,
which imports no JAX): one 8-rank group runs the (2, 2, 2) mesh, one 4-rank
group the (1, 1, 4), (1, 4, 1), (4, 1, 1) and (1, 2, 2) meshes, pp=2 of
(pp, data, fsdp, tp) = (2, 1, 1, 2), the checkpoints and the CLI. esm_tpu
runs on one device (its sharded results equal its unsharded ones,
tests/test_sharding.py), its weights carried across with
esm2_state_dict_from_jax and its adapters with lora_from_jax.

Tolerances: the LoRA step's loss, adapter gradients and updated adapters
against jax.grad of esm_tpu's LoRA loss (exact path, fp32 compute over the
bf16 base; the flash path with remat, the plain K1 and K2, held to it as
tests/test_torch_sharding.py holds the flash forward) at atol 2e-5, rtol
1e-5 (tests/test_sharding.py:35); over the int8 base 1e-4
(tests/test_torch_lora.py), its int8 values and scales equal to esm_tpu's
quantize_params of the whole tree. Adafactor's parameters after three steps
on esm_tpu's gradients against optax.adafactor at atol 1e-6
(tests/test_torch_trainers.py:306), its statistics against the unsharded
port's at rtol 1e-5. Checkpoints bit for bit. cli.pretrain's mesh runs
against one process at rtol 1e-5 (tests/test_torch_pretrain_mesh.py), their
resumed runs bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_shard_ranks import shard_train_body, spawn
from esm_tpu import lora as jlora
from esm_tpu import training as jtraining
from esm_tpu.data import Alphabet as JaxAlphabet
from esm_tpu.models import esm2 as jesm2
from esm_tpu.quantization import quantize_params as jquantize
from esm_tpu_torch import training
from esm_tpu_torch.cli import pretrain
from esm_tpu_torch.data import Alphabet
from esm_tpu_torch.io import checkpoint
from esm_tpu_torch.io.from_jax import esm2_state_dict_from_jax, lora_from_jax
from esm_tpu_torch.models import esm2

SIZE = dict(num_layers=2, embed_dim=64, attention_heads=4)
# the LoRA steps' model: without token dropout. Over a bf16 table the port
# rescales the embedding of a row with <mask> tokens in bf16 where XLA fuses
# the rescale in fp32: 1.8e-4 of the loss apart on one device, with or
# without a mesh; without the rescale the two agree to fp32 rounding
LORA_SIZE = dict(SIZE, token_dropout=False)
SIZE128 = dict(num_layers=2, embed_dim=128, attention_heads=4)
TOL = dict(atol=2e-5, rtol=1e-5)
INT8_TOL = dict(atol=1e-4, rtol=0)
MESHES8 = ((2, 2, 2),)
MESHES4 = ((1, 1, 4), (1, 4, 1), (4, 1, 1), (1, 2, 2))
PP = (2, 1, 1, 2)
VARIANTS = ("bf16", "flash", "int8")
SCALE = 2.0
ADAFACTOR = dict(weight_decay=0.01, warmup_steps=1, total_steps=10, grad_clip_norm=1.0,
                 factored=True)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def ref():
    """esm_tpu's side: the 64-wide LM, its corruption, seeded adapters
    (nonzero b) and jax.grad of its LoRA loss over the bf16 and the int8
    base, with the AdamW update of the adapters on those gradients (a clip
    at half the bf16 gradients' norm, so that it binds); the 128-wide LM and
    three adafactor updates on seeded gradients. Each JAX function is
    jitted: run op by op it takes twice as long."""
    jalpha = JaxAlphabet.from_architecture("ESM-1b")
    jcfg = jesm2.ESM2Config.from_alphabet(jalpha, **LORA_SIZE)
    params = jax.jit(jesm2.init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    rng = np.random.RandomState(1)
    params["lm_head"]["bias"] = jnp.asarray(rng.randn(len(jalpha)).astype(np.float32) * 0.1)
    seqs = [("s%d" % i, "KALTARQQEVFDLIRDHISQTGMPPTRAEIA"[: 8 + 2 * i]) for i in range(8)]
    toks = np.array(jalpha.get_batch_converter(pad_to_multiple=8)(seqs)[2])
    corrupted, target_mask = jax.jit(jtraining._corrupt_batch, static_argnums=0)(
        jcfg, jax.random.PRNGKey(5), jnp.asarray(toks))
    jad = jax.jit(functools.partial(jlora.init_lora, rank=4))(jax.random.PRNGKey(1), params)
    jad = jax.tree_util.tree_map_with_path(
        lambda path, x: (rng.randn(*x.shape) * 0.05).astype(np.float32)
        if path[-1].key == "lora_b" else np.asarray(x), jad)
    bases = {False: jax.tree.map(lambda x: x.astype(jnp.bfloat16), params),
             True: jquantize(params, min_size=1)}
    state_dict = esm2_state_dict_from_jax(_np(params), jcfg)
    model = esm2.ESM2(esm2.ESM2Config.from_alphabet(Alphabet.from_architecture("ESM-1b"), **SIZE))
    model.load_state_dict(state_dict)
    out = dict(toks=toks, corrupted=corrupted, target_mask=target_mask, state_dict=state_dict,
               adapters=lora_from_jax(jad, model).state_dict(), loss={}, grads={}, updated={},
               int8_base=esm2_state_dict_from_jax(_np(bases[True]), jcfg))
    def loss_fn(a, base):
        patched = jlora.patch(jax.lax.stop_gradient(base), a, scale=SCALE)
        return jtraining.mlm_loss(patched, jcfg, corrupted, jnp.asarray(toks), target_mask)

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    grads = {int8: value_and_grad(jad, base) for int8, base in bases.items()}
    out["clip"] = clip = float(optax.global_norm(grads[False][1])) / 2
    tx = jtraining.make_optimizer(1e-3, warmup_steps=0, total_steps=10, grad_clip_norm=clip)
    update = jax.jit(lambda g: optax.apply_updates(jad, tx.update(g, tx.init(jad), jad)[0]))
    for int8, ((loss, _), g) in grads.items():
        out["loss"][int8] = float(loss)
        out["grads"][int8] = lora_from_jax(_np(g), model).state_dict()
        out["updated"][int8] = lora_from_jax(_np(update(g)), model).state_dict()

    jcfg128 = jesm2.ESM2Config.from_alphabet(jalpha, **SIZE128)
    params128 = jax.jit(jesm2.init, static_argnums=1)(jax.random.PRNGKey(2), jcfg128)
    grads = [jax.tree.map(lambda x: rng.randn(*x.shape).astype(np.float32), params128)
             for _ in range(3)]
    tx = jtraining.make_optimizer(1e-2, **ADAFACTOR)

    @jax.jit
    def update(g, opt, p):
        updates, opt = tx.update(g, opt, p)
        return optax.apply_updates(p, updates), opt

    jp, opt = params128, tx.init(params128)
    for g in grads:
        jp, opt = update(g, opt, jp)
    out.update(state_dict128=esm2_state_dict_from_jax(_np(params128), jcfg128),
               adafactor_grads=[esm2_state_dict_from_jax(_np(g), jcfg128) for g in grads],
               adafactor_params=esm2_state_dict_from_jax(_np(jp), jcfg128))
    return out


def _inputs(ref, **kw):
    return dict(size=SIZE, lora_size=LORA_SIZE, size128=SIZE128, state_dict=ref["state_dict"],
                state_dict128=ref["state_dict128"], tokens=_t(ref["toks"]).long(),
                corrupted=_t(ref["corrupted"]).long(), target_mask=_t(ref["target_mask"]),
                adapters=_factors(ref["adapters"]),
                lora_grads=ref["grads"], clip=ref["clip"], scale=SCALE,
                lora_variants=VARIANTS, adafactor_grads=ref["adafactor_grads"], **kw)


def _factors(state_dict):
    """{adapter path: (lora_a, lora_b)} of a LoRA module's state dict."""
    paths = dict.fromkeys(n.rpartition(".")[0] for n in state_dict)
    return {p: (state_dict[f"{p}.lora_a"], state_dict[f"{p}.lora_b"]) for p in paths}


def _one_device_adafactor(ref):
    """The unsharded port's three adafactor steps on the same gradients."""
    cfg = esm2.ESM2Config.from_alphabet(Alphabet.from_architecture("ESM-1b"), **SIZE128)
    model = esm2.ESM2(cfg)
    model.load_state_dict(ref["state_dict128"])
    tx = training.make_optimizer(1e-2, **ADAFACTOR)
    state = training.init_state(model, tx)
    for grads in ref["adafactor_grads"]:
        for name, p in model.named_parameters():
            p.grad = grads[name].clone()
        tx.update(model, state.opt_state)
    model.zero_grad(set_to_none=True)
    state.step = 3
    return state, tx


# ------------------------------------------------------------------ cli inputs

CLI_ARGS = ["--num-layers", "2", "--embed-dim", "128", "--attention-heads", "4",
            "--toks-per-batch", "512", "--truncation-seq-length", "62", "--log-every", "1",
            "--warmup-steps", "1", "--cpu", "--grad-clip", "1.0", "--steps", "4",
            "--lr", "1e-3"]
CLI_VARIANTS = {"lora": (["--lora", "4"], ["--data", "2", "--fsdp", "2", "--tp", "1"]),
                "lora-int8": (["--lora", "4", "--lora-int8-base"], ["--fsdp", "4", "--data", "1",
                                                                     "--tp", "1"]),
                "adafactor": (["--adafactor"], [])}


def _fasta(path, n, seed):
    """``n`` sequences of one length: every batch of 512 tokens holds 8 rows,
    which the (data, fsdp) rows of any 4-rank mesh divide, so no run pads
    its batches and the mesh runs see the one-process batches."""
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for i in range(n):
            f.write(f">seq{i}\n{''.join(rng.choice(list('ACDEFGHIKLMNPQRSTVWY'), 62))}\n")
    return str(path)


def _one_process(argv):
    losses = []
    real = {name: getattr(training, name) for name in ("train_step", "train_step_lora")}

    def recording(fn):
        def step(*a, **k):
            state, metrics = fn(*a, **k)
            losses.append(metrics["loss"].item())
            return state, metrics
        return step

    for name, fn in real.items():
        setattr(training, name, recording(fn))
    try:
        pretrain.run(pretrain.create_parser().parse_args(argv))
    finally:
        for name, fn in real.items():
            setattr(training, name, fn)
    return losses


def _old_layout_state(ref, directory):
    """A train state as earlier versions wrote it: one torch.save file of the
    whole tree (AdamW after one step of the 64-wide model)."""
    cfg = esm2.ESM2Config.from_alphabet(Alphabet.from_architecture("ESM-1b"), **SIZE)
    model = esm2.ESM2(cfg)
    model.load_state_dict(ref["state_dict"])
    tx = training.make_optimizer(1e-3, warmup_steps=0, total_steps=10)
    state = training.init_state(model, tx)
    state, _ = training.train_step_corrupted(state, cfg, tx, _t(ref["corrupted"]).long(),
                                             _t(ref["toks"]).long(), _t(ref["target_mask"]))
    directory.mkdir()
    opt = state.opt_state
    torch.save({"params": {k: v.clone() for k, v in model.state_dict().items()},
                "opt_state": {"count": opt.count, "mu": opt.mu, "nu": opt.nu},
                "step": state.step}, directory / checkpoint.STATE_FILE)
    return state, tx


@pytest.fixture(scope="module")
def ranks8(ref, tmp_path_factory):
    inputs = _inputs(ref, lora_meshes=MESHES8, adafactor_meshes=MESHES8)
    return spawn(shard_train_body, 8, inputs, tmp_path_factory.mktemp("shard_train8"))


@pytest.fixture(scope="module")
def ranks4(ref, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shard_train4")
    fasta = _fasta(tmp / "train.fasta", 24, seed=0)
    base = ["--fasta", fasta] + CLI_ARGS
    one, runs = {}, []
    for name, (flags, mesh) in CLI_VARIANTS.items():
        one[name] = _one_process(base + flags)
        ck = ["--checkpoint-dir", str(tmp / name)]
        half = ["--checkpoint-dir", str(tmp / f"{name}-resumed")]
        runs += [base + flags + mesh + ck + ["--save-every", "4"],
                 base + flags + mesh + half + ["--save-every", "2", "--stop-after", "2"],
                 base + flags + mesh + half + ["--save-every", "2", "--resume"]]
    old_state = _old_layout_state(ref, tmp / "old")
    inputs = _inputs(ref, lora_meshes=MESHES4, adafactor_meshes=((1, 2, 2),), adafactor_pp=PP,
                     dir=str(tmp), old_layout=str(tmp / "old"), cli={"runs": runs})
    ranks = spawn(shard_train_body, 4, inputs, tmp)
    return dict(ranks=ranks, tmp=tmp, one=one, old_state=old_state)


def _ranks(ranks8, ranks4, shape):
    return ranks8 if shape in MESHES8 else ranks4["ranks"]


# ----------------------------------------------------------------- LoRA steps


@pytest.mark.parametrize("shape", MESHES8 + MESHES4)
@pytest.mark.parametrize("variant", VARIANTS)
def test_sharded_lora_step_matches_esm_tpu(ref, ranks8, ranks4, shape, variant):
    """Step 0 of the LoRA step over a sharded base with esm_tpu's corruption
    and adapters, on every rank: the loss and the adapter gradients (whole,
    summed over the mesh) against jax.grad of esm_tpu's LoRA loss, the
    adapters after AdamW's update (a binding clip, on esm_tpu's gradients)
    against optax's; the next step's loss is lower."""
    int8 = variant == "int8"
    tol = INT8_TOL if int8 else TOL
    for rank, res in enumerate(_ranks(ranks8, ranks4, shape)):
        got = res[f"lora/{shape}/{variant}"]
        np.testing.assert_allclose(got["loss"], ref["loss"][int8], **tol)
        assert got["grads"].keys() == ref["grads"][int8].keys()
        for name, g in got["grads"].items():
            np.testing.assert_allclose(g.numpy(), ref["grads"][int8][name].numpy(), **tol,
                                       err_msg=f"rank {rank} grad {name}")
        for name, p in got["updated"].items():
            np.testing.assert_allclose(p.numpy(), ref["updated"][int8][name].numpy(), **TOL,
                                       err_msg=f"rank {rank} {name}")
        assert got["loss1"] < got["loss"]


@pytest.mark.parametrize("shape", MESHES8 + MESHES4)
def test_sharded_int8_base_is_esm_tpu_quantization(ref, ranks8, ranks4, shape):
    """store_base's int8 path on shards: the gathered int8 values and scales
    equal esm_tpu's quantize_params of the whole tree bit for bit (each
    row's scale is its whole row's absmax, over the ranks that split it)."""
    want = ref["int8_base"]
    for rank, res in enumerate(_ranks(ranks8, ranks4, shape)):
        base = res[f"lora/{shape}/int8"]["base"]
        for name, t in base.items():
            if name.endswith(".scale") or t.dtype == torch.int8:
                assert torch.equal(t, want[name]), (rank, name)
        assert base["layers.0.self_attn.q_proj.weight"].dtype == torch.int8


# ------------------------------------------------------------------- adafactor


@pytest.mark.parametrize("shape", MESHES8 + ((1, 2, 2), PP))
def test_sharded_adafactor_matches_optax(ref, ranks8, ranks4, shape):
    """Three adafactor steps (weight decay, a binding clip) on the 128-wide
    model, each rank fed its shards of esm_tpu's gradients: the gathered
    parameters against optax.adafactor through esm_tpu's make_optimizer;
    the gathered statistics (v_row, v_col, v, laid out by the state's specs)
    against the unsharded port's."""
    state, _ = _one_device_adafactor(ref)
    opt = state.opt_state
    assert opt.v_row and opt.v_col and not opt.specs
    for rank, res in enumerate(_ranks(ranks8, ranks4, shape)):
        got = res[f"adafactor/{shape}"]
        assert (got["count"], got["step"]) == (3, 3)
        for name, p in got["params"].items():
            if name in ref["adafactor_params"]:
                np.testing.assert_allclose(p.numpy(), ref["adafactor_params"][name].numpy(),
                                           atol=1e-6, err_msg=f"rank {rank} {name}")
        for key, want in training.tensor_fields(opt).items():
            assert got[key].keys() == want.keys(), key
            for name, t in want.items():
                np.testing.assert_allclose(got[key][name].numpy(), t.numpy(), rtol=1e-5,
                                           atol=0, err_msg=f"rank {rank} {key} {name}")


# ----------------------------------------------------------------- checkpoints


def _equal_trees(a, b, what=""):
    assert a.keys() == b.keys(), what
    for k in a:
        assert torch.equal(a[k], b[k]), (what, k)


def _state_tree(state):
    out = {"params": state.model.state_dict(), "count": state.opt_state.count,
           "step": state.step}
    out.update(training.tensor_fields(state.opt_state))
    return out


def _equal_states(got, want, what):
    for key in want:
        if isinstance(want[key], dict):
            _equal_trees(got[key], want[key], f"{what} {key}")
        else:
            assert got[key] == want[key], (what, key)


@pytest.mark.parametrize("shape", ((1, 2, 2), PP))
def test_sharded_train_state_reloads_bit_for_bit(ranks4, shape):
    """The (1, 2, 2) and the pp=2 adafactor states, saved (the pipeline's
    stages gathered over pp), reload onto one device and onto the other mesh
    bit for bit: parameters, v_row, v_col, v, count and step."""
    ranks = ranks4["ranks"]
    i = [(1, 2, 2), PP].index(shape)
    other = [(1, 2, 2), PP][1 - i]
    saved = ranks[0][f"adafactor/{shape}"]
    cfg = esm2.ESM2Config.from_alphabet(Alphabet.from_architecture("ESM-1b"), **SIZE128)
    one = training.init_state(esm2.ESM2(cfg), training.make_optimizer(1e-2, **ADAFACTOR))
    checkpoint.load_train_state(ranks4["tmp"] / f"adafactor{i}", one)
    _equal_states(_state_tree(one), saved, "one device")
    for rank, res in enumerate(ranks):
        _equal_states(res[f"adafactor/{shape}"], saved, f"rank {rank} saved")
        _equal_states(res[f"load/{shape}->{other}"], saved, f"rank {rank} onto {other}")


def test_sharded_save_holds_one_entry_on_the_host(ranks4):
    """During a sharded save rank 0's host copies never exceed the largest
    entry, gathered whole entries on any rank neither (the writer lets each
    entry go before the next is gathered); the other ranks copy nothing to
    the host."""
    cfg = esm2.ESM2Config.from_alphabet(Alphabet.from_architecture("ESM-1b"), **SIZE128)
    whole = esm2.ESM2(cfg).state_dict()
    largest = max(t.numel() * t.element_size() for t in whole.values())
    total = sum(t.numel() * t.element_size() for t in whole.values())
    for shape in ((1, 2, 2), PP):
        for rank, res in enumerate(ranks4["ranks"]):
            got = res[f"save/{shape}"]
            assert 0 < got["device_peak"] <= largest < total / 4, (shape, rank, got)
            if rank == 0:
                assert 0 < got["host_peak"] <= largest, (shape, got, largest)
                entries = _count_tensors(checkpoint.read_train_state(
                    ranks4["tmp"] / f"adafactor{[(1, 2, 2), PP].index(shape)}"))
                assert got["host_copies"] == entries > 2 * len(whole), (shape, got, entries)
            else:
                assert got["host_copies"] == 0, (shape, rank, got)


def _count_tensors(node) -> int:
    if isinstance(node, torch.Tensor):
        return 1
    return sum(_count_tensors(v) for v in node.values()) if isinstance(node, dict) else 0


def test_earlier_single_file_train_state_loads(ranks4):
    """A train state in the single-file layout of earlier versions loads onto
    one device and onto a (1, 2, 2) mesh bit for bit."""
    state, tx = ranks4["old_state"]
    cfg = esm2.ESM2Config.from_alphabet(Alphabet.from_architecture("ESM-1b"), **SIZE)
    one = checkpoint.load_train_state(ranks4["tmp"] / "old",
                                      training.init_state(esm2.ESM2(cfg), tx))
    _equal_trees(one.model.state_dict(), state.model.state_dict(), "one device")
    _equal_trees(one.opt_state.mu, state.opt_state.mu, "one device mu")
    assert (one.step, one.opt_state.count) == (1, 1)
    for rank, res in enumerate(ranks4["ranks"]):
        got = res["old_layout"]
        _equal_trees(got["params"], state.model.state_dict(), f"rank {rank}")
        _equal_trees(got["mu"], state.opt_state.mu, f"rank {rank} mu")
        assert (got["step"], got["count"]) == (1, 1), rank


def test_replicated_lora_state_is_written_once(ref, ranks4):
    """The adapters' AdamW state over a sharded base (whole on every rank) is
    written by rank 0 alone, and reads back as the adapters."""
    copies = [res["lora_save_copies"] for res in ranks4["ranks"]]
    assert copies[0] > 0 and copies[1:] == [0, 0, 0], copies
    blob = checkpoint.read_train_state(ranks4["tmp"] / "lora")
    _equal_trees(blob["params"], ref["adapters"], "adapters")
    assert blob["opt_state"]["count"] == 0 and blob["step"] == 0


def test_sharded_merge_equals_unsharded_merge(ranks4):
    """lora.merge over a (1, 2, 2)-sharded base gives a model sharded alike
    whose gathered state equals the unsharded merge's bit for bit."""
    want = ranks4["ranks"][0]["unsharded_merge"]
    for rank, res in enumerate(ranks4["ranks"]):
        assert res["merged_is_sharded"], rank
        _equal_trees(res["merged"], want, f"rank {rank}")


# ------------------------------------------------------------------------ cli


@pytest.mark.parametrize("variant", list(CLI_VARIANTS))
def test_cli_pretrain_on_a_mesh_matches_one_process(ranks4, variant):
    """--lora 4 on (2, 2, 1), --lora 4 --lora-int8-base on (1, 4, 1) and
    --adafactor on the default mesh (tp=4), 4 ranks: each step's loss within
    1e-5 of the one-process run's (fp32 compute: the sums differ only in
    order). --lora computes in bf16: its losses before the first update
    (step 0 runs at learning rate 0) within 1e-5, the later ones within PR
    14's bf16 rule, 1e-3 (each rank's bf16 adapter gradients are rounded
    before they are summed, and Adam's update, g / (|g| + eps), moves an
    element by the whole rate wherever the tiny gradients differ in sign);
    rank 0 prints the plan of its optimizer."""
    i = list(CLI_VARIANTS).index(variant)
    for rank, res in enumerate(ranks4["ranks"]):
        got, want = res["cli"]["runs"][3 * i]["losses"], ranks4["one"][variant]
        assert len(got) == len(want) == 4
        exact = 2 if variant.startswith("lora") else 4
        np.testing.assert_allclose(got[:exact], want[:exact], rtol=1e-5, err_msg=f"rank {rank}")
        np.testing.assert_allclose(got, want, rtol=1e-3, err_msg=f"rank {rank}")
    log = ranks4["ranks"][0]["cli"]["runs"][3 * i]["log"]
    what = {"lora": "LoRA, ", "lora-int8": "LoRA, ", "adafactor": "adafactor, "}[variant]
    assert f"memory plan ({what}est. B=" in log, log
    assert ranks4["ranks"][1]["cli"]["runs"][3 * i]["log"] == ""


@pytest.mark.parametrize("variant", list(CLI_VARIANTS))
def test_cli_pretrain_on_a_mesh_resumes_bit_for_bit(ranks4, variant):
    """Stopped after 2 steps and resumed, each variant's mesh run repeats
    its uninterrupted run bit for bit: the losses, the final parameters (the
    adapters for --lora) and the saved train state at step 4."""
    i = list(CLI_VARIANTS).index(variant)
    for rank, res in enumerate(ranks4["ranks"]):
        straight, first, resumed = res["cli"]["runs"][3 * i:3 * i + 3]
        assert first["losses"] + resumed["losses"] == straight["losses"], rank
        _equal_trees(resumed["params"], straight["params"], f"rank {rank}")
    a = checkpoint.read_train_state(ranks4["tmp"] / f"{variant}-state")
    b = checkpoint.read_train_state(ranks4["tmp"] / f"{variant}-resumed-state")
    assert a["step"] == b["step"] == 4
    _equal_trees(a["params"], b["params"], "params")
    assert a["opt_state"].keys() == b["opt_state"].keys()
    for key, value in a["opt_state"].items():
        if isinstance(value, dict):
            _equal_trees(value, b["opt_state"][key], key)
        else:
            assert value == b["opt_state"][key], key
