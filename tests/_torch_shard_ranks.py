"""Rank bodies of the parameter-sharding and pipeline tests
(tests/test_torch_sharding.py, tests/test_torch_pipeline.py,
tests/test_torch_pretrain_mesh.py, tests/test_torch_shard_train.py; the
families' bodies are in tests/_torch_shard_family_ranks.py).

Each body runs in one of ``world`` processes spawned by :func:`spawn` over a
gloo process group whose FileStore lives in the test's temporary directory,
with one CPU thread. This module imports no JAX, so the spawned processes
never do: the parent passes esm_tpu's results in and each rank returns what
the parent asserts on.
"""

import contextlib
import importlib
import io
import os
import time
import weakref

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from esm_tpu_torch import training
from esm_tpu_torch.data import Alphabet
from esm_tpu_torch.io import checkpoint
from esm_tpu_torch.models import esm2
from esm_tpu_torch.parallel import pipeline, sharding
from esm_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from esm_tpu_torch.quantization import quantize_params

JOIN_TIMEOUT = 240  # seconds a spawned group may take; a hung collective fails one test


def spawn(body, world: int, inputs: dict, tmp_path) -> list:
    """Run ``body(inputs, rank)`` on ``world`` gloo ranks; returns each rank's
    result, in rank order. ``body`` is a function of this module or of
    another JAX-free module of tests/ (tests/_torch_fold_shard_ranks.py).
    Raises when a rank fails or the group outlasts JOIN_TIMEOUT."""
    torch.save(inputs, tmp_path / "inputs.pt")
    ctx = mp.start_processes(_main, args=(world, body.__module__, body.__name__, str(tmp_path)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{body.__name__}: {world} ranks did not end in {JOIN_TIMEOUT} s")
    return [torch.load(tmp_path / f"out{r}.pt", weights_only=False) for r in range(world)]


def _main(rank: int, world: int, module: str, body: str, tmp: str) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
        fn = getattr(importlib.import_module(module), body)
        torch.save(fn(inputs, rank), os.path.join(tmp, f"out{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _mesh(shape):
    return make_mesh(MeshConfig(*shape), device_type="cpu")


def _model(inp, sharded_on=None, **options):
    """The ESM-2 of ``inp["size"]`` with ``inp["state_dict"]`` (weight-only
    int8 with ``inp["int8"]``), sharded on the mesh ``sharded_on``."""
    cfg = esm2.ESM2Config.from_alphabet(Alphabet.from_architecture("ESM-1b"), **inp["size"],
                                        **options)
    model = esm2.ESM2(cfg, device="cpu")
    model.load_state_dict(inp["state_dict"], strict=True)
    if inp.get("int8"):
        quantize_params(model, min_size=1)
    if sharded_on is not None:
        sharding.shard_params(model, sharded_on)
    return model, cfg


def _errors(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return str(e)
    return "no error"


@torch.no_grad()
def forward_body(inp: dict, rank: int) -> dict:
    """esm2.apply on each mesh of ``inp["want"]``, exact and flash, on this
    rank's rows: logits and representations beside esm_tpu's on that mesh
    (cut to the same rows), and each rank's resident parameter bytes. With
    ``inp["int8_mesh"]`` the int8 forward on that mesh; with ``inp["maps"]``
    (a mesh) the attention maps and contacts, both contact paths; with
    ``inp["uneven"]`` (a mesh and a model size) the refusal of an uneven
    shard."""
    out = {}
    meshes = {}
    for shape, want in inp["want"].items():
        mesh = meshes[shape] = _mesh(shape)
        rows = lambda x, dim=0: sharding.batch_rows(x, mesh, dim=dim)  # noqa: E731
        for use_flash in (False, True):
            model, cfg = _model(inp, mesh, use_flash=use_flash)
            res = esm2.apply(model, cfg, rows(inp["tokens"]), return_representations=True)
            out[f"{shape}/{'flash' if use_flash else 'exact'}"] = {
                "logits": res["logits"], "want_logits": rows(want["logits"]),
                "reps": res["representations"], "want_reps": rows(want["reps"], 1)}
        out[f"{shape}/bytes"] = sharding.resident_bytes(model)
    if "int8_mesh" in inp:
        mesh = meshes[inp["int8_mesh"]]
        model, cfg = _model(dict(inp, int8=True), mesh)
        rows = sharding.batch_rows(inp["tokens"], mesh)
        out["int8"] = {"logits": esm2.apply(model, cfg, rows)["logits"],
                       "want_logits": sharding.batch_rows(inp["int8_logits"], mesh),
                       "dtype": model.layers[0].fc1.weight.dtype}
    if "maps" in inp:
        mesh = meshes[inp["maps"]]
        model, cfg = _model(inp, mesh)
        rows = lambda x: sharding.batch_rows(x, mesh)  # noqa: E731
        res = esm2.apply(model, cfg, rows(inp["tokens"]), need_head_weights=True,
                         return_contacts=True)
        streamed = esm2.apply(model, cfg, rows(inp["tokens"]), return_contacts=True)
        out["maps"] = {"attentions": res["attentions"], "contacts": res["contacts"],
                       "streamed": streamed["contacts"],
                       "want_attentions": rows(inp["attentions"]),
                       "want_contacts": rows(inp["contacts"])}
    if "uneven" in inp:
        shape, size = inp["uneven"]
        cfg = esm2.ESM2Config.from_alphabet(Alphabet.from_architecture("ESM-1b"), **size)
        model = esm2.ESM2(cfg, device="cpu")
        out["uneven"] = _errors(lambda: sharding.shard_params(model, meshes[shape]))
    return out


def _whole_grads(model):
    grads = {n: p.grad for n, p in model.named_parameters()}
    return sharding.whole_state(model, grads)


def _step_pieces(model, tx, state, loss_and_grads, grads_in) -> dict:
    """Step 0 in pieces: the loss and the gradients (gathered whole), the
    global norm the optimizer's clip sees, then the optimizer update on
    ``grads_in`` (whole gradients, each rank given its shards: the update
    is then a function of the same numbers on both sides; an Adam step
    divides by |g| + 1e-8, so it would turn roundoff-level gradient
    differences into visible ones) with the parameters gathered whole."""
    model.zero_grad(set_to_none=True)
    metrics = loss_and_grads()
    grads = _whole_grads(model)
    shard = sharding.sharding_of(model)
    norm = torch.sqrt(shard.norm_sq({n: p.grad for n, p in model.named_parameters()}))
    for name, p in model.named_parameters():
        p.grad = shard.cut(name, grads_in[name]).clone()
    tx.update(model, state.opt_state)
    model.zero_grad(set_to_none=True)
    params = {n: t for n, t in sharding.whole_state(model).items() if n in grads}
    return {"loss": metrics["loss"].item(), "grads": grads, "norm": norm.item(),
            "params": params}


def train_body(inp: dict, rank: int) -> dict:
    """Step 0 of a sharded train step on each case of ``inp["cases"]`` (mesh
    shape, model options, grad clip) with esm_tpu's corruption, then a
    whole step; and of the pipelined step on each of ``inp["pp_cases"]``
    ((pp, data, fsdp, tp), microbatches, options)."""
    out = {}
    batch = (inp["corrupted"], inp["tokens"], inp["target_mask"])
    for tag, shape, options, clip in inp.get("cases", ()):
        mesh = _mesh(shape)
        model, cfg = _model(inp, mesh, **options)
        tx = training.make_optimizer(1e-3, warmup_steps=0, total_steps=10, grad_clip_norm=clip)
        state = training.init_state(model, tx)
        out[tag] = _step_pieces(model, tx, state, lambda: training.sharded_loss_and_grads(
            model, cfg, *batch), inp["grads"])
        state, metrics = training.train_step_corrupted(state, cfg, tx, *batch)
        out[tag]["loss1"] = metrics["loss"].item()
    for tag, shape, m, options in inp.get("pp_cases", ()):
        mesh = pipeline.make_pp_mesh(*shape, device_type="cpu")
        model, cfg = _model(inp, mesh, **options)
        tx = training.make_optimizer(1e-3, warmup_steps=0, total_steps=10)
        state = training.init_state(model, tx)
        # a stage's tensors only: the parent puts the stages together
        out[tag] = _step_pieces(model, tx, state, lambda: training.pp_loss_and_grads(
            model, cfg, *batch, num_microbatches=m), inp["grads"])
    return out


@torch.no_grad()
def pipeline_body(inp: dict, rank: int) -> dict:
    """apply_pipelined on each ((pp, data, fsdp, tp), microbatches) of
    ``inp["cases"]``; the validation errors."""
    out = {}
    for shape, m in inp["cases"]:
        mesh = pipeline.make_pp_mesh(*shape, device_type="cpu")
        model, cfg = _model(inp, mesh)
        shard = sharding.sharding_of(model)
        out[(shape, m)] = {
            "logits": esm2.apply_pipelined(model, cfg, sharding.batch_rows(inp["tokens"], shard),
                                           num_microbatches=m)["logits"],
            "want": sharding.batch_rows(inp["want"][(shape, m)], shard)}
    mesh = pipeline.make_pp_mesh(4, tp=2, device_type="cpu")
    model, cfg = _model(inp, mesh)
    out["batch_error"] = _errors(lambda: esm2.apply_pipelined(model, cfg, inp["tokens"],
                                                              num_microbatches=3))
    out["apply_error"] = _errors(lambda: esm2.apply(model, cfg, inp["tokens"]))
    six = dict(inp, size=dict(inp["size"], num_layers=6), state_dict=inp["six_layers"])
    out["layers_error"] = _errors(lambda: _model(six, mesh))
    # the generic schedule: a per-stage affine map, checked in closed form
    st = pipeline.Stage(mesh)
    w = float(st.index + 1)
    x = torch.arange(24.0).reshape(6, 2, 2)
    out["generic"] = pipeline.pipeline_apply(lambda h, aux: h * w, x, mesh=mesh,
                                             num_microbatches=3)
    return out


@contextlib.contextmanager
def _gathered_bytes():
    """Counts the bytes of the whole entries ``Sharding.whole`` gathers that
    are alive at once; yields {"peak": the most}."""
    live = {"now": 0, "peak": 0}
    real = sharding.Sharding.whole

    def let_go(n):
        live["now"] -= n

    def whole(self, name, local, spec=None):
        out = real(self, name, local, spec)
        n = out.numel() * out.element_size()
        live["now"] += n
        live["peak"] = max(live["peak"], live["now"])
        weakref.finalize(out, let_go, n)
        return out

    sharding.Sharding.whole = whole
    try:
        yield live
    finally:
        sharding.Sharding.whole = real


def checkpoint_body(inp: dict, rank: int) -> dict:
    """Save a sharded model's parameters and its train state after one step
    on ``inp["mesh"]`` (and return them gathered, with the most bytes of
    gathered whole entries, and of host copies, the saves held at once);
    load the unsharded save of the parent onto the mesh and return it
    gathered whole."""
    mesh = _mesh(inp["mesh"])
    model, cfg = _model(inp, mesh)
    tx = training.make_optimizer(1e-3, warmup_steps=0, total_steps=10)
    state = training.init_state(model, tx)
    state, _ = training.train_step_corrupted(
        state, cfg, tx, inp["corrupted"], inp["tokens"], inp["target_mask"])
    with _gathered_bytes() as live, _host_bytes() as host:
        checkpoint.save_params(inp["dir"] + "/params", model)
        checkpoint.save_train_state(inp["dir"] + "/state", state)
    mine = {"params": sharding.whole_state(model),
            "mu": sharding.whole_state(model, state.opt_state.mu),
            "nu": sharding.whole_state(model, state.opt_state.nu),
            "save_peak_bytes": live["peak"], "host_peak_bytes": host["peak"]}
    # the reverse: a whole (one-device) save onto this mesh
    other, _ = _model(inp, mesh)
    checkpoint.load_params(inp["dir"] + "/one_device", other)
    fresh = training.init_state(other, tx)
    checkpoint.load_train_state(inp["dir"] + "/one_device_state", fresh)
    return {"params": sharding.whole_state(other),
            "mu": sharding.whole_state(other, fresh.opt_state.mu),
            "step": fresh.step, "count": fresh.opt_state.count, "saved": mine}


def pretrain_body(inp: dict, rank: int) -> dict:
    """cli.pretrain on the ranks, as a torchrun launch runs it, for each argv
    of ``inp["runs"]``: rank 0's log, each step's loss (recorded around
    training.train_step and train_step_lora), the final parameters gathered
    whole (a LoRA run's adapters, whole on every rank); the message of each
    refused argv of ``inp["refused"]``."""
    from esm_tpu_torch.cli import pretrain

    def whole_init(*args, **kwargs):
        raise AssertionError("the mesh run built the whole model (esm2.init)")

    out = {"runs": [], "refused": []}
    steps = ("train_step", "train_step_lora")
    real, real_init = {name: getattr(training, name) for name in steps}, esm2.init
    esm2.init = whole_init
    for argv in inp["runs"]:
        losses = []

        def recording(fn):
            def step(*a, **k):
                state, metrics = fn(*a, **k)
                losses.append(metrics["loss"].item())
                return state, metrics
            return step

        for name in steps:
            setattr(training, name, recording(real[name]))
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                state = pretrain.run(pretrain.create_parser().parse_args(argv))
        finally:
            for name in steps:
                setattr(training, name, real[name])
        params = (sharding.whole_state(state.model) if sharding.sharding_of(state.model)
                  else state.model.state_dict())
        out["runs"].append({"log": buf.getvalue(), "losses": losses, "params": params})
    esm2.init = real_init
    for argv in inp.get("refused", ()):
        try:
            pretrain.run(pretrain.create_parser().parse_args(argv))
            out["refused"].append("no error")
        except SystemExit as e:
            out["refused"].append(str(e))
    return out


def example_body(inp: dict, rank: int) -> dict:
    """examples.esm2_infer_sharded on the ranks: its log."""
    from esm_tpu_torch.examples import esm2_infer_sharded

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        esm2_infer_sharded.main(inp["argv"])
    return {"log": buf.getvalue()}


# ------------------------------------------------- training on a sharded model


def _lora_model(inp, mesh, variant):
    """The 64-wide base on ``mesh`` as a LoRA recipe stores it: "bf16" and
    "flash" (with remat, the plain K1 and K2) cast every fp32 parameter to
    bf16 after the cut, "int8" quantizes the shards (the whole rows' scales);
    fp32 compute, so that esm_tpu's exact path is the reference; token
    dropout off (``inp["lora_size"]``)."""
    from esm_tpu_torch import lora

    options = dict(use_flash=True, remat=True) if variant == "flash" else {}
    model, cfg = _model(dict(inp, size=inp["lora_size"]), mesh, **options)
    if variant == "int8":
        quantize_params(model, min_size=1)
    else:
        lora.store_base(model)
    return model, cfg


def _adapters(inp):
    from esm_tpu_torch import lora

    return lora.LoRA({path: (ab[0].clone(), ab[1].clone()) for path, ab in inp["adapters"].items()})


def _lora_step(inp, mesh, variant) -> dict:
    """Step 0 of the sharded LoRA step with esm_tpu's corruption: the loss,
    the adapter gradients, the adapters after the optimizer's update on
    esm_tpu's gradients; then one whole train_step_lora; for int8 the base
    gathered whole."""
    model, cfg = _lora_model(inp, mesh, variant)
    adapters = _adapters(inp)
    batch = (inp["corrupted"], inp["tokens"], inp["target_mask"])
    tx = training.make_optimizer(1e-3, warmup_steps=0, total_steps=10, grad_clip_norm=inp["clip"])
    state = training.init_state(adapters, tx)
    with training.frozen_and_patched(model, adapters, inp["scale"]):
        metrics = training.sharded_loss_and_grads(model, cfg, *batch, adapters=adapters)
    out = {"loss": metrics["loss"].item(),
           "grads": {n: p.grad.clone() for n, p in adapters.named_parameters()}}
    for n, p in adapters.named_parameters():
        p.grad = inp["lora_grads"][variant == "int8"][n].clone()
    tx.update(adapters, state.opt_state)
    adapters.zero_grad(set_to_none=True)
    out["updated"] = {n: p.detach().clone() for n, p in adapters.named_parameters()}
    state, metrics = training.train_step_lora_corrupted(state, model, cfg, tx, *batch,
                                                        scale=inp["scale"])
    out["loss1"] = metrics["loss"].item()
    if variant == "int8":
        out["base"] = sharding.whole_state(model)
    return out


def _adafactor_steps(inp, mesh) -> tuple:
    """Three adafactor steps (weight decay, a binding clip) on the 128-wide
    model on ``mesh``, fed esm_tpu's gradients (each rank its shards)."""
    model, cfg = _model(dict(inp, size=inp["size128"], state_dict=inp["state_dict128"]), mesh)
    tx = training.make_optimizer(1e-2, weight_decay=0.01, warmup_steps=1, total_steps=10,
                                 grad_clip_norm=1.0, factored=True)
    state = training.init_state(model, tx)
    shard = sharding.sharding_of(model)
    for grads in inp["adafactor_grads"]:
        for name, p in model.named_parameters():
            p.grad = shard.cut(name, grads[name]).clone()
        tx.update(model, state.opt_state)
    model.zero_grad(set_to_none=True)
    state.step = 3
    return state, tx


def _whole_train_state(state) -> dict:
    opt = state.opt_state
    out = {"params": sharding.whole_state(state.model), "count": opt.count, "step": state.step}
    for key, tensors in training.tensor_fields(opt).items():
        out[key] = sharding.whole_state(state.model, tensors, opt.specs.get(key))
    return out


@contextlib.contextmanager
def _host_bytes():
    """Counts the bytes of the host copies a checkpoint save holds at once
    (``checkpoint._to_host``, until the writer lets each go); yields
    {"peak": the most, "copies": how many}."""
    live = {"now": 0, "peak": 0, "copies": 0}
    real = checkpoint._to_host

    def let_go(n):
        live["now"] -= n

    def to_host(t):
        out = real(t)
        n = out.numel() * out.element_size()
        live["now"] += n
        live["copies"] += 1
        live["peak"] = max(live["peak"], live["now"])
        weakref.finalize(out, let_go, n)
        return out

    checkpoint._to_host = to_host
    try:
        yield live
    finally:
        checkpoint._to_host = real


def shard_train_body(inp: dict, rank: int) -> dict:
    """Training on a sharded model, on each case of ``inp``: the LoRA step
    (``lora_meshes`` x ``lora_variants``), three adafactor steps
    (``adafactor_meshes``; ``adafactor_pp``, a (pp, data, fsdp, tp) mesh),
    with ``inp["dir"]``: the adafactor states saved and loaded across
    meshes, a replicated LoRA state saved, an earlier single-file save
    loaded, a sharded merge, the LoRA-on-pp refusal; with ``inp["cli"]``
    cli.pretrain's runs (:func:`pretrain_body`)."""
    from esm_tpu_torch import lora

    out = {}
    for shape in inp.get("lora_meshes", ()):
        mesh = _mesh(shape)
        for variant in inp["lora_variants"]:
            out[f"lora/{shape}/{variant}"] = _lora_step(inp, mesh, variant)
    states = {}
    for shape in inp.get("adafactor_meshes", ()):
        states[shape] = _adafactor_steps(inp, _mesh(shape))
    if "adafactor_pp" in inp:
        shape = inp["adafactor_pp"]
        states[shape] = _adafactor_steps(inp, pipeline.make_pp_mesh(*shape, device_type="cpu"))
    for shape, (state, _) in states.items():
        out[f"adafactor/{shape}"] = _whole_train_state(state)
    if "dir" not in inp:
        return out

    # the adafactor states saved, then each loaded onto the other's mesh
    root = inp["dir"]
    for i, (shape, (state, _)) in enumerate(states.items()):
        with _gathered_bytes() as device, _host_bytes() as host:
            checkpoint.save_train_state(f"{root}/adafactor{i}", state)
        out[f"save/{shape}"] = {"device_peak": device["peak"], "host_peak": host["peak"],
                                "host_copies": host["copies"]}
    shapes = list(states)
    for i, shape in enumerate(shapes):
        other = shapes[(i + 1) % len(shapes)]
        template = states[other][0]
        fresh = training.init_state(template.model, states[other][1])
        checkpoint.load_train_state(f"{root}/adafactor{i}", fresh)
        out[f"load/{shape}->{other}"] = _whole_train_state(fresh)
    # an earlier version's single-file AdamW state onto (1, 2, 2)
    model, _ = _model(inp, _mesh((1, 2, 2)))
    tx = training.make_optimizer(1e-3, warmup_steps=0, total_steps=10)
    fresh = checkpoint.load_train_state(inp["old_layout"], training.init_state(model, tx))
    out["old_layout"] = {"params": sharding.whole_state(model), "count": fresh.opt_state.count,
                         "step": fresh.step, "mu": sharding.whole_state(model, fresh.opt_state.mu)}
    # a replicated tree: the adapters' AdamW state over a sharded base
    model, _ = _lora_model(inp, _mesh((1, 2, 2)), "bf16")
    adapters = _adapters(inp)
    state = training.init_state(adapters, tx)
    with _host_bytes() as host:
        checkpoint.save_train_state(f"{root}/lora", state)
    out["lora_save_copies"] = host["copies"]
    # a sharded merge against the unsharded merge of the same base
    model, _ = _model(inp, _mesh((1, 2, 2)))
    merged = lora.merge(model, adapters, scale=0.5)
    out["merged"] = sharding.whole_state(merged)
    out["merged_is_sharded"] = sharding.sharding_of(merged) is sharding.sharding_of(model)
    if rank == 0:
        whole, _ = _model(inp)
        out["unsharded_merge"] = lora.merge(whole, adapters, scale=0.5).state_dict()
    if "cli" in inp:
        out["cli"] = pretrain_body(inp["cli"], rank)
    return out


# ------------------------------------------------ LoRA on a pipeline-sharded base


def _lookup_raises(shard) -> bool:
    """Whether ``shard`` refuses an entry its specs do not hold."""
    try:
        shard.axes_of("layers.0.self_attn.no_such_entry")
    except KeyError:
        return True
    return False


def pp_lora_body(inp: dict, rank: int) -> dict:
    """LoRA over a pipeline-sharded ESM-2 on each ((pp, data, fsdp, tp),
    microbatches, options) of ``inp["cases"]``, the base stored in bf16:
    step 0 with esm_tpu's corruption and adapters (each stage's, ``on_stage``)
    through pp_loss_and_grads (the loss, the adapter gradients gathered over
    the stages, the global norm the clip sees, the adapters after AdamW's
    update on esm_tpu's gradients), then a whole train_step_lora_corrupted;
    on the first case init_lora over the stages gathered whole, the specs
    the stage's adapters carry, and the adapters' train state saved to
    ``inp["dir"]``."""
    from esm_tpu_torch import lora

    out = {}
    batch = (inp["corrupted"], inp["tokens"], inp["target_mask"])
    for i, (tag, shape, m, options) in enumerate(inp["cases"]):
        mesh = pipeline.make_pp_mesh(*shape, device_type="cpu")
        model, cfg = _model(dict(inp, size=inp["lora_size"]), mesh, **options)
        lora.store_base(model)
        adapters = lora.on_stage(_adapters(inp), model)
        shard = sharding.sharding_of(adapters)
        tx = training.make_optimizer(1e-3, warmup_steps=0, total_steps=10,
                                     grad_clip_norm=inp["clip"])
        state = training.init_state(adapters, tx)
        with training.frozen_and_patched(model, adapters, inp["scale"]):
            metrics = training.pp_loss_and_grads(model, cfg, *batch, num_microbatches=m,
                                                 adapters=adapters)
        grads = {n: p.grad for n, p in adapters.named_parameters()}
        got = {"loss": metrics["loss"].item(), "norm": torch.sqrt(shard.norm_sq(grads)).item(),
               "grads": sharding.whole_state(adapters, grads), "stage": sorted(grads)}
        for n, p in adapters.named_parameters():
            p.grad = inp["lora_grads"][n].clone()
        tx.update(adapters, state.opt_state)
        adapters.zero_grad(set_to_none=True)
        got["updated"] = sharding.whole_state(adapters)
        state, metrics = training.train_step_lora_corrupted(
            state, model, cfg, tx, *batch, scale=inp["scale"], num_microbatches=m)
        got["loss1"] = metrics["loss"].item()
        if i == 0:
            got["init"] = sharding.whole_state(
                lora.init_lora(torch.Generator().manual_seed(5), model, rank=4))
            names = [n for n, _ in adapters.named_parameters()]
            got["specs"] = {"adapters": {n: shard.specs[n] for n in names},
                            "in_base": [n for n in names if n in sharding.sharding_of(model).specs],
                            "missing_raises": [_lookup_raises(s) for s in
                                               (shard, sharding.sharding_of(model))]}
            checkpoint.save_train_state(inp["dir"] + "/pp_lora", state)
            got["saved"] = {"params": sharding.whole_state(adapters),
                            "mu": sharding.whole_state(adapters, state.opt_state.mu),
                            "nu": sharding.whole_state(adapters, state.opt_state.nu)}
        out[tag] = got
    return out
