"""Rank bodies of the family sharding tests (tests/test_torch_shard_family.py):
ESM-1, ESM-1b, ESM-1v and the MSA Transformer on the (data, fsdp, tp) mesh.

Spawned by tests/_torch_shard_ranks.py's ``spawn`` over gloo. This module
imports no JAX: the parent passes esm_tpu's results in (weights carried
across by io.from_jax) and each rank returns what the parent asserts on.
"""

import contextlib
import dataclasses
import io

import torch

from _torch_shard_ranks import _errors, _mesh
from esm_tpu_torch import lora, training
from esm_tpu_torch.io import checkpoint
from esm_tpu_torch.models import esm1, esm2, msa_transformer
from esm_tpu_torch.parallel import memory_plan, pipeline, sharding
from esm_tpu_torch.parallel.mesh import MeshConfig
from esm_tpu_torch.quantization import quantize_params

FAMILY = {esm1.ESM1Config: (esm1.ESM1, esm1.apply),
          msa_transformer.MSATransformerConfig: (msa_transformer.MSATransformer,
                                                 msa_transformer.apply)}


def _model(case, mesh=None, **options):
    """The case's model (``case["cfg"]`` with ``options``) holding its state
    dict, sharded on ``mesh`` when given."""
    cfg = dataclasses.replace(case["cfg"], **options)
    cls, apply = FAMILY[type(cfg)]
    model = cls(cfg, device="cpu")
    model.load_state_dict(case["state_dict"], strict=True)
    if mesh is not None:
        sharding.shard_params(model, mesh)
    return model, cfg, apply


def _rows(x, mesh, dim=0):
    return sharding.batch_rows(x, mesh, dim=dim)


@torch.no_grad()
def _forward(case, mesh) -> dict:
    """Every output of the case's sharded forward beside esm_tpu's (cut to
    this rank's rows): logits, representations, attention maps (row and
    column for the MSA) and contacts (ESM-1's stacked and streamed)."""
    model, cfg, apply = _model(case, mesh)
    tokens = _rows(case["tokens"], mesh)
    res = apply(model, cfg, tokens, need_head_weights=True, return_contacts=True,
                return_representations=True)
    got = {k: res[k] for k in case["want"] if k != "streamed"}
    if "streamed" in case["want"]:
        got["streamed"] = apply(model, cfg, tokens, return_contacts=True)["contacts"]
    want = {k: _rows(v, mesh, dim=1 if k == "representations" else 0)
            for k, v in case["want"].items()}
    shape = tuple(mesh.size(i) for i in range(3))
    whole = FAMILY[type(cfg)][0](cfg, device="meta")
    return {"got": got, "want": want, "bytes": sharding.resident_bytes(model),
            "plan": memory_plan.plan(whole, MeshConfig(*shape))["per_device_bytes"]}


@torch.no_grad()
def _flash(case, mesh) -> dict:
    """The flash path (K1's plain version on the CPU): logits and
    representations."""
    model, cfg, apply = _model(case, mesh, use_flash=True)
    res = apply(model, cfg, _rows(case["tokens"], mesh), return_representations=True)
    return {"got": {"logits": res["logits"], "representations": res["representations"]},
            "want": {"logits": _rows(case["want"]["logits"], mesh),
                     "representations": _rows(case["want"]["representations"], mesh, 1)}}


def _msa_step(inp, mesh) -> dict:
    """Step 0 of the MSA Transformer's MLM step on the mesh with esm_tpu's
    corruption (the loss, the gradients gathered whole, the global norm the
    clip sees, the AdamW update on esm_tpu's gradients, the parameters
    gathered whole), then a whole train_step_corrupted and a train_step_msa."""
    step = inp["msa_step"]
    model, cfg, apply = _model(inp["cases"]["msa"], mesh)
    batch = (step["corrupted"], inp["cases"]["msa"]["tokens"], step["target_mask"])
    tx = training.make_optimizer(1e-3, warmup_steps=0, total_steps=10,
                                 grad_clip_norm=step["clip"])
    state = training.init_state(model, tx)
    metrics = training.sharded_loss_and_grads(model, cfg, *batch, apply_fn=apply)
    params = dict(model.named_parameters())
    grads = sharding.whole_state(model, {n: p.grad for n, p in params.items()})
    shard = sharding.sharding_of(model)
    norm = torch.sqrt(shard.norm_sq({n: p.grad for n, p in params.items()})).item()
    for name, p in params.items():
        p.grad = shard.cut(name, step["grads"][name]).clone()
    tx.update(model, state.opt_state)
    model.zero_grad(set_to_none=True)
    out = {"loss": metrics["loss"].item(), "grads": grads, "norm": norm,
           "params": {n: t for n, t in sharding.whole_state(model).items() if n in grads}}
    state, metrics = training.train_step_corrupted(state, cfg, tx, *batch, apply_fn=apply)
    out["loss1"] = metrics["loss"].item()
    state, metrics = training.train_step_msa(state, cfg, tx, torch.Generator().manual_seed(3),
                                             batch[1])
    out["msa_step_loss"] = metrics["loss"].item()
    return out


def _adapters(factors, model=None):
    adapters = lora.LoRA({p: (ab[0].clone(), ab[1].clone()) for p, ab in factors.items()})
    return adapters if model is None else lora.on_stage(adapters, model)


def _lora_step(inp, tag, mesh) -> dict:
    """Step 0 of the LoRA step over the sharded base of case ``tag`` with
    esm_tpu's corruption and adapters: the loss, the adapter gradients, the
    adapters after AdamW's update on esm_tpu's gradients; then one whole
    train_step_lora_corrupted."""
    ref = inp["lora"][tag]
    model, cfg, apply = _model(inp["cases"][tag], mesh)
    adapters = _adapters(ref["adapters"])
    batch = (ref["corrupted"], inp["cases"][tag]["tokens"], ref["target_mask"])
    tx = training.make_optimizer(1e-3, warmup_steps=0, total_steps=10, grad_clip_norm=ref["clip"])
    state = training.init_state(adapters, tx)
    with training.frozen_and_patched(model, adapters, inp["scale"]):
        metrics = training.sharded_loss_and_grads(model, cfg, *batch, apply_fn=apply,
                                                  adapters=adapters)
    out = {"loss": metrics["loss"].item(),
           "grads": {n: p.grad.clone() for n, p in adapters.named_parameters()}}
    for n, p in adapters.named_parameters():
        p.grad = ref["grads"][n].clone()
    tx.update(adapters, state.opt_state)
    adapters.zero_grad(set_to_none=True)
    out["updated"] = {n: p.detach().clone() for n, p in adapters.named_parameters()}
    state, metrics = training.train_step_lora_corrupted(state, model, cfg, tx, *batch,
                                                        scale=inp["scale"], apply_fn=apply)
    out["loss1"] = metrics["loss"].item()
    return out


def _base_and_merge(inp, tag, mesh, rank) -> dict:
    """store_base(int8) over the sharded base gathered whole; a sharded
    merge (and on rank 0 the unsharded merge) of the case's adapters."""
    case = inp["cases"][tag]
    model, _, _ = _model(case, mesh)
    quantize_params(model, min_size=1)  # store_base(int8=True) at this size
    out = {"int8": sharding.whole_state(model)}
    model, _, _ = _model(case, mesh)
    adapters = _adapters(inp["lora"][tag]["adapters"])
    out["merged"] = sharding.whole_state(lora.merge(model, adapters, scale=0.5))
    if rank == 0:
        whole, _, _ = _model(case)
        out["unsharded_merge"] = lora.merge(whole, adapters, scale=0.5).state_dict()
    return out


def _checkpoints(inp, mesh) -> dict:
    """ESM-1's parameters (bias_kv split over tp) and the MSA Transformer's
    AdamW train state after one step, saved from the mesh; the parent's
    one-device saves loaded onto the mesh and gathered back."""
    root = inp["dir"]
    model, _, _ = _model(inp["cases"]["esm1"], mesh)
    checkpoint.save_params(f"{root}/esm1_params", model)
    out = {"esm1": sharding.whole_state(model)}
    msa, cfg, apply = _model(inp["cases"]["msa"], mesh)
    step = inp["msa_step"]
    tx = training.make_optimizer(1e-3, warmup_steps=0, total_steps=10)
    state = training.init_state(msa, tx)
    state, _ = training.train_step_corrupted(state, cfg, tx, step["corrupted"],
                                             inp["cases"]["msa"]["tokens"], step["target_mask"],
                                             apply_fn=apply)
    checkpoint.save_train_state(f"{root}/msa_state", state)
    out["msa"] = {"params": sharding.whole_state(msa),
                  "mu": sharding.whole_state(msa, state.opt_state.mu),
                  "nu": sharding.whole_state(msa, state.opt_state.nu)}
    other, _, _ = _model(inp["cases"]["esm1"], mesh)
    checkpoint.load_params(f"{root}/one_device_esm1", other)
    out["esm1_loaded"] = sharding.whole_state(other)
    other, _, _ = _model(inp["cases"]["msa"], mesh)
    fresh = checkpoint.load_train_state(f"{root}/one_device_msa_state",
                                        training.init_state(other, tx))
    out["msa_loaded"] = {"params": sharding.whole_state(other),
                         "mu": sharding.whole_state(other, fresh.opt_state.mu),
                         "step": fresh.step, "count": fresh.opt_state.count}
    return out


def _refusals(inp) -> dict:
    """A pp mesh refuses the families; sequence parallelism (the ring)
    refuses ESM-1."""
    pp = pipeline.make_pp_mesh(2, tp=2, device_type="cpu")
    out = {tag: _errors(lambda: _model(inp["cases"][tag], pp)) for tag in ("esm1b", "msa")}
    model, cfg, _ = _model(inp["cases"]["esm1"])
    out["ring"] = _errors(lambda: esm2.apply_seq_sharded(model, cfg, inp["cases"]["esm1"]["tokens"],
                                                         mesh=_mesh((1, 1, 4))))
    return out


def _example(argv) -> str:
    from esm_tpu_torch.examples import esm2_infer_sharded

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            esm2_infer_sharded.main(argv)
        except SystemExit as e:
            return f"SystemExit: {e}"
    return buf.getvalue()


def family_body(inp: dict, rank: int) -> dict:
    """Every mesh of ``inp["meshes"]``: each case's forward (and the flash
    cases'), the MSA step, the LoRA steps; on ``inp["extra_mesh"]`` the int8
    base, the merges, the checkpoints; the refusals; the example's runs."""
    out = {}
    for shape in inp["meshes"]:
        mesh = _mesh(shape)
        for tag, case in inp["cases"].items():
            out[f"{shape}/{tag}"] = _forward(case, mesh)
        for tag in inp["flash"]:
            out[f"{shape}/{tag}/flash"] = _flash(inp["cases"][tag], mesh)
        out[f"{shape}/msa_step"] = _msa_step(inp, mesh)
        for tag in inp["lora"]:
            out[f"{shape}/lora/{tag}"] = _lora_step(inp, tag, mesh)
    mesh = _mesh(inp["extra_mesh"])
    for tag in inp["lora"]:
        out[f"base/{tag}"] = _base_and_merge(inp, tag, mesh, rank)
    out["checkpoints"] = _checkpoints(inp, mesh)
    out["refusals"] = _refusals(inp)
    out["example"] = [_example(argv) for argv in inp["example"]]
    return out
