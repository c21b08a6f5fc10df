"""Rank bodies of the sequence-parallel tests (tests/test_torch_ring.py).

Each body runs in one of ``world`` processes spawned by :func:`spawn`, over a
gloo process group whose FileStore lives in the test's temporary directory
(so concurrent test workers never share a port), with one CPU thread. This
module imports no JAX, so the spawned processes never do: the parent passes
esm_tpu's full results in, each rank cuts its own shard of them with
``parallel.mesh.local_shard`` and saves (got, want) pairs for the parent to
assert on.
"""

import os

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from esm_tpu_torch import training
from esm_tpu_torch.data import Alphabet
from esm_tpu_torch.models import esm2
from esm_tpu_torch.parallel.mesh import MeshConfig, local_shard, make_hybrid_mesh, make_mesh
from esm_tpu_torch.parallel.ring_attention import ring_attention


def spawn(body, world: int, inputs: dict, tmp_path) -> list:
    """Run ``body(inputs, rank)`` on ``world`` gloo ranks; returns each rank's
    result (a dict of tensors), in rank order."""
    torch.save(inputs, tmp_path / "inputs.pt")
    mp.spawn(_main, args=(world, body.__name__, str(tmp_path)), nprocs=world, join=True)
    return [torch.load(tmp_path / f"out{r}.pt") for r in range(world)]


def _main(rank: int, world: int, body: str, tmp: str) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        inputs = torch.load(os.path.join(tmp, "inputs.pt"))
        torch.save(globals()[body](inputs, rank), os.path.join(tmp, f"out{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _mesh(shape):
    return make_mesh(MeshConfig(*shape), device_type="cpu")


def ring_body(inp: dict, rank: int) -> dict:
    """ring_attention, exact and flash, forward and gradients, on a (1, 1, N)
    mesh: each rank's output and q/k/v gradients of sum(out * w) beside its
    shard of the full references."""
    mesh = _mesh((1, 1, dist.get_world_size()))
    seq = lambda x: local_shard(x, mesh, seq_dim=2)
    out = {}
    for case, mask, w in (("ragged", inp["mask"], inp["w_ragged"]),
                          ("dead_row", inp["mask_dead"], inp["w_dead"])):
        for use_flash in (False, True):
            q, k, v = (seq(inp[n]).clone().requires_grad_() for n in ("q", "k", "v"))
            o = ring_attention(q, k, v, mesh, key_padding_mask=local_shard(mask, mesh),
                               use_flash=use_flash)
            (o * seq(w)).sum().backward()
            tag = f"{case}/{'flash' if use_flash else 'exact'}"
            out[tag] = {"out": o.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}
            for name in ("out", "dq", "dk", "dv"):
                out[tag][f"want_{name}"] = seq(inp[f"{tag}_{name}"])
    return out


def _model(inp, **options):
    cfg = esm2.ESM2Config.from_alphabet(Alphabet.from_architecture("ESM-1b"), **inp["size"],
                                        **options)
    model = esm2.ESM2(cfg, device="cpu")
    model.load_state_dict(inp["state_dict"], strict=True)
    return model, cfg


@torch.no_grad()
def model_body(inp: dict, rank: int) -> dict:
    """apply_seq_sharded on each mesh shape of ``inp["meshes"]``, exact and
    flash, against esm_tpu's logits and representations; the same forward
    with shard-local token-dropout counts; the contacts refusal."""
    out = {}
    tokens = inp["tokens"]
    for shape in inp["meshes"]:
        mesh = _mesh(shape)
        for use_flash in (False, True):
            model, cfg = _model(inp, use_flash=use_flash)
            res = esm2.apply_seq_sharded(model, cfg, tokens, mesh=mesh,
                                         return_representations=True)
            tag = f"{shape}/{'flash' if use_flash else 'exact'}"
            out[tag] = {
                "logits": res["logits"], "want_logits": local_shard(inp["logits"], mesh),
                "reps": res["representations"],
                "want_reps": local_shard(inp["reps"], mesh, batch_dim=1, seq_dim=2),
            }
        # the rescale's counts taken on this rank's columns alone
        real = esm2._sequence_counts
        esm2._sequence_counts = lambda is_mask, padding_mask, ring: real(is_mask, padding_mask,
                                                                         None)
        try:
            out[f"{shape}/local_counts"] = {
                "logits": esm2.apply_seq_sharded(model, cfg, tokens, mesh=mesh)["logits"],
                "want_logits": local_shard(inp["logits"], mesh)}
        finally:
            esm2._sequence_counts = real
        try:
            esm2.apply_seq_sharded(model, cfg, tokens, mesh=mesh, return_contacts=True)
            out[f"{shape}/contacts"] = "no error"
        except ValueError as e:
            out[f"{shape}/contacts"] = str(e)
    # two hosts of two ranks each, as a launcher would number them
    os.environ["LOCAL_WORLD_SIZE"] = "2"
    hybrid = make_hybrid_mesh(device_type="cpu")
    out["hybrid"] = {"shape": tuple(hybrid.shape), "names": hybrid.mesh_dim_names,
                     "tp_ranks": dist.get_process_group_ranks(hybrid.get_group("tp"))}
    try:
        make_hybrid_mesh(MeshConfig(1, 1, 4), device_type="cpu")
        out["hybrid"]["one_data_slice"] = "no error"
    except ValueError as e:
        out["hybrid"]["one_data_slice"] = str(e)
    return out


def train_body(inp: dict, rank: int) -> dict:
    """train_step_seq_corrupted on ``inp["mesh"]`` with esm_tpu's corruption:
    the loss and the updated parameters."""
    mesh = _mesh(inp["mesh"])
    model, cfg = _model(inp, **inp["options"])
    tx = training.make_optimizer(1e-3, warmup_steps=0, total_steps=10)
    state = training.init_state(model, tx)
    state, metrics = training.train_step_seq_corrupted(
        state, cfg, tx, inp["corrupted"], inp["tokens"], inp["target_mask"], mesh=mesh)
    return {"metrics": {k: v.item() for k, v in metrics.items()},
            "params": {n: p.detach() for n, p in model.named_parameters()}}
