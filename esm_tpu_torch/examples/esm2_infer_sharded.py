"""Large-model inference with the parameters sharded over a mesh of cards.

Port of examples/esm2_infer_sharded.py. The reference squeezed ESM2-15B
onto one GPU by wrapping each layer in FSDP with CPU offload
(examples/esm2_infer_fairscale_fsdp_cpu_offloading.py); here each rank keeps
its shard of every parameter (Megatron tensor parallelism over ``tp``,
ZeRO-3 over ``fsdp``: esm_tpu_torch.parallel.sharding) and the forward
gathers what a layer needs as it runs. The model comes from the local cache
(``ESM_TPU_CACHE``), or with --random-seed as seeded random weights at its
released size, drawn one layer at a time so that no rank holds the whole
model. It prints the mesh, the scaling model's warnings for this batch and
each sequence's mean-embedding norm.

--model takes every ESM-2 name and, as esm_tpu's example does, the ESM-1
family's: ESM-1b (esm1b_t33_650M_UR50S), ESM-1v (esm1v_t33_650M_UR90S_1 to
_5) and ESM-1 (esm1_t34_670M_UR50S/UR50D/UR100, esm1_t12_85M_UR50S,
esm1_t6_43M_UR50S), each with its alphabet and forward. An MSA Transformer
takes (B, R, C) alignments, not this example's sequences: shard it with
``parallel.sharding.shard_params`` and call ``msa_transformer.apply``.

    torchrun --nproc_per_node 4 -m esm_tpu_torch.examples.esm2_infer_sharded \\
        --random-seed 0 [--model esm1b_t33_650M_UR50S]

Without a launcher it runs as a mesh of one rank. --cpu runs on the CPU
(gloo), otherwise each rank uses the GPU of its LOCAL_RANK.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch
import torch.distributed as dist

DATA = [
    ("protein1", "MKTVRQERLKSIVRILERSKEPVSGAQLAEELSVSRQVIVQDIAYLRSLGYNIVATPRGYVLAGG"),
    ("protein2", "KALTARQQEVFDLIRDHISQTGMPPTRAEIAQRLGFRSPNAAEEHLKALARKGVIEIVSGASRGIRLLQEE"),
]


def create_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="esm2_t48_15B_UR50D")
    p.add_argument("--random-seed", type=int, default=None,
                   help="seeded random weights at the model's released widths instead of "
                   "the checkpoint in the local cache")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    for axis in ("data", "fsdp", "tp"):
        p.add_argument(f"--{axis}", type=int, default=None,
                       help=f"the mesh's {axis} axis (default: MeshConfig.for_devices)")
    return p


def _join(device_type):
    """Join the launcher's process group, or make a group of one."""
    from esm_tpu_torch.parallel.mesh import init_multihost

    if "WORLD_SIZE" in os.environ or dist.is_initialized():
        return init_multihost(device_type=device_type)
    if device_type != "cpu":
        torch.cuda.set_device(0)
    store = dist.FileStore(os.path.join(tempfile.mkdtemp(), "store"), 1)
    dist.init_process_group("gloo" if device_type == "cpu" else "nccl", store=store, rank=0,
                            world_size=1)
    return 0


def seeded(name: str, seed: int, device):
    """The layer-at-a-time builder of a released size's seeded weights
    (bf16 compute, flash): ESM-2's ``seeded_parts``, the ESM-1 family's
    ``esm1.init_parts``."""
    from esm_tpu_torch.data import Alphabet
    from esm_tpu_torch.examples.esm2_15b_int8_single_chip import seeded_parts
    from esm_tpu_torch.models import esm1

    if name not in esm1.ESM1_SIZES:
        return seeded_parts(name, seed, device)
    size = esm1.ESM1_SIZES[name]
    cfg = esm1.ESM1Config.from_alphabet(Alphabet.from_architecture(size["model_version"]),
                                        **size, compute_dtype=torch.bfloat16, use_flash=True)
    return esm1.init_parts(cfg, torch.Generator(device=device).manual_seed(seed), device)


def family(model):
    """(alphabet, apply) of a seeded model: ESM-2's or the ESM-1 family's."""
    from esm_tpu_torch import pretrained
    from esm_tpu_torch.data import Alphabet
    from esm_tpu_torch.models import esm1, esm2

    if isinstance(model, esm1.ESM1):
        return Alphabet.from_architecture(model.cfg.model_version), esm1.apply
    return pretrained._esm2_alphabet(), esm2.apply


def main(argv=None):
    args = create_parser().parse_args(argv)
    from esm_tpu_torch import pretrained
    from esm_tpu_torch.models import msa_transformer
    from esm_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from esm_tpu_torch.parallel.scaling import warn_if_inefficient
    from esm_tpu_torch.parallel.sharding import batch_rows, shard_params, sharding_of
    from esm_tpu_torch.parallel.tensor_parallel import all_gather

    name = pretrained._ALIASES.get(args.model, args.model)
    if name in msa_transformer.MSA_SIZES or name.startswith("esm_msa"):
        raise SystemExit(
            f"{args.model} is an MSA Transformer: it takes (B, R, C) alignments, not this "
            "example's (B, T) sequences. Shard it with parallel.sharding.shard_params and "
            "call msa_transformer.apply on this rank's alignments (batch_rows).")

    device_type = "cpu" if args.cpu else None
    if not args.cpu and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass --cpu to run on the CPU")
    rank = _join(device_type)
    world = dist.get_world_size()
    given = (args.data, args.fsdp, args.tp)
    mesh_cfg = (MeshConfig.for_devices(world) if given == (None, None, None)
                else MeshConfig(*(g or 1 for g in given)))
    mesh = make_mesh(mesh_cfg, device_type)
    device = pretrained.resolve_device("cpu" if args.cpu else None)
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh_cfg.shape))}")

    if args.random_seed is not None:
        model = shard_params(seeded(name, args.random_seed, device), mesh, dtype=torch.bfloat16)
        cfg = model.cfg
        alphabet, apply = family(model)
    else:
        # read on the host: each card receives its shards only
        handle, alphabet = pretrained.load_model_and_alphabet(args.model, device="cpu")
        if handle.kind == "msa":
            raise SystemExit(f"{args.model} is an MSA Transformer: see this example's help")
        model, cfg = shard_params(handle.model, mesh).to(device), handle.cfg
        apply = pretrained._APPLY[handle.kind]
    model.requires_grad_(False)
    tokens = alphabet.get_batch_converter(pad_to_multiple=128)(DATA)[2]
    dp = mesh_cfg.data * mesh_cfg.fsdp
    padded = -(-tokens.shape[0] // dp) * dp  # every row shard gets rows
    tokens = torch.cat([tokens, tokens[:1].repeat(padded - tokens.shape[0], 1)])
    # the scaling model at the run's own shape (a layout the model calls
    # link-bound warns here: e.g. ESM2-15B at two sequences is weight-gather
    # bound; a larger batch amortizes the gathers)
    if rank == 0:
        warn_if_inefficient(cfg, mesh_cfg, batch=len(DATA), seqlen=int(tokens.shape[1]))
    rows = batch_rows(tokens, mesh).to(device)
    with torch.no_grad():
        out = apply(model, cfg, rows, repr_layers=[cfg.num_layers])
        reps = out["representations"][cfg.num_layers].float()
        keep = (rows != alphabet.padding_idx) & (rows != alphabet.cls_idx) & (
            rows != alphabet.eos_idx)
        means = (reps * keep[..., None]).sum(1) / keep.sum(1, keepdim=True)
        means = all_gather(means, 0, sharding_of(model).group["dp"])
    for i, (label, _) in enumerate(DATA):
        say(label, "mean embedding norm:", float(torch.linalg.norm(means[i])))
    return means[:len(DATA)]


if __name__ == "__main__":
    main()
