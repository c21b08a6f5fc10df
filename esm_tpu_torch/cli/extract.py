"""esm-extract: bulk embedding extraction from FASTA, on the port.

Port of esm_tpu/cli/extract.py (reference semantics: scripts/extract.py):
token-budget batching, negative repr-layer resolution, one output file per
sequence with per_tok/mean/bos selections truncated to the real length, and
optional contacts. Same flags and outputs: ``.pt`` files (torch.save) by
default, ``.npz`` with --npz.

Runs on the GPU; --nogpu runs on the CPU, and without a GPU the run raises
unless --nogpu is given. --fp32-precision turns TF32 off for matmuls and
cuDNN (otherwise both may use it). --profile-trace writes a torch.profiler
trace. --int8 quantizes the linear layers' weights to int8 (weight-only).
"""

from __future__ import annotations

import argparse
import pathlib

import numpy as np
import torch


def create_parser():
    parser = argparse.ArgumentParser(
        description="Run a protein LM over every sequence in a FASTA file and "
        "save the selected embeddings/outputs to one file per sequence"
    )
    parser.add_argument(
        "model_location",
        type=str,
        help="registry name of a released model (from the local cache), or a "
        "path to a local .pt checkpoint",
    )
    parser.add_argument("fasta_file", type=pathlib.Path, help="input sequences, FASTA format")
    parser.add_argument("output_dir", type=pathlib.Path, help="directory that receives one output file per sequence")
    parser.add_argument("--toks_per_batch", type=int, default=4096, help="token budget per batch (caps max_len * batch_size)")
    parser.add_argument(
        "--repr_layers",
        type=int,
        default=[-1],
        nargs="+",
        help="which layers' hidden states to save; 0..num_layers inclusive, "
        "negatives count back from the last layer",
    )
    parser.add_argument(
        "--include",
        type=str,
        nargs="+",
        choices=["mean", "per_tok", "bos", "contacts"],
        help="what to write per sequence: full per-residue embeddings, their "
        "mean over the sequence, the BOS embedding, and/or the contact map",
        required=True,
    )
    parser.add_argument(
        "--truncation_seq_length",
        type=int,
        default=1022,
        help="clip sequences to at most this many residues before the forward pass",
    )
    parser.add_argument("--npz", action="store_true", help="write .npz instead of torch .pt files")
    parser.add_argument(
        "--fp32-precision", action="store_true",
        help="turn TF32 off for matmuls and cuDNN (full fp32 numerics; slower)",
    )
    parser.add_argument("--nogpu", action="store_true", help="run on the host CPU even when a GPU is present")
    parser.add_argument(
        "--profile-trace", type=str, default=None, metavar="LOGDIR",
        help="capture a torch.profiler trace of the run into LOGDIR (Chrome trace JSON)",
    )
    parser.add_argument(
        "--bucket", action="store_true",
        help="pad batches to shape buckets (T to 128-multiples, B to powers "
        "of two) so bulk jobs see a few batch shapes",
    )
    parser.add_argument(
        "--int8", action="store_true",
        help="weight-only int8 quantization of the linear layers",
    )
    parser.add_argument(
        "--serial", action="store_true",
        help="disable the host/device pipeline (tokenize, forward, readback "
        "and write strictly in sequence, like the reference CLI)",
    )
    parser.add_argument(
        "--writers", type=int, default=2,
        help="output-writer threads for the pipelined path",
    )
    return parser


def run(args):
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    allow = not args.fp32_precision
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow
    try:
        _run(args)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _run(args):
    from .. import pretrained
    from ..data import FastaBatchedDataset
    from ..quantization import quantize_params

    device = pretrained.resolve_device("cpu" if args.nogpu else None)
    model, alphabet = pretrained.load_model_and_alphabet(args.model_location, device=device)
    if args.int8:  # in place: the loaded weights are not needed in fp32
        quantize_params(model.model)

    profiler = None
    if args.profile_trace:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()

    dataset = FastaBatchedDataset.from_file(args.fasta_file)
    batches = dataset.get_batch_indices(args.toks_per_batch, extra_toks_per_seq=1)
    batch_converter = alphabet.get_batch_converter(
        args.truncation_seq_length, pad_to_multiple=8
    )
    print(f"Read {args.fasta_file} with {len(dataset)} sequences")

    args.output_dir.mkdir(parents=True, exist_ok=True)
    return_contacts = "contacts" in args.include

    if not all(-(model.num_layers + 1) <= i <= model.num_layers for i in args.repr_layers):
        raise ValueError(f"--repr_layers {args.repr_layers} out of range for "
                         f"{model.num_layers} layers")
    repr_layers = [
        (i + model.num_layers + 1) % (model.num_layers + 1) for i in args.repr_layers
    ]
    round_up_cap = -(-(args.truncation_seq_length + 2) // 128) * 128

    def bucketed(toks):
        """Pad (B, T) up to shape buckets: T to the next multiple of 128, B to
        the next power of two; padded rows are copies of row 0 (inert,
        discarded on output)."""
        b, t = toks.shape
        tp = min(-(-t // 128) * 128, round_up_cap)
        bp = 1 << (b - 1).bit_length()
        toks = torch.nn.functional.pad(toks, (0, tp - t), value=alphabet.padding_idx)
        if bp != b:
            toks = torch.cat([toks, toks[:1].repeat(bp - b, 1)])
        return toks

    def prepare(batch):
        labels, strs, toks = batch_converter([dataset[i] for i in batch])
        if args.bucket:
            toks = bucketed(toks)
        return labels, strs, toks

    def device_means(reps, lengths, trunc):
        """Masked mean over real tokens (positions 1..len), on the device: the
        copy back shrinks from (B, T, D) to (B, D) per layer."""
        t0 = next(iter(reps.values()))
        pos = torch.arange(t0.shape[1], device=t0.device)
        n = torch.clamp(lengths, max=trunc)
        mask = ((pos[None, :] >= 1) & (pos[None, :] < (n + 1)[:, None]))[..., None]
        return {
            layer: (t * mask).sum(1) / n[:, None].to(t.dtype) for layer, t in reps.items()
        }

    want_per_tok = "per_tok" in args.include
    want_mean = "mean" in args.include
    want_bos = "bos" in args.include

    dispatched = [0]

    def dispatch(prepared):
        labels, strs, toks = prepared
        # progress is printed here (the caller thread dispatches in batch
        # order) so lines stay monotonic even with concurrent writer threads
        dispatched[0] += 1
        print(
            f"Processing {dispatched[0]} of {len(batches)} batches ({len(labels)} sequences)"
        )
        # asynchronous on the GPU: returns device tensors without waiting
        out = model(toks, repr_layers=repr_layers, return_contacts=return_contacts)
        reps = out["representations"]
        result = {}
        if want_per_tok:
            result["representations"] = reps
        if want_bos:
            result["bos"] = {layer: t[:, 0] for layer, t in reps.items()}
        if want_mean and not want_per_tok:  # else the host takes the mean below
            lengths = torch.ones((toks.shape[0],), dtype=torch.int64)  # padded rows
            lengths[: len(strs)] = torch.tensor([len(s) for s in strs])
            result["mean"] = device_means(
                reps, lengths.to(model.device), args.truncation_seq_length
            )
        if return_contacts:
            result["contacts"] = out["contacts"]
        return result

    def to_host(d):
        return {layer: t.cpu().numpy() for layer, t in d.items()}

    def consume(batch_idx, batch, prepared, out):
        labels, strs, _ = prepared
        # .cpu() is the synchronization point (the copy back)
        representations = to_host(out.get("representations", {}))
        device_mean = to_host(out.get("mean", {}))
        device_bos = to_host(out.get("bos", {}))
        contacts = out["contacts"].cpu().numpy() if return_contacts else None

        for i, label in enumerate(labels):
            output_file = args.output_dir / f"{label}.{'npz' if args.npz else 'pt'}"
            output_file.parent.mkdir(parents=True, exist_ok=True)
            truncate_len = min(args.truncation_seq_length, len(strs[i]))
            result = {"label": label}
            if want_per_tok:
                result["representations"] = {
                    layer: t[i, 1 : truncate_len + 1].copy()
                    for layer, t in representations.items()
                }
            if want_mean:
                result["mean_representations"] = (
                    {
                        layer: t[i, 1 : truncate_len + 1].mean(0)
                        for layer, t in representations.items()
                    }
                    if want_per_tok
                    else {layer: t[i].copy() for layer, t in device_mean.items()}
                )
            if want_bos:
                result["bos_representations"] = {
                    layer: t[i].copy() for layer, t in device_bos.items()
                }
            if return_contacts:
                result["contacts"] = contacts[i, :truncate_len, :truncate_len].copy()
            _save(output_file, result, npz=args.npz)

    if args.serial:
        # reference-style strictly sequential loop (scripts/extract.py:88-131)
        for batch_idx, batch in enumerate(batches):
            prepared = prepare(batch)
            consume(batch_idx, batch, prepared, dispatch(prepared))
    else:
        from ..runtime import run_pipeline

        stats = run_pipeline(
            batches, prepare, dispatch, consume,
            prefetch=2, in_flight=2, writers=args.writers,
        )
        print("Pipeline:", stats.summary())

    if profiler is not None:
        profiler.stop()
        trace_dir = pathlib.Path(args.profile_trace)
        trace_dir.mkdir(parents=True, exist_ok=True)
        profiler.export_chrome_trace(str(trace_dir / "esm_extract_trace.json"))
        print(f"Profiler trace written to {args.profile_trace}")
    print(f"Saved results to {args.output_dir}")


def _save(output_file: pathlib.Path, result: dict, *, npz: bool) -> None:
    if npz:
        flat = {"label": result["label"]}
        for key in ("representations", "mean_representations", "bos_representations"):
            for layer, t in result.get(key, {}).items():
                flat[f"{key}_{layer}"] = t
        if "contacts" in result:
            flat["contacts"] = result["contacts"]
        np.savez(output_file, **flat)
        return
    torch.save(
        {
            k: (
                {kk: torch.from_numpy(np.asarray(vv)) for kk, vv in v.items()}
                if isinstance(v, dict)
                else (v if isinstance(v, str) else torch.from_numpy(np.asarray(v)))
            )
            for k, v in result.items()
        },
        output_file,
    )


def main():
    args = create_parser().parse_args()
    run(args)


if __name__ == "__main__":
    main()
