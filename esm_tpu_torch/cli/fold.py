"""esm-fold: bulk structure prediction from FASTA, on the port.

Port of esm_tpu/cli/fold.py (reference semantics: scripts/fold.py):
sequences sorted by length into token-budget batches, one PDB per record,
pLDDT and pTM logged, and a batch that runs out of memory skipped with
advice. Same flags and outputs. Runs on the GPU; --cpu-only runs on the CPU,
and without a GPU the run raises unless --cpu-only is given.
--fused-triangle selects kernel K6 for triangle attention; --bf16-lm and
--fp16-lm set the LM's dtype (exact attention); --profile-trace writes a
torch.profiler trace. --int8 quantizes the LM's and trunk's linear layers
to int8 (weight-only). --plan prints the memory plan of the run these
flags make (the worst token-budget batch, the CLI's frugal outputs,
--in-flight batches held, --bucket rounding) and the longest sequence that
fits, without folding.

    python -m esm_tpu_torch.cli.fold -i seqs.fasta -o pdbs/ -m esmfold.pt --bf16-trunk
"""

from __future__ import annotations

import argparse
import logging
import pathlib
import sys
import timeit

import torch

logger = logging.getLogger(__name__)


def _setup_logging():
    """Logging for the command-line entry (not at import time)."""
    root = logging.getLogger()
    root.setLevel(logging.INFO)
    if not any(getattr(h, "_esm_torch_fold", False) for h in root.handlers):
        handler = logging.StreamHandler(sys.stdout)
        handler.setLevel(logging.INFO)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s | %(levelname)s | %(name)s | %(message)s", datefmt="%y/%m/%d %H:%M:%S"))
        handler._esm_torch_fold = True
        root.addHandler(handler)


def create_batched_sequence_dataset(sequences, max_tokens_per_batch: int = 1024):
    """(reference scripts/fold.py:66-79)"""
    batch_headers, batch_sequences, num_tokens = [], [], 0
    for header, seq in sequences:
        if (len(seq) + num_tokens > max_tokens_per_batch) and num_tokens > 0:
            yield batch_headers, batch_sequences
            batch_headers, batch_sequences, num_tokens = [], [], 0
        batch_headers.append(header)
        batch_sequences.append(seq)
        num_tokens += len(seq)
    yield batch_headers, batch_sequences


def create_parser():
    parser = argparse.ArgumentParser(description="Predict structures from a FASTA file")
    parser.add_argument("-i", "--fasta", type=pathlib.Path, required=True,
                        help="input sequences to fold, FASTA format")
    parser.add_argument("-o", "--pdb", type=pathlib.Path, required=True,
                        help="directory that receives one .pdb per sequence")
    parser.add_argument("-m", "--model-path", type=str, default=None,
                        help="a local ESMFold checkpoint (.pt) instead of esmfold_v1 from the "
                        "local cache")
    parser.add_argument("--num-recycles", type=int, default=None,
                        help="trunk recycle iterations; omit for the training-time setting (4)")
    parser.add_argument("--max-tokens-per-batch", type=int, default=1024,
                        help="token budget per batch; shorter sequences share a batch. Lower it "
                        "if short-sequence batches run out of memory")
    parser.add_argument("--chunk-size", type=int, default=None,
                        help="evaluate exact triangle attention in row chunks of this size, "
                        "cutting pair-activation memory at some speed cost (try 128/64/32)")
    parser.add_argument("--cpu-only", action="store_true", help="run on the host CPU")
    parser.add_argument("--bf16-trunk", action="store_true",
                        help="bf16 compute in the folding trunk (LN/softmax stay fp32)")
    parser.add_argument("--fp16-lm", action="store_true",
                        help="run the frozen LM in float16 like the reference "
                        "(esm/esmfold/v1/esmfold.py:59-62); LN/softmax stay fp32")
    parser.add_argument("--bf16-lm", action="store_true", help="run the frozen LM in bfloat16")
    parser.add_argument("--fused-triangle", action="store_true",
                        help="triangle attention through the fused CUDA kernel (K6)")
    parser.add_argument("--profile-trace", type=str, default=None, metavar="LOGDIR",
                        help="capture a torch.profiler trace of the run into LOGDIR "
                        "(Chrome trace JSON)")
    parser.add_argument("--int8", action="store_true",
                        help="weight-only int8 LM and trunk")
    parser.add_argument("--in-flight", type=int, default=2,
                        help="batches kept in flight on the device (overlaps PDB writing of "
                        "batch k with folding of batch k+1); each holds its outputs")
    parser.add_argument("--serial", action="store_true",
                        help="fold, read back and write strictly in sequence, like the "
                        "reference CLI")
    parser.add_argument("--bucket", action="store_true",
                        help="pad each batch's length to a 64-multiple bucket (outputs are "
                        "identical: padded positions are masked)")
    parser.add_argument("--plan", action="store_true",
                        help="print the memory plan of this run and exit without folding")
    return parser


def _is_oom(err: BaseException) -> bool:
    return isinstance(err, torch.cuda.OutOfMemoryError) or "out of memory" in str(err).lower()


def run(args):
    from .. import pretrained
    from ..data import FastaBatchedDataset
    from ..models.esmfold import esmfold as ef

    if args.fp16_lm and args.bf16_lm:
        raise SystemExit("esm-fold: pass at most one of --fp16-lm / --bf16-lm")
    device = pretrained.resolve_device("cpu" if args.cpu_only else None)

    logger.info("Reading sequences from FASTA")
    dataset = FastaBatchedDataset.from_file(args.fasta)
    all_sequences = sorted(zip(dataset.sequence_labels, dataset.sequence_strs),
                           key=lambda x: len(x[1]))
    logger.info(f"Loaded {len(all_sequences)} sequences from {args.fasta}")

    logger.info("Loading model")
    if args.model_path is not None:
        handle = pretrained.load_esmfold(args.model_path, device=device)
    else:
        handle = pretrained.esmfold_v1(device=device)
    trunk = {}
    if args.chunk_size is not None:
        trunk["chunk_size"] = args.chunk_size
    if args.bf16_trunk:
        trunk["compute_dtype"] = torch.bfloat16
    if args.fused_triangle:
        trunk["use_flash_tri"] = True
    lm_dtype = torch.float16 if args.fp16_lm else torch.bfloat16 if args.bf16_lm else None
    handle = handle.with_options(lm_dtype=lm_dtype, **trunk)
    if args.int8:  # LM and trunk, in place; lookup tables untouched
        from ..quantization import quantize_params

        quantize_params(handle.model)

    batches = list(create_batched_sequence_dataset(all_sequences, args.max_tokens_per_batch))
    if args.plan:
        print_plan(args, handle, batches, device)
        return 0
    args.pdb.mkdir(exist_ok=True, parents=True)
    num_completed = 0
    num_sequences = len(all_sequences)

    profiler = None
    if args.profile_trace:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()

    last_done = [None]  # completion time of the previous batch

    def prepare(item):
        return {"item": item, "start": None}  # encoding happens inside infer (cheap)

    def dispatch(prepared):
        prepared["start"] = timeit.default_timer()
        _, sequences = prepared["item"]
        # frugal: the O(L^2) diagnostics the CLI never writes are dropped
        return handle.infer(sequences, num_recycles=args.num_recycles, frugal=True,
                            pad_to_multiple=ef.FOLD_LENGTH_BUCKET if args.bucket else None)

    def consume(batch_idx, item, prepared, output):
        nonlocal num_completed
        headers, sequences = item
        pdbs = ef.output_to_pdb(output)  # the copy back (synchronises)
        done = timeit.default_timer()
        # with batches in flight, dispatch returns before the device is
        # free: time from max(dispatch start, previous completion)
        since = prepared["start"] if last_done[0] is None else max(prepared["start"],
                                                                   last_done[0])
        last_done[0] = done
        per_seq = (done - since) / len(headers)
        mean_plddt = output["mean_plddt"].cpu().numpy()
        ptm = output["ptm"].cpu().numpy()
        for header, seq, pdb_str, pl, tm in zip(headers, sequences, pdbs, mean_plddt, ptm):
            (args.pdb / f"{header}.pdb").write_text(pdb_str)
            num_completed += 1
            logger.info(f"Predicted structure for {header} with length {len(seq)}, pLDDT "
                        f"{pl:0.1f}, pTM {tm:0.3f} in {per_seq:0.1f}s ({num_completed} / "
                        f"{num_sequences} completed)")

    def on_batch_error(batch_idx, item, err) -> bool:
        # the reference's OOM catch-and-skip (scripts/fold.py:163-178)
        if not _is_oom(err):
            return False
        headers, sequences = item
        hint = ("" if args.serial or args.in_flight <= 1 else
                " With batches in flight each holds its outputs on the device: try "
                "--in-flight 1 (or --serial) before shrinking the batch.")
        if len(sequences) > 1:
            logger.info(f"Failed (OOM) to predict batch of size {len(sequences)}. Try "
                        "lowering --max-tokens-per-batch." + hint)
        else:
            logger.info(f"Failed (OOM) on sequence {headers[0]} of length "
                        f"{len(sequences[0])}." + hint)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        return True

    if args.serial:
        for batch_idx, item in enumerate(batches):
            prepared = prepare(item)
            try:
                consume(batch_idx, item, prepared, dispatch(prepared))
            except Exception as e:
                if not on_batch_error(batch_idx, item, e):
                    raise
    else:
        from ..runtime import run_pipeline

        # one writer keeps the completion log in order; PDB writes are small
        run_pipeline(batches, prepare, dispatch, consume, prefetch=2,
                     in_flight=max(1, args.in_flight), writers=1,
                     on_batch_error=on_batch_error)

    if profiler is not None:
        profiler.stop()
        trace_dir = pathlib.Path(args.profile_trace)
        trace_dir.mkdir(parents=True, exist_ok=True)
        profiler.export_chrome_trace(str(trace_dir / "esm_fold_trace.json"))
        logger.info(f"Profiler trace written to {args.profile_trace}")
    return num_completed


def print_plan(args, handle, batches, device) -> dict:
    """The memory plan of the run the flags make (esm_tpu/cli/fold.py:195-245):
    every token-budget batch at its folded length (multimer linkers
    included, rounded up to the bucket with --bucket), the CLI's frugal
    outputs, --in-flight batches holding theirs (one with --serial), the
    live model's parameter and buffer bytes; printed for the worst batch,
    with the longest single sequence that fits. Returns the worst plan."""
    import itertools

    from ..models.esmfold import esmfold as ef
    from ..parallel.memory_plan import max_fold_length, plan_fold

    lm_bytes = 1 if args.int8 else 2 if (args.fp16_lm or args.bf16_lm) else 4
    held = 1 if args.serial else max(args.in_flight, 1)
    params_bytes = sum(t.numel() * t.element_size() for t in itertools.chain(
        handle.model.parameters(), handle.model.buffers()))
    kw = dict(lm_dtype_bytes=lm_bytes, frugal=True, held_outputs=held,
              params_bytes=params_bytes, device=device)
    worst = None
    for _, sequences in batches:
        length = max(len(ef.encode_sequence(seq)[0]) for seq in sequences)
        if args.bucket:
            length = -(-length // ef.FOLD_LENGTH_BUCKET) * ef.FOLD_LENGTH_BUCKET
        p = plan_fold(handle.cfg, length, batch=len(sequences), **kw)
        if worst is None or p["per_device_bytes"] > worst["per_device_bytes"]:
            worst, shape = p, (len(sequences), length)
    max_l = max_fold_length(handle.cfg, **kw)
    lm = "int8" if args.int8 else "bf16/fp16" if lm_bytes == 2 else "fp32"
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "the host's memory"
    p = worst
    print(f"memory plan (worst batch B={shape[0]} x L={shape[1]}, one device: {name}, {lm} LM, "
          f"held_outputs={held}):\n"
          f"  verdict: {p['verdict']}  ({p['per_device_bytes'] / 1e9:.2f} GB of "
          f"{p['hbm_bytes'] / 1e9:.2f} GB)\n"
          f"  params {p['params_bytes'] / 1e9:.2f} GB | LM activations "
          f"{p['lm_bytes'] / 1e9:.2f} GB | pair working set {p['pair_bytes'] / 1e9:.2f} GB | "
          f"held outputs {p['output_bytes'] / 1e9:.2f} GB (frugal={p['frugal']})\n"
          f"  largest L that fits (single sequence) under these flags: ~{max_l}\n"
          f"  (an estimate: trust the verdict, not the decimals; 'over': try --int8, "
          f"--chunk-size 128, --bf16-trunk, or a lower --max-tokens-per-batch / --in-flight 1)")
    return dict(p, shape=shape, max_length=max_l)


def main():
    _setup_logging()
    run(create_parser().parse_args())


if __name__ == "__main__":
    main()
