"""Bulk embedding, as ``esm-extract`` runs it: a pool of sequences batched by
a token budget, tokenized on a host thread, the LM's forward dispatched
without waiting, the masked mean of the last layer taken on the device and
read back on a writer thread (``runtime.run_pipeline``), closed loop until
the window ends.

Traffic parameters (``traffic/<name>.json``): ``sequences``,
``median_length``, ``sigma`` (of the log length), ``min_length``,
``max_length``, ``toks_per_batch``, ``truncation_seq_length``,
``pad_to_multiple``, ``prefetch``, ``in_flight``, ``writers``, ``strata``.

The lengths are the log-normal's quantiles at (i + 1/2)/N, so every seed
has the same set of sizes and so the same batches; the seed draws the
residues, which sequence gets which length, and the order of the batches.
The order interleaves ``strata`` groups of batches of like length (one of
each group a round, in a random order), so a window that ends part way
through the pool has the pool's mix of lengths.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from ..harness import Window
from ..reference import esm2 as ref


def pool(p: dict, rng: np.random.Generator) -> List[str]:
    n = p["sequences"]
    dist = statistics.NormalDist(np.log(p["median_length"]), p["sigma"])
    lengths = np.array([dist.inv_cdf((i + 0.5) / n) for i in range(n)])
    lengths = np.clip(np.rint(np.exp(lengths)), p["min_length"], p["max_length"]).astype(int)
    lengths = lengths[rng.permutation(n)]
    letters = np.frombuffer(ref.AMINO.encode(), dtype=np.uint8)[
        rng.integers(0, len(ref.AMINO), int(lengths.sum()))].tobytes().decode()
    ends = np.cumsum(lengths)
    return [letters[e - n_:e] for n_, e in zip(lengths, ends)]


def stratified(batches: List[List[int]], strata: int, rng: np.random.Generator) -> List[int]:
    """Batch ids (batches come sorted by length) in rounds of one batch of
    each of ``strata`` length groups, the groups' order random in each round."""
    groups = [list(g) for g in np.array_split(np.arange(len(batches)), strata) if len(g)]
    for g in groups:
        rng.shuffle(g)
    order = []
    for r in range(max(len(g) for g in groups)):
        for gi in rng.permutation(len(groups)):
            if r < len(groups[gi]):
                order.append(int(groups[gi][r]))
    return order


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.p = cell.traffic
        self.span = lambda name: contextlib.nullcontext()

    def setup(self) -> None:
        from esm_tpu_torch.data.fasta import FastaBatchedDataset

        c, p = self.cell, self.p
        state = c.family.weights(c.config, c.stream(0), c.device)
        self.handle = c.family.program(c.config, state, c.device)
        if c.variant == "fp8":
            self.handle = ReferenceLM(state, c.config, self.handle.alphabet)
        del state
        rng = np.random.default_rng(c.stream(1))
        self.seqs = pool(p, rng)
        self.labels = [f"s{i}" for i in range(len(self.seqs))]
        dataset = FastaBatchedDataset(self.labels, self.seqs)
        self.batches = dataset.get_batch_indices(p["toks_per_batch"], extra_toks_per_seq=1)
        self.order = stratified(self.batches, p["strata"], rng)
        self.converter = self.handle.alphabet.get_batch_converter(
            p["truncation_seq_length"], pad_to_multiple=p["pad_to_multiple"])
        self.layer = c.config["num_layers"]
        self.done: Dict[int, tuple] = {}  # pipeline item -> (batch id, its means on the host)
        # warm-up: the pool's longest batch and its shortest, through the same calls
        for b in (len(self.batches) - 1, 0):
            prepared = self._prepare(b)
            self._consume(b, b, prepared, self._dispatch(prepared))
        self.done.clear()

    # esm-extract's prepare / dispatch / consume (cli/extract.py), minus the files
    def _prepare(self, b: int):
        labels, strs, toks = self.converter([(self.labels[i], self.seqs[i])
                                             for i in self.batches[b]])
        return b, strs, toks

    def _dispatch(self, prepared):
        b, strs, toks = prepared
        with self.span("bench.embed.dispatch"):
            reps = self.handle(toks, repr_layers=(self.layer,))["representations"]
            t = reps[self.layer]
            lengths = torch.tensor([len(s) for s in strs]).to(t.device)
            n = torch.clamp(lengths, max=self.p["truncation_seq_length"])
            pos = torch.arange(t.shape[1], device=t.device)
            mask = ((pos[None, :] >= 1) & (pos[None, :] < (n + 1)[:, None]))[..., None]
            return (t * mask).sum(1) / n[:, None].to(t.dtype)

    def _consume(self, idx, b, prepared, means):
        with self.span("bench.embed.readback"):
            self.done[idx] = (b, means.cpu())

    def window(self, seconds: float, tracer) -> Window:
        from esm_tpu_torch.kernels import flash_attention as fa
        from esm_tpu_torch.runtime import run_pipeline

        p, order, w = self.p, self.order, self.cell.workload["trace"]
        deadline = [None]
        dispatched: List[int] = []
        traced: List[int] = []
        after = []  # (batches dispatched, time) once the trace has closed
        # the traced stretch, and a batch after it, always run
        least = w["from_item"] + w["items"] + 1 if tracer.enabled else 1
        before = {}

        def items():
            i = 0
            while (deadline[0] is None or time.perf_counter() < deadline[0]
                   or len(dispatched) < least):
                yield order[i % len(order)]
                i += 1

        def dispatch(prepared):
            if deadline[0] is None:
                self.t_first = time.perf_counter()
                deadline[0] = self.t_first + seconds
            if tracer.enabled and len(dispatched) == w["from_item"]:
                if self.cell.device == "cuda":  # the stretch starts with an idle card
                    torch.cuda.synchronize()
                tracer.begin()
                before["k1"] = fa.flash_attention.launches
            if tracer.active and len(dispatched) == w["from_item"] + w["items"]:
                tracer.end()
                tracer.counters["k1"] = fa.flash_attention.launches - before["k1"]
                tracer.items = len(traced)
                after.append((len(dispatched), time.perf_counter()))
            if tracer.active:
                traced.append(prepared[0])
            dispatched.append(prepared[0])
            return self._dispatch(prepared)

        self.span = tracer.span
        stats = run_pipeline(items(), self._prepare, dispatch, self._consume,
                             prefetch=p["prefetch"], in_flight=p["in_flight"],
                             writers=p["writers"])
        t_end = time.perf_counter()  # every batch is back on the host
        elapsed = t_end - self.t_first

        def residues(done):
            return [min(len(self.seqs[i]), p["truncation_seq_length"])
                    for b, _ in done for i in self.batches[b]]

        lengths = residues(self.done.values())
        info = {"stats": stats, "lengths": lengths,
                # (B, T) of every traced batch, for the K1 roofline
                "shapes": [(len(self.batches[b]), self._padded(b)) for b in traced]}
        if after:  # the batches dispatched once the trace had closed (the card idle then)
            n, t = after[0]
            info["untraced"] = (residues(v for k, v in self.done.items() if k >= n),
                                t_end - t)
        return Window(
            metrics={"embed_residues_per_s": sum(lengths) / elapsed},
            attempted=sum(len(self.batches[b]) for b in dispatched),
            failed=sum(len(self.batches[b]) for b in dispatched) - len(lengths),
            seconds=elapsed,
            info=info)

    def _padded(self, b: int) -> int:
        longest = max(min(len(self.seqs[i]), self.p["truncation_seq_length"])
                      for i in self.batches[b])
        m = self.p["pad_to_multiple"]
        return -(-(longest + 2) // m) * m

    def release(self) -> None:
        del self.handle

    def check(self) -> Dict[str, float]:
        """The layer means of a sample of the window's sequences (the longest
        among them) against the plain reference in float32: the largest
        relative error of one sequence's mean, the median one, and the
        relative size of the error that the sample's means share (their
        mean error over their mean norm)."""
        c = self.cell
        got = {i: m for b, ms in self.done.values() for i, m in zip(self.batches[b], ms)}
        done = sorted(got)
        rng = np.random.default_rng(c.stream(2))
        k = min(c.workload["check"]["sample"], len(done))
        longest = max(done, key=lambda i: len(self.seqs[i]))
        rest = [i for i in done if i != longest]
        sample = [longest] + [rest[j] for j in rng.choice(len(rest), k - 1, replace=False)]
        w = c.family.weights(c.config, c.stream(0), c.device)
        trunc = self.p["truncation_seq_length"]
        errs, diffs, norms = [], [], []
        sample.sort(key=lambda i: len(self.seqs[i]))
        with torch.no_grad(), ref.float32_exact():
            for at in range(0, len(sample), c.workload["check"]["rows"]):
                ids = sample[at:at + c.workload["check"]["rows"]]
                seqs = [self.seqs[i][:trunc] for i in ids]
                out = ref.forward(w, c.config, ref.tokenize(seqs, c.device))["final"]
                want = ref.masked_means(out, [len(s) for s in seqs])
                for i, r in zip(ids, want):
                    g = got[i].float().to(r.device)
                    errs.append(((g - r).norm() / r.norm()).item())
                    diffs.append(g - r)
                    norms.append(r.norm().item())
        shared = torch.stack(diffs).mean(0).norm().item() / float(np.mean(norms))
        return {"embed_mean_rel_err": max(errs), "embed_mean_rel_err_median": float(
            np.median(errs)), "embed_mean_shared_err": shared}


class ReferenceLM:
    """The fp8 control in the program's place: the plain reference with every
    matrix product's operands rounded to fp8, called as the program's handle."""

    def __init__(self, w, cfg, alphabet):
        self.w, self.cfg, self.alphabet = w, cfg, alphabet

    @torch.no_grad()
    def __call__(self, tokens, repr_layers):
        with ref.float32_exact():
            out = ref.forward(self.w, self.cfg, tokens.to(self.w["embed_tokens.weight"].device),
                              mm=ref.fp8_matmul)
        return {"representations": {layer: out["final"] for layer in repr_layers}}

