"""Local inference server with dynamic batching.

Port of esm_tpu/runtime/server.py (the reference ships batch scripts only,
scripts/extract.py:63). A long-lived process keeps the models loaded and
coalesces concurrent requests into device batches:

- one batcher thread tokenizes each window of requests into BUCKETED batches
  (T padded to 128-multiples, B to powers of two), launches the device work
  and hands the batch to a finalizer thread, which reads it back and answers;
- dispatch copies its inputs in from pinned host memory without blocking,
  launches the forward, reduces ``mean`` embeddings on the device ((B, T, D)
  -> (B, D)), copies what the answer needs into pinned host memory without
  blocking and records a CUDA event after those copies. The finalizer waits
  on that event only: batch k's readback never waits for batch k+1's compute,
  which the batcher has already queued behind it on the same stream;
- stdlib HTTP (ThreadingHTTPServer) + JSON: no server dependencies.

API (the esm-extract CLI's --include vocabulary, reference
scripts/extract.py:104-131), the same JSON and NPZ formats as esm_tpu's:

  GET  /healthz -> {"status": "ok", "endpoints": [...], model info}
  GET  /stats   -> request/batch/latency counters
  POST /embed   {"sequences": ["MKT...", ...] | [["label","MKT..."], ...],
                 "repr_layers": [-1], "include": ["mean"|"per_tok"|"logits"|"contacts"],
                 "format": "json" | "npz", "stream": false}
                -> json: {"results": [{"label", "length", "truncated",
                                 "mean_representations"/"representations":{layer: ...},
                                 "logits", "contacts"}, ...]}
                -> npz: one .npz ({i}/logits, {i}/mean/{layer}, ...)
  POST /fold    {"sequences": [...], "num_recycles": N, "stream": false}
                (multimers via ':')
                -> {"results": [{"label", "length", "num_chains", "pdb",
                                 "mean_plddt", "ptm"}, ...]}

  Streaming: with "stream": true, /embed and /fold deliver results as each
  device batch finalizes:
  - format json -> application/x-ndjson: one {"index", ...result} object
    per line (fold results arrive in completion order; "index" is the
    position in the request), terminated by {"done": N};
  - format npz (embed only) -> application/x-npz-stream: length-prefixed
    frames (8-byte big-endian length + one .npz per result with keys
    index/label/length/truncated/logits/contacts/mean/{layer}/per_tok/{layer};
    the final frame is {"done": N}).
  A missing terminator means the stream was truncated. Errors after the
  first frame arrive as a final {"error": ...} frame.
  POST /score   {"sequence": "...", "mutations": ["P76A", ...], "offset_idx": 0}
                -> {"results": [{"label", "scores": {"P76A": logp_mt - logp_wt}}]}
                (zero-shot variant effect, wt-marginals: one forward per batch)
  POST /design  {"coords": (L, 3, 3) N/CA/C floats | "pdb": "<PDB text>"
                 [+ "chain"], "temperature": 1.0, "seed": 0,
                 "num_samples": N, "partial_seq": "...", "bucket": 16}
                -> {"results": [{"label", "sequences": [...]}]}
                (ESM-IF1 sequence design; N samples run as ONE batched
                decode; backbones are padded to the 16-bucket after their
                eos residue, so a result is the port's ``sample`` with that
                seed and ``pad_to_multiple``; "bucket": 0 decodes at the
                exact length. With "seq": "..." it scores that sequence
                instead -> {"ll_fullseq", "ll_withcoord"}. Needs an IF model)
  POST /profile {"seconds": 3, "dir": "/tmp/esm_serve_trace"}
                -> captures a torch.profiler trace (<dir>/trace.json, CPU and
                   CUDA activity of the whole process) of whatever the server
                   runs during the window -> {"trace_dir", "seconds",
                   "batches", "attempts"} (a window whose trace lost its
                   kernel records is taken again, up to PROFILE_ATTEMPTS);
                   409 if a capture is already running

Folds share the batcher thread but batch separately, capped at
``max_fold_batch_seqs``: pair tensors are O(L^2..L^3).

Runs on the device of the handles it is given (the card unless they were
built on the CPU); ``esm_tpu_torch.cli.serve`` is the command line.
"""

from __future__ import annotations

import itertools
import json
import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils.device import host_to_device

logger = logging.getLogger(__name__)

_INCLUDE = ("mean", "per_tok", "logits", "contacts")


class ServerSaturatedError(RuntimeError):
    """Admission control: the in-flight budget is exhausted.

    Mapped to HTTP 429 + ``Retry-After`` by the handler instead of letting the
    queue grow without bound (which turns saturation into unbounded p95)."""

    def __init__(self, msg: str, retry_after_s: int):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class _HTTPServer(ThreadingHTTPServer):
    # the stdlib default listen backlog of 5 resets concurrent connects the
    # moment more than a handful of clients arrive together
    request_queue_size = 128
    daemon_threads = True


@dataclass
class _Request:
    labels: List[str]
    seqs: List[str]
    repr_layers: Tuple[int, ...] = ()
    include: Tuple[str, ...] = ()
    kind: str = "embed"  # "embed" | "fold" | "score" | "design"
    num_recycles: Optional[int] = None
    mutations: Optional[List[Tuple]] = None  # (raw, wt, idx0, mt); idx0 0-based
    # inverse-folding (/design): one backbone per request
    coords: Optional[Any] = None  # (L, 3, 3) N/CA/C float array
    temperature: float = 1.0
    seed: int = 0
    num_samples: int = 1
    partial_seq: Optional[str] = None
    design_seq: Optional[str] = None  # score this sequence instead of sampling
    design_bucket: int = 16  # pad sampling backbones to this multiple (0 = exact)
    fmt: str = "json"  # "json" | "npz" (embed only; binary arrays, no tolist)
    # streaming requests get results pushed one by one as device chunks
    # finalize: messages are ("item", index, dict) | ("end", count) |
    # ("error", msg); stream_q is None for buffered (default) requests
    stream_q: Optional["queue.Queue"] = None
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[List[Dict[str, Any]]] = None
    error: Optional[str] = None
    enqueued: float = field(default_factory=time.perf_counter)
    # estimated device-seconds this request holds while in flight; fixed at
    # admission (the estimate may drift later: release what was charged)
    cost: float = 0.0

    @property
    def key(self) -> Tuple:
        if self.kind == "fold":
            return ("fold", self.num_recycles)
        if self.kind == "score":
            return ("score",)
        if self.kind == "design":
            # processed per request inside the group (no cross-request
            # device batching for the autoregressive decode)
            return ("design",)
        # fmt is host-side serialization only: compute-identical requests
        # share a device batch whatever their json/npz
        return ("embed", self.repr_layers, self.include)


class InferenceServer:
    """Dynamic-batching inference server over an :class:`~esm_tpu_torch.pretrained.LMHandle`
    (and/or an ``ESMFoldHandle`` for /fold, an ``IFHandle`` for /design).

    ``max_wait_ms`` bounds added latency: the batcher dispatches as soon as
    ``max_batch_seqs`` sequences are pending or the oldest request has waited
    that long. When the PREVIOUS dispatch went out full, the window extends
    to ``refill_wait_ms``: a full batch means the server is saturated and its
    completion is about to release a wave of re-posts that a short window
    would miss; under light load the previous batch is small and the short
    window keeps added latency at ``max_wait_ms``. (esm_tpu's defaults, 10 and
    80 ms, and its queue caps, 256 sequences and 60 s; none is measured on
    the card.)

    Admission is COST-WEIGHTED: each request is charged its estimated
    device-seconds (per-kind EMAs from completed batches; folds follow a
    quadratic+cubic polynomial of the bucketed length) and total in-flight
    work is capped at ``max_queued_seconds``; ``max_queued_seqs`` still
    bounds host memory for queued payloads. ``port=0`` picks a free port
    (see ``.port`` after ``start()``).
    """

    def __init__(
        self,
        model=None,
        *,
        fold_model=None,
        if_model=None,
        host: str = "127.0.0.1",
        port: int = 0,
        max_batch_seqs: int = 16,
        max_fold_batch_seqs: int = 4,
        max_wait_ms: float = 10.0,
        refill_wait_ms: float = 80.0,
        truncation_seq_length: int = 1022,
        max_request_seqs: int = 64,
        max_queued_seqs: int = 256,
        max_queued_seconds: Optional[float] = 60.0,
        batch_bucket: str = "pow2",
        max_fold_seq_len: Optional[int] = None,
    ):
        if batch_bucket not in ("pow2", "max"):
            raise ValueError(f"batch_bucket must be 'pow2' or 'max', got {batch_bucket!r}")
        if model is None and fold_model is None and if_model is None:
            raise ValueError(
                "need at least one of model (LM) / fold_model / if_model"
            )
        if model is not None and getattr(model, "kind", None) not in ("esm2", "esm1"):
            raise ValueError(
                "InferenceServer serves single-sequence LMs (esm2/esm1); "
                f"got kind={getattr(model, 'kind', None)!r}"
            )
        self.model = model
        self.fold_model = fold_model
        self.if_model = if_model
        self.alphabet = model.alphabet if model is not None else None
        self.max_batch_seqs = max_batch_seqs
        self.max_fold_batch_seqs = max_fold_batch_seqs
        self.batch_bucket = batch_bucket
        self.max_wait_s = max_wait_ms / 1e3
        self.refill_wait_s = max(refill_wait_ms, max_wait_ms) / 1e3
        self._last_batch_full = False
        self.truncation_seq_length = truncation_seq_length
        self.max_request_seqs = max_request_seqs
        self.max_queued_seqs = max_queued_seqs
        if max_queued_seqs < 3 * max_batch_seqs:
            # the admission cap counts ALL admitted-unfinished sequences, and
            # the dispatch/finalize pipeline alone holds 2 full batches, so a
            # cap under ~3x max_batch starves batch formation
            logger.warning(
                "max_queued_seqs=%d < 3x max_batch_seqs=%d: the in-flight "
                "pipeline holds 2 batches, a cap this low degrades batch "
                "formation and tail latency; raise it to >= %d",
                max_queued_seqs, max_batch_seqs, 3 * max_batch_seqs,
            )
        # embeds truncate to truncation_seq_length; folds cannot truncate
        # silently (the structure IS the output), so over-long sequences are
        # rejected up front: the O(L^2..L^3) trunk would otherwise run out of
        # memory and take co-batched requests down with it. None (or 0), the
        # default, derives the cap from the memory plan for THIS model's
        # config, precision and device (parallel.memory_plan.max_fold_length;
        # held_outputs=2 for the dispatch/finalize pipeline, at a full fold
        # batch); an explicit cap overrides it. The derivation admits only
        # "fits": a cap must keep the plan's 10%-headroom margin.
        if not max_fold_seq_len and fold_model is not None:
            from ..parallel.memory_plan import max_fold_length

            # true parameter bytes of the live module: int8 weights keep their
            # fp compute_dtype in cfg, and their scales are buffers
            module = fold_model.model
            params_bytes = sum(
                t.numel() * t.element_size()
                for t in itertools.chain(module.parameters(), module.buffers())
            )
            max_fold_seq_len = max_fold_length(
                fold_model.cfg,
                params_bytes=params_bytes, frugal=True, held_outputs=2,
                batch=max_fold_batch_seqs, device=fold_model.device,
            )
            if not max_fold_seq_len:
                # the plan says no length fits this config on this device:
                # refuse to start rather than admit out-of-memory folds
                raise ValueError(
                    "memory plan: no fold length fits this model/precision "
                    "on this device (max_fold_length returned 0); use int8 "
                    "weights, a smaller fold batch, or pass an explicit "
                    "max_fold_seq_len to override"
                )
            logger.info("fold length cap from memory plan: %d", max_fold_seq_len)
        self.max_fold_seq_len = max_fold_seq_len
        self._inflight_seqs = 0  # admitted but not yet finished/failed
        # ---- cost-weighted admission ----------------------------------------
        # A /fold sequence costs hundreds of /embed sequences of device time,
        # so a raw sequence-count cap admits hours of fold backlog or rejects
        # milliseconds of embeds. Each request is charged its estimated
        # device-seconds at admission and the TOTAL estimated backlog is
        # capped at ``max_queued_seconds``, which therefore IS the worst-case
        # drain time (Little's law with both sides in seconds). Estimates are
        # per-kind EMAs measured from completed device batches; fold work
        # follows the length polynomial times trunk passes (_fold_units; one
        # unit = one trunk pass of a bucket-512 fold).
        # 0 disables like None (a literal 0-second budget would permanently
        # 400 every request).
        self.max_queued_seconds = max_queued_seconds or None
        self._inflight_cost = 0.0  # sum of admitted requests' .cost
        # Priors (_COST_PRIORS), overwritten by the first measured batch of
        # each kind.
        self._cost_unit = dict(_COST_PRIORS)
        # static copy for the never-admittable (400) decision: the LEARNED
        # units drift (a cold start can transiently inflate them), and a
        # permanent rejection must not depend on a transient
        self._cost_prior = dict(self._cost_unit)
        self._latencies_by_kind: Dict[str, List[float]] = {
            "embed": [], "score": [], "fold": [], "design": [],
        }
        self._converter = (
            self.alphabet.get_batch_converter(truncation_seq_length, pad_to_multiple=128)
            if model is not None
            else None
        )
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        # dispatched-but-not-finalized batches; depth 2 bounds in-flight
        # device work while letting readback overlap the next batch's compute
        self._pending: "queue.Queue" = queue.Queue(maxsize=2)
        self._stop = threading.Event()
        self._drained = threading.Event()
        self._lock = threading.Lock()
        self._stats = {
            "requests": 0, "sequences": 0, "batches": 0, "fold_batches": 0,
            "design_batches": 0, "designed_backbones": 0,
            "batched_sequences": 0, "errors": 0, "rejected": 0,
        }
        self._latencies: List[float] = []
        self._profiling = threading.Lock()  # one profiler capture at a time
        self._started = time.time()
        self._httpd = _HTTPServer((host, port), self._make_handler())
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="esm-serve-http", daemon=True
        )
        self._batch_thread = threading.Thread(
            target=self._batch_loop, name="esm-serve-batcher", daemon=True
        )
        self._finalize_thread = threading.Thread(
            target=self._finalize_loop, name="esm-serve-finalizer", daemon=True
        )

    # ---------------------------------------------------------------- public

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host = self._httpd.server_address[0]
        return f"http://{host}:{self.port}"

    def start(self) -> "InferenceServer":
        """Build the kernels the loaded handles launch (so the first request
        does not pay for nvcc), then start the threads."""
        self.build_kernels()
        self._batch_thread.start()
        self._finalize_thread.start()
        self._http_thread.start()
        return self

    def build_kernels(self) -> List[str]:
        """Build (or load) the kernel libraries that the loaded handles
        launch on the card: K1 for an LM with ``use_flash`` (and ESMFold's
        LM), K6 for a trunk with ``use_flash_tri``. Returns their names."""
        from ..kernels import _build

        names = []
        if self.model is not None and self.model.device.type == "cuda" and self.model.cfg.use_flash:
            names += ["esm_flash_attention", "esm_flash_attention_bwd"]
        fm = self.fold_model
        if fm is not None and fm.device.type == "cuda":
            if fm.cfg.esm.use_flash:
                names += ["esm_flash_attention", "esm_flash_attention_bwd"]
            if fm.cfg.trunk.use_flash_tri:
                names.append("esm_triangle_attention")
        names = sorted(set(names))
        if names:
            _build.load_libraries({n: _build.LIBRARIES[n] for n in names})
        return names

    def prewarm(self, lengths=None, include=("mean",), batch_sizes=None) -> int:
        """Run the embed path's standard (B, T) shapes once before traffic.

        Nothing is compiled per shape on the card, but the first call at a
        shape pays for cuBLAS's heuristics and for growing the caching
        allocator's pools. This walks the exact production dispatch
        (including the on-device mean) for each T bucket up to
        ``truncation_seq_length`` at the batch shapes the bucketing policy
        can produce, after building the kernels (``build_kernels``). Returns
        the number of (B, T) shapes run. Defaults run the ``mean`` path at
        B in {1, 2, 4, ..., max} ("pow2") or {1, max} ("max")."""
        if self.model is None:
            return 0
        self.build_kernels()
        if lengths is None:
            # aa length L occupies the ceil((L + bos + eos)/128) token bucket
            extra = int(self.alphabet.prepend_bos) + int(self.alphabet.append_eos)
            buckets = range(128, ((self.truncation_seq_length + extra + 127)
                                  // 128) * 128 + 1, 128)
            lengths = [t - extra for t in buckets]
        if batch_sizes is None:
            if self.batch_bucket == "max":
                batch_sizes = (1, self.max_batch_seqs)
            else:
                batch_sizes = tuple(
                    1 << i for i in range((self.max_batch_seqs).bit_length())
                )
        layers = [self.model.num_layers]
        count = 0
        with torch.no_grad():
            for L in lengths:
                for b in batch_sizes:
                    pairs = [(f"warm{i}", "A" * L) for i in range(b)]
                    fin = self._dispatch_embed_chunk(pairs, layers, set(include))
                    fin()
                    count += 1
        return count

    def prewarm_fold(self, lengths, batch_sizes=(1,), num_recycles=None) -> int:
        """Run the fold path once for chosen 64-bucket lengths / batch sizes
        (the given lengths round up to their 64-bucket: warming 300 covers
        every sequence of 257-320 residues)."""
        if self.fold_model is None:
            return 0
        from ..models.esmfold.esmfold import FOLD_LENGTH_BUCKET

        self.build_kernels()
        count = 0
        for L in lengths:
            for b in batch_sizes:
                out = self.fold_model.infer(
                    ["A" * int(L)] * b,
                    num_recycles=num_recycles,
                    frugal=True,
                    pad_to_multiple=FOLD_LENGTH_BUCKET,
                )
                float(out["ptm"][0])  # a readback: the fold has run
                count += 1
        return count

    def prewarm_design(self, lengths, num_samples=(1,)) -> int:
        """Run the /design decode once for the given backbone lengths (and
        sample batch sizes). Lengths round up to DESIGN_LENGTH_BUCKET, the
        serving default (warming 100 covers every 97-112-residue request)."""
        if self.if_model is None:
            return 0
        count = 0
        for L in lengths:
            for n in num_samples:
                # a straight-line synthetic backbone; only the length matters
                coords = np.zeros((int(L), 3, 3), np.float32)
                coords[:, :, 0] = np.arange(int(L), dtype=np.float32)[:, None] * 3.8
                coords[:, 1, 1] = 1.5  # CA off the N-C axis: finite frames
                self.if_model.sample(
                    coords, seed=0, num_samples=int(n),
                    pad_to_multiple=self.DESIGN_LENGTH_BUCKET,
                )
                count += 1
        return count

    def stop(self) -> None:
        self._stop.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        self._batch_thread.join(timeout=30)
        # let the finalizer drain already-dispatched batches, then exit; if
        # it is wedged (a hung readback) don't block shutdown: abandon it and
        # fail whatever it will never process
        try:
            self._pending.put(None, timeout=5)
        except queue.Full:
            while True:
                try:
                    item = self._pending.get_nowait()
                except queue.Empty:
                    break
                if item is not None:
                    self._fail(item[0], RuntimeError("server shutting down"))
        self._finalize_thread.join(timeout=60)
        # fail anything still queued so no handler thread waits forever
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            req.error = "server shutting down"
            with self._lock:
                self._inflight_seqs -= len(req.seqs)
                self._inflight_cost -= req.cost
            if req.stream_q is not None:
                req.stream_q.put(("error", req.error))
            req.done.set()
        self._drained.set()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            s = dict(self._stats)
            lat = sorted(self._latencies)
            by_kind = {k: sorted(v) for k, v in self._latencies_by_kind.items()}
            s["inflight_sequences"] = self._inflight_seqs
            s["inflight_cost_s"] = round(self._inflight_cost, 3)
            s["cost_unit_s"] = {
                k: round(v, 6) for k, v in self._cost_unit.items()
            }
        s["queue_depth"] = self._queue.qsize()
        s["max_queued_seqs"] = self.max_queued_seqs
        s["max_queued_seconds"] = self.max_queued_seconds
        s["uptime_s"] = round(time.time() - self._started, 3)
        n_batches = s["batches"] + s["fold_batches"]
        s["mean_batch_seqs"] = (
            round(s["batched_sequences"] / n_batches, 3) if n_batches else 0.0
        )
        if lat:
            s["latency_p50_ms"] = round(1e3 * lat[len(lat) // 2], 3)
            s["latency_p95_ms"] = round(1e3 * lat[min(len(lat) - 1, int(0.95 * len(lat)))], 3)
        for kind, kl in by_kind.items():
            if kl:
                s[f"latency_{kind}_p50_ms"] = round(1e3 * kl[len(kl) // 2], 3)
                s[f"latency_{kind}_p95_ms"] = round(
                    1e3 * kl[min(len(kl) - 1, int(0.95 * len(kl)))], 3
                )
        return s

    # --------------------------------------------------------------- batcher

    def _batch_loop(self) -> None:
        # grad mode is per thread: every model call here runs without it
        # (the handles' own no_grad aside), so no kernel's gradient guard fires
        with torch.no_grad():
            while not self._stop.is_set():
                try:
                    first = self._queue.get(timeout=0.1)
                except queue.Empty:
                    continue
                self._dispatch_window(first)

    def _dispatch_window(self, first: _Request) -> None:
        window = [first]
        n = len(first.seqs)
        # drain everything already waiting (requests that arrived while the
        # previous batch was on the device): free coalescing, no added latency
        while n < self.max_batch_seqs:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            window.append(req)
            n += len(req.seqs)
        # then wait out the window for stragglers, counted from the FIRST
        # request's arrival so a lone request never waits longer than the
        # window end to end; after a full batch the window is refill_wait_s
        wait_s = self.refill_wait_s if self._last_batch_full else self.max_wait_s
        deadline = first.enqueued + wait_s
        while n < self.max_batch_seqs:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                req = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            window.append(req)
            n += len(req.seqs)
        self._last_batch_full = n >= self.max_batch_seqs
        # one device batch per distinct options group
        groups: Dict[Tuple, List[_Request]] = {}
        for req in window:
            groups.setdefault(req.key, []).append(req)
        for reqs in groups.values():
            # dispatch phase: tokenize + launch the device work; the
            # finalizer reads batch k back while batch k+1 computes
            try:
                if reqs[0].kind == "fold":
                    fin = self._dispatch_fold_group(reqs)
                elif reqs[0].kind == "score":
                    fin = self._dispatch_score_group(reqs)
                elif reqs[0].kind == "design":
                    fin = self._dispatch_design_group(reqs)
                else:
                    fin = self._dispatch_embed_group(reqs)
            except Exception as e:  # noqa: BLE001 (reported to the client)
                self._fail(reqs, e)
                continue
            while not self._stop.is_set():
                try:
                    self._pending.put((reqs, fin), timeout=0.5)
                    break
                except queue.Full:
                    continue
            else:
                self._fail(reqs, RuntimeError("server shutting down"))

    def _fail(self, reqs: List[_Request], e: BaseException) -> None:
        failed = [r for r in reqs if not r.done.is_set()]
        with self._lock:
            self._stats["errors"] += 1
            self._inflight_seqs -= sum(len(r.seqs) for r in failed)
            self._inflight_cost -= sum(r.cost for r in failed)
        msg = str(e) if isinstance(e, RuntimeError) else f"{type(e).__name__}: {e}"
        for r in failed:
            r.error = msg
            if r.stream_q is not None:
                r.stream_q.put(("error", msg))
            r.done.set()

    def _finalize_loop(self) -> None:
        with torch.no_grad():  # the finalizer dispatches fold chunks and designs
            while True:
                item = self._pending.get()
                if item is None:
                    return
                reqs, fin = item
                try:
                    fin()
                except Exception as e:  # noqa: BLE001 (reported to the client)
                    self._fail(reqs, e)

    def _finish(self, r: _Request, results: List[Dict[str, Any]]) -> None:
        r.result = results
        with self._lock:
            self._inflight_seqs -= len(r.seqs)
            self._inflight_cost -= r.cost
            lat = time.perf_counter() - r.enqueued
            self._latencies.append(lat)
            if len(self._latencies) > 1024:
                del self._latencies[:512]
            by_kind = self._latencies_by_kind[r.kind]
            by_kind.append(lat)
            if len(by_kind) > 1024:
                del by_kind[:512]
        r.done.set()

    def _stream_item(self, r: _Request, idx: int, item: Dict[str, Any]) -> None:
        r.stream_q.put(("item", idx, item))

    def _finish_stream(self, r: _Request) -> None:
        r.stream_q.put(("end", len(r.seqs)))
        self._finish(r, [])

    @staticmethod
    def _owners(reqs: List[_Request]) -> List[Tuple[_Request, int]]:
        """Flattened-pair index -> (owning request, index within request)."""
        return [(r, j) for r in reqs for j in range(len(r.seqs))]

    def _dispatch_fold_group(self, reqs: List[_Request]):
        """Dispatch a fold group in device batches of at most
        ``max_fold_batch_seqs`` sequences (a request may carry up to
        max_request_seqs: the cap bounds the device batch, not the request).

        Only the first chunk is dispatched here; the finalizer dispatches
        chunk k+1 once chunk k's outputs have reached the host, then writes
        chunk k's PDBs. (esm_tpu dispatches chunk k+1 before reading chunk k
        back. Here a fold's dispatch holds the host: its input copy from
        pageable memory synchronizes the stream, and it then launches a
        whole pass of kernels; in that order chunk k's answer would wait for
        chunk k+1's launches.) At most one chunk's outputs are live on the
        device. A chunk that fails (e.g. one sequence runs out of memory)
        fails only the requests owning its sequences."""
        pairs = [(lab, seq) for r in reqs for lab, seq in zip(r.labels, r.seqs)]
        # fold in length-sorted chunks: every batch pads to its longest member
        # and the trunk is O(L^2..L^3); results go back in request order below
        order = sorted(range(len(pairs)), key=lambda i: len(pairs[i][1]))
        chunk_idxs = [
            order[st : st + self.max_fold_batch_seqs]
            for st in range(0, len(order), self.max_fold_batch_seqs)
        ]
        owners = self._owners(reqs)

        def dispatch(idxs):
            from ..models.esmfold.esmfold import FOLD_LENGTH_BUCKET

            chunk = [pairs[i] for i in idxs]
            t0 = time.perf_counter()
            # pad_to_multiple: lengths share a handful of shapes (padded tail
            # positions are mask=0 rows the whole stack already handles)
            out = self.fold_model.infer(
                [seq for _, seq in chunk],
                num_recycles=reqs[0].num_recycles,
                frugal=True,
                pad_to_multiple=FOLD_LENGTH_BUCKET,
            )
            host = {k: out[k][-1:] if k == "positions" else out[k] for k in _FOLD_KEYS}
            host, ready = _readback(host)
            return chunk, host, ready, t0

        first = dispatch(chunk_idxs[0])  # raises -> _batch_loop fails the group

        def finalize():
            buffers = {
                id(r): [None] * len(r.seqs) for r in reqs if r.stream_q is None
            }
            fin, fin_err = first, None
            for ci, idxs in enumerate(chunk_idxs):
                chunk = None
                try:
                    if fin_err is not None:
                        raise fin_err
                    chunk, host, ready, t0 = fin
                    _wait(ready)
                    # dispatch->readback per chunk feeds the admission cost EMA
                    self._observe_cost(
                        "fold",
                        time.perf_counter() - t0,
                        self._fold_units([s for _, s in chunk], reqs[0].num_recycles),
                    )
                except Exception as e:  # noqa: BLE001
                    chunk_reqs = {id(owners[i][0]): owners[i][0] for i in idxs}
                    self._fail(list(chunk_reqs.values()), e)
                    chunk = None
                fin = fin_err = None
                if ci + 1 < len(chunk_idxs):
                    try:
                        fin = dispatch(chunk_idxs[ci + 1])
                    except Exception as e:  # noqa: BLE001
                        fin_err = e
                if chunk is None:
                    continue
                try:
                    pdbs = self.fold_model.output_to_pdb(host)
                    mean_plddt = host["mean_plddt"].double().numpy()
                    ptm = host["ptm"].double().numpy()
                except Exception as e:  # noqa: BLE001
                    chunk_reqs = {id(owners[i][0]): owners[i][0] for i in idxs}
                    self._fail(list(chunk_reqs.values()), e)
                    continue
                for i, (orig, (lab, seq)) in enumerate(zip(idxs, chunk)):
                    r, j = owners[orig]
                    if r.done.is_set():  # failed in an earlier chunk
                        continue
                    item = {
                        "label": lab,
                        "length": len(seq) - seq.count(":"),
                        "num_chains": seq.count(":") + 1,
                        "pdb": pdbs[i],
                        "mean_plddt": round(float(mean_plddt[i]), 4),
                        "ptm": round(float(ptm[i]), 4),
                    }
                    if r.stream_q is not None:
                        # chunks are length-sorted, so streamed fold results
                        # arrive in completion order; "index"=j says where
                        self._stream_item(r, j, item)
                    else:
                        buffers[id(r)][j] = item
                with self._lock:
                    self._stats["fold_batches"] += 1
                    self._stats["batched_sequences"] += len(chunk)
            for r in reqs:
                if r.done.is_set():
                    continue
                if r.stream_q is not None:
                    self._finish_stream(r)
                else:
                    self._finish(r, buffers[id(r)])

        return finalize

    DESIGN_LENGTH_BUCKET = 16  # pad backbones to this multiple

    def _dispatch_design_group(self, reqs: List[_Request]):
        """Inverse-folding requests (ESM-IF1, reference
        esm/inverse_folding/gvp_transformer.py:88-140 sample / util.py:108-131
        score). N samples for one backbone run as ONE batched decode, and
        sampling backbones are padded to DESIGN_LENGTH_BUCKET after their eos
        residue (``sample``'s ``pad_to_multiple``), so results are
        deterministic per (seed, bucket); "bucket": 0 decodes at the exact
        length. ALL device work runs in the returned finalize() on the
        finalizer thread: sample() and score() block until readback, and a
        blocking call in dispatch would hold every other endpoint's batches
        for the whole decode."""

        def finalize():
            t0 = time.perf_counter()
            for r in reqs:
                if r.design_seq is not None:
                    ll_full, ll_coord = self.if_model.score_sequence(
                        r.coords, r.design_seq
                    )
                    out = {
                        "label": r.labels[0], "sequence": r.design_seq,
                        "ll_fullseq": round(ll_full, 6),
                        "ll_withcoord": round(ll_coord, 6),
                    }
                else:
                    seqs = self.if_model.sample(
                        r.coords, temperature=r.temperature, seed=r.seed,
                        partial_seq=r.partial_seq, num_samples=r.num_samples,
                        pad_to_multiple=r.design_bucket or None,
                    )
                    if r.num_samples == 1:
                        seqs = [seqs]
                    out = {
                        "label": r.labels[0], "sequences": seqs,
                        "temperature": r.temperature, "seed": r.seed,
                    }
                self._finish(r, [out])
            with self._lock:
                self._stats["design_batches"] += 1
                self._stats["designed_backbones"] += len(reqs)
            self._observe_cost(
                "design", time.perf_counter() - t0,
                sum(self._design_units(r) for r in reqs),
            )

        return finalize

    def _tokens(self, pairs):
        """(B, T) device tokens of ``pairs`` (T padded to a multiple of 128,
        B by the bucketing policy; padded rows copy row 0, numerically inert
        and dropped on output) and the number of real rows."""
        _, _, toks = self._converter(pairs)
        target = (
            self.max_batch_seqs
            if self.batch_bucket == "max" and len(pairs) > 1
            else None
        )
        toks, real_b = _pad_batch_rows(np.asarray(toks), target)
        # already on the device, so the handle makes no second copy
        return host_to_device(toks, self.model.device), real_b

    def _dispatch_score_group(self, reqs: List[_Request]):
        """Variant-effect scoring (wt-marginals, reference
        examples/variant-prediction/predict.py:107-115): ONE forward on the
        wild-type sequences, score(mt) = logp[mt] - logp[wt] at the mutated
        position. Each request contributes one sequence to the device batch;
        its mutations are host-side post-processing."""
        t0 = time.perf_counter()
        pairs = [(r.labels[0], r.seqs[0]) for r in reqs]
        chunks = []
        for s in range(0, len(pairs), self.max_batch_seqs):
            chunk = pairs[s : s + self.max_batch_seqs]
            toks, real_b = self._tokens(chunk)
            out = self.model(toks)
            chunks.append((out["logits"][:real_b], len(chunk)))
        host, ready = _readback([c for c, _ in chunks])

        prepend = int(self.alphabet.prepend_bos)
        get_idx = self.alphabet.get_idx

        def finalize():
            from ..cli.predict_variants import wt_marginal_score

            _wait(ready)
            # T may differ across chunks; score rows are read per chunk
            arrays = [_numpy(c) for c in host]
            self._observe_cost("score", time.perf_counter() - t0, len(reqs))
            for i, r in enumerate(reqs):
                logp = log_softmax_np(arrays[i // self.max_batch_seqs][i % self.max_batch_seqs])
                scores = {
                    raw: round(wt_marginal_score(
                        logp, idx, get_idx(wt), get_idx(mt), prepend_bos=prepend
                    ), 6)
                    for raw, wt, idx, mt in r.mutations
                }
                self._finish(r, [{
                    "label": r.labels[0],
                    "length": len(r.seqs[0]),
                    "strategy": "wt-marginals",
                    "scores": scores,
                }])
            # stats count in finalize (like embed/fold) so failed device work
            # never reports as processed
            with self._lock:
                for _, n in chunks:
                    self._stats["batches"] += 1
                    self._stats["batched_sequences"] += n

        return finalize

    def _dispatch_embed_group(self, reqs: List[_Request]):
        """Dispatch an embed group in device batches of at most
        ``max_batch_seqs`` sequences; returns the finalize thunk.

        Only the first chunk dispatches eagerly; the finalize thunk
        dispatches chunk k+1 before reading back chunk k (its readback waits
        on chunk k's event only, so chunk k+1 computes meanwhile; at most two
        chunks' outputs are live on the device), and a failing chunk fails
        only its owning requests."""
        pairs = [
            (lab, seq) for r in reqs for lab, seq in zip(r.labels, r.seqs)
        ]
        repr_layers, include = reqs[0].repr_layers, set(reqs[0].include)
        n_layers = self.model.num_layers
        layers = sorted(
            {(i + n_layers + 1) % (n_layers + 1) for i in repr_layers}
        )
        chunks = [
            pairs[st : st + self.max_batch_seqs]
            for st in range(0, len(pairs), self.max_batch_seqs)
        ]
        owners = self._owners(reqs)

        first = self._dispatch_embed_chunk(chunks[0], layers, include)

        def finalize():
            buffers = {
                id(r): [] for r in reqs if r.stream_q is None
            }
            g = 0
            fin, fin_err = first, None
            for ci, chunk in enumerate(chunks):
                nxt = nxt_err = None
                if ci + 1 < len(chunks):
                    try:
                        nxt = self._dispatch_embed_chunk(
                            chunks[ci + 1], layers, include
                        )
                    except Exception as e:  # noqa: BLE001
                        nxt_err = e
                try:
                    if fin_err is not None:
                        raise fin_err
                    items = fin()  # one device chunk read back
                except Exception as e:  # noqa: BLE001
                    chunk_reqs = {
                        id(owners[g + k][0]): owners[g + k][0]
                        for k in range(len(chunk))
                    }
                    self._fail(list(chunk_reqs.values()), e)
                    items = None
                if items is None:
                    g += len(chunk)
                else:
                    for item in items:
                        r, j = owners[g]
                        g += 1
                        if r.done.is_set():  # failed in an earlier chunk
                            continue
                        if r.stream_q is not None:
                            self._stream_item(r, j, item)
                        else:
                            buffers[id(r)].append(item)
                fin, fin_err = nxt, nxt_err
            for r in reqs:
                if r.done.is_set():
                    continue
                if r.stream_q is not None:
                    self._finish_stream(r)
                else:
                    self._finish(r, buffers[id(r)])

        return finalize

    def _dispatch_embed_chunk(self, pairs, layers, include):
        """Launch one device batch and its readback; returns the thunk that
        waits for the readback and builds the items."""
        t0 = time.perf_counter()
        # items hold numpy arrays; serialization (json tolist / npz bytes)
        # happens per request at response time, so json and npz requests
        # share device batches
        toks, real_b = self._tokens(pairs)
        out = self.model(
            toks,
            repr_layers=tuple(layers) if ("mean" in include or "per_tok" in include) else (),
            return_contacts="contacts" in include,
        )

        lengths = [min(len(s), self.truncation_seq_length) for _, s in pairs]
        prepend = int(self.alphabet.prepend_bos)
        reps = out.get("representations", {})
        dev = {}
        if "mean" in include:
            # reduce on the device: (B, T, D) -> (B, D) per layer before the
            # readback (padded rows take length 1 and are dropped)
            lens = np.ones(toks.shape[0], np.int64)
            lens[:real_b] = lengths
            lens = host_to_device(lens, toks.device)
            for k in layers:
                dev[("mean", k)] = _device_mean(reps[k], lens, prepend)[:real_b]
        if "per_tok" in include:
            for k in layers:
                dev[("per_tok", k)] = reps[k][:real_b]
        if "logits" in include:
            dev["logits"] = out["logits"][:real_b]
        if "contacts" in include:
            dev["contacts"] = out["contacts"][:real_b]
        del out, reps
        host, ready = _readback(dev)

        def finalize():
            _wait(ready)
            arrays = {k: _numpy(v) for k, v in host.items()}
            # dispatch->readback feeds the admission cost EMA
            self._observe_cost("embed", time.perf_counter() - t0, len(pairs))

            items: List[Dict[str, Any]] = []
            for i, (lab, seq) in enumerate(pairs):
                L = lengths[i]
                item: Dict[str, Any] = {
                    "label": lab, "length": L, "truncated": len(seq) > L,
                }
                if "mean" in include:
                    item["mean_representations"] = {
                        str(k): arrays[("mean", k)][i] for k in layers
                    }
                if "per_tok" in include:
                    item["representations"] = {
                        str(k): arrays[("per_tok", k)][i, prepend : prepend + L]
                        for k in layers
                    }
                if "logits" in include:
                    item["logits"] = arrays["logits"][i, prepend : prepend + L]
                if "contacts" in include:
                    item["contacts"] = arrays["contacts"][i, :L, :L]
                items.append(item)
            with self._lock:
                self._stats["batches"] += 1
                self._stats["batched_sequences"] += len(pairs)
            return items

        finalize.ready = ready  # the readback's event (None on the CPU)
        return finalize

    # ------------------------------------------------------------------ http

    def _parse_sequences(self, payload: Dict[str, Any], *, fold: bool):
        seqs_in = payload.get("sequences")
        if not isinstance(seqs_in, list) or not seqs_in:
            raise ValueError('"sequences" must be a non-empty list')
        if len(seqs_in) > self.max_request_seqs:
            raise ValueError(
                f"too many sequences in one request ({len(seqs_in)} > "
                f"{self.max_request_seqs}); split the request"
            )
        labels, seqs = [], []
        for j, item in enumerate(seqs_in):
            if isinstance(item, str):
                lab, seq = f"seq{j}", item
            elif isinstance(item, (list, tuple)) and len(item) == 2:
                lab, seq = str(item[0]), str(item[1])
            elif isinstance(item, dict) and "sequence" in item:
                lab, seq = str(item.get("label", f"seq{j}")), str(item["sequence"])
            else:
                raise ValueError(
                    f"sequences[{j}]: expected a string, [label, sequence] "
                    "pair, or {label, sequence} object"
                )
            if not seq:
                raise ValueError(f"sequences[{j}] ({lab!r}): empty sequence")
            if fold:
                # ESMFold maps unknown letters to X (reference misc.py:18-58);
                # ':' separates multimer chains
                bad = [c for c in seq if not (c.isalpha() and c.isupper() or c == ":")]
                if bad:
                    raise ValueError(
                        f"sequences[{j}] ({lab!r}): invalid character {bad[0]!r}"
                    )
                if any(not chain for chain in seq.split(":")):
                    raise ValueError(f"sequences[{j}] ({lab!r}): empty chain around ':'")
                # the trunk folds chain residues + a 25-G linker per ':'; the
                # memory-plan-derived cap must bound THAT length
                n_res = self._fold_effective_len(seq)
                if n_res > self.max_fold_seq_len:
                    raise ValueError(
                        f"sequences[{j}] ({lab!r}): {n_res} residues "
                        "(incl. 25-glycine linkers per ':') exceeds "
                        f"the fold limit ({self.max_fold_seq_len}); folding "
                        "cannot truncate: split the chain or raise "
                        "--max-fold-len"
                    )
            else:
                bad = [c for c in seq if c not in self.alphabet.tok_to_idx]
                if bad:
                    raise ValueError(
                        f"sequences[{j}] ({lab!r}): unknown residue {bad[0]!r}"
                    )
            labels.append(lab)
            seqs.append(seq)
        return labels, seqs

    _FOLD_REF_LEN = 512  # fold cost EMA is normalized to this bucketed length
    _CHAIN_LINKER_LEN = 25  # encode_sequence joins chains with 'G'*25
    # Per-trunk-pass cost shape t(L) ~ a*y^2 + b*y^3 + c in units of the
    # bucket-512 pass (y = L_bucket/512): the y^2 term is the pair tensor's
    # memory traffic, the y^3 term the triangle products, c the fixed cost.
    # Fitted (least largest relative error: 6.13% at each point) to
    # chip_smoke.py [serve]'s single-pass fold times of ESMFold v1 (fast
    # preset, B=1) at buckets 256, 512, 1024 and 2048 on an NVIDIA H100 80GB
    # HBM3, 700.00 W. The short passes are host-bound, and the 256 bucket's
    # time moved between calls more than that error.
    _FOLD_UNIT_L2 = 0.8168
    _FOLD_UNIT_L3 = 0.1250
    _FOLD_UNIT_FIXED = 0.0582

    @classmethod
    def _fold_effective_len(cls, seq: str) -> int:
        """Residues the trunk actually folds: chain residues PLUS the
        25-glycine linker inserted per ':' (esmfold.encode_sequence)."""
        return len(seq) - seq.count(":") + cls._CHAIN_LINKER_LEN * seq.count(":")

    def _fold_passes(self, num_recycles: Optional[int]) -> int:
        """Trunk passes a fold request runs (the trunk's semantics, reference
        trunk.py:190-194): explicit R -> R+1 passes, None -> the
        checkpoint's max_recycles."""
        if num_recycles is None:
            try:
                return max(int(self.fold_model.cfg.trunk.max_recycles), 1)
            except AttributeError:
                return 4
        return int(num_recycles) + 1

    def _fold_units(self, seqs: List[str], num_recycles: Optional[int] = None) -> float:
        """Length- and recycle-normalized fold work: per chain set, the
        polynomial of the 64-bucketed folded length, times the number of
        trunk passes. One unit = one trunk pass of a bucket-512 fold; the
        EMA learns seconds per that unit."""
        from ..models.esmfold.esmfold import FOLD_LENGTH_BUCKET as B

        total = 0.0
        for seq in seqs:
            lb = -(-max(self._fold_effective_len(seq), 1) // B) * B
            y = lb / self._FOLD_REF_LEN
            total += (
                self._FOLD_UNIT_L2 * y * y
                + self._FOLD_UNIT_L3 * y * y * y
                + self._FOLD_UNIT_FIXED
            )
        return total * self._fold_passes(num_recycles)

    @staticmethod
    def _design_units(req: _Request) -> float:
        """Design work: the decode is L steps, each O(d^2 + L*d) per layer
        (projections + attention over <=L cached/encoder keys), so
        t(L) ~ L*(1 + L/d) with d=512: linear until L ~ d, quadratic past
        it. One unit = one 256-residue decode; times the samples."""
        l = max(len(req.coords), 1)
        units = (l / 256.0) * (1.0 + l / 512.0) / 1.5
        return max(units, 0.25) * max(req.num_samples, 1)

    def _estimate_cost(self, req: _Request, units=None) -> float:
        """Estimated device-seconds for a request, from the per-kind EMAs
        (or a given unit table). Caller holds self._lock."""
        units = units if units is not None else self._cost_unit
        if req.kind == "fold":
            return units["fold"] * self._fold_units(req.seqs, req.num_recycles)
        if req.kind == "design":
            return units["design"] * self._design_units(req)
        return units[req.kind] * len(req.seqs)

    def _observe_cost(self, kind: str, seconds: float, units: float) -> None:
        """Fold a measured device-batch service time into the kind's EMA
        (units: sequences for embed/score, _fold_units for fold). A single
        update can at most triple the unit: a cold first call (allocator
        growth, cuBLAS heuristics) measures far above the steady state, and
        an unconstrained EMA would then shed nearly everything until enough
        fast batches wash it out; decay is unclamped so recovery is fast."""
        if units <= 0 or seconds <= 0:
            return
        with self._lock:
            prev = self._cost_unit[kind]
            new = 0.7 * prev + 0.3 * (seconds / units)
            self._cost_unit[kind] = min(new, 3.0 * prev)

    def _enqueue(self, req: _Request) -> _Request:
        if self._stop.is_set():
            raise ValueError("server shutting down")
        n = len(req.seqs)
        if n > self.max_queued_seqs:
            # would never be admitted even on an idle server: a permanent
            # error, not a 429 the client would retry forever
            raise ValueError(
                f"request has {n} sequences but the server admits at most "
                f"{self.max_queued_seqs} in flight; split the request"
            )
        with self._lock:
            req.cost = self._estimate_cost(req)
            cap_s = self.max_queued_seconds
            prior_cost = self._estimate_cost(req, self._cost_prior)
            if cap_s is not None and prior_cost > cap_s:
                # over budget even against an empty backlog: permanent, judged
                # at the STATIC priors (the learned units drift)
                raise ValueError(
                    f"request is estimated at {prior_cost:.1f}s of device time "
                    f"but the server's backlog budget is {cap_s:.0f}s "
                    "(--max-queued-seconds); split the request or raise the "
                    "budget"
                )
            over_count = self._inflight_seqs + n > self.max_queued_seqs
            # an IDLE server always admits (else nothing could ever run when
            # an estimate spikes); the budget caps the backlog BEYOND the
            # request currently being taken on
            over_cost = (
                cap_s is not None
                and self._inflight_cost > 0
                and self._inflight_cost + req.cost > cap_s
            )
            if over_count or over_cost:
                self._stats["rejected"] += 1
                # Retry-After: for a cost-capped rejection the estimated
                # device-seconds already admitted IS the backlog's drain time;
                # count-capped rejections keep the per-kind p95 latency
                lat = sorted(self._latencies_by_kind[req.kind] or self._latencies)
                p95 = lat[min(len(lat) - 1, int(0.95 * len(lat)))] if lat else 1.0
                retry = self._inflight_cost if over_cost else p95
                detail = (
                    f"{self._inflight_cost:.1f}s of estimated work in flight "
                    f"(budget {cap_s:.0f}s)"
                    if over_cost
                    else f"{self._inflight_seqs} sequences in flight "
                    f"(limit {self.max_queued_seqs})"
                )
                raise ServerSaturatedError(
                    f"server saturated: {detail}; retry later",
                    retry_after_s=max(1, round(retry)),
                )
            self._inflight_seqs += n
            self._inflight_cost += req.cost
            self._stats["requests"] += 1
            self._stats["sequences"] += n
        self._queue.put(req)
        return req

    def _submit_fold(self, payload: Dict[str, Any]) -> _Request:
        if self.fold_model is None:
            raise ValueError("no fold model loaded (start the server with --fold-model)")
        labels, seqs = self._parse_sequences(payload, fold=True)
        num_recycles = payload.get("num_recycles")
        if num_recycles is not None and (
            not isinstance(num_recycles, int) or num_recycles < 0
        ):
            raise ValueError(f"num_recycles must be a non-negative int, got {num_recycles!r}")
        return self._enqueue(
            _Request(
                labels, seqs, kind="fold", num_recycles=num_recycles,
                stream_q=_parse_stream(payload),
            )
        )

    _MAX_DESIGN_LEN = 1024  # the decode is O(L^2) attention; bound the work

    def _submit_design(self, payload: Dict[str, Any]) -> _Request:
        """POST /design: {"coords": (L, 3, 3) N/CA/C floats | "pdb": str
        [+ "chain"], "temperature": T, "seed": S, "num_samples": N,
        "partial_seq": str} samples sequences for the backbone; with "seq"
        it scores that sequence instead (avg log-likelihood full/coords)."""
        if self.if_model is None:
            raise ValueError(
                "no inverse-folding model loaded (start the server with --if-model)"
            )
        if payload.get("stream"):
            raise ValueError("stream is not supported on /design (one-row responses)")
        if ("coords" in payload) == ("pdb" in payload):
            raise ValueError('give exactly one of "coords" or "pdb"')
        if "pdb" in payload:
            import tempfile

            from ..models.inverse_folding.util import load_coords

            if not isinstance(payload["pdb"], str) or not payload["pdb"]:
                raise ValueError('"pdb" must be a non-empty PDB file string')
            try:
                with tempfile.NamedTemporaryFile("w", suffix=".pdb") as f:
                    f.write(payload["pdb"])
                    f.flush()
                    coords, _seq = load_coords(f.name, payload.get("chain"))
            except Exception as e:  # noqa: BLE001 (malformed client input)
                # the reader's own errors are not in do_POST's 400 catch set,
                # and an unwound handler thread resets the client's connection
                raise ValueError(f"could not parse PDB payload: {e}")
            coords = np.asarray(coords, np.float32)
            if coords.shape[0] == 0:
                raise ValueError(
                    f"chain {payload.get('chain')!r} not found (or has no "
                    "backbone atoms) in the PDB payload"
                )
        else:
            try:
                coords = np.asarray(payload["coords"], np.float32)
            except (ValueError, TypeError) as e:
                raise ValueError(f"coords not parseable as floats: {e}")
        if coords.ndim != 3 or coords.shape[1:] != (3, 3) or len(coords) < 2:
            raise ValueError(
                f'"coords" must be (L, 3, 3) backbone N/CA/C with L >= 2, '
                f"got shape {tuple(coords.shape)}"
            )
        if len(coords) > self._MAX_DESIGN_LEN:
            raise ValueError(
                f"backbone length {len(coords)} exceeds the design cap "
                f"{self._MAX_DESIGN_LEN}"
            )
        temperature = payload.get("temperature", 1.0)
        if not isinstance(temperature, (int, float)) or not temperature > 0:
            raise ValueError(f"temperature must be > 0, got {temperature!r}")
        seed = payload.get("seed", 0)
        if not isinstance(seed, int) or not 0 <= seed < 2**31:
            raise ValueError(f"seed must be an int in [0, 2^31), got {seed!r}")
        num_samples = payload.get("num_samples", 1)
        if not isinstance(num_samples, int) or not 1 <= num_samples <= 16:
            raise ValueError(f"num_samples must be in [1, 16], got {num_samples!r}")
        bucket = payload.get("bucket", self.DESIGN_LENGTH_BUCKET)
        if not isinstance(bucket, int) or not 0 <= bucket <= 256:
            raise ValueError(
                f"bucket must be an int in [0, 256] (0 = exact length), got {bucket!r}"
            )
        if_alphabet = self.if_model.alphabet
        seq = payload.get("seq")
        if seq is not None:
            if not isinstance(seq, str) or len(seq) != len(coords):
                raise ValueError(
                    '"seq" must be a string with one residue per backbone '
                    f"position ({len(coords)})"
                )
            bad = [c for c in seq if c not in if_alphabet.tok_to_idx]
            if bad:
                raise ValueError(f"unknown residue {bad[0]!r} in seq")
        partial = payload.get("partial_seq")
        if partial is not None:
            if seq is not None:
                raise ValueError('"partial_seq" only applies when sampling (no "seq")')
            if not isinstance(partial, str) or len(partial) > len(coords):
                raise ValueError(
                    '"partial_seq" must be a string no longer than the backbone'
                )
            bad = [c for c in partial if c not in if_alphabet.tok_to_idx]
            if bad:
                raise ValueError(f"unknown residue {bad[0]!r} in partial_seq")
        label = payload.get("label", "design")
        if not isinstance(label, str):
            raise ValueError("label must be a string")
        return self._enqueue(
            _Request(
                [label], ["<backbone>"], kind="design", coords=coords,
                temperature=float(temperature), seed=seed,
                num_samples=num_samples, partial_seq=partial, design_seq=seq,
                design_bucket=bucket,
            )
        )

    def _submit_score(self, payload: Dict[str, Any]) -> _Request:
        if self.model is None:
            raise ValueError("no LM loaded (start the server with a model name)")
        if payload.get("stream"):
            raise ValueError("stream is not supported on /score (one-row responses)")
        seq = payload.get("sequence")
        if not isinstance(seq, str) or not seq:
            raise ValueError('"sequence" must be a non-empty string')
        if len(seq) > self.truncation_seq_length:
            raise ValueError(
                f"sequence length {len(seq)} exceeds the server's "
                f"truncation_seq_length {self.truncation_seq_length}; "
                "variant scores past the truncation would be wrong"
            )
        bad = [c for c in seq if c not in self.alphabet.tok_to_idx]
        if bad:
            raise ValueError(f"unknown residue {bad[0]!r} in sequence")
        muts_in = payload.get("mutations")
        if not isinstance(muts_in, list) or not muts_in:
            raise ValueError('"mutations" must be a non-empty list like ["P76A"]')
        offset = payload.get("offset_idx", 0)
        if not isinstance(offset, int):
            raise ValueError("offset_idx must be an int")
        parsed = []
        for raw in muts_in:
            if (
                not isinstance(raw, str) or len(raw) < 3
                or not raw[1:-1].isdigit()
            ):
                raise ValueError(f"mutation {raw!r}: expected e.g. 'P76A'")
            wt, mt = raw[0], raw[-1]
            idx = int(raw[1:-1]) - offset
            if not 0 <= idx < len(seq):
                raise ValueError(
                    f"mutation {raw!r}: position out of range for length "
                    f"{len(seq)} (offset_idx={offset})"
                )
            if seq[idx] != wt:
                raise ValueError(
                    f"mutation {raw!r}: the listed wildtype does not match "
                    f"the provided sequence ({seq[idx]!r} at that position)"
                )
            if mt not in self.alphabet.tok_to_idx:
                raise ValueError(f"mutation {raw!r}: unknown target residue {mt!r}")
            parsed.append((raw, wt, idx, mt))
        label = str(payload.get("label", "seq0"))
        return self._enqueue(
            _Request([label], [seq], kind="score", mutations=parsed)
        )

    def _submit(self, payload: Dict[str, Any]) -> _Request:
        if self.model is None:
            raise ValueError("no LM loaded (start the server with a model name)")
        labels, seqs = self._parse_sequences(payload, fold=False)
        repr_layers = tuple(payload.get("repr_layers", [-1]))
        n = self.model.num_layers
        for i in repr_layers:
            if not isinstance(i, int) or not -(n + 1) <= i <= n:
                raise ValueError(f"repr_layers entry {i!r} out of range [-{n + 1}, {n}]")
        include = tuple(payload.get("include", ["mean"]))
        for inc in include:
            if inc not in _INCLUDE:
                raise ValueError(f'include entry {inc!r} not in {_INCLUDE}')
        fmt = payload.get("format", "json")
        if fmt not in ("json", "npz"):
            raise ValueError(f'format must be "json" or "npz", got {fmt!r}')
        return self._enqueue(
            _Request(
                labels, seqs, repr_layers, include, fmt=fmt,
                stream_q=_parse_stream(payload),
            )
        )

    def _finished_batches(self) -> int:
        with self._lock:
            return sum(self._stats[k] for k in ("batches", "fold_batches", "design_batches"))

    PROFILE_ATTEMPTS = 3  # /profile windows before a trace without kernels is returned

    def _profile(self, seconds: float, trace_dir: str) -> Tuple[int, int]:
        """A torch.profiler capture of ``seconds`` of whatever the server
        runs: the card's kernels, whichever thread launched them, and the
        CPU operators of every thread; writes ``<trace_dir>/trace.json``.
        The window stays open (up to ``seconds`` more) until a device batch
        has finished inside it, so the capture of a busy server holds its
        device work. A window whose trace holds kernel launches but no
        kernel record is taken again, up to ``PROFILE_ATTEMPTS`` windows.
        Returns (the batches that finished in the last window, the windows
        taken)."""
        from ..utils import profiling

        for attempt in range(1, self.PROFILE_ATTEMPTS + 1):
            with profiling.profile_trace(trace_dir):
                before = self._finished_batches()
                time.sleep(seconds)
                deadline = time.monotonic() + seconds
                while self._finished_batches() == before and time.monotonic() < deadline:
                    time.sleep(0.05)
                batches = self._finished_batches() - before
            if not profiling.trace_lost_kernels(trace_dir):
                break
            logger.warning("profile window %d of %d: kernel launches but no kernel record "
                           "in the trace", attempt, self.PROFILE_ATTEMPTS)
        return batches, attempt

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet by default
                pass

            def _send(
                self,
                code: int,
                obj: Dict[str, Any],
                extra_headers: Optional[Dict[str, str]] = None,
            ) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (extra_headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _stream_response(self, req: _Request) -> None:
                """Write results as they finalize. The response has no
                Content-Length and ends on connection close (HTTP/1.0
                semantics); the terminator frame distinguishes a complete
                stream from a truncated one."""
                fmt = req.fmt
                headers_sent = False

                def frame(obj: Dict[str, Any]) -> None:
                    if fmt == "npz":
                        body = _item_to_npz(obj)
                        self.wfile.write(len(body).to_bytes(8, "big") + body)
                    else:
                        self.wfile.write(json.dumps(_jsonify(obj)).encode() + b"\n")
                    self.wfile.flush()

                while True:
                    try:
                        msg = req.stream_q.get(timeout=1.0)
                    except queue.Empty:
                        if server._drained.is_set():
                            msg = ("error", req.error or "server shutting down")
                        else:
                            continue
                    if msg[0] == "error":
                        if not headers_sent:
                            self._send(500, {"error": msg[1]})
                        else:
                            # status already committed; an in-band error frame
                            # (with no "done" terminator) is all we can signal
                            frame({"error": msg[1]})
                        return
                    if not headers_sent:
                        self.send_response(200)
                        self.send_header(
                            "Content-Type",
                            "application/x-npz-stream" if fmt == "npz"
                            else "application/x-ndjson",
                        )
                        self.send_header("Connection", "close")
                        self.end_headers()
                        headers_sent = True
                    if msg[0] == "end":
                        frame({"done": msg[1]})
                        return
                    _, idx, item = msg
                    frame({"index": idx, **item})

            def do_GET(self):
                if self.path == "/healthz":
                    h = {
                        "status": "ok",
                        "endpoints": (["/embed", "/score"] if server.model else [])
                        + (["/fold"] if server.fold_model else [])
                        + (["/design"] if server.if_model else []),
                        "truncation_seq_length": server.truncation_seq_length,
                    }
                    if server.model is not None:
                        m = server.model
                        h.update(
                            model_kind=m.kind,
                            num_layers=m.num_layers,
                            embed_dim=m.embed_dim,
                        )
                    self._send(200, h)
                elif self.path == "/stats":
                    self._send(200, server.stats())
                else:
                    self._send(404, {"error": f"unknown path {self.path}"})

            def do_POST(self):
                if self.path == "/profile":
                    try:
                        length = int(self.headers.get("Content-Length", 0))
                        payload = json.loads(self.rfile.read(length) or b"{}")
                        seconds = float(payload.get("seconds", 3.0))
                        if not 0 < seconds <= 120:
                            raise ValueError("seconds must be in (0, 120]")
                        trace_dir = str(
                            payload.get("dir", f"/tmp/esm_serve_trace_{int(time.time())}")
                        )
                    except (ValueError, TypeError, json.JSONDecodeError) as e:
                        # TypeError: well-formed JSON of the wrong type, e.g.
                        # {"seconds": null}: a client error, not a 500
                        self._send(400, {"error": str(e)})
                        return
                    if not server._profiling.acquire(blocking=False):
                        self._send(409, {"error": "a profile capture is already running"})
                        return
                    try:
                        batches, attempts = server._profile(seconds, trace_dir)
                    except Exception as e:  # noqa: BLE001
                        self._send(500, {"error": f"{type(e).__name__}: {e}"})
                        return
                    finally:
                        server._profiling.release()
                    self._send(200, {"trace_dir": trace_dir, "seconds": seconds,
                                     "batches": batches, "attempts": attempts})
                    return
                routes = {
                    "/embed": server._submit,
                    "/fold": server._submit_fold,
                    "/score": server._submit_score,
                    "/design": server._submit_design,
                }
                if self.path not in routes:
                    self._send(404, {"error": f"unknown path {self.path}"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(length) or b"{}")
                    if not isinstance(payload, dict):
                        raise ValueError("request body must be a JSON object")
                    req = routes[self.path](payload)
                except ServerSaturatedError as e:
                    # rejected counter already bumped in _enqueue
                    self._send(
                        429,
                        {"error": str(e), "retry_after_s": e.retry_after_s},
                        extra_headers={"Retry-After": str(e.retry_after_s)},
                    )
                    return
                except (ValueError, KeyError, TypeError, json.JSONDecodeError) as e:
                    # TypeError covers well-formed JSON of the wrong shape
                    # (e.g. "repr_layers": 33): without it the handler thread
                    # unwinds and the client sees a reset connection
                    with server._lock:
                        server._stats["errors"] += 1
                    self._send(400, {"error": str(e)})
                    return
                if req.stream_q is not None:
                    self._stream_response(req)
                    return
                # wait for the batcher; if the server drained its queue on
                # shutdown and this request still isn't done, it was orphaned
                # by the enqueue/stop race: fail it rather than hang
                while not req.done.wait(timeout=1.0):
                    if server._drained.is_set():
                        req.error = req.error or "server shutting down"
                        break
                if req.error is not None:
                    self._send(500, {"error": req.error})
                elif req.fmt == "npz":
                    body = _results_to_npz(req.result)
                    self.send_response(200)
                    self.send_header("Content-Type", "application/octet-stream")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self._send(200, {"results": _jsonify(req.result)})

        return Handler


# Admission cost priors in device-seconds a unit: a sequence for embed and
# score, one bucket-512 trunk pass for fold, one 256-residue decode for
# design. The units chip_smoke.py [serve] had learned before its /profile
# capture (ESM2-650M bf16 flash in "max" batches of 16, ESMFold v1 fast,
# ESM-IF1; NVIDIA H100 80GB HBM3, 700.00 W).
_COST_PRIORS = {"embed": 0.02991, "score": 0.017821, "fold": 0.763812, "design": 0.724003}

# the fold outputs a PDB and the response read (positions: the last block's)
_FOLD_KEYS = ("aatype", "positions", "atom37_atom_exists", "residue_index", "plddt",
              "chain_index", "mean_plddt", "ptm")


def _parse_stream(payload: Dict[str, Any]) -> Optional["queue.Queue"]:
    stream = payload.get("stream", False)
    if not isinstance(stream, bool):
        raise ValueError(f"stream must be a bool, got {stream!r}")
    return queue.Queue() if stream else None


def _item_to_npz(obj: Dict[str, Any]) -> bytes:
    """One streamed result as a standalone .npz: nested dicts flatten to
    ``mean/{layer}`` / ``per_tok/{layer}`` keys; scalar fields (label,
    length, index, ...) become 0-d arrays."""
    import io as _io

    arrays: Dict[str, Any] = {}
    for k, v in obj.items():
        if isinstance(v, dict):
            prefix = {"mean_representations": "mean", "representations": "per_tok"}.get(k, k)
            for kk, vv in v.items():
                arrays[f"{prefix}/{kk}"] = _np_safe(vv)
        elif isinstance(v, (str, bool, int, float)):
            arrays[k] = np.asarray(v)
        else:
            arrays[k] = _np_safe(v)
    buf = _io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _np_safe(a):
    """Cast non-native dtypes to float32: np.savez writes them as void bytes
    that clients cannot read, and .tolist() on them yields non-JSON scalars."""
    a = np.asarray(a)
    if a.dtype.kind not in "fiub" or a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return a


def _jsonify(obj):
    """Convert numpy arrays/scalars inside a response tree to JSON-able
    Python values (done per request at response time, not in the batcher)."""
    if isinstance(obj, dict):
        return {k: _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_jsonify(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return _np_safe(obj).tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def _results_to_npz(results: List[Dict[str, Any]]) -> bytes:
    """Serialize /embed results as one .npz: per-sequence arrays are named
    ``{i}/logits``, ``{i}/contacts``, ``{i}/mean/{layer}``,
    ``{i}/per_tok/{layer}``, plus ``labels``/``lengths``/``truncated`` vectors."""
    import io as _io

    arrays: Dict[str, Any] = {
        "labels": np.asarray([r["label"] for r in results]),
        "lengths": np.asarray([r["length"] for r in results], np.int32),
        "truncated": np.asarray([r["truncated"] for r in results], bool),
    }
    for i, r in enumerate(results):
        for field_ in ("logits", "contacts"):
            if field_ in r:
                arrays[f"{i}/{field_}"] = _np_safe(r[field_])
        for name, key in (("mean_representations", "mean"), ("representations", "per_tok")):
            for layer, v in r.get(name, {}).items():
                arrays[f"{i}/{key}/{layer}"] = _np_safe(v)
    buf = _io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _pad_batch_rows(toks, target=None):
    """Pad the batch dim of a (B, T) token batch to the next power of two, or
    to ``target`` rows when given. Padded rows copy row 0 (numerically inert;
    dropped on output)."""
    b = toks.shape[0]
    bp = max(target or 0, 1 << (b - 1).bit_length())
    if bp != b:
        toks = np.concatenate([toks, np.repeat(toks[:1], bp - b, axis=0)])
    return toks, b


def _device_mean(rep: torch.Tensor, lengths: torch.Tensor, prepend: int) -> torch.Tensor:
    """Masked mean of (B, T, D) ``rep`` over each row's real residue
    positions [prepend, prepend + length), in rep's dtype, on its device."""
    pos = torch.arange(rep.shape[1], device=rep.device)[None, :]
    mask = (pos >= prepend) & (pos < prepend + lengths[:, None])
    w = mask.to(rep.dtype)[..., None]
    return (rep * w).sum(1) / w.sum(1).clamp_min(1.0)


def log_softmax_np(logits: np.ndarray) -> np.ndarray:
    """Stable log-softmax over the last (vocabulary) axis, on the host."""
    m = logits.max(-1, keepdims=True)
    return logits - m - np.log(np.exp(logits - m).sum(-1, keepdims=True))


def _readback(tensors):
    """Start copying a tree (dict or list) of device tensors to the host:
    on the card, non-blocking copies into pinned memory followed by a CUDA
    event on the current stream, so that a reader waits for these copies
    only and not for work queued after them. Returns (host tree, event or
    None); the host tensors are valid once ``_wait(event)`` returns."""
    items = tensors.items() if isinstance(tensors, dict) else enumerate(tensors)
    host, event = {}, None
    for k, t in items:
        if t.device.type == "cuda":
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            if event is None:
                event = torch.cuda.Event()
            host[k] = h
        else:
            host[k] = t
    if event is not None:
        event.record(torch.cuda.current_stream())
    return (host if isinstance(tensors, dict) else [host[i] for i in range(len(tensors))]), event


def _wait(event) -> None:
    if event is not None:
        event.synchronize()


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy (bfloat16, which numpy lacks, as float32)."""
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
