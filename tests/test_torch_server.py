"""The port's dynamic-batching inference server (esm_tpu_torch/runtime/server.py)
against esm_tpu's (esm_tpu/runtime/server.py) on the CPU.

Both servers run side by side in this process on the same weights: a 2 x 32
ESM-2 (esm_tpu's init carried across by ``esm2_state_dict_from_jax``), a tiny
ESMFold (``esmfold_state_dict_from_jax``, the zero-initialized layers
re-drawn) and a tiny ESM-IF1 (``if1_state_dict_from_jax``). The same payloads
go to both: /embed JSON and NPZ (buffered and streamed) and /score agree
within test_torch_esm2.py's TOL (1e-4); /fold agrees with esm_tpu's direct
``infer`` within test_torch_esmfold.py's bounds plus the response's rounding
(PDB coordinates to 1e-3 A on each side, mean pLDDT and pTM to 1e-4; esm_tpu's
fold server fixture needs an absent reference checkpoint); the /design score
path agrees with esm_tpu's. A bucketed /design sample is the port's own
``sample`` with the same seed and bucket (it pads after the eos residue, which
esm_tpu does not). The rest mirrors tests/test_server.py: admission (429 and
the permanent 400), streaming, bad payloads, the batch buckets, prewarm and
the fold cost model, whose constants are held to the card's measured pass
times. Every HTTP call has a client timeout; every fixture stops its server.
"""

import io
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from esm_tpu.data import Alphabet as JaxAlphabet
from esm_tpu.models import esm2 as jesm2
from esm_tpu.pretrained import LMHandle as JaxLMHandle
from esm_tpu.runtime.server import InferenceServer as JaxInferenceServer
from esm_tpu_torch.data import Alphabet
from esm_tpu_torch.io.from_jax import (
    esm2_state_dict_from_jax,
    esmfold_state_dict_from_jax,
    if1_state_dict_from_jax,
)
from esm_tpu_torch.models import esm2 as tesm2
from esm_tpu_torch.pretrained import ESMFoldHandle, IFHandle, LMHandle
from esm_tpu_torch.runtime import server as server_mod
from esm_tpu_torch.runtime.server import InferenceServer

SEQS = [
    "MKTVRQERLKSIVRILERSKEPVSGAQLAEELSVSRQVIVQDIAYLRSLGYNIVATPRGYVLA",
    "KALTARQQEVFDLIRDHISQTGMPPTRAEIA",
    "QEVFDLIRD",
]
TOL = dict(atol=1e-4, rtol=1e-4)  # test_torch_esm2.py's
SIZE = dict(num_layers=2, embed_dim=32, attention_heads=2)
HTTP_TIMEOUT = 120


def _lm_pair(seed=0, **options):
    """(esm_tpu LMHandle, port LMHandle) on the same weights."""
    jalpha = JaxAlphabet.from_architecture("ESM-1b")
    jcfg = jesm2.ESM2Config.from_alphabet(jalpha, **SIZE)
    params = jesm2.init(jax.random.PRNGKey(seed), jcfg)
    alphabet = Alphabet.from_architecture("ESM-1b")
    cfg = tesm2.ESM2Config.from_alphabet(alphabet, **SIZE, **options)
    model = tesm2.ESM2(cfg, device="cpu")
    model.load_state_dict(
        esm2_state_dict_from_jax(jax.tree.map(np.asarray, params), jcfg), strict=True)
    return JaxLMHandle("esm2", jcfg, params, jalpha), LMHandle("esm2", cfg, model, alphabet)


@pytest.fixture(scope="module")
def server():
    jmodel, model = _lm_pair()
    srv = InferenceServer(model, max_wait_ms=150.0, truncation_seq_length=60).start()
    yield srv, model
    srv.stop()


@pytest.fixture(scope="module")
def jax_server():
    jmodel, _ = _lm_pair()
    srv = JaxInferenceServer(jmodel, max_wait_ms=150.0, truncation_seq_length=60).start()
    yield srv, jmodel
    srv.stop()


def _post_raw(srv, payload, path="/embed"):
    req = urllib.request.Request(
        srv.url + path,
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as resp:
        return resp.headers, resp.read()


def _post(srv, payload, path="/embed"):
    return json.loads(_post_raw(srv, payload, path)[1])


def _get(srv, path):
    with urllib.request.urlopen(srv.url + path, timeout=30) as resp:
        return json.loads(resp.read())


def _expect_error(srv, payload, code, frag=None, path="/embed"):
    with pytest.raises(urllib.error.HTTPError) as exc_info:
        _post(srv, payload, path=path)
    assert exc_info.value.code == code, payload
    body = json.loads(exc_info.value.read())
    if frag is not None:
        assert frag in body["error"], (payload, body)
    return exc_info.value, body


def _direct(model, pairs, **kw):
    """A direct handle call on the batch converter's tokens (T padded to 128,
    as the server pads)."""
    _, _, toks = model.alphabet.get_batch_converter(60, pad_to_multiple=128)(pairs)
    return model(toks, **kw)


def test_healthz(server):
    srv, _ = server
    h = _get(srv, "/healthz")
    assert h["status"] == "ok" and h["model_kind"] == "esm2" and h["num_layers"] == 2
    assert h["endpoints"] == ["/embed", "/score"]


def test_embed_matches_jax_server_and_direct_call(server, jax_server):
    srv, model = server
    payload = {
        "sequences": [["a", SEQS[0]], ["b", SEQS[1]]],
        "repr_layers": [0, -1],
        "include": ["mean", "per_tok", "logits", "contacts"],
    }
    results = _post(srv, payload)["results"]
    want = _post(jax_server[0], payload)["results"]
    assert [r["label"] for r in results] == ["a", "b"]
    for got, ref in zip(results, want):
        assert got.keys() == ref.keys()
        assert (got["length"], got["truncated"]) == (ref["length"], ref["truncated"])
        for k in ("0", "2"):
            np.testing.assert_allclose(got["mean_representations"][k],
                                       ref["mean_representations"][k], **TOL)
            np.testing.assert_allclose(got["representations"][k], ref["representations"][k],
                                       **TOL)
        np.testing.assert_allclose(got["logits"], ref["logits"], **TOL)
        np.testing.assert_allclose(got["contacts"], ref["contacts"], **TOL)

    direct = _direct(model, [("a", SEQS[0]), ("b", SEQS[1])], repr_layers=[0, 2],
                     return_contacts=True)
    for i, (r, seq) in enumerate(zip(results, SEQS[:2])):
        L = min(len(seq), 60)
        assert r["length"] == L and r["truncated"] == (len(seq) > 60)
        rep = direct["representations"][2][i, 1 : L + 1].numpy()
        np.testing.assert_allclose(np.asarray(r["representations"]["2"]), rep, atol=1e-5)
        np.testing.assert_allclose(np.asarray(r["mean_representations"]["2"]), rep.mean(0),
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(r["logits"]),
                                   direct["logits"][i, 1 : L + 1].numpy(), atol=1e-5)
        np.testing.assert_allclose(np.asarray(r["contacts"]),
                                   direct["contacts"][i, :L, :L].numpy(), atol=1e-5)


def test_device_mean_matches_jax():
    """The on-device masked mean, against esm_tpu's jitted one."""
    from esm_tpu.runtime.server import _device_mean as jax_device_mean

    rng = np.random.RandomState(0)
    rep = rng.randn(4, 128, 16).astype(np.float32)
    lengths = np.array([10, 126, 1, 60], np.int32)
    want = np.asarray(jax_device_mean(rep, jax.numpy.asarray(lengths), 128, 1))
    got = server_mod._device_mean(torch.from_numpy(rep), torch.from_numpy(lengths), 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


def test_concurrent_requests_are_batched(server):
    srv, _ = server
    before = _get(srv, "/stats")
    n = 6
    results = [None] * n
    barrier = threading.Barrier(n)

    def worker(j):
        barrier.wait()
        results[j] = _post(srv, {"sequences": [SEQS[j % 3]], "include": ["mean"]})

    threads = [threading.Thread(target=worker, args=(j,)) for j in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=HTTP_TIMEOUT)
    assert all(r is not None and len(r["results"]) == 1 for r in results)
    # identical sequences must produce identical embeddings across batches
    a = results[0]["results"][0]["mean_representations"]
    b = results[3]["results"][0]["mean_representations"]
    for k in a:
        np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]), atol=1e-5)

    after = _get(srv, "/stats")
    new_reqs = after["requests"] - before["requests"]
    new_batches = after["batches"] - before["batches"]
    assert new_reqs == n
    assert new_batches < new_reqs, (before, after)  # coalescing happened


def test_oversized_request_is_sliced(server):
    """A single request above max_batch_seqs (16) is served in several device
    batches, never one giant padded batch."""
    srv, model = server
    before = _get(srv, "/stats")
    seqs = [SEQS[j % 3][: 5 + j % 7] for j in range(20)]
    out = _post(srv, {"sequences": seqs, "include": ["mean"]})
    assert len(out["results"]) == 20
    after = _get(srv, "/stats")
    assert after["batches"] - before["batches"] >= 2
    # order preserved and numerics independent of slicing
    rep = _direct(model, [("x", seqs[-1])], repr_layers=[2])["representations"][2]
    expect = rep[0, 1 : len(seqs[-1]) + 1].mean(0).numpy()
    np.testing.assert_allclose(
        np.asarray(out["results"][-1]["mean_representations"]["2"]), expect, atol=1e-5)


BAD_EMBED = [
    ({"sequences": []}, "non-empty"),
    ({"sequences": ["MK1TA"]}, "unknown residue"),
    ({"sequences": [""]}, "empty sequence"),
    ({"sequences": ["MKT"], "include": ["bogus"]}, "bogus"),
    ({"sequences": ["MKT"], "repr_layers": [99]}, "out of range"),
    ({"sequences": "MKT"}, "non-empty list"),
]


def test_bad_requests(server, jax_server):
    """The same 400s (and messages) as esm_tpu's server, and a 404."""
    srv, _ = server
    for payload, frag in BAD_EMBED:
        _, body = _expect_error(srv, payload, 400, frag)
        _, jbody = _expect_error(jax_server[0], payload, 400, frag)
        assert body == jbody
    with pytest.raises(urllib.error.HTTPError) as exc_info:
        _post(srv, {"sequences": ["MKT"]}, path="/nope")
    assert exc_info.value.code == 404


def test_admission_control_429(server):
    """Past max_queued_seqs the server rejects with 429 + Retry-After instead
    of queueing without bound; once the backlog drains, requests are admitted
    again and stats expose the rejection."""
    _, model = server
    srv = InferenceServer(
        model,
        max_wait_ms=2000.0,  # hold the first request in the batch window
        truncation_seq_length=60,
        max_queued_seqs=2,
    ).start()
    try:
        results = {}

        def post_a():
            results["a"] = _post(srv, {"sequences": SEQS[:2]})

        t = threading.Thread(target=post_a)
        t.start()
        for _ in range(100):
            if _get(srv, "/stats")["inflight_sequences"] == 2:
                break
            time.sleep(0.02)
        else:
            pytest.fail("request A never became in-flight")

        err, body = _expect_error(srv, {"sequences": SEQS[2:3]}, 429, "saturated")
        assert int(err.headers["Retry-After"]) >= 1

        t.join(timeout=HTTP_TIMEOUT)
        assert "results" in results["a"]
        ok = _post(srv, {"sequences": SEQS[2:3]})  # backlog drained -> admitted
        assert "results" in ok

        stats = _get(srv, "/stats")
        assert stats["rejected"] >= 1
        assert stats["inflight_sequences"] == 0
        assert stats["max_queued_seqs"] == 2
    finally:
        srv.stop()


def test_unadmittable_request_is_permanent_400(server):
    """A request larger than max_queued_seqs can NEVER be admitted: a
    permanent 400 ("split the request"), not a 429 retried forever."""
    _, model = server
    srv = InferenceServer(model, truncation_seq_length=60, max_queued_seqs=2).start()
    try:
        err, _ = _expect_error(srv, {"sequences": SEQS[:3]}, 400, "split the request")
        assert "Retry-After" not in (err.headers or {})
        ok = _post(srv, {"sequences": SEQS[:2]})
        assert "results" in ok
    finally:
        srv.stop()


def test_npz_format_matches_json_and_jax(server, jax_server):
    """format='npz' returns one binary .npz whose arrays equal the JSON
    response's values, and esm_tpu's npz within TOL."""
    srv, _ = server
    payload = {
        "sequences": [["a", SEQS[0]], ["b", SEQS[1]]],
        "repr_layers": [-1],
        "include": ["mean", "per_tok", "contacts"],
    }
    js = _post(srv, payload)["results"]
    headers, body = _post_raw(srv, {**payload, "format": "npz"})
    assert headers["Content-Type"] == "application/octet-stream"
    assert len(body) < len(json.dumps(js)) / 2  # binary beats decimal text
    npz = np.load(io.BytesIO(body))
    jnpz = np.load(io.BytesIO(_post_raw(jax_server[0], {**payload, "format": "npz"})[1]))
    assert sorted(npz.files) == sorted(jnpz.files)
    assert list(npz["labels"]) == ["a", "b"]
    for k in npz.files:
        assert npz[k].dtype == jnpz[k].dtype, k
        if npz[k].dtype.kind == "f":
            np.testing.assert_allclose(npz[k], jnpz[k], **TOL)
        else:
            assert np.array_equal(npz[k], jnpz[k]), k
    for i, r in enumerate(js):
        np.testing.assert_allclose(npz[f"{i}/mean/2"], np.asarray(r["mean_representations"]["2"]),
                                   atol=1e-6)
        np.testing.assert_allclose(npz[f"{i}/per_tok/2"], np.asarray(r["representations"]["2"]),
                                   atol=1e-6)
        np.testing.assert_allclose(npz[f"{i}/contacts"], np.asarray(r["contacts"]), atol=1e-6)
        assert npz["lengths"][i] == r["length"]
    _expect_error(srv, {**payload, "format": "parquet"}, 400)


def test_npz_and_json_with_bf16_model():
    """With bf16 compute npz arrays come back as readable float32 (numpy has
    no bfloat16) and the JSON path emits plain floats."""
    _, model = _lm_pair(compute_dtype=torch.bfloat16)
    srv = InferenceServer(model, max_wait_ms=30.0, truncation_seq_length=60).start()
    try:
        payload = {"sequences": [SEQS[2]], "include": ["mean", "per_tok"], "format": "npz"}
        npz = np.load(io.BytesIO(_post_raw(srv, payload)[1]))
        assert npz["0/per_tok/2"].dtype == np.float32
        assert npz["0/mean/2"].dtype == np.float32
        assert np.isfinite(npz["0/per_tok/2"]).all()
        js = _post(srv, {**payload, "format": "json"})["results"][0]
        per_tok = np.asarray(js["representations"]["2"], np.float32)
        np.testing.assert_allclose(per_tok, npz["0/per_tok/2"], atol=1e-6)
        # the bf16 values themselves: a direct bf16 call, rounded the same way
        direct = _direct(model, [("x", SEQS[2])], repr_layers=[2])["representations"][2]
        np.testing.assert_array_equal(
            npz["0/per_tok/2"], direct[0, 1 : len(SEQS[2]) + 1].float().numpy())
    finally:
        srv.stop()


def test_score_endpoint_matches_wt_marginals(server, jax_server):
    """/score == the variant CLI's wt-marginals arithmetic (reference
    predict.py:107-115), and esm_tpu's /score within TOL."""
    from esm_tpu_torch.cli.predict_variants import label_row, wt_marginal_score

    srv, model = server
    seq = SEQS[1]
    payload = {"sequence": seq, "mutations": ["K1A", "T4W", "A31G"], "offset_idx": 1,
               "label": "wt"}
    r = _post(srv, payload, path="/score")["results"][0]
    want = _post(jax_server[0], payload, path="/score")["results"][0]
    assert r["label"] == "wt" and r["strategy"] == "wt-marginals"
    assert set(r["scores"]) == {"K1A", "T4W", "A31G"}
    assert r.keys() == want.keys() and r["length"] == want["length"]
    for raw in r["scores"]:
        assert r["scores"][raw] == pytest.approx(want["scores"][raw], abs=1e-4), raw

    _, _, toks = model.alphabet.get_batch_converter(60)([("wt", seq)])
    token_probs = torch.log_softmax(model(toks)["logits"], dim=-1).numpy()
    a = model.alphabet
    for raw in ("K1A", "T4W", "A31G"):
        expect = label_row(raw, seq, token_probs, a, 1)
        assert expect == wt_marginal_score(token_probs[0], int(raw[1:-1]) - 1,
                                           a.get_idx(raw[0]), a.get_idx(raw[-1]))
        assert np.isclose(r["scores"][raw], expect, atol=1e-4), raw

    for bad, frag in [
        ({"sequence": seq, "mutations": ["Q1A"], "offset_idx": 1}, "does not match"),
        ({"sequence": seq, "mutations": ["K99A"], "offset_idx": 1}, "out of range"),
        ({"sequence": seq, "mutations": ["bogus"]}, "expected e.g."),
        ({"sequence": seq, "mutations": []}, "non-empty list"),
        ({"sequence": "X" * 100, "mutations": ["X1A"], "offset_idx": 1}, "truncation"),
        ({"sequence": seq, "mutations": ["K1A"], "stream": True}, "not supported"),
    ]:
        _expect_error(srv, bad, 400, frag, path="/score")


def test_wt_marginal_score_matches_jax():
    from esm_tpu.cli.predict_variants import wt_marginal_score as jax_score
    from esm_tpu_torch.cli.predict_variants import wt_marginal_score

    logp = np.random.RandomState(3).randn(12, 33).astype(np.float32)
    for idx, wt, mt, bos in ((0, 5, 7, 1), (9, 4, 20, 1), (3, 8, 8, 0)):
        assert wt_marginal_score(logp, idx, wt, mt, bos) == jax_score(logp, idx, wt, mt, bos)


def test_batch_bucket_max_outputs_unchanged():
    """batch_bucket='max' (pad multi-request batches to max_batch) must not
    change any response numerics vs the default pow2 bucketing."""
    _, model = _lm_pair()
    srv = InferenceServer(
        model, max_wait_ms=30.0, truncation_seq_length=60, max_batch_seqs=8,
        batch_bucket="max",
    ).start()
    try:
        out = _post(srv, {
            "sequences": [["a", SEQS[0]], ["b", SEQS[1]], ["c", SEQS[2]]],
            "include": ["mean", "logits"],
        })
        direct = _direct(model, [("a", SEQS[0]), ("b", SEQS[1]), ("c", SEQS[2])],
                         repr_layers=[2])
        for i, (r, seq) in enumerate(zip(out["results"], SEQS)):
            L = min(len(seq), 60)
            np.testing.assert_allclose(np.asarray(r["logits"]),
                                       direct["logits"][i, 1 : L + 1].numpy(), atol=1e-5)
    finally:
        srv.stop()
    with pytest.raises(ValueError, match="batch_bucket"):
        InferenceServer(model, batch_bucket="nope")


def test_pad_batch_rows_buckets():
    toks = np.arange(6).reshape(3, 2)
    padded, real = server_mod._pad_batch_rows(toks)
    assert real == 3 and padded.shape == (4, 2) and (padded[3] == toks[0]).all()
    padded, real = server_mod._pad_batch_rows(toks, target=8)
    assert real == 3 and padded.shape == (8, 2)
    assert server_mod._pad_batch_rows(toks[:1])[0].shape == (1, 2)


def test_msa_model_rejected():
    alphabet = Alphabet.from_architecture("msa_transformer")
    fake = type("H", (), {"kind": "msa", "alphabet": alphabet})()
    with pytest.raises(ValueError, match="single-sequence"):
        InferenceServer(fake)
    with pytest.raises(ValueError, match="at least one"):
        InferenceServer()


# ---------------------------------------------------------------- streaming


def _parse_npz_frames(raw):
    frames, off = [], 0
    while off < len(raw):
        n = int.from_bytes(raw[off : off + 8], "big")
        off += 8
        frames.append(np.load(io.BytesIO(raw[off : off + n])))
        off += n
    assert off == len(raw), "trailing bytes after the last npz frame"
    return frames


def test_stream_embed_ndjson_matches_buffered(server, jax_server):
    """stream=true delivers one NDJSON object per sequence plus a {"done": N}
    terminator, identical to the buffered response and to esm_tpu's stream."""
    srv, _ = server
    payload = {
        "sequences": [["a", SEQS[0]], ["b", SEQS[1]], ["c", SEQS[2]]],
        "repr_layers": [-1],
        "include": ["mean", "logits"],
    }
    buffered = _post(srv, payload)["results"]
    headers, raw = _post_raw(srv, {**payload, "stream": True})
    assert headers["Content-Type"] == "application/x-ndjson"
    lines = [json.loads(line) for line in raw.splitlines()]
    assert lines[-1] == {"done": 3}
    items = sorted(lines[:-1], key=lambda d: d["index"])
    assert [d["index"] for d in items] == [0, 1, 2]
    jlines = [json.loads(x) for x in _post_raw(jax_server[0], {**payload, "stream": True})[1]
              .splitlines()]
    jitems = sorted(jlines[:-1], key=lambda d: d["index"])
    for got, want, ref in zip(items, buffered, jitems):
        assert got["label"] == want["label"] and got["length"] == want["length"]
        assert got.keys() == ref.keys()
        np.testing.assert_allclose(np.asarray(got["logits"]), np.asarray(want["logits"]),
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(got["logits"]), np.asarray(ref["logits"]), **TOL)
        for k, v in want["mean_representations"].items():
            np.testing.assert_allclose(np.asarray(got["mean_representations"][k]),
                                       np.asarray(v), atol=1e-6)


def test_stream_embed_npz_frames(server, jax_server):
    """Binary streaming: length-prefixed standalone .npz frames, equal to
    esm_tpu's frames within TOL and to a direct call."""
    srv, model = server
    payload = {
        "sequences": [["a", SEQS[0]], ["b", SEQS[1]]],
        "repr_layers": [-1],
        "include": ["logits", "contacts"],
        "format": "npz",
        "stream": True,
    }
    headers, raw = _post_raw(srv, payload)
    assert headers["Content-Type"] == "application/x-npz-stream"
    frames = _parse_npz_frames(raw)
    assert int(frames[-1]["done"]) == 2
    items = sorted(frames[:-1], key=lambda f: int(f["index"]))
    jframes = _parse_npz_frames(_post_raw(jax_server[0], payload)[1])
    jitems = sorted(jframes[:-1], key=lambda f: int(f["index"]))
    assert len(items) == 2
    direct = _direct(model, [("a", SEQS[0]), ("b", SEQS[1])], return_contacts=True)
    for i, (f, jf, seq) in enumerate(zip(items, jitems, SEQS[:2])):
        L = min(len(seq), 60)
        assert sorted(f.files) == sorted(jf.files)
        assert str(f["label"]) == "ab"[i] and int(f["length"]) == L
        np.testing.assert_allclose(f["logits"], direct["logits"][i, 1 : L + 1].numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(f["contacts"], direct["contacts"][i, :L, :L].numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(f["logits"], jf["logits"], **TOL)
        np.testing.assert_allclose(f["contacts"], jf["contacts"], **TOL)


def test_stream_validation(server):
    srv, _ = server
    _expect_error(srv, {"sequences": ["MKT"], "stream": "yes"}, 400, "stream must be a bool")


def test_wrong_type_payload_is_400(server):
    """Well-formed JSON of the wrong type must come back as a 400, not a
    dropped connection from an unwound handler."""
    srv, _ = server
    for payload in (
        {"sequences": ["MKT"], "repr_layers": 33},
        {"sequences": ["MKT"], "include": 5},
        {"sequences": ["MKT"], "repr_layers": [None]},
    ):
        _expect_error(srv, payload, 400)
    with pytest.raises(urllib.error.HTTPError) as exc_info:
        req = urllib.request.Request(srv.url + "/embed", data=b"[1, 2]")
        urllib.request.urlopen(req, timeout=HTTP_TIMEOUT)
    assert exc_info.value.code == 400


def test_adaptive_refill_window():
    """After a FULL batch the wait window extends to refill_wait_ms so the
    re-post wave coalesces; light-load requests keep the short window."""
    _, model = _lm_pair()
    srv = InferenceServer(
        model, max_batch_seqs=4, max_wait_ms=1.0, refill_wait_ms=400.0,
        truncation_seq_length=60,
    ).start()
    try:
        assert srv.max_wait_s == pytest.approx(0.001)
        assert srv.refill_wait_s == pytest.approx(0.4)
        assert srv._last_batch_full is False
        _post(srv, {"sequences": [SEQS[0], SEQS[1], SEQS[2], SEQS[0]], "include": ["mean"]})
        assert srv._last_batch_full is True
        before = _get(srv, "/stats")
        results = [None, None]

        def w(j, delay):
            time.sleep(delay)
            results[j] = _post(srv, {"sequences": [SEQS[j]], "include": ["mean"]})

        ts = [threading.Thread(target=w, args=(j, 0.05 * j)) for j in range(2)]
        [t.start() for t in ts]
        [t.join(timeout=HTTP_TIMEOUT) for t in ts]
        assert all(r is not None for r in results)
        after = _get(srv, "/stats")
        assert after["batches"] - before["batches"] == 1, (before, after)
        assert srv._last_batch_full is False
    finally:
        srv.stop()


def test_prewarm(server):
    """prewarm() walks the production dispatch for every standard (B, T)
    shape and leaves request stats untouched (it is not traffic)."""
    srv, _ = server
    before = _get(srv, "/stats")
    assert srv.prewarm(lengths=[10, 30], batch_sizes=(1, 2)) == 4
    after = _get(srv, "/stats")
    assert after["requests"] == before["requests"]
    out = _post(srv, {"sequences": [SEQS[0]], "include": ["mean"]})
    assert len(out["results"]) == 1
    # the default walks every 128-token bucket up to the truncation length
    # at B = 1, 2, 4, 8, 16 (pow2)
    assert srv.prewarm() == 5
    assert srv.build_kernels() == []  # nothing to build for CPU handles


def test_mixed_endpoint_soak(server):
    """A seeded concurrent mix of /embed (json+npz), /score, bad requests and
    /stats polls: every well-formed request succeeds, every malformed one
    fails with 400, and the server stays consistent (no 500s, no hangs)."""
    import random

    srv, _ = server
    errors = []

    def client(j):
        rng = random.Random(j)
        for _ in range(6):
            kind = rng.random()
            try:
                if kind < 0.4:
                    out = _post(srv, {"sequences": [SEQS[rng.randrange(3)]],
                                      "include": rng.choice([["mean"], ["mean", "logits"]])})
                    assert out["results"][0]["length"] > 0
                elif kind < 0.55:
                    _, body = _post_raw(srv, {"sequences": [SEQS[rng.randrange(3)]],
                                              "include": ["mean"], "format": "npz"})
                    assert np.load(io.BytesIO(body))["lengths"][0] > 0
                elif kind < 0.7:
                    out = _post(srv, {"sequence": SEQS[1], "mutations": ["K1A"],
                                      "offset_idx": 1}, path="/score")
                    assert "K1A" in out["results"][0]["scores"]
                elif kind < 0.85:
                    try:
                        _post(srv, {"sequences": ["MK1"]})
                        errors.append("bad request did not 400")
                    except urllib.error.HTTPError as e:
                        assert e.code == 400
                        e.read()
                else:
                    _get(srv, "/stats")
            except Exception as e:  # noqa: BLE001
                errors.append(f"client {j}: {type(e).__name__}: {e}")

    import sys

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # switch threads often: lost updates would show
    try:
        threads = [threading.Thread(target=client, args=(j,)) for j in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=4 * HTTP_TIMEOUT)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    stats = _get(srv, "/stats")
    assert stats["errors"] >= 1
    assert stats["requests"] >= 20
    # every admitted request released what it was charged
    assert stats["inflight_sequences"] == 0 and stats["inflight_cost_s"] == 0


def test_profile_endpoint(server, tmp_path):
    """/profile captures a torch.profiler trace of concurrent server work
    and reports the device batches that finished in its window; a second
    capture while one runs is a 409, a bad window a 400."""
    srv, _ = server
    trace_dir = str(tmp_path / "trace")
    worker = threading.Thread(
        target=lambda: _post(srv, {"sequences": [SEQS[0]], "include": ["mean"]}))
    results = {}

    def capture():
        results["out"] = _post(srv, {"seconds": 1.0, "dir": trace_dir}, path="/profile")

    cap = threading.Thread(target=capture)
    cap.start()
    time.sleep(0.2)
    worker.start()
    _expect_error(srv, {"seconds": 0.5, "dir": str(tmp_path / "t2")}, 409, "already running",
                  path="/profile")
    worker.join(timeout=HTTP_TIMEOUT)
    cap.join(timeout=HTTP_TIMEOUT)
    assert results["out"] == {"trace_dir": trace_dir, "seconds": 1.0, "batches": 1,
                              "attempts": 1}
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("linear" in n or "addmm" in n or "matmul" in n for n in names)
    for bad in ({"seconds": 0}, {"seconds": None}, {"seconds": 500}):
        _expect_error(srv, bad, 400, path="/profile")


@pytest.mark.parametrize("lost", [1, 2, 3])
def test_profile_retakes_a_window_without_kernels(server, tmp_path, monkeypatch, lost):
    """A window whose trace lost its kernel records is taken again, up to
    PROFILE_ATTEMPTS windows; the response counts the windows taken."""
    from esm_tpu_torch.utils import profiling

    srv, _ = server
    verdicts = [True] * lost + [False] * 3
    monkeypatch.setattr(profiling, "trace_lost_kernels", lambda logdir: verdicts.pop(0))
    out = _post(srv, {"seconds": 0.1, "dir": str(tmp_path / "trace")}, path="/profile")
    assert out["attempts"] == min(lost + 1, srv.PROFILE_ATTEMPTS)
    assert len(verdicts) == 3 + lost - out["attempts"]
    assert (tmp_path / "trace" / "trace.json").exists()


def test_trace_lost_kernels(tmp_path):
    """Launches without a kernel record are a lost trace; launches with
    kernels, and host work alone, are not."""
    from esm_tpu_torch.utils.profiling import trace_lost_kernels

    launch = {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel"}
    cu_launch = {"ph": "X", "cat": "cuda_runtime", "name": "cuLaunchKernelEx"}
    kernel = {"ph": "X", "cat": "kernel", "name": "flash_fwd_bf16<64>"}
    op = {"ph": "X", "cat": "cpu_op", "name": "aten::linear"}
    cases = [([op, launch], True), ([op, cu_launch], True), ([op, launch, kernel], False),
             ([op], False)]
    for i, (events, lost) in enumerate(cases):
        d = tmp_path / str(i)
        d.mkdir()
        (d / "trace.json").write_text(json.dumps({"traceEvents": events}, indent=1))
        assert trace_lost_kernels(str(d)) is lost, events


# ---------------------------------------------------------------- cost model


def test_cost_weighted_admission_429(server):
    """Admission charges estimated device-seconds, not sequence counts."""
    _, model = server
    srv = InferenceServer(
        model, max_wait_ms=2000.0, truncation_seq_length=60, max_queued_seconds=1.0,
    ).start()
    srv._cost_unit["embed"] = 0.4  # pretend embeds are expensive
    try:
        results = {}

        def post_a():
            results["a"] = _post(srv, {"sequences": SEQS[:2]})

        t = threading.Thread(target=post_a)
        t.start()
        for _ in range(100):
            if _get(srv, "/stats")["inflight_cost_s"] >= 0.8:
                break
            time.sleep(0.02)
        else:
            pytest.fail("request A never became in-flight")
        err, _ = _expect_error(srv, {"sequences": SEQS[2:3]}, 429, "estimated work in flight")
        assert int(err.headers["Retry-After"]) == 1  # the 0.8 s backlog's drain time
        t.join(timeout=HTTP_TIMEOUT)
        assert "results" in results["a"]
        assert "results" in _post(srv, {"sequences": SEQS[2:3]})
        stats = _get(srv, "/stats")
        assert stats["rejected"] >= 1
        assert stats["inflight_cost_s"] == 0
        assert stats["max_queued_seconds"] == 1.0
    finally:
        srv.stop()


def test_over_budget_request_is_permanent_400(server):
    _, model = server
    srv = InferenceServer(model, truncation_seq_length=60, max_queued_seconds=1.0).start()
    srv._cost_prior["embed"] = 0.6
    srv._cost_unit["embed"] = 0.6
    try:
        _expect_error(srv, {"sequences": SEQS[:2]}, 400, "split the request or raise")
        assert "results" in _post(srv, {"sequences": SEQS[:1]})
    finally:
        srv.stop()


def test_cost_model_learns_and_reports(server):
    _, model = server
    srv = InferenceServer(model, truncation_seq_length=60).start()
    try:
        prior = srv._cost_unit["embed"]
        _post(srv, {"sequences": SEQS})
        stats = _get(srv, "/stats")
        assert stats["cost_unit_s"]["embed"] != prior  # EMA moved
        assert stats["cost_unit_s"]["embed"] > 0
        assert stats["inflight_cost_s"] == 0  # released on finish
        assert "latency_embed_p50_ms" in stats and "latency_embed_p95_ms" in stats
        assert "latency_fold_p50_ms" not in stats  # no folds served
        assert set(stats) >= set(_get(srv, "/stats"))  # the same keys each time
    finally:
        srv.stop()


def test_stats_keys_match_jax(server, jax_server):
    assert set(_get(server[0], "/stats")) == set(_get(jax_server[0], "/stats"))


# Single-pass fold times of ESMFold v1 (fast preset, B=1, num_recycles=0,
# frugal, 64-bucketed) by bucket, and the 512 bucket's fitted time: the
# card's measurement the polynomial was fitted to (chip_smoke.py [serve];
# NVIDIA H100 80GB HBM3, 700.00 W).
CARD_PASS_SECONDS = {256: 0.20913048799999956, 512: 0.6653289129999962,
                     1024: 3.253828471999981, 2048: 14.057451961000027}
CARD_UNIT_SECONDS = 0.706118


def test_fold_cost_matches_measured_scaling(server):
    """unit * units(L) reproduces the card's measured single-pass times at
    every calibration bucket within 11% (tests/test_server.py's tolerance);
    the unit scales with trunk passes; multimers pay for the linker."""
    _, model = server
    srv = InferenceServer(model, truncation_seq_length=60)
    srv._httpd.server_close()
    u = srv._fold_units
    assert (srv._FOLD_UNIT_L2 + srv._FOLD_UNIT_L3 + srv._FOLD_UNIT_FIXED
            == pytest.approx(1.0))  # normalized to the 512 bucket
    for bucket, seconds in CARD_PASS_SECONDS.items():
        est = CARD_UNIT_SECONDS * u(["A" * bucket], 0)  # num_recycles=0: one pass
        assert est == pytest.approx(seconds, rel=0.11), (bucket, est, seconds)
    assert u(["A" * 100], 3) == pytest.approx(4 * u(["A" * 100], 0))
    passes_default = srv._fold_passes(None)
    assert passes_default >= 1
    assert u(["A" * 100]) == pytest.approx(passes_default * u(["A" * 100], 0))
    # 60+25+60 = 145 residues -> bucket 192, more than a 128-bucket monomer
    assert u(["A" * 60 + ":" + "A" * 60], 0) > u(["A" * 100], 0)
    fold_cost = srv._estimate_cost(server_mod._Request(["x"], ["A" * 1000], kind="fold"))
    embed_cost = srv._estimate_cost(server_mod._Request(["x"], ["A" * 1000]))
    assert fold_cost / embed_cost > 100


def test_idle_server_always_admits_and_ema_clamp(server):
    _, model = server
    srv = InferenceServer(model, truncation_seq_length=60, max_queued_seconds=1.0).start()
    srv._cost_unit["embed"] = 50.0
    try:
        assert "results" in _post(srv, {"sequences": SEQS[:2]})  # idle -> admitted
        srv._cost_unit["embed"] = 0.01
        srv._observe_cost("embed", seconds=100.0, units=1)
        assert srv._cost_unit["embed"] == pytest.approx(0.03)  # 3x, not 30+
        srv._observe_cost("embed", seconds=0.001, units=1)
        assert srv._cost_unit["embed"] < 0.022
    finally:
        srv.stop()


def test_zero_budget_disables_cost_cap(server):
    _, model = server
    srv = InferenceServer(model, truncation_seq_length=60, max_queued_seconds=0).start()
    try:
        assert srv.max_queued_seconds is None
        assert "results" in _post(srv, {"sequences": SEQS[:2]})
    finally:
        srv.stop()


# ---------------------------------------------------------------------- /fold


@pytest.fixture(scope="module")
def fold_models():
    """(esm_tpu cfg, params, port ESMFoldHandle): tiny ESMFold, same weights."""
    from tests.test_torch_esmfold import build

    jcfg, jparams, _, cfg, model = build(seed=3)
    model.eval()
    return jcfg, jparams, ESMFoldHandle(cfg, model, Alphabet.from_architecture("ESM-1b"))


@pytest.fixture(scope="module")
def fold_server(fold_models):
    _, _, handle = fold_models
    srv = InferenceServer(fold_model=handle, max_wait_ms=100.0, max_fold_batch_seqs=2).start()
    yield srv, handle
    srv.stop()


FOLD_SEQS = [("long", "MKTVRQERLKSIVRILERSK"), ("short", "MKTV"), ("mid", "MKTVRQERLK"),
             ("tiny", "MKT"), ("dimer", "MKTAY:RQELSG")]


def _pdb_atoms(pdb):
    return np.array([[float(x[i:i + 8]) for i in (30, 38, 46)] + [float(x[60:66])]
                     for x in pdb.splitlines() if x.startswith("ATOM")])


def test_fold_endpoint_matches_jax_infer(fold_server, fold_models):
    """/fold (length-sorted chunks of 2, 64-bucketed, frugal) against
    esm_tpu's direct infer of the same sequences: PDB coordinates within 1e-3
    A plus both sides' printed rounding (1e-3), B-factors (pLDDT, 2 decimals)
    within 1e-3 + 1e-2, mean pLDDT and pTM within 1e-3 / 1e-4 plus 1e-4."""
    from esm_tpu.models import esmfold as jef
    from esm_tpu.models.esmfold.protein import output_to_pdb as jax_output_to_pdb

    jcfg, jparams, _ = fold_models
    srv, _ = fold_server
    out = _post(srv, {"sequences": [[l, s] for l, s in FOLD_SEQS], "num_recycles": 1},
                path="/fold")["results"]
    assert [r["label"] for r in out] == [l for l, _ in FOLD_SEQS]
    want = jef.infer(jparams, jcfg, [s for _, s in FOLD_SEQS], num_recycles=1, frugal=True,
                     pad_to_multiple=64)
    pdbs = jax_output_to_pdb({k: np.array(want[k]) for k in (
        "aatype", "positions", "atom37_atom_exists", "residue_index", "plddt", "chain_index")})
    for r, (lab, seq), pdb, mp, tm in zip(out, FOLD_SEQS, pdbs, np.asarray(want["mean_plddt"]),
                                          np.asarray(want["ptm"])):
        assert r["length"] == len(seq) - seq.count(":")
        assert r["num_chains"] == seq.count(":") + 1
        got, ref = _pdb_atoms(r["pdb"]), _pdb_atoms(pdb)
        assert got.shape == ref.shape and r["pdb"].count(" CA ") == r["length"], lab
        np.testing.assert_allclose(got[:, :3], ref[:, :3], atol=1e-3 + 1e-3, rtol=0)
        np.testing.assert_allclose(got[:, 3], ref[:, 3], atol=1e-3 + 1e-2, rtol=0)
        assert [x[:30] for x in r["pdb"].splitlines()] == [x[:30] for x in pdb.splitlines()]
        assert r["mean_plddt"] == pytest.approx(float(mp), abs=1e-3 + 1e-4)
        assert r["ptm"] == pytest.approx(float(tm), abs=1e-4 + 1e-4)
    assert out[-1]["pdb"].count("TER") == 2


def test_fold_endpoint_matches_direct_infer(fold_server):
    """A lone /fold equals the handle's own bucketed PDB; validation 400s;
    /embed 400s on a fold-only server."""
    from esm_tpu_torch.models.esmfold.esmfold import FOLD_LENGTH_BUCKET

    srv, handle = fold_server
    assert _get(srv, "/healthz")["endpoints"] == ["/fold"]
    alone = _post(srv, {"sequences": ["MKTVRQERLK"], "num_recycles": 1}, path="/fold")
    direct = handle.infer_pdb("MKTVRQERLK", num_recycles=1, frugal=True,
                              pad_to_multiple=FOLD_LENGTH_BUCKET)
    assert alone["results"][0]["pdb"] == direct
    r = alone["results"][0]
    assert 0.0 <= r["mean_plddt"] <= 100.0 and 0.0 <= r["ptm"] <= 1.0
    _expect_error(srv, {"sequences": ["MKT"]}, 400, "no LM loaded")
    for payload, frag in [
        ({"sequences": ["MKT:"]}, "empty chain"),
        ({"sequences": ["MK T"]}, "invalid character"),
        ({"sequences": ["MKT"], "num_recycles": -1}, "non-negative"),
    ]:
        _expect_error(srv, payload, 400, frag, path="/fold")


def test_fold_length_sorted_chunks_preserve_order(fold_server):
    srv, _ = fold_server
    before = _get(srv, "/stats")
    out = _post(srv, {"sequences": [[l, s] for l, s in FOLD_SEQS[:4]], "num_recycles": 0},
                path="/fold")
    assert [r["label"] for r in out["results"]] == [l for l, _ in FOLD_SEQS[:4]]
    for r, (_, s) in zip(out["results"], FOLD_SEQS[:4]):
        assert r["length"] == len(s) and r["pdb"].count(" CA ") == len(s), r["label"]
    after = _get(srv, "/stats")
    assert after["fold_batches"] - before["fold_batches"] == 2  # chunks of 2


def test_stream_fold_completion_order(fold_server):
    """Streamed folds arrive in completion order (length-sorted chunks),
    tagged with their request index, equal to the buffered response."""
    srv, _ = fold_server
    payload = {"sequences": [[l, s] for l, s in FOLD_SEQS[:4]], "num_recycles": 0}
    buffered = _post(srv, payload, path="/fold")["results"]
    headers, raw = _post_raw(srv, {**payload, "stream": True}, path="/fold")
    assert headers["Content-Type"] == "application/x-ndjson"
    lines = [json.loads(line) for line in raw.splitlines()]
    assert lines[-1] == {"done": 4}
    items = lines[:-1]
    assert [d["label"] for d in items] == ["tiny", "short", "mid", "long"]
    by_index = {d["index"]: d for d in items}
    assert sorted(by_index) == [0, 1, 2, 3]
    for j, want in enumerate(buffered):
        got = by_index[j]
        for k in ("label", "pdb", "mean_plddt", "ptm"):
            assert got[k] == want[k], k


def test_fold_length_cap(fold_server):
    """Folds cannot truncate: sequences over max_fold_seq_len get a permanent
    400 up front; a multimer is bounded by chain residues plus 25 per ':'."""
    srv, _ = fold_server
    old = srv.max_fold_seq_len
    srv.max_fold_seq_len = 30
    try:
        _expect_error(srv, {"sequences": ["A" * 31]}, 400, "fold limit", path="/fold")
        assert len(_post(srv, {"sequences": ["AA:AA"]}, path="/fold")["results"]) == 1
        _expect_error(srv, {"sequences": ["AAAA:AAAA"]}, 400, "linker", path="/fold")
    finally:
        srv.max_fold_seq_len = old


def test_fold_chunk_failure_isolated(fold_server):
    """A chunk that fails fails only its owning requests; other requests
    coalesced into the same fold group still complete."""
    srv, _ = fold_server
    real = srv.fold_model

    class _Wrapper:
        def infer(self, seqs, **kw):
            if any(len(s) == 13 for s in seqs):
                raise RuntimeError("synthetic device OOM")
            return real.infer(seqs, **kw)

        def __getattr__(self, name):
            return getattr(real, name)

    srv.fold_model = _Wrapper()
    old_chunk = srv.max_fold_batch_seqs
    srv.max_fold_batch_seqs = 1
    try:
        results = {}

        def post(key, seq):
            try:
                results[key] = _post(srv, {"sequences": [seq]}, path="/fold")
            except urllib.error.HTTPError as e:
                results[key] = e.code

        threads = [threading.Thread(target=post, args=("good", "MKTAYIAKQR")),
                   threading.Thread(target=post, args=("poison", "A" * 13))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=HTTP_TIMEOUT)
        assert results["poison"] == 500
        assert isinstance(results["good"], dict) and "results" in results["good"]
    finally:
        srv.fold_model = real
        srv.max_fold_batch_seqs = old_chunk


def test_prewarm_fold(fold_server):
    srv, _ = fold_server
    before = _get(srv, "/stats")
    assert srv.prewarm_fold(lengths=[10], batch_sizes=(1, 2)) == 2
    assert _get(srv, "/stats")["requests"] == before["requests"]


# -------------------------------------------------------------------- /design

IF_SIZE = dict(
    encoder_embed_dim=32, encoder_layers=1, encoder_attention_heads=2,
    encoder_ffn_embed_dim=64, decoder_embed_dim=32, decoder_layers=1,
    decoder_attention_heads=2, decoder_ffn_embed_dim=64,
    gvp_top_k_neighbors=5, gvp_node_hidden_dim_scalar=16,
    gvp_node_hidden_dim_vector=4, gvp_edge_hidden_dim_scalar=8,
    gvp_edge_hidden_dim_vector=1, gvp_num_encoder_layers=1,
)


@pytest.fixture(scope="module")
def if_models():
    """(esm_tpu IFHandle, port IFHandle) on the same weights (every leaf
    perturbed, so no bias is zero and no LN is the identity)."""
    from esm_tpu.models import inverse_folding as jif
    from esm_tpu.models.inverse_folding.model import GVPTransformerConfig as JaxIFConfig
    from esm_tpu.pretrained import IFHandle as JaxIFHandle
    from esm_tpu_torch.models.inverse_folding.model import (
        GVPTransformerConfig,
        GVPTransformerModel,
    )

    jalpha = JaxAlphabet.from_architecture("invariant_gvp")
    alphabet = Alphabet.from_architecture("invariant_gvp")
    jcfg = JaxIFConfig.from_alphabet(jalpha, **IF_SIZE)
    cfg = GVPTransformerConfig.from_alphabet(alphabet, **IF_SIZE)
    rng = np.random.RandomState(4)
    params = jax.tree.map(
        lambda x: (np.asarray(x) + 0.1 * rng.randn(*np.shape(x))).astype(np.float32),
        jif.init(jax.random.PRNGKey(4), jcfg))
    model = GVPTransformerModel(cfg)
    model.load_state_dict(if1_state_dict_from_jax(params, cfg), strict=True)
    model.eval()
    return (JaxIFHandle(jcfg, jax.tree.map(jax.numpy.asarray, params), jalpha),
            IFHandle(cfg, model, alphabet))


@pytest.fixture(scope="module")
def design_server(if_models):
    _, if_model = if_models
    srv = InferenceServer(if_model=if_model, max_wait_ms=50.0).start()
    yield srv, if_model
    srv.stop()


def _backbone(L, seed=0):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.normal(0, 1.0, (L, 3, 3)).astype(np.float32), axis=0)


def test_design_sample_and_score(design_server, if_models):
    srv, if_model = design_server
    coords = _backbone(12)
    r = _post(srv, {"coords": coords.tolist(), "num_samples": 2, "seed": 7,
                    "temperature": 1.0, "label": "bb1"}, path="/design")["results"][0]
    assert r["label"] == "bb1" and len(r["sequences"]) == 2
    # one batched decode on the 16-bucketed backbone: the port's own sample
    # with the same (seed, bucket)
    assert r["sequences"] == if_model.sample(coords, temperature=1.0, seed=7, num_samples=2,
                                             pad_to_multiple=16)
    out0 = _post(srv, {"coords": coords.tolist(), "seed": 7, "bucket": 0}, path="/design")
    assert out0["results"][0]["sequences"][0] == if_model.sample(coords, temperature=1.0, seed=7)

    # the score path: esm_tpu's score_sequence on the same weights
    seq = "KALTARQQEVFD"
    r = _post(srv, {"coords": coords.tolist(), "seq": seq}, path="/design")["results"][0]
    jif_model, _ = if_models
    ll_full, ll_coord = jif_model.score_sequence(coords, seq)
    assert r["ll_fullseq"] == pytest.approx(ll_full, abs=1e-4)
    assert r["ll_withcoord"] == pytest.approx(ll_coord, abs=1e-4)
    assert (r["ll_fullseq"], r["ll_withcoord"]) == tuple(
        round(x, 6) for x in if_model.score_sequence(coords, seq))
    stats = srv.stats()
    assert stats["cost_unit_s"]["design"] > 0
    assert stats["design_batches"] >= 2 and stats["designed_backbones"] >= 2


def test_design_score_matches_jax_server(design_server, if_models):
    """The same /design score payload to both servers."""
    jif_model, _ = if_models
    jsrv = JaxInferenceServer(if_model=jif_model, max_wait_ms=50.0).start()
    try:
        coords = _backbone(9, seed=5)
        coords[4] = np.nan  # a missing residue
        payload = {"coords": np.where(np.isnan(coords), None, coords).tolist(),
                   "seq": "KALTARQQE", "label": "g"}
        got = _post(design_server[0], payload, path="/design")["results"][0]
        want = _post(jsrv, payload, path="/design")["results"][0]
        assert got.keys() == want.keys() and got["label"] == want["label"] == "g"
        for k in ("ll_fullseq", "ll_withcoord"):
            assert np.isfinite(got[k]) and got[k] == pytest.approx(want[k], abs=1e-4), k
    finally:
        jsrv.stop()


def test_design_validation_errors(design_server):
    srv, _ = design_server

    def expect_400(payload, match):
        _expect_error(srv, payload, 400, match, path="/design")

    expect_400({}, "exactly one")
    expect_400({"coords": [[0, 0, 0]]}, "(L, 3, 3)")
    expect_400({"coords": _backbone(4).tolist(), "pdb": "x"}, "exactly one")
    expect_400({"coords": _backbone(4).tolist(), "temperature": 0}, "temperature")
    expect_400({"coords": _backbone(4).tolist(), "num_samples": 99}, "num_samples")
    expect_400({"coords": _backbone(4).tolist(), "seq": "AG"}, "one residue per")
    expect_400({"coords": _backbone(4).tolist(), "seq": "AGX7"}, "unknown residue")
    expect_400({"coords": _backbone(4).tolist(), "seq": "AGAG", "partial_seq": "A"},
               "only applies")
    expect_400({"coords": _backbone(4).tolist(), "seed": 2**63}, "seed")
    expect_400({"coords": _backbone(4).tolist(), "bucket": -1}, "bucket")
    expect_400({"coords": _backbone(4).tolist(), "stream": True}, "not supported")


def test_design_without_if_model_is_400(server):
    srv, _ = server
    _expect_error(srv, {"coords": _backbone(4).tolist()}, 400, "--if-model", path="/design")


def test_design_from_pdb_payload(design_server):
    """A PDB file string goes through the port's structure reader to the
    same backbone the coords payload uses."""
    srv, if_model = design_server
    coords = _backbone(6, seed=3)
    lines, serial = [], 1
    for i, res in enumerate(coords):
        for a, xyz in zip(("N", "CA", "C"), res):
            lines.append(
                f"ATOM  {serial:5d}  {a:<3s} ALA A{i + 1:4d}    "
                f"{xyz[0]:8.3f}{xyz[1]:8.3f}{xyz[2]:8.3f}  1.00  0.00          {a[0]:>2s}")
            serial += 1
    pdb = "\n".join(lines) + "\nEND\n"
    r = _post(srv, {"pdb": pdb, "chain": "A", "seed": 1}, path="/design")["results"][0]
    rounded = np.round(coords.astype(np.float64), 3).astype(np.float32)
    assert r["sequences"][0] == if_model.sample(rounded, temperature=1.0, seed=1,
                                                pad_to_multiple=16)
    _, body = _expect_error(srv, {"pdb": pdb, "chain": "Z"}, 400, path="/design")
    assert "chain" in body["error"]


def test_healthz_lists_design(design_server):
    """esm_tpu's /healthz never lists /design; the port lists it when an IF
    model is loaded."""
    assert _get(design_server[0], "/healthz")["endpoints"] == ["/design"]


def test_prewarm_design(design_server, server):
    srv, _ = design_server
    assert srv.prewarm_design([8, 12]) == 2
    lm_srv, _ = server
    assert lm_srv.prewarm_design([8]) == 0
    assert lm_srv.prewarm_fold([8]) == 0
