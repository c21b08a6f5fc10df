"""The port's esm-serve CLI (esm_tpu_torch.cli.serve) on the CPU (--nogpu),
with checkpoints written by the port: a 2 x 32 ESM-2 (``save_esm2``), a tiny
ESMFold (``save_esmfold``, its LM in a local ``ESM_TPU_CACHE``) and a tiny
ESM-IF1 (``save_if1``). The served answers equal direct calls of the handles
the CLI's flags build; the module starts as a process, serves, and stops on
SIGINT. Every HTTP call has a client timeout; every server is stopped.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

from esm_tpu_torch import pretrained
from esm_tpu_torch.cli import serve
from esm_tpu_torch.data import Alphabet
from esm_tpu_torch.io.export import save_esm2, save_esmfold, save_if1
from esm_tpu_torch.models import esm2

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_NAME = "esm2_t6_8M_UR50D_500K.pt"
SEQ = "MKTVRQERLK"


def _post(url, payload, path="/embed"):
    req = urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=30) as resp:
        return json.loads(resp.read())


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """ESM_TPU_CACHE holding the 2 x 32 LM; an esmfold checkpoint over it."""
    from tests.test_torch_fold_cli import _tiny_cfg
    from esm_tpu_torch.models import esmfold as ef

    model = ef.init_esmfold(_tiny_cfg(), torch.Generator().manual_seed(0), device="cpu")
    cache = tmp_path / "cache"
    cache.mkdir()
    save_esm2(model.esm, cache / LM_NAME)
    fold_path = save_esmfold(model, tmp_path / "esmfold_tiny.pt")
    monkeypatch.setenv("ESM_TPU_CACHE", str(cache))
    return cache, fold_path


def _args(*argv):
    return serve.create_parser().parse_args(list(argv) + ["--port", "0", "--nogpu"])


def test_serve_cli_embed_matches_the_handle(tmp_path):
    """--int8 and --max-batch: /healthz and /embed against the quantized
    handle's direct call (2 x 128, so that int8 selects the linear layers)."""
    cfg = esm2.ESM2Config.from_alphabet(Alphabet.from_architecture("ESM-1b"), num_layers=2,
                                        embed_dim=128, attention_heads=4)
    path, _ = save_esm2(esm2.init(cfg, torch.Generator().manual_seed(5), device="cpu"),
                        tmp_path / "esm2_t2_128.pt")
    srv = serve.start_server(_args(path, "--max-batch", "4", "--max-wait-ms", "50", "--int8",
                                   "--truncation-seq-length", "60"))
    try:
        h = _get(srv.url, "/healthz")
        assert h["status"] == "ok" and h["num_layers"] == 2
        assert h["endpoints"] == ["/embed", "/score"]
        assert srv.max_batch_seqs == 4 and srv.batch_bucket == "max"
        assert any(p.dtype == torch.int8 for p in srv.model.model.parameters())
        r = _post(srv.url, {"sequences": [SEQ], "include": ["mean", "logits"]})["results"][0]
        assert r["length"] == 10 and len(r["logits"]) == 10
        handle, alphabet = pretrained.load_model_and_alphabet(path, device="cpu")
        handle = handle.quantized()
        toks = alphabet.get_batch_converter(60, pad_to_multiple=128)([("x", SEQ)])[2]
        out = handle(toks, repr_layers=[2])
        np.testing.assert_allclose(r["logits"], out["logits"][0, 1:11].numpy(), atol=1e-5)
        np.testing.assert_allclose(r["mean_representations"]["2"],
                                   out["representations"][2][0, 1:11].mean(0).numpy(), atol=1e-5)
    finally:
        srv.stop()


def test_serve_cli_flags_set_options(cache):
    """--bf16 --flash set the LM's compute dtype and K1, the fold's trunk and
    LM dtypes, K1 and K6; --fold-chunk-size the trunk's chunks; /fold and
    /embed answer (the plain versions of the kernels on the CPU)."""
    cache_dir, fold_path = cache
    srv = serve.start_server(_args(str(cache_dir / LM_NAME), "--fold-model", str(fold_path),
                                   "--fold-chunk-size", "32", "--max-fold-batch", "2",
                                   "--bf16", "--flash", "--truncation-seq-length", "60"))
    try:
        assert _get(srv.url, "/healthz")["endpoints"] == ["/embed", "/score", "/fold"]
        assert srv.model.cfg.compute_dtype == torch.bfloat16 and srv.model.cfg.use_flash
        fc = srv.fold_model.cfg
        assert fc.trunk.chunk_size == 32 and fc.trunk.use_flash_tri
        assert fc.trunk.compute_dtype == fc.esm.compute_dtype == torch.bfloat16
        assert fc.esm.use_flash and srv.max_fold_batch_seqs == 2
        assert srv.model.device.type == srv.fold_model.device.type == "cpu"
        out = _post(srv.url, {"sequences": ["MKTVRQ"], "num_recycles": 0}, path="/fold")
        assert out["results"][0]["pdb"].startswith("ATOM")
        r = _post(srv.url, {"sequences": [SEQ]})["results"][0]
        assert np.isfinite(r["mean_representations"]["2"]).all()
    finally:
        srv.stop()


def test_serve_cli_design_and_derived_fold_cap(cache, tmp_path):
    """--if-model serves /design; --max-fold-len 0 derives the cap from the
    memory plan on the CPU's memory; --fp32-precision turns TF32 off."""
    from esm_tpu_torch.models import inverse_folding as if_mod
    from esm_tpu_torch.parallel.memory_plan import max_fold_length

    _, fold_path = cache
    cfg = if_mod.GVPTransformerConfig.from_alphabet(
        Alphabet.from_architecture("invariant_gvp"), encoder_embed_dim=32, encoder_layers=1,
        encoder_attention_heads=2, encoder_ffn_embed_dim=64, decoder_embed_dim=32,
        decoder_layers=1, decoder_attention_heads=2, decoder_ffn_embed_dim=64,
        gvp_top_k_neighbors=5, gvp_node_hidden_dim_scalar=16, gvp_node_hidden_dim_vector=4,
        gvp_edge_hidden_dim_scalar=8, gvp_edge_hidden_dim_vector=1, gvp_num_encoder_layers=1)
    if_path, _ = save_if1(if_mod.init(cfg, torch.Generator().manual_seed(2)),
                          tmp_path / "esm_if1_tiny.pt")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    srv = serve.start_server(_args("--if-model", str(if_path), "--fold-model", str(fold_path),
                                   "--max-fold-len", "0", "--fp32-precision"))
    try:
        assert not torch.backends.cuda.matmul.allow_tf32
        assert _get(srv.url, "/healthz")["endpoints"] == ["/fold", "/design"]
        module = srv.fold_model.model
        nbytes = sum(t.numel() * t.element_size()
                     for t in list(module.parameters()) + list(module.buffers()))
        assert srv.max_fold_seq_len == max_fold_length(
            srv.fold_model.cfg, params_bytes=nbytes, frugal=True, held_outputs=2, batch=4,
            device="cpu")
        coords = np.cumsum(np.random.default_rng(0).normal(0, 1, (10, 3, 3)), 0)
        r = _post(srv.url, {"coords": coords.tolist(), "seed": 3}, path="/design")["results"][0]
        assert r["sequences"][0] == srv.if_model.sample(
            coords.astype(np.float32), seed=3, pad_to_multiple=16)
    finally:
        srv.stop()
        torch.backends.cuda.matmul.allow_tf32 = tf32


def test_serve_cli_needs_a_model():
    with pytest.raises(SystemExit):
        serve.start_server(_args())


def test_serve_module_runs_and_stops(cache, tmp_path):
    """``python -m esm_tpu_torch.cli.serve --nogpu`` as a process: it prints
    its URL, answers /embed like the handle, and exits on SIGINT."""
    cache_dir, _ = cache
    path = str(cache_dir / LM_NAME)
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "esm_tpu_torch.cli.serve", path, "--port", "0", "--nogpu",
         "--prewarm", "--truncation-seq-length", "60"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        url, lines = None, []
        deadline = time.monotonic() + 180
        while url is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if " on http://" in line:
                url = line.split(" on ")[1].split()[0]
        assert url, "".join(lines)
        assert any("prewarmed" in x for x in lines)
        r = _post(url, {"sequences": [SEQ], "include": ["logits"]})["results"][0]
        handle, alphabet = pretrained.load_model_and_alphabet(path, device="cpu")
        toks = alphabet.get_batch_converter(60, pad_to_multiple=128)([("x", SEQ)])[2]
        np.testing.assert_allclose(r["logits"], handle(toks)["logits"][0, 1:11].numpy(),
                                   atol=1e-5)
        proc.send_signal(signal.SIGINT)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0 and "shutting down" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
