"""The port's esm-fold CLI (esm_tpu_torch.cli.fold) and ESMFold loading on
the CPU, with a reference-layout checkpoint written by the port's
``save_esmfold`` and its LM (a 2 x 32 ESM-2 under the registry name that
``esm_type`` "esm2_8M" names) in a local ``ESM_TPU_CACHE``.

The CLI's PDBs must equal, byte for byte, what ``ESMFoldHandle.infer_pdbs``
gives for the same batch on the same weights: both run the same CPU ops.
"""

import logging

import numpy as np
import pytest
import torch

from esm_tpu_torch import pretrained
from esm_tpu_torch.cli import fold
from esm_tpu_torch.data import Alphabet
from esm_tpu_torch.io.export import save_esm2, save_esmfold
from esm_tpu_torch.models import esm2
from esm_tpu_torch.models import esmfold as ef

SEQS = {"short": "MKTVRQERLK", "multi": "MKTAY:RQELSG", "long": "MKTAYIAKQRQISFVKSHFSRQLEE"}


def _tiny_cfg():
    alphabet = Alphabet.from_architecture("ESM-1b")
    return ef.ESMFoldConfig(
        esm=esm2.ESM2Config.from_alphabet(alphabet, num_layers=2, embed_dim=32,
                                          attention_heads=2),
        trunk=ef.FoldingTrunkConfig(
            num_blocks=1, sequence_state_dim=64, pairwise_state_dim=32, sequence_head_width=16,
            pairwise_head_width=16, max_recycles=2,
            structure_module=ef.StructureModuleConfig(c_s=32, c_z=32, c_ipa=8, c_resnet=16,
                                                      no_heads_ipa=4, no_blocks=2)),
        esm_type="esm2_8M",
    )


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """An ESM_TPU_CACHE with the LM, and an esmfold checkpoint beside it."""
    cfg = _tiny_cfg()
    model = ef.init_esmfold(cfg, torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():  # non-zero residual branches, so every op shows in the output
        gen = torch.Generator().manual_seed(1)
        for name, p in model.named_parameters():
            if not name.startswith("esm.") and not p.any():
                p.normal_(0, 0.1, generator=gen)
    cache = tmp_path / "cache"
    cache.mkdir()
    save_esm2(model.esm, cache / "esm2_t6_8M_UR50D_500K.pt")
    path = save_esmfold(model, tmp_path / "esmfold_tiny.pt")
    monkeypatch.setenv("ESM_TPU_CACHE", str(cache))
    fasta = tmp_path / "seqs.fasta"
    fasta.write_text("".join(f">{k}\n{v}\n" for k, v in SEQS.items()))
    return model, path, fasta


def test_save_and_load_esmfold_round_trip(cache):
    model, path, _ = cache
    data = torch.load(path, weights_only=False)
    assert not any(k.startswith("esm.") for k in data["model"])  # the LM rides its own file
    assert data["cfg"]["model"].esm_type == "esm2_8M"
    handle = pretrained.load_esmfold(str(path), device="cpu")
    cfg, loaded, _ = handle
    assert cfg.trunk.num_blocks == 1 and cfg.esm.num_layers == 2 and not cfg.trunk.use_flash_tri
    want = model.state_dict()
    got = loaded.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    fast, _, _ = pretrained.load_esmfold(str(path), fast=True, device="cpu")
    assert fast.trunk.use_flash_tri and fast.esm.use_flash
    assert fast.trunk.compute_dtype == fast.esm.compute_dtype == torch.bfloat16


@pytest.mark.parametrize("extra", [[], ["--serial"], ["--bucket", "--max-tokens-per-batch", "20"]])
def test_fold_cli_matches_infer_pdbs(cache, tmp_path, extra):
    _, path, fasta = cache
    out = tmp_path / "pdb"
    args = fold.create_parser().parse_args(
        ["-i", str(fasta), "-o", str(out), "-m", str(path), "--cpu-only", "--num-recycles", "1",
         *extra])
    assert fold.run(args) == len(SEQS)
    handle = pretrained.load_esmfold(str(path), device="cpu")
    ordered = sorted(SEQS.items(), key=lambda kv: len(kv[1]))
    batches = fold.create_batched_sequence_dataset(ordered, args.max_tokens_per_batch)
    for headers, seqs in batches:
        pdbs = handle.infer_pdbs(seqs, num_recycles=1,
                                 pad_to_multiple=ef.FOLD_LENGTH_BUCKET if args.bucket else None)
        for header, pdb in zip(headers, pdbs):
            assert (out / f"{header}.pdb").read_text() == pdb
    assert (out / "multi.pdb").read_text().count("TER") == 2


def test_fold_cli_skips_a_batch_that_runs_out_of_memory(cache, tmp_path, monkeypatch, caplog):
    _, path, fasta = cache
    real = pretrained.ESMFoldHandle.infer

    def infer(self, sequences, **kw):
        if "MKTVRQERLK" in sequences:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (simulated)")
        return real(self, sequences, **kw)

    monkeypatch.setattr(pretrained.ESMFoldHandle, "infer", infer)
    out = tmp_path / "pdb"
    args = fold.create_parser().parse_args(
        ["-i", str(fasta), "-o", str(out), "-m", str(path), "--cpu-only", "--num-recycles", "0",
         "--max-tokens-per-batch", "12"])
    with caplog.at_level(logging.INFO):
        assert fold.run(args) == 2
    assert not (out / "short.pdb").exists() and (out / "long.pdb").exists()
    assert "Failed (OOM) on sequence short" in caplog.text


@pytest.mark.parametrize("extra", [[], ["--bucket", "--serial", "--bf16-lm"],
                                   ["--max-tokens-per-batch", "12", "--in-flight", "3"]])
def test_fold_cli_plan_prints_without_folding(cache, tmp_path, capsys, extra):
    """--plan prints the worst batch's plan_fold (frugal outputs, --in-flight
    held, --bucket rounding, the live model's bytes, the host's memory on
    the CPU) and max_fold_length under the same flags, and folds nothing."""
    import itertools

    from esm_tpu_torch.parallel import memory_plan

    _, path, fasta = cache
    out = tmp_path / "pdb"
    args = fold.create_parser().parse_args(
        ["-i", str(fasta), "-o", str(out), "-m", str(path), "--cpu-only", "--plan", *extra])
    assert fold.run(args) == 0
    printed = capsys.readouterr().out
    assert not out.exists()
    handle = pretrained.load_esmfold(str(path), device="cpu")
    if args.bf16_lm:
        handle = handle.with_options(lm_dtype=torch.bfloat16)
    ordered = sorted(SEQS.items(), key=lambda kv: len(kv[1]))
    kw = dict(lm_dtype_bytes=2 if args.bf16_lm else 4, frugal=True,
              held_outputs=1 if args.serial else args.in_flight, device="cpu",
              params_bytes=sum(t.numel() * t.element_size() for t in itertools.chain(
                  handle.model.parameters(), handle.model.buffers())))
    plans = []
    for _, seqs in fold.create_batched_sequence_dataset(ordered, args.max_tokens_per_batch):
        length = max(len(ef.encode_sequence(s)[0]) for s in seqs)  # "multi": 11 + 25 linker
        if args.bucket:
            length = -(-length // 64) * 64
        plans.append((memory_plan.plan_fold(handle.cfg, length, batch=len(seqs), **kw),
                      (len(seqs), length)))
    want, shape = max(plans, key=lambda p: p[0]["per_device_bytes"])
    assert f"worst batch B={shape[0]} x L={shape[1]}" in printed
    assert f"verdict: {want['verdict']}" in printed
    assert f"({want['per_device_bytes'] / 1e9:.2f} GB of" in printed
    assert f"~{memory_plan.max_fold_length(handle.cfg, **kw)}" in printed
    assert f"held_outputs={kw['held_outputs']}" in printed


def _ca(pdb: str) -> np.ndarray:
    return np.array([[float(line[30:38]), float(line[38:46]), float(line[46:54])]
                     for line in pdb.splitlines()
                     if line.startswith("ATOM") and line[12:16] == " CA "])


def test_fold_cli_int8(cache, tmp_path, monkeypatch):
    """--int8 (ported since it raised): the CLI's PDBs equal those of
    ``ESMFoldHandle.quantized()`` byte for byte, and their CA coordinates
    stay within esm_tpu's int8 bound of the fp32 run's, 0.15 (max|ref| + 1)
    (a 1-block trunk: the LM's and the trunk's linears at int8). Quantized
    with min_size=1 (the default selects no linear at this size)."""
    import functools

    from esm_tpu_torch import quantization

    monkeypatch.setattr(quantization, "quantize_params",
                        functools.partial(quantization.quantize_params, min_size=1))
    _, path, fasta = cache
    outs = {}
    for tag, extra in (("int8", ["--int8"]), ("fp32", [])):
        outs[tag] = tmp_path / tag
        args = fold.create_parser().parse_args(
            ["-i", str(fasta), "-o", str(outs[tag]), "-m", str(path), "--cpu-only",
             "--num-recycles", "1", *extra])
        assert fold.run(args) == len(SEQS)
    handle = pretrained.load_esmfold(str(path), device="cpu").quantized(min_size=1)
    assert handle.model.trunk.blocks[0].tri_mul_out.linear_z.weight.dtype == torch.int8
    ordered = sorted(SEQS.items(), key=lambda kv: len(kv[1]))
    for headers, seqs in fold.create_batched_sequence_dataset(ordered, args.max_tokens_per_batch):
        for header, want in zip(headers, handle.infer_pdbs(seqs, num_recycles=1)):
            pdb = (outs["int8"] / f"{header}.pdb").read_text()
            assert pdb == want
            ca, ca32 = _ca(pdb), _ca((outs["fp32"] / f"{header}.pdb").read_text())
            err = np.abs(ca - ca32).max()
            assert 0 < err < 0.15 * (np.abs(ca32).max() + 1), (header, err, np.abs(ca32).max())


def test_handle_options(cache):
    _, path, _ = cache
    handle = pretrained.load_esmfold(str(path), device="cpu")
    with pytest.raises(ValueError, match="no float16 path"):
        handle.with_options(lm_dtype=torch.float16, use_flash=True)
    fp16 = handle.with_options(lm_dtype=torch.float16)
    assert fp16.cfg.esm.compute_dtype == torch.float16 and not fp16.cfg.esm.use_flash
    handle.set_chunk_size(4)
    assert handle.cfg.trunk.chunk_size == 4
    chunked = handle.infer(["MKTVRQERLK"], num_recycles=0)
    whole = handle.with_options(chunk_size=None).infer(["MKTVRQERLK"], num_recycles=0)
    np.testing.assert_allclose(chunked["positions"].numpy(), whole["positions"].numpy(),
                               atol=1e-5, rtol=0)


def test_handle_accepts_pair_spec(cache):
    """with_options(pair_spec=...) gives a handle that folds on a mesh: without
    mesh= its infer names the missing mesh."""
    _, path, _ = cache
    handle = pretrained.load_esmfold(str(path), device="cpu")
    sharded = handle.with_options(pair_spec=("tp",))
    assert sharded.cfg.trunk.pair_spec == ("tp",) and handle.cfg.trunk.pair_spec is None
    assert sharded.model is handle.model
    with pytest.raises(ValueError, match="no mesh was given"):
        sharded.infer(["MKTVRQERLK"], num_recycles=0)


def test_apply_sharded_without_pair_spec_raises(cache):
    """esm_tpu's refusal (esm_tpu/models/esmfold/esmfold.py:293-298)."""
    _, path, _ = cache
    handle = pretrained.load_esmfold(str(path), device="cpu")
    aa = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="apply_sharded needs cfg.trunk.pair_spec set"):
        ef.esmfold.apply_sharded(handle.model, handle.cfg, aa, mesh=None)


def test_fold_cli_needs_a_gpu_or_cpu_only(cache, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    _, path, fasta = cache
    args = fold.create_parser().parse_args(
        ["-i", str(fasta), "-o", str(tmp_path / "pdb"), "-m", str(path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fold.run(args)
