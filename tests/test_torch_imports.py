"""Import hygiene and device rules of the port (esm_tpu_torch):
  * importing it, and every module in it (the ESM-1 and MSA Transformer
    modules, the variant-scoring CLI, the ESM-IF1 modules, the structure
    reader, the inverse-folding CLIs, ``lora`` and ``quantization``, the
    fold losses, the metrics, the structural dataset, the profiling
    utilities, the examples, the server, the fold memory plan, the serving
    CLI, the design apps and their examples, the mesh, ring attention, the
    hub entry points and the NaN checks, parameter sharding, its
    collectives, the pipeline, the scaling model, the sharded example and
    the sharded fold's collectives among them), pulls in neither
    ``jax``, ``optax`` nor ``esm_tpu`` (checked in a fresh interpreter);
  * no source file of the port, nor chip_smoke.py, imports ``jax``,
    ``optax`` or ``esm_tpu``;
  * entry points given no device run on CUDA, so without a GPU they raise.
"""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "esm_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts)
    for p in PKG.rglob("*.py")
    if p.name != "__init__.py"
)


def test_import_leaves_out_jax_and_esm_tpu():
    code = (
        "import sys, importlib\n"
        "import esm_tpu_torch\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "assert {'esm_tpu_torch.lora', 'esm_tpu_torch.quantization',\n"
        "        'esm_tpu_torch.models.esmfold.losses', 'esm_tpu_torch.data.structural',\n"
        "        'esm_tpu_torch.utils.profiling', 'esm_tpu_torch.data.atlas',\n"
        "        'esm_tpu_torch.examples.esmfold_finetune', 'esm_tpu_torch.runtime.server',\n"
        "        'esm_tpu_torch.parallel.memory_plan', 'esm_tpu_torch.cli.serve',\n"
        "        'esm_tpu_torch.apps.lm_design', 'esm_tpu_torch.apps.schedules',\n"
        "        'esm_tpu_torch.apps.ppl.folding', 'esm_tpu_torch.apps.ppl.optimize',\n"
        "        'esm_tpu_torch.apps.ppl.energy', 'esm_tpu_torch.apps.ppl.geometry',\n"
        "        'esm_tpu_torch.examples.lm_design_fixedbb',\n"
        "        'esm_tpu_torch.examples.ppl_two_level_multimer',\n"
        "        'esm_tpu_torch.parallel.mesh', 'esm_tpu_torch.parallel.ring_attention',\n"
        "        'esm_tpu_torch.hubconf', 'esm_tpu_torch.utils.debug',\n"
        "        'esm_tpu_torch.parallel.sharding', 'esm_tpu_torch.parallel.pipeline',\n"
        "        'esm_tpu_torch.parallel.scaling', 'esm_tpu_torch.parallel.tensor_parallel',\n"
        "        'esm_tpu_torch.examples.esm2_infer_sharded',\n"
        "        'esm_tpu_torch.parallel.pair_sharding'} <= set(sys.modules)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'optax', 'esm_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize(
    "path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"], ids=lambda p: p.name
)
def test_no_source_imports_the_jax_package(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "optax", "esm_tpu"), f"{path}: imports {name}"


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")


@pytest.mark.parametrize(
    "entry",
    ["resolve_device", "random_model_and_alphabet", "load_model_and_alphabet_local",
     "extract", "pretrain", "random_esmfold", "load_esmfold", "fold",
     "random_esm1", "random_msa", "predict_variants", "random_if1", "if_sample",
     "if_score", "pretrain_lora", "extract_int8", "esmfold_finetune", "ss_finetune",
     "int8_15b", "contact_prediction", "sm_only", "serve", "serve_memory", "lm_design",
     "ppl_free_hallucination", "ppl_fixed_backbone", "make_mesh", "init_multihost", "hub",
     "make_pp_mesh", "infer_sharded"],
)
def test_entry_points_without_device_raise_when_cuda_absent(no_cuda, entry, tmp_path):
    from esm_tpu_torch import pretrained
    from esm_tpu_torch.cli import extract, fold, if_sample, if_score, predict_variants, pretrain

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "resolve_device":
            pretrained.resolve_device()
        elif entry == "random_model_and_alphabet":
            pretrained.random_model_and_alphabet("esm2_t6_8M_UR50D")
        elif entry == "load_model_and_alphabet_local":
            pretrained.load_model_and_alphabet_local(tmp_path / "esm2_missing.pt")
        elif entry == "random_esm1":
            pretrained.random_model_and_alphabet("esm1b_t33_650M_UR50S")
        elif entry == "random_msa":
            pretrained.random_model_and_alphabet("esm_msa1b_t12_100M_UR50S")
        elif entry == "random_if1":
            pretrained.random_model_and_alphabet("esm_if1_gvp4_t16_142M_UR50")
        elif entry == "if_sample":
            if_sample.run(if_sample.create_parser().parse_args(
                [str(tmp_path / "s.pdb"), "--model", str(tmp_path / "esm_if1_missing.pt")]))
        elif entry == "if_score":
            if_score.run(if_score.create_parser().parse_args(
                [str(tmp_path / "s.pdb"), str(tmp_path / "v.fasta"),
                 "--model", str(tmp_path / "esm_if1_missing.pt")]))
        elif entry == "predict_variants":
            (tmp_path / "dms.csv").write_text("mutant\nA1C\n")
            predict_variants.run(predict_variants.create_parser().parse_args(
                ["--model-location", str(tmp_path / "esm1v_missing.pt"), "--sequence", "A",
                 "--dms-input", str(tmp_path / "dms.csv"), "--dms-output",
                 str(tmp_path / "out.csv")]))
        elif entry == "random_esmfold":
            pretrained.random_esmfold("esmfold_v1")
        elif entry == "load_esmfold":
            pretrained.load_esmfold(str(tmp_path / "esmfold_missing.pt"))
        elif entry == "fold":
            fold.run(fold.create_parser().parse_args(
                ["-i", str(tmp_path / "x.fasta"), "-o", str(tmp_path / "pdb")]))
        elif entry == "esmfold_finetune":
            from esm_tpu_torch.examples import esmfold_finetune as ex
            ex.main(ex.create_parser().parse_args(["--pdbs", str(tmp_path), "--steps", "1"]))
        elif entry == "ss_finetune":
            from esm_tpu_torch.examples import finetune_secondary_structure as ex
            ex.run(ex.create_parser().parse_args(["--synthetic", "4", "--steps", "1"]))
        elif entry == "int8_15b":
            from esm_tpu_torch.examples import esm2_15b_int8_single_chip as ex
            ex.main(["--random-seed", "0"])
        elif entry == "contact_prediction":
            from esm_tpu_torch.examples import contact_prediction as ex
            ex.main(ex.create_parser().parse_args(["--model", str(tmp_path / "esm2_missing.pt"),
                                                   "--fasta", str(tmp_path / "x.fasta")]))
        elif entry == "serve":
            from esm_tpu_torch.cli import serve
            serve.start_server(serve.create_parser().parse_args(
                [str(tmp_path / "esm2_missing.pt"), "--port", "0"]))
        elif entry == "serve_memory":
            from esm_tpu_torch.parallel import memory_plan
            memory_plan.device_memory_bytes()
        elif entry == "lm_design":
            from esm_tpu_torch.examples import lm_design_fixedbb as ex
            ex.run(ex.create_parser().parse_args(["--model", str(tmp_path / "esm2_missing.pt")]))
        elif entry == "ppl_free_hallucination":
            from esm_tpu_torch.examples import ppl_free_hallucination as ex
            ex.run(ex.create_parser().parse_args(["--steps", "1"]))
        elif entry == "ppl_fixed_backbone":
            from esm_tpu_torch.examples import ppl_fixed_backbone as ex
            (tmp_path / "t.pdb").write_text(
                "ATOM      1  CA  ALA A   1       0.000   0.000   0.000  1.00  0.00           C\n")
            ex.run(ex.create_parser().parse_args([str(tmp_path / "t.pdb"), "--steps", "1"]))
        elif entry in ("make_mesh", "init_multihost"):
            from esm_tpu_torch.parallel import mesh
            getattr(mesh, entry)()
        elif entry == "make_pp_mesh":
            from esm_tpu_torch.parallel import pipeline
            pipeline.make_pp_mesh(1)
        elif entry == "infer_sharded":
            from esm_tpu_torch.examples import esm2_infer_sharded as ex
            ex.main(["--random-seed", "0", "--model", "esm2_t6_8M_UR50D"])
        elif entry == "hub":
            from esm_tpu_torch.io.export import save_esm2
            from esm_tpu_torch.models import esm2
            cfg = esm2.ESM2Config(num_layers=1, embed_dim=32, attention_heads=2)
            save_esm2(esm2.init(cfg, torch.Generator(), device="cpu"),
                      tmp_path / "esm2_t6_8M_UR50D.pt")
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("ESM_TPU_CACHE", str(tmp_path))
                torch.hub.load(str(PKG), "esm2_t6_8M_UR50D", source="local")
        elif entry == "sm_only":
            pretrained.esmfold_structure_module_only_8M()
        elif entry in ("pretrain", "pretrain_lora"):
            lora = ["--lora", "4", "--lora-int8-base"] if entry == "pretrain_lora" else []
            pretrain.run(pretrain.create_parser().parse_args(
                ["--fasta", str(tmp_path / "x.fasta"), "--steps", "1"] + lora))
        else:
            args = extract.create_parser().parse_args(
                [str(tmp_path / "esm2_missing.pt"), str(tmp_path / "x.fasta"),
                 str(tmp_path / "out"), "--include", "mean"]
                + (["--int8"] if entry == "extract_int8" else [])
            )
            extract.run(args)


def test_explicit_cpu_runs(tmp_path):
    from esm_tpu_torch import pretrained

    handle, alphabet = pretrained.random_model_and_alphabet(
        "esm2_t6_8M_UR50D", seed=0, device="cpu"
    )
    toks = alphabet.get_batch_converter()([("a", "MKTAYIAK")])[2]
    out = handle(toks, repr_layers=[-1])
    assert out["logits"].shape == (1, 10, len(alphabet))
    assert out["representations"][6].shape == (1, 10, 320)
    assert torch.isfinite(out["logits"]).all()


def test_hub_name_without_cache_raises(tmp_path, monkeypatch):
    from esm_tpu_torch import pretrained

    monkeypatch.setenv("ESM_TPU_CACHE", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="not ported"):
        pretrained.esm2_t6_8M_UR50D(device="cpu")
