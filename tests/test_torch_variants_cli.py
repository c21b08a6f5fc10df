"""The port's esm-predict-variants (esm_tpu_torch.cli.predict_variants)
against esm_tpu.cli.predict_variants.run on the same files, on the CPU: each
scoring strategy on an ESM-1v-shaped and an ESM-1 checkpoint, the MSA
Transformer's masked-marginals on an a3m with insertions, the ensemble's
--eval-column report; the CSV's columns, in order, and its scores at 1e-4
absolute and relative (fp32 on both sides). Also: spearman equals JAX's,
--int8 equals JAX's --int8, and the CLI module runs without importing pandas.
"""

import contextlib
import csv
import io
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from esm_tpu.cli import predict_variants as jcli
from esm_tpu.data import Alphabet as JaxAlphabet
from esm_tpu.io import export as jexport
from esm_tpu.metrics import spearman as jspearman
from esm_tpu.models import esm1 as jesm1
from esm_tpu.models import msa_transformer as jmsa
from esm_tpu_torch.cli import predict_variants as tcli
from esm_tpu_torch.metrics import spearman

TOL = dict(atol=1e-4, rtol=1e-4)
AAS = "ACDEFGHIKLMNPQRSTVWY"
SIZE = dict(num_layers=2, embed_dim=64, attention_heads=4, ffn_embed_dim=128)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dms")
    rng = np.random.RandomState(0)
    seq = "".join(rng.choice(list(AAS), 30))
    # ten single mutants, 1-based, two at one site
    sites = [3, 7, 7, 11, 15, 18, 22, 25, 28, 30]
    rows = []
    for i, site in enumerate(sites):
        wt = seq[site - 1]
        mt = rng.choice([a for a in AAS if a != wt])
        rows.append((f"{wt}{site}{mt}", f"{rng.randn():.6f}", f"note {i}"))
    dms = tmp / "dms.csv"
    with open(dms, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["mutant", "score", "comment"])
        w.writerows(rows)

    models = {}
    for name, arch, extra in (("esm1v_small", "ESM-1b", dict(token_dropout=True)),
                              ("esm1_small", "ESM-1", {})):
        cfg = jesm1.ESM1Config.from_alphabet(JaxAlphabet.from_architecture(arch),
                                             model_version=arch, max_positions=64, **SIZE, **extra)
        params = jesm1.init(jax.random.PRNGKey(len(name)), cfg)
        emb = np.asarray(params["embed_tokens"]["weight"]).copy()
        if cfg.is_1b:
            emb[cfg.mask_idx] = 0
        else:
            params["embed_out"]["kernel"] = jnp.asarray(
                rng.randn(cfg.embed_dim, cfg.alphabet_size).astype(np.float32) / 8)
        params["embed_tokens"]["weight"] = jnp.asarray(emb)
        path = str(tmp / f"{name}.pt")
        (jexport.save_esm1b if cfg.is_1b else jexport.save_esm1)(params, cfg, path)
        models[name] = path

    mcfg = jmsa.MSATransformerConfig.from_alphabet(
        JaxAlphabet.from_architecture("msa_transformer"), max_positions=64, **SIZE)
    models["msa"] = str(tmp / "esm_msa1b_small.pt")
    jexport.save_msa(jmsa.init(jax.random.PRNGKey(7), mcfg), mcfg, models["msa"])
    a3m = tmp / "x.a3m"
    with open(a3m, "w") as f:
        f.write(f">query\n{seq}\n")
        for i in range(5):
            row = list(rng.choice(list(AAS + "-"), 30))
            f.write(f">r{i}\n{''.join(row[:10])}ak{''.join(row[10:20])}..{''.join(row[20:])}\n")
    return dict(seq=seq, dms=dms, a3m=a3m, tmp=tmp, **models)


def _argv(files, models, strategy, out, *extra):
    return (["--model-location", *models, "--sequence", files["seq"], "--dms-input",
             str(files["dms"]), "--dms-output", str(out), "--offset-idx", "1",
             "--scoring-strategy", strategy, "--nogpu", "--mask-batch", "8"] + list(extra))


def _read(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def _run_both(files, models, strategy, name, *extra):
    outs = {}
    for tag, cli in (("jax", jcli), ("port", tcli)):
        out = files["tmp"] / f"{name}_{tag}.csv"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.run(cli.create_parser().parse_args(_argv(files, models, strategy, out, *extra)))
        outs[tag] = (_read(out), buf.getvalue())
    return outs


def _compare(outs, models):
    (jheader, jrows), _ = outs["jax"]
    (header, rows), _ = outs["port"]
    assert header == jheader == ["", "mutant", "score", "comment", *models]
    assert len(rows) == len(jrows)
    for row, jrow in zip(rows, jrows):
        assert row[:2] == jrow[:2] and row[3] == jrow[3]  # index, mutant, comment
        assert float(row[2]) == float(jrow[2])
        np.testing.assert_allclose([float(v) for v in row[4:]], [float(v) for v in jrow[4:]],
                                   **TOL)


@pytest.mark.parametrize("strategy", ["wt-marginals", "masked-marginals", "pseudo-ppl"])
@pytest.mark.parametrize("model", ["esm1v_small", "esm1_small"])
def test_strategies_match_jax(files, strategy, model):
    outs = _run_both(files, [files[model]], strategy, f"{model}_{strategy}")
    _compare(outs, [files[model]])


def test_msa_masked_marginals_match_jax(files):
    outs = _run_both(files, [files["msa"]], "masked-marginals", "msa", "--msa-path",
                     str(files["a3m"]), "--msa-samples", "4", "--msa-mask-batch", "3")
    _compare(outs, [files["msa"]])


def test_ensemble_eval_column_matches_jax(files):
    models = [files["esm1v_small"], files["esm1_small"]]
    outs = _run_both(files, models, "wt-marginals", "ensemble", "--eval-column", "score")
    _compare(outs, models)
    pattern = r"\|rho\|(?: vs score)? = ([0-9.]+)"
    got = [float(x) for x in re.findall(pattern, outs["port"][1])]
    want = [float(x) for x in re.findall(pattern, outs["jax"][1])]
    assert len(got) == len(want) == 3  # two models and the ensemble
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_spearman_equals_jax():
    rng = np.random.RandomState(1)
    for n in (7, 50):
        x = rng.randint(0, 5, n).astype(float)  # ties
        y = rng.randn(n)
        y[0] = np.nan
        assert spearman(x, y) == jspearman(x, y)
    with pytest.raises(ValueError):
        spearman([1.0], [2.0])


def test_int8_matches_jax(files, monkeypatch):
    """--int8 (ported since it raised): the port's scores equal esm_tpu's
    --int8 scores at 1e-4 and stay near the fp32 run's. Both packages
    quantize with min_size=1 (the default selects no linear at this size)."""
    import functools

    import esm_tpu.quantization as jq
    import esm_tpu_torch.quantization as tq

    monkeypatch.setattr(jq, "quantize_params", functools.partial(jq.quantize_params, min_size=1))
    monkeypatch.setattr(tq, "quantize_params", functools.partial(tq.quantize_params, min_size=1))
    models = [files["esm1v_small"]]
    outs = _run_both(files, models, "wt-marginals", "int8", "--int8")
    _compare(outs, models)
    (_, f32_rows), _ = _run_both(files, models, "wt-marginals", "int8_f32")["port"]
    (_, rows), _ = outs["port"]
    int8 = np.array([float(r[4]) for r in rows])
    f32 = np.array([float(r[4]) for r in f32_rows])
    err = np.abs(int8 - f32).max()
    assert 0 < err < 0.15 * (np.abs(f32).max() + 1), err


def test_cli_runs_without_pandas(files):
    argv = _argv(files, [files["esm1v_small"]], "wt-marginals", files["tmp"] / "nopd.csv")
    code = (
        "import sys\n"
        "from esm_tpu_torch.cli import predict_variants as m\n"
        f"m.run(m.create_parser().parse_args({argv!r}))\n"
        "assert 'pandas' not in sys.modules, 'pandas imported'\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=Path(__file__).resolve().parent.parent)
    assert proc.returncode == 0, proc.stderr
    header, rows = _read(files["tmp"] / "nopd.csv")
    assert header[-1] == files["esm1v_small"] and len(rows) == 10


def test_wildtype_mismatch_raises(files, tmp_path):
    bad = tmp_path / "bad.csv"
    bad.write_text(f"mutant\n{'W' if files['seq'][0] != 'W' else 'A'}1C\n")
    argv = _argv(files, [files["esm1v_small"]], "wt-marginals", tmp_path / "o.csv")
    argv[argv.index("--dms-input") + 1] = str(bad)
    with pytest.raises(ValueError, match="wildtype does not match"):
        tcli.run(tcli.create_parser().parse_args(argv))
