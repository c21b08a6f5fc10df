"""The port's esm-extract (esm_tpu_torch.cli.extract) against esm_tpu's, both
with --nogpu, on one tiny checkpoint written by esm_tpu.io.export.save_esm2
(the reference's released ESM-2 file layout, with its co-located contact
regression). Every per-sequence output is compared; fp32, tolerance 1e-4
absolute and relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esm_tpu.cli import extract as jax_extract
from esm_tpu.io.export import save_esm2
from esm_tpu.models import esm2 as jesm2
from esm_tpu.data import Alphabet as JaxAlphabet
from esm_tpu_torch.cli import extract as torch_extract

TOL = dict(atol=1e-4, rtol=1e-4)
LABELS = ["s0", "s1", "s2", "s3", "s4"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("extract")
    cfg = jesm2.ESM2Config.from_alphabet(
        JaxAlphabet.from_architecture("ESM-1b"), num_layers=2, embed_dim=32, attention_heads=4
    )
    params = jesm2.init(jax.random.PRNGKey(2), cfg)
    rng = np.random.RandomState(0)
    params["contact_head"]["regression"]["kernel"] = jnp.asarray(
        rng.randn(8, 1).astype(np.float32)
    )
    path = root / "esm2_t2_tiny.pt"
    save_esm2(params, cfg, path)
    toks = "ACDEFGHIKLMNPQRSTVWY"
    fasta = root / "seqs.fasta"
    with open(fasta, "w") as f:
        for i, label in enumerate(LABELS):
            n = int(rng.randint(5, 40))
            f.write(f">{label}\n" + "".join(rng.choice(list(toks), n)) + "\n")
    return root, path, fasta


def _args(path, fasta, out, extra):
    parser = torch_extract.create_parser()
    return parser.parse_args(
        [str(path), str(fasta), str(out), "--nogpu", "--toks_per_batch", "80",
         "--repr_layers", "0", "-1", "--include", "mean", "per_tok", "bos", "contacts"]
        + extra
    )


def _load(path, npz):
    if npz:
        return dict(np.load(path))
    flat = {}
    for k, v in torch.load(path, weights_only=False).items():
        if isinstance(v, dict):
            flat.update({f"{k}_{kk}": vv.numpy() for kk, vv in v.items()})
        elif isinstance(v, torch.Tensor):
            flat[k] = v.numpy()
        else:
            flat[k] = v
    return flat


@pytest.mark.parametrize(
    "extra", [[], ["--npz", "--serial"], ["--bucket", "--writers", "1"]]
)
def test_extract_matches_jax(ckpt, tmp_path, extra):
    root, path, fasta = ckpt
    jax_extract.run(_args(path, fasta, tmp_path / "jax", extra))
    torch_extract.run(_args(path, fasta, tmp_path / "torch", extra))
    npz = "--npz" in extra
    suffix = "npz" if npz else "pt"
    for label in LABELS:
        ref = _load(tmp_path / "jax" / f"{label}.{suffix}", npz)
        out = _load(tmp_path / "torch" / f"{label}.{suffix}", npz)
        assert sorted(out) == sorted(ref)
        for key in ref:
            if key == "label":
                assert str(out[key]) == str(ref[key]) == label
            else:
                assert out[key].shape == ref[key].shape, key
                np.testing.assert_allclose(out[key], ref[key], err_msg=key, **TOL)


def test_extract_mean_only_uses_device_means(ckpt, tmp_path):
    """With 'mean' and no 'per_tok' the mean is taken before the copy back."""
    root, path, fasta = ckpt
    parser = torch_extract.create_parser()
    argv = [str(path), str(fasta), None, "--nogpu", "--include", "mean"]
    argv[2] = str(tmp_path / "jax")
    jax_extract.run(parser.parse_args(argv))
    argv[2] = str(tmp_path / "torch")
    torch_extract.run(parser.parse_args(argv))
    for label in LABELS:
        ref = _load(tmp_path / "jax" / f"{label}.pt", False)
        out = _load(tmp_path / "torch" / f"{label}.pt", False)
        np.testing.assert_allclose(
            out["mean_representations_2"], ref["mean_representations_2"], **TOL
        )


def test_extract_int8(ckpt, tmp_path, monkeypatch):
    """--int8 (ported since it raised) against esm_tpu's --int8 at 1e-4, and
    against the fp32 run within esm_tpu's int8 bound, 0.15 (max|ref| + 1).
    Both packages quantize with min_size=1: at this size the default
    threshold would select no linear."""
    import functools

    import esm_tpu.quantization as jq
    import esm_tpu_torch.quantization as tq

    monkeypatch.setattr(jq, "quantize_params", functools.partial(jq.quantize_params, min_size=1))
    monkeypatch.setattr(tq, "quantize_params", functools.partial(tq.quantize_params, min_size=1))
    root, path, fasta = ckpt
    jax_extract.run(_args(path, fasta, tmp_path / "jax", ["--int8"]))
    torch_extract.run(_args(path, fasta, tmp_path / "int8", ["--int8"]))
    torch_extract.run(_args(path, fasta, tmp_path / "fp32", []))
    moved = 0.0
    for label in LABELS:
        ref = _load(tmp_path / "jax" / f"{label}.pt", False)
        out = _load(tmp_path / "int8" / f"{label}.pt", False)
        f32 = _load(tmp_path / "fp32" / f"{label}.pt", False)
        for key in ref:
            if key != "label":
                np.testing.assert_allclose(out[key], ref[key], err_msg=key, **TOL)
        for key in ("representations_2", "mean_representations_2"):
            err = np.abs(out[key] - f32[key]).max()
            assert err < 0.15 * (np.abs(f32[key]).max() + 1), (key, err)
            moved = max(moved, err)
    assert moved > 0  # the int8 weights were used


def test_extract_profile_trace(ckpt, tmp_path):
    root, path, fasta = ckpt
    trace = tmp_path / "trace"
    torch_extract.run(_args(path, fasta, tmp_path / "o", ["--profile-trace", str(trace)]))
    assert (trace / "esm_extract_trace.json").stat().st_size > 0


def test_local_loader_matches_jax_loader(ckpt):
    """load_model_and_alphabet_local reads the same file into equal weights
    (the regression from the co-located -contact-regression.pt)."""
    from esm_tpu import pretrained as jp
    from esm_tpu_torch import pretrained as tp

    root, path, fasta = ckpt
    jh, _ = jp.load_model_and_alphabet_local(str(path))
    th, alphabet = tp.load_model_and_alphabet_local(path, device="cpu")
    assert th.device == torch.device("cpu") and th.num_layers == 2
    np.testing.assert_array_equal(
        th.model.contact_head.regression.weight.detach().numpy()[0],
        np.asarray(jh.params["contact_head"]["regression"]["kernel"])[:, 0],
    )
    toks = alphabet.get_batch_converter()([("a", "MKTAYIAK"), ("b", "GAVL")])[2]
    np.testing.assert_allclose(
        th(toks, return_contacts=True)["contacts"].numpy(),
        np.asarray(jh(toks.numpy(), return_contacts=True)["contacts"]), **TOL,
    )


def test_parsers_take_the_same_flags():
    """Both parsers take the same flags."""
    a = vars(jax_extract.create_parser().parse_args(["m", "f", "o", "--include", "mean"]))
    b = vars(torch_extract.create_parser().parse_args(["m", "f", "o", "--include", "mean"]))
    assert a.keys() == b.keys()


def test_port_checkpoint_loads_in_jax(tmp_path):
    """esm_tpu_torch.io.export.save_esm2 writes the reference layout: the JAX
    package's loader reads it back into the same forward."""
    from esm_tpu import pretrained as jp
    from esm_tpu_torch import pretrained as tp
    from esm_tpu_torch.io.export import save_esm2

    th, alphabet = tp.random_model_and_alphabet("esm2_t6_8M_UR50D", seed=7, device="cpu")
    with torch.no_grad():
        th.model.contact_head.regression.weight.normal_(generator=torch.Generator().manual_seed(8))
    path = tmp_path / "esm2_t6_seeded.pt"
    save_esm2(th.model, path)
    jh, _ = jp.load_model_and_alphabet_local(str(path))
    toks = alphabet.get_batch_converter()([("a", "MKTAYIAKQRQ"), ("b", "GAVL")])[2]
    out = th(toks, repr_layers=[3], return_contacts=True)
    ref = jh(toks.numpy(), repr_layers=[3], return_contacts=True)
    np.testing.assert_allclose(out["logits"].numpy(), np.asarray(ref["logits"]), **TOL)
    np.testing.assert_allclose(out["contacts"].numpy(), np.asarray(ref["contacts"]), **TOL)
    np.testing.assert_allclose(
        out["representations"][3].numpy(), np.asarray(ref["representations"][3]), **TOL
    )


def test_missing_regression_gives_zero_contact_head(tmp_path):
    """Without the co-located -contact-regression.pt the loader warns and the
    contact head is zero, as esm_tpu's loader makes it."""
    import os

    from esm_tpu_torch import pretrained as tp
    from esm_tpu_torch.io.export import save_esm2

    th, _ = tp.random_model_and_alphabet("esm2_t6_8M_UR50D", seed=1, device="cpu")
    path, reg_path = save_esm2(th.model, tmp_path / "esm2_t6_noreg.pt")
    os.remove(reg_path)
    with pytest.warns(UserWarning, match="Regression weights not found"):
        loaded, _ = tp.load_model_and_alphabet_local(path, device="cpu")
    assert torch.count_nonzero(loaded.model.contact_head.regression.weight) == 0
    sd, ref = loaded.model.state_dict(), th.model.state_dict()
    for key in ref:
        if not key.startswith("contact_head."):
            assert torch.equal(sd[key], ref[key]), key
