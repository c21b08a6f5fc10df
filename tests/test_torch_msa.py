"""The port's MSA Transformer (esm_tpu_torch) against esm_tpu on the CPU:
tied-row and column attention, chunked and unchunked; whole forwards on the
same weights (JAX init carried across by msa_state_dict_from_jax) with
representations, row and column attentions and contacts; the 1024-row limit
of the MSA position embedding; MSABatchConverter, read_msa and
greedy_select; checkpoint round trips between the two packages.

fp32 throughout. Tolerance: 1e-4 absolute and relative, as
tests/test_torch_esm2.py holds ESM-2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esm_tpu import pretrained as jpretrained
from esm_tpu.data import Alphabet as JaxAlphabet
from esm_tpu.data import greedy_select as jgreedy_select
from esm_tpu.data import read_msa as jread_msa
from esm_tpu.io import export as jexport
from esm_tpu.models import msa_transformer as jmsa
from esm_tpu.ops import axial_attention as jax_axial
from esm_tpu_torch import pretrained
from esm_tpu_torch.data import Alphabet, MSABatchConverter, greedy_select, read_msa
from esm_tpu_torch.io import export
from esm_tpu_torch.io.from_jax import msa_state_dict_from_jax
from esm_tpu_torch.models import msa_transformer as tmsa
from esm_tpu_torch.ops import axial_attention as taxial

TOL = dict(atol=1e-4, rtol=1e-4)
SIZE = dict(num_layers=3, embed_dim=64, attention_heads=4, ffn_embed_dim=128, max_positions=64)
AAS = "ACDEFGHIKLMNPQRSTVWY-"


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _random_msa(rng, rows, length, prefix="s"):
    return [(f"{prefix}{i}", "".join(rng.choice(list(AAS), length))) for i in range(rows)]


# -- axial attention ---------------------------------------------------------


def _axial_pair(d, rng):
    attn = taxial.AxialAttention(d)
    params = {}
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        w, b = (rng.randn(d, d) / 5).astype(np.float32), rng.randn(d).astype(np.float32)
        with torch.no_grad():
            getattr(attn, name).weight.copy_(torch.from_numpy(w))
            getattr(attn, name).bias.copy_(torch.from_numpy(b))
        params[name] = {"kernel": jnp.asarray(w.T), "bias": jnp.asarray(b)}
    return attn, params


def _axial_inputs(rng, b=2, r=5, c=7, d=32):
    x = rng.randn(b, r, c, d).astype(np.float32)
    mask = np.zeros((b, r, c), bool)
    mask[1, 3:] = True        # padded rows
    mask[1, :, 5:] = True     # padded columns: keys all masked there
    return x, mask


@pytest.mark.parametrize("chunk", [None, 2, 3])
@pytest.mark.parametrize("masked", [False, True])
def test_row_attention(chunk, masked):
    rng = np.random.RandomState(0)
    attn, params = _axial_pair(32, rng)
    x, mask = _axial_inputs(rng)
    mask = mask if masked else None
    out, probs = taxial.row_self_attention(
        attn, torch.from_numpy(x), num_heads=4,
        padding_mask=None if mask is None else torch.from_numpy(mask), max_rows_per_chunk=chunk)
    ref_out, ref_probs = jax_axial.row_self_attention(
        params, jnp.asarray(x), num_heads=4,
        padding_mask=None if mask is None else jnp.asarray(mask), max_rows_per_chunk=chunk)
    np.testing.assert_allclose(out.detach().numpy(), _np(ref_out), **TOL)
    np.testing.assert_allclose(probs.detach().numpy(), _np(ref_probs), **TOL)
    if chunk is not None:  # chunked against unchunked, within the port
        whole, whole_probs = taxial.row_self_attention(
            attn, torch.from_numpy(x), num_heads=4,
            padding_mask=None if mask is None else torch.from_numpy(mask))
        torch.testing.assert_close(out, whole, **TOL)
        torch.testing.assert_close(probs, whole_probs, **TOL)


@pytest.mark.parametrize("chunk", [None, 2, 4])
@pytest.mark.parametrize("rows", [1, 5])
def test_column_attention(chunk, rows):
    rng = np.random.RandomState(1)
    attn, params = _axial_pair(32, rng)
    x, mask = _axial_inputs(rng, r=rows)
    out, probs = taxial.column_self_attention(
        attn, torch.from_numpy(x), num_heads=4, padding_mask=torch.from_numpy(mask),
        max_cols_per_chunk=chunk)
    ref_out, ref_probs = jax_axial.column_self_attention(
        params, jnp.asarray(x), num_heads=4, padding_mask=jnp.asarray(mask),
        max_cols_per_chunk=chunk)
    np.testing.assert_allclose(out.detach().numpy(), _np(ref_out), **TOL)
    np.testing.assert_allclose(probs.detach().numpy(), _np(ref_probs), **TOL)
    assert torch.isfinite(probs).all()  # -10000, not -inf: padded columns stay finite
    if chunk is not None:
        whole, whole_probs = taxial.column_self_attention(
            attn, torch.from_numpy(x), num_heads=4, padding_mask=torch.from_numpy(mask))
        torch.testing.assert_close(out, whole, **TOL)
        torch.testing.assert_close(probs, whole_probs, **TOL)


# -- whole forwards --------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jcfg = jmsa.MSATransformerConfig.from_alphabet(
        JaxAlphabet.from_architecture("msa_transformer"), **SIZE)
    params = jmsa.init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.RandomState(2)
    params["contact_head"]["regression"]["kernel"] = jnp.asarray(
        rng.randn(SIZE["num_layers"] * SIZE["attention_heads"], 1).astype(np.float32))
    params["contact_head"]["regression"]["bias"] = jnp.asarray([0.2], jnp.float32)
    params["lm_head"]["bias"] = jnp.asarray(rng.randn(jcfg.alphabet_size).astype(np.float32))
    params["msa_position_embedding"] = params["msa_position_embedding"] * 50  # make it count
    alphabet = Alphabet.from_architecture("msa_transformer")
    cfg = tmsa.MSATransformerConfig.from_alphabet(alphabet, **SIZE)
    model = tmsa.MSATransformer(cfg, device="cpu")
    model.load_state_dict(msa_state_dict_from_jax(jax.tree.map(np.asarray, params), jcfg),
                          strict=True)
    # two MSAs of different depth and length: padded rows and columns
    msas = [_random_msa(rng, 4, 12, "a"), _random_msa(rng, 3, 9, "b")]
    tokens = alphabet.get_batch_converter()(msas)[2]
    return jcfg, params, cfg, model, alphabet, tokens


def _both(models, max_tokens=2 ** 14, **kw):
    jcfg, params, cfg, model, _, tokens = models
    ref = jmsa.apply(params, dataclasses.replace(jcfg, max_tokens_per_msa=max_tokens),
                     jnp.asarray(tokens.numpy()), **kw)
    with torch.no_grad():
        out = tmsa.apply(model, dataclasses.replace(cfg, max_tokens_per_msa=max_tokens),
                         tokens, **kw)
    return out, ref


@pytest.mark.parametrize("max_tokens", [2 ** 14, 20])  # 20 < R*C: both axial paths chunk
def test_msa_forward_with_attentions_and_contacts(models, max_tokens):
    out, ref = _both(models, max_tokens, return_representations=True, return_contacts=True)
    for key in ("logits", "representations", "row_attentions", "col_attentions", "contacts"):
        assert out[key].shape == ref[key].shape, key
        np.testing.assert_allclose(out[key].numpy(), _np(ref[key]), **TOL, err_msg=key)
    whole, _ = _both(models, 2 ** 14, return_representations=True, return_contacts=True)
    for key in ("logits", "row_attentions", "col_attentions", "contacts"):
        torch.testing.assert_close(out[key], whole[key], **TOL)


@pytest.mark.parametrize("repr_layers", [(0, 2, -1), (1,)])
def test_msa_selected_repr_layers(models, repr_layers):
    out, ref = _both(models, repr_layers=repr_layers)
    assert sorted(out["representations"]) == sorted(ref["representations"])
    for layer, t in out["representations"].items():
        np.testing.assert_allclose(t.numpy(), _np(ref["representations"][layer]), **TOL)
    np.testing.assert_allclose(out["logits"].numpy(), _np(ref["logits"]), **TOL)


def test_msa_handle_matches_jax_handle(models):
    jcfg, params, cfg, model, alphabet, tokens = models
    jh = jpretrained.LMHandle("msa", jcfg, params, JaxAlphabet.from_architecture("msa_transformer"))
    th = pretrained.LMHandle("msa", cfg, model, alphabet)
    toks = tokens.numpy()
    out, ref = th(toks, repr_layers=[3], return_contacts=True), jh(toks, repr_layers=[3],
                                                                    return_contacts=True)
    np.testing.assert_allclose(out["representations"][3].numpy(),
                               _np(ref["representations"][3]), **TOL)
    np.testing.assert_allclose(out["contacts"].numpy(), _np(ref["contacts"]), **TOL)
    with pytest.raises(ValueError, match="expected 3D"):
        th(toks[:, 0])


def test_more_than_1024_rows_raise(models):
    jcfg, params, cfg, model, alphabet, _ = models
    toks = torch.full((1, 1025, 3), 5, dtype=torch.int64)
    toks[:, :, 0] = alphabet.cls_idx
    with pytest.raises(ValueError, match="maximum MSA depth of 1024"):
        tmsa.apply(model, cfg, toks)
    with pytest.raises(ValueError, match="maximum MSA depth of 1024"):
        jmsa.apply(params, jcfg, jnp.asarray(toks.numpy()))


# -- MSA data ----------------------------------------------------------------------


def test_msa_batch_converter_matches_jax():
    rng = np.random.RandomState(3)
    alphabet = Alphabet.from_architecture("msa_transformer")
    jalphabet = JaxAlphabet.from_architecture("msa_transformer")
    conv, jconv = alphabet.get_batch_converter(), jalphabet.get_batch_converter()
    assert isinstance(conv, MSABatchConverter)
    ragged = [_random_msa(rng, 4, 10, "a"), _random_msa(rng, 2, 13, "b")]
    for inputs in (ragged, ragged[0]):  # a batch, and one MSA on its own
        labels, strs, toks = conv(inputs)
        jlabels, jstrs, jtoks = jconv(inputs)
        assert labels == jlabels and strs == jstrs and toks.dtype == torch.int64
        np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    padded = alphabet.get_batch_converter(pad_to_multiple=8)(ragged)[2]
    np.testing.assert_array_equal(
        padded.numpy(), np.asarray(jalphabet.get_batch_converter(pad_to_multiple=8)(ragged)[2]))
    unaligned = [("a", "MKTA"), ("b", "MKT")]
    for c in (conv, jconv):
        with pytest.raises(RuntimeError, match="unaligned"):
            c(unaligned)


def test_read_msa_and_greedy_select_match_jax(tmp_path):
    rng = np.random.RandomState(4)
    rows = _random_msa(rng, 30, 16)
    path = tmp_path / "x.a3m"
    with open(path, "w") as f:
        for i, (label, seq) in enumerate(rows):
            # insertions: lower case, '.' and '*'
            noisy = seq[:5] + "kq" + seq[5:9] + ".." + seq[9:] + ("*" if i % 3 == 0 else "")
            f.write(f">{label}\n{noisy}\n")
    msa = read_msa(path)
    assert msa == jread_msa(str(path)) == rows
    for mode in ("max", "min"):
        assert greedy_select(msa, 8, mode=mode) == jgreedy_select(msa, 8, mode=mode)


# -- checkpoints ---------------------------------------------------------------------


def test_port_checkpoint_loads_in_both_packages(models, tmp_path):
    jcfg, params, cfg, model, alphabet, tokens = models
    path, reg = export.save_msa(model, tmp_path / "esm_msa1b_small.pt")
    data = torch.load(path, weights_only=False)
    assert data["args"].arch == "msa_transformer"
    # the released files' swap: the row attention is stored under "column"
    assert torch.equal(
        data["model"]["encoder.sentence_encoder.layers.0.column_self_attention.layer.q_proj.weight"],
        model.layers[0].row_self_attention.layer.q_proj.weight)
    handle, _ = pretrained.load_model_and_alphabet_local(path, device="cpu")
    jhandle, _ = jpretrained.load_model_and_alphabet_local(str(path))
    assert handle.kind == jhandle.kind == "msa" and handle.cfg.embed_positions_msa
    sd, loaded = model.state_dict(), handle.model.state_dict()
    assert sd.keys() == loaded.keys() and all(torch.equal(sd[k], loaded[k]) for k in sd)
    out, ref = handle(tokens, return_contacts=True), jhandle(tokens.numpy(), return_contacts=True)
    for key in ("logits", "contacts"):
        np.testing.assert_allclose(out[key].numpy(), _np(ref[key]), **TOL)


def test_jax_checkpoint_loads_in_the_port(models, tmp_path):
    jcfg, params, cfg, model, alphabet, tokens = models
    path = tmp_path / "esm_msa1b_small.pt"
    jexport.save_msa(params, jcfg, str(path))
    handle, _ = pretrained.load_model_and_alphabet_local(path, device="cpu")
    out = handle(tokens, return_contacts=True)
    ref = jmsa.apply(params, jcfg, jnp.asarray(tokens.numpy()), return_contacts=True)
    for key in ("logits", "contacts", "row_attentions"):
        np.testing.assert_allclose(out[key].numpy(), _np(ref[key]), **TOL)


@pytest.mark.parametrize("name,with_msa_positions", [("esm_msa1_t12_100M_UR50S", False),
                                                     ("esm_msa1b_t12_100M_UR50S", True)])
def test_released_sizes(name, with_msa_positions):
    cfg = tmsa.MSATransformerConfig(**tmsa.MSA_SIZES[name])
    assert (cfg.num_layers, cfg.embed_dim, cfg.attention_heads, cfg.ffn_embed_dim,
            cfg.max_positions, cfg.embed_positions_msa) == (12, 768, 12, 3072, 1024,
                                                            with_msa_positions)
    assert name in jpretrained._LM_NAMES and callable(getattr(pretrained, name))


def test_random_msa_transformer_runs_on_cpu():
    handle, alphabet = pretrained.random_model_and_alphabet("esm_msa1b_t12_100M_UR50S", seed=2,
                                                            device="cpu")
    assert handle.kind == "msa" and handle.model.msa_position_embedding.shape == (1, 1024, 1, 768)
    toks = alphabet.get_batch_converter()([("a", "MKTAYIAK"), ("b", "MKT-YIAK")])[2]
    out = handle(toks, repr_layers=[12], return_contacts=True)
    assert out["logits"].shape == (1, 2, 9, len(alphabet)) and out["contacts"].shape == (1, 8, 8)
    assert torch.isfinite(out["logits"]).all()
