"""The port's ESM-1, ESM-1b and ESM-1v (esm_tpu_torch) against esm_tpu's
esm1.apply on the CPU, on the same weights (JAX init carried across by
esm1_state_dict_from_jax) and the same tokens; the positional embeddings and
bias_kv attention on their own; checkpoint round trips between the two
packages' savers and loaders; the registry and its refusals.

fp32 throughout. Tolerance: 1e-4 absolute and relative on every output, as
tests/test_torch_esm2.py holds ESM-2 (summation order and transcendental
implementations over a few layers).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esm_tpu import pretrained as jpretrained
from esm_tpu.data import Alphabet as JaxAlphabet
from esm_tpu.io import export as jexport
from esm_tpu.models import esm1 as jesm1
from esm_tpu.ops import attention as jatt
from esm_tpu.ops import positional as jpos
from esm_tpu_torch import pretrained
from esm_tpu_torch.data import Alphabet
from esm_tpu_torch.io import export
from esm_tpu_torch.io.from_jax import esm1_state_dict_from_jax
from esm_tpu_torch.models import esm1 as tesm1
from esm_tpu_torch.ops import attention as tatt
from esm_tpu_torch.ops import common as tc
from esm_tpu_torch.ops import positional as tpos

TOL = dict(atol=1e-4, rtol=1e-4)
SIZE = dict(num_layers=3, embed_dim=64, attention_heads=4, ffn_embed_dim=128, max_positions=64)
# version -> (architecture, extra config)
VERSIONS = {
    "ESM-1b": ("ESM-1b", {}),
    "ESM-1v": ("ESM-1b", {"token_dropout": True}),
    "ESM-1": ("ESM-1", {}),
}
SEQS = [("a", "MKTAYIAKQRQISFVKSHFSRQ"), ("b", "MKT<mask>YIAK"), ("c", "GAV<mask>LIEK<mask>W")]


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _jax_params(jcfg, seed):
    params = jesm1.init(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.RandomState(seed + 1)
    n = jcfg.num_layers * jcfg.attention_heads
    # a nonzero contact regression, LM bias and (ESM-1) output projection
    params["contact_head"]["regression"]["kernel"] = jnp.asarray(
        rng.randn(n, 1).astype(np.float32))
    params["contact_head"]["regression"]["bias"] = jnp.asarray([0.3], jnp.float32)
    if jcfg.is_1b:
        params["lm_head"]["bias"] = jnp.asarray(rng.randn(jcfg.alphabet_size).astype(np.float32))
    else:
        params["embed_out"]["kernel"] = jnp.asarray(
            (rng.randn(jcfg.embed_dim, jcfg.alphabet_size) / 8).astype(np.float32))
        params["embed_out"]["bias"] = jnp.asarray(rng.randn(jcfg.alphabet_size).astype(np.float32))
    return params


@pytest.fixture(scope="module", params=list(VERSIONS))
def models(request):
    arch, extra = VERSIONS[request.param]
    jcfg = jesm1.ESM1Config.from_alphabet(JaxAlphabet.from_architecture(arch),
                                          model_version=arch, **SIZE, **extra)
    params = _jax_params(jcfg, seed=len(request.param))
    alphabet = Alphabet.from_architecture(arch)
    cfg = tesm1.ESM1Config.from_alphabet(alphabet, model_version=arch, **SIZE, **extra)
    model = tesm1.ESM1(cfg, device="cpu")
    model.load_state_dict(esm1_state_dict_from_jax(jax.tree.map(np.asarray, params), jcfg),
                          strict=True)
    tokens = alphabet.get_batch_converter()(SEQS)[2]
    return request.param, jcfg, params, cfg, model, alphabet, tokens


def _both(models, use_flash, **kw):
    _, jcfg, params, cfg, model, _, tokens = models
    ref = jesm1.apply(params, dataclasses.replace(jcfg, use_flash=use_flash),
                      jnp.asarray(tokens.numpy()), **kw)
    with torch.no_grad():
        out = tesm1.apply(model, dataclasses.replace(cfg, use_flash=use_flash), tokens, **kw)
    return out, ref


# -- positions ---------------------------------------------------------------


def _padded_tokens():
    rng = np.random.RandomState(3)
    toks = rng.randint(4, 24, size=(3, 11))
    toks[1, 7:] = 1
    toks[2, 2:] = 1
    return toks


def test_learned_positions_with_pads():
    toks = _padded_tokens()
    out = tpos.learned_positions(torch.from_numpy(toks), 1).numpy()
    np.testing.assert_array_equal(out, np.asarray(jpos.learned_positions(jnp.asarray(toks), 1)))
    assert (out[toks == 1] == 1).all() and out.max() == 1 + 11

    w = np.random.RandomState(4).randn(14, 8).astype(np.float32)
    w[1] = 0
    emb = tc.new_embedding(14, 8, padding_idx=1)
    with torch.no_grad():
        emb.weight.copy_(torch.from_numpy(w))
    got = tpos.learned_positional_embedding(emb, torch.from_numpy(toks), 1, 12).detach()
    want = jpos.learned_positional_embedding({"weight": jnp.asarray(w)}, jnp.asarray(toks), 1, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=0)
    with pytest.raises(ValueError, match="above maximum sequence length"):
        tpos.learned_positional_embedding(emb, torch.from_numpy(toks), 1, 10)
    with pytest.raises(ValueError, match="above maximum sequence length"):
        jpos.learned_positional_embedding({"weight": jnp.asarray(w)}, jnp.asarray(toks), 1, 10)


@pytest.mark.parametrize("dim", [16, 17])
def test_sinusoidal_positions_with_pads(dim):
    toks = _padded_tokens()
    table = tpos.sinusoidal_table(20, dim, 1).numpy()
    np.testing.assert_allclose(table, np.asarray(jpos.sinusoidal_table(20, dim, 1)), atol=1e-6)
    assert not table[1].any()
    got = tpos.sinusoidal_positional_embedding(torch.from_numpy(toks), dim, 1).numpy()
    want = jpos.sinusoidal_positional_embedding(jnp.asarray(toks), dim, 1)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)
    assert not got[toks == 1].any()  # pads take the zero row


# -- bias_kv attention ---------------------------------------------------------


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("need_weights", [False, True])
def test_bias_kv_attention(use_flash, need_weights):
    b, t, d, h = 2, 13, 32, 4
    rng = np.random.RandomState(5)
    attn = tatt.SelfAttention(d, h, use_rotary=False, use_bias_kv=True)
    params = {}
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        w, bias = (rng.randn(d, d) / 6).astype(np.float32), rng.randn(d).astype(np.float32)
        layer = getattr(attn, name)
        with torch.no_grad():
            layer.weight.copy_(torch.from_numpy(w))
            layer.bias.copy_(torch.from_numpy(bias))
        params[name] = {"kernel": jnp.asarray(w.T), "bias": jnp.asarray(bias)}
    for name in ("bias_k", "bias_v"):
        v = rng.randn(d).astype(np.float32)
        with torch.no_grad():
            getattr(attn, name).copy_(torch.from_numpy(v).reshape(1, 1, d))
        params[name] = jnp.asarray(v)
    x = rng.randn(b, t, d).astype(np.float32)
    mask = np.zeros((b, t), bool)
    mask[1, 9:] = True
    out, probs = tatt.multihead_attention(
        attn, torch.from_numpy(x), num_heads=h, key_padding_mask=torch.from_numpy(mask),
        use_bias_kv=True, need_weights=need_weights, use_flash=use_flash)
    ref = jatt.multihead_attention(
        params, jnp.asarray(x), num_heads=h, key_padding_mask=jnp.asarray(mask),
        use_bias_kv=True, need_weights=need_weights, use_flash=use_flash)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref.out), **TOL)
    if need_weights:
        assert probs.shape == (b, h, t, t + 1)
        np.testing.assert_allclose(probs.detach().numpy(), np.asarray(ref.probs), **TOL)
    else:
        assert probs is None


# -- whole models ----------------------------------------------------------------


@pytest.mark.parametrize("use_flash", [False, True])
def test_logits_and_all_representations(models, use_flash):
    out, ref = _both(models, use_flash, return_representations=True)
    np.testing.assert_allclose(out["logits"].numpy(), _np(ref["logits"]), **TOL)
    np.testing.assert_allclose(out["representations"].numpy(), _np(ref["representations"]),
                               **TOL)


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("repr_layers", [(0, 1, -1), (2,), (3, 0)])
def test_selected_repr_layers(models, use_flash, repr_layers):
    out, ref = _both(models, use_flash, repr_layers=repr_layers)
    assert sorted(out["representations"]) == sorted(ref["representations"])
    for layer, t in out["representations"].items():
        np.testing.assert_allclose(t.numpy(), _np(ref["representations"][layer]), **TOL)
    np.testing.assert_allclose(out["logits"].numpy(), _np(ref["logits"]), **TOL)


def test_attentions_and_stacked_contacts(models):
    version, *_, tokens = models
    out, ref = _both(models, False, need_head_weights=True, return_contacts=True)
    t = tokens.shape[1]
    assert out["attentions"].shape[-2:] == (t, t)  # ESM-1's bias_kv column stripped
    np.testing.assert_allclose(out["attentions"].numpy(), _np(ref["attentions"]), **TOL)
    np.testing.assert_allclose(out["contacts"].numpy(), _np(ref["contacts"]), **TOL)
    np.testing.assert_allclose(out["logits"].numpy(), _np(ref["logits"]), **TOL)


@pytest.mark.parametrize("use_flash", [False, True])
def test_streaming_contacts(models, use_flash):
    out, ref = _both(models, use_flash, return_contacts=True, return_representations=True)
    assert "attentions" not in out
    np.testing.assert_allclose(out["contacts"].numpy(), _np(ref["contacts"]), **TOL)
    stacked, _ = _both(models, False, need_head_weights=True, return_contacts=True)
    np.testing.assert_allclose(out["contacts"].numpy(), stacked["contacts"].numpy(), **TOL)


def test_handle_routes_match_jax_handle(models):
    version, jcfg, params, cfg, model, alphabet, tokens = models
    arch = VERSIONS[version][0]
    jh = jpretrained.LMHandle("esm1", jcfg, params, JaxAlphabet.from_architecture(arch))
    th = pretrained.LMHandle("esm1", cfg, model, alphabet)
    toks = tokens.numpy()
    for kw in (dict(repr_layers=[-1, 1]), dict(repr_layers=[0, 3], return_contacts=True)):
        ref, out = jh(toks, **kw), th(toks, **kw)
        for layer, t in out["representations"].items():
            np.testing.assert_allclose(t.numpy(), _np(ref["representations"][layer]), **TOL)
        np.testing.assert_allclose(out["logits"].numpy(), _np(ref["logits"]), **TOL)
    np.testing.assert_allclose(th.predict_contacts(toks).numpy(),
                               _np(jh.predict_contacts(toks)), **TOL)


# -- checkpoints -------------------------------------------------------------------


def _stem(version):
    return {"ESM-1b": "esm1b_small", "ESM-1v": "esm1v_small", "ESM-1": "esm1_small"}[version]


def test_port_checkpoint_loads_in_both_packages(models, tmp_path):
    version, jcfg, params, cfg, model, alphabet, tokens = models
    path = tmp_path / f"{_stem(version)}.pt"
    if cfg.is_1b:
        with torch.no_grad():  # the v1 loader zeroes this row; the saver warns otherwise
            model.embed_tokens.weight[cfg.mask_idx] = 0
        export.save_esm1b(model, path)
    else:
        export.save_esm1(model, path)
    data = torch.load(path, weights_only=False)
    stem = "encoder" if cfg.is_1b else "decoder"
    assert all(k.startswith(f"{stem}.") for k in data["model"])
    assert data["args"].arch == ("roberta_large" if cfg.is_1b else "protein_bert_base")
    handle, _ = pretrained.load_model_and_alphabet_local(path, device="cpu")
    jhandle, _ = jpretrained.load_model_and_alphabet_local(str(path))
    assert handle.kind == jhandle.kind == "esm1"
    assert handle.cfg.token_dropout == cfg.token_dropout
    sd, loaded = model.state_dict(), handle.model.state_dict()
    assert sd.keys() == loaded.keys()
    # an esm1v file's contact regression is not read (reference esm/pretrained.py:18-21)
    skip = "contact_head." if version == "ESM-1v" else "-"
    assert all(torch.equal(sd[k], loaded[k]) for k in sd if not k.startswith(skip))
    out = handle(tokens, return_contacts=True)
    ref = jhandle(tokens.numpy(), return_contacts=True)
    for key in ("logits", "contacts"):
        np.testing.assert_allclose(out[key].numpy(), _np(ref[key]), **TOL)


def test_jax_checkpoint_loads_in_the_port(models, tmp_path):
    version, jcfg, params, cfg, model, alphabet, tokens = models
    path = tmp_path / f"{_stem(version)}.pt"
    if jcfg.is_1b:
        p = dict(params)
        emb = np.asarray(p["embed_tokens"]["weight"]).copy()
        emb[jcfg.mask_idx] = 0  # the v1 loader zeroes it
        p["embed_tokens"] = {"weight": jnp.asarray(emb)}
        jexport.save_esm1b(p, jcfg, str(path))
        if version == "ESM-1v":  # its contact regression is not read: zero
            p["contact_head"] = jax.tree.map(jnp.zeros_like, p["contact_head"])
    else:
        p = params
        jexport.save_esm1(p, jcfg, str(path))
    handle, _ = pretrained.load_model_and_alphabet_local(path, device="cpu")
    out = handle(tokens, repr_layers=[2], return_contacts=True)
    ref = jesm1.apply(p, jcfg, jnp.asarray(tokens.numpy()), repr_layers=(2,),
                      need_head_weights=True, return_contacts=True)
    np.testing.assert_allclose(out["logits"].numpy(), _np(ref["logits"]), **TOL)
    np.testing.assert_allclose(out["representations"][2].numpy(),
                               _np(ref["representations"][2]), **TOL)
    np.testing.assert_allclose(out["contacts"].numpy(), _np(ref["contacts"]), **TOL)


# -- registry ------------------------------------------------------------------------


def test_random_small_esm1_runs_on_cpu():
    handle, alphabet = pretrained.random_model_and_alphabet("esm1_t6_43M_UR50S", seed=1,
                                                            device="cpu")
    assert (handle.kind, handle.num_layers, handle.embed_dim) == ("esm1", 6, 768)
    assert not alphabet.append_eos and len(alphabet) == 35
    toks = alphabet.get_batch_converter()([("a", "MKTAYIAK"), ("b", "MKT")])[2]
    out = handle(toks, repr_layers=[-1], return_contacts=True)
    assert out["logits"].shape == (2, 9, 35) and out["contacts"].shape == (2, 8, 8)
    assert torch.isfinite(out["logits"]).all() and out["logits"].abs().max() > 0


@pytest.mark.parametrize("name,shape", [
    ("esm1_t34_670M_UR50S", ("ESM-1", 34, 1280, 20, 5120, False)),
    ("esm1_t12_85M_UR50S", ("ESM-1", 12, 768, 12, 3072, False)),
    ("esm1b_t33_650M_UR50S", ("ESM-1b", 33, 1280, 20, 5120, False)),
    ("esm1v_t33_650M_UR90S_3", ("ESM-1b", 33, 1280, 20, 5120, True)),
])
def test_released_sizes(name, shape):
    size = tesm1.ESM1_SIZES[name]
    cfg = tesm1.ESM1Config(**size)
    assert (cfg.model_version, cfg.num_layers, cfg.embed_dim, cfg.attention_heads,
            cfg.ffn_embed_dim, cfg.token_dropout) == shape
    assert cfg.emb_layer_norm_before
    assert name in jpretrained._LM_NAMES and callable(getattr(pretrained, name))
    assert callable(pretrained.esm1v_t33_650M_UR90S)


def test_inverse_folding_still_raises(tmp_path):
    """The v1 loader's invariant_gvp branch: ESM-IF1 is ported, so it no
    longer raises NotImplementedError; what still raises is a state that
    does not fit the model (the load is strict). A fitting state loads into
    an IFHandle, and the registry constructor exists."""
    import argparse

    from esm_tpu_torch.models import inverse_folding as tif

    sizes = dict(encoder_embed_dim=32, encoder_layers=1, encoder_attention_heads=2,
                 encoder_ffn_embed_dim=64, decoder_embed_dim=32, decoder_layers=1,
                 decoder_attention_heads=2, decoder_ffn_embed_dim=64, gvp_top_k_neighbors=4,
                 gvp_node_hidden_dim_scalar=16, gvp_node_hidden_dim_vector=4,
                 gvp_edge_hidden_dim_scalar=8, gvp_edge_hidden_dim_vector=1,
                 gvp_num_encoder_layers=1)
    data = {"args": argparse.Namespace(arch="vt_invariant_gvp_transformer", **sizes),
            "model": {}}
    with pytest.raises(RuntimeError, match="Missing key"):
        pretrained.load_model_and_alphabet_core("esm_if1_small", data, device="cpu")
    cfg = tif.GVPTransformerConfig.from_alphabet(Alphabet.from_architecture("invariant_gvp"),
                                                 **sizes)
    data["model"] = tif.init(cfg, torch.Generator().manual_seed(0)).state_dict()
    handle, _ = pretrained.load_model_and_alphabet_core("esm_if1_small", data, device="cpu")
    assert isinstance(handle, pretrained.IFHandle) and handle.cfg == cfg
    assert callable(pretrained.esm_if1_gvp4_t16_142M_UR50)


# -- esm-extract ---------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["ESM-1b", "ESM-1"])
def test_extract_matches_jax(arch, tmp_path):
    """esm-extract on an ESM-1b and an ESM-1 checkpoint, --bucket, against the
    JAX CLI. ESM-1b's learned positions (1026 rows) must take the longest
    sequence, truncated to 1022 residues and bucketed to 1024 tokens; ESM-1
    has no eos."""
    from esm_tpu.cli import extract as jextract
    from esm_tpu_torch.cli import extract as textract

    jcfg = jesm1.ESM1Config.from_alphabet(
        JaxAlphabet.from_architecture(arch), model_version=arch,
        **dict(SIZE, num_layers=2, max_positions=1024))
    params = _jax_params(jcfg, seed=11)
    if jcfg.is_1b:
        emb = np.asarray(params["embed_tokens"]["weight"]).copy()
        emb[jcfg.mask_idx] = 0
        params["embed_tokens"] = {"weight": jnp.asarray(emb)}
    path = str(tmp_path / ("esm1b_tiny.pt" if jcfg.is_1b else "esm1_tiny.pt"))
    (jexport.save_esm1b if jcfg.is_1b else jexport.save_esm1)(params, jcfg, path)
    rng = np.random.RandomState(12)
    lengths = {"s0": 7, "s1": 40, "s2": 1100}
    with open(tmp_path / "seqs.fasta", "w") as f:
        for label, n in lengths.items():
            f.write(f">{label}\n" + "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), n)) + "\n")
    argv = [path, str(tmp_path / "seqs.fasta"), None, "--nogpu", "--bucket", "--repr_layers",
            "0", "-1", "--include", "mean", "per_tok", "contacts", "--toks_per_batch", "2048"]
    for name, cli in (("jax", jextract), ("port", textract)):
        argv[2] = str(tmp_path / name)
        cli.run(cli.create_parser().parse_args(argv))
    for label, n in lengths.items():
        ref = torch.load(tmp_path / "jax" / f"{label}.pt", weights_only=False)
        out = torch.load(tmp_path / "port" / f"{label}.pt", weights_only=False)
        n = min(n, 1022)
        assert out["contacts"].shape == (n, n)
        np.testing.assert_allclose(out["contacts"].numpy(), ref["contacts"].numpy(), **TOL)
        for key in ("representations", "mean_representations"):
            assert sorted(out[key]) == sorted(ref[key]) == [0, 2]
            for layer in (0, 2):
                np.testing.assert_allclose(out[key][layer].numpy(), ref[key][layer].numpy(),
                                           **TOL)
