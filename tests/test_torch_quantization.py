"""The port's weight-only int8 (esm_tpu_torch.quantization) against
esm_tpu.quantization on the CPU, on the same weights (JAX inits carried
across by the ``*_state_dict_from_jax`` functions): the int8 values and
scales, bit for bit, both when the port quantizes the carried fp32 weights
and when esm_tpu's int8 tree is carried across (``adopt_int8_layout``); the
int8 forwards of ESM-2, ESM-1b, ESM-1 (its untied ``embed_out``), an ESMFold
trunk block and an ESM-IF1 score against esm_tpu's int8 forwards; the
port's int8 forward against its own fp32 forward within esm_tpu's bounds
(tests/test_quantization.py); parameter bytes and the handles.

fp32, TF32 off. Tolerances: int8 values and scales exact; int8 forwards
against esm_tpu's 1e-4 of the largest value (the same int8 weights; fp32
summation order); against the fp32 forward 0.15 (max|ref| + 1) with argmax
agreement above 0.95 (esm_tpu's bounds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esm_tpu.data import Alphabet as JaxAlphabet
from esm_tpu.models import esm1 as jesm1
from esm_tpu.models import esm2 as jesm2
from esm_tpu.quantization import param_bytes as jparam_bytes
from esm_tpu.quantization import quantize_params as jquantize
from esm_tpu_torch import pretrained
from esm_tpu_torch.data import Alphabet
from esm_tpu_torch.io import from_jax
from esm_tpu_torch.models import esm1 as tesm1
from esm_tpu_torch.models import esm2 as tesm2
from esm_tpu_torch.quantization import adopt_int8_layout, param_bytes, quantize_params

SIZE = dict(num_layers=2, embed_dim=64, attention_heads=4)


@pytest.fixture(scope="module", autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _tokens(alphabet, seed, eos=True):
    g = np.random.RandomState(seed)
    toks = np.full((2, 18), alphabet.padding_idx, np.int64)
    toks[:, 0] = alphabet.cls_idx
    toks[0, 1:17] = g.randint(4, 24, 16)
    toks[1, 1:9] = g.randint(4, 24, 8)
    if eos:
        toks[0, 17] = toks[1, 9] = alphabet.eos_idx
    return toks


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _carry(model, state_dict):
    adopt_int8_layout(model, state_dict)
    model.load_state_dict(state_dict, strict=True)
    return model


def _close_to_max(got, want, rel=1e-4):
    np.testing.assert_allclose(got, want, atol=rel * np.abs(want).max(), rtol=0)


def _within_int8_bounds(quant, full, argmax=True):
    err = np.abs(quant - full).max()
    assert 0 < err < 0.15 * (np.abs(full).max() + 1), err
    if argmax:
        agree = (quant.argmax(-1) == full.argmax(-1)).mean()
        assert agree > 0.95, agree


@pytest.fixture(scope="module")
def esm2_setup():
    jalpha = JaxAlphabet.from_architecture("ESM-1b")
    jcfg = jesm2.ESM2Config.from_alphabet(jalpha, **SIZE)
    params = jesm2.init(jax.random.PRNGKey(0), jcfg)
    cfg = tesm2.ESM2Config.from_alphabet(Alphabet.from_architecture("ESM-1b"), **SIZE)
    return jcfg, params, cfg, _tokens(jalpha, 1)


def _esm2(esm2_setup, params):
    jcfg, _, cfg, _ = esm2_setup
    return _carry(tesm2.ESM2(cfg, device="cpu"),
                  from_jax.esm2_state_dict_from_jax(_np_tree(params), jcfg))


@pytest.mark.parametrize("min_size", [1, 1 << 13])
def test_int8_values_and_scales_equal_jax(esm2_setup, min_size):
    """min_size 8192 selects the 2-layer stacked leaves of 8192 elements and
    more (q/k/v/out, 2 x 64 x 64) and fc1/fc2, not the LM head's dense
    (64 x 64 = 4096): the port counts a leaf over its stacked layers."""
    jcfg, params, cfg, _ = esm2_setup
    jq = jquantize(params, min_size=min_size)
    want = from_jax.esm2_state_dict_from_jax(_np_tree(jq), jcfg)
    model = quantize_params(_esm2(esm2_setup, params), min_size=min_size)
    got = model.state_dict()
    assert got.keys() == want.keys()
    n_int8 = 0
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        assert torch.equal(got[k], v), k
        n_int8 += v.dtype == torch.int8
    assert n_int8 == (2 * 6 + 2 if min_size == 1 else 2 * 6)
    assert (model.lm_head.dense.weight.dtype == torch.int8) == (min_size == 1)
    assert not model.layers[0].fc1.weight.requires_grad
    assert model.embed_tokens.weight.dtype == torch.float32


def test_esm2_int8_forward(esm2_setup):
    jcfg, params, cfg, toks = esm2_setup
    jq = jquantize(params, min_size=1)
    want = np.asarray(jesm2.apply(jq, jcfg, jnp.asarray(toks))["logits"])
    full = _esm2(esm2_setup, params)
    quant = _esm2(esm2_setup, jq)
    t = torch.from_numpy(toks)
    with torch.no_grad():
        got = tesm2.apply(quant, cfg, t, return_contacts=True)
        f32 = tesm2.apply(full, cfg, t)["logits"].numpy()
    _close_to_max(got["logits"].numpy(), want)
    assert torch.isfinite(got["contacts"]).all()  # the int8 contact regression
    _within_int8_bounds(got["logits"].numpy(), f32)
    assert param_bytes(quant) <= 0.62 * param_bytes(full)
    assert param_bytes(quant) / param_bytes(full) == pytest.approx(
        jparam_bytes(jq) / jparam_bytes(params), abs=0.02)


@pytest.mark.parametrize("version", ["ESM-1b", "ESM-1"])
def test_esm1_int8_forward(version):
    """ESM-1b's tied head and ESM-1's untied ``embed_out`` (an esm_tpu kernel,
    quantized at min_size=1 and read dequantized)."""
    jalpha = JaxAlphabet.from_architecture(version)
    jcfg = jesm1.ESM1Config.from_alphabet(jalpha, model_version=version, ffn_embed_dim=128,
                                          max_positions=64, **SIZE)
    params = jesm1.init(jax.random.PRNGKey(0), jcfg)
    if version == "ESM-1":
        rng = np.random.RandomState(3)
        params["embed_out"]["kernel"] = jnp.asarray(
            rng.randn(64, jcfg.alphabet_size).astype(np.float32) / 8)
    jq = jquantize(params, min_size=1)
    toks = _tokens(jalpha, 2, eos=jalpha.append_eos)
    want = np.asarray(jesm1.apply(jq, jcfg, jnp.asarray(toks))["logits"])
    cfg = tesm1.ESM1Config.from_alphabet(Alphabet.from_architecture(version),
                                         model_version=version, ffn_embed_dim=128,
                                         max_positions=64, **SIZE)
    quant = _carry(tesm1.ESM1(cfg, device="cpu"),
                   from_jax.esm1_state_dict_from_jax(_np_tree(jq), jcfg))
    full = _carry(tesm1.ESM1(cfg, device="cpu"),
                  from_jax.esm1_state_dict_from_jax(_np_tree(params), jcfg))
    ported = quantize_params(_carry(tesm1.ESM1(cfg, device="cpu"),
                                    from_jax.esm1_state_dict_from_jax(_np_tree(params), jcfg)),
                             min_size=1)
    if version == "ESM-1":
        assert quant.embed_out.dtype == ported.embed_out.dtype == torch.int8
        assert torch.equal(quant.embed_out, ported.embed_out)
        assert torch.equal(quant.embed_out_scale, ported.embed_out_scale)
    t = torch.from_numpy(toks)
    with torch.no_grad():
        got = tesm1.apply(quant, cfg, t)["logits"].numpy()
        again = tesm1.apply(ported, cfg, t)["logits"].numpy()
        f32 = tesm1.apply(full, cfg, t)["logits"].numpy()
    _close_to_max(got, want)
    np.testing.assert_array_equal(again, got)
    _within_int8_bounds(got, f32)


def _block_state_dict(block, jblock):
    """A JAX trunk-block tree (one block, int8 or not) as the port block's
    state dict, by io.from_jax.jax_leaf's paths: a kernel transposed, its
    scale and bias; a LayerNorm's scale and bias."""
    sd = {}
    for name, module in block.named_modules():
        if isinstance(module, torch.nn.Linear):
            node = jblock
            for key in from_jax.jax_leaf(name)[0]:
                node = node[key]
            sd[f"{name}.weight"] = torch.from_numpy(
                np.ascontiguousarray(np.asarray(node["kernel"]).T))
            for key in ("bias", "scale"):
                if key in node:
                    sd[f"{name}.{key}"] = torch.from_numpy(np.array(node[key]))
        elif isinstance(module, torch.nn.LayerNorm):
            node = jblock
            for key in from_jax.jax_leaf(name)[0]:
                node = node[key]
            sd[f"{name}.weight"] = torch.from_numpy(np.array(node["scale"]))
            sd[f"{name}.bias"] = torch.from_numpy(np.array(node["bias"]))
    return sd


def test_esmfold_trunk_block_int8():
    """An ESMFold trunk block at int8 (its tri-mul projections are read
    dequantized through materialize_weight) against esm_tpu's; the port's
    quantization of the carried fp32 block equals esm_tpu's int8 block."""
    from esm_tpu.models.esmfold import blocks as jblocks
    from esm_tpu.models.esmfold.init import _KeyGen, init_trunk_block
    from esm_tpu_torch.models.esmfold import blocks as tblocks

    rng = np.random.RandomState(4)
    params = jax.tree.map(
        lambda x: (np.asarray(x) + 0.05 * rng.randn(*np.shape(x))).astype(np.float32),
        init_trunk_block(_KeyGen(jax.random.PRNGKey(0)), 64, 32, seq_head_width=16,
                         pair_head_width=16))
    jq = jquantize(params, min_size=1)

    def block(tree):
        b = tblocks.TriangularSelfAttentionBlock(64, 32, 16, 16)
        return _carry(b, _block_state_dict(b, tree))

    quant, full, ported = block(jq), block(params), quantize_params(block(params), min_size=1)
    for k, v in quant.state_dict().items():
        assert torch.equal(ported.state_dict()[k], v), k
    assert quant.tri_mul_out.linear_a_g.weight.dtype == torch.int8
    s = rng.randn(1, 9, 64).astype(np.float32)
    z = rng.randn(1, 9, 9, 32).astype(np.float32)
    js, jz = jblocks.triangular_self_attention_block(jax.tree.map(jnp.asarray, jq),
                                                     jnp.asarray(s), jnp.asarray(z),
                                                     seq_heads=4, pair_heads=2)
    outs = {}
    for tag, m in (("int8", quant), ("fp32", full)):
        with torch.no_grad():
            outs[tag] = tblocks.triangular_self_attention_block(
                m, torch.from_numpy(s), torch.from_numpy(z), seq_heads=4, pair_heads=2)
    _close_to_max(outs["int8"][0].numpy(), np.asarray(js))
    _close_to_max(outs["int8"][1].numpy(), np.asarray(jz))
    for got, f32 in zip(outs["int8"], outs["fp32"]):
        _within_int8_bounds(got.numpy(), f32.numpy(), argmax=False)


def test_if1_int8_score():
    from esm_tpu.models import inverse_folding as jif
    from esm_tpu_torch.models import inverse_folding as tif

    size = dict(encoder_embed_dim=64, encoder_layers=2, encoder_attention_heads=4,
                encoder_ffn_embed_dim=128, decoder_embed_dim=64, decoder_layers=2,
                decoder_attention_heads=4, decoder_ffn_embed_dim=128, gvp_top_k_neighbors=6,
                gvp_node_hidden_dim_scalar=32, gvp_node_hidden_dim_vector=8,
                gvp_edge_hidden_dim_scalar=16, gvp_edge_hidden_dim_vector=1,
                gvp_num_encoder_layers=2)
    jalpha = JaxAlphabet.from_architecture("invariant_gvp")
    jcfg = jif.GVPTransformerConfig.from_alphabet(jalpha, **size)
    params = jif.init(jax.random.PRNGKey(0), jcfg)
    jq = jquantize(params, min_size=1)
    L = 11
    t = np.arange(L)[:, None]
    g = np.random.RandomState(5)
    ca = np.concatenate([np.cos(t * 0.6) * 2.3, np.sin(t * 0.6) * 2.3, t * 1.5], -1)
    ca = ca + g.randn(L, 3) * 0.2
    coords = np.stack([ca + [1.2, 0, 0], ca, ca + [0, 1.2, 0]], 1).astype(np.float32)
    seq = "KALTARQQEVF"
    want, _ = jif.score_sequence(jq, jcfg, jalpha, coords, seq)
    alphabet = Alphabet.from_architecture("invariant_gvp")
    cfg = tif.GVPTransformerConfig.from_alphabet(alphabet, **size)
    quant = _carry(tif.GVPTransformerModel(cfg),
                   from_jax.if1_state_dict_from_jax(_np_tree(jq), cfg))
    full = _carry(tif.GVPTransformerModel(cfg),
                  from_jax.if1_state_dict_from_jax(_np_tree(params), cfg))
    got, _ = tif.score_sequence(quant, alphabet, coords, seq)
    f32, _ = tif.score_sequence(full, alphabet, coords, seq)
    assert abs(got - want) <= 1e-4 * max(abs(want), 1.0), (got, want)
    assert got != f32 and abs(got - f32) < 0.3  # esm_tpu's bound for the int8 score


def test_handles_quantized(esm2_setup):
    jcfg, params, cfg, toks = esm2_setup
    model = _esm2(esm2_setup, params)
    handle = pretrained.LMHandle("esm2", cfg, model, Alphabet.from_architecture("ESM-1b"))
    hq = handle.quantized(min_size=1)
    assert hq.model is not model and model.layers[0].fc1.weight.dtype == torch.float32
    assert hq.model.layers[0].fc1.weight.dtype == torch.int8
    out = hq(torch.from_numpy(toks))
    assert torch.isfinite(out["logits"]).all()
