"""The port's ESM-IF1 (esm_tpu_torch.models.inverse_folding) against esm_tpu's
on the CPU, on the same weights (JAX init, every leaf perturbed so no bias is
zero and no LN is the identity, carried across by if1_state_dict_from_jax)
and the same seeded backbones: the kNN graph (indices exactly), node and
edge features, the dihedral embedding, one GVP, a GVP conv layer, the GVP
encoder, the transformer encoder, the teacher-forced logits, the scores,
the encoder output and the incremental decode step; then the port's own
decode against its teacher forcing, its sampling distribution against the
softmax of the JAX logits (20,000 draws, total variation <= 0.03),
partial_seq, pad_to_multiple, rotation invariance and the multichain score.

Size as tests/test_inverse_folding.py sizes it: 64 wide, 2+2 layers, 4
heads, k = 6, node 32/8, edge 16/1, 2 GVP layers. fp32 throughout.
Tolerances (summation order and transcendental implementations only):
features and single modules 1e-5 absolute and relative; the GVP encoder,
the transformer encoder, logits, scores and decode steps 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esm_tpu.data import Alphabet as JaxAlphabet
from esm_tpu.models import inverse_folding as jif
from esm_tpu.models.inverse_folding import features as jfeat
from esm_tpu.models.inverse_folding import gvp as jgvp
from esm_tpu.models.inverse_folding import model as jmodel
from esm_tpu.models.inverse_folding import multichain as jmulti
from esm_tpu.models.inverse_folding import transformer as jtrans
from esm_tpu_torch.data import Alphabet
from esm_tpu_torch.io.from_jax import if1_state_dict_from_jax
from esm_tpu_torch.models import inverse_folding as tif
from esm_tpu_torch.models.inverse_folding import features as tfeat
from esm_tpu_torch.models.inverse_folding import model as tmodel
from esm_tpu_torch.models.inverse_folding import multichain as tmulti
from esm_tpu_torch.models.inverse_folding import transformer as ttrans

FEAT_TOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-4, rtol=1e-4)
SIZE = dict(
    encoder_embed_dim=64, encoder_layers=2, encoder_attention_heads=4, encoder_ffn_embed_dim=128,
    decoder_embed_dim=64, decoder_layers=2, decoder_attention_heads=4, decoder_ffn_embed_dim=128,
    gvp_top_k_neighbors=6, gvp_node_hidden_dim_scalar=32, gvp_node_hidden_dim_vector=8,
    gvp_edge_hidden_dim_scalar=16, gvp_edge_hidden_dim_vector=1, gvp_num_encoder_layers=2,
)
AAS = "ACDEFGHIKLMNPQRSTVWY"


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def backbone(L, seed, gap=None):
    """A wobbly helix (N, CA, C per residue), NaN rows at ``gap`` (a slice).
    CA is jittered too: on an exact helix the distances to i-d and i+d tie,
    and which neighbour comes first would turn on rounding."""
    g = np.random.RandomState(seed)
    t = np.arange(L)[:, None]
    ca = np.concatenate([np.cos(t * 0.6) * 2.3, np.sin(t * 0.6) * 2.3, t * 1.5], axis=-1)
    ca = ca + g.randn(L, 3) * 0.2
    n = ca + g.randn(L, 3) * 0.3 + [1.2, 0, 0]
    c = ca + g.randn(L, 3) * 0.3 + [0, 1.2, 0]
    coords = np.stack([n, ca, c], axis=1).astype(np.float32)
    if gap is not None:
        coords[gap] = np.nan
    return coords


@pytest.fixture(scope="module")
def models():
    jalphabet = JaxAlphabet.from_architecture("invariant_gvp")
    alphabet = Alphabet.from_architecture("invariant_gvp")
    jcfg = jmodel.GVPTransformerConfig.from_alphabet(jalphabet, **SIZE)
    cfg = tmodel.GVPTransformerConfig.from_alphabet(alphabet, **SIZE)
    rng = np.random.RandomState(1)
    params = jax.tree.map(
        lambda x: (np.asarray(x) + 0.1 * rng.randn(*np.shape(x))).astype(np.float32),
        jif.init(jax.random.PRNGKey(0), jcfg))
    model = tmodel.GVPTransformerModel(cfg)
    model.load_state_dict(if1_state_dict_from_jax(params, cfg), strict=True)
    model.eval()
    return params, jcfg, jalphabet, model, cfg, alphabet


@pytest.fixture(scope="module")
def batch(models):
    """Two backbones of 13 and 9 residues (a NaN gap in the first, a missing
    residue in the second), through both packages' converters."""
    _, _, jalphabet, _, _, alphabet = models
    raw = [(backbone(13, 0, gap=slice(4, 6)), None, None), (backbone(9, 1, gap=3), 0.7, None)]
    jb = jif.CoordBatchConverter(jalphabet)(raw)
    tb = tif.CoordBatchConverter(alphabet)(raw)
    for j, t in zip(jb, tb):
        if isinstance(j, np.ndarray):
            np.testing.assert_array_equal(np.asarray(t), j)
    coords, conf, _, _, pmask = jb
    return coords, conf.astype(np.float32), pmask


def test_coord_batch_converter(models):
    _, _, jalphabet, _, _, alphabet = models
    raw = [(backbone(5, 2), None, "MKTAY"), (backbone(3, 3, gap=1), [0.5, 0.2, 0.9], None)]
    j = jif.CoordBatchConverter(jalphabet)(raw)
    t = tif.CoordBatchConverter(alphabet)(raw)
    np.testing.assert_array_equal(t[0].numpy(), j[0])      # inf bos/eos, NaN padding
    np.testing.assert_array_equal(t[1].numpy(), j[1])      # confidence, -1 where no coords
    np.testing.assert_array_equal(t[3].numpy(), j[3])      # <cath> first, then residues
    np.testing.assert_array_equal(t[4].numpy(), j[4])      # padding_mask
    assert t[3][0, 0] == alphabet.get_idx("<cath>")


@pytest.mark.parametrize("clean", [False, True], ids=["raw_nan", "nan_to_num"])
def test_knn_graph_indices_equal_jax(batch, clean):
    coords, _, pmask = batch
    coord_mask = np.isfinite(coords).all(axis=(-1, -2))
    x = np.where(np.isfinite(coords), coords, 0) if clean else coords
    jd, je, jcm, jrm = jfeat.knn_graph(jnp.asarray(x[:, :, 1]), jnp.asarray(coord_mask),
                                       jnp.asarray(pmask), 6)
    td, te, tcm, trm = tfeat.knn_graph(_t(x[:, :, 1]), _t(coord_mask), _t(pmask), 6)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tcm.numpy(), np.asarray(jcm))
    np.testing.assert_array_equal(trm.numpy(), np.asarray(jrm))
    np.testing.assert_allclose(td.numpy(), _np(jd), **FEAT_TOL)
    # ties are present: residues without coordinates see equal distances
    # both ways along the chain, and the lower index must come first
    assert (np.diff(td.numpy(), axis=-1) == 0).any()


def test_node_and_edge_features(batch):
    coords, _, pmask = batch
    coord_mask = np.isfinite(coords).all(axis=(-1, -2))
    x = np.where(np.isfinite(coords), coords, 0)
    js, jv = jfeat.node_features(jnp.asarray(x), jnp.asarray(coord_mask))
    ts, tv = tfeat.node_features(_t(x), _t(coord_mask))
    np.testing.assert_allclose(ts.numpy(), _np(js), **FEAT_TOL)
    np.testing.assert_allclose(tv.numpy(), _np(jv), **FEAT_TOL)
    (jes, jev), jsrc, jdst, jvalid = jfeat.edge_features(
        jnp.asarray(x), jnp.asarray(coord_mask), jnp.asarray(pmask), top_k=6)
    (tes, tev), tsrc, tdst, tvalid = tfeat.edge_features(
        _t(x), _t(coord_mask), _t(pmask), top_k=6)
    for got, want in ((tsrc, jsrc), (tdst, jdst), (tvalid, jvalid)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(tes.numpy(), _np(jes), **FEAT_TOL)
    np.testing.assert_allclose(tev.numpy(), _np(jev), **FEAT_TOL)


def test_dihedral_features(models, batch):
    params, _, _, model, _, _ = models
    coords = np.where(np.isfinite(batch[0]), batch[0], 0)
    want = jfeat.dihedral_features(params["encoder"]["embed_dihedrals"], jnp.asarray(coords))
    with torch.no_grad():
        got = model.encoder.embed_dihedrals(_t(coords))
    np.testing.assert_allclose(got.numpy(), _np(want), **FEAT_TOL)


def _graph(params, batch):
    """The JAX graph embedding's outputs, as numpy."""
    coords, conf, pmask = batch
    coord_mask = np.isfinite(coords).all(axis=(-1, -2))
    x = np.where(np.isfinite(coords), coords, 0)
    (s, v), (es, ev), src, dst, valid = jgvp.gvp_graph_embedding_apply(
        params["encoder"]["gvp_encoder"]["embed_graph"], jnp.asarray(x), jnp.asarray(coord_mask),
        jnp.asarray(pmask), jnp.asarray(conf), top_k=6)
    return [np.asarray(a) for a in (s, v, es, ev, src, dst, valid)], (x, coord_mask)


def test_graph_embedding_and_one_gvp(models, batch):
    params, _, _, model, _, _ = models
    (s, v, es, ev, src, dst, valid), (x, cm) = _graph(params, batch)
    emb = model.encoder.gvp_encoder.embed_graph
    with torch.no_grad():
        (ts, tv), (tes, tev), tsrc, tdst, tvalid = emb(_t(x), _t(cm), _t(batch[2]), _t(batch[1]))
    for got, want in ((ts, s), (tv, v), (tes, es), (tev, ev)):
        np.testing.assert_allclose(got.numpy(), want, **FEAT_TOL)
    np.testing.assert_array_equal(tdst.numpy(), dst)
    # the first message GVP (vector-gated) on one batch of random inputs
    rng = np.random.RandomState(5)
    ms = rng.randn(3, 7, 2 * 32 + 16).astype(np.float32)
    mv = rng.randn(3, 7, 2 * 8 + 1, 3).astype(np.float32)
    jp = params["encoder"]["gvp_encoder"]["encoder_layers"][0]["conv"]["message_func"][0]
    js, jv = jgvp.gvp_apply(jp, jnp.asarray(ms), jnp.asarray(mv), vector_gate=True)
    with torch.no_grad():
        gs, gv = model.encoder.gvp_encoder.encoder_layers[0].conv.message_func[0](_t(ms), _t(mv))
    np.testing.assert_allclose(gs.numpy(), _np(js), **FEAT_TOL)
    np.testing.assert_allclose(gv.numpy(), _np(jv), **FEAT_TOL)


def test_gvp_conv_layer(models, batch):
    params, _, _, model, _, _ = models
    (s, v, es, ev, src, dst, valid), _ = _graph(params, batch)
    js, jv = jgvp.gvp_conv_layer_apply(
        params["encoder"]["gvp_encoder"]["encoder_layers"][0], *map(jnp.asarray, (
            s, v, es, ev, src, dst, valid)))
    with torch.no_grad():
        ts, tv = model.encoder.gvp_encoder.encoder_layers[0](*map(_t, (s, v, es, ev, src, dst,
                                                                      valid)))
    np.testing.assert_allclose(ts.numpy(), _np(js), **TOL)
    np.testing.assert_allclose(tv.numpy(), _np(jv), **TOL)


def test_gvp_encoder(models, batch):
    params, _, _, model, _, _ = models
    coords, conf, pmask = batch
    cm = np.isfinite(coords).all(axis=(-1, -2))
    x = np.where(np.isfinite(coords), coords, 0)
    js, jv = jgvp.gvp_encoder_apply(params["encoder"]["gvp_encoder"], jnp.asarray(x),
                                    jnp.asarray(cm), jnp.asarray(pmask), jnp.asarray(conf),
                                    top_k=6, num_layers=2)
    with torch.no_grad():
        ts, tv = model.encoder.gvp_encoder(_t(x), _t(cm), _t(pmask), _t(conf))
    np.testing.assert_allclose(ts.numpy(), _np(js), **TOL)
    np.testing.assert_allclose(tv.numpy(), _np(jv), **TOL)


def test_transformer_encoder_and_logits(models, batch):
    params, jcfg, _, model, cfg, _ = models
    coords, conf, pmask = batch
    want = jmodel.encoder_apply(params["encoder"], jcfg, jnp.asarray(coords), jnp.asarray(pmask),
                                jnp.asarray(conf))
    with torch.no_grad():
        got = tmodel.encoder_apply(model.encoder, cfg, _t(coords), _t(pmask), _t(conf))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)

    rng = np.random.RandomState(2)
    prev = rng.randint(4, 24, size=(2, 12)).astype(np.int64)
    prev[:, 0] = cfg.cath_idx
    prev[1, 9:] = cfg.padding_idx
    want = jif.apply(params, jcfg, jnp.asarray(coords), jnp.asarray(pmask), jnp.asarray(conf),
                     jnp.asarray(prev.astype(np.int32)))
    with torch.no_grad():
        got = model(_t(coords), _t(pmask), _t(conf), _t(prev))
    assert got.shape == (2, cfg.alphabet_size, 12)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_score_sequence_and_encoder_output(models):
    params, jcfg, jalphabet, model, _, alphabet = models
    coords = backbone(11, 2, gap=slice(3, 5))
    seq = "KALTARQQEVF"
    want = jif.score_sequence(params, jcfg, jalphabet, coords, seq)
    got = tif.score_sequence(model, alphabet, coords, seq)
    np.testing.assert_allclose(got, want, **TOL)
    want = jif.get_encoder_output(params, jcfg, jalphabet, coords)
    got = tif.get_encoder_output(model, alphabet, coords)
    assert got.shape == (11, 64)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_decoder_step_matches_jax_with_pads(models):
    """The port's decoder_step against JAX's over a fixed token sequence with
    <pad> inside it (the multichain pattern): every step's logits."""
    params, jcfg, jalphabet, model, cfg, alphabet = models
    coords = backbone(10, 11)
    bc, conf, _, _, pmask = tif.CoordBatchConverter(alphabet)([(coords, None, None)])
    rng = np.random.RandomState(3)
    tokens = rng.randint(4, 24, size=(1, 10)).astype(np.int64)
    tokens[0, 0] = cfg.cath_idx
    tokens[0, 3:6] = cfg.padding_idx
    jenc = jmodel.encoder_apply(params["encoder"], jcfg, jnp.asarray(bc.numpy()),
                                jnp.asarray(pmask.numpy()), jnp.asarray(conf.numpy()))
    jcache = jtrans.init_decode_cache(params["decoder"], jenc, num_heads=4, num_layers=2,
                                      max_len=10)
    with torch.no_grad():
        enc = tmodel.encoder_apply(model.encoder, cfg, bc, pmask, conf)
    cache = ttrans.init_decode_cache(model.decoder, enc, num_heads=4, max_len=10,
                                     padding_idx=cfg.padding_idx)
    for i in range(10):
        want, jcache = jtrans.decoder_step(
            params["decoder"], jnp.asarray(tokens[:, i].astype(np.int32)), i, jcache,
            num_heads=4, num_layers=2, padding_idx=cfg.padding_idx,
            enc_padding_mask=jnp.asarray(pmask.numpy()))
        got, cache = ttrans.decoder_step(model.decoder, _t(tokens[:, i]), i, cache, num_heads=4,
                                         padding_idx=cfg.padding_idx, enc_padding_mask=pmask)
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL, err_msg=f"step {i}")
    np.testing.assert_array_equal(cache.pad_mask.numpy(), np.asarray(jcache.pad_mask))


@pytest.mark.parametrize("with_pads", [False, True])
def test_incremental_decode_matches_teacher_forcing(models, with_pads):
    """Each decode step's logits equal the teacher-forced logits of the
    tokens the decode produced, <pad> inputs included (prefilled, or drawn:
    a random model draws any token)."""
    _, _, _, model, cfg, alphabet = models
    coords = backbone(12, 4)
    L = len(coords)
    bc, conf, _, _, pmask = tif.CoordBatchConverter(alphabet)([(coords, None, None)])
    init = torch.full((3, L + 1), cfg.mask_idx, dtype=torch.int64)
    init[:, 0] = cfg.cath_idx
    if with_pads:
        init[:, 4:7] = cfg.padding_idx
    steps = []
    tokens = tmodel.sample_tokens(model, bc, pmask, conf, init,
                                  torch.Generator().manual_seed(0), 1.0, step_logits=steps)
    assert len(steps) == L and (tokens[:, 4:7] == cfg.padding_idx).all() == with_pads
    with torch.no_grad():
        tf = model(bc.expand(3, -1, -1, -1), pmask.expand(3, -1), conf.expand(3, -1),
                   tokens[:, :-1])
    for i, step in enumerate(steps):
        np.testing.assert_allclose(step.numpy(), tf[:, :, i].numpy(), **TOL, err_msg=f"step {i}")


def test_sampling_distribution_matches_jax_softmax(models):
    """20,000 draws at the first position (one batched decode) against
    softmax(logits / T) of the JAX teacher-forced logits there: total
    variation <= 0.03 (sampling noise alone is ~0.015 at this count)."""
    params, jcfg, jalphabet, model, cfg, alphabet = models
    coords = backbone(3, 6)
    T, n = 1.3, 20000
    toks = tif.sample(model, alphabet, coords, temperature=T, seed=7, num_samples=n,
                      return_tokens=True)
    bc, conf, _, _, pmask = jif.CoordBatchConverter(jalphabet)([(coords, None, None)])
    prev = np.asarray([[cfg.cath_idx]], np.int32)
    logits = _np(jif.apply(params, jcfg, jnp.asarray(bc), jnp.asarray(pmask), jnp.asarray(conf),
                           jnp.asarray(prev)))[0, :, 0]
    p = np.exp((logits - logits.max()) / T)
    p /= p.sum()
    freq = np.bincount(toks[:, 0], minlength=len(p)) / n
    tv = 0.5 * np.abs(freq - p).sum()
    assert tv <= 0.03, tv


def test_partial_seq_and_pad_to_multiple(models):
    _, _, _, model, cfg, alphabet = models
    coords = backbone(11, 5)
    partial = ["K", None, None, "T", "A", "R", "Q", "Q", "E", "V", "F"]
    toks = tif.sample(model, alphabet, coords, partial_seq=[c or "<mask>" for c in partial],
                      seed=2, return_tokens=True)
    for i, c in enumerate(partial):
        if c is not None:
            assert alphabet.get_tok(int(toks[i])) == c, i
    assert toks[1] != cfg.mask_idx and toks[2] != cfg.mask_idx

    # a random model draws special tokens too: compare tokens, not lengths
    plain = tif.sample(model, alphabet, coords, seed=9, num_samples=4, return_tokens=True)
    padded = tif.sample(model, alphabet, coords, seed=9, num_samples=4, pad_to_multiple=16,
                        return_tokens=True)
    assert plain.shape == (4, 11)
    np.testing.assert_array_equal(padded, plain)
    assert len({tuple(row) for row in plain}) > 1  # the rows are independent draws
    one = tif.sample(model, alphabet, coords, seed=9)
    assert one == tif.sample(model, alphabet, coords, seed=9, pad_to_multiple=8)
    assert tif.sample(model, alphabet, coords, generator=torch.Generator().manual_seed(9)) == one


def test_encoder_output_is_rotation_invariant(models):
    from scipy.stats import special_ortho_group

    _, _, _, model, _, alphabet = models
    coords = backbone(11, 3)
    R = special_ortho_group.rvs(3, random_state=0).astype(np.float32)
    a = tif.get_encoder_output(model, alphabet, coords)
    b = tif.get_encoder_output(model, alphabet, coords @ R.T)
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-4, rtol=1e-4)


def test_multichain_score_and_sample(models):
    params, jcfg, jalphabet, model, cfg, alphabet = models
    coords = {"A": backbone(9, 7), "B": backbone(6, 8, gap=2), "C": backbone(4, 9)}
    for target, seq in (("A", "MKTAYIAKQ"), ("B", "GAVLIE")):
        want = jmulti.score_sequence_in_complex(params, jcfg, jalphabet, coords, target, seq)
        got = tmulti.score_sequence_in_complex(model, alphabet, coords, target, seq)
        np.testing.assert_allclose(got, want, **TOL)
    all_coords = tmulti._concatenate_coords(coords, "B")
    np.testing.assert_array_equal(all_coords, jmulti._concatenate_coords(coords, "B"))
    assert all_coords.shape[0] == 6 + 10 + 9 + 10 + 4
    seq = tmulti.sample_sequence_in_complex(model, alphabet, coords, "B", seed=3)
    assert len(seq) == 6 and set(seq) <= set(alphabet.all_toks[4:]) | set("X")
