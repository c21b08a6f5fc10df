"""The port's MSA Transformer and ESM-IF1 trainers and its adafactor
(esm_tpu_torch.training) against esm_tpu.training on the CPU, on the same
weights (JAX inits carried across) and, for the MLM steps, JAX's
corruption: train_step_msa's loss and gradients, LoRA over the MSA
Transformer (tests/test_msa_training.py), if_loss_sums and train_step_if's
gradients, LoRA over ESM-IF1 and merge on its list-stacked decoder
(tests/test_if_training.py); make_optimizer(factored=True) against
optax.adafactor on ESM-2 at width 128, where the linears factor.

fp32, TF32 off. Tolerances (tests/test_torch_training.py's): losses and
gradients 1e-4 absolute; if_loss_sums 1e-5 relative; optimizer steps on the
same gradients 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from esm_tpu import lora as jlora
from esm_tpu import training as jtraining
from esm_tpu.data import Alphabet as JaxAlphabet
from esm_tpu.models import esm2 as jesm2
from esm_tpu.models import inverse_folding as jif
from esm_tpu.models import msa_transformer as jmsa
from esm_tpu_torch import lora, training
from esm_tpu_torch.data import Alphabet
from esm_tpu_torch.io import from_jax
from esm_tpu_torch.models import esm2 as tesm2
from esm_tpu_torch.models import inverse_folding as tif
from esm_tpu_torch.models import msa_transformer as tmsa

TOL = dict(atol=1e-4, rtol=0)
AA = list("ACDEFGHIKLMNPQRSTVWY")


@pytest.fixture(scope="module", autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _grads(model):
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p)).clone()
            for n, p in model.named_parameters()}


# -- MSA Transformer ---------------------------------------------------------


@pytest.fixture(scope="module")
def msa():
    msa_size = dict(num_layers=2, embed_dim=64, ffn_embed_dim=128, attention_heads=4)
    jalpha = JaxAlphabet.from_architecture("msa_transformer")
    jcfg = jmsa.MSATransformerConfig.from_alphabet(jalpha, **msa_size)
    params = jmsa.init(jax.random.PRNGKey(0), jcfg)
    alphabet = Alphabet.from_architecture("msa_transformer")
    cfg = tmsa.MSATransformerConfig.from_alphabet(alphabet, **msa_size)
    base = "KALTARQQEVFDLIRD"
    msas = [[("a", base), ("b", base[:5] + "L" + base[6:]), ("c", base)],
            [("d", base[:12]), ("e", "M" + base[1:12])]]
    toks = alphabet.get_batch_converter()(msas)[2]
    return jcfg, params, cfg, toks, from_jax.msa_state_dict_from_jax(_np_tree(params), jcfg)


def _msa_model(msa):
    model = tmsa.MSATransformer(msa[2], device="cpu")
    model.load_state_dict(msa[4], strict=True)
    return model


def test_msa_loss_and_grads_match_jax(msa):
    jcfg, params, cfg, toks, _ = msa
    jtoks = jnp.asarray(toks.numpy())
    corrupted, target_mask = jtraining._corrupt_batch(jcfg, jax.random.PRNGKey(3), jtoks)
    assert int(target_mask.sum()) > 0
    (jloss, _), jgrads = jax.value_and_grad(jtraining.mlm_loss, has_aux=True)(
        params, jcfg, corrupted, jtoks, target_mask, jmsa.apply)
    model = _msa_model(msa)
    loss, _ = training.mlm_loss(model, cfg, torch.from_numpy(np.array(corrupted)).to(torch.int64),
                                toks, torch.from_numpy(np.array(target_mask)), tmsa.apply)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    want = from_jax.msa_state_dict_from_jax(_np_tree(jgrads), jcfg)
    for name, g in _grads(model).items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), err_msg=name, **TOL)


def test_train_step_msa_overfits_tiny_batch(msa):
    _, _, cfg, toks, _ = msa
    model = _msa_model(msa)
    tx = training.make_optimizer(3e-3, warmup_steps=1, total_steps=50)
    state = training.init_state(model, tx)
    losses = []
    for i in range(6):
        state, metrics = training.train_step_msa(state, cfg, tx,
                                                 torch.Generator().manual_seed(2), toks)
        losses.append(metrics["loss"].item())
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_train_step_lora_msa_family(msa):
    """train_step_lora's apply_fn drives the MSA Transformer: the adapters of
    the row/column attention and FFN linears train; the base is frozen."""
    _, _, cfg, toks, state_dict = msa
    model = _msa_model(msa)
    adapters = lora.init_lora(torch.Generator().manual_seed(1), model, rank=4)
    assert "layers.0.row_self_attention.layer.q_proj" in dict(adapters.adapters())
    start = {k: v.clone() for k, v in adapters.state_dict().items()}
    tx = training.make_optimizer(5e-2, warmup_steps=1, total_steps=50)
    state = training.init_state(adapters, tx)
    losses = []
    for i in range(5):
        state, metrics = training.train_step_lora(
            state, model, cfg, tx, torch.Generator().manual_seed(3), toks, apply_fn=tmsa.apply)
        losses.append(metrics["loss"].item())
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert any(not torch.equal(v, start[k]) for k, v in adapters.state_dict().items())
    for k, v in model.state_dict().items():
        assert torch.equal(v, state_dict[k]), k


# -- ESM-IF1 -----------------------------------------------------------------

IF_SIZE = dict(
    encoder_embed_dim=64, encoder_layers=2, encoder_attention_heads=4, encoder_ffn_embed_dim=128,
    decoder_embed_dim=64, decoder_layers=2, decoder_attention_heads=4, decoder_ffn_embed_dim=128,
    gvp_top_k_neighbors=6, gvp_node_hidden_dim_scalar=32, gvp_node_hidden_dim_vector=8,
    gvp_edge_hidden_dim_scalar=16, gvp_edge_hidden_dim_vector=1, gvp_num_encoder_layers=1,
)


@pytest.fixture(scope="module")
def if1():
    jalpha = JaxAlphabet.from_architecture("invariant_gvp")
    jcfg = jif.GVPTransformerConfig.from_alphabet(jalpha, **IF_SIZE)
    rng = np.random.RandomState(1)
    params = jax.tree.map(
        lambda x: (np.asarray(x) + 0.1 * rng.randn(*np.shape(x))).astype(np.float32),
        jif.init(jax.random.PRNGKey(0), jcfg))
    alphabet = Alphabet.from_architecture("invariant_gvp")
    cfg = tif.GVPTransformerConfig.from_alphabet(alphabet, **IF_SIZE)
    rnd = np.random.default_rng(0)
    items = []
    for length in (12, 9):  # ragged: NaN batch padding and the pad mask
        coords = (rnd.normal(size=(length, 3, 3)) * 3.0).astype(np.float32)
        items.append((coords, None, "".join(rnd.choice(AA, size=length))))
    coords, conf, _, tokens, pmask = tif.CoordBatchConverter(alphabet)(items)
    batch = (coords, pmask, conf, tokens)
    jbatch = tuple(jnp.asarray(t.numpy()) for t in batch)
    return dict(jcfg=jcfg, params=params, cfg=cfg, alphabet=alphabet, items=items,
                batch=batch, jbatch=jbatch,
                state_dict=from_jax.if1_state_dict_from_jax(params, cfg))


def _if_model(if1):
    model = tif.GVPTransformerModel(if1["cfg"])
    model.load_state_dict(if1["state_dict"], strict=True)
    return model


def test_if_loss_sums_match_jax_and_score(if1):
    jnll, jaux = jtraining.if_loss_sums(if1["params"], if1["jcfg"], *if1["jbatch"])
    model = _if_model(if1)
    with torch.no_grad():
        nll, aux = training.if_loss_sums(model, if1["cfg"], *if1["batch"])
    np.testing.assert_allclose(nll.item(), float(jnll), rtol=1e-5)
    assert aux["count"].item() == float(jaux["count"])
    assert aux["correct"].item() == float(jaux["correct"])
    coords, _, seq = if1["items"][1]
    one = tif.CoordBatchConverter(if1["alphabet"])([(coords, None, seq)])
    with torch.no_grad():
        nll1, aux1 = training.if_loss_sums(model, if1["cfg"], one[0], one[4], one[1], one[3])
    ll, _ = tif.score_sequence(model, if1["alphabet"], coords, seq)
    np.testing.assert_allclose(-nll1.item() / aux1["count"].item(), ll, rtol=1e-5)


def test_train_step_if_grads_match_jax(if1):
    jcfg = if1["jcfg"]

    def loss_fn(p):
        nll, aux = jtraining.if_loss_sums(p, jcfg, *if1["jbatch"])
        return nll / jnp.maximum(aux["count"], 1.0)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(if1["params"])
    model = _if_model(if1)
    loss, _ = training._if_loss(model, if1["cfg"], if1["batch"])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    want = from_jax.if1_state_dict_from_jax(_np_tree(jgrads), if1["cfg"])
    for name, g in _grads(model).items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), err_msg=name, **TOL)


def test_train_step_if_overfits_tiny_batch(if1):
    model = _if_model(if1)
    tx = training.make_optimizer(3e-3, warmup_steps=1, total_steps=50)
    state = training.init_state(model, tx)
    losses = []
    for _ in range(6):
        state, metrics = training.train_step_if(state, if1["cfg"], tx, *if1["batch"])
        losses.append(metrics["loss"].item())
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_train_step_if_lora_trains_adapters_only(if1):
    model = _if_model(if1)
    adapters = lora.init_lora(torch.Generator().manual_seed(1), model, rank=4)
    assert "decoder.layers.0.self_attn.q_proj" in dict(adapters.adapters())
    start = {k: v.clone() for k, v in adapters.state_dict().items()}
    tx = training.make_optimizer(5e-2, warmup_steps=1, total_steps=50)
    state = training.init_state(adapters, tx)
    losses = []
    for _ in range(5):
        state, metrics = training.train_step_if_lora(state, model, if1["cfg"], tx, *if1["batch"])
        losses.append(metrics["loss"].item())
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert any(not torch.equal(v, start[k]) for k, v in adapters.state_dict().items())
    for k, v in model.state_dict().items():
        assert torch.equal(v, if1["state_dict"][k]), k
    assert all(p.grad is None for p in model.parameters())


def test_if_lora_merge_matches_patch_on_list_stacked_decoder(if1):
    """JAX's adapters over the list-stacked encoder and decoder layers
    carried across: the patched loss equals esm_tpu's, and merge equals
    patch; a decoder layer that the model lacks is refused."""
    params = if1["params"]
    rng = np.random.RandomState(2)
    jad = jlora.init_lora(jax.random.PRNGKey(1), params, rank=4)
    jad = jax.tree_util.tree_map_with_path(
        lambda path, x: (rng.randn(*x.shape) * 0.05).astype(np.float32)
        if path[-1].key == "lora_b" else np.asarray(x), jad)
    want, _ = jtraining.if_loss_sums(jlora.patch(params, jad, scale=0.5), if1["jcfg"],
                                     *if1["jbatch"])
    model = _if_model(if1)
    adapters = from_jax.lora_from_jax(jad, model)
    assert "decoder.layers.1.fc2" in dict(adapters.adapters())
    with torch.no_grad():
        base, _ = training.if_loss_sums(model, if1["cfg"], *if1["batch"])
        with lora.patch(model, adapters, scale=0.5):
            patched, _ = training.if_loss_sums(model, if1["cfg"], *if1["batch"])
        merged, _ = training.if_loss_sums(lora.merge(model, adapters, scale=0.5), if1["cfg"],
                                          *if1["batch"])
    assert abs(patched.item() - base.item()) > 1e-4
    np.testing.assert_allclose(patched.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(merged.item(), patched.item(), rtol=1e-5)
    extra = {"decoder": {"layers": [{}, {}, {"fc1": jad["decoder"]["layers"][0]["fc1"]}]}}
    with pytest.raises(KeyError, match="no linear"):
        from_jax.lora_from_jax(extra, model)


# -- adafactor ---------------------------------------------------------------


@pytest.mark.parametrize("weight_decay,clip", [(0.01, None), (0.0, None), (0.01, 1.0)],
                         ids=["decay", "no-decay", "clip"])
def test_adafactor_matches_optax(weight_decay, clip):
    """3 steps of make_optimizer(factored=True) against optax.adafactor: JAX's
    stacked (2, in, out) gradients to optax, the same gradients per layer to
    the port. At width 128 the linears factor (their row and column
    statistics per layer) and the embedding, biases and LayerNorms do not;
    the block RMS values are taken over both layers of each leaf."""
    jalpha = JaxAlphabet.from_architecture("ESM-1b")
    size = dict(num_layers=2, embed_dim=128, attention_heads=4)
    jcfg = jesm2.ESM2Config.from_alphabet(jalpha, **size)
    params = jesm2.init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.RandomState(7)
    jgrads = [jax.tree.map(lambda x: rng.randn(*x.shape).astype(np.float32), params)
              for _ in range(3)]
    kw = dict(weight_decay=weight_decay, warmup_steps=1, total_steps=10, grad_clip_norm=clip,
              factored=True)
    tx = jtraining.make_optimizer(1e-2, **kw)
    jp, opt = params, tx.init(params)
    for g in jgrads:
        updates, opt = tx.update(g, opt, jp)
        jp = optax.apply_updates(jp, updates)

    cfg = tesm2.ESM2Config.from_alphabet(Alphabet.from_architecture("ESM-1b"), **size)
    model = tesm2.ESM2(cfg, device="cpu")
    model.load_state_dict(from_jax.esm2_state_dict_from_jax(_np_tree(params), jcfg), strict=True)
    ttx = training.make_optimizer(1e-2, **kw)
    state = training.init_state(model, ttx)
    opt_state = state.opt_state
    assert "layers.0.fc1.weight" in opt_state.v_row and "layers.1.fc2.weight" in opt_state.v_col
    assert "embed_tokens.weight" in opt_state.v and "layers.0.fc1.bias" in opt_state.v
    assert opt_state.v_row["layers.0.fc1.weight"].shape == (128,)   # esm_tpu's (in, out) rows
    assert opt_state.v_col["layers.0.fc1.weight"].shape == (512,)
    names = dict(model.named_parameters())
    for g in jgrads:
        named = from_jax.esm2_state_dict_from_jax(_np_tree(g), jcfg)
        for n, p in names.items():
            p.grad = named[n].clone()
        ttx.update(model, opt_state)
    assert opt_state.count == 3
    want = from_jax.esm2_state_dict_from_jax(_np_tree(jp), jcfg)
    for n, p in names.items():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), atol=1e-6, err_msg=n)
    n_params = sum(p.numel() for p in names.values())
    assert state.opt_state_bytes() < 0.2 * 4 * n_params  # far below AdamW's 8 bytes a parameter
