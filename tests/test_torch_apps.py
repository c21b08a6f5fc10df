"""The port's design apps (esm_tpu_torch.apps.lm_design and .schedules)
against esm_tpu's on the CPU, on the same weights (a 2 x 32 ESM-2 with 2
heads, esm_tpu's seeded init carried across by esm2_state_dict_from_jax).

The chains hold against esm_tpu's jitted scans by replaying esm_tpu's own
draws: ``JaxDraws`` splits the key as each esm_tpu loop does (4 ways an MH
step, 3 ways a Gibbs step, 2 then 4 ways a free-generation round) and hands
the port's loops the same positions, proposals, uniforms and Gumbel noise.

Tolerances: energies, log-probabilities, KLs and projection logits 1e-4
absolute and relative (the TOL of tests/test_torch_esm2.py: fp32 on both
sides, summation order and transcendentals); tokens, accept flags and
sampled bins exactly; schedules 1e-5 relative against esm_tpu's (which
raises gamma to the step's power in fp32: 1.07e-6 off the float64 value by
step 40 of ExponentialLR(gamma=0.9)) and 1e-5 absolute against
torch.optim.lr_scheduler.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esm_tpu.apps import lm_design as jld
from esm_tpu.apps import schedules as jsched
from esm_tpu.data import Alphabet as JaxAlphabet
from esm_tpu.models import esm2 as jesm2
from esm_tpu_torch.apps import lm_design as ld
from esm_tpu_torch.apps import schedules as sched
from esm_tpu_torch.data import Alphabet
from esm_tpu_torch.io.export import save_esm2
from esm_tpu_torch.io.from_jax import distogram_projection_from_jax, esm2_state_dict_from_jax
from esm_tpu_torch.models import esm2

TOL = dict(atol=1e-4, rtol=1e-4)
SIZE = dict(num_layers=2, embed_dim=32, attention_heads=2)
SEED_SEQ = "KALTARQQEVFDLIRD"


@pytest.fixture(scope="module")
def lm():
    jalpha = JaxAlphabet.from_architecture("ESM-1b")
    jcfg = jesm2.ESM2Config.from_alphabet(jalpha, **SIZE)
    params = jesm2.init(jax.random.PRNGKey(0), jcfg)
    alphabet = Alphabet.from_architecture("ESM-1b")
    cfg = esm2.ESM2Config.from_alphabet(alphabet, **SIZE)
    model = esm2.ESM2(cfg, device="cpu")
    model.load_state_dict(esm2_state_dict_from_jax(jax.tree.map(np.asarray, params), jcfg),
                          strict=True)
    return jcfg, params, cfg, model, alphabet


def _tokens(alphabet, seq=SEED_SEQ, batch=2):
    return alphabet.get_batch_converter()([(f"s{i}", seq) for i in range(batch)])[2]


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t.to(dtype) if dtype else t


class JaxDraws:
    """esm_tpu's draws, from its key splits, for the port's chain loops."""

    def __init__(self, key):
        self.rng = key

    def mh(self, b, L):
        self.rng, r_pos, r_prop, r_acc = jax.random.split(self.rng, 4)
        pos = 1 + jax.random.randint(r_pos, (b,), 0, L)
        prop = jld.AA_OFFSET + jax.random.randint(r_prop, (b,), 0, jld.NUM_STANDARD_AA)
        u = jax.random.uniform(r_acc, (b,), minval=1e-20)
        return _t(pos, torch.int64), _t(prop, torch.int64), _t(u)

    def gibbs(self, b, L, vocab):
        self.rng, r_pos, r_draw = jax.random.split(self.rng, 3)
        pos = 1 + jax.random.randint(r_pos, (b,), 0, L)
        return _t(pos, torch.int64), _t(jax.random.gumbel(r_draw, (b, vocab)))

    def targets(self, shapes):
        self.rng, r_samp = jax.random.split(self.rng)
        keys = jax.random.split(r_samp, 4)
        return {name: _t(jax.random.gumbel(k, shapes[name]))
                for k, name in zip(keys, ld.TARGET_NAMES)}


# -- schedules ---------------------------------------------------------------------------

SCHEDULES = {
    "Constant": (lambda m: m.ConstantSchedule(0.7), None, None),
    "StepLR": (lambda m: m.StepLR(8.0, step_size=4, gamma=0.5), "StepLR",
               dict(step_size=4, gamma=0.5)),
    "MultiStepLR": (lambda m: m.MultiStepLR(2.0, milestones=(3, 7, 15), gamma=0.3),
                    "MultiStepLR", dict(milestones=[3, 7, 15], gamma=0.3)),
    "ExponentialLR": (lambda m: m.ExponentialLR(1.5, gamma=0.9), "ExponentialLR",
                      dict(gamma=0.9)),
    "LinearLR": (lambda m: m.LinearLR(3.0, start_factor=0.25, end_factor=1.0, total_iters=10),
                 "LinearLR", dict(start_factor=0.25, end_factor=1.0, total_iters=10)),
    "CosineAnnealingLR": (lambda m: m.CosineAnnealingLR(5.0, T_max=20, eta_min=0.5),
                          "CosineAnnealingLR", dict(T_max=20, eta_min=0.5)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_esm_tpu(name):
    make = SCHEDULES[name][0]
    got, want = make(sched), make(jsched)
    steps = range(40)
    np.testing.assert_allclose([got(s) for s in steps], [float(want(s)) for s in steps],
                               rtol=1e-5, atol=0)
    values = sched.schedule_values(got, steps, "cpu")
    assert values.dtype == torch.float32 and values.shape == (40,)
    np.testing.assert_allclose(values.numpy(), np.asarray(jld._schedule_values(want, steps)),
                               rtol=1e-5, atol=0)


@pytest.mark.parametrize("name", sorted(n for n in SCHEDULES if SCHEDULES[n][1]))
def test_schedules_match_torch_lr_scheduler(name):
    make, torch_name, kw = SCHEDULES[name]
    s = make(sched)
    dummy = torch.tensor([0.0], requires_grad=True)
    opt = torch.optim.SGD([dummy], lr=s.initial)
    ref = getattr(torch.optim.lr_scheduler, torch_name)(opt, **kw)
    for step in range(30):
        assert abs(s(step) - ref.get_last_lr()[0]) < 1e-5, (torch_name, step)
        opt.step()
        ref.step()


def test_to_schedule_from_config():
    s = sched.to_schedule({"scheduler": "StepLR", "initial": 8, "step_size": 10000,
                           "gamma": 0.5})
    assert isinstance(s, sched.StepLR) and s(0) == 8.0 and s(10000) == 4.0
    assert sched.to_schedule(0.7)(123) == pytest.approx(0.7)
    assert sched.schedule_values(0.7, range(3)).tolist() == pytest.approx([0.7] * 3)
    with pytest.raises(ValueError):
        sched.to_schedule({"scheduler": "Bogus", "initial": 1.0})


# -- energies ----------------------------------------------------------------------------


def test_masked_lm_logprobs_matches_jax(lm):
    jcfg, params, cfg, model, alphabet = lm
    toks = _tokens(alphabet, batch=3)
    pos = np.array([1, 7, 16])
    want = jld._masked_lm_logprobs(params, jcfg, jnp.asarray(toks.numpy()), jnp.asarray(pos))
    with torch.no_grad():
        got = ld.masked_lm_logprobs(model, cfg, toks, torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _ngram_stats(seed):
    rng = np.random.RandomState(seed)
    return {order: {tuple(rng.randint(0, 20, order)): float(rng.rand()) for _ in range(40)}
            for order in (1, 2, 3)}


@pytest.mark.parametrize("order", [1, 2, 3])
def test_ngram_kl_matches_jax(order):
    stats = _ngram_stats(order)
    jt, tt = jld._ngram_energy_tables(stats), ld.ngram_energy_tables(stats)
    np.testing.assert_allclose(tt[order].numpy(), np.asarray(jt[order]), **TOL)
    seqs = np.random.RandomState(9).randint(0, 20, (3, 17))
    seqs[0, :6] = [1, 2, 1, 2, 1, 2]  # repeated grams
    want = [float(jld.ngram_kl(jnp.asarray(s), jt[order], order)) for s in seqs]
    got = ld.ngram_kl(torch.from_numpy(seqs), tt[order], order)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    one = ld.ngram_kl(torch.from_numpy(seqs[0]), tt[order], order)
    assert one.shape == () and float(one) == pytest.approx(want[0], rel=1e-4, abs=1e-4)


def test_load_ngram_stats_pickles_matches_jax(tmp_path):
    rng = np.random.RandomState(3)
    letters = list("LAGVSERTIDPKQNFYMHWC")
    paths = {}
    for order in (1, 2, 3):
        raw = {tuple(rng.choice(letters, order)): int(rng.randint(1, 1000)) for _ in range(60)}
        raw[("X",) * order] = 5  # a non-standard gram, dropped by both
        paths[order] = str(tmp_path / f"ngram_{order}.pkl")
        with open(paths[order], "wb") as f:
            pickle.dump(raw, f)
    got, want = ld.load_ngram_stats_pickles(paths), jld.load_ngram_stats_pickles(paths)
    assert got.keys() == want.keys()
    for order in got:
        assert got[order].keys() == want[order].keys()
        np.testing.assert_allclose([got[order][k] for k in want[order]],
                                   list(want[order].values()), rtol=1e-12)


def test_total_energy_with_ngrams_matches_jax(lm):
    jcfg, params, cfg, model, alphabet = lm
    stats = _ngram_stats(4)
    dcfg = ld.DesignConfig(lm_weight=0.7, ngram_weight=0.3)
    jdcfg = jld.DesignConfig(lm_weight=0.7, ngram_weight=0.3)
    toks = _tokens(alphabet, batch=3)
    pos = np.array([2, 9, 15])
    want = jld._total_energy(params, jcfg, jld._ngram_energy_tables(stats), jdcfg,
                             jnp.asarray(toks.numpy()), jnp.asarray(pos))
    with torch.no_grad():
        got = ld.total_energy(model, cfg, ld.ngram_energy_tables(stats), dcfg, toks,
                              torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# -- the chains against esm_tpu's, on esm_tpu's draws --------------------------------------

CHAINS = {
    "constant T": (dict(num_iter=30, temperature=1.0, seed=5), None),
    "StepLR, n-grams": (dict(num_iter=30, temperature={"scheduler": "StepLR", "initial": 2.0,
                                                       "step_size": 10, "gamma": 0.5},
                             lm_weight=1.0, ngram_weight=0.5, seed=6), 4),
}


@pytest.mark.parametrize("case", sorted(CHAINS))
def test_mh_chain_replays_esm_tpu(lm, case):
    """30 steps of esm_tpu's _run_chain, its draws injected into the port's
    mh_step (and into run_chain): tokens and accept flags equal at every
    step, energies within TOL."""
    jcfg, params, cfg, model, alphabet = lm
    kw, ngram_seed = CHAINS[case]
    kw = dict(kw)
    temp_spec = kw.pop("temperature")
    stats = _ngram_stats(ngram_seed) if ngram_seed else None
    jtemp = jsched.to_schedule(temp_spec)
    toks = _tokens(alphabet)
    jtables = jld._ngram_energy_tables(stats) if stats else None
    want_tokens, want_e, want_acc = jld._run_chain(
        params, jcfg, jtables, jld.DesignConfig(temperature=jtemp, **kw),
        jnp.asarray(toks.numpy()), jax.random.PRNGKey(kw["seed"]))
    want_e, want_acc = np.array(want_e), np.array(want_acc)

    dcfg = ld.DesignConfig(temperature=sched.to_schedule(temp_spec), **kw)
    tables = ld.ngram_energy_tables(stats) if stats else None
    temps = sched.schedule_values(dcfg.temperature, range(dcfg.num_iter))
    draws = JaxDraws(jax.random.PRNGKey(kw["seed"]))
    b, L = toks.shape[0], toks.shape[1] - 2
    tokens, jax_tokens, margin = toks, toks.clone(), np.inf
    with torch.no_grad():
        for it in range(dcfg.num_iter):
            pos, prop, u = draws.mh(b, L)
            tokens, e_cur, accept = ld.mh_step(model, cfg, tables, dcfg, tokens, pos, prop, u,
                                               temps[it])
            np.testing.assert_allclose(e_cur.numpy(), want_e[it], **TOL, err_msg=f"step {it}")
            assert accept.numpy().tolist() == want_acc[it].tolist(), f"step {it}"
            # esm_tpu's state after step it, from its accept flags and the same draws
            proposal = jax_tokens.scatter(1, pos[:, None], prop[:, None])
            jax_tokens = torch.where(torch.from_numpy(want_acc[it])[:, None], proposal, jax_tokens)
            assert torch.equal(tokens, jax_tokens), f"step {it}"
            # how near the accept rule came to a tie
            e_prop = ld.total_energy(model, cfg, tables, dcfg, proposal, pos)
            gap = np.abs(np.log(u.numpy()) - (e_cur - e_prop).numpy() / float(temps[it]))
            margin = min(margin, float(gap.min()))
    assert torch.equal(tokens, _t(want_tokens))
    print(f"{case}: smallest |log u - log a| over the chain {margin:.3e}")

    got_tokens, got_e, got_acc = ld.run_chain(model, cfg, tables, dcfg, toks,
                                              JaxDraws(jax.random.PRNGKey(kw["seed"])))
    assert torch.equal(got_tokens, tokens)
    np.testing.assert_allclose(got_e.numpy(), want_e, **TOL)
    assert np.array_equal(got_acc.numpy(), want_acc)


def test_gibbs_replays_esm_tpu(lm):
    jcfg, params, cfg, model, alphabet = lm
    toks = _tokens(alphabet, "KALTARQ", batch=3)
    temp = {"scheduler": "LinearLR", "initial": 2.0, "total_iters": 20}
    want = jld.gibbs_free_generation(params, jcfg, jnp.asarray(toks.numpy()),
                                     jax.random.PRNGKey(2), 30, temperature=temp)
    got = ld.gibbs_free_generation(model, cfg, toks, 30, temperature=temp,
                                   draws=JaxDraws(jax.random.PRNGKey(2)))
    assert torch.equal(got, _t(want))
    designed = got[:, 1:-1]
    assert ((designed >= 4) & (designed < 24)).all()


def _projection(cfg):
    nch = cfg.num_layers * cfg.attention_heads
    bins = jld.DISTOGRAM_BINS
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    n1, n2 = bins["N_BINS"] + bins["OMEGA_BINS"], bins["THETA_BINS"] + bins["PHI_BINS"]
    rng = np.random.RandomState(7)
    return {
        "conv1": {"kernel": 0.5 * jax.random.normal(k1, (nch, n1)),
                  "bias": jnp.asarray(0.1 * rng.randn(n1).astype(np.float32))},
        "conv2": {"kernel": 0.5 * jax.random.normal(k2, (nch, n2)),
                  "bias": jnp.asarray(0.1 * rng.randn(n2).astype(np.float32))},
    }


@pytest.mark.parametrize("route", ["from_jax", "conv2d_state_dict"])
def test_distogram_projection_matches_jax(lm, route):
    """The projection's four logit maps and the cross-entropy against esm_tpu's,
    the weights carried across by distogram_projection_from_jax or loaded from
    a torch Conv2d state dict (esm_tpu reading the same one)."""
    jcfg, params, cfg, model, alphabet = lm
    jproj = _projection(cfg)
    sd = distogram_projection_from_jax(jax.tree.map(np.asarray, jproj))
    assert sd["conv1.weight"].shape == (36, 4, 1, 1) and sd["conv2.weight"].shape == (26, 4, 1, 1)
    if route == "from_jax":
        proj = ld.DistogramProjection(4)
        proj.load_state_dict(sd, strict=True)
    else:
        convs = {n: torch.nn.Conv2d(4, sd[f"{n}.weight"].shape[0], 1) for n in ("conv1", "conv2")}
        torch_sd = {f"{n}.{k}": v for n, c in convs.items() for k, v in c.state_dict().items()}
        proj = ld.convert_distogram_projection(torch_sd)
        jproj = jld.convert_distogram_projection(torch_sd)
    toks = _tokens(alphabet, "KALTARQQEVFD", batch=2)
    want = jld.distogram_projection_apply(jproj, params, jcfg, jnp.asarray(toks.numpy()))
    with torch.no_grad():
        got = ld.distogram_projection_apply(proj, model, cfg, toks)
    assert sorted(got) == sorted(want)
    rng = np.random.RandomState(3)
    mask = (rng.rand(2, 12, 12) < 0.7).astype(np.float32)
    for name in ld.TARGET_NAMES:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), **TOL)
        target = rng.randint(0, want[name].shape[-1], want[name].shape[:-1])
        for m in (None, mask):
            ce = ld.distogram_cross_entropy(got[name], torch.from_numpy(target),
                                            None if m is None else torch.from_numpy(m))
            jce = jld.distogram_cross_entropy(want[name], jnp.asarray(target),
                                              None if m is None else jnp.asarray(m))
            np.testing.assert_allclose(ce.numpy(), np.asarray(jce), **TOL)


def test_free_generation_replays_esm_tpu(lm):
    """Two rounds of resampled targets and 3 MH steps each, esm_tpu's draws
    injected: the first round's sampled targets, every energy and the final
    tokens."""
    jcfg, params, cfg, model, alphabet = lm
    jproj = _projection(cfg)
    proj = ld.DistogramProjection(4)
    proj.load_state_dict(distogram_projection_from_jax(jax.tree.map(np.asarray, jproj)))
    toks = _tokens(alphabet, "KALTARQQEVFD", batch=2)
    kw = dict(num_iter=6, resample_y_every=3, resample_y_temp=0.8,
              mh_temperature={"scheduler": "ExponentialLR", "initial": 1.0, "gamma": 0.9},
              lm_weight=1.0, struct_weight=0.5)
    want_tokens, want_e = jld.free_generation(params, jcfg, jproj, jnp.asarray(toks.numpy()),
                                              jax.random.PRNGKey(4), **kw)
    got_tokens, got_e = ld.free_generation(model, cfg, proj, toks,
                                           draws=JaxDraws(jax.random.PRNGKey(4)), **kw)
    assert got_e.shape == (2, 3, 2)
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), **TOL)
    assert torch.equal(got_tokens, _t(want_tokens))

    # round 0's targets: esm_tpu's categorical against the port's on its noise
    _, r_samp = jax.random.split(jax.random.PRNGKey(4))
    keys = jax.random.split(r_samp, 4)
    preds = jld.distogram_projection_apply(jproj, params, jcfg, jnp.asarray(toks.numpy()))
    with torch.no_grad():
        tpreds = ld.distogram_projection_apply(proj, model, cfg, toks)
    gumbels = {n: _t(jax.random.gumbel(k, preds[n].shape)) for k, n in zip(keys, ld.TARGET_NAMES)}
    got_t = ld.sample_targets(tpreds, 0.8, gumbels)
    for k, name in zip(keys, ld.TARGET_NAMES):
        want_t = jax.random.categorical(k, preds[name] / 0.8, axis=-1)
        assert np.array_equal(got_t[name].numpy(), np.asarray(want_t)), name


# -- Designer, draws and the example ---------------------------------------------------------


def test_designer_repeats_itself(lm):
    _, _, cfg, model, alphabet = lm
    designer = ld.Designer(model, cfg, alphabet)
    dcfg = ld.DesignConfig(num_iter=12, temperature=0.7, seed=3)
    a = designer.design(SEED_SEQ, dcfg, batch=2)
    b = designer.design(SEED_SEQ, dcfg, batch=2)
    assert a[0] == b[0] and np.array_equal(a[1], b[1]) and a[2] == b[2]
    assert a[1].shape == (12, 2) and np.isfinite(a[1]).all() and 0.0 <= a[2] <= 1.0
    assert all(len(s) == len(SEED_SEQ) and set(s) <= set("LAGVSERTIDPKQNFYMHWC") for s in a[0])
    c = designer.design(SEED_SEQ, ld.DesignConfig(num_iter=12, temperature=0.7, seed=4), batch=2)
    assert not np.array_equal(a[1], c[1])


def test_designer_takes_a_handle(lm):
    """An LMHandle with use_flash routes the masked-LM forward through K1's
    path (its plain version on the CPU): the same chain as the exact path."""
    from esm_tpu_torch.kernels import flash_attention as fa
    from esm_tpu_torch.pretrained import LMHandle

    _, _, cfg, model, alphabet = lm
    handle = LMHandle("esm2", cfg, model, alphabet)
    dcfg = ld.DesignConfig(num_iter=10, seed=1)
    exact = ld.Designer(handle).design(SEED_SEQ, dcfg, batch=2)
    before = fa.flash_attention.launches
    flash = ld.Designer(handle.with_options(use_flash=True)).design(SEED_SEQ, dcfg, batch=2)
    assert fa.flash_attention.launches == before  # no kernel on the CPU
    assert flash[0] == exact[0]
    np.testing.assert_allclose(flash[1], exact[1], **TOL)
    with pytest.raises(TypeError, match="ESM-2"):
        ld.Designer(LMHandle("esm1", cfg, model, alphabet))


def test_draws_follow_esm_tpu_distributions():
    gen = torch.Generator().manual_seed(0)
    pos, prop, u = ld.draw_mh(gen, 20000, 12, "cpu")
    assert pos.min() == 1 and pos.max() == 12 and prop.min() == 4 and prop.max() == 23
    assert u.min() >= 1e-20 and u.max() < 1 and abs(float(u.mean()) - 0.5) < 0.01
    g = ld.draw_gumbel(gen, (200000,), "cpu")
    assert abs(float(g.mean()) - 0.5772) < 0.01  # the Euler-Mascheroni constant
    logits = torch.log(torch.tensor([0.2, 0.5, 0.3]))
    draws = ld.categorical(logits, ld.draw_gumbel(gen, (100000, 3), "cpu"))
    freq = torch.bincount(draws, minlength=3).float() / 100000
    assert torch.allclose(freq, torch.tensor([0.2, 0.5, 0.3]), atol=0.01)


def test_lm_design_example(tmp_path, monkeypatch, capsys):
    from esm_tpu_torch.examples import lm_design_fixedbb

    cfg = esm2.ESM2Config.from_alphabet(Alphabet.from_architecture("ESM-1b"), **SIZE)
    model = esm2.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    save_esm2(model, tmp_path / "esm2_t6_8M_UR50D.pt")
    monkeypatch.setenv("ESM_TPU_CACHE", str(tmp_path))
    args = lm_design_fixedbb.create_parser().parse_args(
        ["--model", "esm2_t6_8M_UR50D", "--num-iter", "8", "--batch", "2",
         "--seed-seq", SEED_SEQ])
    seqs, energies, acc = lm_design_fixedbb.run(args, device="cpu")
    out = capsys.readouterr().out
    assert f"acceptance rate: {acc:.2%}" in out and f"design 1: " in out
    assert energies.shape == (8, 2) and np.isfinite(energies).all()
    want = ld.Designer(model, cfg, Alphabet.from_architecture("ESM-1b")).design(
        SEED_SEQ, ld.DesignConfig(num_iter=8, temperature=0.1), batch=2)
    assert seqs == want[0] and np.array_equal(energies, want[1])
