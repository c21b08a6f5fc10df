"""LM-driven protein design (MCMC).

Port of esm_tpu/apps/lm_design.py (reference semantics: examples/lm-design/
— Designer with energies
  * masked-LM pseudo-likelihood (utils/lm.py:20-58, lm_design.py:204-283):
    E_LM(x, i) = -log p(x_i | x_\\i) with position i masked, scaled by LM_w/L;
  * n-gram KL to natural sequence statistics (utils/ngram.py:59-73);
  * distogram cross-entropy against a target structure through a linear
    projection of the attention maps (utils/linear_projection.py:85-135);
and the fixed-backbone Metropolis-Hastings loop with single-site uniform
proposals (utils/fixedbb.py:17-56)).

esm_tpu runs each chain as one jitted ``lax.scan``. Eager PyTorch has no
scan, so the chains here are Python loops over step functions that never
read a tensor back to the host: the draws come from a ``torch.Generator``
on the model's device, every step's energies and accept flags go into
preallocated device tensors, the temperatures are a device tensor built
before the loop (``schedules.schedule_values``), and the results are read
back once, after the loop. Current and proposal are scored in one stacked
forward of 2·B rows, as in esm_tpu.

The draws go through a ``draws`` object (:class:`GeneratorDraws` by default)
with the distributions of esm_tpu's: ``pos = 1 + randint(0, L)``, ``prop =
4 + randint(0, 20)``, ``u`` uniform on [1e-20, 1), and Gumbel noise for the
categorical draws, written ``argmax(logits / T + vmask + g)`` as
``jax.random.categorical`` computes them. Another object with the same
methods can replay other draws (esm_tpu's key splits, say) through the same
loops.

The chains run under ``torch.no_grad()``. With ``cfg.use_flash`` the
masked-LM forward runs kernel K1; the distogram projection needs the
attention maps, so its forward takes the exact path.
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..data.alphabet import Alphabet
from ..models import esm2
from ..utils.device import host_to_device
from .schedules import Schedule, schedule_values

# Standard amino acids (design proposal support), in ESM vocab order 4..23
NUM_STANDARD_AA = 20
AA_OFFSET = 4
_UNIFORM_MIN = 1e-20  # the acceptance draw's lower bound, as esm_tpu draws it
TARGET_NAMES = ("logits", "theta_logits", "phi_logits", "omega_logits")


@dataclass(frozen=True)
class DesignConfig:
    num_iter: int = 1000
    # MH acceptance temperature: a float, or an annealing schedule from
    # esm_tpu_torch.apps.schedules (the reference default anneals StepLR
    # initial=8 step_size=10000 gamma=0.5, conf/config.yaml:31-39)
    temperature: "float | Schedule" = 1.0
    lm_weight: float = 1.0
    ngram_weight: float = 0.0
    ngram_orders: Tuple[int, ...] = (1, 2, 3)
    seed: int = 0


# ---------------------------------------------------------------------------
# Draws
# ---------------------------------------------------------------------------


def draw_mh(gen: torch.Generator, b: int, L: int, device) -> Tuple[torch.Tensor, ...]:
    """One MH step's draws for ``b`` chains over ``L`` designable positions:
    (pos (b,) in [1, L], proposed token (b,) in [4, 24), u (b,) on
    [1e-20, 1))."""
    pos = 1 + torch.randint(0, L, (b,), generator=gen, device=device)
    prop = AA_OFFSET + torch.randint(0, NUM_STANDARD_AA, (b,), generator=gen, device=device)
    u = torch.rand((b,), generator=gen, device=device)
    u = (_UNIFORM_MIN + (1.0 - _UNIFORM_MIN) * u).clamp_min(_UNIFORM_MIN)
    return pos, prop, u


def draw_gumbel(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log(U)) with U on [tiny, 1) (the form of
    ``jax.random.gumbel``)."""
    u = torch.rand(shape, generator=gen, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


class GeneratorDraws:
    """The chains' draws from one ``torch.Generator`` on the model's device."""

    def __init__(self, generator: torch.Generator):
        self.gen = generator
        self.device = generator.device

    def mh(self, b: int, L: int):
        """(pos, prop_aa, u) of one MH step."""
        return draw_mh(self.gen, b, L, self.device)

    def gibbs(self, b: int, L: int, vocab: int):
        """(pos, Gumbel noise (b, vocab)) of one Gibbs step."""
        pos = 1 + torch.randint(0, L, (b,), generator=self.gen, device=self.device)
        return pos, draw_gumbel(self.gen, (b, vocab), self.device)

    def targets(self, shapes: Dict[str, Tuple[int, ...]]) -> Dict[str, torch.Tensor]:
        """Gumbel noise for each distogram target, in ``TARGET_NAMES`` order."""
        return {name: draw_gumbel(self.gen, shapes[name], self.device) for name in TARGET_NAMES}


def categorical(logits: torch.Tensor, gumbel: torch.Tensor) -> torch.Tensor:
    """A draw from softmax(logits) along the last axis with the given Gumbel
    noise (``jax.random.categorical`` is the same argmax)."""
    return torch.argmax(gumbel + logits, dim=-1)


# ---------------------------------------------------------------------------
# Energies
# ---------------------------------------------------------------------------


def masked_lm_logprobs(model, cfg: esm2.ESM2Config, tokens: torch.Tensor, pos: torch.Tensor):
    """log p(x | x_\\pos) with position ``pos`` masked in each row, one forward.

    tokens: (B, T) WITH bos/eos; pos: (B,) absolute index into T.
    Returns (B, V) fp32 log-probabilities at the masked position."""
    masked = tokens.scatter(1, pos[:, None], cfg.mask_idx)
    logits = esm2.apply(model, cfg, masked)["logits"]
    at = logits.gather(1, pos[:, None, None].expand(-1, 1, logits.shape[-1]))[:, 0]
    return torch.log_softmax(at, dim=-1)


def ngram_energy_tables(ngram_stats: Dict[int, Dict[tuple, float]], device=None):
    """Dense fp32 log-probability tables per order from {order: {aa_tuple: p}}."""
    tables = {}
    for order, stats in ngram_stats.items():
        t = np.full((NUM_STANDARD_AA,) * order, 1e-5, np.float32)
        for k, v in stats.items():
            t[k] = max(v, 1e-5)
        tables[order] = torch.log(torch.from_numpy(t)).to(device)
    return tables


def ngram_kl(seq_aa: torch.Tensor, log_table: torch.Tensor, order: int) -> torch.Tensor:
    """KL(observed n-gram frequency || natural statistics) of sequences of
    standard-AA ids (0..19), (..., L) -> (...): the dense formulation of
    esm_tpu (utils/ngram.py:59-73). Summed over the distinct grams, p log(p/q)
    equals the mean over positions of log(p_pos / q_pos), p_pos the count of
    the gram at that position over n."""
    L = seq_aa.shape[-1]
    n = L - order + 1
    grams = torch.stack([seq_aa[..., i:i + n] for i in range(order)], dim=-1)  # (..., n, order)
    logq = log_table[tuple(grams.unbind(-1))]                                   # (..., n)
    same = (grams[..., :, None, :] == grams[..., None, :, :]).all(-1)
    counts = same.sum(-1).float()
    return torch.mean(torch.log(counts / n) - logq, dim=-1)


def load_ngram_stats_pickles(paths: Dict[int, str]) -> Dict[int, Dict[tuple, float]]:
    """Read the reference's ngram_stats pickle format ({aa_str_tuple: count})
    and renormalize (utils/ngram.py:16-48)."""
    seq_encode = [
        "L", "A", "G", "V", "S", "E", "R", "T", "I", "D",
        "P", "K", "Q", "N", "F", "Y", "M", "H", "W", "C",
    ]
    out = {}
    for order, path in paths.items():
        with open(path, "rb") as f:
            raw = pickle.load(f)
        idx_dict = {}
        for k, v in raw.items():
            try:
                ids = tuple(seq_encode.index(ki) for ki in k)
            except ValueError:
                continue
            idx_dict[ids] = v
        total = sum(idx_dict.values())
        out[order] = {k: max(v / total, 1e-5) for k, v in idx_dict.items()}
    return out


def total_energy(model, lm_cfg, ngram_tables, cfg: DesignConfig, tokens, pos):
    """Total energy (B,) at single-site mask ``pos``. tokens: (B, T) with bos/eos."""
    logp = masked_lm_logprobs(model, lm_cfg, tokens, pos)
    token_at = tokens.gather(1, pos[:, None])
    lm_nll = -logp.gather(1, token_at)[:, 0]
    L = tokens.shape[1] - 2
    e = cfg.lm_weight * lm_nll / L
    if ngram_tables is not None and cfg.ngram_weight:
        seq_aa = (tokens[:, 1:-1] - AA_OFFSET).clamp(0, NUM_STANDARD_AA - 1)
        for order in cfg.ngram_orders:
            e = e + cfg.ngram_weight * ngram_kl(seq_aa, ngram_tables[order], order)
    return e


def _propose(tokens, pos, prop_aa):
    """(proposal, [tokens; proposal], [pos; pos]): the stacked batch of 2·B rows."""
    proposal = tokens.scatter(1, pos[:, None], prop_aa[:, None].to(tokens.dtype))
    return proposal, torch.cat([tokens, proposal]), torch.cat([pos, pos])


def _accept(tokens, proposal, e, u, temperature):
    """The MH rule on stacked energies e = [e_cur; e_prop]: accept where
    log u < (e_cur - e_prop) / T. Returns (tokens, e_cur, accept)."""
    b = tokens.shape[0]
    e_cur, e_prop = e[:b], e[b:]
    accept = torch.log(u) < (e_cur - e_prop) / temperature
    return torch.where(accept[:, None], proposal, tokens), e_cur, accept


def mh_step(model, lm_cfg, ngram_tables, cfg: DesignConfig, tokens, pos, prop_aa, u,
            temperature):
    """One Metropolis-Hastings step with its draws passed in
    (esm_tpu/apps/lm_design.py:174-201): score current and proposal in one
    forward of 2·B rows, accept where log u < (e_cur - e_prop) / T.
    Returns (tokens, e_cur (B,), accept (B,) bool)."""
    proposal, stacked, pos2 = _propose(tokens, pos, prop_aa)
    e = total_energy(model, lm_cfg, ngram_tables, cfg, stacked, pos2)
    return _accept(tokens, proposal, e, u, temperature)


def _model_device(model) -> torch.device:
    return model.embed_tokens.weight.device


@torch.no_grad()
def run_chain(model, lm_cfg, ngram_tables, cfg: DesignConfig, tokens0: torch.Tensor,
              draws=None):
    """The MH chain of ``cfg.num_iter`` steps from ``tokens0`` (B, T) on the
    model's device (reference utils/fixedbb.py:17-56). ``draws`` defaults to
    :class:`GeneratorDraws` seeded with ``cfg.seed``. Nothing is read back inside the loop.
    Returns (tokens, energies (num_iter, B), accepts (num_iter, B)) on the
    device; energies[t] is the energy of the state entering step t."""
    device = _model_device(model)
    b, t = tokens0.shape
    L = t - 2  # designable positions exclude bos/eos
    n = cfg.num_iter
    if draws is None:
        draws = GeneratorDraws(torch.Generator(device=device).manual_seed(cfg.seed))
    temperatures = schedule_values(cfg.temperature, range(n), device)
    energies = torch.empty((n, b), dtype=torch.float32, device=device)
    accepts = torch.empty((n, b), dtype=torch.bool, device=device)
    tokens = host_to_device(tokens0, device)
    for it in range(n):
        pos, prop_aa, u = draws.mh(b, L)
        tokens, energies[it], accepts[it] = mh_step(
            model, lm_cfg, ngram_tables, cfg, tokens, pos, prop_aa, u, temperatures[it])
    return tokens, energies, accepts


class Designer:
    """Fixed-backbone / free sequence design via MH over LM energy.

    ``lm`` is an ESM-2 ``LMHandle`` (its config's execution options apply:
    ``handle.with_options(compute_dtype=torch.bfloat16, use_flash=True)``
    runs K1), or an ``ESM2`` module with ``lm_cfg`` and ``alphabet``."""

    def __init__(self, lm, lm_cfg: Optional[esm2.ESM2Config] = None,
                 alphabet: Optional[Alphabet] = None,
                 ngram_stats: Optional[Dict[int, Dict[tuple, float]]] = None):
        if lm_cfg is None:  # a handle
            if getattr(lm, "kind", None) != "esm2":
                raise TypeError("Designer needs an ESM-2 handle, or a model and its config")
            lm, lm_cfg, alphabet = lm.model, lm.cfg, alphabet or lm.alphabet
        self.model = lm
        self.cfg = lm_cfg
        self.alphabet = alphabet
        self.device = _model_device(lm)
        self.ngram_tables = (
            ngram_energy_tables(ngram_stats, self.device) if ngram_stats else None
        )

    def run(self, seed_seq: str, cfg: DesignConfig = DesignConfig(), batch: int = 1):
        """The chain of :meth:`design` with nothing read back: (tokens,
        energies, accepts) on the device (see :func:`run_chain`)."""
        _, _, toks = self.alphabet.get_batch_converter()(
            [(f"seed{i}", seed_seq) for i in range(batch)]
        )
        return run_chain(self.model, self.cfg, self.ngram_tables, cfg, toks)

    def design(self, seed_seq: str, cfg: DesignConfig = DesignConfig(),
               batch: int = 1) -> Tuple[list, np.ndarray, float]:
        """Run the MH chain from a seed sequence. Returns (sequences, energy
        trace (num_iter, B), acceptance rate), read back once at the end."""
        tokens, energies, accepts = self.run(seed_seq, cfg, batch)
        return (sequences(self.alphabet, tokens), energies.cpu().numpy(),
                accepts.float().mean().item())


# ---------------------------------------------------------------------------
# Structure energy: linear projection distogram model
# (reference examples/lm-design/utils/linear_projection.py:85-135)
# ---------------------------------------------------------------------------

DISTOGRAM_BINS = dict(
    N_BINS=18, CUTOFF_BIN=5, MIN_DIST=2.5, MAX_DIST=20, CONTACT_DIST=8,
    THETA_BINS=18, PHI_BINS=8, OMEGA_BINS=18, TORSION_BINS=50,
)


class DistogramProjection(nn.Module):
    """1x1 convolutions over the (layers * heads)-channel attention stack:
    ``conv1`` (dist + omega bins) reads the symmetrized maps, ``conv2``
    (theta + phi bins) the asymmetric ones. Its state dict is the released
    checkpoint's (conv1/conv2 weight (out, in, 1, 1) and bias)."""

    def __init__(self, in_channels: int, device=None):
        super().__init__()
        bins = DISTOGRAM_BINS
        self.conv1 = nn.Conv2d(in_channels, bins["N_BINS"] + bins["OMEGA_BINS"], 1,
                               device=device)
        self.conv2 = nn.Conv2d(in_channels, bins["THETA_BINS"] + bins["PHI_BINS"], 1,
                               device=device)


def distogram_projection_apply(proj: DistogramProjection, model, lm_cfg, tokens):
    """Distance/angle bin logits from the LM's attention maps (the exact
    path: K1 returns no maps). Returns {"logits", "omega_logits",
    "theta_logits", "phi_logits"} of (B, L', L', bins), bos/eos stripped."""
    attn = esm2.apply(model, lm_cfg, tokens, need_head_weights=True)["attentions"]
    b, nl, nh, t, _ = attn.shape                         # (B, layers, H, T, T)
    attn = attn.reshape(b, nl * nh, t, t)[:, :, 1:-1, 1:-1]
    attn_sym = attn + attn.transpose(-1, -2)
    out1 = proj.conv1(attn_sym).permute(0, 2, 3, 1)
    out2 = proj.conv2(attn).permute(0, 2, 3, 1)
    nb, nth = DISTOGRAM_BINS["N_BINS"], DISTOGRAM_BINS["THETA_BINS"]
    return {
        "logits": out1[..., :nb],
        "omega_logits": out1[..., nb:],
        "theta_logits": out2[..., :nth],
        "phi_logits": out2[..., nth:],
    }


def convert_distogram_projection(sd, device=None) -> DistogramProjection:
    """A :class:`DistogramProjection` holding a torch Conv2d state dict (the
    released ``linear_projection`` checkpoint's conv1/conv2 weights)."""
    proj = DistogramProjection(sd["conv1.weight"].shape[1], device=device)
    proj.load_state_dict({k: torch.as_tensor(sd[k]) for k in proj.state_dict()})
    return proj


def distogram_cross_entropy(logits, target_bins, mask=None):
    """Distogram CCE energy (B,) against a target binning (lm_design.py:240-283)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, target_bins[..., None].long())[..., 0]
    if mask is not None:
        return (nll * mask).sum((-1, -2)) / mask.sum((-1, -2)).clamp_min(1.0)
    return nll.mean((-1, -2))


def sample_targets(preds: Dict[str, torch.Tensor], temperature, gumbels):
    """A target structure drawn from the projection's bins at ``temperature``
    (one categorical per pair and target, with the given Gumbel noise)."""
    return {name: categorical(preds[name] / temperature, gumbels[name])
            for name in TARGET_NAMES}


def struct_energy(proj, model, lm_cfg, tokens, targets):
    """Mean distogram cross-entropy (B,) of ``tokens``' projection against
    ``targets`` over the four targets."""
    preds = distogram_projection_apply(proj, model, lm_cfg, tokens)
    e = 0.0
    for name in TARGET_NAMES:
        e = e + distogram_cross_entropy(preds[name], targets[name])
    return e / 4.0


def free_generation_mh_step(model, lm_cfg, proj, tokens, targets, pos, prop_aa, u,
                            temperature, lm_weight: float = 1.0, struct_weight: float = 1.0):
    """One MH step of the free-generation loop: masked-LM pseudo-likelihood
    (K1 when ``lm_cfg.use_flash``) plus the distogram cross-entropy against
    ``targets`` (the exact path), current and proposal stacked.
    Returns (tokens, e_cur (B,), accept (B,))."""
    L = tokens.shape[1] - 2
    proposal, stacked, pos2 = _propose(tokens, pos, prop_aa)
    logp = masked_lm_logprobs(model, lm_cfg, stacked, pos2)
    lm_nll = -logp.gather(1, stacked.gather(1, pos2[:, None]))[:, 0]
    targets2 = {k: torch.cat([v, v]) for k, v in targets.items()}
    e = lm_weight * lm_nll / L + struct_weight * struct_energy(proj, model, lm_cfg, stacked,
                                                               targets2)
    return _accept(tokens, proposal, e, u, temperature)


@torch.no_grad()
def free_generation(model, lm_cfg, proj, tokens0, *, num_iter: int, resample_y_every: int,
                    resample_y_temp: "float | Schedule" = 1.0,
                    mh_temperature: "float | Schedule" = 1.0, lm_weight: float = 1.0,
                    struct_weight: float = 1.0, seed: int = 0, draws=None):
    """Joint sequence/structure hallucination — the full free-generation loop
    (reference examples/lm-design/utils/free_generation.py:22-73): every
    ``resample_y_every`` steps, run the distogram projection on the current
    sequence and sample a target structure at ``resample_y_temp``; then run
    MH sequence steps whose energy is the masked-LM pseudo-likelihood plus
    the distogram cross-entropy against that target. Schedules advance with
    the global iteration index. Returns (tokens, energy trace (rounds,
    resample_y_every, B)) on the device."""
    device = _model_device(model)
    b, t = tokens0.shape
    L = t - 2
    rounds = num_iter // resample_y_every
    if draws is None:
        draws = GeneratorDraws(torch.Generator(device=device).manual_seed(seed))
    mh_temps = schedule_values(mh_temperature, range(num_iter), device)
    resample_temps = schedule_values(
        resample_y_temp, [r * resample_y_every for r in range(rounds)], device)
    energies = torch.empty((rounds, resample_y_every, b), dtype=torch.float32, device=device)
    tokens = host_to_device(tokens0, device)
    for r in range(rounds):
        preds = distogram_projection_apply(proj, model, lm_cfg, tokens)
        gumbels = draws.targets({name: tuple(preds[name].shape) for name in TARGET_NAMES})
        targets = sample_targets(preds, resample_temps[r], gumbels)
        for k in range(resample_y_every):
            pos, prop_aa, u = draws.mh(b, L)
            tokens, energies[r, k], _ = free_generation_mh_step(
                model, lm_cfg, proj, tokens, targets, pos, prop_aa, u,
                mh_temps[r * resample_y_every + k], lm_weight, struct_weight)
    return tokens, energies


def gibbs_step(model, lm_cfg, tokens, pos, gumbel, temperature):
    """One Gibbs step: resample position ``pos`` of each row from the
    masked-LM conditional at ``temperature``, restricted to the 20 standard
    residues, with the given Gumbel noise (B, V)."""
    logp = masked_lm_logprobs(model, lm_cfg, tokens, pos)
    vmask = torch.full((logp.shape[-1],), float("-inf"), device=logp.device)
    vmask[AA_OFFSET:AA_OFFSET + NUM_STANDARD_AA] = 0.0
    draw = categorical(logp / temperature + vmask, gumbel)
    return tokens.scatter(1, pos[:, None], draw[:, None].to(tokens.dtype))


@torch.no_grad()
def gibbs_free_generation(model, lm_cfg, tokens0, num_steps: int,
                          temperature: "float | Schedule" = 1.0, seed: int = 0, draws=None):
    """Free sequence generation by Gibbs sampling from the masked-LM
    conditionals (the sequence half of the reference's free_generation loop,
    examples/lm-design/utils/free_generation.py:22-73). Returns the tokens
    on the device."""
    device = _model_device(model)
    b, t = tokens0.shape
    L = t - 2
    if draws is None:
        draws = GeneratorDraws(torch.Generator(device=device).manual_seed(seed))
    temps = schedule_values(temperature, range(num_steps), device)
    tokens = host_to_device(tokens0, device)
    for it in range(num_steps):
        pos, gumbel = draws.gibbs(b, L, lm_cfg.alphabet_size)
        tokens = gibbs_step(model, lm_cfg, tokens, pos, gumbel, temps[it])
    return tokens


def sequences(alphabet: Alphabet, tokens: torch.Tensor) -> Sequence[str]:
    """The designed residues of each row of (B, T) tokens (bos/eos dropped)."""
    return ["".join(alphabet.get_tok(int(a)) for a in row[1:-1]) for row in tokens.tolist()]
