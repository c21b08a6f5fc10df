"""Port of esm_tpu/apps/ppl/optimize.py, copied: the acceptance draw comes
from ``np.random``'s global state, as in esm_tpu, so a seeded run repeats
esm_tpu's annealing trace step for step given the same folds.

Simulated-annealing Metropolis-Hastings optimizer for program trees.

The acceptance rule is the reference's contract (examples/
protein-programming-language/language/optimize.py: minimize, geometric
temperature decay, symmetric-proposal approximation, always-accept first
step); the machinery around it is this repo's: a propose/evaluate helper,
immutable state updates via dataclasses.replace, an energy trace and accept
counter for convergence diagnostics, and plain logging instead of the
reference's rich.Live table.
"""

from __future__ import annotations

import dataclasses
import logging
from copy import deepcopy
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from .folding import FoldingCallback
from .program import ProgramNode

logger = logging.getLogger(__name__)

# (term name, weight, value) triples as produced by get_energy_term_functions
TermValues = List[Tuple[str, float, float]]


@dataclass
class MetropolisHastingsState:
    program: ProgramNode
    temperature: float
    annealing_rate: float
    num_steps: int = 0
    num_accepts: int = 0
    current_energy: Optional[float] = None
    current_energy_term_fn_values: Optional[TermValues] = None
    best_energy: Optional[float] = None
    best_energy_term_fn_values: Optional[TermValues] = None
    best_program: Optional[ProgramNode] = None
    best_sequence: Optional[str] = None
    energy_trace: List[float] = field(default_factory=list)

    @property
    def accept_rate(self) -> float:
        return self.num_accepts / max(self.num_steps, 1)


def _propose(
    program: ProgramNode, folding_callback: FoldingCallback
) -> Tuple[ProgramNode, str, TermValues, float]:
    """One mutation proposal, folded and scored: returns the mutated copy,
    its sequence, the per-term (name, weight, value) triples and the total
    weighted energy."""
    candidate = deepcopy(program)
    candidate.mutate()
    sequence, residue_indices = candidate.get_sequence_and_set_residue_index_ranges()
    folding_output = folding_callback.fold(sequence, residue_indices)
    term_values = [
        (name, weight, fn(folding_output))
        for name, weight, fn in candidate.get_energy_term_functions()
    ]
    energy = float(sum(weight * value for _, weight, value in term_values))
    return candidate, sequence, term_values, energy


def metropolis_hastings_step(
    state: MetropolisHastingsState,
    folding_callback: FoldingCallback,
    verbose: bool = False,
) -> MetropolisHastingsState:
    temperature = state.temperature * state.annealing_rate
    candidate, sequence, term_values, energy = _propose(
        state.program, folding_callback
    )

    if state.current_energy is None:
        accept = True  # nothing to compare against: seed the chain
    else:
        # minimizing with symmetric proposals: accept prob min(1, e^(-dE/T));
        # the exponent is clamped so a large downhill step cannot overflow
        downhill = state.current_energy - energy
        accept = np.random.uniform() < min(
            1.0, float(np.exp(min(downhill / temperature, 50.0)))
        )
    if accept and verbose:
        logger.info("Accepted %s with energy %.3f", sequence, energy)

    updates = dict(
        temperature=temperature,
        num_steps=state.num_steps + 1,
        num_accepts=state.num_accepts + int(accept),
        energy_trace=state.energy_trace + [energy],
    )
    if accept:
        updates.update(
            program=candidate,
            current_energy=energy,
            current_energy_term_fn_values=term_values,
        )
    if state.best_energy is None or energy < state.best_energy:
        updates.update(
            best_energy=energy,
            best_energy_term_fn_values=term_values,
            best_program=deepcopy(candidate),
            best_sequence=sequence,
        )
    return dataclasses.replace(state, **updates)


def run_simulated_annealing(
    program: ProgramNode,
    folding_callback: FoldingCallback,
    initial_temperature: float = 1.0,
    annealing_rate: float = 0.97,
    total_num_steps: int = 10_000,
    display_progress: bool = True,
    progress_every: int = 50,
) -> MetropolisHastingsState:
    """(reference optimize.py:96-158)"""
    state = MetropolisHastingsState(
        program=program,
        temperature=initial_temperature,
        annealing_rate=annealing_rate,
    )
    for step in range(total_num_steps):
        state = metropolis_hastings_step(state, folding_callback)
        if display_progress and (step % progress_every == 0):
            logger.info(
                "step %d: T=%.4f accept=%.0f%% E_cur=%s E_best=%s",
                step, state.temperature, 100 * state.accept_rate,
                state.current_energy, state.best_energy,
            )
    return state
