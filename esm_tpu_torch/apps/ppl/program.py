"""Port of esm_tpu/apps/ppl/program.py, copied (host side, numpy).

Program tree for compositional protein design.

The DSL surface (node fields, traversal order, residue-index assignment with
the +1000 multimer chain skip, term naming, candidate-weighted mutation) is
the reference's contract — examples/protein-programming-language/language/
program.py — and must match it; the implementation below is restructured
around a single leaf walk: leaves get contiguous index blocks in
depth-first order, interior ranges fall out as [first leaf start, last leaf
end), and mutation picks a leaf directly (each level of the reference's
recursive candidate-weighted descent is proportional to subtree candidate
counts, so the induced leaf distribution is exactly candidate-proportional).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np

from .sequence import SequenceSegmentFactory

MULTIMER_RESIDUE_INDEX_SKIP_LENGTH: int = 1000


class ProgramNode:
    def __init__(
        self,
        children: Optional[List["ProgramNode"]] = None,
        sequence_segment: Optional[SequenceSegmentFactory] = None,
        children_are_different_chains: bool = False,
        energy_function_terms: Optional[List] = None,
        energy_function_weights: Optional[List[float]] = None,
    ) -> None:
        self.children = children
        self.sequence_segment = sequence_segment
        self.children_are_different_chains = children_are_different_chains
        self.energy_function_terms = energy_function_terms or []
        self.energy_function_weights = energy_function_weights or [
            1.0 for _ in self.energy_function_terms
        ]
        assert len(self.energy_function_terms) == len(self.energy_function_weights)
        self.residue_index_range: Optional[Tuple[int, int]] = None

    def is_leaf_node(self) -> bool:
        return self.children is None

    def get_children(self):
        return self.children

    def _leaves(self) -> Iterator["ProgramNode"]:
        """Leaves in depth-first (sequence) order."""
        if self.is_leaf_node():
            yield self
        else:
            for child in self.children:
                yield from child._leaves()

    def get_sequence_and_set_residue_index_ranges(
        self, residue_index_offset: int = 1
    ) -> Tuple[str, List[int]]:
        """Concatenated sequence + per-residue indices; stamps every node's
        ``residue_index_range``. Chain breaks (``children_are_different_
        chains``) skip the index forward by 1000 between that node's
        children — the fold callback turns the gaps into chain separation."""
        segments: List[str] = []
        indices: List[int] = []
        next_index = residue_index_offset

        def walk(node: "ProgramNode") -> None:
            nonlocal next_index
            start = next_index
            if node.is_leaf_node():
                seq = node.sequence_segment.get()
                segments.append(seq)
                indices.extend(range(next_index, next_index + len(seq)))
                next_index += len(seq)
            else:
                for i, child in enumerate(node.children):
                    if i > 0 and node.children_are_different_chains:
                        next_index += MULTIMER_RESIDUE_INDEX_SKIP_LENGTH
                    walk(child)
            node.residue_index_range = (start, next_index)

        walk(self)
        return "".join(segments), indices

    def get_residue_index_range(self) -> Tuple[int, int]:
        assert self.residue_index_range is not None
        return self.residue_index_range

    def _walk_named(self, prefix: str) -> Iterator[Tuple[str, "ProgramNode"]]:
        """(path-name, node) pairs in pre-order; children named .n1, .n2, ..."""
        yield prefix, self
        if not self.is_leaf_node():
            for i, child in enumerate(self.children):
                yield from child._walk_named(f"{prefix}.n{i + 1}")

    def get_energy_term_functions(
        self, name_prefix: str = ""
    ) -> List[Tuple[str, float, Callable]]:
        return [
            (f"{name}:{type(term).__name__}", weight, partial(term.compute, node))
            for name, node in self._walk_named(name_prefix or "root")
            for term, weight in zip(
                node.energy_function_terms, node.energy_function_weights
            )
        ]

    def mutate(self) -> None:
        """Mutate one leaf segment, chosen proportionally to its number of
        mutation candidates (equivalent to the per-level candidate-weighted
        descent: at every level the subtree weight is the sum of its leaves')."""
        leaves = list(self._leaves())
        weights = np.array(
            [float(leaf.num_mutation_candidates()) for leaf in leaves]
        )
        assert weights.sum() > 0
        chosen = np.random.choice(len(leaves), p=weights / weights.sum())
        leaves[chosen].sequence_segment.mutate()

    def num_mutation_candidates(self) -> int:
        return sum(
            leaf.sequence_segment.num_mutation_candidates() for leaf in self._leaves()
        )
