"""Port of esm_tpu/apps/ppl/sequence.py, copied: host-side Python with the
numpy draws in esm_tpu's order, from ``np.random``'s global state.

Sequence segment factories for the protein programming language.

Reference semantics: examples/protein-programming-language/language/sequence.py —
constant / fixed-length / variable-length segments with substitution, deletion
and insertion mutations (cysteine disallowed by default).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List, Union

import numpy as np

ALL_RESIDUE_TYPES = [
    "A", "R", "N", "D", "C", "Q", "E", "G", "H", "I",
    "L", "K", "M", "F", "P", "S", "T", "W", "Y", "V",
]
RESIDUE_TYPES_WITHOUT_CYSTEINE = [r for r in ALL_RESIDUE_TYPES if r != "C"]

RESIDUE_TYPES_1to3 = {
    "A": "ALA", "R": "ARG", "N": "ASN", "D": "ASP", "C": "CYS",
    "Q": "GLN", "E": "GLU", "G": "GLY", "H": "HIS", "I": "ILE",
    "L": "LEU", "K": "LYS", "M": "MET", "F": "PHE", "P": "PRO",
    "S": "SER", "T": "THR", "W": "TRP", "Y": "TYR", "V": "VAL",
}
RESIDUE_TYPES_3to1 = {v: k for k, v in RESIDUE_TYPES_1to3.items()}


def random_sequence(length: int, corpus: List[str], rng=np.random) -> str:
    return "".join(rng.choice(corpus) for _ in range(length))


def substitute_one_amino_acid(sequence: str, corpus: List[str], rng=np.random) -> str:
    s = list(sequence)
    s[rng.choice(len(s))] = rng.choice(corpus)
    return "".join(s)


def delete_one_amino_acid(sequence: str, rng=np.random) -> str:
    i = rng.choice(len(sequence))
    return sequence[:i] + sequence[i + 1 :]


def insert_one_amino_acid(sequence: str, corpus: List[str], rng=np.random) -> str:
    n = len(sequence)
    i = rng.randint(0, n) if n > 0 else 0
    return sequence[:i] + rng.choice(corpus) + sequence[i:]


class SequenceSegmentFactory(ABC):
    @abstractmethod
    def get(self) -> str: ...

    @abstractmethod
    def mutate(self) -> None: ...

    @abstractmethod
    def num_mutation_candidates(self) -> int: ...


class ConstantSequenceSegment(SequenceSegmentFactory):
    def __init__(self, sequence: str) -> None:
        self.sequence = sequence

    def get(self) -> str:
        return self.sequence

    def mutate(self) -> None:
        pass

    def num_mutation_candidates(self) -> int:
        return 0


class FixedLengthSequenceSegment(SequenceSegmentFactory):
    def __init__(
        self,
        initial_sequence: Union[str, int],
        disallow_mutations_to_cysteine: bool = True,
    ) -> None:
        self.mutation_residue_types = (
            RESIDUE_TYPES_WITHOUT_CYSTEINE
            if disallow_mutations_to_cysteine
            else ALL_RESIDUE_TYPES
        )
        self.sequence = (
            initial_sequence
            if isinstance(initial_sequence, str)
            else random_sequence(initial_sequence, self.mutation_residue_types)
        )

    def get(self) -> str:
        return self.sequence

    def mutate(self) -> None:
        self.sequence = substitute_one_amino_acid(
            self.sequence, self.mutation_residue_types
        )

    def num_mutation_candidates(self) -> int:
        return len(self.sequence)


class VariableLengthSequenceSegment(SequenceSegmentFactory):
    def __init__(
        self,
        initial_sequence: Union[str, int],
        disallow_mutations_to_cysteine: bool = True,
        mutation_operation_probabilities=(3.0, 1.0, 1.0),  # sub, del, ins
    ) -> None:
        self.mutation_residue_types = (
            RESIDUE_TYPES_WITHOUT_CYSTEINE
            if disallow_mutations_to_cysteine
            else ALL_RESIDUE_TYPES
        )
        self.sequence = (
            initial_sequence
            if isinstance(initial_sequence, str)
            else random_sequence(initial_sequence, self.mutation_residue_types)
        )
        p = np.asarray(mutation_operation_probabilities, float)
        self.mutation_operation_probabilities = p / p.sum()

    def get(self) -> str:
        return self.sequence

    def mutate(self) -> None:
        op = np.random.choice(3, p=self.mutation_operation_probabilities)
        if op == 0:
            self.sequence = substitute_one_amino_acid(
                self.sequence, self.mutation_residue_types
            )
        elif op == 1:
            self.sequence = delete_one_amino_acid(self.sequence)
        else:
            self.sequence = insert_one_amino_acid(
                self.sequence, self.mutation_residue_types
            )

    def num_mutation_candidates(self) -> int:
        return len(self.sequence)
