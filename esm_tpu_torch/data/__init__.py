from .alphabet import PROTEIN_TOKS, Alphabet, BatchConverter, MSABatchConverter
from .fasta import FastaBatchedDataset, read_alignment_lines, read_fasta
from .msa import greedy_select, read_msa, remove_insertions

__all__ = [
    "PROTEIN_TOKS", "Alphabet", "BatchConverter", "MSABatchConverter",
    "FastaBatchedDataset", "read_alignment_lines", "read_fasta",
    "greedy_select", "read_msa", "remove_insertions",
]
