"""AlphaFold-2 residue constants.

The port's own copy of esm_tpu/data/residue_constants.py: the tables are
read from ``residue_constants.npz`` beside this file (a byte-for-byte copy of
the JAX package's, AlphaFold's published literature geometry). Used by the
ESMFold structure module (torsions -> frames -> atom14), the atom14/atom37
maps and the PDB writer (reference: openfold's tables, consumed at
esm/esmfold/v1/esmfold.py:23-25 and esm/esmfold/v1/misc.py:12-15).

Array tables are module attributes (``residue_constants.restype_atom14_mask``
and so on); the string tables are functions.
"""

from __future__ import annotations

import functools
import os

import numpy as np


@functools.lru_cache(None)
def _data() -> dict:
    path = os.path.join(os.path.dirname(__file__), "residue_constants.npz")
    with np.load(path, allow_pickle=False) as f:
        return {k: f[k] for k in f.files}


def __getattr__(name: str):
    d = _data()
    if name in d:
        return d[name]
    raise AttributeError(name)


restype_num = 20


@functools.lru_cache(None)
def restypes() -> list:
    return [str(x) for x in _data()["restypes"]]


@functools.lru_cache(None)
def restypes_with_x() -> list:
    return [str(x) for x in _data()["restypes_with_x"]]


@functools.lru_cache(None)
def restype_order_with_x() -> dict:
    return {r: i for i, r in enumerate(restypes_with_x())}


@functools.lru_cache(None)
def restype_1to3() -> dict:
    d = _data()
    return {str(k): str(v) for k, v in zip(d["restype_1to3_keys"], d["restype_1to3_vals"])}


@functools.lru_cache(None)
def atom_types() -> list:
    return [str(x) for x in _data()["atom_types"]]
