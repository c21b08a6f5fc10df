"""The port's structure reader (esm_tpu_torch.data.pdb) and the inverse-folding
loaders built on it, against esm_tpu.data.pdb and esm_tpu's load_coords on
the fixtures tests/test_pdb_io.py builds: an altloc B copy, a HETATM water,
a second model, a residue missing its C atom, primed and quoted mmCIF
values. Every parsed field and every backbone array must be equal."""

import numpy as np
import pytest

from esm_tpu.data import pdb as jpdb
from esm_tpu.models.inverse_folding import util as jutil
from esm_tpu_torch.data import pdb as tpdb
from esm_tpu_torch.models.inverse_folding import multichain as tmulti
from esm_tpu_torch.models.inverse_folding import util as tutil
from tests.test_pdb_io import CIF_TEXT, pdb_text  # noqa: F401  (pdb_text is a fixture)

QUOTED_CIF = "\n".join([
    "data_test", "loop_", "_atom_site.group_PDB", "_atom_site.id", "_atom_site.auth_atom_id",
    "_atom_site.label_alt_id", "_atom_site.auth_comp_id", "_atom_site.auth_asym_id",
    "_atom_site.auth_seq_id", "_atom_site.Cartn_x", "_atom_site.Cartn_y", "_atom_site.Cartn_z",
    "_atom_site.type_symbol", "_atom_site.pdbx_PDB_model_num",
    "ATOM 1 \"O5'\" . DA A 1 1.0 2.0 3.0 O 1",
    "ATOM 2 'C1\"' . DA A 1 1.5 2.5 3.5 C 1",
    "ATOM 3 CA . ALA A 2 4.0 5.0 6.0 C 1",
    "#",
])
FIELDS = ("coord", "atom_name", "res_name", "res_id", "chain_id", "element", "hetero")


def assert_same_atoms(got, want):
    assert len(got) == len(want)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


def assert_same_backbone(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


@pytest.mark.parametrize("keep_hetero", [False, True])
def test_read_pdb_matches_jax(pdb_text, keep_hetero):
    assert_same_atoms(tpdb.read_pdb(pdb_text, keep_hetero=keep_hetero),
                      jpdb.read_pdb(pdb_text, keep_hetero=keep_hetero))


@pytest.mark.parametrize("keep_hetero", [False, True])
@pytest.mark.parametrize("text", [CIF_TEXT, QUOTED_CIF], ids=["cif", "quoted_cif"])
def test_read_cif_matches_jax(text, keep_hetero):
    assert_same_atoms(tpdb.read_cif(text, keep_hetero=keep_hetero),
                      jpdb.read_cif(text, keep_hetero=keep_hetero))


def test_cif_tokens_match_jax():
    for line in ("ATOM \"O5'\" 'C1\"' end", "'a b' plain", "x 'unterminated", "  a\tb  "):
        assert tpdb._cif_tokens(line) == jpdb._cif_tokens(line)
    assert tpdb.read_cif(QUOTED_CIF).atom_name.tolist() == ["O5'", 'C1"', "CA"]


@pytest.mark.parametrize("chain", [None, "A", "B"])
def test_backbone_coords_match_jax(pdb_text, chain):
    got = tpdb.backbone_coords(tpdb.read_pdb(pdb_text), chain=chain)
    assert_same_backbone(got, jpdb.backbone_coords(jpdb.read_pdb(pdb_text), chain=chain))
    got = tpdb.backbone_coords(tpdb.read_cif(CIF_TEXT), chain=chain)
    assert_same_backbone(got, jpdb.backbone_coords(jpdb.read_cif(CIF_TEXT), chain=chain))


def test_missing_atom_is_a_nan_row(pdb_text):
    coords, seq = tpdb.backbone_coords(tpdb.read_pdb(pdb_text), chain="B")
    assert seq == "G" and np.isnan(coords[0, 2]).all() and np.isfinite(coords[0, :2]).all()


@pytest.mark.parametrize("chain", [None, "A", "B", ["A", "B"], ["B"]],
                         ids=["all", "A", "B", "AB", "list_B"])
@pytest.mark.parametrize("suffix", [".pdb", ".cif"])
def test_load_coords_matches_jax(pdb_text, tmp_path, chain, suffix):
    """The port's load_coords against esm_tpu's, whose biotite-free fallback
    reads the same file through esm_tpu.data.pdb."""
    path = tmp_path / f"s{suffix}"
    path.write_text(pdb_text if suffix == ".pdb" else CIF_TEXT)
    got = tutil.load_coords(str(path), chain)
    assert_same_backbone(got, jutil.load_coords(str(path), chain))
    assert tpdb.read_structure(str(path)).coord.shape[0] == len(jpdb.read_structure(str(path)))


def test_load_structure_and_complex(pdb_text, tmp_path):
    path = tmp_path / "c.pdb"
    path.write_text(pdb_text)
    atoms = tutil.load_structure(str(path))
    coords, seqs = tmulti.extract_coords_from_complex(atoms)
    assert list(coords) == ["A", "B"] and seqs == {"A": "MKT", "B": "G"}
    for c in ("A", "B"):
        assert_same_backbone((coords[c], seqs[c]),
                             jpdb.backbone_coords(jpdb.read_pdb(pdb_text), chain=c))
    coords_b, _ = tmulti.load_complex_coords(str(path), ["B"])
    assert list(coords_b) == ["B"]
    with pytest.raises(ValueError, match="Chain Z not found"):
        tutil.load_structure(str(path), "Z")
    empty = tmp_path / "empty.pdb"
    empty.write_text("HEADER    EMPTY\nEND\n")
    with pytest.raises(ValueError, match="No chains"):
        tutil.load_structure(str(empty))
