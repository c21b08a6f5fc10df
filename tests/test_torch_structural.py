"""The port's structural split dataset (esm_tpu_torch.data.structural)
against esm_tpu's on a synthetic split directory: the same names, the same
items; downloading is not ported, and the constructor says where the files
go; the atlas URL builders (esm_tpu_torch.data.atlas) equal esm_tpu's."""

import pickle

import numpy as np
import pytest

from esm_tpu.data import atlas as jatlas
from esm_tpu.data.structural import ESMStructuralSplitDataset as JaxDataset
from esm_tpu_torch.data import atlas
from esm_tpu_torch.data.structural import ESMStructuralSplitDataset


@pytest.fixture
def root(tmp_path):
    """structural-data/{splits/superfamily/4/{train,valid}.txt, pkl/..} with
    seeded items."""
    base = tmp_path / "structural-data"
    rng = np.random.RandomState(0)
    names = ["d1abca_", "d1abcb_", "d2xyza1", "d3qrsa_"]
    for name in names:
        L = int(rng.randint(5, 12))
        item = {"seq": "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), L)),
                "ssp": "".join(rng.choice(list("HEC"), L)),
                "dist": rng.rand(L, L) * 20, "coords": rng.randn(L, 3)}
        d = base / "pkl" / name[1:3]
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{name}.pkl").write_bytes(pickle.dumps(item))
    split = base / "splits" / "superfamily" / "4"
    split.mkdir(parents=True)
    (split / "train.txt").write_text("\n".join(names[:3]) + "\n")
    (split / "valid.txt").write_text(names[3] + "\n")
    return tmp_path


@pytest.mark.parametrize("split", ["train", "valid"])
def test_dataset_matches_jax(root, split):
    ds = ESMStructuralSplitDataset("superfamily", "4", split, root_path=str(root))
    want = JaxDataset("superfamily", "4", split, root_path=str(root))
    assert ds.names == want.names and len(ds) == len(want) == (3 if split == "train" else 1)
    for i in range(len(ds)):
        got, ref = ds[i], want[i]
        assert got.keys() == ref.keys() == {"seq", "ssp", "dist", "coords"}
        assert got["seq"] == ref["seq"] and got["ssp"] == ref["ssp"]
        np.testing.assert_array_equal(got["dist"], ref["dist"])
        np.testing.assert_array_equal(got["coords"], ref["coords"])


def test_dataset_refusals(root, tmp_path):
    with pytest.raises(NotImplementedError, match="splits.tar.gz"):
        ESMStructuralSplitDataset("superfamily", "4", "train", root_path=str(root), download=True)
    with pytest.raises(FileNotFoundError, match="unpack"):
        ESMStructuralSplitDataset("superfamily", "4", "train", root_path=str(tmp_path / "none"))
    with pytest.raises(ValueError, match="split"):
        ESMStructuralSplitDataset("superfamily", "4", "test", root_path=str(root))


def test_atlas_urls_match_jax():
    for kind in ("full", "high_quality_clust30"):
        assert list(atlas.tarball_urls(kind)) == list(jatlas.tarball_urls(kind))
    assert len(list(atlas.tarball_urls())) == 100
    assert atlas.foldseek_db_urls() == jatlas.foldseek_db_urls()
    assert atlas.metadata_urls() == jatlas.metadata_urls()
    assert atlas.fetch_structure_api_url("MGYP000", "cif") == jatlas.fetch_structure_api_url(
        "MGYP000", "cif")
