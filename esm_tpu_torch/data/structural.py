"""The SCOPe structural split dataset, read from a local root.

Port of esm_tpu/data/structural.py (reference semantics: esm/data.py:381-493,
ESMStructuralSplitDataset): 5-fold cross-validation splits at the family,
superfamily and fold levels; items are {seq, ssp, dist, coords} pickles.
Downloading is not ported: the tarballs are read from ``root_path`` only.
"""

from __future__ import annotations

import os
import pickle


class ESMStructuralSplitDataset:
    """Structural split dataset (Rives et al. 2021, supplement A.10).

    Per SCOPe domain: seq (an L string), ssp (an L string of secondary
    structure), dist (an L x L distance array), coords (an L x 3 array).
    Splits: ``<root_path>/structural-data/splits/{split_level}/{cv_partition}/{split}.txt``;
    items: ``<root_path>/structural-data/pkl/{name[1:3]}/{name}.pkl``.
    """

    base_folder = "structural-data"
    # (url, tarball, folder it unpacks to, md5): where the files come from
    file_list = [
        ("https://dl.fbaipublicfiles.com/fair-esm/structural-data/splits.tar.gz",
         "splits.tar.gz", "splits", "456fe1c7f22c9d3d8dfe9735da52411d"),
        ("https://dl.fbaipublicfiles.com/fair-esm/structural-data/pkl.tar.gz",
         "pkl.tar.gz", "pkl", "644ea91e56066c750cd50101d390f5db"),
    ]

    def __init__(
        self,
        split_level: str,
        cv_partition: str,
        split: str,
        root_path: str = os.path.expanduser("~/.cache/esm_tpu/data"),
        download: bool = False,
    ):
        if split not in ("train", "valid"):
            raise ValueError(f"split must be 'train' or 'valid', got {split!r}")
        self.root_path = root_path
        self.base_path = os.path.join(self.root_path, self.base_folder)
        if download:
            raise NotImplementedError(
                "downloading the structural split dataset is not ported: fetch "
                + " and ".join(url for url, *_ in self.file_list)
                + f", check their md5 sums, and unpack both under {self.base_path} "
                "(giving splits/ and pkl/ there)")
        self.split_file = os.path.join(self.base_path, "splits", split_level, cv_partition,
                                       f"{split}.txt")
        self.pkl_dir = os.path.join(self.base_path, "pkl")
        if not self._check_exists():
            raise FileNotFoundError(
                f"{self.base_path} lacks splits/ or pkl/: unpack splits.tar.gz and pkl.tar.gz "
                "there (downloading is not ported)")
        with open(self.split_file) as f:
            self.names = f.read().splitlines()

    def __len__(self) -> int:
        return len(self.names)

    def _check_exists(self) -> bool:
        return all(os.path.isdir(os.path.join(self.base_path, folder))
                   for _, _, folder, _ in self.file_list)

    def __getitem__(self, idx: int) -> dict:
        name = self.names[idx]
        with open(os.path.join(self.pkl_dir, name[1:3], f"{name}.pkl"), "rb") as f:
            return pickle.load(f)
