"""ESM Metagenomic Atlas bulk-download manifests: URL builders only.

Port of esm_tpu/data/atlas.py (reference semantics: scripts/atlas/, the
v2023_02 manifests): the per-bin PDB tarballs and foldseek databases binned
by pTM x pLDDT, and the metadata databases, generated instead of shipped as
manifest files. Nothing here fetches.
"""

from __future__ import annotations

from typing import Iterator, List

BASE = "https://dl.fbaipublicfiles.com/esmatlas/v2023_02"

# the pTM / pLDDT bins of the v2023_02 release: 0.00-1.00 in steps of 0.10
_BINS = [f"{x / 10:.2f}" for x in range(0, 10)]


def tarball_urls(kind: str = "full") -> Iterator[str]:
    """URLs of the per-bin .tar archives. kind: 'full' or 'high_quality_clust30'."""
    if kind == "high_quality_clust30":
        yield f"{BASE}/highquality_clust30/tarballs/highquality_clust30.tar"
        return
    for ptm in _BINS:
        for plddt in _BINS:
            yield (f"{BASE}/full/tarballs/ptm_{ptm}_to_{float(ptm) + 0.1:.2f}"
                   f"__plddt_{plddt}_to_{float(plddt) + 0.1:.2f}.tar")


def foldseek_db_urls() -> List[str]:
    return [f"{BASE}/foldseek/esm_atlas_v2023_02.{suffix}" for suffix in ("tar.gz", "md5")]


def metadata_urls() -> List[str]:
    """The metadata parquet and sqlite files (id, ptm, plddt, num_conf, len, ...)."""
    return [f"{BASE}/metadata/esm_atlas_v2023_02_metadata.parquet",
            f"{BASE}/metadata/esm_atlas_v2023_02.sqlite"]


def fetch_structure_api_url(atlas_id: str, fmt: str = "pdb") -> str:
    """The single-structure endpoint (reference scripts/atlas/README.md)."""
    return f"https://api.esmatlas.com/fetchPredictedStructure/{atlas_id}.{fmt}"
