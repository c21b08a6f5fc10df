"""The port's torch.hub entry points (esm_tpu_torch/hubconf.py): every name of
the root hubconf.py, loaded through ``torch.hub.load(..., source="local")``
from the local checkpoint cache only."""

import ast
import importlib
import pathlib

import torch

from esm_tpu_torch import pretrained
from esm_tpu_torch.data import Alphabet
from esm_tpu_torch.io.export import save_esm2
from esm_tpu_torch.models import esm2

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "esm_tpu_torch"


def _imported_names(path):
    tree = ast.parse(path.read_text())
    return sorted(a.asname or a.name for node in ast.walk(tree)
                  if isinstance(node, ast.ImportFrom) for a in node.names)


def test_every_root_hub_name_is_an_entry():
    names = _imported_names(ROOT / "hubconf.py")
    assert len(names) == 34
    assert _imported_names(PKG / "hubconf.py") == names
    hub = importlib.import_module("esm_tpu_torch.hubconf")
    assert all(callable(getattr(hub, n)) for n in names)


def test_hub_load_from_the_local_cache(tmp_path, monkeypatch):
    cfg = esm2.ESM2Config.from_alphabet(Alphabet.from_architecture("ESM-1b"), num_layers=2,
                                        embed_dim=64, attention_heads=4)
    save_esm2(esm2.init(cfg, torch.Generator().manual_seed(0), device="cpu"),
              tmp_path / "esm2_t6_8M_UR50D.pt")
    monkeypatch.setenv("ESM_TPU_CACHE", str(tmp_path))
    handle, alphabet = torch.hub.load(str(PKG), "esm2_t6_8M_UR50D", source="local",
                                      device="cpu")
    want, _ = pretrained.load_model_and_alphabet_local(tmp_path / "esm2_t6_8M_UR50D.pt",
                                                       device="cpu")
    toks = alphabet.get_batch_converter()([("a", "MKTAYIAKQR")])[2]
    torch.testing.assert_close(handle(toks)["logits"], want(toks)["logits"], rtol=0, atol=0)
