"""ESM-IF1 checkpoints and CLIs of the port (esm_tpu_torch) against esm_tpu, on
the CPU: save_if1 -> load_model_and_alphabet_local round trips (strict keys)
in both packages, older checkpoint key layouts, the registry name from the
local cache, random_model_and_alphabet at the released size, and the
port's if_score / if_sample (--nogpu) against esm_tpu.cli.if_score on the
same checkpoint and structure files (esm_tpu reads them through its
biotite-free fallback, esm_tpu/data/pdb.py).

Small model (as tests/test_torch_if1.py sizes it), fp32. Tolerance: 1e-4
absolute on the scores (log-likelihoods of a few, summed over ~30
positions, summation order only).
"""

import csv
import re

import numpy as np
import pytest
import torch

from esm_tpu import pretrained as jpretrained
from esm_tpu.cli import if_score as jif_score
from esm_tpu.data import pdb as jpdb
from esm_tpu.models.inverse_folding import multichain as jmulti
from esm_tpu_torch import pretrained
from esm_tpu_torch.cli import if_sample, if_score
from esm_tpu_torch.data import Alphabet
from esm_tpu_torch.io import export
from esm_tpu_torch.models import inverse_folding as tif

SIZE = dict(
    encoder_embed_dim=64, encoder_layers=2, encoder_attention_heads=4, encoder_ffn_embed_dim=128,
    decoder_embed_dim=64, decoder_layers=2, decoder_attention_heads=4, decoder_ffn_embed_dim=128,
    gvp_top_k_neighbors=6, gvp_node_hidden_dim_scalar=32, gvp_node_hidden_dim_vector=8,
    gvp_edge_hidden_dim_scalar=16, gvp_edge_hidden_dim_vector=1, gvp_num_encoder_layers=2,
)
AAS = "ACDEFGHIKLMNPQRSTVWY"
THREE = {"A": "ALA", "C": "CYS", "D": "ASP", "E": "GLU", "F": "PHE", "G": "GLY", "H": "HIS",
         "I": "ILE", "K": "LYS", "L": "LEU", "M": "MET", "N": "ASN", "P": "PRO", "Q": "GLN",
         "R": "ARG", "S": "SER", "T": "THR", "V": "VAL", "W": "TRP", "Y": "TYR"}
TOL = 1e-4


def backbone(L, seed):
    g = np.random.RandomState(seed)
    return np.cumsum(g.normal(0, 1.0, (L, 3, 3)).astype(np.float32), axis=0) * 1.2


def atom_rows(chains):
    """(chain, residue number, residue name, atom, xyz) for N/CA/C of every
    residue, NaN atoms left out; ``chains``: {chain id: (coords, sequence)}."""
    rows = []
    for chain, (coords, seq) in chains.items():
        for i, aa in enumerate(seq):
            for a, name in enumerate(("N", "CA", "C")):
                if np.isfinite(coords[i, a]).all():
                    rows.append((chain, i + 1, THREE[aa], name, coords[i, a]))
    return rows


def write_pdb(path, chains):
    lines = [f"ATOM  {k + 1:5d} {name:<4s} {res:>3s} {chain}{num:4d}    "
             f"{x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00           {name[0]}"
             for k, (chain, num, res, name, (x, y, z)) in enumerate(atom_rows(chains))]
    path.write_text("\n".join(lines) + "\nEND\n")


def write_cif(path, chains):
    tags = ["group_PDB", "id", "type_symbol", "label_atom_id", "label_comp_id", "label_asym_id",
            "label_seq_id", "Cartn_x", "Cartn_y", "Cartn_z", "auth_seq_id", "auth_asym_id",
            "pdbx_PDB_model_num"]
    lines = ["data_test", "loop_"] + [f"_atom_site.{t}" for t in tags]
    lines += [f"ATOM {k + 1} {name[0]} {name} {res} {chain} {num} {x:.3f} {y:.3f} {z:.3f} "
              f"{num} {chain} 1"
              for k, (chain, num, res, name, (x, y, z)) in enumerate(atom_rows(chains))]
    path.write_text("\n".join(lines) + "\n#\n")


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A small seeded ESM-IF1 written by save_if1, a 30-residue backbone (and
    a second chain) as .pdb and .cif, and a FASTA of 6 variants."""
    tmp = tmp_path_factory.mktemp("if1")
    alphabet = Alphabet.from_architecture("invariant_gvp")
    cfg = tif.GVPTransformerConfig.from_alphabet(alphabet, **SIZE)
    model = tif.init(cfg, torch.Generator().manual_seed(3))
    path, reg = export.save_if1(model, tmp / "esm_if1_small.pt")
    assert reg is None
    rng = np.random.RandomState(4)
    native = "".join(rng.choice(list(AAS), 30))
    other = "".join(rng.choice(list(AAS), 12))
    coords = backbone(30, 5)
    coords[7, 1:] = np.nan  # CA and C missing: a NaN row when read back
    chains = {"A": (coords, native), "B": (backbone(12, 6) + 15.0, other)}
    write_pdb(tmp / "s.pdb", chains)
    write_cif(tmp / "s.cif", chains)
    variants = [native] + ["".join(rng.choice(list(AAS), 30)) for _ in range(5)]
    (tmp / "v.fasta").write_text("".join(f">v{i}\n{s}\n" for i, s in enumerate(variants)))
    return tmp, path, model, native


def test_save_if1_round_trip_in_both_packages(checkpoint):
    tmp, path, model, _ = checkpoint
    handle, alphabet = pretrained.load_model_and_alphabet_local(path, device="cpu")
    assert isinstance(handle, pretrained.IFHandle) and handle.device.type == "cpu"
    assert handle.cfg == model.cfg
    want = model.state_dict()
    got = handle.model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # esm_tpu loads the same file (its converter reads every key) and scores alike
    jhandle, jalphabet = jpretrained.load_model_and_alphabet_local(path)
    coords = backbone(9, 1)
    np.testing.assert_allclose(handle.score_sequence(coords, "MKTAYIAKQ"),
                               jhandle.score_sequence(coords, "MKTAYIAKQ"), atol=TOL)
    with pytest.raises(ValueError, match="esm_if"):
        export.save_if1(model, tmp / "if1_small.pt")


def test_old_checkpoint_key_layout_loads(checkpoint):
    """Keys of the layout the released file predates are renamed on load
    (_GVP_KEY_RENAMES), in the port as in esm_tpu; "version" keys drop."""
    tmp, path, model, _ = checkpoint
    data = torch.load(path, weights_only=False)
    old = {}
    for k, v in data["model"].items():
        for new, was in (("gvp_encoder.embed_graph.embed_node", "gvp_encoder.W_v"),
                         ("gvp_encoder.embed_graph.embed_edge", "gvp_encoder.W_e"),
                         ("gvp_encoder.embed_graph.embed_confidence", "gvp_encoder.embed_score"),
                         ("encoder.embed_confidence", "encoder.embed_scores.0"),
                         ("embed_dihedrals", "embed_ingraham_features"),
                         ("embed_gvp_output", "embed_gvp_in_local_frame.0"),
                         ("embed_gvp_input_features", "embed_features_in_local_frame.0")):
            k = k.replace(new, was)
        old[k] = v
    old["encoder.version"] = torch.tensor([2.0])
    assert "encoder.gvp_encoder.W_v.0.wh.weight" in old
    data["model"] = old
    old_path = tmp / "esm_if1_old_layout.pt"
    torch.save(data, old_path)
    handle, _ = pretrained.load_model_and_alphabet_local(old_path, device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(handle.model.state_dict()[k], v), k
    jhandle, _ = jpretrained.load_model_and_alphabet_local(str(old_path))
    coords = backbone(8, 2)
    np.testing.assert_allclose(handle.score_sequence(coords, "GAVLIEKW"),
                               jhandle.score_sequence(coords, "GAVLIEKW"), atol=TOL)


def test_registry_name_resolves_from_the_local_cache(checkpoint, tmp_path, monkeypatch):
    _, path, model, _ = checkpoint
    monkeypatch.setenv("ESM_TPU_CACHE", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="not ported"):
        pretrained.esm_if1_gvp4_t16_142M_UR50(device="cpu")
    export.save_if1(model, tmp_path / "esm_if1_gvp4_t16_142M_UR50.pt")
    handle, alphabet = pretrained.esm_if1_gvp4_t16_142M_UR50(device="cpu")
    assert isinstance(handle, pretrained.IFHandle) and alphabet.get_idx("<cath>") == 33


def test_random_model_at_the_released_size():
    handle, alphabet = pretrained.random_model_and_alphabet(
        "esm_if1_gvp4_t16_142M_UR50", seed=0, device="cpu")
    assert isinstance(handle, pretrained.IFHandle)
    assert handle.cfg == tif.GVPTransformerConfig.from_alphabet(alphabet)
    assert sum(p.numel() for p in handle.model.parameters()) == 141_662_150
    coords = backbone(6, 0)
    ll, llc = handle.score_sequence(coords, "MKTAYI")
    assert np.isfinite([ll, llc]).all()
    assert handle.get_encoder_output(coords).shape == (6, 512)
    with pytest.raises(TypeError, match="no execution options"):
        pretrained.random_model_and_alphabet("esm_if1_gvp4_t16_142M_UR50", device="cpu",
                                             use_flash=True)


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("structure", ["s.pdb", "s.cif"])
def test_if_score_matches_jax_cli(checkpoint, structure, capsys):
    tmp, path, _, _ = checkpoint
    argv = [str(tmp / structure), str(tmp / "v.fasta"), "--chain", "A", "--model", str(path)]
    if_score.run(if_score.create_parser().parse_args(
        argv + ["--outpath", str(tmp / "port.csv"), "--nogpu"]))
    printed = capsys.readouterr().out
    jif_score.run(jif_score.create_parser().parse_args(
        argv + ["--outpath", str(tmp / "jax.csv"), "--nogpu"]))
    got, want = _read_csv(tmp / "port.csv"), _read_csv(tmp / "jax.csv")
    assert got[0] == want[0] == ["seqid", "log_likelihood", "log_likelihood_withcoord"]
    assert [r[0] for r in got[1:]] == [r[0] for r in want[1:]] == [f"v{i}" for i in range(6)]
    np.testing.assert_allclose(np.asarray([r[1:] for r in got[1:]], float),
                               np.asarray([r[1:] for r in want[1:]], float), atol=TOL)
    assert "v0:" in printed and "Results saved to" in printed


def test_if_score_multichain_matches_jax(checkpoint):
    """--multichain-backbone scores chain A in the complex; held against
    esm_tpu's score_sequence_in_complex on the chains esm_tpu.data.pdb
    reads (esm_tpu's CLI needs biotite for this mode)."""
    tmp, path, _, _ = checkpoint
    if_score.run(if_score.create_parser().parse_args(
        [str(tmp / "s.pdb"), str(tmp / "v.fasta"), "--model", str(path), "--nogpu",
         "--multichain-backbone", "--outpath", str(tmp / "multi.csv")]))
    got = _read_csv(tmp / "multi.csv")[1:]
    atoms = jpdb.read_pdb(str(tmp / "s.pdb"))
    coords = {c: jpdb.backbone_coords(atoms, chain=c)[0] for c in ("A", "B")}
    jhandle, jalphabet = jpretrained.load_model_and_alphabet_local(str(path))
    fasta = (tmp / "v.fasta").read_text().split()
    for row, seq in zip(got, fasta[1::2]):
        want = jmulti.score_sequence_in_complex(jhandle.params, jhandle.cfg, jalphabet, coords,
                                                "A", seq)
        np.testing.assert_allclose([float(row[1]), float(row[2])], want, atol=TOL)


@pytest.mark.parametrize("multichain", [False, True])
def test_if_sample_output(checkpoint, tmp_path, capsys, multichain):
    tmp, path, _, native = checkpoint

    def run(out):
        argv = [str(tmp / "s.pdb"), "--chain", "A", "--model", str(path), "--num-samples", "3",
                "--seed", "5", "--outpath", str(out), "--nogpu"]
        if_sample.run(if_sample.create_parser().parse_args(
            argv + (["--multichain-backbone"] if multichain else [])))
        return capsys.readouterr().out

    out = tmp_path / "sampled.fasta"
    printed = run(out)
    assert native in printed.splitlines()
    records = out.read_text().splitlines()
    assert records[0::2] == [">sampled_seq_1", ">sampled_seq_2", ">sampled_seq_3"]
    recoveries = [float(x) for x in re.findall(r"^Sequence recovery: ([0-9.]+)$", printed, re.M)]
    assert len(recoveries) == 3
    for seq, rec in zip(records[1::2], recoveries):
        assert rec == pytest.approx(np.mean([a == b for a, b in zip(native, seq)]))
    # the same seeds draw the same sequences
    again = tmp_path / "again.fasta"
    run(again)
    assert again.read_text() == out.read_text()
