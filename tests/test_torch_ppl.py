"""The port's protein programming language (esm_tpu_torch.apps.ppl) against
esm_tpu's on the CPU: the geometry, the energy terms, the seven recipes
under the annealer, the template reader, ESMFoldCallback on the same
weights, and the seven ppl_* examples at a tiny size.

The recipes and terms are host-side numpy in both packages, so a seeded
run must repeat esm_tpu's exactly: ``np.random.seed`` before each package's
build and run, one stub folder for both whose noise is seeded from
``zlib.crc32`` of the sequence (a stable hash; Python's ``hash`` is salted
per process). Geometry, SASA and SSE equal to 1e-6; energy traces, best
sequences and accept counts exactly.

ESMFoldCallback: a 2 x 32 LM and one trunk block at widths 32 (the size of
tests/test_ppl_programs.py), esm_tpu's seeded init with its all-zero
tensors re-drawn, carried across by esmfold_state_dict_from_jax; fp32.
Atom coordinates within 1e-3 A, pLDDT and pTM within 1e-4 (the bounds of
tests/test_torch_esmfold.py).
"""

import zlib

import jax
import numpy as np
import pytest
import torch

from esm_tpu.apps import ppl as jppl
from esm_tpu.apps.ppl import folding as jfolding
from esm_tpu.apps.ppl import geometry as jgeometry
from esm_tpu.data import Alphabet as JaxAlphabet
from esm_tpu.models import esm2 as jesm2
from esm_tpu.models import esmfold as jef
from esm_tpu_torch.apps import ppl
from esm_tpu_torch.apps.ppl import folding, geometry
from esm_tpu_torch.data import Alphabet
from esm_tpu_torch.io.export import save_esm2, save_esmfold
from esm_tpu_torch.io.from_jax import esmfold_state_dict_from_jax
from esm_tpu_torch.models import esm2
from esm_tpu_torch.models import esmfold as ef

from test_torch_esmfold import redraw_zeros

THREE = {"A": "ALA", "R": "ARG", "N": "ASN", "D": "ASP", "C": "CYS", "Q": "GLN", "E": "GLU",
         "G": "GLY", "H": "HIS", "I": "ILE", "L": "LEU", "K": "LYS", "M": "MET", "F": "PHE",
         "P": "PRO", "S": "SER", "T": "THR", "W": "TRP", "Y": "TYR", "V": "VAL"}


def stub_callback(pkg_folding):
    """A deterministic synthetic folder for either package: backbone atoms on
    a helix-like curve with sequence-seeded noise, confidences from the same
    seed (the stub of tests/test_ppl_programs.py with a stable hash)."""

    class Stub(pkg_folding.FoldingCallback):
        def fold(self, sequence, residue_indices):
            rng = np.random.RandomState(zlib.crc32(sequence.encode()) % (2 ** 31))
            L = len(sequence)
            t = np.arange(L) * 100.0 * np.pi / 180.0
            ca = np.stack([2.3 * np.cos(t), 2.3 * np.sin(t), 1.5 * np.arange(L)], -1)
            ca = ca + rng.randn(L, 3) * 0.05
            rows = [(ca[i] + off, name, THREE.get(sequence[i], "UNK"), residue_indices[i])
                    for i in range(L)
                    for name, off in (("N", [-0.5, 0.3, -0.6]), ("CA", [0, 0, 0]),
                                      ("C", [0.6, -0.2, 0.5]), ("O", [1.1, 0.6, 0.9]))]
            atoms = pkg_folding.AtomView(
                np.asarray([r[0] for r in rows], np.float32),
                np.asarray([r[1] for r in rows]),
                np.asarray([r[2] for r in rows]),
                np.asarray([r[3] for r in rows], np.int64),
                np.asarray([r[1][0] for r in rows]),
            )
            return pkg_folding.FoldingResult(
                ptm=float(rng.uniform(0.3, 0.9)), plddt=float(rng.uniform(0.4, 0.95)),
                atoms=atoms, residue_indices=np.asarray(residue_indices))

    return Stub()


def _template(pkg_folding):
    return stub_callback(pkg_folding).fold("KAVLEW", list(range(10, 16))).atoms


# -- geometry ------------------------------------------------------------------------------


def _helix(n, seed):
    t = np.arange(n)
    ca = np.stack([2.3 * np.cos(t * 1.745), 2.3 * np.sin(t * 1.745), 1.5 * t], -1)
    return ca + np.random.RandomState(seed).randn(n, 3) * 0.3


@pytest.mark.parametrize("fn", ["sasa", "kabsch_rmsd", "annotate_sse_ca"])
def test_geometry_matches_esm_tpu(fn):
    rng = np.random.RandomState(1)
    coords = np.cumsum(rng.randn(60, 3) * 1.5, axis=0)
    if fn == "sasa":
        elements = rng.choice(["C", "N", "O", "S", "X"], 60)
        np.testing.assert_allclose(geometry.sasa(coords, elements),
                                   jgeometry.sasa(coords, elements), atol=1e-6, rtol=0)
    elif fn == "kabsch_rmsd":
        other = coords @ np.linalg.qr(rng.randn(3, 3))[0] + rng.randn(60, 3) * 0.4
        got = geometry.kabsch_superimpose(coords, other)
        np.testing.assert_allclose(got, jgeometry.kabsch_superimpose(coords, other), atol=1e-6)
        assert abs(geometry.rmsd(coords, got) - jgeometry.rmsd(coords, got)) < 1e-6
    else:
        for ca in (_helix(30, 2), coords):
            assert np.array_equal(geometry.annotate_sse_ca(ca), jgeometry.annotate_sse_ca(ca))


# -- energy terms --------------------------------------------------------------------------

TERMS = {
    "MaximizePTM": lambda m, t: m.MaximizePTM(),
    "MaximizePLDDT": lambda m, t: m.MaximizePLDDT(),
    "SymmetryRing": lambda m, t: m.SymmetryRing(),
    "SymmetryRing all-to-all": lambda m, t: m.SymmetryRing(all_to_all_protomer_symmetry=True),
    "MinimizeSurfaceHydrophobics": lambda m, t: m.MinimizeSurfaceHydrophobics(),
    "MinimizeSurfaceExposure": lambda m, t: m.MinimizeSurfaceExposure(),
    "MaximizeSurfaceExposure": lambda m, t: m.MaximizeSurfaceExposure(),
    "MaximizeGlobularity": lambda m, t: m.MaximizeGlobularity(),
    "MinimizeCRmsd": lambda m, t: m.MinimizeCRmsd(template=t),
    "MinimizeCRmsd backbone": lambda m, t: m.MinimizeCRmsd(template=t, backbone_only=True),
    "MinimizeDRmsd": lambda m, t: m.MinimizeDRmsd(template=t),
    "MinimizeDRmsd backbone": lambda m, t: m.MinimizeDRmsd(template=t, backbone_only=True),
    "MatchSecondaryStructure": lambda m, t: m.MatchSecondaryStructure("a"),
}


@pytest.mark.parametrize("term", sorted(TERMS))
def test_energy_terms_match_esm_tpu(term):
    values = []
    for pkg, fold_mod in ((ppl, folding), (jppl, jfolding)):
        node = pkg.ProgramNode(
            children=[pkg.ProgramNode(sequence_segment=pkg.ConstantSequenceSegment(s))
                      for s in ("MKLVFWAE", "GSLIVKRE", "MKLVFWAE")],
            energy_function_terms=[TERMS[term](pkg, _template(fold_mod))])
        seq, idx = node.get_sequence_and_set_residue_index_ranges()
        result = stub_callback(fold_mod).fold(seq, idx)
        (name, weight, fn), = node.get_energy_term_functions()
        values.append((name, weight, fn(result)))
    (got_name, got_w, got), (want_name, want_w, want) = values
    assert (got_name, got_w) == (want_name, want_w)
    assert np.isfinite(got) and abs(got - want) <= 1e-6


# -- the recipes under the annealer ---------------------------------------------------------

RECIPES = {
    "free_hallucination": lambda m, t: m.free_hallucination(12),
    "fixed_backbone": lambda m, t: m.fixed_backbone(t),
    "functional_site_scaffolding": lambda m, t: m.functional_site_scaffolding(
        t, residue_range=(10, 15), flank_length=5),
    "secondary_structure": lambda m, t: m.secondary_structure("a", "b", segment_length=7),
    "symmetric_monomer": lambda m, t: m.symmetric_monomer(3, protomer_length=5),
    "symmetric_binding": lambda m, t: m.symmetric_binding(
        t, residue_range=(10, 15), num_binding_sites=3, flank_length=3),
    "symmetric_two_level_multimer": lambda m, t: m.symmetric_two_level_multimer(2, 2, 5),
}


def _anneal(pkg, fold_mod, recipe, steps=6):
    np.random.seed(0)
    program = RECIPES[recipe](pkg, _template(fold_mod))
    np.random.seed(1)
    return pkg.run_simulated_annealing(program, stub_callback(fold_mod), total_num_steps=steps,
                                       display_progress=False)


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_recipes_anneal_as_esm_tpu(recipe):
    got, want = _anneal(ppl, folding, recipe), _anneal(jppl, jfolding, recipe)
    assert got.energy_trace == want.energy_trace
    assert (got.best_sequence, got.best_energy, got.num_accepts, got.current_energy) == (
        want.best_sequence, want.best_energy, want.num_accepts, want.current_energy)
    assert got.best_energy_term_fn_values == want.best_energy_term_fn_values
    assert got.program.get_sequence_and_set_residue_index_ranges() == \
        want.program.get_sequence_and_set_residue_index_ranges()
    assert np.isfinite(got.best_energy) and got.best_energy <= got.current_energy


def test_pdb_file_to_atomview_matches_esm_tpu(tmp_path):
    rng = np.random.RandomState(5)
    seq = "MKTAYIAKQRQ"
    lines, serial = [], 1
    for chain, offset in (("A", 0), ("B", 20)):
        for i, aa in enumerate(seq):
            for name in ("N", "CA", "C", "O", "CB"):
                x, y, z = rng.randn(3) * 5 + offset
                lines.append(f"ATOM  {serial:5d}  {name:<3s} {THREE[aa]:>3s} {chain}{i + 5:4d}    "
                             f"{x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00           {name[0]}")
                serial += 1
    path = tmp_path / "t.pdb"
    path.write_text("\n".join(lines) + "\nEND\n")
    for chain in (None, "B"):
        got = ppl.pdb_file_to_atomview(str(path), chain=chain)
        want = jppl.pdb_file_to_atomview(str(path), chain=chain)
        for field in ("coord", "atom_name", "res_name", "res_id", "element"):
            assert np.array_equal(getattr(got, field), getattr(want, field)), field
    part = ppl.get_atomview_in_residue_range(got, 7, 10)
    assert ppl.sequence_from_atomview(part) == jppl.sequence_from_atomview(
        jppl.get_atomview_in_residue_range(want, 7, 10)) == "TAY"


# -- ESMFoldCallback on the same weights -------------------------------------------------------


def _fold_sizes(lib, lm_lib, alphabet):
    return lib.ESMFoldConfig(
        esm=lm_lib.ESM2Config.from_alphabet(alphabet, num_layers=2, embed_dim=32,
                                            attention_heads=2),
        trunk=lib.FoldingTrunkConfig(
            num_blocks=1, sequence_state_dim=32, pairwise_state_dim=32, sequence_head_width=16,
            pairwise_head_width=16, max_recycles=1,
            structure_module=lib.StructureModuleConfig(
                c_s=32, c_z=32, c_ipa=8, c_resnet=16, no_heads_ipa=4, no_blocks=1)),
        esm_type="esm2_8M",
    )


@pytest.fixture(scope="module")
def folders():
    jalpha = JaxAlphabet.from_architecture("ESM-1b")
    jcfg = _fold_sizes(jef, jesm2, jalpha)
    params = redraw_zeros(jax.tree.map(np.asarray, jef.init_esmfold(
        jax.random.PRNGKey(1), jcfg, jalpha)), 2)
    cfg = _fold_sizes(ef, esm2, Alphabet.from_architecture("ESM-1b"))
    model = ef.ESMFold(cfg, device="cpu")
    model.load_state_dict(esmfold_state_dict_from_jax(params, cfg), strict=True)
    jparams = jax.tree.map(jax.numpy.asarray, params)
    return (ppl.ESMFoldCallback(model, cfg, num_recycles=1, bucket=16),
            jppl.ESMFoldCallback(jparams, jcfg, num_recycles=1, bucket=16), model, cfg)


@pytest.mark.parametrize("indices", ["contiguous", "chain break"])
def test_esmfold_callback_matches_esm_tpu(folders, indices):
    callback, jcallback, _, _ = folders
    seq = "MKTAYIAKQRQI"
    idx = list(range(1, 13)) if indices == "contiguous" else (
        list(range(1, 7)) + list(range(1007, 1013)))
    got, want = callback.fold(seq, idx), jcallback.fold(seq, idx)
    for field in ("atom_name", "res_name", "res_id", "element"):
        assert np.array_equal(getattr(got.atoms, field), getattr(want.atoms, field)), field
    assert got.atoms.coord.dtype == np.float32 and len(got.atoms) > 3 * len(seq)
    np.testing.assert_allclose(got.atoms.coord, want.atoms.coord, atol=1e-3, rtol=0)
    assert abs(got.plddt - want.plddt) <= 1e-4 and abs(got.ptm - want.ptm) <= 1e-4
    assert np.array_equal(got.residue_indices, idx)


def test_esmfold_callback_matches_infer(folders):
    """The callback's bucketed fold on the real rows against ``infer`` at the
    same bucket, with infer's single-chain residue indices."""
    from esm_tpu_torch.models.esmfold.protein import atom14_to_atom37

    callback, _, model, cfg = folders
    seq = "MKTAYIAKQRQISFV"
    got = callback.fold(seq, list(range(len(seq))))
    out = ef.infer(model, cfg, seq, num_recycles=1, pad_to_multiple=16)
    pos37 = atom14_to_atom37(out["positions"][-1], out["aatype"])[0, :len(seq)].numpy()
    keep = out["atom37_atom_exists"][0, :len(seq)].numpy() >= 0.5
    np.testing.assert_allclose(got.atoms.coord, pos37[keep], atol=1e-5, rtol=0)
    assert abs(got.ptm - float(out["ptm"][0])) <= 1e-6
    assert abs(got.plddt - float(out["plddt"][0, :len(seq), 1].mean()) / 100) <= 1e-6


def test_annealing_through_the_callback_matches_esm_tpu(folders):
    callback, jcallback, _, _ = folders
    states = []
    for pkg, cb in ((ppl, callback), (jppl, jcallback)):
        np.random.seed(0)
        program = pkg.free_hallucination(12)
        np.random.seed(1)
        states.append(pkg.run_simulated_annealing(program, cb, total_num_steps=3,
                                                  display_progress=False))
    got, want = states
    np.testing.assert_allclose(got.energy_trace, want.energy_trace, atol=1e-4, rtol=0)
    assert (got.best_sequence, got.num_accepts) == (want.best_sequence, want.num_accepts)


# -- the examples ---------------------------------------------------------------------------


@pytest.fixture
def esmfold_cache(tmp_path, monkeypatch, folders):
    """ESMFold v1's registry name in a temporary ESM_TPU_CACHE, holding the
    tiny folder and its LM."""
    _, _, model, _ = folders
    save_esm2(model.esm, tmp_path / "esm2_t6_8M_UR50D_500K.pt")
    save_esmfold(model, tmp_path / "esmfold_3B_v1.pt")
    monkeypatch.setenv("ESM_TPU_CACHE", str(tmp_path))
    lines, serial = [], 1
    rng = np.random.RandomState(3)
    ca = np.cumsum(rng.randn(50, 3) * 0.5 + [3.8, 0, 0], axis=0)
    for i in range(50):
        for name, off in (("N", [-1.2, 0.6, 0]), ("CA", [0, 0, 0]), ("C", [1.3, -0.6, 0.2])):
            x, y, z = ca[i] + off
            lines.append(f"ATOM  {serial:5d}  {name:<3s} {'ALA':>3s} A{i + 1:4d}    "
                         f"{x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00           {name[0]}")
            serial += 1
    (tmp_path / "t.pdb").write_text("\n".join(lines) + "\nEND\n")
    return tmp_path / "t.pdb"


EXAMPLES = {
    "ppl_fixed_backbone": ["{pdb}", "--steps", "2"],
    "ppl_free_hallucination": ["--length", "10", "--steps", "2"],
    "ppl_secondary_structure": ["--segment-length", "6", "--steps", "2"],
    "ppl_site_scaffolding": ["{pdb}", "--site-start", "23", "--site-end", "28",
                             "--flank-length", "4", "--steps", "2"],
    "ppl_symmetric_binding": ["{pdb}", "--num-binding-sites", "2", "--flank-length", "3",
                              "--steps", "2"],
    "ppl_symmetric_design": ["--protomer-length", "5", "--num-protomers", "3", "--steps", "2"],
    "ppl_two_level_multimer": ["--num-chains", "2", "--protomers-per-chain", "2",
                               "--protomer-length", "4", "--steps", "2"],
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_ppl_examples_run(name, esmfold_cache, capsys):
    import importlib

    example = importlib.import_module(f"esm_tpu_torch.examples.{name}")
    argv = [a.format(pdb=esmfold_cache) for a in EXAMPLES[name]]
    np.random.seed(0)
    state = example.run(example.create_parser().parse_args(argv), device="cpu")
    out = capsys.readouterr().out
    assert f"best energy: {state.best_energy}" in out
    assert f"best sequence: {state.best_sequence}" in out
    assert state.num_steps == 2 and np.isfinite(state.best_energy)
    assert set(state.best_sequence) <= set("ACDEFGHIKLMNPQRSTVWY")
