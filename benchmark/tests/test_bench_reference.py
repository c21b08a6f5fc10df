"""The plain references against the port at tiny widths and depths in
float32, on the benchmark's own seeded weights: both must compute the same
function, so that on the card only precision and kernels tell them apart."""

import torch

from benchmark import harness
from benchmark.families import esm2 as esm2_family
from benchmark.families import esmfold as fold_family
from benchmark.reference import esm2 as ref_esm2
from benchmark.reference import esmfold as ref_fold
from benchmark.tests.tiny import CELLS

FP32 = {"compute_dtype": "float32", "use_flash": False}


def _config(name, over):
    return harness.cell(name, 0, "cpu", overrides={"config": over}).config


def test_esm2_reference_matches_the_port():
    cfg = _config("esm2_650m.embed", dict(CELLS["esm2_650m.embed"]["config"], **FP32))
    w = esm2_family.weights(cfg, 11, "cpu")
    handle = esm2_family.program(cfg, w, "cpu")
    seqs = ["MKTAYIAKQR", "GAVLIPFW", "ACDEFGHIKLMNPQRSTVWYAC"]
    tokens = ref_esm2.tokenize(seqs)
    _, _, port_tokens = handle.alphabet.get_batch_converter()([("a", s) for s in seqs])
    assert torch.equal(tokens, port_tokens)
    tokens[0, 3] = ref_esm2.MASK  # the mask-token rescale
    got = handle(tokens, repr_layers=(cfg["num_layers"],))
    want = ref_esm2.forward(w, cfg, tokens)
    real = tokens != ref_esm2.PAD
    torch.testing.assert_close(got["representations"][cfg["num_layers"]][real],
                               want["final"][real], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got["logits"][real], want["logits"][real], rtol=1e-5, atol=1e-4)


def test_esm2_training_reference_matches_the_port():
    """The train driver's three steps, the port in fp32 with exact attention,
    against the reference's: the same losses, gradients and changes."""
    tiny = dict(CELLS["esm2_650m.train"], config=dict(CELLS["esm2_650m.train"]["config"], **FP32))
    c = harness.cell("esm2_650m.train", 5, "cpu", overrides=tiny)
    d = harness.driver(c)
    d.setup()
    d.release()
    values = d.check()
    assert values["train_loss_gap"] < 1e-5
    assert values["train_grad_gap"] < 1e-4
    assert values["train_change_gap"] < 1e-3


def test_esmfold_reference_matches_the_port():
    over = CELLS["esmfold_v1.fold512"]["config"]
    over = dict(over, esm=dict(over["esm"], **FP32),
                trunk=dict(over["trunk"], compute_dtype="float32", use_flash_tri=False))
    cfg = _config("esmfold_v1.fold512", over)
    w = fold_family.weights(cfg, 13, "cpu")
    handle = fold_family.program(cfg, w, "cpu")
    seq = "MKTAYIAKQRQISFVKSHFSRQ"
    got = handle.infer([seq])
    want = ref_fold.fold(w, cfg, [seq])[0]
    torch.testing.assert_close(got["positions"][-1][0], want["positions"], rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(got["plddt"][0], want["plddt"], rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(got["ptm"][0], want["ptm"], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got["mean_plddt"][0], want["mean_plddt"], rtol=1e-4, atol=1e-3)
    # the trunk does work: the drawn residual branches move the pair state
    assert want["positions"].abs().max() > 1.0
