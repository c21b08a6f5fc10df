"""The check catches what it is there to catch. At a tiny size on the CPU,
with each cell's committed limits:

  * the cell's control (``workloads/<cell>.json``: the plain reference one
    step below the stated precision) reads above the program on the same
    seed;
  * a run with the timed path broken underneath comes out not correct, once
    for each fault the cell can have: an answer altered where it is
    produced; for training, a step that leaves the state unchanged and a
    step that takes the mean over half of the batch.
The readings at the cells' own sizes, on the card, are in PERF.md."""

import contextlib

import pytest
import torch

from benchmark import harness
from benchmark.tests.tiny import CELLS

SEED = 2 ** 31 + 101


def _run(name, variant="program"):
    result, _, values = harness.run_cell(name, SEED, 0.3, False, device="cpu",
                                         variant=variant, overrides=CELLS[name])
    return result, values


@pytest.mark.parametrize("name", sorted(CELLS))
def test_control_reads_above_the_program(name):
    _, program = _run(name)
    _, control = _run(name, harness.cell(name, 0, "cpu").workload["control"])
    limits = harness.cell(name, 0, "cpu").workload["limits"]
    # the control has to fail one of the cell's numbers, not each (on the CPU
    # the structure module's TF32 is plain float32)
    assert any(control[k] > 2 * program[k] for k in limits), (program, control)


@contextlib.contextmanager
def patched(obj, attr, make):
    old = getattr(obj, attr)
    setattr(obj, attr, make(old))
    try:
        yield
    finally:
        setattr(obj, attr, old)


def _altered_embedding(old):
    def call(self, tokens, *a, **kw):
        out = old(self, tokens, *a, **kw)
        reps = out["representations"]
        for k in reps:  # the last layer's features, rolled: an answer altered
            reps[k] = reps[k].roll(1, dims=-1)
        return out
    return call


def _altered_fold(old):
    def infer(model, cfg, sequences, **kw):
        out = old(model, cfg, sequences, **kw)
        out["positions"] = out["positions"].flip(-3)  # residue i placed as L-1-i
        return out
    return infer


def test_embed_answer_altered():
    from esm_tpu_torch import pretrained

    with patched(pretrained.LMHandle, "__call__", _altered_embedding):
        result, _ = _run("esm2_650m.embed")
    assert result["correct"] is False


def test_fold_answer_altered():
    from esm_tpu_torch.models.esmfold import esmfold

    with patched(esmfold, "infer", _altered_fold):
        result, _ = _run("esmfold_v1.fold512")
    assert result["correct"] is False


def test_train_state_unchanged():
    from esm_tpu_torch import training

    with patched(training.AdamW, "update", lambda old: lambda self, model, state: None):
        result, values = _run("esm2_650m.train")
    assert values["train_change_gap"] == pytest.approx(1.0)
    assert result["correct"] is False


def test_train_half_batch():
    from esm_tpu_torch import training

    def half(old):
        def step(state, cfg, tx, corrupted, targets, target_mask, **kw):
            b = corrupted.shape[0] // 2
            return old(state, cfg, tx, corrupted[:b], targets[:b], target_mask[:b], **kw)
        return step

    with patched(training, "train_step_corrupted", half):
        result, _ = _run("esm2_650m.train")
    assert result["correct"] is False


def test_faults_leave_the_port_as_it_was():
    from esm_tpu_torch import pretrained, training
    from esm_tpu_torch.models.esmfold import esmfold

    assert pretrained.LMHandle.__call__.__name__ == "__call__"
    assert training.train_step_corrupted.__name__ == "train_step_corrupted"
    assert esmfold.infer.__name__ == "infer"
    assert torch.is_grad_enabled()
