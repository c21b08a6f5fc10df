"""The port's pretraining CLI (esm_tpu_torch.cli.pretrain) end to end on the
CPU, at a tiny size (2 layers x 64 wide x 4 heads) over seeded FASTA files
written to tmp_path: bit-exact resume, accumulation with evaluation, saved
parameters, and one step with each of the LoRA flags and --adafactor.
"""

import math
import re

import numpy as np
import pytest
import torch

from esm_tpu_torch.cli import pretrain
from esm_tpu_torch.io.checkpoint import load_params
from esm_tpu_torch.models import esm2


def _fasta(path, n, seed):
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for i in range(n):
            seq = "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), rng.randint(20, 70)))
            f.write(f">seq{i}\n{seq}\n")
    return str(path)


def _run(tmp_path, sub, extra, steps):
    fasta = _fasta(tmp_path / "train.fasta", 24, seed=0)
    args = pretrain.create_parser().parse_args(
        ["--fasta", fasta, "--steps", str(steps), "--num-layers", "2", "--embed-dim", "64",
         "--attention-heads", "4", "--toks-per-batch", "512", "--truncation-seq-length", "62",
         "--log-every", "1", "--warmup-steps", "1", "--cpu",
         "--checkpoint-dir", str(tmp_path / sub / "ckpt")] + extra
    )
    return pretrain.run(args)


def test_resume_is_bit_exact(tmp_path, capsys):
    """3 steps + save + resume for 3 more == 6 uninterrupted steps: identical
    parameters and optimizer state."""
    straight = _run(tmp_path, "a", ["--save-every", "6", "--shuffle"], 6)
    _run(tmp_path, "b", ["--save-every", "3", "--stop-after", "3", "--shuffle"], 6)
    assert "stopping after step 3" in capsys.readouterr().out
    resumed = _run(tmp_path, "b", ["--save-every", "3", "--resume", "--shuffle"], 6)
    out = capsys.readouterr().out
    assert "resumed from" in out and "at step 3" in out
    assert straight.step == resumed.step == 6
    assert straight.opt_state.count == resumed.opt_state.count == 6
    a, b = straight.model.state_dict(), resumed.model.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for k in straight.opt_state.mu:
        assert torch.equal(straight.opt_state.mu[k], resumed.opt_state.mu[k]), k
        assert torch.equal(straight.opt_state.nu[k], resumed.opt_state.nu[k]), k
    assert any(not torch.equal(a[k], v) for k, v in esm2.init(
        straight.model.cfg, torch.Generator().manual_seed(0), device="cpu").state_dict().items())


def test_accum_eval_and_saved_params(tmp_path, capsys):
    eval_fasta = _fasta(tmp_path / "eval.fasta", 10, seed=1)
    state = _run(tmp_path, "c", ["--accum-steps", "2", "--grad-clip", "1.0", "--bf16-moments",
                                 "--eval-fasta", eval_fasta, "--eval-every", "2"], 4)
    out = capsys.readouterr().out
    ppl = [float(x) for x in re.findall(r"eval masked-ppl\s+([0-9.naif]+)", out)]
    assert len(ppl) == 2, out
    assert all(math.isfinite(p) and p > 1 for p in ppl), ppl
    losses = [float(x) for x in re.findall(r"loss\s+([0-9.]+)", out)]
    assert len(losses) == 4 and all(math.isfinite(x) for x in losses)
    assert {m.dtype for m in state.opt_state.mu.values()} == {torch.bfloat16}
    saved = load_params(tmp_path / "c" / "ckpt")
    for k, v in state.model.state_dict().items():
        assert torch.equal(saved[k], v), k


@pytest.mark.parametrize(
    "flag",
    [["--lora", "4"], ["--lora", "4", "--lora-alpha", "8"], ["--lora", "4", "--lora-int8-base"],
     ["--lora", "4", "--lora-full-remat"], ["--adafactor"]],
    ids=lambda f: f[-1] if f[-1].startswith("--") else f[-2],
)
def test_lora_and_adafactor_flags(tmp_path, capsys, flag):
    """Each flag that raised before it was ported runs one step: LoRA trains
    rank-4 adapters only (2 layers x 6 linears) over a bf16 or int8 base and
    saves the merged model or, over int8, the adapters; --adafactor trains
    with adafactor."""
    from esm_tpu_torch import lora, training

    state = _run(tmp_path, "d", flag, 1)
    out = capsys.readouterr().out
    assert state.step == 1 and re.search(r"step\s+1\s+loss\s+[0-9.]+", out), out
    saved = load_params(tmp_path / "d" / "ckpt")
    if "--adafactor" in flag:
        assert isinstance(state.opt_state, training.AdafactorState)
        assert saved.keys() == state.model.state_dict().keys()
        return
    assert isinstance(state.model, lora.LoRA)
    assert lora.num_params(state.model) == 2 * (4 * (64 * 4 + 4 * 64)
                                                + (64 * 4 + 4 * 256) + (256 * 4 + 4 * 64))
    assert "LoRA rank 4" in out
    if "--lora-int8-base" in flag:
        assert "saved LoRA adapters" in out
        assert saved.keys() == state.model.state_dict().keys()
    else:
        assert "saved MERGED params" in out
        merged = esm2.ESM2(esm2.ESM2Config(num_layers=2, embed_dim=64, attention_heads=4))
        merged.load_state_dict(saved, strict=True)
        assert saved["layers.0.fc1.weight"].dtype == torch.bfloat16


def test_resume_without_saved_state_exits(tmp_path):
    with pytest.raises(SystemExit, match="no saved state"):
        _run(tmp_path, "e", ["--resume"], 2)
