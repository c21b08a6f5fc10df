"""cli.pretrain on a mesh and examples.esm2_infer_sharded, on gloo ranks on
the CPU (tests/_torch_shard_ranks.py spawns them in a process group, as a
torchrun launch would make one; the CLI joins it).

A 4-rank run on the default mesh (MeshConfig.for_devices(4): tp=4) and on
(2, 2, 1) repeats the one-process run's losses within 1e-5 relative (the
same batches and corruptions; the sums differ only in order; the batches
of (2, 2, 1) are padded to 4 rows, as one process pads them for
--accum-steps 4); stopped,
saved and resumed it repeats its own uninterrupted run bit for bit. The
example's mean-embedding norms on 2 ranks match the unsharded model's
within 1e-2 relative (bf16 compute and storage, as the example runs).
"""

import re

import numpy as np
import pytest
import torch

from _torch_shard_ranks import example_body, pretrain_body, spawn
from esm_tpu_torch import training
from esm_tpu_torch.cli import pretrain

ARGS = ["--num-layers", "2", "--embed-dim", "64", "--attention-heads", "4",
        "--toks-per-batch", "512", "--truncation-seq-length", "62", "--log-every", "1",
        "--warmup-steps", "1", "--cpu", "--shuffle", "--grad-clip", "1.0"]
STEPS = 4


def _fasta(path, n, seed):
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for i in range(n):
            seq = "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), rng.randint(20, 70)))
            f.write(f">seq{i}\n{seq}\n")
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pretrain_mesh")
    fasta = _fasta(tmp / "train.fasta", 24, seed=0)
    eval_fasta = _fasta(tmp / "eval.fasta", 6, seed=1)
    base = ["--fasta", fasta, "--steps", str(STEPS)] + ARGS
    # the one-process runs, their losses recorded around the train step:
    # plain, and with the batch padded to 4 rows as a 4-row-shard mesh pads it
    one = {}
    for name, extra in (("plain", []), ("rows4", ["--accum-steps", "4"])):
        losses, real = [], getattr(training, "train_step_accum" if extra else "train_step")

        def step(*a, _real=real, _losses=losses, **k):
            state, metrics = _real(*a, **k)
            _losses.append(metrics["loss"].item())
            return state, metrics

        setattr(training, real.__name__, step)
        try:
            pretrain.run(pretrain.create_parser().parse_args(base + extra))
        finally:
            setattr(training, real.__name__, real)
        one[name] = losses
    ck = lambda name: ["--checkpoint-dir", str(tmp / name)]  # noqa: E731
    inputs = {"runs": [
        base + ck("a") + ["--eval-fasta", eval_fasta],
        base + ["--data", "2", "--fsdp", "2", "--tp", "1"] + ck("b"),
        base + ck("c") + ["--save-every", "2", "--stop-after", "2"],
        base + ck("c") + ["--resume"],
    ]}
    ranks = spawn(pretrain_body, 4, inputs, tmp)
    return dict(one=one, ranks=ranks)


def test_mesh_run_matches_one_process(runs):
    """The default mesh (tp=4) against the one-process run; (2, 2, 1), whose
    4 row shards pad each batch to a multiple of 4 rows, against the
    one-process run whose --accum-steps 4 pads it alike. The mesh runs draw
    the same weights a layer at a time: they never build the whole model
    (the ranks refuse ``esm2.init``)."""
    for rank, res in enumerate(runs["ranks"]):
        for i, one in ((0, "plain"), (1, "rows4")):
            np.testing.assert_allclose(res["runs"][i]["losses"], runs["one"][one], rtol=1e-5,
                                       err_msg=f"rank {rank} run {i}")
    log = runs["ranks"][0]["runs"][0]["log"]
    assert "mesh: data=1 fsdp=1 tp=4" in log
    assert re.search(r"memory plan \(est\. B=\d+\): [0-9.]+ GB/rank of [0-9.]+ -> fits", log), log
    assert len(re.findall(r"eval masked-ppl", log)) == 1
    assert "mesh: data=2 fsdp=2 tp=1" in runs["ranks"][0]["runs"][1]["log"]
    assert runs["ranks"][1]["runs"][0]["log"] == ""  # rank 0 logs


def test_mesh_resume_is_bit_exact(runs):
    for rank, res in enumerate(runs["ranks"]):
        straight, resumed = res["runs"][0]["params"], res["runs"][3]["params"]
        assert "resumed from" in res["runs"][3]["log"] or rank
        assert straight.keys() == resumed.keys()
        for name in straight:
            assert torch.equal(straight[name], resumed[name]), (rank, name)
        assert res["runs"][2]["losses"] + res["runs"][3]["losses"] == res["runs"][0]["losses"]


def test_esm2_infer_sharded_on_two_ranks(tmp_path):
    from esm_tpu_torch.examples.esm2_15b_int8_single_chip import seeded_parts
    from esm_tpu_torch.examples.esm2_infer_sharded import DATA
    from esm_tpu_torch.lora import store_base
    from esm_tpu_torch.models import esm2
    from esm_tpu_torch.pretrained import _esm2_alphabet

    argv = ["--random-seed", "0", "--model", "esm2_t6_8M_UR50D", "--cpu"]
    ranks = spawn(example_body, 2, {"argv": argv}, tmp_path)
    log = ranks[0]["log"]
    assert "mesh: {'data': 1, 'fsdp': 1, 'tp': 2}" in log
    got = [float(x) for x in re.findall(r"mean embedding norm: ([0-9.]+)", log)]
    parts = seeded_parts("esm2_t6_8M_UR50D", 0, "cpu")
    cfg, model = next(parts)
    for layer in parts:
        model.layers.append(layer)
    store_base(model)  # the example's bf16 storage
    alphabet = _esm2_alphabet()
    toks = alphabet.get_batch_converter(pad_to_multiple=128)(DATA)[2]
    with torch.no_grad():
        reps = esm2.apply(model, cfg, toks, repr_layers=[cfg.num_layers])["representations"]
    want = [float(torch.linalg.norm(reps[cfg.num_layers][i, 1:len(s) + 1].float().mean(0)))
            for i, (_, s) in enumerate(DATA)]
    np.testing.assert_allclose(got, want, rtol=1e-2)
