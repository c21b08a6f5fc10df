"""The yardstick's arithmetic: the kernel bounds reproduce the port's kernel
table (PERF.md §6), and the models' matrix-product counts match totals
worked out by hand."""

import json

import pytest

from benchmark import harness
from benchmark.counts import attention, models

ESM2 = harness.read_json(harness.ROOT / "benchmark" / "configs" / "esm2_t33_650M.json")
FOLD = harness.read_json(harness.ROOT / "benchmark" / "configs" / "esmfold_v1.json")


@pytest.mark.parametrize("kernel, shape, ms", [
    ("k1", (32, 20, 1024, 1024, 64), 0.1737),   # K1 at the bench shape: operations
    ("k2", (8, 20, 1024, 1024, 64), 0.1086),    # K2 at B=8: operations
    ("k6", (1, 1000, 1000, 4, 32), 0.5177),     # K6 at I=J=1000: operations
    ("k6", (1, 512, 512, 4, 32), 0.0817),       # K6 at I=J=512: bytes
])
def test_kernel_bounds(kernel, shape, ms):
    got = attention.bound_s(*getattr(attention, kernel)(*shape)) * 1e3
    assert round(got, 4) == ms


def test_k6_bytes_bound_at_1000():
    flops, nbytes = attention.k6(1, 1000, 1000, 4, 32)
    assert round(nbytes / 3.35e12 * 1e3, 4) == 0.3116


def test_esm2_counts_by_hand():
    # one layer at n tokens: 12·d² multiply-adds a token in the projections
    # and the FFN, 2·n·d more in q·kᵀ and p·v
    d, n = 1280, 1024
    layer = 2 * (12 * d * d * n) + 2 * (2 * n * n * d)
    assert models.esm2_layers(ESM2, n) == 33 * layer == 1_505_922_908_160
    head = 2 * n * (d * d + d * 33)
    assert models.esm2_train_step(ESM2, 32, n) == 3 * 32 * (33 * layer + head)
    assert models.esm2_train_step(ESM2, 32, n) == 144_899_026_452_480
    assert models.esm2_embed(ESM2, [300, 700]) == (models.esm2_layers(ESM2, 300)
                                                   + models.esm2_layers(ESM2, 700))


def test_esmfold_count_by_hand():
    """ESMFold v1 at L=512, summed op by op from the published widths."""
    L, P, cs, cz, d = 512, 512 * 512, 1024, 128, 2560
    lz = 2 * P * cz * cz
    block = sum([
        2 * P * cz * 32,                          # pair -> sequence bias, 32 heads
        2 * L * cs * 3 * cs,                      # gated attention: q, k, v
        2 * P * cs * 2,                           # q·kᵀ and p·v over every head
        2 * L * cs * cs * 2,                      # gate, output
        2 * L * cs * 4 * cs * 2,                  # sequence MLP
        2 * L * cs * cz, lz,                      # sequence -> pair
        2 * (6 * lz + 2 * L * P * cz),            # tri-mul out and in
        2 * (2 * P * cz * 4 + 5 * lz + 2 * 2 * L * P * cz),  # tri-att start and end
        2 * 2 * P * cz * 4 * cz,                  # pair MLP
    ])
    ipa = (2 * L * 384 * (12 * 16 * 3 + 12 * 16 * 3) + 2 * P * 128 * 12 + 2 * P * 12 * 16 * 2
           + 2 * P * 12 * (4 + 8) * 3 + 2 * P * 12 * 128 + 2 * L * 12 * (128 + 16 + 32) * 384)
    sm_block = ipa + 3 * 2 * L * 384 * 384 + 2 * L * 384 * 6 + 2 * L * (
        2 * 384 * 128 + 4 * 128 * 128 + 128 * 14)
    per_pass = 48 * block + 2 * L * cs * 384 + 2 * P * cz * 128 + 2 * L * 384 * 384 \
        + 8 * sm_block
    heads = 2 * 2 * P * cz * 64 + 2 * L * 384 * 128 * 2 + 2 * L * 128 * 37 * 50
    lm = models.esm2_layers(FOLD["esm"], L + 2) + 2 * L * d * cs + 2 * L * cs * cs
    assert models.esmfold_fold(FOLD, L) == lm + 4 * per_pass + heads
    assert 90e12 < models.esmfold_fold(FOLD, L) < 100e12


def test_config_widths_are_published():
    assert (ESM2["num_layers"], ESM2["embed_dim"], ESM2["attention_heads"],
            ESM2["ffn_embed_dim"]) == (33, 1280, 20, 5120)
    lm, tc, sm = FOLD["esm"], FOLD["trunk"], FOLD["structure_module"]
    assert (lm["num_layers"], lm["embed_dim"], lm["attention_heads"]) == (36, 2560, 40)
    assert (tc["num_blocks"], tc["sequence_state_dim"], tc["pairwise_state_dim"],
            tc["sequence_head_width"], tc["pairwise_head_width"], tc["position_bins"]) == (
        48, 1024, 128, 32, 32, 32)
    assert sm["no_blocks"] == 8
    assert json.dumps(FOLD)  # plain JSON
