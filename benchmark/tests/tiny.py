"""Each cell cut to a size the CPU runs in seconds: the same files, drivers
and checks, with the widths, depths and traffic shrunk."""

CELLS = {
    "esm2_650m.embed": {
        "config": {"num_layers": 2, "embed_dim": 64, "attention_heads": 4},
        "traffic": {"sequences": 48, "median_length": 30, "min_length": 5, "max_length": 60,
                    "toks_per_batch": 512, "truncation_seq_length": 60},
        "workload": {"check": {"sample": 8, "rows": 4}, "trace": {"from_item": 1, "items": 2}}},
    "esm2_650m.train": {
        "config": {"num_layers": 2, "embed_dim": 64, "attention_heads": 4},
        "traffic": {"batch": 4, "length": 32, "reference_rows": 2},
        "workload": {"trace": {"from_item": 1, "items": 2}}},
    "esmfold_v1.fold512": {
        "config": {"esm": {"num_layers": 2, "embed_dim": 64, "attention_heads": 4},
                   "trunk": {"num_blocks": 2, "sequence_state_dim": 64, "pairwise_state_dim": 32,
                             "sequence_head_width": 16, "pairwise_head_width": 16},
                   "structure_module": {"c_s": 32, "c_z": 32, "c_ipa": 8, "c_resnet": 16,
                                        "no_heads_ipa": 2, "no_blocks": 2},
                   "lddt_head_hid_dim": 16},
        "traffic": {"length": 20}},
}
