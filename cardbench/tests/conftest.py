"""Tiny sizes of the cells added after ``common.py`` was written, registered in ``common.TINY`` before the tests
are collected, so that every test that walks the cells (``test_cardbench_runs.py``) walks them too."""

from cardbench.tests import common

common.TINY.setdefault("hllm-dsv2lite-books.train", {
    "config": {"hidden_size": 64, "num_attention_heads": 4, "kv_lora_rank": 16, "qk_rope_head_dim": 8, "qk_nope_head_dim": 16, "v_head_dim": 16, "intermediate_size": 96,
               "moe_intermediate_size": 32, "n_routed_experts": 4, "n_routed_experts_router": 8, "held_experts_first": 2, "num_experts_per_tok": 2, "num_hidden_layers": 3,
               "vocab_size": 1000, "num_negatives": 32, "max_seq_len": 16},
    "traffic": {"batch": 6, "history_len": 16, "pool_batches": 4},
})
common.TINY.setdefault("hstu-books.train-dp4", {"config": common.TINY_HSTU, "traffic": {"batch": 8, "ranks": 2, "history_len": 32, "pool_batches": 4}})
