"""Tiny sizes of the cells, for runs of the harness on the CPU."""

TINY_HSTU = {"vocab_size": 1000, "d_model": 32, "n_heads": 2, "dqk": 8, "dv": 8, "n_layers": 2, "max_seq_len": 32, "num_negatives": 64}
TINY = {
    "hstu-books.train": {"config": TINY_HSTU, "traffic": {"batch": 4, "history_len": 32, "pool_batches": 4}},
    "deepfm-criteo.train": {"config": {"cardinalities": [1000, 50, 600, 20], "n_dense": 3, "mlp_dims": [32, 16], "table_layout": True, "sparse_min_rows": 0},
                            "traffic": {"batch": 256, "pool_batches": 4}},
    "hstu-books.serve": {"config": TINY_HSTU, "traffic": {"batch": 4, "history_len": 32, "pool_batches": 4, "top_k": 10, "checked_requests": 3}},
}
