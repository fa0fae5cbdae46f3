"""The frozen bound arithmetic gives the kernel table's bounds, and the step counts add up by hand."""

import pytest
import torch

from cardbench.counts import attention, peaks, steps


def test_k1_and_k2_bounds_at_the_table_shape():
    shape = dict(b=8, h=8, l=256, dqk=32, dv=32, max_seq_len=256, num_buckets=128)
    k1, k2 = attention.rab_bound(**shape), attention.bwd_bound(**shape)
    assert round(k1["bound_ms"], 4) == 0.0025 and k1["bound_by"] == "bytes"
    assert round(k2["bound_ms"], 4) == 0.0044 and k2["bound_by"] == "bytes"


def test_valid_pairs_by_hand():
    assert attention.valid_pairs(1, 1, 3) == 6  # 1 + 2 + 3
    assert attention.valid_pairs(1, 2, 4, lengths=[2]) == 2 * (1 + 2 + 2 + 2)


def test_operation_bound_uses_three_tf32_passes():
    b = attention.both_bounds(1e12, 1.0)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(3e12 / peaks.PEAK_TF32_FLOPS * 1e3)
    assert peaks.PEAK_FP32_ACCURATE_FLOPS == pytest.approx(164.9e12)


def test_mask_pairs_count_as_valid_pairs_whatever_the_padding():
    suffix = torch.tensor([[[True, True, False, False]]])
    prefix = torch.tensor([[[False, False, True, True]]])
    assert attention.mask_pairs(suffix) == [attention.valid_pairs(1, 1, 4, lengths=[2])] == [7]
    assert attention.mask_pairs(prefix) == [3]  # 1 + 2: a PAD query sees no key
    assert attention.mask_pairs(torch.ones(2, 3, 5, dtype=torch.bool)) == [attention.valid_pairs(3, 1, 5)] * 2


def test_hstu_step_flops_by_hand():
    cfg = dict(d_model=64, n_heads=8, dqk=8, dv=8, n_layers=16, num_negatives=512, vocab_size=686625)
    tokens, pairs = 1800, 20000
    layers = 16 * (2 * tokens * 64 * 256 + 2 * tokens * 64 * 64 + 2 * 8 * pairs * 16)
    assert steps.hstu_forward_flops(cfg, tokens, pairs) == layers
    assert steps.hstu_train_step_flops(cfg, tokens, pairs) == 3 * (layers + 2 * tokens * 64 * 513)
    assert steps.hstu_serve_request_flops(cfg, 128, tokens, pairs) == layers + 2 * 128 * 686625 * 64


def test_deepfm_example_flops():
    cfg = dict(cardinalities=[10] * 26, n_dense=13, embed_dim=16, mlp_dims=[256, 128])
    assert steps.deepfm_example_flops(cfg) == 6 * (429 * 256 + 256 * 128 + 128 + 416)
