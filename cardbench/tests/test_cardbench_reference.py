"""The plain reference against hand-worked cases: the rab attention, one row-wise Adagrad step, a top-k with ties."""

import math

import torch
import torch.nn.functional as F

from cardbench.reference import hstu, optim, topk


MINUTES = {"time_bucket_fn": "sqrt", "time_bucket_divisor": 1.0, "time_bucket_unit": "minutes"}


def test_attention_with_the_rab_bias_by_hand():
    cfg = {"max_seq_len": 2, "num_time_buckets": 4, **MINUTES}
    q = torch.tensor([[[[1.0]], [[2.0]]]])  # (B1, L2, H1, d1)
    k = torch.tensor([[[[0.5]], [[-1.0]]]])
    v = torch.tensor([[[[3.0]], [[5.0]]]])
    pos_w = torch.tensor([[0.1], [0.2], [0.3]])  # index j - i + 1
    ts_w = torch.tensor([[0.0], [0.01], [0.02], [0.03], [0.04]])
    times = torch.tensor([[0, 240]])  # 4 minutes apart: bucket sqrt(4) = 2
    out = hstu.attention(q, k, v, pos_w, ts_w, times, torch.tensor([[True, True]]), cfg)
    silu = lambda x: x / (1 + math.exp(-x))  # noqa: E731
    s00 = 1.0 * 0.5 + 0.2 + 0.0  # i = j = 0: position slot 1, time bucket 0
    s10, s11 = 2.0 * 0.5 + 0.1 + 0.02, 2.0 * -1.0 + 0.2 + 0.0
    expect = [silu(s00) / 2 * 3.0, (silu(s10) * 3.0 + silu(s11) * 5.0) / 2]
    assert torch.allclose(out.reshape(-1), torch.tensor(expect), atol=1e-6)


def test_a_padded_key_is_left_out():
    cfg = {"max_seq_len": 2, "num_time_buckets": 4, **MINUTES}
    q = k = v = torch.ones(1, 2, 1, 1)
    out = hstu.attention(q, k, v, torch.zeros(3, 1), torch.zeros(5, 1), torch.zeros(1, 2, dtype=torch.int64), torch.tensor([[True, False]]), cfg)
    assert out[0, 1, 0, 0] == F.silu(torch.tensor(1.0)) / 2


def test_log_buckets_of_seconds_by_hand():
    cfg = {"time_bucket_fn": "log", "time_bucket_divisor": 0.301, "time_bucket_unit": "seconds"}
    dt = torch.tensor([0, 1, 2, 100, -100, 10**9])
    # log(100) / 0.301 = 15.3; log(2) / 0.301 = 2.3; under a second, bucket 0; 1e9 s cut at 40
    assert hstu.bucketize(dt, cfg, 40).tolist() == [0, 0, 2, 15, 15, 40]


def test_l2_scores_divide_by_the_norm_and_keep_zero_rows():
    cfg = {"score_norm": "l2", "l2_norm_eps": 1e-6}
    rows = hstu.score_rows(torch.tensor([[3.0, 4.0], [0.0, 0.0]]), cfg)
    assert torch.allclose(rows, torch.tensor([[0.6, 0.8], [0.0, 0.0]]))
    assert torch.equal(hstu.score_rows(torch.ones(1, 2), {"score_norm": "none"}), torch.ones(1, 2))


def test_table_rows_gradient_counts_duplicates():
    table = torch.arange(6.0).reshape(3, 2).requires_grad_()
    idx = torch.tensor([[0, 2], [2, 2]])
    hstu.TableRows.apply(table, idx).sum().backward()
    assert table.grad.tolist() == [[1.0, 1.0], [0.0, 0.0], [3.0, 3.0]]


def test_one_rowwise_adagrad_step_by_hand():
    table = torch.ones(3, 2)
    accum = torch.zeros(3)
    g = torch.tensor([[3.0, 4.0], [0.0, 0.0], [1.0, 1.0]])
    optim.rowwise_adagrad_step(table, accum, g, lr=0.5, eps=0.0)
    assert accum.tolist() == [12.5, 0.0, 1.0]
    row0 = 1 - 0.5 / math.sqrt(12.5) * torch.tensor([3.0, 4.0])
    assert torch.allclose(table[0], row0) and table[1].tolist() == [1.0, 1.0] and table[2].tolist() == [0.5, 0.5]


def test_adam_first_step_moves_by_the_learning_rate():
    p, g = torch.tensor([1.0, -2.0]), torch.tensor([0.3, -0.1])
    taken = optim.adam_step(p, g, {}, step=1, lr=1e-3, weight_decay=0.0)
    assert torch.equal(taken, g) and torch.allclose(p, torch.tensor([1.0 - 1e-3, -2.0 + 1e-3]), atol=1e-7)


def test_topk_with_ties_takes_the_lower_id_and_blocks_agree():
    items = torch.tensor([[1.0], [3.0], [2.0], [3.0], [0.5], [3.0]])
    users = torch.tensor([[1.0], [-1.0]])
    for block in (2, 4, 64):
        s, i = topk.topk(users, items, 3, block=block)
        assert i.tolist() == [[1, 3, 5], [4, 0, 2]] and s.tolist() == [[3.0, 3.0, 3.0], [-0.5, -1.0, -2.0]]


def test_scores_of_marks_repeats_and_strangers():
    items = torch.eye(3)
    s = topk.scores_of(torch.tensor([[1.0, 2.0, 3.0]] * 3), items, torch.tensor([[2, 1], [1, 1], [2, 7]]))
    assert s[0].tolist() == [3.0, 2.0] and torch.isinf(s[1]).all() and math.isinf(s[2, 1])
