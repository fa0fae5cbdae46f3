"""HLLM's user model on DeepSeek-V2's block (``HLLMModel(backbone="deepseek_v2")``) against its plain reference.

At tiny widths (d 64, 4 heads, kv_lora 16, rope 8, nope 16, v 16, 8 routed
experts, top 2, a layer holding 4 of them), on the CPU, in float32, the
program (``basic/mla.py``, ``basic/moe.py`` through ``SeqTrainer`` with the
sampled softmax) is compared with
``torch_rechub_tpu_torch/reference/hllm_deepseek_v2.py``: the forward's
logits, the loss and the balance loss, every leaf's gradient and one Adam
step.  The two compute the same sums in different orders (the program sorts
the expert pairs and scatters them back, the reference masks rows), so
they differ by float32 rounding alone: relative 1e-5 on values of order
one, and on gradients 1e-5 of each leaf's largest entry, against rounding
errors near 1e-7 at these sizes and gaps of order one from any wrong
term.  The program's routing is handed to the reference, which takes it
only at near-ties and here takes none.

Also: the share test (two layers holding complementary halves of the
experts, the shared experts counted once, add up to the uncut layer),
padding (routed to no expert, no effect on valid positions), the tie rule of
the reference, the spans and counters, and the collectives' span.
"""

import copy

import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from torch_rechub_tpu_torch.basic.mla import MLA
from torch_rechub_tpu_torch.basic.moe import MoE
from torch_rechub_tpu_torch.models.generative import HLLMModel
from torch_rechub_tpu_torch.models.generative.hllm import DeepseekV2Block
from torch_rechub_tpu_torch.parallel import distributed as pdist
from torch_rechub_tpu_torch.reference import hllm_deepseek_v2 as ref
from torch_rechub_tpu_torch.trainers import SeqTrainer
from torch_rechub_tpu_torch.utils import profiling

YARN = {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707, "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096, "type": "yarn"}
CFG = dict(hidden_size=64, num_attention_heads=4, kv_lora_rank=16, qk_rope_head_dim=8, qk_nope_head_dim=16, v_head_dim=16, q_lora_rank=None, rms_norm_eps=1e-6, rope_theta=10000,
           rope_scaling=YARN, first_k_dense_replace=1, num_hidden_layers=3, intermediate_size=96, moe_intermediate_size=32, n_routed_experts=8, held_experts=[2, 4],
           num_experts_per_tok=2, n_shared_experts=2, aux_loss_alpha=0.001, routed_scaling_factor=1.0, norm_topk_prob=False, seq_aux=True, topk_method="greedy", scoring_func="softmax", moe_layer_freq=1)
LOSS = {"temperature": 0.05, "num_negatives": 16, "remove_accidental_hits": True, "logq_correction": False, "lr": 1e-3, "weight_decay": 0.0}
V, B, L, SEED = 100, 4, 10, 5
RTOL = 1e-5


def table():
    return torch.randn(V, CFG["hidden_size"], generator=torch.Generator().manual_seed(0))


def build():
    model = HLLMModel(table(), V, d_model=64, max_seq_len=L, temperature=LOSS["temperature"], generator=torch.Generator().manual_seed(1), backbone="deepseek_v2", backbone_config=CFG)
    trainer = SeqTrainer(model, optimizer_params={"lr": LOSS["lr"], "weight_decay": 0.0}, loss_type="sampled_softmax",
                         loss_params={k: LOSS[k] for k in ("num_negatives", "remove_accidental_hits", "logq_correction")}, seed=SEED, device="cpu")
    return model, trainer


def batch():
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(1, V, (B, L), generator=g)
    tokens[0, :4] = 0  # left-padded histories
    tokens[1, :7] = 0
    return tokens, torch.zeros(B, L, dtype=torch.int32), torch.randint(1, V, (B,), generator=g)


def routes(model):
    return [m.last_topk for m in model.modules() if isinstance(m, MoE)]


def reference_step(weights, tokens, targets, given):
    """The reference's loss, balance loss and gradients of one step from ``weights``."""
    params = {n: t.clone().requires_grad_() for n, t in weights.items()}
    tab = ref.normalised_table(table())
    hidden, auxes, substituted, refused = ref.user_states(params, tab, tokens, {**CFG, **LOSS}, given)
    negs = ref.negatives(torch.Generator().manual_seed(SEED), V, LOSS["num_negatives"], "cpu")
    loss = ref.sampled_softmax_loss(hidden, tab, tokens, targets, negs, {**CFG, **LOSS})
    balance = torch.stack(auxes).sum()
    grads = dict(zip(params, torch.autograd.grad(loss + balance, list(params.values()))))
    return float(loss), float(balance), grads, substituted, refused


@pytest.fixture(scope="module")
def step():
    model, trainer = build()
    weights = {n: p.detach().clone() for n, p in model.named_parameters()}
    tokens, times, targets = batch()
    model.train()
    loss = trainer.loss_fn(tokens, times, targets)
    loss.backward()
    return {"model": model, "weights": weights, "loss": float(loss.detach()), "balance": float(model.balance_loss()), "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "reference": reference_step(weights, tokens, targets, routes(model))}


def test_forward_logits_match_the_reference():
    model, _ = build()
    tokens, times, _ = batch()
    model.eval()
    with torch.no_grad():
        logits = model(tokens, times)
        hidden, _, substituted, _ = ref.user_states({n: p.detach() for n, p in model.named_parameters()}, ref.normalised_table(table()), tokens, {**CFG, **LOSS}, routes(model))
    expected = hidden @ ref.normalised_table(table()).t() / LOSS["temperature"]
    assert logits.shape == (B, L, V) and torch.isfinite(logits).all() and substituted == 0
    torch.testing.assert_close(logits, expected, rtol=RTOL, atol=RTOL * float(expected.abs().max()))


def test_loss_and_balance_loss_match_the_reference(step):
    loss, balance, _, substituted, refused = step["reference"]
    assert (substituted, refused) == (0, 0) and balance > 0
    assert step["loss"] == pytest.approx(loss, rel=RTOL) and step["balance"] == pytest.approx(balance, rel=RTOL)


LEAVES = sorted(n for n, _ in build()[0].named_parameters())


@pytest.mark.parametrize("leaf", LEAVES)
def test_every_leaf_gradient_matches_the_reference(step, leaf):
    got, expected = step["grads"][leaf], step["reference"][2][leaf]
    assert float(expected.abs().max()) > 0
    torch.testing.assert_close(got, expected, rtol=RTOL, atol=RTOL * float(expected.abs().max()))


def test_one_adam_step_matches_the_reference():
    model, trainer = build()
    weights = {n: p.detach().clone() for n, p in model.named_parameters()}
    tokens, times, targets = batch()
    loss = trainer.train_step(tokens, times, targets)
    given = [routes(model)]
    out = ref.train(weights, ref.normalised_table(table()), [{"tokens": tokens, "targets": targets}], {**CFG, **LOSS}, torch.Generator().manual_seed(SEED), given)
    assert float(loss) == pytest.approx(out["losses"][0], rel=RTOL) and out["substituted"] == 0
    # Adam's first step moves every element by lr * g / (|g| + eps), about lr: a gradient's rounding moves that by
    # a millionth of lr, or by up to a few thousandths where |g| is near eps (1e-8) and the rounding is relatively
    # large; a wrong gradient moves it by up to 2 lr
    for n, p in model.named_parameters():
        torch.testing.assert_close(p.detach(), weights[n], rtol=0, atol=LOSS["lr"] * 1e-2)


def test_the_shares_add_up_to_the_uncut_layer():
    """Two layers that hold experts 0-3 and 4-7 of 8: their outputs, the shared experts counted once, are the
    uncut reference's whole layer."""
    torch.manual_seed(0)
    full = MoE(64, 32, 8, 8, 0, 2, 2, 0.0, generator=torch.Generator().manual_seed(7))
    halves = []
    for first in (0, 4):
        part = MoE(64, 32, 8, 4, first, 2, 2, 0.0)
        with torch.no_grad():
            part.gate.weight.copy_(full.gate.weight)
            for name in ("experts_gate_proj", "experts_up_proj", "experts_down_proj"):
                getattr(part, name).copy_(getattr(full, name)[first:first + 4])
            part.shared_experts.load_state_dict(full.shared_experts.state_dict())
        halves.append(part.eval())
    x = torch.randn(3, 5, 64, generator=torch.Generator().manual_seed(8))
    valid = torch.ones(3, 5, dtype=torch.bool)
    with torch.no_grad():
        y0, y1 = halves[0](x, valid), halves[1](x, valid)
        shared = full.shared_experts(x)
        w = {"mlp." + n: p.detach() for n, p in full.named_parameters()}
        whole, _, _, _ = ref.expert_layer(w, "mlp.", x, valid, {**CFG, "held_experts": [0, 8], "n_routed_experts": 8})
    torch.testing.assert_close(y0 + y1 - shared, whole, rtol=RTOL, atol=RTOL * float(whole.abs().max()))


def test_padding_takes_no_expert_and_leaves_valid_positions_alone():
    block = DeepseekV2Block({**CFG, "first_k_dense_replace": 0}, 0, torch.Generator().manual_seed(2)).train()
    x = torch.randn(2, L, 64, generator=torch.Generator().manual_seed(4))
    valid = torch.arange(L)[None, :] >= torch.tensor([[3], [6]])
    other = torch.where(valid[..., None], x, 10 * torch.randn(x.shape, generator=torch.Generator().manual_seed(5)))
    profiling.clear_spans()
    y = block(x, valid)
    pairs = profiling.counters()["rechub.moe.routed_pairs"]
    y_other = block(other, valid)
    held = (block.mlp.last_topk >= 2) & (block.mlp.last_topk < 6)
    assert pairs == int((held & valid.reshape(-1)[:, None]).sum())  # padding routed to no expert
    assert torch.isfinite(y).all()
    torch.testing.assert_close(y[valid], y_other[valid], rtol=0, atol=0)
    profiling.clear_spans()


def test_a_padding_query_gives_zero_and_no_nan():
    attn = MLA(CFG, torch.Generator().manual_seed(6))
    x = torch.randn(1, L, 64, requires_grad=True)
    valid = torch.arange(L)[None, :] >= 5
    (attn.o_proj.weight.new_ones(()) * 0 + attn(x, valid).sum()).backward()
    out = attn(x, valid)
    assert torch.isfinite(x.grad).all() and torch.equal(out[0, :5], torch.zeros(5, 64))


def test_a_near_tie_is_substituted_and_counted_and_a_far_one_refused():
    logits = torch.tensor([[3.0, 2.0, 1.0, 1.0 - ref.ROUTING_TIE_MARGIN / 2, 0.0], [3.0, 2.0, 1.0, 0.5, 0.0]])
    valid = torch.tensor([True, True])
    given = torch.tensor([[0, 1, 3], [0, 1, 3]])
    ids, substituted, refused = ref.route(logits, 3, valid, given)
    assert (substituted, refused) == (1, 1)
    assert sorted(ids[0].tolist()) == [0, 1, 3] and sorted(ids[1].tolist()) == [0, 1, 2]
    repeated = torch.tensor([[0, 1, 1], [0, 1, 1]])  # a choice that repeats an expert is no top 3; padding rows do not count
    assert ref.route(logits, 3, torch.tensor([True, False]), repeated)[1:] == (0, 1)


def test_the_default_backbone_is_unchanged():
    """Today's HLLM: its parameters, in order, and no expert or latent attention among them."""
    model = HLLMModel(table().numpy(), V, d_model=64, n_heads=4, n_layers=2, max_seq_len=L, generator=torch.Generator().manual_seed(1))
    again = HLLMModel(table().numpy(), V, d_model=64, n_heads=4, n_layers=2, max_seq_len=L, generator=torch.Generator().manual_seed(1), backbone="transformer")
    names = [n for n, _ in model.named_parameters()]
    assert names[:2] == ["position_embedding", "time_embedding"] and all(n.startswith(("position", "time", "rel_pos_bias", "block_")) for n in names)
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(), again.state_dict().values()))


def test_the_expert_model_declares_its_step_unsafe_to_capture():
    model, _ = build()
    assert any(getattr(m, "graph_safe", True) is False for m in model.modules())
    assert all(getattr(m, "graph_safe", True) for m in HLLMModel(table().numpy(), V, d_model=64, n_heads=4, n_layers=1, max_seq_len=L).modules())


STAGES = {"rechub.mla.attention", "rechub.mla.attention.bwd", "rechub.moe.route", "rechub.moe.dispatch", "rechub.moe.experts", "rechub.moe.experts.bwd", "rechub.moe.dispatch.bwd"}


def test_spans_open_under_a_profiler_and_cost_nothing_without():
    model, trainer = build()
    tokens, times, targets = batch()
    profiling.clear_spans()
    trainer.train_step(tokens, times, targets)
    assert profiling.spans() == []  # no profiler: no span recorded
    counted = profiling.counters()
    assert counted["rechub.moe.routed_pairs"] > 0 and 0 < counted["rechub.moe.max_expert_pairs"] <= counted["rechub.moe.routed_pairs"]
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_step(tokens, times, targets)
    record = profiling.spans()
    names = {s[0] for s in record}
    assert STAGES <= names and STAGES <= {e.name for e in prof.events()}
    steps = [i for i, s in enumerate(record) if s[0] == "rechub.train_step"]
    forward = [s for s in record if s[0] == "rechub.moe.route"]
    assert len(steps) == 1 and len(forward) == 2  # two expert layers
    profiling.clear_spans()


def test_the_latent_attention_backward_is_one_closed_span_a_layer_holding_no_other_layer():
    """``rechub.mla.attention.bwd`` opens at each layer's output gradient and closes after its input's, the first
    layer's too, whose input (the frozen item table's rows) takes no gradient; no expert layer's backward falls
    inside one."""
    model, trainer = build()
    tokens, times, targets = batch()
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        trainer.train_step(tokens, times, targets)
    record = profiling.spans()
    profiling.clear_spans()
    forward = [s for s in record if s[0] == "rechub.mla.attention"]
    backward = [s for s in record if s[0] == "rechub.mla.attention.bwd"]
    assert len(backward) == len(forward) == sum(isinstance(m, MLA) for m in model.modules()) and all(s[3] is not None for s in backward)
    others = [s[2] for s in record if s[0] in ("rechub.moe.experts.bwd", "rechub.moe.dispatch.bwd")]
    assert others and not any(lo < t < hi for _, _, lo, hi in backward for t in others)
    assert all(b[2] > f[3] for f in forward for b in backward)


def test_the_collectives_open_their_spans_and_count_calls_and_bytes(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0, world_size=1)
    try:
        group = dist.group.WORLD
        p = torch.nn.Parameter(torch.ones(3))
        p.grad = torch.full((3,), 2.0)
        profiling.clear_spans()
        with profile(activities=[ProfilerActivity.CPU]):
            pdist.all_reduce_gradients([p], group)
            gathered = pdist.all_gather(torch.arange(4), group)
        names = [s[0] for s in profiling.spans()]
        counted = profiling.counters()
        assert "rechub.dist.all_reduce" in names and "rechub.dist.all_gather" in names
        assert counted["rechub.dist.calls"] == 2 and counted["rechub.dist.bytes"] == 3 * 4 + 4 * 8
        assert torch.equal(p.grad, torch.full((3,), 2.0)) and torch.equal(gathered, torch.arange(4))
    finally:
        dist.destroy_process_group()
        profiling.clear_spans()


def test_the_reference_leaves_tf32_as_it_found_it():
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        model, _ = build()
        w = {n: p.detach().clone() for n, p in model.named_parameters()}
        tokens, _, targets = batch()
        ref.train(copy.deepcopy(w), ref.normalised_table(table()), [{"tokens": tokens, "targets": targets}], {**CFG, **LOSS}, torch.Generator().manual_seed(SEED))
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
