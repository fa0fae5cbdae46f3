"""HLLM's user model on DeepSeek-V2's block on the card: the trainer runs its steps eagerly, and its first step
agrees with the plain reference run on the card.

These tests need a CUDA device and skip without one.  They import torch only:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_hllm_moe.py

The expert layers read their per-expert counts on the host, so the model
declares its step unsafe to capture as a CUDA graph, and every step on the
card runs eagerly (``rechub.train.graph.eager``), none captured or refused.
The first step is compared with ``reference/hllm_deepseek_v2.py`` on the
same card, its negatives drawn from a generator on the card seeded as the
trainer's and its routing handed the program's: the loss to ``REL``, and
the gradient each leaf's Adam took (its first moment over ``1 - beta1``)
to ``REL`` of that leaf's largest reference entry.  The two sum in other
orders, so they differ by float32 rounding (about 1e-7 of a value here);
a wrong term moves a value by its own size.
"""

import pytest
import torch

from torch_rechub_tpu_torch.basic.moe import MoE
from torch_rechub_tpu_torch.models.generative import HLLMModel
from torch_rechub_tpu_torch.reference import hllm_deepseek_v2 as ref
from torch_rechub_tpu_torch.trainers import SeqTrainer
from torch_rechub_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

YARN = {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707, "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096, "type": "yarn"}
CFG = dict(hidden_size=128, num_attention_heads=4, kv_lora_rank=32, qk_rope_head_dim=16, qk_nope_head_dim=32, v_head_dim=32, q_lora_rank=None, rms_norm_eps=1e-6, rope_theta=10000,
           rope_scaling=YARN, first_k_dense_replace=1, num_hidden_layers=3, intermediate_size=256, moe_intermediate_size=64, n_routed_experts=16, held_experts=[4, 8],
           num_experts_per_tok=4, n_shared_experts=2, aux_loss_alpha=0.001, routed_scaling_factor=1.0, norm_topk_prob=False, seq_aux=True, topk_method="greedy", scoring_func="softmax", moe_layer_freq=1)
V, B, L = 500, 16, 20
REL = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = old


def batches(device, steps):
    g = torch.Generator().manual_seed(2)
    for _ in range(steps):
        tokens = torch.randint(1, V, (B, L), generator=g)
        tokens[: B // 2, : L // 2] = 0
        yield tokens.to(device), torch.zeros(B, L, dtype=torch.int32, device=device), torch.randint(1, V, (B,), generator=g).to(device)


def test_the_steps_run_eagerly_on_the_card_and_the_first_agrees_with_the_reference(card):
    table = torch.randn(V, CFG["hidden_size"], generator=torch.Generator().manual_seed(0))
    model = HLLMModel(table, V, d_model=CFG["hidden_size"], max_seq_len=L, temperature=0.05, generator=torch.Generator().manual_seed(1), backbone="deepseek_v2", backbone_config=CFG)
    trainer = SeqTrainer(model, optimizer_params={"lr": 1e-3, "weight_decay": 0.0}, loss_type="sampled_softmax", loss_params={"num_negatives": 64, "logq_correction": False}, seed=3, device=card)
    params = {n: p.detach().clone().requires_grad_() for n, p in model.named_parameters()}
    profiling.clear_spans()
    steps = list(batches(card, 3))
    loss = float(trainer.train_step(*steps[0]))
    took = {n: trainer.optimizer.state[p]["exp_avg"] / 0.1 for n, p in model.named_parameters()}
    given = [m.last_topk for m in model.modules() if isinstance(m, MoE)]
    for b in steps[1:]:
        trainer.train_step(*b)
    counted = profiling.counters()
    assert counted.get("rechub.train.graph.eager") == 3 and "rechub.train.graph.capture" not in counted and "rechub.train.graph.refused" not in counted
    cfg = {**CFG, "temperature": 0.05, "num_negatives": 64, "remove_accidental_hits": True, "logq_correction": False}
    items = ref.normalised_table(table.to(card))
    hidden, auxes, _, _ = ref.user_states(params, items, steps[0][0], cfg, given)
    negs = ref.negatives(torch.Generator(device=card).manual_seed(3), V, 64, card)
    expected = ref.sampled_softmax_loss(hidden, items, steps[0][0], steps[0][2], negs, cfg)
    grads = dict(zip(params, torch.autograd.grad(expected + torch.stack(auxes).sum(), list(params.values()))))
    assert loss == pytest.approx(float(expected.detach()), rel=REL)
    for n, g in grads.items():
        torch.testing.assert_close(took[n], g, rtol=REL, atol=REL * float(g.abs().max()))
    profiling.clear_spans()
