"""The slice as a whole: ``examples_torch/generative/run_hstu_production_vocab.py``'s own construction function
(``build``: data, model, trainer) at a small size (vocab 300, d16, 2 layers of 4 heads, L16, 16 sampled
negatives, both tables sparse under row-wise Adagrad) against the JAX script's recipe, dropout 0, the negatives
given to both.  The JAX trainer takes two steps, its state (parameters, Adam over the rest, both tables'
accumulators) is carried JAX -> numpy -> torch, both take the third: the loss, every parameter (both tables'
rows among them) and the accumulators; then ``evaluate``'s full-vocab (loss, top-1 accuracy).  On the CPU the
attention kernels K1 and K2 run as their plain versions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples.generative.run_hstu import synthetic_sequences as jsynthetic_sequences
from examples_torch.generative import run_hstu_production_vocab as recipe
from test_torch_ctr_model import np_tree
from test_torch_ctr_train import LOSS_ATOL, LOSS_RTOL
from test_torch_sparse_train import CARRIED_ATOL, CARRIED_RTOL, adam_state
from torch_rechub_tpu.models.generative.hstu import HSTUModel as JHSTUModel
from torch_rechub_tpu.ops import chunked_ce as jce
from torch_rechub_tpu.trainers.seq_trainer import SeqTrainer as JSeqTrainer
from torch_rechub_tpu.utils import data as jdata
from torch_rechub_tpu_torch.ops import chunked_ce as tce
from torch_rechub_tpu_torch.utils import data as tdata
from torch_rechub_tpu_torch.utils.jax_weights import flax_to_state_dict, load_flax_params, load_optax_adam_state, load_sparse_accumulators

ARGV = ["--vocab", "300", "--d_model", "16", "--n_layers", "2", "--seq_len", "16", "--num_negatives", "16", "--batch_size", "16", "--epoch", "1", "--steps_per_call", "2"]


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def jax_recipe(args, model_path):
    """The JAX script's data, model and trainer (examples/generative/run_hstu_production_vocab.py:52-78), dropout 0."""
    toks, tds, targets = jsynthetic_sequences(n_users=1000, vocab=args.vocab, seq_len=args.seq_len)
    positions = np.tile(np.arange(args.seq_len), (len(toks), 1))
    loaders = jdata.SequenceDataGenerator(toks, positions, targets, tds).generate_dataloader(batch_size=args.batch_size, split_ratio=(0.8, 0.1, 0.1))
    model = JHSTUModel(vocab_size=args.vocab, d_model=args.d_model, n_heads=4, n_layers=args.n_layers, dqk=args.d_model // 4, dv=args.d_model // 4, max_seq_len=args.seq_len, dropout=0.0, tie_embeddings=False)
    trainer = JSeqTrainer(model, n_epoch=args.epoch, model_path=model_path, loss_type="sampled_softmax", loss_params={"num_negatives": args.num_negatives}, sparse_embedding="adagrad",
                          steps_per_call=args.steps_per_call)
    return loaders, trainer


def test_production_vocab_recipe_step_and_evaluate_match_jax(tmp_path, monkeypatch):
    args = recipe.parse_args(ARGV + ["--save_dir", str(tmp_path / "port")])
    (train, _, test), model, trainer = recipe.build(args, "cpu", dropout=0.0)
    (jtrain, _, jtest), jtrainer = jax_recipe(args, str(tmp_path / "jax"))
    layers = [m for m in model.modules() if hasattr(m, "dqk")]
    assert len(layers) == 2 and {(m.n_heads, m.dqk, m.dv) for m in layers} == {(4, 4, 4)} and not model.tie_embeddings
    assert set(trainer.sparse_tables) == {"token_embedding", "output_projection"} and trainer.loss_type == "sampled_softmax"
    np.testing.assert_array_equal(train.seq_tokens, jtrain.seq_tokens)
    np.testing.assert_array_equal(test.targets, jtest.targets)

    b = args.batch_size
    rows = [a[: 3 * b] for a in (train.seq_tokens, train.seq_positions, train.targets, train.seq_time_diffs)]
    negs = np.random.default_rng(5).integers(1, args.vocab, args.num_negatives)
    negs[:2] = rows[2][:2]  # accidental hits
    jdraw, tdraw = jce.sampled_candidates, tce.sampled_candidates  # the labels as drawn, the negatives given
    monkeypatch.setattr(jce, "sampled_candidates", lambda *a: (jdraw(*a)[0], jnp.asarray(negs, jnp.int32)))
    monkeypatch.setattr(tce, "sampled_candidates", lambda *a: (tdraw(*a)[0], torch.from_numpy(negs)))

    jtrainer.train_one_epoch(jdata.SeqLoader(*(a[: 2 * b] for a in rows), batch_size=b), log_interval=0)
    adam = adam_state(jtrainer.state.opt_state[0])
    assert int(adam.count) == 2
    load_flax_params(model, np_tree(jtrainer.state.params))
    load_optax_adam_state(trainer.optimizer, model, np_tree(adam.mu), np_tree(adam.nu), adam.count)
    load_sparse_accumulators(trainer.sparse_accums, np_tree(jtrainer.state.opt_state[1]))

    third = [a[2 * b:] for a in rows]
    jloss = jtrainer.train_one_epoch(jdata.SeqLoader(*third, batch_size=b), log_interval=0)
    loss = trainer.train_one_epoch(tdata.SeqLoader(*third, batch_size=b), log_interval=0)
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    params = dict(model.named_parameters())
    for name, ref in flax_to_state_dict(np_tree(jtrainer.state.params)).items():
        np.testing.assert_allclose(params[name].detach().numpy(), ref.numpy(), rtol=CARRIED_RTOL, atol=CARRIED_ATOL, err_msg=name)
    for name, ref in flax_to_state_dict(np_tree(jtrainer.state.opt_state[1])).items():
        np.testing.assert_allclose(trainer.sparse_accums[name].numpy(), ref.numpy(), rtol=CARRIED_RTOL, atol=CARRIED_ATOL * float(ref.numpy().max()), err_msg=name)

    jeval, teval = jtrainer.evaluate(jtest), trainer.evaluate(test)
    np.testing.assert_allclose(teval[0], jeval[0], rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert teval[1] == jeval[1]
