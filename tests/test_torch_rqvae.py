"""The port's RQ-VAE (``models/generative/rqvae.py``) and ``RQVAETrainer`` against the JAX package's,
at the sizes of ``tests/test_rqvae.py``.

- Sinkhorn and the distance centring against JAX's (rtol 1e-5); at epsilon
  0.003 both overflow to a NaN plan and code 0 for every row (a mirrored
  quirk, ``ROADMAP.md`` queue 3), at 0.05 neither does.
- The numpy k-means equal to JAX's bit for bit (the same code and
  ``default_rng`` draws); the k-means codebook init on carried weights.
- The quantizer's straight-through gradient; the model's outputs, loss and
  codes on carried weights (codebooks copied untransposed); one
  ``RQVAETrainer`` step against JAX's (loss, gradients, every parameter
  after Adam, the BatchNorm statistics).
- ``fit`` with both best checkpoints and ``generate_semantic_ids`` with its
  retries; the collision rate and the codes against JAX's on the same
  k-means-initialised weights.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ctr_model import np_tree
from test_torch_cuda_mtl import E_DIM, IN_DIM, build_rqvae, embeddings
from test_torch_cuda_ranking import LOSS_ATOL, LOSS_RTOL, STATS_ATOL, STATS_RTOL, check_step
from torch_rechub_tpu.models.generative import rqvae as jrq
from torch_rechub_tpu.trainers.rqvae_trainer import RQVAETrainer as JRQVAETrainer
from torch_rechub_tpu_torch.models.generative import rqvae as trq
from torch_rechub_tpu_torch.trainers import RQVAETrainer
from torch_rechub_tpu_torch.utils.jax_weights import flax_to_state_dict, load_flax_params

OUT_RTOL, OUT_ATOL = 1e-5, 1e-6
# the decoder's output: three Dense + BatchNorm layers over clustered rows, whose small batch variances
# scale the two sides' fp32 rounding up to about 1e-5 of outputs of about 1
DECODER_ATOL = 2e-5


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_sinkhorn_matches_jax_and_overflows_at_small_epsilon():
    d = np.random.default_rng(0).normal(size=(64, 256)).astype(np.float32) * 3
    centred = trq.center_distances(torch.from_numpy(d))
    np.testing.assert_allclose(centred.numpy(), np.asarray(jrq.center_distances(jnp.asarray(d))), rtol=OUT_RTOL, atol=OUT_ATOL)
    assert float(centred.min()) >= -1 and float(centred.max()) <= 1
    q = trq.sinkhorn_algorithm(centred, 0.05, 50)
    ref = np.asarray(jrq.sinkhorn_algorithm(jrq.center_distances(jnp.asarray(d)), 0.05, 50))
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(q.numpy(), ref, rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(q.sum(1).numpy(), 1.0, rtol=5e-2)  # tests/test_rqvae.py::test_sinkhorn_balanced
    # epsilon 0.003: exp(1/0.003) overflows fp32, the plan is NaN everywhere and argmax is 0 on both sides
    ref = jrq.sinkhorn_algorithm(jrq.center_distances(jnp.asarray(d)), 0.003, 100)
    q = trq.sinkhorn_algorithm(centred, 0.003, 100)
    assert np.isnan(np.asarray(ref)).all() and torch.isnan(q).all()
    assert (np.asarray(jnp.argmax(ref, axis=-1)) == 0).all() and (q.argmax(-1) == 0).all()


def test_kmeans_centres_equal_jax_s():
    x = embeddings(200)
    np.testing.assert_array_equal(trq.kmeans(x, 10, num_iters=5, seed=3), jrq.kmeans(x, 10, num_iters=5, seed=3))
    for kmeans in (trq.kmeans, jrq.kmeans):  # fewer distinct rows than clusters: k-means++ runs out of mass
        with pytest.raises(ValueError, match="Probabilities"):
            kmeans(x[:4], 6, num_iters=2)


def test_nearest_decides_near_ties_as_the_direct_form():
    """Rows equidistant from centres 0 and 1 (the same coordinates but the first, which lies halfway between them):
    the expanded ``|x|² − 2 x·c + |c|²`` rounds some of them to centre 1, and ``_nearest``'s direct fallback gives
    centre 0, the first of an exact tie, as the JAX package's ``((x - c) ** 2).sum(-1)`` argmin does."""
    rng = np.random.default_rng(0)
    p = rng.normal(size=16) * 30
    centers = np.concatenate([np.stack([p, p]), p + rng.normal(size=(6, 16)) * 50])
    centers[0, 0] -= 0.7
    centers[1, 0] += 0.7
    x = p + rng.normal(size=(256, 16)) * 3
    x[:, 0] = p[0]
    d2 = ((x[:, None, :] - centers[None]) ** 2).sum(-1)
    assert (d2[:, 0] == d2[:, 1]).all()  # exact ties in the direct form
    expanded = np.argmin((x * x).sum(-1)[:, None] - 2.0 * (x @ centers.T) + (centers * centers).sum(-1)[None, :], axis=1)
    assert (expanded == 1).sum() > 50  # the matrix product alone would take centre 1 for many of them
    np.testing.assert_array_equal(trq._nearest(x, centers), np.argmin(d2, axis=1))
    assert (trq._nearest(x, centers) == 0).all()


def carried(seed=0, **kw):
    """A flax RQVAEModel, its variables, and the port's model carrying them."""
    jmodel = build_rqvae(jrq, **kw)
    variables = np_tree(jmodel.init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(embeddings(8)), training=False))
    return jmodel, variables, load_flax_params(build_rqvae(trq, **kw), variables["params"], variables["batch_stats"])


def test_quantizers_and_model_match_jax():
    """The straight-through gradient of a VQ stage (``tests/test_rqvae.py``), then the model on carried
    weights: codebooks ``(32, 8)`` copied as they are, eval outputs, loss and codes, the train forward and
    the statistics it leaves; ``kmeans_init_codebooks`` from the same weights."""
    vq = trq.VectorQuantizer(n_e=16, e_dim=E_DIM, sk_epsilon=0.0, generator=torch.Generator().manual_seed(0))
    assert float(vq.embedding.detach().abs().max()) <= 1 / 16
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(20, E_DIM)).astype(np.float32)).requires_grad_()
    x_q, loss, indices = vq(x, use_sk=False)
    assert x_q.shape == x.shape and indices.shape == (20,) and float(loss.detach()) >= 0
    x_q.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), 1.0, rtol=1e-5)

    jmodel, variables, model = carried()
    assert tuple(model.rq.vq_layers_1.embedding.shape) == (32, E_DIM)
    np.testing.assert_array_equal(model.rq.vq_layers_1.embedding.detach().numpy(), variables["params"]["rq"]["vq_layers_1"]["embedding"])
    data = embeddings(64, seed=1)
    np.testing.assert_array_equal(model.get_indices(torch.from_numpy(data)).numpy(), np.asarray(jmodel.apply(variables, jnp.asarray(data), method=jrq.RQVAEModel.get_indices)))
    for training in (False, True):
        ref, mutated = jmodel.apply(variables, jnp.asarray(data), use_sk=True, training=training, mutable=["batch_stats"])
        out, rq_loss, idx = model.train(training)(torch.from_numpy(data), use_sk=True)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref[0]), rtol=OUT_RTOL, atol=DECODER_ATOL)
        np.testing.assert_allclose(float(rq_loss.detach()), float(ref[1]), rtol=OUT_RTOL, atol=OUT_ATOL)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref[2]))
    assert (idx[:, 1] == 0).all()  # the second stage's Sinkhorn at 0.003 overflows: code 0 for every row
    ref_stats = flax_to_state_dict(np_tree(mutated["batch_stats"]))
    for key, b in model.named_buffers():
        np.testing.assert_allclose(b.numpy(), ref_stats[key].numpy(), rtol=STATS_RTOL, atol=STATS_ATOL, err_msg=key)
    ref_params = jrq.kmeans_init_codebooks(jmodel, variables, data, num_iters=3, seed=5)
    _, _, model = carried()
    trq.kmeans_init_codebooks(model, data, num_iters=3, seed=5)
    for i in range(2):
        np.testing.assert_allclose(getattr(model.rq, f"vq_layers_{i}").embedding.detach().numpy(), np.asarray(ref_params["rq"][f"vq_layers_{i}"]["embedding"]), rtol=1e-5, atol=1e-6)


def test_rqvae_trainer_step_matches_jax(tmp_path):
    """One step from the same weights on one shuffled batch of 64 of 100 rows (Sinkhorn on in training, as
    by default): the loss, gradients, every parameter after Adam and the BatchNorm statistics."""
    jmodel, variables, model = carried(seed=1)
    data = embeddings(100, seed=2)
    jtrainer = JRQVAETrainer(jmodel, n_epoch=1, model_path=str(tmp_path / "jax"))
    jtrainer.init_state_from_data(data)
    jtrainer.state = jtrainer.state.replace(params=jax.tree_util.tree_map(jnp.asarray, variables["params"]), batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]))
    jtrainer._build_steps()
    batch = data[next(iter(_orders(len(data), 64)))]

    def jloss(p):
        (out, rq_loss, _), _ = jmodel.apply({"params": p, "batch_stats": variables["batch_stats"]}, jnp.asarray(batch), use_sk=True, training=True, mutable=["batch_stats"])
        return jnp.mean((out - batch) ** 2) + rq_loss

    ref_loss, jgrads = jax.jit(jax.value_and_grad(jloss))(variables["params"])
    jtrainer.state, jstep_loss = jtrainer._train_step(jtrainer.state, jnp.asarray(batch), jnp.asarray(1e-3, jnp.float32), jax.random.PRNGKey(0))
    trainer = RQVAETrainer(model, n_epoch=1, model_path=str(tmp_path / "torch"), device="cpu")
    loss = trainer.train_one_epoch(data, batch_size=64, epoch=0)
    np.testing.assert_allclose(loss, float(jstep_loss), rtol=LOSS_RTOL, atol=LOSS_ATOL)
    np.testing.assert_allclose(float(jstep_loss), float(ref_loss), rtol=1e-6)
    before, after, ref_grads = (flax_to_state_dict(t) for t in (variables["params"], np_tree(jtrainer.state.params), np_tree(jgrads)))
    named = dict(trainer.model.named_parameters())
    check_step({k: p.grad.numpy() for k, p in named.items()}, {k: p.detach().numpy() for k, p in named.items()},
               {k: v.numpy() for k, v in ref_grads.items()}, {k: v.numpy() for k, v in after.items()}, {k: v.numpy() for k, v in before.items()}, 64, ref_grad_noise=True)
    ref_stats = flax_to_state_dict(np_tree(jtrainer.state.batch_stats))
    for key, b in trainer.model.named_buffers():
        np.testing.assert_allclose(b.numpy(), ref_stats[key].numpy(), rtol=STATS_RTOL, atol=STATS_ATOL, err_msg=key)


def _orders(n, batch_size, seed=0, epoch=0):
    """The row order of the trainers' first epoch (numpy's ``default_rng(seed + epoch)`` shuffle)."""
    order = np.arange(n)
    np.random.default_rng(seed + epoch).shuffle(order)
    return [order[s:s + batch_size] for s in range(0, n - batch_size + 1, batch_size)]


def test_fit_and_semantic_ids_match_jax(tmp_path):
    """``tests/test_rqvae.py::test_rqvae_trainer_fit_and_semantic_ids`` in the port: k-means init, 3 epochs,
    the collision rate every 2, both best checkpoints and ``model.pt``, the semantic ids.  Then, on a JAX
    model's weights with its k-means codebooks carried over, the collision rate of 256 rows and the codes of
    ``generate_semantic_ids`` over 40 of them (nearest codes, then the colliding groups' Sinkhorn retries at
    0.003, which give code 0; JAX runs each group's Sinkhorn eagerly, about 0.7 s a group) equal JAX's."""
    data = embeddings(256)
    model = build_rqvae(trq, kmeans_init=True, generator=torch.Generator().manual_seed(0))
    trainer = RQVAETrainer(model, n_epoch=3, eval_step=2, model_path=str(tmp_path / "torch"), use_sk=False, device="cpu")
    best_loss, best_rate = trainer.fit(data, batch_size=64)
    assert np.isfinite(best_loss) and 0 <= best_rate < 1
    for name in ("best_loss_model.pt", "best_collision_model.pt", "model.pt"):
        assert os.path.exists(tmp_path / "torch" / name)
    sids = trainer.generate_semantic_ids(data, batch_size=64, max_retries=3)
    assert len(sids) == len(data) and all(len(v) == 2 for v in sids.values())

    jtrainer = JRQVAETrainer(build_rqvae(jrq, kmeans_init=True), model_path=str(tmp_path / "jax"), use_sk=False)
    jtrainer.init_state_from_data(data)
    model = load_flax_params(build_rqvae(trq), np_tree(jtrainer.state.params), np_tree(jtrainer.state.batch_stats))
    trainer = RQVAETrainer(model, device="cpu")
    rate = trainer.evaluate(data, 64)
    assert rate > 0
    np.testing.assert_allclose(rate, jtrainer.evaluate(data, 64), rtol=0, atol=1e-12)
    ref = jtrainer.generate_semantic_ids(data[:40], batch_size=64, max_retries=2)
    got = trainer.generate_semantic_ids(data[:40], batch_size=64, max_retries=2)
    assert got == ref
    assert any(codes[1] == "<b_0>" for codes in got.values())  # the retried rows' code 0
