"""The (data, model) mesh: the scenarios a job of ranks runs, and the mesh on the card.

``mesh_worker`` is what each rank of a spawned job runs: every scenario of
``SPECS`` under each of its meshes (``(2, 1)`` and ``(1, 2)`` on two ranks;
the sequence, CTR, matching, multi-task and RQ-VAE trainers), the
``local_inbatch_loss`` blocks, sharded exact retrieval, the sharded prefetch
and a checkpoint round trip; rank 0 writes the results to an ``.npz``.  It
imports torch and numpy only, so the job's ranks import no JAX:
``tests/test_torch_mesh_train.py`` builds the inputs from the JAX package's
weights, spawns one two-rank gloo job on the CPU and holds the results
against the JAX package.

The tests here need a CUDA device and skip without one:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_mesh.py

(a) a world of one over NCCL with ``mesh=None``'s gradients bit for bit
through K2a + K2b (but the rab tables', summed by float atomics), (b) two gloo ranks sharing the card under ``(2, 1)`` and
``(1, 2)`` against the single-process card run, and a checkpoint written
under ``(1, 2)`` restored under ``mesh=None`` and back.
"""

import os
import types

import numpy as np
import pytest
import torch

from torch_rechub_tpu_torch.basic import layers
from torch_rechub_tpu_torch.data import prefetch_to_device
from torch_rechub_tpu_torch.models.generative import HSTUModel
from torch_rechub_tpu_torch.models.generative import rqvae as trqvae
from torch_rechub_tpu_torch.ops import chunked_ce
from torch_rechub_tpu_torch.ops import embedding as temb
from torch_rechub_tpu_torch.parallel import create_mesh, scan_batch_sharding
from torch_rechub_tpu_torch.parallel import distributed as pdist
from torch_rechub_tpu_torch.parallel.mesh import row_shard
from torch_rechub_tpu_torch.serving import brute_force_topk
from torch_rechub_tpu_torch.trainers import CTRTrainer, MatchTrainer, MTLTrainer, RQVAETrainer, SeqTrainer, match_trainer, mtl_trainer
from torch_rechub_tpu_torch.utils.checkpoint import flat_tensors
from torch_rechub_tpu_torch.utils.data import ArrayLoader, SeqLoader
from torch_rechub_tpu_torch.utils.match import local_inbatch_loss

MESHES = ((2, 1), (1, 2))
# tests/test_sharding.py:_seq_losses: a vocab of SHARD_MIN_ROWS, so the token table row-shards under (1, 2)
HSTU_KW = dict(vocab_size=65536, d_model=16, n_heads=2, n_layers=1, dqk=8, dv=8, max_seq_len=8, dropout=0.0, use_time_embedding=True)
HSTU_N, HSTU_BATCH, HSTU_NEGATIVES = 32, 8, 64
# tests/test_sharding.py:data / build_model, and the DSSM of :100
CTR_VOCAB, CTR_N, CTR_BATCH = 64, 256, 64
MATCH_VOCAB, MATCH_N, MATCH_BATCH, MATCH_D = 64, 128, 64, 8
# tests/test_sharding.py:133, and a corpus that does not split over two ranks
TOPK = dict(users=32, items=400, dim=16, k=10)
LOCAL_POOL = dict(b=16, d=8, k=5)  # a rank's block of tests/test_sharding.py:165
# tests/test_sharding.py:_mtl_losses: four fields of 30 ids at d6 and one dense field, two tasks, B64, 4 steps
MTL_VOCAB, MTL_N, MTL_BATCH, MTL_TASKS = 30, 256, 64, ("classification", "classification")
# tests/test_sharding.py:_rqvae_run: 256 rows of 10 clusters in 32-d, two stages of 16 codes at e_dim 8, B64, 2 epochs
RQ_KW = dict(in_dim=32, num_emb_list=(16, 16), e_dim=8, layers=(16,), kmeans_init=True, kmeans_iters=2, dropout_prob=0.0)
RQ_N, RQ_BATCH, RQ_EPOCHS, RQ_SEED, RQ_SIDS = 256, 64, 2, 3, 40

SPECS = {
    # SeqTrainer: the tied table row-sharded under (1, 2), the chunked CE (tests/test_sharding.py:235)
    "hstu_chunked": dict(kind="seq", model={}, trainer=dict(vocab_chunk_size=8192, seed=5)),
    # untied, the sampled softmax on injected negatives, sparse SGD on both tables (tests/test_sharding.py:438)
    "hstu_sampled_sparse": dict(kind="seq", model=dict(tie_embeddings=False), trainer=dict(seed=5, loss_type="sampled_softmax", loss_params={"num_negatives": HSTU_NEGATIVES}, sparse_embedding="sgd"), inject=True),
    # the same with the negatives drawn by the trainer's generator: they must be mesh=None's
    "hstu_sampled_drawn": dict(kind="seq", model=dict(tie_embeddings=False), trainer=dict(seed=5, loss_type="sampled_softmax", loss_params={"num_negatives": HSTU_NEGATIVES}), meshes=((2, 1),)),
    # CTRTrainer: DeepFM with BatchNorm (tests/test_sharding.py:58), dense, and fused with sparse Adagrad (:402)
    "deepfm_dense": dict(kind="ctr", fused=False, trainer=dict(seed=7)),
    "deepfm_fused_adagrad": dict(kind="ctr", fused=True, trainer=dict(seed=7, sparse_embedding="adagrad")),
    # BatchNorm's statistics left per rank: must NOT match
    "deepfm_dense_per_rank_bn": dict(kind="ctr", fused=False, trainer=dict(seed=7), patch="per_rank_bn", meshes=((2, 1),)),
    # MatchTrainer: in-batch negatives over the global pool (tests/test_sharding.py:100) and the local one
    "dssm_global_hard": dict(kind="match", trainer=dict(mode=2, in_batch_neg=True, in_batch_neg_ratio=7, hard_negative=True, seed=3)),
    "dssm_global_uniform": dict(kind="match", trainer=dict(mode=2, in_batch_neg=True, in_batch_neg_ratio=7, seed=3), meshes=((2, 1),)),
    # uniform negatives drawn per rank at the local shape: must NOT match
    "dssm_global_uniform_per_rank": dict(kind="match", trainer=dict(mode=2, in_batch_neg=True, in_batch_neg_ratio=7, seed=3), patch="per_rank_negatives", meshes=((2, 1),)),
    "dssm_local_hard": dict(kind="match", trainer=dict(mode=2, in_batch_neg=True, in_batch_neg_ratio=7, hard_negative=True, neg_pool="local", seed=3)),
    # MTLTrainer: MMOE under the mean and each adaptive method (tests/test_sharding.py:304)
    **{f"mmoe_{m or 'mean'}": dict(kind="mtl", model="MMOE", method=m, trainer=dict(seed=9)) for m in (None, "uwl", "metabalance")},
    # GradNorm over two epochs (8 steps), so that the loss weights have moved by more than their tolerance
    "mmoe_gradnorm": dict(kind="mtl", model="MMOE", method="gradnorm", trainer=dict(seed=9), epochs=2),
    # every table fused, sparse Adagrad under the mean: the fused table row-sharded under (1, 2)
    "mmoe_fused_adagrad": dict(kind="mtl", model="MMOE", method=None, fused=True, trainer=dict(seed=9, sparse_embedding="adagrad"), meshes=((1, 2),)),
    # a row-sharded fused table as GradNorm's leaf (SharedBottom's table sorts last) and among MetaBalance's norms
    "sharedbottom_fused_gradnorm": dict(kind="mtl", model="SharedBottom", method="gradnorm", fused=True, trainer=dict(seed=9), meshes=((1, 2),)),
    "mmoe_fused_metabalance": dict(kind="mtl", model="MMOE", method="metabalance", fused=True, trainer=dict(seed=9), meshes=((1, 2),)),
    # GradNorm's norms taken from the rank's own share of the leaf's gradient: must NOT match
    "mmoe_gradnorm_per_rank": dict(kind="mtl", model="MMOE", method="gradnorm", trainer=dict(seed=9), epochs=2, patch="per_rank_gradnorm", meshes=((2, 1),)),
    # RQVAETrainer with the k-means init (tests/test_sharding.py:344), without Sinkhorn and with it on the last stage
    "rqvae": dict(kind="rqvae", sk=(0.0, 0.0), meshes=((2, 1),)),
    "rqvae_sinkhorn": dict(kind="rqvae", sk=(0.0, 0.1), meshes=((2, 1),)),
    # Sinkhorn over the rank's rows with the local batch size: must NOT match
    "rqvae_sinkhorn_local": dict(kind="rqvae", sk=(0.0, 0.1), patch="local_sinkhorn", meshes=((2, 1),)),
}
EPOCHS = {"seq": 1, "ctr": 1, "match": 2, "mtl": 1, "rqvae": RQ_EPOCHS}


def epochs_of(spec):
    return spec.get("epochs", EPOCHS[spec["kind"]])


# ---------------------------------------------------------------------------
# data and models (``feat``, ``ranking`` and ``matching`` are either package's modules)
# ---------------------------------------------------------------------------


def hstu_data(n=HSTU_N, seed=3):
    """tests/test_sharding.py:_seq_losses's sequences: no PAD, sorted time differences."""
    rng = np.random.default_rng(seed)
    vocab, l = HSTU_KW["vocab_size"], HSTU_KW["max_seq_len"]
    tokens = rng.integers(1, vocab, (n, l)).astype(np.int32)
    positions = np.broadcast_to(np.arange(l, dtype=np.int32), (n, l)).copy()
    tds = np.sort(rng.integers(0, 10**5, (n, l)), axis=1).astype(np.int32)
    targets = rng.integers(1, vocab, n).astype(np.int32)
    return tokens, positions, targets, tds


def hstu_negatives(seed=4):
    return np.random.default_rng(seed).integers(1, HSTU_KW["vocab_size"], HSTU_NEGATIVES)


def ctr_data(n=CTR_N, seed=0):
    rng = np.random.default_rng(seed)
    x = {f"C{i}": rng.integers(0, CTR_VOCAB, n).astype(np.int32) for i in range(4)}
    x["I0"] = rng.normal(size=n).astype(np.float32)
    return x, rng.integers(0, 2, n).astype(np.float32)


def deepfm(feat, ranking):
    sparse = tuple(feat.SparseFeature(f"C{i}", vocab_size=CTR_VOCAB, embed_dim=8) for i in range(4))
    return ranking.DeepFM(deep_features=(feat.DenseFeature("I0"),), fm_features=sparse, mlp_params={"dims": (16,), "dropout": 0.0})


def match_data(n=MATCH_N, seed=0):
    rng = np.random.default_rng(seed)
    x = {"user_id": rng.integers(0, MATCH_VOCAB, n).astype(np.int32), "item_id": rng.integers(0, MATCH_VOCAB, n).astype(np.int32)}
    return x, np.ones(n, np.float32)


def dssm(feat, matching):
    d = MATCH_D
    return matching.DSSM(user_features=(feat.SparseFeature("user_id", vocab_size=MATCH_VOCAB, embed_dim=d),), item_features=(feat.SparseFeature("item_id", vocab_size=MATCH_VOCAB, embed_dim=d),),
                         user_params={"dims": (16, d)}, item_params={"dims": (16, d)})


def mtl_data(n=MTL_N, seed=11):
    """tests/test_sharding.py:_mtl_losses's rows: uniform ids, a normal dense field, two random 0/1 tasks."""
    rng = np.random.default_rng(seed)
    x = {f"C{i}": rng.integers(0, MTL_VOCAB, n).astype(np.int32) for i in range(4)}
    x["I0"] = rng.normal(size=n).astype(np.float32)
    return x, rng.integers(0, 2, (n, 2)).astype(np.float32)


def mtl_model(feat, mt, name):
    """tests/test_sharding.py:_mtl_losses's MMOE (3 experts of 16, towers of 8), or a SharedBottom of the same widths."""
    feats = tuple(feat.SparseFeature(f"C{i}", vocab_size=MTL_VOCAB, embed_dim=6) for i in range(4)) + (feat.DenseFeature("I0"),)
    towers = ({"dims": (8,), "dropout": 0.0}, {"dims": (8,), "dropout": 0.0})
    if name == "SharedBottom":
        return mt.SharedBottom(features=feats, task_types=MTL_TASKS, bottom_params={"dims": (16,), "dropout": 0.0}, tower_params_list=towers)
    return mt.MMOE(features=feats, task_types=MTL_TASKS, n_expert=3, expert_params={"dims": (16,), "dropout": 0.0}, tower_params_list=towers)


def rq_data(n=RQ_N, seed=5):
    """tests/test_sharding.py:_rqvae_run's rows: 10 clusters in 32-d at noise 0.1."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(10, RQ_KW["in_dim"])) * 3
    return (centers[rng.integers(0, 10, n)] + rng.normal(size=(n, RQ_KW["in_dim"])) * 0.1).astype(np.float32)


def build(spec):
    """The port's model of a scenario (random weights; the caller loads the scenario's)."""
    from torch_rechub_tpu_torch.basic import features as feat
    from torch_rechub_tpu_torch.models import matching, multi_task, ranking

    if spec["kind"] == "seq":
        return HSTUModel(**HSTU_KW, **spec["model"])
    if spec["kind"] == "rqvae":
        return trqvae.RQVAEModel(**RQ_KW, sk_epsilons=spec["sk"])
    if spec["kind"] in ("ctr", "mtl"):
        old = temb.set_fused_default(spec.get("fused", "auto"))
        try:
            return deepfm(feat, ranking) if spec["kind"] == "ctr" else mtl_model(feat, multi_task, spec["model"])
        finally:
            temb.set_fused_default(old)
    return dssm(feat, matching)


def loader(spec):
    if spec["kind"] == "seq":
        return SeqLoader(*hstu_data(), batch_size=HSTU_BATCH, shuffle=False)
    if spec["kind"] == "ctr":
        return ArrayLoader(*ctr_data(), batch_size=CTR_BATCH, shuffle=False)
    if spec["kind"] == "mtl":
        return ArrayLoader(*mtl_data(), batch_size=MTL_BATCH, shuffle=False)
    return ArrayLoader(*match_data(), batch_size=MATCH_BATCH, shuffle=False)


def trainer_of(spec, model, mesh, device, model_path):
    if spec["kind"] == "mtl":
        adaptive = {"method": spec["method"]} if spec["method"] else None
        return MTLTrainer(model, MTL_TASKS, adaptive_params=adaptive, n_epoch=1, model_path=model_path, mesh=mesh, device=device, **spec["trainer"])
    if spec["kind"] == "rqvae":
        return RQVAETrainer(model, n_epoch=RQ_EPOCHS, eval_step=10, model_path=model_path, mesh=mesh, seed=RQ_SEED, device=device)
    cls = {"seq": SeqTrainer, "ctr": CTRTrainer, "match": MatchTrainer}[spec["kind"]]
    return cls(model, n_epoch=1, model_path=model_path, mesh=mesh, device=device, **spec["trainer"])


class patched:
    """A scenario's patch, undone on exit: the injected negatives, BatchNorm's statistics per rank, the uniform
    in-batch keys drawn per rank at the local shape, GradNorm's norms of the rank's share, or Sinkhorn over the
    rank's rows.  Every RQ-VAE run records the codes of each Sinkhorn call (``codes``: this rank's rows)."""

    def __init__(self, spec):
        self.spec, self.undo, self.codes = spec, [], []

    def set(self, module, name, value):
        self.undo.append((module, name, getattr(module, name)))
        setattr(module, name, value)

    def __enter__(self):
        if self.spec.get("inject"):
            draw, negs = chunked_ce.sampled_candidates, torch.from_numpy(hstu_negatives())
            self.set(chunked_ce, "sampled_candidates", lambda *a: (draw(*a)[0], negs.to(a[0].device)))
        if self.spec.get("patch") == "per_rank_bn":
            self.set(layers, "data_group", lambda: None)
        if self.spec.get("patch") == "per_rank_negatives":
            sample = match_trainer.inbatch_negative_sampling
            self.set(match_trainer, "inbatch_negative_sampling", lambda scores, ratio, hard, generator=None, row_offset=0: sample(scores, ratio, hard, keys=torch.rand(scores.shape, generator=generator, device=scores.device), row_offset=row_offset))
        if self.spec.get("patch") == "per_rank_gradnorm":  # sum_tensors the identity for the trainer alone
            self.set(mtl_trainer, "pdist", types.SimpleNamespace(**{**vars(pdist), "sum_tensors": lambda tensors, group: list(tensors)}))
        if self.spec.get("patch") == "local_sinkhorn":
            self.set(trqvae, "_batch_group", lambda: None)
        if self.spec["kind"] == "rqvae":
            sinkhorn = trqvae.sinkhorn_algorithm

            def recorded(*args):
                q = sinkhorn(*args)
                self.codes.append(torch.argmax(q, dim=-1))
                return q

            self.set(trqvae, "sinkhorn_algorithm", recorded)
        return self

    def __exit__(self, *exc):
        for module, name, value in reversed(self.undo):
            setattr(module, name, value)


def run_spec(spec, state, mesh, device, model_path):
    """Train a scenario from ``state`` (every rank of ``mesh`` calls it); numpy results: ``loss`` (one per epoch),
    ``sharded`` (the row-sharded parameters' names), ``param/<name>`` and ``accum/<name>`` (unsharded), and the
    trained model's ``predict`` (and ``evaluate`` for HSTU) under the mesh."""
    model = build(spec)
    if state is not None:
        model.load_state_dict(state)
    if spec["kind"] == "rqvae":
        return run_rqvae(spec, model, mesh, device, model_path)
    with patched(spec):
        trainer = trainer_of(spec, model, mesh, device, model_path)
        data = loader(spec)
        losses = [trainer.train_one_epoch(data, log_interval=0) for _ in range(epochs_of(spec))]
        st = trainer.train_state()
        out = {"loss": np.asarray(losses), "sharded": np.asarray([n for n, p in trainer.model.named_parameters() if row_shard(p) is not None] or [""])}
        out.update({f"param/{k}": v.detach().cpu().numpy() for k, v in st["model"].items()})
        out.update({f"accum/{k}": v.detach().cpu().numpy() for k, v in st["sparse_accums"].items()})
        # serving under the mesh: the whole batch on every rank, through the sharded reads
        if spec["kind"] == "seq":
            out["predict"] = trainer.predict_logits(SeqLoader(*hstu_data(n=8, seed=9), batch_size=8))
            out["evaluate"] = np.asarray(trainer.evaluate(SeqLoader(*hstu_data(n=8, seed=9), batch_size=8)))
        elif spec["kind"] == "ctr":
            out["predict"] = trainer.predict(trainer.model, ArrayLoader(ctr_data(n=100, seed=9)[0], batch_size=CTR_BATCH))
        elif spec["kind"] == "mtl":
            out["predict"] = trainer.predict(trainer.model, ArrayLoader(mtl_data(n=100, seed=9)[0], batch_size=MTL_BATCH))
            if trainer.loss_weight is not None:  # every rank's, one row a rank
                weights = trainer.loss_weight.detach()[None]
                out["loss_weight"] = (weights if mesh is None else pdist.all_gather(weights, None)).cpu().numpy()
    return out


def run_rqvae(spec, model, mesh, device, model_path):
    """``fit`` with the k-means init under ``mesh`` (every rank holds the data); the best loss, the parameters, the
    codes of every Sinkhorn call in training over the global batch (``sk_codes``, one row a call) and the codes of
    ``generate_semantic_ids`` over the first ``RQ_SIDS`` rows."""
    data = rq_data()
    with patched(spec) as p:
        trainer = trainer_of(spec, model, mesh, device, model_path)
        best_loss, _ = trainer.fit(data, batch_size=RQ_BATCH)
        codes = np.zeros((0, RQ_BATCH), np.int64)
        if p.codes:
            codes = torch.stack(p.codes)
            codes = (codes if mesh is None else pdist.all_gather(codes, mesh.data_group, dim=1)).cpu().numpy()
    out = {"loss": np.asarray(best_loss), "sharded": np.asarray([""]), "sk_codes": codes}
    out.update({f"param/{k}": v.detach().cpu().numpy() for k, v in trainer.train_state()["model"].items()})
    sids = trainer.generate_semantic_ids(data[:RQ_SIDS], batch_size=RQ_BATCH, max_retries=2)
    out["sids"] = np.asarray([sids[i] for i in range(RQ_SIDS)])
    return out


def mesh_worker(rank, inputs_path, out_path, device):
    """One rank of the job: every scenario under each mesh, then the pieces; rank 0 writes ``out_path``."""
    torch.set_num_threads(1)
    inputs = torch.load(inputs_path, weights_only=False)
    device = torch.device(device)
    results = {}
    meshes = {shape: create_mesh(*shape) for shape in MESHES}
    scratch = os.path.join(os.path.dirname(out_path), f"rank{rank}")
    for name, spec in SPECS.items():
        for shape in spec.get("meshes", MESHES):
            out = run_spec(spec, inputs["states"].get(name), meshes[shape], device, scratch)
            results.update({f"{name}@{shape[0]}x{shape[1]}::{k}": v for k, v in out.items()})
    results.update(pieces(rank, inputs, meshes, device, os.path.dirname(out_path)))
    if rank == 0:
        np.savez(out_path, **results)
    torch.distributed.barrier()


def pieces(rank, inputs, meshes, device, directory):
    """``local_inbatch_loss`` on given keys, exact retrieval, the sharded prefetch and a checkpoint round trip."""
    out = {}
    mesh21, mesh12 = meshes[(2, 1)], meshes[(1, 2)]
    lp = inputs["local_pool"]
    d = mesh21.data_index
    rows = slice(d * LOCAL_POOL["b"], (d + 1) * LOCAL_POOL["b"])
    user = torch.as_tensor(lp["user"][rows], device=device).requires_grad_()
    for mode in (1, 2):
        loss = local_inbatch_loss(user, torch.as_tensor(lp["item"][rows], device=device), torch.as_tensor(lp["w"][rows], device=device), None, mesh21, mode,
                                  neg_ratio=LOCAL_POOL["k"], keys=torch.as_tensor(lp["keys"][d], device=device))
        grad, = torch.autograd.grad(loss, user)
        out[f"local_pool::mode{mode}::loss"] = loss.detach().cpu().numpy()
        out[f"local_pool::mode{mode}::grad"] = pdist.all_gather(grad, mesh21.data_group).cpu().numpy()
    for items in (TOPK["items"], TOPK["items"] + 1):  # split over the ranks, and replicated
        idx, vals = brute_force_topk(inputs["topk"]["users"], inputs["topk"]["items"][:items], TOPK["k"], batch_size=12, mesh=mesh12, device=device)
        out[f"topk{items}::idx"], out[f"topk{items}::vals"] = idx, vals
    groups = [tuple(np.arange(4 * 6 * 3).reshape(4, 6, 3) + 1000 * g for _ in range(2)) for g in range(3)]
    got = list(prefetch_to_device(iter(groups), size=2, sharding=scan_batch_sharding(mesh21), device=device))
    mine = torch.stack([t for g in got for t in g])
    out["prefetch::ranks"] = pdist.all_gather(mine[None], None).cpu().numpy()
    host_rows = np.arange(6 * 2).reshape(6, 2)
    out["global_batch"] = pdist.global_batch_from_host({"x": mesh21.data_index * 100 + host_rows}, mesh21)["x"]
    out.update(checkpoint_round_trip(inputs, mesh12, device, directory))
    return out


def checkpoint_round_trip(inputs, mesh, device, directory):
    """The fused Adagrad DeepFM: 4 steps under ``mesh`` with a checkpoint at step 4 (rank 0 writes it; the test
    restores it under ``mesh=None``); and the checkpoint ``mesh=None`` wrote (``inputs``) restored under ``mesh``."""
    spec = SPECS["deepfm_fused_adagrad"]
    model = build(spec)
    model.load_state_dict(inputs["states"]["deepfm_fused_adagrad"])
    trainer = trainer_of(spec, model, mesh, device, os.path.join(directory, "unused"))
    trainer.enable_step_checkpointing(os.path.join(directory, "ckpt_mesh"), every_n_steps=4)
    trainer.train_one_epoch(loader(spec), log_interval=0)  # checkpoints after the 4-step group
    out = {f"ckpt_mesh::{k}": v.detach().cpu().numpy() for k, v in flat_tensors(trainer.train_state()) if isinstance(v, torch.Tensor)}
    back = trainer_of(spec, build(spec), mesh, device, os.path.join(directory, "unused"))
    back.enable_step_checkpointing(inputs["ckpt_none"], every_n_steps=4)
    out["ckpt_none::resumed_step"] = np.asarray(back.maybe_resume())
    out.update({f"ckpt_none::{k}": v.detach().cpu().numpy() for k, v in flat_tensors(back.train_state()) if isinstance(v, torch.Tensor)})
    return out


def failing_rank(rank):
    """Rank 1 raises while rank 0 waits for it in a collective."""
    if rank == 1:
        raise ValueError("rank 1 fails")
    torch.distributed.barrier()


def run_job(inputs, directory, device="cpu", backend=None, timeout_s=600.0):
    """Spawn the two-rank job on ``inputs`` (written to ``directory``); returns its results."""
    inputs_path, out_path = os.path.join(directory, "inputs.pt"), os.path.join(directory, "results.npz")
    torch.save(inputs, inputs_path)
    pdist.spawn(mesh_worker, 2, args=(inputs_path, out_path, device), backend=backend, timeout_s=timeout_s)
    return dict(np.load(out_path))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from torch_rechub_tpu_torch.ops.cuda import _build

    _build.build_all()  # here, once: the spawned ranks load the libraries
    return torch.device("cuda")


CARD_HSTU = dict(HSTU_KW, vocab_size=65536, d_model=64, n_heads=2, n_layers=2, dqk=32, dv=32, max_seq_len=64)


def card_hstu_run(rank, out_path, fused):
    """World of one: one step of the card HSTU under ``mesh=None``, twice, then under the ``(1, 1)`` mesh, same weights,
    under ``torch.use_deterministic_algorithms`` (the embedding backward's atomics otherwise make two runs differ);
    the gradients saved."""
    from torch_rechub_tpu_torch.ops.cuda import hstu_rab_attention as rab

    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"  # this process only, before its first cuBLAS call
    torch.use_deterministic_algorithms(True)
    rab._FUSED_BWD[0] = fused
    torch.backends.cuda.matmul.allow_tf32 = False
    data = SeqLoader(*(a[:8] for a in card_sequences()), batch_size=8)
    res = {}
    for label, mesh in (("none", None), ("none2", None), ("mesh", create_mesh(1, 1))):
        trainer = SeqTrainer(HSTUModel(**CARD_HSTU, generator=torch.Generator().manual_seed(0)), vocab_chunk_size=8192, mesh=mesh, model_path=os.path.dirname(out_path))
        res[f"{label}::loss"] = np.asarray(trainer.train_one_epoch(data, log_interval=0))
        res.update({f"{label}::{k}": p.grad.cpu().numpy() for k, p in trainer.model.named_parameters() if p.grad is not None})
    np.savez(out_path, **res)


def card_sequences(n=32, seed=3):
    rng = np.random.default_rng(seed)
    l, v = CARD_HSTU["max_seq_len"], CARD_HSTU["vocab_size"]
    toks = rng.integers(1, v, (n, l)).astype(np.int32)
    toks[::2, : l // 4] = 0
    tds = np.sort(rng.integers(0, 10**6, (n, l)), axis=1).astype(np.int32)
    return toks, np.tile(np.arange(l, dtype=np.int32), (n, 1)), rng.integers(1, v, n).astype(np.int32), tds


def test_world_of_one_over_nccl_takes_the_no_mesh_gradients_bit_for_bit(card, tmp_path):
    """K2a + K2b (fixed-order dq), deterministic algorithms: a step on the (1, 1) mesh over NCCL has mesh=None's loss and
    gradients bit for bit, but the rab tables', which K2a sums by float atomics (they vary between mesh=None runs too)."""
    out = str(tmp_path / "one.npz")
    pdist.spawn(card_hstu_run, 1, args=(out, False), backend="nccl", timeout_s=600)
    res = dict(np.load(out))
    for k in [k for k in res if k.startswith("none::")]:
        if k.endswith(("rab.pos_w", "rab.ts_w")):
            np.testing.assert_allclose(res["mesh::" + k[6:]], res[k], rtol=1e-4, atol=1e-6 * np.abs(res[k]).max(), err_msg=k)
        else:
            np.testing.assert_array_equal(res["mesh::" + k[6:]], res[k], err_msg=k)


def card_scenarios(rank, out_path, device):
    torch.backends.cuda.matmul.allow_tf32 = False
    meshes = {shape: create_mesh(*shape) for shape in MESHES}
    res = {}
    for name in ("hstu_chunked", "deepfm_fused_adagrad"):
        spec = SPECS[name]
        state = seeded_state(spec)
        for shape in MESHES:
            out = run_spec(spec, state, meshes[shape], device, os.path.join(os.path.dirname(out_path), f"r{rank}"))
            res.update({f"{name}@{shape[0]}x{shape[1]}::{k}": v for k, v in out.items()})
    if rank == 0:
        np.savez(out_path, **res)
    torch.distributed.barrier()


def seeded_state(spec):
    torch.manual_seed(0)
    return build(spec).state_dict()


def test_two_gloo_ranks_sharing_the_card_match_one_process(card, tmp_path):
    """(2, 1) and (1, 2) over two gloo ranks on the one card against the single-process card run, at
    tests/test_sharding.py's tolerances (HSTU :255, the sparse DeepFM :402)."""
    out = str(tmp_path / "two.npz")
    pdist.spawn(card_scenarios, 2, args=(out, "cuda"), backend="gloo", timeout_s=600)
    res = dict(np.load(out))
    for name, (loss_rtol, rtol, atol) in {"hstu_chunked": (3e-4, 3e-3, 3e-4), "deepfm_fused_adagrad": (2e-4, 2e-3, 2.5e-3)}.items():
        spec = SPECS[name]
        ref = run_spec(spec, seeded_state(spec), None, card, str(tmp_path / "ref"))
        for shape in MESHES:
            key = f"{name}@{shape[0]}x{shape[1]}::"
            np.testing.assert_allclose(res[key + "loss"], ref["loss"], rtol=loss_rtol, err_msg=key)
            for k, v in ref.items():
                if k.startswith("param/"):
                    np.testing.assert_allclose(res[key + k], v, rtol=rtol, atol=atol, err_msg=key + k)


def test_checkpoint_moves_between_a_mesh_and_none_on_the_card(card, tmp_path):
    """A checkpoint written under (1, 2) by two gloo ranks on the card restores under mesh=None, and one written
    under mesh=None restores under (1, 2), equal to the tensor."""
    spec = SPECS["deepfm_fused_adagrad"]
    state = seeded_state(spec)
    ref = trainer_of(spec, build(spec), None, card, str(tmp_path))
    ref.model.load_state_dict(state)
    ref.enable_step_checkpointing(str(tmp_path / "ckpt_none"), every_n_steps=4)
    ref.train_one_epoch(loader(spec), log_interval=0)
    inputs = {"states": {"deepfm_fused_adagrad": state}, "ckpt_none": str(tmp_path / "ckpt_none")}
    torch.save(inputs, tmp_path / "inputs.pt")
    pdist.spawn(card_checkpoint, 2, args=(str(tmp_path / "inputs.pt"), str(tmp_path / "ck.npz")), backend="gloo", timeout_s=600)
    res = dict(np.load(tmp_path / "ck.npz"))
    want = {k: v.detach().cpu().numpy() for k, v in flat_tensors(ref.train_state()) if isinstance(v, torch.Tensor)}
    assert int(res["ckpt_none::resumed_step"]) == 4
    for k, v in want.items():
        np.testing.assert_array_equal(res[f"ckpt_none::{k}"], v, err_msg=k)
    restored = trainer_of(spec, build(spec), None, card, str(tmp_path))
    restored.enable_step_checkpointing(str(tmp_path / "ckpt_mesh"), every_n_steps=4)
    assert restored.maybe_resume() == 4
    for k, v in flat_tensors(restored.train_state()):
        if isinstance(v, torch.Tensor):
            np.testing.assert_array_equal(v.cpu().numpy(), res[f"ckpt_mesh::{k}"], err_msg=k)


def card_checkpoint(rank, inputs_path, out_path):
    inputs = torch.load(inputs_path, weights_only=False)
    res = checkpoint_round_trip(inputs, create_mesh(1, 2), torch.device("cuda"), os.path.dirname(out_path))
    if rank == 0:
        np.savez(out_path, **res)
    torch.distributed.barrier()
