"""The port's trainers under a (data, model) mesh against the JAX package, on two gloo ranks on the CPU.

One module-scoped fixture carries the JAX package's initial weights into
the port, spawns ONE two-rank job (``test_torch_cuda_mesh.mesh_worker``,
which imports no JAX) that runs every scenario under ``(2, 1)`` and
``(1, 2)``, and meanwhile trains the JAX references (``mesh=None``, as
``tests/test_sharding.py`` holds sharded JAX runs to unsharded ones; the
local negative pool under a two-device JAX mesh).  Tolerances are those of
the matching ``tests/test_sharding.py`` test, named at each.

Four tests show what the mesh must get right beyond a per-rank program:
BatchNorm's statistics left per rank, uniform in-batch negatives drawn per
rank, GradNorm's norms taken from the rank's share of the gradient, and
Sinkhorn over the rank's rows each fail the comparison that the real
implementation passes.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_cuda_mesh as M
from torch_rechub_tpu.basic import features as jfeat
from torch_rechub_tpu.models import matching as jmatching
from torch_rechub_tpu.models import multi_task as jmt
from torch_rechub_tpu.models import ranking as jranking
from torch_rechub_tpu.models.generative import HSTUModel as JHSTUModel
from torch_rechub_tpu.models.generative import rqvae as jrq
from torch_rechub_tpu.ops import chunked_ce as jce
from torch_rechub_tpu.ops import embedding as jemb
from torch_rechub_tpu.parallel import create_mesh as jcreate_mesh
from torch_rechub_tpu.serving import brute_force_topk as jbrute_force_topk
from torch_rechub_tpu.trainers import CTRTrainer as JCTRTrainer
from torch_rechub_tpu.trainers import MatchTrainer as JMatchTrainer
from torch_rechub_tpu.trainers import MTLTrainer as JMTLTrainer
from torch_rechub_tpu.trainers import RQVAETrainer as JRQVAETrainer
from torch_rechub_tpu.trainers.seq_trainer import SeqTrainer as JSeqTrainer
from torch_rechub_tpu.utils import data as jdata
from torch_rechub_tpu.utils import match as jmatch
from torch_rechub_tpu_torch.utils.checkpoint import flat_tensors
from torch_rechub_tpu_torch.utils.jax_weights import flax_to_state_dict, load_flax_params

# tests/test_sharding.py's tolerances: losses, then parameters
SEQ_TOL = dict(loss_rtol=3e-4, loss_atol=0.0, rtol=3e-3, atol=3e-4)  # :255 and :438
CTR_TOL = dict(loss_rtol=2e-4, loss_atol=1e-5, rtol=2e-3, atol=2.5e-3)  # :58 and :402
MATCH_TOL = dict(loss_rtol=2e-4, loss_atol=1e-5, rtol=2e-3, atol=2.5e-3)  # :100 (losses), parameters as :58
MTL_TOL = dict(loss_rtol=5e-4, loss_atol=1e-5, rtol=3e-3, atol=5e-4)  # :308-328
LOSS_WEIGHT_TOL = dict(rtol=1e-3, atol=1e-4)  # :311
RQ_TOL = dict(loss_rtol=1e-4, loss_atol=0.0, rtol=2e-3, atol=2e-4)  # :351 and :369
LOCAL_POOL_RTOL = 1e-5  # :165
TOPK_RTOL = 1e-5  # :133
JAX_KEY = 11


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


class fused_default:
    def __init__(self, fused):
        self.fused = fused

    def __enter__(self):
        self.old = jemb.set_fused_default(self.fused)

    def __exit__(self, *exc):
        jemb.set_fused_default(self.old)


def jax_trainer(name, spec, model_path):
    """The JAX package's trainer and loader of a scenario (the local pool under a two-device data mesh), writing
    under ``model_path``."""
    kw = dict(spec["trainer"], model_path=model_path)
    if spec["kind"] == "seq":
        return JSeqTrainer(JHSTUModel(**M.HSTU_KW, **spec["model"]), n_epoch=1, **kw), jdata.SeqLoader(*M.hstu_data(), batch_size=M.HSTU_BATCH, shuffle=False)
    if spec["kind"] == "ctr":
        return JCTRTrainer(M.deepfm(jfeat, jranking), n_epoch=1, **kw), jdata.ArrayLoader(*M.ctr_data(), batch_size=M.CTR_BATCH, shuffle=False)
    if spec["kind"] == "mtl":
        adaptive = {"method": spec["method"]} if spec["method"] else None
        return (JMTLTrainer(M.mtl_model(jfeat, jmt, spec["model"]), M.MTL_TASKS, adaptive_params=adaptive, n_epoch=1, **kw),
                jdata.ArrayLoader(*M.mtl_data(), batch_size=M.MTL_BATCH, shuffle=False))
    mesh = jcreate_mesh(data=2, model=1, devices=jax.devices()[:2]) if kw.get("neg_pool") == "local" else None
    return JMatchTrainer(M.dssm(jfeat, jmatching), n_epoch=1, mesh=mesh, **kw), jdata.ArrayLoader(*M.match_data(), batch_size=M.MATCH_BATCH, shuffle=False)


class JaxRun:
    """A scenario's JAX trainer: its initial weights as the port's ``state_dict``, then its training."""

    def __init__(self, name, spec, model_path):
        self.spec, self.model_path = spec, model_path
        if spec["kind"] == "rqvae":
            self._init_rqvae()
            return
        with fused_default(spec.get("fused", "auto")):
            self.trainer, self.loader = jax_trainer(name, spec, model_path)
            self.trainer._ensure_ready(self.loader)
        state = self.trainer.state
        self.init = load_flax_params(M.build(spec), np_tree(state.params), np_tree(state.batch_stats) if state.batch_stats else None).state_dict()

    def _init_rqvae(self):
        """The trainer's state from ``init_state_from_data`` (the k-means codebooks), and the weights it started
        from before the k-means, for the port to run its own k-means init from."""
        self.data = M.rq_data()
        self.trainer = JRQVAETrainer(jrq.RQVAEModel(**M.RQ_KW, sk_epsilons=self.spec["sk"]), n_epoch=M.RQ_EPOCHS, eval_step=10, model_path=self.model_path, seed=M.RQ_SEED)
        init_rng, _ = jax.random.split(jax.random.PRNGKey(M.RQ_SEED))  # the trainer's first split (trainers/base.py)
        variables = np_tree(self.trainer.model.init({"params": init_rng, "dropout": init_rng}, jnp.asarray(self.data[:512]), training=False))
        self.trainer.init_state_from_data(self.data)
        state = flax_to_state_dict(np_tree(self.trainer.state.params))
        before = flax_to_state_dict(variables["params"])
        for k, v in before.items():  # the same weights but the codebooks, which the k-means replaced
            if "vq_layers" not in k:
                np.testing.assert_array_equal(state[k].numpy(), v.numpy(), err_msg=k)
        self.init = load_flax_params(M.build(self.spec), variables["params"], variables["batch_stats"]).state_dict()

    def train(self):
        if self.spec["kind"] == "rqvae":
            self.loss = np.asarray(self.trainer.fit(self.data, batch_size=M.RQ_BATCH)[0])
            sids = self.trainer.generate_semantic_ids(self.data[:M.RQ_SIDS], batch_size=M.RQ_BATCH, max_retries=2)
            self.sids = np.asarray([sids[i] for i in range(M.RQ_SIDS)])
            self.params = {k: v.numpy() for k, v in flax_to_state_dict(np_tree(self.trainer.state.params)).items()}
            return
        with fused_default(self.spec.get("fused", "auto")):
            self.loss = np.asarray([self.trainer.train_one_epoch(self.loader, log_interval=0) for _ in range(M.epochs_of(self.spec))])
            if self.spec["kind"] == "seq":
                self.predict = self.trainer.predict_logits(jdata.SeqLoader(*M.hstu_data(n=8, seed=9), batch_size=8))
                self.evaluate = np.asarray(self.trainer.evaluate(jdata.SeqLoader(*M.hstu_data(n=8, seed=9), batch_size=8)))
            elif self.spec["kind"] == "ctr":
                self.predict = self.trainer.predict(self.trainer.model, jdata.ArrayLoader(M.ctr_data(n=100, seed=9)[0], batch_size=M.CTR_BATCH))
            elif self.spec["kind"] == "mtl":
                self.predict = self.trainer.predict(self.trainer.model, jdata.ArrayLoader(M.mtl_data(n=100, seed=9)[0], batch_size=M.MTL_BATCH))
        state = self.trainer.state
        if getattr(state, "loss_weight", None) is not None:
            self.loss_weight = np.asarray(state.loss_weight)
        self.params = {k: v.numpy() for k, v in flax_to_state_dict(np_tree(state.params)).items()}
        if self.spec["trainer"].get("sparse_embedding") == "adagrad":
            self.accums = {k: v.numpy() for k, v in flax_to_state_dict(np_tree(state.opt_state[1])).items()}


JAX_SCENARIOS = ("hstu_chunked", "hstu_sampled_sparse", "deepfm_dense", "deepfm_fused_adagrad", "dssm_global_hard", "dssm_local_hard")
MTL_SCENARIOS = ("mmoe_mean", "mmoe_uwl", "mmoe_gradnorm", "mmoe_metabalance", "mmoe_fused_adagrad", "sharedbottom_fused_gradnorm", "mmoe_fused_metabalance")
RQ_SCENARIOS = ("rqvae", "rqvae_sinkhorn")
# the port-only scenarios start from a JAX scenario's weights
SAME_WEIGHTS = {"hstu_sampled_drawn": "hstu_sampled_sparse", "deepfm_dense_per_rank_bn": "deepfm_dense", "dssm_global_uniform": "dssm_global_hard", "dssm_global_uniform_per_rank": "dssm_global_hard",
                "mmoe_gradnorm_per_rank": "mmoe_gradnorm", "rqvae_sinkhorn_local": "rqvae_sinkhorn"}


def local_pool_inputs():
    """tests/test_sharding.py:165 on two data shards: users, items, weights, and each block's JAX keys."""
    rng = np.random.default_rng(5)
    n, b, d = 2 * M.LOCAL_POOL["b"], M.LOCAL_POOL["b"], M.LOCAL_POOL["d"]
    user, item = rng.normal(size=(n, d)).astype(np.float32), rng.normal(size=(n, d)).astype(np.float32)
    w = (rng.random(n) > 0.2).astype(np.float32)
    keys = np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(JAX_KEY), i), (b, b))) for i in range(2)])
    return dict(user=user, item=item, w=w, keys=keys)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    directory = tmp_path_factory.mktemp("mesh_job")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    runs = {name: JaxRun(name, M.SPECS[name], str(directory / "jax" / name)) for name in JAX_SCENARIOS + MTL_SCENARIOS + RQ_SCENARIOS}
    states = {name: run.init for name, run in runs.items()}
    states.update({name: states[src] for name, src in SAME_WEIGHTS.items()})
    rng = np.random.default_rng(0)
    topk = dict(users=rng.normal(size=(M.TOPK["users"], M.TOPK["dim"])).astype(np.float32), items=rng.normal(size=(M.TOPK["items"] + 1, M.TOPK["dim"])).astype(np.float32))
    # the checkpoint that mesh=None writes, for the ranks to restore under (1, 2)
    spec = M.SPECS["deepfm_fused_adagrad"]
    none = M.trainer_of(spec, M.build(spec), None, "cpu", str(directory / "none"))
    none.model.load_state_dict(states["deepfm_fused_adagrad"])
    none.enable_step_checkpointing(str(directory / "ckpt_none"), every_n_steps=4)
    none.train_one_epoch(M.loader(spec), log_interval=0)
    inputs = {"states": states, "local_pool": local_pool_inputs(), "topk": topk, "ckpt_none": str(directory / "ckpt_none")}

    box = {}

    def job_thread():
        try:
            box["res"] = M.run_job(inputs, str(directory), timeout_s=600)
        except Exception as e:  # raised again in the test process below
            box["error"] = e

    ranks = threading.Thread(target=job_thread)
    ranks.start()
    try:
        draws = {}
        jsample = jce.sampled_candidates
        negs = jnp.asarray(M.hstu_negatives(), jnp.int32)
        for name, run in runs.items():
            if M.SPECS[name].get("inject"):
                jce.sampled_candidates = lambda *a: (jsample(*a)[0], negs)
            try:
                run.train()
            finally:
                jce.sampled_candidates = jsample
        # the port without a mesh, for the scenarios whose draws JAX's streams cannot pin
        for name in ("hstu_sampled_drawn", "dssm_global_uniform", "rqvae_sinkhorn"):
            draws[name] = M.run_spec(M.SPECS[name], states[name], None, "cpu", str(directory / "none"))
    finally:
        ranks.join(timeout=900)
        torch.set_num_threads(threads)
    if "error" in box:
        raise box["error"]
    assert not ranks.is_alive() and "res" in box, "the two-rank job did not finish"
    return dict(res=box["res"], runs=runs, draws=draws, none=none, inputs=inputs, directory=directory)


def key(name, shape):
    return f"{name}@{shape[0]}x{shape[1]}::"


def bn_biases(params):
    """The Dense biases in front of a BatchNorm: their exact gradient is 0, so Adam moves them by float noise."""
    return {k for k in params if k.endswith(".bias") and k.replace("Dense_", "BatchNorm_").replace(".bias", ".weight") in params}


def assert_trained_like(res, prefix, loss, params, tol, steps):
    np.testing.assert_allclose(res[prefix + "loss"], loss, rtol=tol["loss_rtol"], atol=tol["loss_atol"], err_msg=prefix + "loss")
    shift_invariant = bn_biases(params)
    for k, v in params.items():
        got = res[prefix + "param/" + k]
        if k in shift_invariant:  # Adam's ±lr steps on noise: within lr a step (tests/test_sharding.py:62)
            assert np.abs(got - v).max() <= 2 * 1e-3 * steps + tol["atol"], prefix + k
        else:
            np.testing.assert_allclose(got, v, rtol=tol["rtol"], atol=tol["atol"], err_msg=prefix + k)


def steps_of(spec):
    n, b = {"seq": (M.HSTU_N, M.HSTU_BATCH), "ctr": (M.CTR_N, M.CTR_BATCH), "match": (M.MATCH_N, M.MATCH_BATCH), "mtl": (M.MTL_N, M.MTL_BATCH), "rqvae": (M.RQ_N, M.RQ_BATCH)}[spec["kind"]]
    return M.epochs_of(spec) * n // b


@pytest.mark.parametrize("shape", M.MESHES, ids=str)
@pytest.mark.parametrize("name", JAX_SCENARIOS)
def test_mesh_trains_as_the_jax_package(job, name, shape):
    """Losses and every parameter after training under the mesh against the JAX package's (sparse runs: the
    accumulators too); the trained model's predictions (and the seq runs' evaluation) under the mesh too.  Under (1, 2) the vocab / fused tables are really
    row-sharded (tests/test_sharding.py:71, :264), under (2, 1) nothing is."""
    spec, run, res = M.SPECS[name], job["runs"][name], job["res"]
    if name == "dssm_local_hard" and shape == (1, 2):  # no data axis: the local pool is the global one (JAX mesh=None)
        run = job["runs"]["dssm_global_hard"]
        for k, v in job["runs"][name].init.items():
            torch.testing.assert_close(v, run.init[k], rtol=0, atol=0)
    tol = {"seq": SEQ_TOL, "ctr": CTR_TOL, "match": MATCH_TOL}[spec["kind"]]
    prefix = key(name, shape)
    assert_trained_like(res, prefix, run.loss, run.params, tol, steps_of(spec))
    for k, v in getattr(run, "accums", {}).items():
        np.testing.assert_allclose(res[prefix + "accum/" + k], v, rtol=tol["rtol"], atol=tol["atol"] * max(float(v.max()), 1e-12), err_msg=prefix + k)
    if hasattr(run, "predict"):  # the trained model served under the mesh: the whole batch on every rank
        np.testing.assert_allclose(res[prefix + "predict"], run.predict, rtol=tol["rtol"], atol=tol["atol"], err_msg=prefix + "predict")
    if hasattr(run, "evaluate"):  # (loss, top-1): the chunked loss and last-position logits of the vocab shards
        np.testing.assert_allclose(res[prefix + "evaluate"], run.evaluate, rtol=tol["loss_rtol"], err_msg=prefix + "evaluate")
    sharded = set(res[prefix + "sharded"]) - {""}
    expected = {"hstu_chunked": {"token_embedding"}, "hstu_sampled_sparse": {"token_embedding", "output_projection"}, "deepfm_fused_adagrad": {"EmbeddingCollection_0.fused_d8_table"}}
    assert sharded == (expected.get(name, set()) if shape == (1, 2) else set()), sharded


def test_sampled_negatives_are_drawn_as_without_a_mesh(job):
    """The sampled softmax's negatives are drawn at the global shape from the trainer's generator on every rank:
    the (2, 1) run trains as the port's mesh=None run does (test_sharding.py:438's tolerances)."""
    ref = job["draws"]["hstu_sampled_drawn"]
    assert_trained_like(job["res"], key("hstu_sampled_drawn", (2, 1)), ref["loss"], {k[6:]: v for k, v in ref.items() if k.startswith("param/")}, SEQ_TOL, steps_of(M.SPECS["hstu_sampled_drawn"]))


def test_uniform_global_pool_draws_as_without_a_mesh(job):
    """Uniform in-batch negatives over the global pool: keys drawn at the global batch's shape, this rank's rows
    taken, so the (2, 1) run equals the port's mesh=None run (test_sharding.py:100's tolerances)."""
    ref = job["draws"]["dssm_global_uniform"]
    assert_trained_like(job["res"], key("dssm_global_uniform", (2, 1)), ref["loss"], {k[6:]: v for k, v in ref.items() if k.startswith("param/")}, MATCH_TOL, steps_of(M.SPECS["dssm_global_uniform"]))


def test_per_rank_negatives_would_fail(job):
    """The same run with the uniform keys drawn per rank at the local shape does not match mesh=None."""
    ref = job["draws"]["dssm_global_uniform"]
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(job["res"][key("dssm_global_uniform_per_rank", (2, 1)) + "loss"], ref["loss"], rtol=MATCH_TOL["loss_rtol"], atol=MATCH_TOL["loss_atol"])


def test_per_rank_batchnorm_would_fail(job):
    """DeepFM under (2, 1) with BatchNorm's statistics left per rank does not match the JAX package, whose
    program normalises over the global batch."""
    run = job["runs"]["deepfm_dense"]
    with pytest.raises(AssertionError):
        assert_trained_like(job["res"], key("deepfm_dense_per_rank_bn", (2, 1)), run.loss, run.params, CTR_TOL, steps_of(M.SPECS["deepfm_dense"]))


MTL_CASES = [(name, shape) for name in MTL_SCENARIOS for shape in M.SPECS[name].get("meshes", M.MESHES)]


@pytest.mark.parametrize("name,shape", MTL_CASES, ids=[f"{n}-{s}" for n, s in MTL_CASES])
def test_mtl_mesh_trains_as_the_jax_package(job, name, shape):
    """MTLTrainer under the mesh against the JAX package's mesh=None run at tests/test_sharding.py:304's tolerances:
    the task losses, every parameter (the Dense biases in front of a BatchNorm within 2 lr a step), every rank's
    loss weights (UWL, GradNorm), the sparse accumulators and the trained model's predictions.  Under (1, 2) a fused
    table is row-sharded: GradNorm's leaf (SharedBottom), one of MetaBalance's norms, the sparse Adagrad table."""
    spec, run, res, prefix = M.SPECS[name], job["runs"][name], job["res"], key(name, shape)
    assert_trained_like(res, prefix, run.loss, run.params, MTL_TOL, steps_of(spec))
    if hasattr(run, "loss_weight"):
        for rank, weights in enumerate(res[prefix + "loss_weight"]):
            np.testing.assert_allclose(weights, run.loss_weight, **LOSS_WEIGHT_TOL, err_msg=f"{prefix}loss_weight of rank {rank}")
    for k, v in getattr(run, "accums", {}).items():
        np.testing.assert_allclose(res[prefix + "accum/" + k], v, rtol=MTL_TOL["rtol"], atol=MTL_TOL["atol"] * max(float(v.max()), 1e-12), err_msg=prefix + k)
    np.testing.assert_allclose(res[prefix + "predict"], run.predict, rtol=MTL_TOL["rtol"], atol=MTL_TOL["atol"], err_msg=prefix + "predict")
    sharded = set(res[prefix + "sharded"]) - {""}
    assert sharded == ({"embedding.fused_d6_table"} if spec.get("fused") and shape == (1, 2) else set()), sharded


@pytest.mark.parametrize("name", RQ_SCENARIOS)
def test_rqvae_mesh_trains_as_the_jax_package(job, name):
    """RQVAETrainer under (2, 1), the k-means init run by each rank, against the JAX package's mesh=None run at
    tests/test_sharding.py:351 and :369's tolerances (the best loss, every parameter), and the codes of
    ``generate_semantic_ids`` equal; with Sinkhorn on the last stage, each training call's codes over the global
    batch equal the port's mesh=None run's."""
    run, res, prefix = job["runs"][name], job["res"], key(name, (2, 1))
    assert_trained_like(res, prefix, run.loss, run.params, RQ_TOL, steps_of(M.SPECS[name]))
    np.testing.assert_array_equal(res[prefix + "sids"], run.sids)
    if name == "rqvae_sinkhorn":
        ref = job["draws"][name]["sk_codes"]
        assert ref.shape == (steps_of(M.SPECS[name]), M.RQ_BATCH)
        np.testing.assert_array_equal(res[prefix + "sk_codes"], ref)


def test_per_rank_gradnorm_would_fail(job):
    """MMOE under GradNorm with each rank's norms taken from its own share of the leaf's gradient: the ranks' loss
    weights part, and leave tests/test_sharding.py:311's tolerance of the JAX package's."""
    run, got = job["runs"]["mmoe_gradnorm"], job["res"][key("mmoe_gradnorm_per_rank", (2, 1)) + "loss_weight"]
    assert not np.array_equal(got[0], got[1])
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got, np.broadcast_to(run.loss_weight, got.shape), **LOSS_WEIGHT_TOL)


def test_local_sinkhorn_would_fail(job):
    """RQ-VAE under (2, 1) with Sinkhorn over each rank's rows and its local batch size: its codes in training
    differ from the mesh=None run's."""
    got, ref = job["res"][key("rqvae_sinkhorn_local", (2, 1)) + "sk_codes"], job["draws"]["rqvae_sinkhorn"]["sk_codes"]
    assert got.shape == ref.shape and (got != ref).any()


@pytest.mark.parametrize("mode", (1, 2))
def test_local_inbatch_loss_equals_the_hand_computed_blocks(job, mode):
    """Each rank's (b, b) block on its JAX keys, combined over the data group, equals tests/test_sharding.py:165's
    hand-computed blocks and the JAX package's ``local_inbatch_loss`` under a two-device data mesh; the users'
    gradients equal the hand-computed loss's."""
    lp, k, b = job["inputs"]["local_pool"], M.LOCAL_POOL["k"], M.LOCAL_POOL["b"]
    key0 = jax.random.PRNGKey(JAX_KEY)

    def blocks(user):
        loss_sum = w_sum = 0.0
        for i in range(2):
            u_i, it_i, w_i = user[i * b:(i + 1) * b], jnp.asarray(lp["item"][i * b:(i + 1) * b]), jnp.asarray(lp["w"][i * b:(i + 1) * b])
            scores = u_i @ it_i.T
            neg_idx = jmatch.inbatch_negative_sampling(scores, neg_ratio=k, rng=jax.random.fold_in(key0, i))
            ls, ws = jmatch.inbatch_loss_from_logits(jmatch.gather_inbatch_logits(scores, neg_idx), mode, weight=w_i)
            loss_sum, w_sum = loss_sum + ls, w_sum + ws
        return loss_sum / w_sum

    user = jnp.asarray(lp["user"])
    ref, ref_grad = jax.value_and_grad(blocks)(user)
    jmesh = jcreate_mesh(data=2, model=1, devices=jax.devices()[:2])
    sharded = jmatch.local_inbatch_loss(user, jnp.asarray(lp["item"]), jnp.asarray(lp["w"]), key0, jmesh, mode, neg_ratio=k)
    got = job["res"][f"local_pool::mode{mode}::loss"]
    np.testing.assert_allclose(got, float(ref), rtol=LOCAL_POOL_RTOL)
    np.testing.assert_allclose(got, float(sharded), rtol=LOCAL_POOL_RTOL)
    np.testing.assert_allclose(job["res"][f"local_pool::mode{mode}::grad"], np.asarray(ref_grad), rtol=LOCAL_POOL_RTOL, atol=1e-7)


@pytest.mark.parametrize("items", (M.TOPK["items"], M.TOPK["items"] + 1), ids=("split", "replicated"))
def test_sharded_exact_topk_equals_the_jax_package(job, items):
    """Exact top-k with the corpus split over the two ranks (and replicated where its rows do not split): the
    indices equal the JAX package's unsharded call, the scores within rtol 1e-5 (tests/test_sharding.py:133)."""
    t = job["inputs"]["topk"]
    idx, vals = jbrute_force_topk(t["users"], t["items"][:items], M.TOPK["k"])
    np.testing.assert_array_equal(job["res"][f"topk{items}::idx"], idx)
    np.testing.assert_allclose(job["res"][f"topk{items}::vals"], vals, rtol=TOPK_RTOL)


def test_prefetch_keeps_each_ranks_rows(job):
    """``prefetch_to_device(sharding=scan_batch_sharding(mesh))`` under (2, 1): each rank's groups are its data
    index's rows of axis 1, in order."""
    got = job["res"]["prefetch::ranks"]
    groups = np.arange(4 * 6 * 3).reshape(4, 6, 3)
    for rank in range(2):
        want = np.stack([a for g in range(3) for a in (groups[:, rank * 3:(rank + 1) * 3] + 1000 * g,) * 2])
        np.testing.assert_array_equal(got[rank], want)


def test_global_batch_from_host_concatenates_the_data_ranks_rows(job):
    rows = np.arange(6 * 2).reshape(6, 2)
    np.testing.assert_array_equal(job["res"]["global_batch"], np.concatenate([rows, 100 + rows]))


def test_checkpoints_move_between_a_mesh_and_none(job):
    """The (1, 2) run's step-4 checkpoint (written by rank 0, unsharded) restores into a mesh=None trainer equal to
    the tensor, and mesh=None's restores under (1, 2) equal to the tensor, at step 4."""
    res, spec = job["res"], M.SPECS["deepfm_fused_adagrad"]
    restored = M.trainer_of(spec, M.build(spec), None, "cpu", str(job["directory"] / "restored"))
    restored.enable_step_checkpointing(str(job["directory"] / "ckpt_mesh"), every_n_steps=4)
    assert restored.maybe_resume() == 4
    for k, v in flat_tensors(restored.train_state()):
        if isinstance(v, torch.Tensor):
            np.testing.assert_array_equal(v.numpy(), res[f"ckpt_mesh::{k}"], err_msg=k)
    assert int(res["ckpt_none::resumed_step"]) == 4
    for k, v in flat_tensors(job["none"].train_state()):
        if isinstance(v, torch.Tensor):
            np.testing.assert_array_equal(res[f"ckpt_none::{k}"], v.numpy(), err_msg=k)
