"""The port's 13 matching models against the JAX package on carried weights,
at the sizes of ``tests/test_e2e_matching.py`` with dropout 0.

For each class: the training output in eval and train mode, the BatchNorm
statistics the train forward leaves, and the ``mode="user"`` / ``"item"``
towers in eval and train mode (NARM, STAMP and SASRec through the same
weights built with an item feature).  The embedding tables are redrawn at
N(0, 0.3²) first, as in the ranking zoo's tests: with the fresh 1e-4
tables SINE's concept scores lie within rounding of each other, so its
top-k picks other concepts on either side, and every tower sits near 0.
MIND's random routing start is given to both sides (the JAX draw is
replaced by the same array).  Then the traps: SINE's concept top-k on tied
scores, MIND's fixed routing start at inference, GRU4Rec over PAD steps,
NARM's unnormalised attention, and the carrier on matching's raw
parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ctr_model import np_tree
from test_torch_cuda_matching import BATCH, MATCH_MODELS, N_ITEMS, OUT_ATOL, OUT_RTOL, SEQ_LEN, TOWER_VARIANTS, build_match, given_routing_start, match_frame
from torch_rechub_tpu.basic import features as jfeat
from torch_rechub_tpu.models import matching as jmatching
from torch_rechub_tpu_torch.basic import features as tfeat
from torch_rechub_tpu_torch.basic import layers as tlayers
from torch_rechub_tpu_torch.models import matching as tmatching
from torch_rechub_tpu_torch.utils.jax_weights import flax_to_state_dict, load_flax_params

TABLES = ("_table", "_embedding", "position_emb")
STATS_RTOL, STATS_ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def jax_batch(x):
    return {k: jnp.asarray(v) for k, v in x.items()}


def torch_batch(x):
    return {k: torch.from_numpy(v) for k, v in x.items()}


def redrawn(variables, seed):
    """``params`` with every embedding table redrawn at N(0, 0.3²); running means moved by N(0, 0.3²) and
    variances scaled by U(0.5, 1.5), so eval mode reads statistics off their start."""
    rng = np.random.default_rng(seed)

    def table(path, a):
        return (rng.normal(size=a.shape) * 0.3).astype(np.float32) if str(path[-1].key).endswith(TABLES) else a

    def stat(path, a):
        return (a * rng.uniform(0.5, 1.5, a.shape) if path[-1].key == "var" else a + rng.normal(size=a.shape) * 0.3).astype(np.float32)

    return {"params": jax.tree_util.tree_map_with_path(table, variables["params"]),
            "batch_stats": jax.tree_util.tree_map_with_path(stat, variables.get("batch_stats", {}))}


def jax_routing(monkeypatch, start):
    """The JAX capsule's routing draw ``jax.random.normal(key, (B, K, L))`` replaced by ``start`` (any other
    draw as it is), while a test traces."""
    normal = jax.random.normal

    def given(key, shape=(), dtype=jnp.float32):
        return jnp.asarray(start, dtype) if tuple(shape) == start.shape else normal(key, shape, dtype)

    monkeypatch.setattr(jax.random, "normal", given)


def carried(name, seed=0):
    """The flax model, its redrawn variables, and the port's model carrying them."""
    jmodel = build_match(jmatching, jfeat, name)
    x, _ = match_frame(8)
    init = jax.jit(lambda rng, batch: jmodel.init({"params": rng, "routing": rng, "dropout": rng}, batch, training=False))
    variables = redrawn(np_tree(init(jax.random.PRNGKey(seed), jax_batch(x))), seed)
    return jmodel, variables, load_flax_params(build_match(tmatching, tfeat, name), variables["params"], variables["batch_stats"])


def close(got, ref, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == np.shape(ref), what
    np.testing.assert_allclose(got, np.asarray(ref), rtol=OUT_RTOL, atol=OUT_ATOL, err_msg=what)


@pytest.mark.parametrize("name", MATCH_MODELS)
def test_matching_model_matches_jax(monkeypatch, name):
    start = given_routing_start(monkeypatch, seed=7)
    jax_routing(monkeypatch, start.numpy())
    jmodel, variables, model = carried(name)
    towers_name = TOWER_VARIANTS.get(name, name)
    jtowers = build_match(jmatching, jfeat, towers_name)
    x, _ = match_frame(BATCH, seed=3)
    jx, tx = jax_batch(x), torch_batch(x)
    rngs = {"routing": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)}

    @jax.jit
    def everything(v, batch):
        out = {"eval": jmodel.apply(v, batch, training=False)}
        out["train"], mutated = jmodel.apply(v, batch, training=True, rngs=rngs, mutable=["batch_stats"])
        for mode in ("user", "item"):
            out[f"{mode} eval"] = jtowers.apply(v, batch, training=False, mode=mode)
            out[f"{mode} train"] = jtowers.apply(v, batch, training=True, mode=mode, rngs=rngs, mutable=["batch_stats"])[0]
        return out, mutated

    ref, mutated = everything(variables, jx)
    for key, train in (("eval", False), ("train", True)):
        got = model.train(train)(tx)
        for i, (g, r) in enumerate(zip(got if isinstance(got, tuple) else (got,), ref[key] if isinstance(ref[key], tuple) else (ref[key],), strict=True)):
            close(g, r, f"{name} {key} output {i}")
    stats = flax_to_state_dict(np_tree(mutated.get("batch_stats", {})))
    assert set(stats) == {k for k, _ in model.named_buffers()}
    for key, b in model.named_buffers():  # the train forward's BatchNorm statistics
        np.testing.assert_allclose(b.numpy(), stats[key].numpy(), rtol=STATS_RTOL, atol=STATS_ATOL, err_msg=key)
    for mode in ("user", "item"):
        for train in (False, True):
            towers = load_flax_params(build_match(tmatching, tfeat, towers_name), variables["params"], variables["batch_stats"])  # the statistics as carried
            close(towers.train(train)(tx, mode=mode), ref[f"{mode} {'train' if train else 'eval'}"], f"{name} {mode} tower, train={train}")
    assert float(np.abs(np.asarray(ref["user eval"])).max()) > 0.05  # the redrawn tables reach the towers


def test_sine_concept_topk_takes_the_lower_index_first_among_ties():
    """SINE picks its intentions by ``jax.lax.top_k`` over the concept scores, which returns equal scores in
    index order; ``torch.topk`` promises no order.  With two concept prototypes equal, their scores tie in
    every row: the port's user tower still equals the JAX package's."""
    jmodel, variables, model = carried("SINE", seed=1)
    params = variables["params"]
    concepts = params["concept_embedding"].copy()
    concepts[[1, 4]] = concepts[2]  # three equal prototypes: a three-way tie in every row
    params = {**params, "concept_embedding": concepts}
    model = load_flax_params(build_match(tmatching, tfeat, "SINE"), params)
    x, _ = match_frame(BATCH, seed=4)
    ref = jax.jit(lambda p, batch: jmodel.apply({"params": p}, batch, mode="user"))(params, jax_batch(x))
    close(model.eval()(torch_batch(x), mode="user"), ref, "SINE user tower on tied concepts")
    scores = torch.from_numpy(np.tile(np.array([[1.0, 3.0, 2.0, 3.0, 3.0, 0.5]], np.float32), (4, 1)))
    vals, idx = jax.lax.top_k(jnp.asarray(scores.numpy()), 3)
    got = tmatching.sine.stable_topk(scores, 3)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(idx))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(vals))


def test_mind_routing_start_is_a_fixed_draw_at_inference():
    """MIND's capsule starts routing from N(0, 1) logits: from the trainer's generator in training; at
    inference the JAX package draws from ``PRNGKey(0)``, the port from a CPU generator seeded 0 (another
    array, the same on every device), so eval outputs repeat."""
    model = build_match(tmatching, tfeat, "MIND", generator=torch.Generator().manual_seed(0)).eval()
    x, _ = match_frame(16, seed=5)
    first, second = model(torch_batch(x), mode="user"), model(torch_batch(x), mode="user")
    assert torch.equal(first, second)
    start = tlayers.routing_start((16, 4, SEQ_LEN), False, None, "cpu")
    assert torch.equal(start, torch.randn((16, 4, SEQ_LEN), generator=torch.Generator().manual_seed(0)))
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    assert torch.equal(tlayers.routing_start((2, 4, 3), True, g1, "cpu"), tlayers.routing_start((2, 4, 3), True, g2, "cpu"))


def test_gru4rec_runs_its_gru_over_pad_steps():
    """As in the JAX package (and the reference's unpacked ``nn.GRU``), GRU4Rec's layers run every step
    with no mask: a history's user embedding changes when PAD steps are appended after it."""
    model = build_match(tmatching, tfeat, "GRU4Rec", generator=torch.Generator().manual_seed(0)).eval()
    x, _ = match_frame(8, seed=6, all_pad_rows=0)
    short = {k: v.copy() for k, v in x.items()}
    short["hist_item_id"][:, 5:] = 0
    trimmed = dict(short, hist_item_id=np.ascontiguousarray(short["hist_item_id"][:, :5]))
    assert not torch.allclose(model(torch_batch(short), mode="user"), model(torch_batch(trimmed), mode="user"))


def test_narm_attention_is_an_unnormalised_exp():
    """NARM weighs its states by ``exp(q)`` over the valid steps divided by their sum, not by a softmax with
    its max subtracted: scores of a size that overflows ``exp`` give inf / NaN, in either package."""
    model = build_match(tmatching, tfeat, "NARM", generator=torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        model.v.fill_(100.0)  # q = sigmoid(.) @ v up to 12 * 100, far past exp's fp32 range
    x, _ = match_frame(4, seed=2, all_pad_rows=0)
    assert not torch.isfinite(model(torch_batch(x), mode="user")).all()


def test_carrier_maps_matching_parameters():
    """The raw parameters (capsule ``w (1, L, K·D, D)``, ``convert_user_weight``, SINE's nine, NARM's
    ``a_1``, ``a_2``, ``v``, ``b``) are copied as they are, SASRec's ``DenseGeneral`` kernels flattened, and
    a kernel of no known layout still raises."""
    _, variables, model = carried("ComirecDR")
    w = variables["params"]["capsule"]["w"]
    assert w.shape == (1, SEQ_LEN, 32, 8)
    np.testing.assert_array_equal(model.capsule.w.detach().numpy(), w)
    _, variables, model = carried("SASRec")
    q = variables["params"]["attns_0"]["query"]["kernel"]
    np.testing.assert_array_equal(model.attns_0.query.weight.detach().numpy(), q.reshape(q.shape[0], -1).T)
    _, variables, model = carried("SINE")
    assert {k for k, _ in model.named_parameters()} == set(variables["params"])
    _, variables, model = carried("NARM")
    for key in ("a_1", "a_2", "v", "b", "item_embedding"):
        np.testing.assert_array_equal(getattr(model, key).detach().numpy(), variables["params"][key])
    with pytest.raises(ValueError, match="no mapping for a kernel"):
        flax_to_state_dict({"capsule": {"Dense_0": {"kernel": np.zeros((1, SEQ_LEN, 32, 8), np.float32)}}})
    assert N_ITEMS == model.item_embedding.shape[0]
