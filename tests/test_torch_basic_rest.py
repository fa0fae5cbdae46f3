"""The rest of ``basic/loss.py``, ``basic/metric.py`` and ``basic/tracking.py`` against the JAX package's:
``hinge_loss`` (with WARP weighting), ``nce_loss`` and ``in_batch_nce_loss`` with their gradients (rtol 1e-5,
atol 1e-6: float32 sums of up to 24 terms, the product of the in-batch logits' gradient, in another order), ``gauc_score`` / ``get_user_pred`` / ``auc_score_bucketed``, and the
loggers: ``ConsoleLogger``'s printed and JSON lines equal the JAX package's at the same clock, ``TensorBoardXLogger``
writes an event file, and the W&B and SwanLab loggers import their packages only when made.
"""

import importlib.util
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_rechub_tpu.basic import loss as jloss
from torch_rechub_tpu.basic import metric as jmetric
from torch_rechub_tpu.basic import tracking as jtracking
from torch_rechub_tpu_torch.basic import loss as tloss
from torch_rechub_tpu_torch.basic import metric as tmetric
from torch_rechub_tpu_torch.basic import tracking as ttracking

RTOL, ATOL = 1e-5, 1e-6


def value_and_grads(tfn, jfn, arrays):
    """The port's loss and its gradients in every float input, and the JAX package's."""
    tensors = [torch.tensor(a, requires_grad=a.dtype == np.float32) for a in arrays]
    out = tfn(*tensors)
    out.backward()
    floats = [i for i, a in enumerate(arrays) if a.dtype == np.float32]
    jval, jgrads = jax.value_and_grad(lambda *fs: jfn(*[fs[floats.index(i)] if i in floats else jnp.asarray(a) for i, a in enumerate(arrays)]), argnums=tuple(range(len(floats))))(*[jnp.asarray(arrays[i]) for i in floats])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jval), rtol=RTOL, atol=ATOL)
    for k, i in enumerate(floats):
        np.testing.assert_allclose(tensors[i].grad.numpy(), np.asarray(jgrads[k]), rtol=RTOL, atol=ATOL, err_msg=str(i))


@pytest.mark.parametrize("num_items", [None, 100])
@pytest.mark.parametrize("neg_dims", [1, 2])
def test_hinge_loss_matches_jax(num_items, neg_dims):
    rng = np.random.default_rng(0)
    pos = rng.normal(size=(16, 1)).astype(np.float32)
    neg = rng.normal(size=(16, 5) if neg_dims == 2 else 16).astype(np.float32)
    weight = (rng.random(16) > 0.2).astype(np.float32)
    value_and_grads(lambda p, n: tloss.hinge_loss(p, n, margin=1.0, num_items=num_items), lambda p, n: jloss.hinge_loss(p, n, margin=1.0, num_items=num_items), [pos, neg])
    value_and_grads(lambda p, n, w: tloss.hinge_loss(p, n, num_items=num_items, weight=w), lambda p, n, w: jloss.hinge_loss(p, n, num_items=num_items, weight=w), [pos, neg, weight.astype(np.float64)])


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_nce_and_in_batch_nce_losses_match_jax(reduction):
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(4, 6, 10)).astype(np.float32)
    targets = rng.integers(0, 10, (4, 6)).astype(np.int64)
    targets[0, :3] = 0  # ignored
    reduce = (lambda t: (t * t).sum()) if reduction == "none" else (lambda t: t)  # a scalar with a gradient per element
    value_and_grads(lambda lg, t: reduce(tloss.nce_loss(lg, t, temperature=0.5, reduction=reduction)), lambda lg, t: reduce(jloss.nce_loss(lg, t, temperature=0.5, reduction=reduction)), [logits, targets])
    users, items = rng.normal(size=(8, 4)).astype(np.float32), rng.normal(size=(12, 4)).astype(np.float32)
    tgt = rng.integers(0, 12, 8).astype(np.int64)
    value_and_grads(lambda u, i, t: reduce(tloss.in_batch_nce_loss(u, i, t, reduction=reduction)), lambda u, i, t: reduce(jloss.in_batch_nce_loss(u, i, t, reduction=reduction)), [users, items, tgt])


def test_gauc_user_pred_and_bucketed_auc_match_jax():
    rng = np.random.default_rng(2)
    users = rng.integers(0, 5, 200)
    y = rng.integers(0, 2, 200).astype(np.float32)
    p = rng.random(200).astype(np.float32)
    assert tmetric.get_user_pred(y, p, users) == jmetric.get_user_pred(y, p, users)
    assert tmetric.gauc_score(y, p, users) == jmetric.gauc_score(y, p, users)
    weights = {u: float(u + 1) for u in range(5)}
    assert tmetric.gauc_score(y, p, users, weights) == jmetric.gauc_score(y, p, users, weights)
    np.testing.assert_allclose(tmetric.auc_score_bucketed(y, p), jmetric.auc_score_bucketed(y, p), rtol=1e-6)
    np.testing.assert_allclose(tmetric.auc_score_bucketed(torch.from_numpy(y), torch.from_numpy(p), n_bins=64), jmetric.auc_score_bucketed(y, p, n_bins=64), rtol=1e-6)
    with pytest.raises(ValueError, match="labels"):
        tmetric.gauc_score(y, p, users[:10])


def test_console_logger_lines_match_jax(tmp_path, monkeypatch, capsys):
    lines = {}
    for name, module in (("port", ttracking), ("jax", jtracking)):
        monkeypatch.setattr(module.time, "time", lambda: 1234.5)
        logger = module.ConsoleLogger(str(tmp_path / name / "log.jsonl"))
        logger.log_hyperparams({"lr": 1e-3, "dims": (8, 4)})
        logger.log_metrics({"train/loss": 0.123456789, "n": 3}, step=2)
        logger.finish()
        lines[name] = (capsys.readouterr().out, (tmp_path / name / "log.jsonl").read_text())
    assert lines["port"] == lines["jax"]
    assert json.loads(lines["port"][1].splitlines()[1]) == {"ts": 1234.5, "step": 2, "train/loss": 0.123456789, "n": 3}
    console = ttracking.ConsoleLogger()
    assert ttracking.iter_loggers(console) == (console,) and ttracking.iter_loggers([console, console]) == (console, console)


def test_tensorboardx_logger_writes_events(tmp_path):
    pytest.importorskip("tensorboardX")
    logger = ttracking.TensorBoardXLogger(str(tmp_path / "runs"))
    logger.log_hyperparams({"lr": 1e-3})
    logger.log_metrics({"train/loss": 0.5}, step=1)
    logger.finish()
    assert [p.name for p in (tmp_path / "runs").iterdir() if p.name.startswith("events.out.tfevents")]


@pytest.mark.parametrize("cls,package", [("WandbLogger", "wandb"), ("SwanLabLogger", "swanlab")])
def test_optional_loggers_import_their_package_when_made(cls, package):
    if importlib.util.find_spec(package) is not None:
        pytest.skip(f"{package} is installed: making the logger would start a run")
    with pytest.raises(ImportError, match=package):
        getattr(ttracking, cls)()
