"""The Parquet input pipeline (``data/``) against the JAX package's, on files written in ``tmp_path``: every
batch of ``ParquetIterableDataset`` (its boundaries across files, the label column, the dtypes, fixed-width list
columns) and of each ``shard``, and ``pa_array_to_numpy``; a ragged list column raises in both.
``prefetch_to_device`` hands over the iterator's values in its order (on the CPU here; the card's pinned copy
stream is in ``test_torch_cuda_lifecycle.py``), refuses a ``sharding`` that is not a mesh layout and defaults to
the card; ``CTRTrainer``'s loop gives the same losses through it as through synchronous copies.
"""

import numpy as np
import pytest
import torch

pa = pytest.importorskip("pyarrow")
pq = pytest.importorskip("pyarrow.parquet")

from test_torch_ctr_model import carried_deepfm, ctr_batch  # noqa: E402
from torch_rechub_tpu.data import ParquetIterableDataset as JDataset  # noqa: E402
from torch_rechub_tpu.data import pa_array_to_numpy as jconvert  # noqa: E402
from torch_rechub_tpu_torch.data import ParquetIterableDataset, pa_array_to_numpy, prefetch_to_device  # noqa: E402
from torch_rechub_tpu_torch.trainers import CTRTrainer  # noqa: E402
from torch_rechub_tpu_torch.utils.data import ArrayLoader  # noqa: E402


def write_files(tmp_path, sizes=(10, 5, 12), seed=0):
    rng = np.random.default_rng(seed)
    paths = []
    for i, n in enumerate(sizes):
        table = pa.table({
            "C0": pa.array(rng.integers(0, 100, n), pa.int64()),
            "I0": pa.array(rng.normal(size=n), pa.float64()),
            "hist": pa.array([list(rng.integers(1, 50, 3)) for _ in range(n)], pa.list_(pa.int32())),
            "fixed": pa.array([list(rng.normal(size=2)) for _ in range(n)], pa.list_(pa.float32(), 2)),
            "label": pa.array(rng.integers(0, 2, n), pa.int8()),
        })
        path = tmp_path / f"part-{i}.parquet"
        pq.write_table(table, path, row_group_size=4)
        paths.append(str(path))
    return paths


def batches(ds):
    out = []
    for batch in ds:
        x, y = batch if isinstance(batch, tuple) else (batch, None)
        out.append(({k: v for k, v in x.items()}, y))
    return out


def assert_same_batches(got, ref):
    assert len(got) == len(ref)
    for (x, y), (jx, jy) in zip(got, ref):
        assert list(x) == list(jx)
        for k in jx:
            assert x[k].dtype == jx[k].dtype and np.array_equal(x[k], jx[k]), k
        assert (y is None and jy is None) or (y.dtype == jy.dtype and np.array_equal(y, jy))


@pytest.mark.parametrize("batch_size", [4, 7, 100])
def test_parquet_batches_match_jax(tmp_path, batch_size):
    paths = write_files(tmp_path)
    kw = dict(batch_size=batch_size, label_col="label", dtype_map={"C0": np.int32, "hist": np.int32})
    got, ref = batches(ParquetIterableDataset(str(tmp_path / "*.parquet"), **kw)), batches(JDataset(str(tmp_path / "*.parquet"), **kw))
    assert_same_batches(got, ref)
    assert sum(len(y) for _, y in got) == 27 and got[0][0]["hist"].shape[1] == 3 and got[0][0]["fixed"].shape[1] == 2
    for n in (2, 3):
        for i in range(n):
            assert_same_batches(batches(ParquetIterableDataset(paths, **kw).shard(n, i)), batches(JDataset(paths, **kw).shard(n, i)))
    cols = dict(batch_size=batch_size, columns=["C0", "I0"])
    assert_same_batches(batches(ParquetIterableDataset(paths, **cols)), batches(JDataset(paths, **cols)))
    with pytest.raises(ValueError, match="out of range"):
        ParquetIterableDataset(paths).shard(2, 2)
    with pytest.raises(ValueError, match="no parquet files matched"):
        ParquetIterableDataset(str(tmp_path / "none-*.parquet"))


def test_pa_array_to_numpy_and_ragged_columns(tmp_path):
    chunked = pa.chunked_array([pa.array([[1, 2], [3, 4]], pa.list_(pa.int64())), pa.array([[5, 6]], pa.list_(pa.int64()))])
    got, ref = pa_array_to_numpy(chunked, dtype=np.int64), jconvert(chunked, dtype=np.int64)
    assert got.dtype == ref.dtype and np.array_equal(got, ref) and got.shape == (3, 2)
    ragged = pa.array([[1, 2], [3]], pa.list_(pa.int64()))
    for convert in (pa_array_to_numpy, jconvert):
        with pytest.raises(ValueError, match="ragged list column"):
            convert(ragged)
    pq.write_table(pa.table({"a": ragged}), tmp_path / "ragged.parquet")
    with pytest.raises(ValueError, match="ragged list column"):
        list(ParquetIterableDataset(str(tmp_path / "ragged.parquet")))


def test_prefetch_to_device_keeps_values_and_order():
    rng = np.random.default_rng(1)
    items = [({"a": rng.integers(0, 9, (2, 3)).astype(np.int32), "b": rng.normal(size=4).astype(np.float32)}, rng.normal(size=2), None) for _ in range(5)]
    for size in (1, 2, 8):
        out = list(prefetch_to_device(iter(items), size=size, device="cpu"))
        assert len(out) == len(items)
        for (x, y, none), (rx, ry, _) in zip(out, items):
            assert none is None and isinstance(y, torch.Tensor) and np.array_equal(y.numpy(), ry)
            assert all(x[k].dtype == torch.from_numpy(rx[k]).dtype and np.array_equal(x[k].numpy(), rx[k]) for k in rx)
    with pytest.raises(TypeError, match="BatchSharding"):  # a mesh layout is taken (tests/test_torch_mesh_train.py); anything else raises
        next(prefetch_to_device(iter(items), sharding=object(), device="cpu"))
    with pytest.raises(ValueError, match="size >= 1"):
        next(prefetch_to_device(iter(items), size=0, device="cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            next(prefetch_to_device(iter(items)))


def test_ctr_loop_losses_through_prefetch_equal_synchronous_copies():
    x = ctr_batch(96, seed=6)
    y = np.random.default_rng(6).integers(0, 2, 96).astype(np.float32)
    results = []
    for prefetch in (True, False):
        trainer = CTRTrainer(carried_deepfm()[2], steps_per_call=2, device="cpu")
        if not prefetch:  # each group copied when it is taken
            trainer._groups = lambda loader, t=trainer: (t._to_device(*group) for group in t._iter_groups(loader))
        losses = [trainer.train_one_epoch(ArrayLoader(x, y, batch_size=16), log_interval=0) for _ in range(2)]
        results.append((losses, trainer.model.state_dict()))
    assert results[0][0] == results[1][0]
    assert all(torch.equal(v, results[1][1][k]) for k, v in results[0][1].items())
