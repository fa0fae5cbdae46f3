"""DeepFM at production table geometry on the PyTorch port: fused tables + sparse row-wise updates.

The other ranking examples mirror the sample-data scripts; this one
demonstrates the knobs that only matter at production scale, as
``examples/ranking/run_criteo_production.py``:

- power-law vocabs with multi-million-row tables (``--scale`` shrinks them
  for a laptop-friendly dry run);
- the ``"auto"`` fused table layout (tables >= 262144 rows share one
  row-shardable ``(ΣV, D)`` parameter);
- ``sparse_embedding="adagrad"`` row-wise updates: only the rows a batch
  touched are updated, keeping step time flat in vocab size;
- optional ``--precision bf16`` and ``--mesh data,model``: the mesh runs one
  process a card, started by ``torchrun --nproc-per-node=<data x model>``
  (``parallel.distributed.initialize`` reads its environment), and each
  rank's ``DeviceCachedLoader`` uploads only its rows of every batch.

Run:
    python examples_torch/ranking/run_criteo_production.py --scale 0.01 --epochs 1
``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np

VOCABS_FULL = [4_000_000, 2_000_000, 1_000_000, 500_000, 300_000, 300_000, 200_000, 100_000, 50_000, 50_000] + [10_000] * 16


def synthetic_clicks(scale, n, seed):
    """``(vocabs, x, y)``: 26 zipf(1.2) id columns over the scaled Criteo-full vocabs, 13 normal dense columns, and
    labels from the two hottest id parities and I0."""
    vocabs = [max(64, int(v * scale)) for v in VOCABS_FULL]
    rng = np.random.default_rng(seed)
    x = {f"C{i}": (rng.zipf(1.2, n) % v).astype(np.int32) for i, v in enumerate(vocabs)}
    x.update({f"I{i}": rng.normal(size=n).astype(np.float32) for i in range(13)})
    # learnable labels so AUC moves: depends on the two hottest id parities + I0
    logit = (x["C0"] % 2) * 1.0 + (x["C1"] % 2) * 1.0 - 1.0 + x["I0"]
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    return vocabs, x, y


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=1.0, help="vocab scale factor (0.01 for a quick dry run)")
    ap.add_argument("--n-examples", type=int, default=262144)
    ap.add_argument("--batch-size", type=int, default=4096)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--embedding-optimizer", choices=["adagrad", "sgd"], default="adagrad")
    ap.add_argument("--precision", choices=["f32", "bf16"], default="f32")
    ap.add_argument("--mesh", default=None, help="'data,model' sizes, e.g. '4,2' (default: no mesh)")
    ap.add_argument("--seed", type=int, default=2022)
    ap.add_argument("--device", default=None, help="default: the card (raises without one); cpu runs on the CPU")
    args = ap.parse_args()

    from torch_rechub_tpu_torch.basic.features import DenseFeature, SparseFeature
    from torch_rechub_tpu_torch.models.ranking import DeepFM
    from torch_rechub_tpu_torch.trainers import CTRTrainer
    from torch_rechub_tpu_torch.trainers.base import resolve_device
    from torch_rechub_tpu_torch.utils.data import DeviceCachedLoader

    mesh = None
    if args.mesh:
        from torch_rechub_tpu_torch.parallel import create_mesh, distributed

        d, m = (int(s) for s in args.mesh.split(","))
        distributed.initialize()  # torchrun's environment; under nccl each rank takes its card
        mesh = create_mesh(data=d, model=m)
    device = resolve_device(args.device)

    n = args.n_examples
    vocabs, x, y = synthetic_clicks(args.scale, n, args.seed)

    sparse = tuple(SparseFeature(f"C{i}", vocab_size=v, embed_dim=16) for i, v in enumerate(vocabs))
    dense = tuple(DenseFeature(f"I{i}") for i in range(13))

    # at --scale < 1 the big tables may fall under the auto-fuse threshold;
    # sparse_embedding requires fused tables, so fuse everything explicitly
    import torch

    from torch_rechub_tpu_torch.ops.embedding import set_fused_default

    old = set_fused_default(True if args.scale < 1.0 else "auto")
    try:
        model = DeepFM(deep_features=dense, fm_features=sparse, mlp_params={"dims": (256, 128), "dropout": 0.0, "activation": "relu"},
                       generator=torch.Generator().manual_seed(args.seed), device=device)
        trainer = CTRTrainer(
            model,
            n_epoch=args.epochs,
            model_path=os.path.join(tempfile.gettempdir(), "criteo_production"),
            steps_per_call=32,
            sparse_embedding=args.embedding_optimizer,
            precision=None if args.precision == "f32" else args.precision,
            mesh=mesh,
            seed=args.seed,
            device=device,
        )
        loader = DeviceCachedLoader(x, y, batch_size=args.batch_size, group_size=32, mesh=mesh, device=device)
        for epoch in range(args.epochs):
            t0 = time.perf_counter()
            loss = trainer.train_one_epoch(loader, log_interval=0)
            dt = time.perf_counter() - t0
            print(f"epoch {epoch}: loss {loss:.5f}  {n / dt:,.0f} examples/s")
        auc = trainer.evaluate(model, loader, bucketed=True)
        print(f"train AUC (bucketed, device-side): {auc:.4f}")
    finally:
        set_fused_default(old)


if __name__ == "__main__":
    main()
