"""Export → quantize → serve on the PyTorch port: the deployment path end to end.

As ``examples/serving/run_quantize_export.py``: train a two-tower model,
export both towers with ``torch.export`` (``.pt2`` programs), quantize
parameters (int8 per-channel / fp16, dequantized inside the program), report
size + reconstruction error + retrieval agreement, then build an index over
the item embeddings and serve top-k queries (the port's ``builder_factory``
backends; ``annoy`` and ``faiss`` need their packages).

    python examples_torch/serving/run_quantize_export.py --backend bruteforce
    python examples_torch/serving/run_quantize_export.py --backend hnsw --mode fp16

``--device cpu`` runs it on the CPU.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from examples_torch.datasets import build_ml1m_matching_dataset
from torch_rechub_tpu_torch.models.matching import DSSM
from torch_rechub_tpu_torch.serving import builder_factory
from torch_rechub_tpu_torch.trainers import MatchTrainer
from torch_rechub_tpu_torch.trainers.base import resolve_device
from torch_rechub_tpu_torch.utils.data import ArrayLoader
from torch_rechub_tpu_torch.utils.export import linear_weight_names, load_exported, quantization_error


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--backend", default="bruteforce", choices=("bruteforce", "hnsw", "annoy", "faiss"))
    parser.add_argument("--mode", default="int8", choices=("int8", "fp16"))
    parser.add_argument("--epoch", type=int, default=2)
    parser.add_argument("--embed_dim", type=int, default=16)
    parser.add_argument("--topk", type=int, default=10)
    parser.add_argument("--save_dir", default="./saved/quantize_demo")
    parser.add_argument("--device", default=None, help="default: the card (raises without one); cpu runs on the CPU")
    args = parser.parse_args()
    device = resolve_device(args.device)

    bundle = build_ml1m_matching_dataset(embed_dim=args.embed_dim, mode=0, neg_ratio=3)
    model = DSSM(user_features=bundle.user_features, item_features=bundle.item_features, user_params={"dims": (64, args.embed_dim)}, item_params={"dims": (64, args.embed_dim)},
                 generator=torch.Generator().manual_seed(0), device=device)
    trainer = MatchTrainer(model, mode=0, n_epoch=args.epoch, model_path=args.save_dir, device=device)
    trainer.fit(ArrayLoader(bundle.x_train, bundle.y_train, batch_size=256, shuffle=True))

    # --- export both towers, fp32 AND quantized-with-in-graph-dequant --------
    examples = {
        "user": {k: np.asarray(v[:8]) for k, v in bundle.x_test_user.items()} if hasattr(bundle, "x_test_user") else {k: np.asarray(v[:8]) for k, v in bundle.x_train.items()},
        "item": {k: np.asarray(v[:8]) for k, v in bundle.x_all_item.items()},
    }
    paths = {}
    for mode in ("user", "item"):
        example = examples[mode]
        path = trainer.export(os.path.join(args.save_dir, f"dssm_{mode}"), example, mode=mode)
        q_path = trainer.export_quantized(os.path.join(args.save_dir, f"dssm_{mode}_{args.mode}"), example, mode=mode, quant_mode=args.mode)
        paths[mode] = (path, q_path)
        fp_kb = os.path.getsize(path) / 1024
        q_kb = os.path.getsize(q_path) / 1024
        print(f"exported {mode} tower -> fp32 {fp_kb:.1f} KiB .pt2, {args.mode} artifact {q_kb:.1f} KiB ({fp_kb / max(q_kb, 1e-9):.2f}x smaller)")

    # the parameters by name, the Linear weights quantized per output row as the export does
    params = dict(trainer.model.named_parameters())
    err = quantization_error(params, mode=args.mode, out_rows=linear_weight_names(trainer.model))
    print(f"{args.mode} max relative reconstruction error: {err:.4f}")

    # --- run BOTH deployed artifacts: latency + retrieval agreement ----------
    x_items = {k: np.asarray(v) for k, v in bundle.x_all_item.items()}
    run_fp, _ = load_exported(paths["item"][0])
    run_q, _ = load_exported(paths["item"][1])
    # artifacts are fixed-shape; stream in chunks of the export batch size
    b = 8

    def stream(run):
        outs = []
        for i in range(0, len(next(iter(x_items.values()))), b):
            chunk = {k: v[i:i + b] for k, v in x_items.items()}
            n = len(next(iter(chunk.values())))
            if n < b:
                chunk = {k: np.concatenate([v, np.repeat(v[-1:], b - n, axis=0)]) for k, v in chunk.items()}
            outs.append(run(chunk)[:n].cpu().numpy())  # the program answers on its device
        return np.concatenate(outs)

    t0 = time.perf_counter()
    item_emb = stream(run_fp)
    fp_ms = (time.perf_counter() - t0) * 1000
    t0 = time.perf_counter()
    q_item_emb = stream(run_q)
    q_ms = (time.perf_counter() - t0) * 1000
    print(f"deployed artifact latency over {len(item_emb)} items: fp32 {fp_ms:.1f} ms, {args.mode} {q_ms:.1f} ms")

    fp_top = np.argsort(-np.asarray(item_emb) @ np.asarray(item_emb).T, axis=1)[:, : args.topk]
    q_top = np.argsort(-q_item_emb @ q_item_emb.T, axis=1)[:, : args.topk]
    agree = float(np.mean([len(set(a) & set(b)) / args.topk for a, b in zip(fp_top, q_top)]))
    print(f"top-{args.topk} retrieval agreement fp32 vs {args.mode} artifact: {agree:.3f}")

    # --- build + query the index ---------------------------------------------
    config = {"bruteforce": dict(metric="ip", device=device), "hnsw": dict(metric="ip")}.get(args.backend, {})
    builder = builder_factory(args.backend, **config)
    t0 = time.perf_counter()
    with builder.from_embeddings(np.asarray(item_emb)) as indexer:
        build_s = time.perf_counter() - t0
        queries = np.asarray(item_emb[:32])
        t0 = time.perf_counter()
        ids, dists = indexer.query(queries, args.topk)
        query_ms = (time.perf_counter() - t0) * 1000 / len(queries)
        indexer.save(os.path.join(args.save_dir, f"{args.backend}.index"))
    self_hit = float(np.mean(ids[:, 0] == np.arange(32)))
    print(f"{args.backend}: build {build_s * 1000:.1f} ms, {query_ms:.3f} ms/query, self-top1 hit {self_hit:.2f}")


if __name__ == "__main__":
    main()
