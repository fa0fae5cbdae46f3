"""Generate the PyTorch port's tutorial notebooks (run: python tutorials_torch/make_tutorials.py).

The port's counterparts of ``tutorials/``: the same seven notebooks, the
same sections, on ``torch_rechub_tpu_torch`` and the example helpers of
``examples_torch/`` (``datasets``, ``models``, ``metrics``).  Every notebook
runs on the card: its setup cell sets ``DEVICE`` from the environment
variable ``TORCH_RECHUB_DEVICE`` (unset, the card, raising without one;
``cpu`` runs on the CPU), and every model and trainer takes ``device=DEVICE``.
Outputs go to a fresh temporary directory a notebook.  The notebooks are
committed unexecuted; ``tests/test_torch_tutorials.py`` runs every code
cell on the CPU and ``chip_smoke.py`` on the card.
"""

from __future__ import annotations

import os

import nbformat as nbf

HERE = os.path.dirname(os.path.abspath(__file__))


def setup(number: str) -> str:
    return f"""\
import os, sys, tempfile
sys.path.insert(0, os.path.abspath(os.path.join(os.getcwd(), "..")))  # repo root
import numpy as np
import torch

from torch_rechub_tpu_torch.trainers.base import resolve_device

DEVICE = resolve_device(os.environ.get("TORCH_RECHUB_DEVICE"))  # the card; TORCH_RECHUB_DEVICE=cpu runs on the CPU
OUT = tempfile.mkdtemp(prefix="rechub_torch_tut{number}_")  # this notebook's outputs
print("device:", DEVICE, "| outputs under", OUT)
"""


def nb(cells):
    notebook = nbf.v4.new_notebook()
    notebook["metadata"] = {"kernelspec": {"display_name": "Python 3", "language": "python", "name": "python3"}, "language_info": {"name": "python"}}
    notebook["cells"] = [nbf.v4.new_markdown_cell(src) if kind == "md" else nbf.v4.new_code_cell(src) for kind, src in cells]
    for i, cell in enumerate(notebook["cells"]):
        cell["id"] = f"cell-{i:02d}"  # fixed ids: the same notebook bytes from every run of the generator
    return notebook


NOTEBOOKS = {}

NOTEBOOKS["00_QuickStart_CTR_DeepFM.ipynb"] = [
    ("md", """\
# QuickStart: CTR ranking with DeepFM

`torch_rechub_tpu_torch` is the PyTorch / CUDA port of `torch_rechub_tpu`,
with the capabilities of [torch-rechub](https://github.com/datawhalechina/torch-rechub).
This notebook trains DeepFM on the committed Criteo sample end to end:
**feature schema → model → `CTRTrainer.fit` → AUC**.

Everything runs on an NVIDIA card (the default) or, with
`TORCH_RECHUB_DEVICE=cpu`, on the CPU with the same code: the trainer runs
an eager PyTorch train step and drives it from a thin Python loop."""),
    ("code", setup("00")),
    ("md", """\
## 1. Data

The repo commits a ~100-row Criteo sample (`benchmarks/data/criteo/criteo_sample.csv`).
`build_criteo_ranking_dataset` (`examples_torch/datasets.py`) applies the standard
preprocessing — log1p-discretized dense features, label-encoded categoricals — and
returns a bundle of numpy dicts + feature schema. For your own data, do the same
with pandas and build the `DenseFeature`/`SparseFeature` lists yourself (see cell 3)."""),
    ("code", """\
from examples_torch.datasets import build_criteo_ranking_dataset

from torch_rechub_tpu_torch.basic.features import DenseFeature, SparseFeature

bundle = build_criteo_ranking_dataset(seed=2022, embed_dim=16)
dense_features = [f for f in bundle.features if isinstance(f, DenseFeature)]
sparse_features = [f for f in bundle.features if isinstance(f, SparseFeature)]
print({k: v.shape for k, v in list(bundle.x_train.items())[:3]}, "y:", bundle.y_train.shape)
print("dense:", len(dense_features), "sparse:", len(sparse_features))"""),
    ("md", """\
## 2. Feature schema

Features are *pure data* (frozen dataclasses) — no embedding parameters hide inside.
`SparseFeature(name, vocab_size, embed_dim)` supports `shared_with` (weight tying),
`padding_idx` (zeroed row) and the auto embed dim `floor(6·V^0.25)` when
`embed_dim` is omitted, matching the reference semantics."""),
    ("code", """\
print(sparse_features[0])
print(SparseFeature("auto_dim_demo", vocab_size=10000))  # embed_dim auto = floor(6*V^0.25)"""),
    ("md", """\
## 3. Model + trainer

Models are `torch.nn.Module`s taking a dict of tensors (same convention as the
reference's dict-input modules); `generator` seeds their weights and `device`
places them. `CTRTrainer` owns the train step (loss = BCE-with-logits + L2
regularization, Adam) and the epoch loop with early stopping and checkpointing."""),
    ("code", """\
from torch_rechub_tpu_torch.models.ranking import DeepFM
from torch_rechub_tpu_torch.trainers import CTRTrainer
from torch_rechub_tpu_torch.utils.data import ArrayLoader

model = DeepFM(
    deep_features=dense_features,
    fm_features=sparse_features,
    mlp_params={"dims": (256, 128), "dropout": 0.2, "activation": "relu"},
    generator=torch.Generator().manual_seed(2022),
    device=DEVICE,
)
trainer = CTRTrainer(model, optimizer_params={"lr": 1e-3, "weight_decay": 1e-5}, n_epoch=2, model_path=OUT, device=DEVICE)
train_dl = ArrayLoader(bundle.x_train, bundle.y_train, batch_size=256, shuffle=True, seed=2022)
test_dl = ArrayLoader(bundle.x_test, bundle.y_test, batch_size=256)
trainer.fit(train_dl, test_dl)"""),
    ("md", "## 4. Evaluate + predict"),
    ("code", """\
auc = trainer.evaluate(model, test_dl)
preds = trainer.predict(model, test_dl)
print(f"test AUC: {auc:.4f}; first predictions: {np.asarray(preds)[:5].round(3)}")"""),
    ("md", """\
## 5. What's different from torch-rechub?

- Hand-written CUDA kernels (sm_90a) for the HSTU attention of the generative
  models; the ranking models here run PyTorch's own kernels.
- The same script scales to several cards: pass `mesh=create_mesh(data, model)`
  (`torch_rechub_tpu_torch.parallel`) under `torchrun` — see
  [06_Scaling_and_Precision](06_Scaling_and_Precision.ipynb).
- Checkpoints store `(model, optimizer, step)` — preemption-safe resume,
  not just final weights.

Next: [01_Ranking_DIN](01_Ranking_DIN.ipynb) for behavior sequences,
[02_Matching_DSSM](02_Matching_DSSM.ipynb) for retrieval."""),
]

NOTEBOOKS["01_Ranking_DIN.ipynb"] = [
    ("md", """\
# Ranking with behavior sequences: DIN

DIN (Deep Interest Network) attends over the user's click history with the
*target item* as query. This notebook builds the sequence features with the
real preprocessing pipeline (`generate_seq_feature`: per-user sliding windows,
1:1 negative sampling, zero-padded histories) and trains DIN with
`CTRTrainer`. Swap `DIN` for `DIEN` (AUGRU interest evolution) or
`BST` (transformer) — same data, same trainer."""),
    ("code", setup("01")),
    ("code", """\
import pandas as pd

rng = np.random.default_rng(2022)
n_users, n_items, n_cates, n_clicks = 100, 200, 20, 3000
users = rng.integers(1, n_users, n_clicks)
items = ((users * 13) % n_items + rng.integers(0, 20, n_clicks)).clip(1, n_items - 1)
df = pd.DataFrame({"user_id": users, "item_id": items, "cate_id": items % n_cates + 1, "time": np.arange(n_clicks)})
df.head()"""),
    ("md", """\
## Sequence feature generation

`generate_seq_feature` mirrors the reference (`utils/data.py`): for each user,
sliding windows over the time-sorted history become training rows; the last
two interactions become val/test; each positive gets a sampled negative."""),
    ("code", """\
import random

from torch_rechub_tpu_torch.utils.data import generate_seq_feature, pad_sequences

train, val, test = generate_seq_feature(df, "user_id", "item_id", "time", item_attribute_cols=["cate_id"], max_len=20, shuffle=True, rng=random.Random(2022))
print(train.keys() if isinstance(train, dict) else type(train))"""),
    ("code", """\
from torch_rechub_tpu_torch.basic.features import SequenceFeature, SparseFeature

def to_xy(part, max_len=20):
    x = {
        "target_item_id": np.asarray(part["target_item_id"], np.int32),
        "target_cate_id": np.asarray(part["target_cate_id"], np.int32),
        "hist_item_id": pad_sequences(part["hist_item_id"], maxlen=max_len, value=0).astype(np.int32),
        "hist_cate_id": pad_sequences(part["hist_cate_id"], maxlen=max_len, value=0).astype(np.int32),
    }
    return x, np.asarray(part["label"], np.float32)

x_train, y_train = to_xy(train)
x_test, y_test = to_xy(test)

features = [SparseFeature("target_item_id", n_items + 1, 8), SparseFeature("target_cate_id", n_cates + 2, 8)]
history_features = [
    SequenceFeature("hist_item_id", vocab_size=n_items + 1, embed_dim=8, pooling="concat", shared_with="target_item_id"),
    SequenceFeature("hist_cate_id", vocab_size=n_cates + 2, embed_dim=8, pooling="concat", shared_with="target_cate_id"),
]
print(x_train["hist_item_id"].shape)"""),
    ("md", """\
## DIN: target attention with a Dice-activated MLP

`shared_with` ties history embeddings to the target-item table. The
ActivationUnit scores each history position against the target; padded
positions are masked (`padding_idx=0` rows stay zero)."""),
    ("code", """\
from torch_rechub_tpu_torch.models.ranking import DIN
from torch_rechub_tpu_torch.trainers import CTRTrainer
from torch_rechub_tpu_torch.utils.data import ArrayLoader

model = DIN(features=features, history_features=history_features, target_features=features, mlp_params={"dims": (64, 32)}, attention_mlp_params={"dims": (16,)},
            generator=torch.Generator().manual_seed(2022), device=DEVICE)
trainer = CTRTrainer(model, n_epoch=1, model_path=OUT, device=DEVICE)
trainer.fit(ArrayLoader(x_train, y_train, batch_size=256, shuffle=True, seed=2022))
auc = trainer.evaluate(model, ArrayLoader(x_test, y_test, batch_size=256))
print(f"test AUC: {auc:.4f}")"""),
    ("md", """\
On real Amazon-Electronics data, run
`python examples_torch/ranking/run_amazon_electronics.py --model_name din|dien|bst`
(the committed sample + `preprocess_amazon_electronics.py` live in
`benchmarks/data/amazon_electronics/`)."""),
]

NOTEBOOKS["02_Matching_DSSM.ipynb"] = [
    ("md", """\
# Matching / retrieval: two-tower DSSM

Retrieval models embed users and items into one space; serving = top-k
nearest items. This notebook: **matching dataset (mode 0, sampled negatives)
→ DSSM → `MatchTrainer` → tower inference → exact top-k retrieval eval**.

`MatchTrainer` supports the reference's three training modes — 0 point-wise,
1 pair-wise (BPR), 2 list-wise (softmax over 1+k negatives) — plus in-batch
negatives (uniform or popularity-hard), which on a device mesh span the
**global** batch (an upgrade over per-host DDP pools)."""),
    ("code", setup("02")),
    ("code", """\
from examples_torch.datasets import build_ml1m_matching_dataset

bundle = build_ml1m_matching_dataset(seed=2022, embed_dim=16, mode=0, neg_ratio=3)
print({k: v.shape for k, v in list(bundle.x_train.items())[:4]})"""),
    ("code", """\
from torch_rechub_tpu_torch.models.matching import DSSM
from torch_rechub_tpu_torch.trainers import MatchTrainer
from torch_rechub_tpu_torch.utils.data import ArrayLoader

model = DSSM(
    user_features=bundle.user_features,
    item_features=bundle.item_features,
    user_params={"dims": (64, 16)},
    item_params={"dims": (64, 16)},
    generator=torch.Generator().manual_seed(2022),
    device=DEVICE,
)
trainer = MatchTrainer(model, mode=0, n_epoch=2, model_path=OUT, device=DEVICE)
trainer.fit(ArrayLoader(bundle.x_train, bundle.y_train, batch_size=256, shuffle=True))"""),
    ("md", """\
## Tower inference + retrieval eval

`inference_embedding` switches the model's `mode` to one tower and streams
batches through it. Evaluation is an **exact brute-force top-k on the card**
(`U @ I.T` → `torch.topk`, split over the mesh for big catalogs) — no ANN
approximation error in the metrics, unlike the reference's Annoy eval."""),
    ("code", """\
from torch_rechub_tpu_torch.serving import match_evaluation

test_x = {k: v for k, v in bundle.x_test_user.items() if not k.startswith("neg")}
user_emb = trainer.inference_embedding(model, "user", ArrayLoader(test_x, batch_size=256), OUT)
item_emb = trainer.inference_embedding(model, "item", ArrayLoader(bundle.x_all_item, batch_size=256), OUT)
res = match_evaluation(user_emb, item_emb, bundle.test_user, bundle.x_all_item, user_col="user_id", item_col="movie_id", topk=10, device=DEVICE)
print(res)"""),
    ("md", """\
## In-batch negatives

Keep only positives and let the other rows of the batch serve as negatives:

```python
trainer = MatchTrainer(model, mode=0, in_batch_neg=True, in_batch_neg_ratio=16, ..., device=DEVICE)
```

For ANN serving instead of exact top-k, see
[05_Model_Export_and_Serving](05_Model_Export_and_Serving.ipynb)."""),
]

NOTEBOOKS["03_MultiTask_MMOE.ipynb"] = [
    ("md", """\
# Multi-task learning: MMOE on Census-Income

Two binary tasks (income>50K, never-married) share expert MLPs; per-task
gates mix them. `MTLTrainer` takes `task_types` and supports adaptive loss
weighting — `uwl` (uncertainty), `gradnorm`, `metabalance` — all inside ONE
train step (per-task gradients by one backward each)."""),
    ("code", setup("03")),
    ("code", """\
from examples_torch.datasets import build_census_multitask_dataset

bundle = build_census_multitask_dataset(seed=2022, embed_dim=8)
print("tasks:", bundle.task_types, "| y:", bundle.y_train.shape)"""),
    ("code", """\
from torch_rechub_tpu_torch.models.multi_task import MMOE
from torch_rechub_tpu_torch.trainers import MTLTrainer
from torch_rechub_tpu_torch.utils.data import ArrayLoader

model = MMOE(features=bundle.features, task_types=bundle.task_types, n_expert=4, expert_params={"dims": (16,)}, tower_params_list=[{"dims": (8,)}, {"dims": (8,)}],
             generator=torch.Generator().manual_seed(2022), device=DEVICE)
trainer = MTLTrainer(model, task_types=bundle.task_types, optimizer_params={"lr": 1e-3, "weight_decay": 1e-5}, n_epoch=1, model_path=OUT, device=DEVICE)
trainer.fit(ArrayLoader(bundle.x_train, bundle.y_train, batch_size=256, shuffle=True), ArrayLoader(bundle.x_test, bundle.y_test, batch_size=256))
print("per-task val scores:", trainer.evaluate(model, ArrayLoader(bundle.x_test, bundle.y_test, batch_size=256)))"""),
    ("md", """\
## Adaptive weighting + ESMM

```python
MTLTrainer(model, task_types, adaptive_params={"method": "metabalance"}, ..., device=DEVICE)  # or "uwl", "gradnorm"
```

ESMM models CVR through CTR (`pCTCVR = pCTR · pCVR`) and needs the derived
third label + loss masking — `MTLTrainer` handles it when the model is ESMM
(see `examples_torch/ranking/run_ali_ccp_multi_task.py`).

A degenerate validation split (a task with a single class) scores that task
`NaN` instead of failing the run."""),
]

NOTEBOOKS["04_Experiment_Tracking.ipynb"] = [
    ("md", """\
# Experiment tracking, early stopping, checkpoint/resume

Trainers fan out metrics to any `BaseLogger` (console, Weights & Biases,
SwanLab, tensorboardX — dependency-gated). Checkpoints store the FULL
train state `(model, optimizer, step)`, so a preempted machine resumes
exactly where it stopped."""),
    ("code", setup("04")),
    ("code", """\
from torch_rechub_tpu_torch.basic.tracking import ConsoleLogger
# from torch_rechub_tpu_torch.basic.tracking import WandbLogger, SwanLabLogger, TensorBoardLogger

logger = ConsoleLogger(log_path=os.path.join(OUT, "metrics.jsonl"))"""),
    ("code", """\
from examples_torch.datasets import build_criteo_ranking_dataset
from torch_rechub_tpu_torch.models.ranking import WideDeep
from torch_rechub_tpu_torch.trainers import CTRTrainer
from torch_rechub_tpu_torch.utils.data import ArrayLoader

from torch_rechub_tpu_torch.basic.features import DenseFeature, SparseFeature

bundle = build_criteo_ranking_dataset(seed=2022, embed_dim=8)
dense = [f for f in bundle.features if isinstance(f, DenseFeature)]
sparse = [f for f in bundle.features if isinstance(f, SparseFeature)]
model = WideDeep(wide_features=sparse, deep_features=dense, mlp_params={"dims": (32,)}, generator=torch.Generator().manual_seed(2022), device=DEVICE)
trainer = CTRTrainer(model, n_epoch=3, earlystop_patience=2, model_path=OUT, model_logger=[logger], device=DEVICE)
train_dl = ArrayLoader(bundle.x_train, bundle.y_train, batch_size=256, shuffle=True, seed=2022)
val_dl = ArrayLoader(bundle.x_test, bundle.y_test, batch_size=256)
trainer.fit(train_dl, val_dl)  # early-stops on val AUC, keeps best weights"""),
    ("md", """\
## Checkpoint / resume

Every fit writes step checkpoints under `model_path`. `TrainCheckpointer`
restores `(model, optimizer, step)` — rerunning the same fit after an
interruption continues from the last saved step instead of restarting."""),
    ("code", """\
from torch_rechub_tpu_torch.utils.checkpoint import TrainCheckpointer

ckpt = TrainCheckpointer(OUT)
print("latest step on disk:", ckpt.latest_step())"""),
    ("md", """\
## Profiling

Wrap any region in a `torch.profiler` trace (the card's kernels too) and view
`trace.json` in Perfetto or `chrome://tracing`:"""),
    ("code", """\
from torch_rechub_tpu_torch.utils.profiling import trace

with trace(os.path.join(OUT, "trace")) as prof:
    trainer.evaluate(model, val_dl)
print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=5))
print("trace written:", os.path.exists(os.path.join(OUT, "trace", "trace.json")))"""),
]

NOTEBOOKS["05_Model_Export_and_Serving.ipynb"] = [
    ("md", """\
# Export, quantization, and serving

Deployment path: train → export a `torch.export` program (`.pt2`; the reference
exports ONNX) → optional int8/fp16 weight-only quantization with **in-graph
dequant** → ANN/exact top-k serving.

Export modes mirror the reference: `full` model, `user` tower, `item` tower."""),
    ("code", setup("05")),
    ("code", """\
from examples_torch.datasets import build_ml1m_matching_dataset
from torch_rechub_tpu_torch.models.matching import DSSM
from torch_rechub_tpu_torch.trainers import MatchTrainer
from torch_rechub_tpu_torch.utils.data import ArrayLoader

bundle = build_ml1m_matching_dataset(seed=2022, embed_dim=16, mode=0, neg_ratio=3)
model = DSSM(user_features=bundle.user_features, item_features=bundle.item_features, user_params={"dims": (32, 16)}, item_params={"dims": (32, 16)},
             generator=torch.Generator().manual_seed(2022), device=DEVICE)
trainer = MatchTrainer(model, mode=0, n_epoch=1, model_path=OUT, device=DEVICE)
trainer.fit(ArrayLoader(bundle.x_train, bundle.y_train, batch_size=256, shuffle=True))"""),
    ("md", "## Export each tower to a `.pt2` program (`TorchExporter`)"),
    ("code", """\
example_item = {k: np.asarray(v[:8]) for k, v in bundle.x_all_item.items()}
path = trainer.export(os.path.join(OUT, "item_tower"), example_item, mode="item")
print("exported:", path)"""),
    ("md", """\
## Quantized export (int8 weight-only, dequant in-graph)

The exported artifact carries int8 params + scales and dequantizes inside the
program — the deployed model IS quantized, not just its checkpoint."""),
    ("code", """\
from torch_rechub_tpu_torch.utils.export import linear_weight_names, load_exported, quantization_error

qpath = trainer.export_quantized(os.path.join(OUT, "item_tower_int8"), example_item, mode="item", quant_mode="int8")
params = dict(trainer.model.named_parameters())  # by name; Linear weights quantized per output row, as the export does
print("param reconstruction err (max relative):", quantization_error(params, mode="int8", out_rows=linear_weight_names(trainer.model)))
run_fp32, _ = load_exported(path)
run_int8, _ = load_exported(qpath)
out32, out8 = run_fp32(example_item).cpu().numpy(), run_int8(example_item).cpu().numpy()  # the programs answer on their device
print("deployed-output max abs diff:", float(np.abs(out32 - out8).max()))"""),
    ("md", """\
## Serving top-k

`builder_factory` gives the reference's backends (annoy / faiss / milvus,
dependency-gated) plus two upgrades: `bruteforce` (exact top-k on the card)
and `hnsw` (in-repo native HNSW, no external dependency)."""),
    ("code", """\
from torch_rechub_tpu_torch.serving import builder_factory

rng = np.random.default_rng(0)
item_vecs = rng.normal(size=(500, 16)).astype(np.float32)
builder = builder_factory("bruteforce", metric="ip", device=DEVICE)
with builder.from_embeddings(item_vecs) as index:
    ids, dists = index.query(rng.normal(size=(3, 16)).astype(np.float32), top_k=5)
print(ids)"""),
    ("md", """\
For an end-to-end latency/accuracy comparison of fp32 vs int8 serving, run
`python examples_torch/serving/run_quantize_export.py --backend hnsw --mode int8`."""),
]

NOTEBOOKS["06_Scaling_and_Precision.ipynb"] = [
    ("md", """\
# Scaling out and mixed precision

Three knobs the reference has no equivalent for: device meshes,
bf16 mixed precision, and sparse row-wise embedding updates. Everything
below runs on the CPU too (same code path)."""),
    ("code", setup("06")),
    ("code", """\
# learnable synthetic CTR data
rng = np.random.default_rng(0)
n = 2048
x = {f"C{i}": rng.integers(0, 64, n).astype(np.int32) for i in range(5)}
x.update({f"I{i}": rng.normal(size=n).astype(np.float32) for i in range(2)})
logit = (x["C0"] % 2) * 2.0 - 1.0 + 1.5 * x["I0"]
y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(np.float32)"""),
    ("md", """\
## bf16 mixed precision

`precision="bf16"` computes in bfloat16 with f32 parameters, losses and
optimizer state. Measured seed-level quality parity (`docs/PRECISION.md`);
fastest on tensor-core-bound models (sequence/generative, big towers)."""),
    ("code", """\
from torch_rechub_tpu_torch.basic.features import DenseFeature, SparseFeature
from torch_rechub_tpu_torch.models.ranking import DeepFM
from torch_rechub_tpu_torch.trainers import CTRTrainer
from torch_rechub_tpu_torch.utils.data import DataGenerator

sparse = tuple(SparseFeature(f"C{i}", vocab_size=64, embed_dim=8) for i in range(5))
dense = tuple(DenseFeature(f"I{i}") for i in range(2))
model = DeepFM(deep_features=dense, fm_features=sparse, mlp_params={"dims": (32,), "dropout": 0.0}, generator=torch.Generator().manual_seed(0), device=DEVICE)
tr, va, te = DataGenerator(x, y).generate_dataloader(split_ratio=[0.7, 0.1], batch_size=256)
trainer = CTRTrainer(model, n_epoch=2, model_path=os.path.join(OUT, "bf16"), precision="bf16", device=DEVICE)
trainer.fit(tr, None, log_interval=0)
print("bf16 AUC:", trainer.evaluate(model, te))"""),
    ("md", """\
## Device mesh

One argument scales the same trainer across cards: batches split over the
`data` axis, embedding tables are placed by the budget-aware policy
(`parallel.mesh.plan_table_placement` — fused/big tables row-shard over
`model`, small ones replicate). A mesh runs one process a card, started by
`torchrun`; alone in a notebook there is one process, and the cell says so."""),
    ("code", """\
import torch.distributed as dist
from torch_rechub_tpu_torch.parallel import create_mesh

if dist.is_initialized() and dist.get_world_size() >= 2:
    mesh = create_mesh(data=dist.get_world_size(), model=1)
    model_m = DeepFM(deep_features=dense, fm_features=sparse, mlp_params={"dims": (32,), "dropout": 0.0}, generator=torch.Generator().manual_seed(0), device=DEVICE)
    t_mesh = CTRTrainer(model_m, n_epoch=1, model_path=os.path.join(OUT, "mesh"), mesh=mesh, device=DEVICE)
    t_mesh.fit(tr, None, log_interval=0)
    print("mesh:", dict(mesh.shape), "AUC:", t_mesh.evaluate(model_m, te))
else:
    print("one process, no process group — mesh demo skipped; on a host with cards run e.g.")
    print("  torchrun --nproc-per-node=4 examples_torch/ranking/run_criteo_production.py --mesh 4,1")"""),
    ("md", """\
## Sparse row-wise embedding updates

At production vocab sizes a dense optimizer pass over the tables dominates
the step. `sparse_embedding="adagrad"` updates only the rows a batch
touched (row-wise Adagrad with in-batch dedup) — requires the fused table
layout."""),
    ("code", """\
from torch_rechub_tpu_torch.ops.embedding import set_fused_default

old = set_fused_default(True)  # small demo vocabs; >=262k-row tables fuse automatically
try:
    model_s = DeepFM(deep_features=dense, fm_features=sparse, mlp_params={"dims": (32,), "dropout": 0.0}, generator=torch.Generator().manual_seed(0), device=DEVICE)
    t_sparse = CTRTrainer(model_s, n_epoch=2, model_path=os.path.join(OUT, "sparse"), sparse_embedding="adagrad", device=DEVICE)
    t_sparse.fit(tr, None, log_interval=0)
    print("sparse-adagrad AUC:", t_sparse.evaluate(model_s, te))
finally:
    set_fused_default(old)"""),
]


def notebooks():
    """``{file name: notebook}``: what :func:`main` writes."""
    return {name: nb(cells) for name, cells in NOTEBOOKS.items()}


def main():
    for name, notebook in notebooks().items():
        path = os.path.join(HERE, name)
        nbf.write(notebook, path)
        print("wrote", path)


if __name__ == "__main__":
    main()
