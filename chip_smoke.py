#!/usr/bin/env python3
"""Drive the PyTorch port (``torch_rechub_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

1. Card: its name and power limit; fails without a CUDA device.
2. Build: every CUDA source of the port, with nvcc, from this checkout;
   the build log (ptxas's registers per kernel), and the CTAs per SM,
   registers and shared memory of K1, K2, K2a, K2b and K3 and of their
   bf16 variants.
3. Kernels: each kernel against its plain PyTorch version on the card, at the
   serving shape and at adversarial ones, with a stated tolerance, and timed
   beside its bound (every kernel runs its products as 3xTF32 on the tensor
   cores; both the fp32-FMA and the 3xTF32 bound are printed): the forward
   K1, then the backward K2 and K2a + K2b against the plain backward, on all
   five gradients; the bucket sweep (K1, K2 and K2a + K2b at every
   time-bucket threshold); then K3 through the op ``hstu_attention``
   (materialised bias) on eight cases, against K1 on the serving model's own
   rab, and the op's gradients; its launch count.  Then K3-bf16 through the
   op on bf16 q, k, v, with an f32 and a bf16 bias (section 14).
4. Serving: the full-width HSTU model of ``benchmarks/perf/hstu_train_bench.py``
   (V40000, d256, 8 heads, 4 layers, L256, batch 8) with random weights from a
   seed, through ``SeqTrainer.evaluate`` / ``predict_logits``, dense and
   chunked; the kernels' launch counts over that run; the fused model's
   logits against the same weights without the kernel.
5. Training: the same configuration through ``SeqTrainer.train_one_epoch``,
   chunked 8192 (the bench's path) and dense, on seeded bench-style data;
   tokens/s, ms per step, and where a step's time goes; the loss finite and
   every parameter moved; K1 and K2 launched once per layer per step, and
   one step with ``_FUSED_BWD[0] = False`` through K2a and K2b; the layers'
   backward timed through K2 and through K2a + K2b; one batch's parameter
   gradients against the same weights without the kernels.
6. DeepFM serving, at ``bench.py``'s small config (batch 4096, 26 sparse
   features of vocab 10,000 and dim 16, 13 dense, MLP (256, 128)) with
   random weights from a seed: ``CTRTrainer.predict`` (ms per batch,
   examples/s, device time and idle share of a batch), the exact and the
   bucketed AUC through ``evaluate``, the card's logits against the CPU's on
   the same weights; then one predict batch at the Criteo-full geometry
   (``bench.py:51``) under the ``"auto"`` layout, its table shapes checked.
7. DeepFM training, the same config through ``CTRTrainer.train_one_epoch``
   on ``ArrayLoader`` and ``DeviceCachedLoader`` (examples/s, ms per step,
   the loss finite and every parameter moved); a step's stages by device
   time and host clock, and its kernels by class (``torch.profiler``); one
   step against the CPU from the same weights (loss, gradients, parameters
   after Adam, BatchNorm statistics); ``fit`` on learnable data to a test AUC
   above 0.65.  No kernel of the port lies on this path: the phases check
   that none was launched.
8. Sparse row-wise embedding updates.  (a) DeepFM at the Criteo-full
   geometry (``bench.py:122-152``: the ``"auto"`` layout's ``(8,100,032, 16)``
   fused table, zipf(1.2) ids) with ``sparse_embedding="adagrad"`` on
   ``DeviceCachedLoader``: the first step moves the batch's rows and no
   other, the fused table takes no gradient and no Adam state; examples/s,
   a step's stages (forward, backward, Adam over the rest, the sparse
   update), host synchronisations and memory; the update alone under
   ``torch.cuda.set_sync_debug_mode("error")``; one dense-Adam step at the
   same geometry beside it; the small config fused, one step of ``"sgd"``
   and ``"adagrad"`` card against CPU, sparse SGD against dense SGD, ``fit``
   above a test AUC of 0.65.  (b) The serving HSTU untied, with the sampled
   softmax and ``"adagrad"``: tokens/s, a step's device time, K1 and K2
   once per layer per step; the PAD row stays 0; the recorded rows'
   gradients against the dense table gradients through K1 and K2.
9. The ranking zoo through ``CTRTrainer``, at full width with random weights
   from a seed, dropout 0: WideDeep, DCN, DCNv2 (parallel, low-rank mixture;
   stacked, full matrices), EDCN, AFM, AutoInt, FiBiNet, DeepFFM and
   FatDeepFFM at bench.py's small config under ``benchmarks/models.py``'s
   defaults, and DIN, BST and DIEN at the Amazon-Electronics shape of
   ``examples/ranking/run_amazon_electronics.py`` (192,403 users, 63,001
   items, 801 categories, embed dim 8, histories of 1-50 post-padded to L50,
   B4096).  Per configuration: ``train_one_epoch`` on ``DeviceCachedLoader``
   (examples/s, ms per step, the loss finite, every parameter moved but
   AFM's constant attention), a step's device time, host clock, idle share
   and launches, ``predict``, and the card against the CPU from the same
   weights at B1024 (logits, DIEN's aux loss, one step's loss, gradients and
   every parameter's step); ``fit`` above a test AUC of 0.65 for DCNv2 and
   DIN.
10. Matching through ``MatchTrainer``.  (a) The 13 classes at MovieLens-1M's
   widths (``examples/matching/run_ml_matching.py:33-58``: 6,040 users and
   3,706 movies, ids shifted by one for PAD, d16, user MLP (64, 16),
   histories of up to 20 movies, 3 negatives, B256; seeded data, tables
   redrawn at N(0, 0.3²)), each in its mode (DSSM and DSSMSENet point-wise,
   FaceBookDSSM and SASRec pair-wise, the rest list-wise, NARM and STAMP over
   every movie; DSSM once more with in-batch negatives): examples/s and ms per
   step on ``DeviceCachedLoader``, a step's device time, host clock, idle
   share and launches, ``inference_embedding`` of every user and movie, the
   card against the CPU at B256 (scores, one step's loss, gradients, every
   parameter's step); ``fit`` of YoutubeDNN and MIND on rows with a
   learnable signal, then ``match_evaluation`` on the card to a recall@10
   above ten times chance.  (b) YoutubeDNN at the production geometry of
   ``BASELINE.md:321-328`` (200,000 users, an 8,000,000 × 64 item table,
   20-item mean-pooled histories, in-batch negatives, B1024, zipf ids) with
   ``sparse_embedding="adagrad"``: the first step's rows, examples/s, a
   step's stages, host synchronisations, peak memory; the item tower's
   ``inference_embedding`` over all 8M items; exact top-10 retrieval of 8,192
   users over them (``brute_force_topk``, 128 users a batch; the product and
   the top-k timed apart beside their bounds; 256 users against the CPU);
   one dense-Adam step beside it.
11. Multi-task through ``MTLTrainer``: SharedBottom, ESMM, MMOE, PLE and AITM
   at the repo's multi-task widths (``benchmarks/models.py:56-70``) over
   Ali-CCP's schema (the 23 sparse fields of the committed sample at d16,
   the sample's vocabularies, and its 8 dense fields), seeded rows with
   ``_aliccp_frame``'s synthetic click / purchase rule, B4096.  Per class:
   examples/s on ``DeviceCachedLoader``, a step's device time, host clock,
   idle share and launches, ``predict``, and one step card against CPU
   (outputs, task losses, gradients, every parameter's step, BatchNorm
   statistics).  MMOE under UWL, GradNorm and MetaBalance card against CPU
   (the loss weights, GradNorm's leaf, MetaBalance's norms); MMOE under UWL
   with every table fused and ``sparse_embedding="adagrad"`` (the table's
   step against a dense-gradient reference, host synchronisations); ``fit``
   of MMOE and PLE to a click AUC above 0.6.
12. RQ-VAE through ``RQVAETrainer`` at the JAX package's default widths
   (768-d input, three codebooks of 256, e_dim 64, layers (512, 256, 128),
   Sinkhorn at 0.003 on the last stage) on 12,101 seeded clustered items:
   one step card against CPU (loss, every parameter's step, the codes),
   ``fit`` ms per epoch, a step's device time and idle share,
   ``generate_semantic_ids`` over every item (ms, the collision rate before
   and after the retries), the stage-1 and stage-2 codes card against CPU
   (argmin ties counted).
13. HLLM and TIGER.  (a) ``HLLMModel`` at the JAX package's defaults (d 512,
   8 heads, 4 layers, L256, 2048 sqrt time buckets, temperature 0.07, the
   relative bias) on the HSTU cell's geometry (V40,000, B8), with seeded
   clustered stand-ins for the frozen LLM item table and histories that
   stay in one cluster: the card against the CPU at B2 (logits; one
   ``SeqTrainer`` step of the dense, chunked 8192 and sampled (1024 given
   negatives) losses: loss, gradients, every parameter's step; the frozen
   table unmoved); ``evaluate`` ms per request, tokens/s, ``predict_logits``
   ms per batch; a step's host clock, device time, idle share and launches
   (chunked, dense, sampled); ``fit`` on ``SequenceDataGenerator``'s split to
   a held-out top-1 above ten times chance.  (b) ``TIGERModel`` at the
   paper's widths (d 128, 4 + 4 layers of 4 heads of 32, d_ff 1024, dropout
   0.1, B256) on semantic ids from ``RQVAETrainer``'s k-means init (no
   epoch) over the RQ-VAE phase's items, samples from ``build_tiger_samples`` over seeded
   histories at Amazon-Beauty's counts (repeat purchases inside one
   cluster): the card against the CPU (loss, logits, one
   ``torch.optim.AdamW`` step); a step's host clock, device time, idle
   share and launches; 900 steps; ``generate`` with a trie, 10 beams, 3 new
   tokens (ms per batch of 256 users, users/s) to a recall@10 over the
   semantic ids above ten times chance and a recall@1 above three times
   that of knowing the target's cluster; the card's beams against the CPU's
   up to near-ties.  The DeepFM, zoo, matching,
   multi-task, RQ-VAE, HLLM and TIGER phases check that none of the port's
   kernels was launched: no TPU kernel lies on these paths.
14. bf16 mixed precision (``basic/precision.py``).  (a) The bf16 K1, K2,
   K2a and K2b (``csrc/hstu_rab_fwd_bf16.cu``, ``csrc/hstu_rab_bwd_bf16.cu``)
   on the kernel phase's six cases and the bucket sweep, against their plain
   bf16 versions (one bf16 ulp of the largest element; dpos and dts as fp32
   sums) and nearer to them than a quarter of their distance to the fp32
   kernels; device and host-clock ms at the serving shape and at L1024
   beside the plain bf16 version and the fp32 kernels, with bounds from bf16
   bytes and 989 TFLOP/s of bf16 tensor cores.  K3-bf16
   (``csrc/hstu_attn_fwd_bf16.cu``) likewise through the op
   ``hstu_attention`` on the attention phase's cases, an f32 and a bf16
   bias, its gradients, its launches.  (b) The full-width HSTU
   under ``SeqTrainer(precision="bf16")``: ``evaluate`` / ``predict_logits``
   (ms per request, tokens/s), training with the chunked 8192, dense and
   sampled (1024) losses (tokens/s, a step's device time, host clock, idle
   share and launches), the bf16 K1 and K2 launched once per layer per
   forward and step, one step of each loss card against CPU, parameters and
   optimizer state f32; one chunked step through the split backward
   (``_FUSED_BWD[0] = False``: K2a-bf16 and K2b-bf16 once per layer), card
   against CPU too, and the layers' backward timed through K2-bf16 and
   through K2a-bf16 + K2b-bf16; ``fit`` on successor histories to a top-1
   above ten times chance.  (c) DeepFM at bench.py's small config under
   ``CTRTrainer(precision="bf16")``: examples/s, a step's device time, host
   clock, idle share, one step card against CPU, ``fit`` above a test AUC of
   0.65; DSSM with in-batch negatives and MMOE under UWL and MetaBalance: one
   step each card against CPU (inside the block that checks that no HSTU
   kernel was launched).
15. The trainer lifecycle (``lifecycle_phase``).  (a) The serving HSTU
   (V40,000, d256, 8 heads, dqk = dv = 32, 4 layers, L256, tied, B8, fp32,
   chunked 8192, dropout 0) through ``SeqTrainer``: 8 steps straight, twice,
   and 4 steps, ``maybe_step_checkpoint``, a fresh trainer, ``maybe_resume``,
   4 more, through K2 and again through K2a + K2b; the state's round trip bit
   for bit, the checkpoint's bytes and save / restore time, the resumed run
   within twice the run-to-run spread (``rel_l2``); K1, K2 (or K2a, K2b) once per layer
   per step.  The registered op's host cost against the ctypes launch, a
   step's device time and host clock.  ``trainer.export`` of the trained
   model, reloaded, one request of 8 x L256: K1 four times a call, within
   1e-6 of the largest eager logit, ms a request beside the eager forward
   and ``evaluate``; the int8 and fp16 exports: bytes against fp32, within K
   quantized tensors x ``quantization_error`` x the largest logit, ms a
   request.  One step under ``utils/profiling.trace`` with an ``annotate``
   span: the Chrome trace names K1's and K2's kernels and the span; the
   peak from ``device_memory_stats()``.  (b) DeepFM at the Criteo-full
   geometry with sparse Adagrad on ``ArrayLoader`` (the prefetching loop):
   examples/s and idle against synchronous copies; checkpoints every 8 of 16
   steps with ``max_to_keep=1`` (the steps saved, the file kept, bytes and
   seconds); 8 + resume + 8 equal to two straight runs bit for bit under
   ``torch.use_deterministic_algorithms`` (``index_add_``'s atomics make
   the default runs differ); the files deleted.
16. The (data, model) mesh (``mesh_phase``).  (a) This process as a world of
   one over NCCL, the serving HSTU under ``torch.use_deterministic_algorithms``
   (so through K2a + K2b, which sum every gradient in a fixed order): one
   step on the (1, 1) mesh has mesh=None's gradients bit for bit, the rab
   tables' too; four steps equal to two mesh=None runs bit for bit; four
   steps through K2 (deterministic algorithms off: K2's dq) within twice the
   spread of two mesh=None runs (``rel_l2``).  Two gloo ranks sharing the card, started by
   ``parallel.distributed.spawn`` (collectives on CUDA tensors staged
   through the host): (b) the HSTU at V65,536 under (2, 1) and (1, 2) against each
   rank's mesh=None run at ``tests/test_sharding.py:255``'s tolerances,
   with each rank's launches, each step's CUDA-event time, the gradient
   all-reduce's host clock and the token table's bytes; (c) DeepFM at the
   Criteo-full geometry with sparse Adagrad under (1, 2), each rank's rows
   against mesh=None's under deterministic algorithms; (d) exact top-10 of
   2,048 users over 1M items split over the ranks, indices equal to the
   unsharded call's; (e) MMOE at the multi-task phase's geometry (Ali-CCP's
   schema, d16, global B4096, 4 steps) under (2, 1) with the mean, UWL,
   GradNorm and MetaBalance, and under (1, 2) with every table fused (the
   fused table row-sharded) and sparse Adagrad, each against the rank's
   mesh=None run at ``tests/test_sharding.py:304``'s tolerances (the loss
   weights too); (f) the RQ-VAE phase's model and items with the k-means
   init, one epoch of B1024 under (2, 1) against mesh=None (the loss and
   parameters at ``:351``/``:369``'s tolerances, the share of equal codes);
   each with a step's CUDA-event time and the collectives' host clock
   (Sinkhorn's apart).  The launches, summed over the ranks, join the
   kernels line; (e) and (f) launch none.
17. Approximate retrieval (``ann_phase``): (g) the native HNSW index
   (``serving/hnsw.py``, a host index) over 30,000 seeded unit-norm items of
   d64: build seconds, recall@10 of 1,024 users against the card's exact
   ``brute_force_topk`` (above 0.9), ms per batch of 128 users on the host
   beside the card's exact batch, the index file's bytes and a save / load
   round trip; the legacy ``Annoy`` and ``Faiss`` engines on one batch each
   against the native HNSW and ``brute_force_topk``.
18. The examples (``examples_phase``): every script of ``examples_torch/`` once through its
   argv entry (``runpy``, ``--device`` unset, so on the card), the small ones at their
   defaults with one epoch (TIGER 50 steps), each one's wall seconds and result line
   (finite); K1 once per layer per HSTU forward and K2 once per layer per training step,
   and no other script launching an HSTU kernel.  The production HSTU recipe
   (``run_hstu_production_vocab.py``) at BASELINE.md's Amazon-Books geometry: V686,000,
   d256, 4 layers of 4 heads of dqk = dv = 64, B8 x L256, 2048 sampled negatives, both
   tables under sparse Adagrad: its peak memory, tokens/s, a step's device ms and idle
   share, one step of its own ``build`` card against CPU (dropout 0, given negatives), K1
   and K2 at its shape against their plain versions with their device ms, bounds and
   occupancy.  The Criteo-full recipe (``run_criteo_production.py``, scale 1.0) without a
   mesh and on a (1, 1) mesh over NCCL (torchrun's environment of one rank), the two runs'
   losses and AUCs agreeing.  The phase stays under 180 s.
19. Determinism (``determinism_phase``): K2, K2a, K2-bf16 and K2a-bf16 launched twice
   at the serving shape and at L1024, dpos and dts (and K2a's dq) bit for bit between
   the two launches; each timed (the table sums' second kernel included) at the serving
   shape and at the production recipe's B8 H4 L256 dqk 64; four steps of the serving
   HSTU through SeqTrainer twice under ``torch.use_deterministic_algorithms`` (the split
   pair), the parameters bit for bit.
20. Wide heads (``wide_phase``): each of the ten kernels against its plain version at
   (dqk, dv) = (160, 160), (256, 256), (320, 64), (64, 320), (384, 384), L200 (ragged)
   and L1024, shuffled stamps and a scattered mask, fp32 and bf16, through the entries a
   model calls (the width-tiled variants, ``csrc/hstu_wide.cuh``, where the tensor-core
   kernels do not take the width); ``examples_torch/generative/run_hstu.py``'s HSTU at
   ``--d_model 1024`` (4 heads of 256, 2 layers) at B8 x L256: one training step card
   against CPU from the same weights, ``evaluate`` in fp32 and in bf16; the launches of
   the variants.  The variants this model launches (K1's, K2's and K1-bf16's) are kernels
   of their own in the ``kernels`` line (``wide_name``: ``hstu_rab_fwd_wide``, ...),
   timed at (256, 256) beside their plain versions and the function's bound; the
   tensor-core entries' launches there count only the tensor-core kernels.
21. The tutorials (``tutorials_phase``): every code cell of the seven notebooks of
   ``tutorials_torch/`` on the card (``TORCH_RECHUB_DEVICE`` unset), each notebook's
   seconds, under 120 s in all.
22. One JSON line of kernels, then the last line ``{"ok": true, "device": ...}``.

Any failure raises, so the exit code is not 0 and the last line is not printed.
Float32 outside the bf16 phases, TF32 off, and cuBLAS's bf16 GEMMs without
reduced-precision reductions.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import csv
import gc
import importlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_rechub_tpu_torch.basic import layers  # noqa: E402
from torch_rechub_tpu_torch.basic.precision import precision_scope  # noqa: E402
from torch_rechub_tpu_torch.basic.features import DenseFeature, SequenceFeature, SparseFeature  # noqa: E402
from torch_rechub_tpu_torch.models import matching, multi_task, ranking  # noqa: E402
from torch_rechub_tpu_torch.models.generative import HLLMModel, HSTUModel, TIGERModel  # noqa: E402
from torch_rechub_tpu_torch.models.generative.rqvae import RQVAEModel  # noqa: E402
from torch_rechub_tpu_torch.models.generative.tiger import generate  # noqa: E402
from torch_rechub_tpu_torch.models.ranking import DeepFM  # noqa: E402
from torch_rechub_tpu_torch.ops import chunked_ce  # noqa: E402
from torch_rechub_tpu_torch.ops.cuda import _build, hstu_attention  # noqa: E402
from torch_rechub_tpu_torch.ops.cuda import hstu_rab_attention as rab  # noqa: E402
from torch_rechub_tpu_torch.ops.embedding import set_fused_default  # noqa: E402
from torch_rechub_tpu_torch.ops.sparse_update import pair_sparse_grads, record_rows, rowwise_adagrad_update, sparse_sgd_update  # noqa: E402
from torch_rechub_tpu_torch.serving import brute_force_topk, match_evaluation  # noqa: E402
from torch_rechub_tpu_torch.serving.retrieval import topk_scores  # noqa: E402
from torch_rechub_tpu_torch.trainers import CTRTrainer, MatchTrainer, MTLTrainer, RQVAETrainer, SeqTrainer, mtl_trainer  # noqa: E402
from torch_rechub_tpu_torch.trainers.sparse import apply_sparse_table_updates  # noqa: E402
from torch_rechub_tpu_torch.utils.data import ArrayLoader, DataGenerator, DeviceCachedLoader, SeqLoader, SequenceDataGenerator, pad_batch, pad_sequences  # noqa: E402
from torch_rechub_tpu_torch.utils.hstu_utils import RelativeBucketedTimeAndPositionBias  # noqa: E402
from torch_rechub_tpu_torch.utils import export as texport  # noqa: E402
from torch_rechub_tpu_torch.utils import mtl as mtl_utils  # noqa: E402
from torch_rechub_tpu_torch.utils.checkpoint import flat_tensors  # noqa: E402
from torch_rechub_tpu_torch.utils.profiling import annotate, device_memory_stats, trace  # noqa: E402
from torch_rechub_tpu_torch.utils.match import get_item_sample_weight  # noqa: E402
from torch_rechub_tpu_torch.utils.tiger import Trie, build_tiger_samples, semantic_id_vocab  # noqa: E402

# the module of the op K3: the package binds the name hstu_attention to the op itself
attn = importlib.import_module("torch_rechub_tpu_torch.ops.cuda.hstu_attention")

# H100 SXM published peaks (NVIDIA data sheet): fp32 outside the tensor cores,
# dense TF32 on the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 494.7e12
PEAK_HBM_BYTES = 3.35e12
TF32_PASSES = 3  # every kernel runs every product as 3xTF32: hi*hi + hi*lo + lo*hi
TENSOR_CORE_KERNELS = ("hstu_rab_fwd", "hstu_rab_bwd", "hstu_rab_bwd_dq", "hstu_rab_bwd_dkv", "hstu_attn_fwd")
# kernel vs plain version: fp32 sums of up to L products in another order than cuBLAS
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5
# backward kernels vs the plain backward: dq, dk, dv as the forward (K2's dq
# adds per-tile fp32 atomics, in an order that changes between runs); dpos
# and dts sum up to B*L^2/2 terms of either sign into one slot, in another
# order than autograd's scatter-add, so their absolute tolerance is relative
# to the table's largest slot
BWD_RTOL, BWD_ATOL = 1e-4, 1e-5
TABLE_RTOL, TABLE_ATOL_REL = 1e-4, 1e-5
# fused vs unfused model logits: the kernel's error carried through 4 layers and the vocab projection
LOGIT_RTOL, LOGIT_ATOL = 1e-4, 1e-4
# fused vs unfused parameter gradients of one batch: the backward's error
# carried back through 4 layers; elements near zero are sums that cancel, so
# the absolute tolerance is relative to each tensor's largest gradient
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-4
SERVE = dict(vocab_size=40000, d_model=256, n_heads=8, n_layers=4, dqk=32, dv=32, max_seq_len=256, num_time_buckets=128, time_bucket_fn="sqrt", time_bucket_unit="minutes", tie_embeddings=True, dropout=0.0)
BATCH, N_BATCHES = 8, 4
TRAIN_BATCHES = 6  # steps per timed training epoch
REPS = 30
GRAD_NAMES = ("dq", "dk", "dv", "dpos", "dts")
# the backward kernels: wrapper, outputs, FMAs per causal pair per unit of (dqk, dv), TPU kernel line
BWD_KERNELS = {
    "hstu_rab_bwd": dict(fn=rab.rab_backward_fused, outs=GRAD_NAMES, fma=(3, 2), line=459),
    "hstu_rab_bwd_dq": dict(fn=rab.rab_backward_dq, outs=("dq", "dpos", "dts"), fma=(2, 1), line=313),
    "hstu_rab_bwd_dkv": dict(fn=rab.rab_backward_dkv, outs=("dk", "dv"), fma=(2, 2), line=404),
}
# DeepFM at bench.py's small config (bench.py:43,90-93): batch 4096, 26 sparse features of
# vocab 10,000 and dim 16, 13 dense features, MLP (256, 128) with ReLU, dropout 0, Adam
CTR = dict(batch=4096, n_sparse=26, n_dense=13, vocab=10_000, dim=16)
CTR_MLP = {"dims": (256, 128), "dropout": 0.0, "activation": "relu"}
CTR_OPT = {"lr": 1e-3, "weight_decay": 1e-5}
# the Criteo-full geometry (bench.py:51): under "auto" the six tables of at least 262,144 rows fuse
VOCABS_FULL = [4_000_000, 2_000_000, 1_000_000, 500_000, 300_000, 300_000, 200_000, 100_000, 50_000, 50_000] + [10_000] * 16
CTR_SERVE_BATCHES = 8  # predict batches per timed pass
CTR_TRAIN_BATCHES, CTR_EPOCHS = 16, 5  # steps per timed epoch, timed epochs per loader
CTR_FIT_BATCHES = 32  # batches of learnable data, split 0.7 / 0.15 / 0.15
CTR_MODEL_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_ctr")
# the tolerances of the CPU parity tests (tests/test_torch_ctr_model.py, test_torch_ctr_train.py):
# logits and BatchNorm statistics; a step's loss, gradients and Adam; the bucketed AUC against the exact one
CTR_LOGIT_RTOL, CTR_LOGIT_ATOL = 1e-5, 1e-6
CTR_STATS_RTOL, CTR_STATS_ATOL = 1e-5, 1e-6
CTR_LOSS_RTOL, CTR_LOSS_ATOL = 2e-5, 1e-5
CTR_GRAD_RTOL, CTR_GRAD_ATOL_REL = 2e-4, 1e-4
CTR_ADAM_RTOL, CTR_ADAM_UPDATE_TOL = 1e-6, 3e-5
CTR_BUCKET_ATOL = 1e-4
# the Dense biases in front of a BatchNorm: the loss gives them an exact gradient of 0, rounding noise below
# this share of the model's largest gradient
CTR_BN_INVARIANT, CTR_NOISE_REL = ("MLP_0.Dense_0.bias", "MLP_0.Dense_1.bias"), 1e-6
# the sparse step, card against CPU: the table's step (step_ratio), which under SGD is -lr times the
# table's gradient and is held to the gradient's tolerances, under row-wise Adagrad to twice its relative
# error; an accumulator is a mean of squared row gradients, so its relative error is twice a gradient's
# too, with an absolute floor relative to the largest accumulator
CTR_STEP_RTOL = {"sgd": CTR_GRAD_RTOL, "adagrad": 2 * CTR_GRAD_RTOL}
# and the table's values at the JAX package's sparse tolerances (tests/test_sparse_embedding.py)
CTR_TABLE_RTOL, CTR_TABLE_ATOL = 1e-5, 1e-6
CTR_ACCUM_RTOL, CTR_ACCUM_ATOL_REL = 2 * CTR_GRAD_RTOL, 1e-6
CTR_SPARSE_FUSED_SMALL = (260_032, 16)  # the small config's 26 x 10,000 rows fused, padded to a multiple of 64 with a spare row
HSTU_SAMPLED = {"num_negatives": 1024}
# the ranking zoo.  Criteo-shaped: bench.py's small config (26 sparse features of vocab 10,000 and dim 16,
# 13 dense, B4096) under each model's defaults of benchmarks/models.py:13-35, dropout 0.  Sequence models:
# Amazon-Electronics-shaped at the widths of examples/ranking/run_amazon_electronics.py:74-95 (embed dim 8,
# the DIN paper's 192,403 users, 63,001 items and 801 categories), histories post-padded to L50
ZOO_CRITEO = ("WideDeep", "DCN", "DCNv2", "DCNv2_stacked", "EDCN", "AFM", "AutoInt", "FiBiNet", "DeepFFM", "FatDeepFFM")
ZOO_SEQ = ("DIN", "BST", "DIEN")
ZOO_SEQ_SHAPE = dict(users=192_403, items=63_001, cates=801, dim=8, seq_len=50, all_pad_share=0.01)
ZOO_STEPS, ZOO_EPOCHS = 8, 3  # steps per timed epoch on DeviceCachedLoader, timed epochs
ZOO_CHECK_BATCH = 1024  # card against CPU
# parameters that cannot move but by weight decay: AFM's softmax runs over an axis of size 1, so its attention
# Dense and h take an exact zero gradient (models/ranking/afm.py)
ZOO_UNMOVED = {"AFM": ("Dense_0.weight", "Dense_0.bias", "h")}
ZOO_FIT_BATCHES = 32
CARD = torch.device("cuda")
COUNTERS = {"hstu_rab_fwd": "launches", "hstu_rab_bwd": "launches_bwd", "hstu_rab_bwd_dq": "launches_bwd_dq", "hstu_rab_bwd_dkv": "launches_bwd_dkv",
            "hstu_rab_fwd_bf16": "launches_bf16", "hstu_rab_bwd_bf16": "launches_bwd_bf16", "hstu_rab_bwd_dq_bf16": "launches_bwd_dq_bf16",
            "hstu_rab_bwd_dkv_bf16": "launches_bwd_dkv_bf16"}


def wide_name(name):
    """The ``kernels`` line's name of an entry's width-tiled variant (``csrc/hstu_wide.cuh``)."""
    return name + "_wide"


def reset_counts():
    for attr in COUNTERS.values():
        setattr(rab, attr, 0)
    rab.launches_wide.clear()


def read_counts():
    """Launches since ``reset_counts``, one count per kernel: an entry's tensor-core kernel under the entry's name
    (its count less the launches that took the variant), its width-tiled variant under ``wide_name`` where it ran."""
    counts = {name: getattr(rab, attr) - rab.launches_wide.get(name, 0) for name, attr in COUNTERS.items()}
    counts.update({wide_name(name): n for name, n in rab.launches_wide.items() if n})
    return counts


def spin_cycles_per_ms():
    """Device clock cycles per ms of ``torch.cuda._sleep``, its spin wait."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(2):  # the first call pays for loading the spin kernel
        start.record()
        torch.cuda._sleep(10**7)
        end.record()
        end.synchronize()
    return 10**7 / start.elapsed_time(end)


def timed(fn, cycles_per_ms, reps=REPS, warmup=3):
    """(device ms, host-clock ms) of one call of ``fn``, each the median of ``reps``.

    Host clock: one call ended by a synchronise, what a caller waits for.
    Device time: CUDA events around one call that was enqueued while the
    device ran a spin wait longer than the enqueueing, so the events see the
    call's device work back to back and not the host's launch cost.  A call
    whose enqueueing outlasted the wait (a host stall: another process, the
    scheduler) is measured again behind a spin twice as long as it took;
    more such repeats than ``reps`` in all raise.  The garbage collector is
    off while the calls are timed.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    gc.collect()
    gc.disable()
    try:
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        spin_ms = 3 * max(walls) + 1.0  # 1 ms of margin: a host hiccup must not outlast the wait
        times, repeats, stall_ms = [], 0, 0.0
        while len(times) < reps:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            torch.cuda._sleep(int(spin_ms * cycles_per_ms))
            ev[1].record()
            t0 = time.perf_counter()
            fn()
            enqueue_ms = (time.perf_counter() - t0) * 1e3
            ev[2].record()
            ev[2].synchronize()
            if enqueue_ms < ev[0].elapsed_time(ev[1]):
                times.append(ev[1].elapsed_time(ev[2]))
                continue
            repeats, stall_ms = repeats + 1, max(stall_ms, enqueue_ms)
            if repeats > reps:
                raise AssertionError(f"the host enqueued for longer than the device waited in {repeats} calls (the last {enqueue_ms:.1f} ms): the device time would count host time")
            spin_ms = max(spin_ms, 2 * enqueue_ms + 1.0)
    finally:
        gc.enable()
    if repeats:
        print(f"    ({repeats} of {reps + repeats} timed calls were measured again: the host stalled while enqueueing, up to {stall_ms:.1f} ms)")
    return float(np.median(times)), float(np.median(walls))


# ---------------------------------------------------------------------------
# 3. kernel phase
# ---------------------------------------------------------------------------

def rab_case(seed, b, l, max_seq_len, times="sorted", mask="suffix", h=8, d=32, nb=128):
    rng = np.random.default_rng(seed)
    arr = {
        "q": (rng.normal(size=(b, h, l, d)) * 0.3).astype(np.float32),
        "k": (rng.normal(size=(b, h, l, d)) * 0.3).astype(np.float32),
        "v": (rng.normal(size=(b, h, l, d)) * 0.3).astype(np.float32),
        "pos_w": (rng.normal(size=(2 * max_seq_len - 1, h)) * 0.1).astype(np.float32),
        "ts_w": (rng.normal(size=(nb + 1, h)) * 0.1).astype(np.float32),
        "ts": None,
        "mask": None,
    }
    if times == "sorted":
        arr["ts"] = np.sort(rng.integers(0, 10**6, (b, l)), axis=1).astype(np.int32)
    elif times == "shuffled":
        arr["ts"] = rng.integers(0, 3_000_000, (b, l)).astype(np.int32)
    elif times == "wrapping":  # both ends of int32: the int32 differences wrap to small values
        near = rng.integers(0, 20_000, (b, l))
        arr["ts"] = np.where(rng.uniform(size=(b, l)) < 0.5, 2**31 - 1 - near, -(2**31) + near).astype(np.int32)
    if mask == "suffix":
        arr["mask"] = np.arange(l)[None, :] < rng.integers(l // 2, l + 1, (b, 1))
    elif mask == "scattered":
        arr["mask"] = rng.uniform(size=(b, l)) > 0.3
        arr["mask"][0, :] = False  # one fully masked row
    case = {k: None if a is None else torch.from_numpy(a).cuda() for k, a in arr.items()}
    cfg = rab.BucketCfg(num_buckets=nb, fn="sqrt", divisor=1.0, unit="minutes")
    case.update(cfg=cfg, thr=rab.compute_bucket_thresholds(cfg).cuda(), max_seq_len=max_seq_len, alpha=1.0 / math.sqrt(d))
    return case


def run_kernel(c):
    return rab.hstu_attention_rab(c["q"], c["k"], c["v"], c["pos_w"], c["ts_w"], c["ts"], c["mask"], c["alpha"], c["max_seq_len"], c["cfg"], c["thr"])


def run_plain(c):
    return rab.dense_forward(c["q"], c["k"], c["v"], c["pos_w"], c["ts_w"], c["ts"], c["mask"], c["alpha"], c["max_seq_len"], c["cfg"], c["ts"] is not None)


def valid_pairs(c):
    """(query, key) pairs this run's data needs: m <= l < L with key m unmasked, over all heads."""
    b, h, l, _ = c["q"].shape
    keys = torch.ones((b, l), dtype=torch.int64, device=c["q"].device) if c["mask"] is None else c["mask"].to(torch.int64)
    return h * int(keys.cumsum(1).sum())


def bound(flops, nbytes, peak=PEAK_FP32_FLOPS):
    """(bound ms, what bounds it): FLOPs at the peak of the units that run them vs bytes at the HBM rate."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def both_bounds(kernel, flops, nbytes):
    """{"fp32": (ms, by), "tensor": (ms, by) or None, "bound_ms", "bound_by"}: the fp32-FMA bound, and
    for the tensor-core kernels the 3xTF32 bound, which is then the least time and the reported one."""
    fp32 = bound(flops, nbytes)
    tensor = bound(TF32_PASSES * flops, nbytes, PEAK_TF32_FLOPS) if kernel in TENSOR_CORE_KERNELS else None
    least = tensor or fp32
    return dict(fp32=fp32, tensor=tensor, bound_ms=least[0], bound_by=least[1])


def bounds_text(b):
    text = f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})"
    if b["tensor"] is not None:
        text += f"; fp32-FMA bound {b['fp32'][0]:.4f} ms ({b['fp32'][1]}), 3xTF32 tensor-core bound {b['tensor'][0]:.4f} ms ({b['tensor'][1]})"
    return text


def input_bytes(c):
    return sum(t.numel() * t.element_size() for t in c.values() if isinstance(t, torch.Tensor))


def rab_bound(c):
    """K1: 2 (dqk + dv) FLOP per valid pair; inputs read and the output written once."""
    dqk, dv = c["q"].shape[-1], c["v"].shape[-1]
    return both_bounds("hstu_rab_fwd", 2 * valid_pairs(c) * (dqk + dv), input_bytes(c) + c["v"].numel() * 4)


def bwd_bound(c, g, kernel, outs):
    """A backward kernel: its FMAs per valid pair; inputs and g read, its outputs written once."""
    fq, fv = BWD_KERNELS[kernel]["fma"]
    dqk, dv = c["q"].shape[-1], c["v"].shape[-1]
    return both_bounds(kernel, 2 * valid_pairs(c) * (fq * dqk + fv * dv), input_bytes(c) + g.numel() * 4 + sum(o.numel() * 4 for o in outs))


def kernel_cases():
    return {
        "serve B8 L256 sorted times, suffix padding": rab_case(0, 8, 256, 256),
        "B8 L256 shuffled times, scattered mask, one empty row": rab_case(1, 8, 256, 256, times="shuffled", mask="scattered"),
        "B8 L256 stamps at both ends of int32 (wrapping differences)": rab_case(5, 8, 256, 256, times="wrapping"),
        "B8 L256 no times, mask None": rab_case(2, 8, 256, 256, times=None, mask=None),
        "B8 L200 ragged, maxL256": rab_case(3, 8, 200, 256),
        "B8 L1024 maxL1024": rab_case(4, 8, 1024, 1024),
    }


def sweep_case(cfg, h=8, d=32, seed=30):
    """CPU tensors on ``rab.bucket_sweep_stamps``: |t_l - t_m| hits every reachable threshold
    -1, 0 and +1 (row 0), and wrapping stamps reach |dt| = 2**31 (row 1)."""
    ts = rab.bucket_sweep_stamps(cfg, seed)
    l = ts.shape[1]
    rng = np.random.default_rng(seed)
    arr = {"q": rng.normal(size=(2, h, l, d)) * 0.1, "k": rng.normal(size=(2, h, l, d)) * 0.1, "v": rng.normal(size=(2, h, l, d)) * 0.3,
           "pos_w": rng.normal(size=(2 * l - 1, h)) * 0.1, "ts_w": rng.normal(size=(cfg.num_buckets + 1, h))}  # large ts_w: a bucket off shows
    case = {k: torch.from_numpy(a.astype(np.float32)) for k, a in arr.items()}
    case.update(ts=ts, mask=torch.ones((2, l), dtype=torch.bool), cfg=cfg, thr=rab.compute_bucket_thresholds(cfg), max_seq_len=l, alpha=1.0 / math.sqrt(d))
    return case


def sweep_phase():
    """K1, K2 and K2a + K2b on the bucket sweep of every config, against the plain version on the CPU
    (where the thresholds were computed: the card's log may round an edge differently).  Max abs errs."""
    worst = {"hstu_rab_fwd": 0.0, **{kernel: 0.0 for kernel in BWD_KERNELS}}
    for cfg in rab.SWEEP_CFGS:
        c = sweep_case(cfg)
        g = torch.from_numpy(np.random.default_rng(31).normal(size=tuple(c["v"].shape)).astype(np.float32))
        dev = {k: v.cuda() if isinstance(v, torch.Tensor) else v for k, v in c.items()}
        out = run_kernel(dev).cpu()
        args = (c["q"], c["k"], c["v"], g, c["pos_w"], c["ts_w"], c["ts"], c["mask"], c["alpha"], c["max_seq_len"], c["cfg"])
        dev_args = [a.cuda() if isinstance(a, torch.Tensor) else a for a in args] + [dev["thr"]]
        ref, ref_grads = run_plain(c), dict(zip(GRAD_NAMES, rab.dense_backward(*args, True)))
        err, ratio = check_close(f"hstu_rab_fwd on the bucket sweep {cfg}", out, ref, KERNEL_RTOL, KERNEL_ATOL)
        worst["hstu_rab_fwd"] = max(worst["hstu_rab_fwd"], err)
        parts = [f"out {err:.2e} ({ratio:.3f})"]
        for kernel, spec in BWD_KERNELS.items():
            for name, a in zip(spec["outs"], spec["fn"](*dev_args)):
                r = ref_grads[name]
                rtol, atol = (TABLE_RTOL, TABLE_ATOL_REL * float(r.abs().max()) + 1e-12) if name in ("dpos", "dts") else (BWD_RTOL, BWD_ATOL)
                err, ratio = check_close(f"{kernel}'s {name} on the bucket sweep {cfg}", a.cpu(), r, rtol, atol)
                worst[kernel] = max(worst[kernel], err)
                parts.append(f"{kernel} {name} {err:.2e} ({ratio:.3f})")
        print(f"  bucket sweep {tuple(cfg)}, L{c['max_seq_len']}, {len(c['thr'])} thresholds: max abs err (ratio) " + ", ".join(parts))
    return worst


def kernel_phase(cases, cycles_per_ms):
    worst = 0.0
    timings = {}
    for name, c in cases.items():
        out = run_kernel(c)
        ref = run_plain(c)
        torch.cuda.synchronize()
        diff = (out - ref).abs()
        err = float(diff.max())
        ratio = float((diff / (KERNEL_ATOL + KERNEL_RTOL * ref.abs())).max())
        print(f"  {name}: max abs err {err:.3e} (max |ref| {float(ref.abs().max()):.3e}), max |d|/(atol+rtol|ref|) {ratio:.3f} (rtol {KERNEL_RTOL}, atol {KERNEL_ATOL})")
        if not (torch.isfinite(out).all() and ratio <= 1.0):
            raise AssertionError(f"hstu_rab_fwd disagrees with its plain version on {name}")
        if c["mask"] is not None and not bool(c["mask"][0].any()) and not bool((out[0] == 0).all()):
            raise AssertionError("a fully masked row must give zeros")
        worst = max(worst, err)
        if name.startswith("serve") or "L1024" in name:
            (ms, wall), (plain_ms, plain_wall) = timed(lambda: run_kernel(c), cycles_per_ms), timed(lambda: run_plain(c), cycles_per_ms)
            b = rab_bound(c)
            timings[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b["bound_ms"], bound_by=b["bound_by"])
            print(f"    device time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, {bounds_text(b)}; "
                  f"host clock per call: kernel {wall:.4f} ms, plain {plain_wall:.4f} ms; medians of {REPS}")
    serve = timings[next(iter(timings))]
    return dict(max_abs_err=worst, **serve)


def backward_phase(cases, cycles_per_ms):
    """K2, and K2a + K2b, against the plain backward on every case, all five gradients."""
    worst = {name: 0.0 for name in BWD_KERNELS}
    timings = {}
    for case, c in cases.items():
        g = torch.from_numpy(np.random.default_rng(10).normal(size=tuple(c["v"].shape)).astype(np.float32)).cuda()
        args = (c["q"], c["k"], c["v"], g, c["pos_w"], c["ts_w"], c["ts"], c["mask"], c["alpha"], c["max_seq_len"], c["cfg"], c["thr"])
        ref = dict(zip(GRAD_NAMES, rab.dense_backward(*args[:-1], c["ts"] is not None)))
        empty_row = c["mask"] is not None and not bool(c["mask"][0].any())
        for kernel, spec in BWD_KERNELS.items():
            got = dict(zip(spec["outs"], spec["fn"](*args)))
            torch.cuda.synchronize()
            parts = []
            for o, t in got.items():
                r = ref[o]
                tables = o in ("dpos", "dts")
                rtol, atol = (TABLE_RTOL, TABLE_ATOL_REL * float(r.abs().max()) + 1e-12) if tables else (BWD_RTOL, BWD_ATOL)
                err = float((t - r).abs().max())
                ratio = float(((t - r).abs() / (atol + rtol * r.abs())).max())
                parts.append(f"{o} {err:.2e} ({ratio:.3f})")
                if not (torch.isfinite(t).all() and ratio <= 1.0):
                    raise AssertionError(f"{kernel} disagrees with the plain backward on {o}, {case}: max abs err {err:.3e}, ratio {ratio:.3f}")
                if empty_row and not tables and not bool((t[0] == 0).all()):
                    raise AssertionError(f"{kernel}: a fully masked row must give zero {o}")
                worst[kernel] = max(worst[kernel], err)
            print(f"  {case}, {kernel}: max abs err (max |d|/(atol+rtol|ref|)) " + ", ".join(parts))
            if case.startswith("serve") or "L1024" in case:
                ms, wall = timed(lambda: spec["fn"](*args), cycles_per_ms)
                b = bwd_bound(c, g, kernel, got.values())
                timings.setdefault(kernel, {})[case] = dict(ms=ms, bound_ms=b["bound_ms"], bound_by=b["bound_by"])
                print(f"    {kernel} device {ms:.4f} ms, {bounds_text(b)}, {valid_pairs(c):,} valid pairs; host clock per call {wall:.4f} ms")
        if case.startswith("serve") or "L1024" in case:
            plain_ms, plain_wall = timed(lambda: rab.dense_backward(*args[:-1], c["ts"] is not None), cycles_per_ms)
            for kernel in BWD_KERNELS:
                timings[kernel][case]["plain_ms"] = plain_ms
            print(f"    plain backward device {plain_ms:.4f} ms, host clock {plain_wall:.4f} ms (medians of {REPS})")
    print(f"  tolerances: dq/dk/dv rtol {BWD_RTOL} atol {BWD_ATOL}; dpos/dts rtol {TABLE_RTOL}, atol {TABLE_ATOL_REL} x the table's max |ref|")
    return {kernel: dict(max_abs_err=worst[kernel], **next(iter(timings[kernel].values()))) for kernel in BWD_KERNELS}


# ---------------------------------------------------------------------------
# 3b. the materialised-bias op hstu_attention (K3)
# ---------------------------------------------------------------------------

def bias_case(seed, b, l, max_seq_len, times="sorted", mask="suffix", shared=False, nan=False, mask_offset=False, h=8, d=32):
    """q, k, v and the bias that the serving HSTU's own rab module makes from seeded tables and stamps;
    with ``mask_offset`` the mask is a contiguous view that starts one byte into its buffer."""
    c = rab_case(seed, b, l, max_seq_len, times=times, mask=mask, h=h, d=d, nb=SERVE["num_time_buckets"])
    dev = c["q"].device
    module = RelativeBucketedTimeAndPositionBias(h, max_seq_len, SERVE["num_time_buckets"], SERVE["time_bucket_fn"], 1.0, SERVE["time_bucket_unit"],
                                                 generator=torch.Generator().manual_seed(seed), device=dev)
    with torch.no_grad():
        bias = module(seq_len=l) if shared else module(c["ts"])
        c["pos_w"], c["ts_w"] = (t.detach() for t in module.tables())
    bias = bias.contiguous()  # the module's output is a permuted view
    if nan:  # NaN where no valid pair reads: the upper triangle and the masked keys
        bias.masked_fill_(~torch.tril(torch.ones((l, l), dtype=torch.bool, device=dev)), float("nan"))
        bias.masked_fill_(~c["mask"][:, None, None, :], float("nan"))
    if mask_offset:
        flat = torch.ones(b * l + 1, dtype=torch.bool, device=dev)
        flat[1:] = c["mask"].flatten()
        c["mask"] = flat[1:].view(b, l)
        assert c["mask"].is_contiguous() and c["mask"].data_ptr() % 4 == 1
    c.update(bias=bias, max_seq_len=float(max_seq_len))
    return c


def bias_cases():
    return {
        "(a) serve B8 L256, the model's own (B, H, L, L) rab, sorted stamps, suffix padding": bias_case(20, 8, 256, 256),
        "(b) B8 L256 shared (1, H, L, L) position-only bias": bias_case(21, 8, 256, 256, shared=True),
        "(c) B8 L256 shuffled stamps, scattered mask, one empty row": bias_case(22, 8, 256, 256, times="shuffled", mask="scattered"),
        "(d) B8 L200 ragged, maxL256": bias_case(23, 8, 200, 256),
        "(e) B8 L256 padding_mask None": bias_case(24, 8, 256, 256, mask=None),
        "(f) B8 L256 NaN in the bias's upper triangle and at masked keys": bias_case(20, 8, 256, 256, nan=True),
        "(g) B8 L1024 maxL1024": bias_case(25, 8, 1024, 1024),
        "(h) B8 L256 the mask a view at byte offset 1": bias_case(26, 8, 256, 256, times="shuffled", mask="scattered", mask_offset=True),
    }


def run_op(c, bias=None):
    return hstu_attention(c["q"], c["k"], c["v"], c["bias"] if bias is None else bias, c["mask"], c["alpha"], c["max_seq_len"])


def run_op_plain(c, bias=None):
    return attn.dense_forward(c["q"], c["k"], c["v"], c["bias"] if bias is None else bias, c["mask"], c["alpha"], c["max_seq_len"])


def attn_bound(c):
    """K3: 2 (dqk + dv) FLOP per valid pair; q, k, v, the mask and the output
    moved once, and of the bias only the elements some valid pair reads.
    Both bounds: fp32 FMAs, and 3xTF32 on the tensor cores (the reported one)."""
    b, h, l, dqk = c["q"].shape
    dv = c["v"].shape[-1]
    keys = torch.ones((b, l), dtype=torch.bool, device=c["q"].device) if c["mask"] is None else c["mask"]
    pairs = valid_pairs(c)
    bias_elems = pairs if c["bias"].shape[0] == b else h * int(keys.any(0).to(torch.int64).cumsum(0).sum())
    nbytes = 4 * (2 * c["q"].numel() + 2 * c["v"].numel()) + (0 if c["mask"] is None else keys.numel()) + 4 * bias_elems
    return both_bounds("hstu_attn_fwd", 2 * pairs * (dqk + dv), nbytes)


def check_close(name, got, ref, rtol, atol):
    diff = (got - ref).abs()
    err, ratio = float(diff.max()), float((diff / (atol + rtol * ref.abs())).max())
    if not (torch.isfinite(got).all() and ratio <= 1.0):
        raise AssertionError(f"{name}: max abs err {err:.3e}, max |d|/(atol+rtol|ref|) {ratio:.3f}")
    return err, ratio


def attention_phase(cases, cycles_per_ms):
    """K3 through the op on every case against its plain version, against K1 on
    the model's own rab, and its gradients; the launch count of these op calls."""
    attn.launches = 0
    calls = 0
    worst = 0.0
    for name, c in cases.items():
        with torch.no_grad():
            out = run_op(c)
            calls += 1
            ref = run_op_plain(c)
        torch.cuda.synchronize()
        err, ratio = check_close(f"hstu_attn_fwd vs its plain version, {name}", out, ref, KERNEL_RTOL, KERNEL_ATOL)
        worst = max(worst, err)
        print(f"  {name}: max abs err {err:.3e} (max |ref| {float(ref.abs().max()):.3e}), max |d|/(atol+rtol|ref|) {ratio:.3f}")
        if c["mask"] is not None and not bool(c["mask"][0].any()) and not bool((out[0] == 0).all()):
            raise AssertionError("a fully masked row must give zeros")
        if name.startswith("(a)"):
            with torch.no_grad():
                k1 = rab.hstu_attention_rab(c["q"], c["k"], c["v"], c["pos_w"], c["ts_w"], c["ts"], c["mask"], c["alpha"], int(c["max_seq_len"]), c["cfg"], c["thr"])
            err, ratio = check_close("hstu_attn_fwd vs hstu_rab_fwd on the model's own rab", out, k1, KERNEL_RTOL, KERNEL_ATOL)
            print(f"    against K1 (hstu_attention_rab) on the same tables, stamps and mask: max abs err {err:.3e}, ratio {ratio:.3f}")
    print(f"  tolerance: rtol {KERNEL_RTOL}, atol {KERNEL_ATOL}")

    for name, c in cases.items():
        if not name.startswith(("(a)", "(b)")):
            continue
        g = torch.from_numpy(np.random.default_rng(11).normal(size=tuple(c["v"].shape)).astype(np.float32)).cuda()
        got, ref = ([t.detach().clone().requires_grad_(True) for t in (c["q"], c["k"], c["v"], c["bias"])] for _ in range(2))
        hstu_attention(*got, c["mask"], c["alpha"], c["max_seq_len"]).backward(g)
        calls += 1
        attn.dense_forward(*ref, c["mask"], c["alpha"], c["max_seq_len"]).backward(g)
        torch.cuda.synchronize()
        if got[3].grad.shape != c["bias"].shape:
            raise AssertionError(f"dbias has shape {tuple(got[3].grad.shape)}, the bias {tuple(c['bias'].shape)}")
        parts = []
        for gname, a, r in zip(("dq", "dk", "dv", "dbias"), got, ref):
            err, ratio = check_close(f"hstu_attention's {gname} vs autograd of the plain version, {name}", a.grad, r.grad, BWD_RTOL, BWD_ATOL)
            parts.append(f"{gname} {err:.2e} ({ratio:.3f})")
        print(f"  backward through the op, {name}: dbias {tuple(got[3].grad.shape)}; max abs err (ratio) " + ", ".join(parts))

    launches = attn.launches
    print(f"  hstu_attn_fwd launches {launches} over {calls} op calls")
    if launches != calls:
        raise AssertionError(f"hstu_attention did not launch K3 once per call: {launches} launches, {calls} calls")

    timings = {}
    for name, c in cases.items():
        if not name.startswith(("(a)", "(b)", "(g)")):
            continue
        with torch.no_grad():
            (ms, wall), (plain_ms, plain_wall) = timed(lambda: run_op(c), cycles_per_ms), timed(lambda: run_op_plain(c), cycles_per_ms)
        b = attn_bound(c)
        timings[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b["bound_ms"], bound_by=b["bound_by"])
        print(f"  {name}: device time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, {bounds_text(b)}, {valid_pairs(c):,} valid pairs; "
              f"host clock per call: kernel {wall:.4f} ms, plain {plain_wall:.4f} ms; medians of {REPS}")
    return dict(launches=launches, max_abs_err=worst, **timings[next(iter(timings))])


# ---------------------------------------------------------------------------
# 4. serving phase
# ---------------------------------------------------------------------------

def serving_data(n, l, vocab, seed=0, pad=True):
    """Sequences as in hstu_train_bench.py:50-55; with ``pad``, a left-padded PAD prefix on half the rows."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, vocab, (n, l)).astype(np.int32)
    for i in range(0, n, 2) if pad else ():
        tokens[i, : rng.integers(1, l // 2)] = 0
    positions = np.broadcast_to(np.arange(l, dtype=np.int32), (n, l)).copy()
    time_diffs = np.sort(rng.integers(0, 10**6, (n, l)), axis=1).astype(np.int32)
    targets = rng.integers(1, vocab, n).astype(np.int32)
    return tokens, positions, targets, time_diffs


def serving_phase(cycles_per_ms):
    l, vocab, n_layers = SERVE["max_seq_len"], SERVE["vocab_size"], SERVE["n_layers"]
    model = HSTUModel(**SERVE, generator=torch.Generator().manual_seed(0), device="cuda")
    data = serving_data(BATCH * N_BATCHES, l, vocab)
    loader = SeqLoader(*data, batch_size=BATCH)
    trainers = {"dense": SeqTrainer(model), "chunked 8192": SeqTrainer(model, vocab_chunk_size=8192)}
    forwards = [0]
    model.register_forward_pre_hook(lambda module, args: forwards.__setitem__(0, forwards[0] + 1))

    for tr in trainers.values():  # warm-up: cuBLAS handles, allocator, library load
        tr.evaluate(loader)
    torch.cuda.synchronize()

    reset_counts()
    forwards[0] = 0
    results = {}
    for name, tr in trainers.items():
        t0 = time.perf_counter()
        loss, top1 = tr.evaluate(loader)
        t_eval = time.perf_counter() - t0
        t0 = time.perf_counter()
        logits = tr.predict_logits(loader)
        t_pred = time.perf_counter() - t0
        results[name] = dict(loss=loss, top1=top1, logits=logits, t_eval=t_eval, t_pred=t_pred)
    launches, n_forward = rab.launches, forwards[0]

    print(f"  hstu_rab_fwd launches {launches} over {n_forward} model forwards x {n_layers} layers")
    if n_forward != 2 * len(trainers) * N_BATCHES or launches != n_layers * n_forward:
        raise AssertionError(f"the serving path did not run the kernel once per layer: {launches} launches, {n_forward} forwards")
    tokens = BATCH * N_BATCHES * l
    for name, r in results.items():
        print(f"  {name}: eval loss {r['loss']:.6f}, top-1 {r['top1']:.4f}, {tokens / r['t_eval']:,.0f} tokens/s, "
              f"{r['t_eval'] / N_BATCHES * 1e3:.3f} ms per request of {BATCH} sequences; predict_logits {r['t_pred'] / N_BATCHES * 1e3:.3f} ms per request")
        if not (math.isfinite(r["loss"]) and 0 < r["loss"] < 2 * math.log(vocab)) or r["logits"].shape != (BATCH * N_BATCHES, vocab) or not np.isfinite(r["logits"]).all():
            raise AssertionError(f"serving output out of range ({name})")
    dense, chunked = results["dense"], results["chunked 8192"]
    if not math.isclose(dense["loss"], chunked["loss"], rel_tol=1e-5):
        raise AssertionError(f"dense and chunked eval losses differ: {dense['loss']} vs {chunked['loss']}")

    # the same weights without the kernel (materialised bias), one batch, last position
    plain = HSTUModel(**SERVE, use_fused_kernel=False, device="cuda")
    plain.load_state_dict(model.state_dict())
    toks, _, tds, _ = next(iter(loader))
    toks, tds = torch.from_numpy(toks).cuda(), torch.from_numpy(tds).cuda()
    with torch.inference_mode():
        fused_last, plain_last = model.eval()(toks, tds)[:, -1], plain.eval()(toks, tds)[:, -1]
    diff = (fused_last - plain_last).abs()
    ratio = float((diff / (LOGIT_ATOL + LOGIT_RTOL * plain_last.abs())).max())
    print(f"  fused vs unfused last-position logits: max abs err {float(diff.max()):.3e}, max |d|/(atol+rtol|ref|) {ratio:.3f} (rtol {LOGIT_RTOL}, atol {LOGIT_ATOL})")
    if ratio > 1.0:
        raise AssertionError("the fused model disagrees with the unfused one")

    # where a request's time goes: its stages on that batch, device time against
    # the host clock; the difference is the time the device waits for the host
    tgts = torch.from_numpy(next(iter(loader))[3]).cuda()
    with torch.inference_mode():
        stages = {
            f"embeddings + {n_layers} HSTU layers (hidden states)": lambda: model(toks, tds, return_hidden=True),
            "forward with (B, L, V) logits": lambda: model(toks, tds),
            "eval_step dense (forward + log-softmax CE + top-1)": lambda: trainers["dense"].eval_step(toks, tds, tgts),
            "eval_step chunked 8192": lambda: trainers["chunked 8192"].eval_step(toks, tds, tgts),
        }
        for name, fn in stages.items():
            device, wall = timed(fn, cycles_per_ms)
            print(f"  stage {name}: device {device:.4f} ms, host clock {wall:.4f} ms, device idle {1 - device / wall:.0%} (medians of {REPS})")
    return launches


def kernel_class(name):
    for key, label in (("hstu_rab_fwd_bf16_kernel", "K1 hstu_rab_fwd_bf16"), ("hstu_rab_bwd_bf16_kernel", "K2 hstu_rab_bwd_bf16"), ("hstu_rab_fwd_kernel", "K1 hstu_rab_fwd"), ("bwd_fused_kernel<", "K2 hstu_rab_bwd"), ("bwd_kv_kernel<", "K2b hstu_rab_bwd_dkv"), ("bwd_q_kernel<", "K2a hstu_rab_bwd_dq")):
        if key in name:
            return label
    lowered = name.lower()
    if any(k in lowered for k in ("gemm", "nvjet", "xmma", "cutlass")):
        return "matrix products (cuBLAS / CUTLASS)"
    if "multi_tensor_apply" in lowered or "adam" in lowered:
        return "Adam (foreach kernels)"
    if lowered.startswith("memcpy") or lowered.startswith("memset"):
        return "copies and fills"
    return "elementwise, reductions, gathers"


def profile_kernels(fn, steps=3):
    """``{kernel name: (device ms, launches)}`` per call of ``fn``, from torch.profiler's kernel events.

    A ``record_function`` range also shows on the device's timeline (``Optimizer.step#Adam.step`` spans
    every kernel of the optimizer's step) with device time of its own; like torch.profiler's own table,
    this leaves such user annotations out, so no kernel counts twice."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    kernels = {e.key: (e.self_device_time_total / 1e3 / steps, e.count / steps) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0 and not e.is_user_annotation}
    if not kernels:
        raise AssertionError("torch.profiler saw no device time")
    return kernels


def kernel_breakdown(name, fn, steps=3, classify=kernel_class, top=0):
    """Device time per call of ``fn`` by kernel class, and its ``top`` kernels by name; returns the kernels' total ms per call."""
    return print_breakdown(name, profile_kernels(fn, steps), steps, classify, top)


def print_breakdown(name, kernels, steps, classify=kernel_class, top=0):
    """Print ``profile_kernels``' ``kernels`` by class, and the ``top`` kernels by name; returns their total ms per call."""
    classes = {}
    for key, (ms, n) in kernels.items():
        total_ms, total_n = classes.get(classify(key), (0.0, 0))
        classes[classify(key)] = (total_ms + ms, total_n + n)
    total = sum(ms for ms, _ in classes.values())
    print(f"  {name} train_step kernels by class (torch.profiler, {steps} steps): {total:.4f} ms of kernels per step")
    for label, (ms, n) in sorted(classes.items(), key=lambda kv: -kv[1][0]):
        print(f"    {ms:.4f} ms {ms / total:6.1%} {n:6.1f} launches  {label}")
    for key, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"    kernel {ms:.4f} ms {n:5.1f} launches  {key[:120]}")
    return total


# ---------------------------------------------------------------------------
# 5. training phase
# ---------------------------------------------------------------------------

def training_phase(cycles_per_ms):
    l, vocab, n_layers = SERVE["max_seq_len"], SERVE["vocab_size"], SERVE["n_layers"]
    data = serving_data(BATCH * TRAIN_BATCHES, l, vocab, seed=1, pad=False)  # the bench's data: no PAD
    loader = SeqLoader(*data, batch_size=BATCH)
    first = SeqLoader(*(a[:BATCH] for a in data), batch_size=BATCH)
    trainers = {
        name: SeqTrainer(HSTUModel(**SERVE, generator=torch.Generator().manual_seed(1), device="cuda"), vocab_chunk_size=chunk)
        for name, chunk in (("chunked 8192", 8192), ("dense", None))
    }
    for tr in trainers.values():  # warm-up: cuBLAS handles, allocator, the optimizer's state
        tr.train_one_epoch(first, log_interval=0)
    torch.cuda.synchronize()
    before = {name: [p.detach().clone() for p in tr.model.parameters()] for name, tr in trainers.items()}

    reset_counts()
    results = {}
    for name, tr in trainers.items():
        t0 = time.perf_counter()
        loss = tr.train_one_epoch(loader, log_interval=0)  # ends in a host read of the losses
        results[name] = (loss, time.perf_counter() - t0)
    rab._FUSED_BWD[0] = False  # one step through the split pair K2a + K2b
    try:
        split_loss = trainers["chunked 8192"].train_one_epoch(first, log_interval=0)
    finally:
        rab._FUSED_BWD[0] = True
    counts = read_counts()

    fused_steps = len(trainers) * TRAIN_BATCHES
    print(f"  launches over {fused_steps} steps + 1 split step, {n_layers} layers: " + ", ".join(f"{k} {v}" for k, v in counts.items()))
    expected = {**{k: 0 for k in COUNTERS}, "hstu_rab_fwd": n_layers * (fused_steps + 1), "hstu_rab_bwd": n_layers * fused_steps, "hstu_rab_bwd_dq": n_layers,
                "hstu_rab_bwd_dkv": n_layers}
    if counts != expected:
        raise AssertionError(f"the training path did not run each kernel once per layer per step: {counts}, expected {expected}")
    tokens = BATCH * TRAIN_BATCHES * l
    for name, (loss, seconds) in results.items():
        print(f"  {name}: train loss {loss:.6f}, {tokens / seconds:,.0f} tokens/s, {seconds / TRAIN_BATCHES * 1e3:.3f} ms per step of {BATCH} x L{l} (host clock, {TRAIN_BATCHES} steps)")
        if not (math.isfinite(loss) and 0 < loss < 2 * math.log(vocab)):
            raise AssertionError(f"training loss out of range ({name}): {loss}")
        moved = [float((p.detach() - q).abs().max()) > 0 for p, q in zip(trainers[name].model.parameters(), before[name])]
        if not all(moved):
            raise AssertionError(f"{moved.count(False)} parameters did not move ({name})")
    print(f"  split-pair step (K2a + K2b): loss {split_loss:.6f}")
    if not math.isfinite(split_loss):
        raise AssertionError("the split-pair step gave a non-finite loss")

    # where a training step's time goes: its stages on one batch, device time
    # against the host clock (the difference is the device waiting for the host)
    toks, _, tds, tgts = next(iter(first))
    toks, tds, tgts = (torch.from_numpy(a).cuda() for a in (toks, tds, tgts))
    cotangent = torch.from_numpy(np.random.default_rng(2).normal(size=(BATCH, l, SERVE["d_model"])).astype(np.float32)).cuda()
    for name, tr in trainers.items():
        tr.model.train()

        def fwd_layers_bwd(tr=tr):  # the layers' backward alone: a cotangent on the hidden states
            tr.optimizer.zero_grad(set_to_none=True)
            tr.model(toks, tds, return_hidden=True, generator=tr.generator)["hidden"].backward(cotangent)

        def fwd_bwd(tr=tr):
            tr.optimizer.zero_grad(set_to_none=True)
            tr.loss_fn(toks, tds, tgts).backward()

        def fwd_layers_bwd_split(tr=tr):  # the same through the split pair K2a + K2b
            rab._FUSED_BWD[0] = False
            try:
                fwd_layers_bwd(tr)
            finally:
                rab._FUSED_BWD[0] = True

        stages = {
            "forward": (f"forward, {n_layers} HSTU layers (hidden states, autograd on)", lambda tr=tr: tr.model(toks, tds, return_hidden=True, generator=tr.generator)),
            "layers": ("forward + backward of the hidden states (no loss)", fwd_layers_bwd),
            "layers split": ("forward + backward of the hidden states (no loss), _FUSED_BWD[0] = False: K2a + K2b", fwd_layers_bwd_split),
            "loss": ("forward + loss", lambda tr=tr: tr.loss_fn(toks, tds, tgts)),
            "loss bwd": ("forward + loss + backward", fwd_bwd),
            "step": ("train_step (+ Adam)", lambda tr=tr: tr.train_step(toks, tds, tgts)),
        }
        t = {}
        for key, (stage, fn) in stages.items():
            device, wall = timed(fn, cycles_per_ms)
            t[key] = device
            print(f"  {name} stage {stage}: device {device:.4f} ms, host clock {wall:.4f} ms, device idle {1 - device / wall:.0%} (medians of {REPS})")
        print(f"  {name} by difference (device ms): forward {t['forward']:.4f}, loss {t['loss'] - t['forward']:.4f}, "
              f"backward of the layers and embeddings {t['layers'] - t['forward']:.4f} (through K2a + K2b: {t['layers split'] - t['forward']:.4f}), "
              f"backward of the loss {t['loss bwd'] - t['loss'] - (t['layers'] - t['forward']):.4f}, Adam and zero_grad {t['step'] - t['loss bwd']:.4f}")

    for name, tr in trainers.items():
        kernel_breakdown(name, lambda tr=tr: tr.train_step(toks, tds, tgts))

    # one batch's parameter gradients against the same weights without the kernels
    fused = trainers["chunked 8192"]
    plain = SeqTrainer(HSTUModel(**SERVE, use_fused_kernel=False, device="cuda"), vocab_chunk_size=8192)
    plain.model.load_state_dict(fused.model.state_dict())
    for tr in (fused, plain):
        tr.model.train()
        tr.optimizer.zero_grad(set_to_none=True)
        tr.loss_fn(toks, tds, tgts).backward()
    worst = (0.0, "")
    for (pname, a), b in zip(fused.model.named_parameters(), plain.model.parameters(), strict=True):
        diff = (a.grad - b.grad).abs()
        ratio = float((diff / (GRAD_ATOL_REL * float(b.grad.abs().max()) + 1e-12 + GRAD_RTOL * b.grad.abs())).max())
        worst = max(worst, (ratio, pname))
        if not (torch.isfinite(a.grad).all() and ratio <= 1.0):
            raise AssertionError(f"the fused model's gradient of {pname} disagrees with the unfused one: max abs err {float(diff.max()):.3e}, ratio {ratio:.3f}")
    print(f"  fused vs unfused parameter gradients, one batch: worst max |d|/(atol+rtol|ref|) {worst[0]:.3f} ({worst[1]}; rtol {GRAD_RTOL}, atol {GRAD_ATOL_REL} x the tensor's max |ref|)")
    return counts


# ---------------------------------------------------------------------------
# 6. DeepFM / CTR: serving and training at bench.py's configurations
# ---------------------------------------------------------------------------

def ctr_features(vocabs):
    sparse = tuple(SparseFeature(f"C{i}", vocab_size=v, embed_dim=CTR["dim"]) for i, v in enumerate(vocabs))
    return sparse, tuple(DenseFeature(f"I{i}") for i in range(CTR["n_dense"]))


def ctr_data(n, vocabs, seed, zipf=False):
    """bench.py's data: uniform ids (zipf-distributed for the Criteo-full geometry), normal dense values, random labels."""
    rng = np.random.default_rng(seed)
    x = {f"C{i}": ((rng.zipf(1.2, n) % v) if zipf else rng.integers(0, v, n)).astype(np.int32) for i, v in enumerate(vocabs)}
    x.update({f"I{i}": rng.normal(size=n).astype(np.float32) for i in range(CTR["n_dense"])})
    return x, rng.integers(0, 2, n).astype(np.float32)


def ctr_model(vocabs, seed, device):
    """bench.py's DeepFM: the MLP over the dense features, LR and FM over the sparse ones; random weights from ``seed``."""
    sparse, dense = ctr_features(vocabs)
    return DeepFM(dense, sparse, CTR_MLP, generator=torch.Generator().manual_seed(seed), device=device)


def wall_ms(fn, reps=REPS, warmup=3):
    """Median host clock of one call of ``fn`` ended by a synchronise."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(walls))


def ratio_of(got, ref, rtol, atol):
    """max |got - ref| / (atol + rtol |ref|), over float64 copies on the CPU."""
    got, ref = got.detach().cpu().double(), ref.detach().cpu().double()
    return float(((got - ref).abs() / (atol + rtol * ref.abs())).max())


def step_ratio(after, before, d_ref, rtol, atol_rel, adds=1, carried=0.0):
    """Worst ``|d - d_ref| / tol`` of a table's step ``d = after - before`` against a reference step, and the largest reference step.

    The step is held, not the table: one SGD step moves a row by lr times a gradient of a batch
    mean, which can lie below any fixed atol on the table, so an unmoved table would pass that.
    ``tol = rtol |d_ref| + atol_rel max|d_ref| + adds eps (|after| + |before + d_ref|)``, the last
    term the fp32 rounding of the two stored tables: each add into a row rounds once, and ``adds``
    is the most adds one row takes in the step (SGD adds once per occurrence of an id).  Raises
    unless the largest reference step is ten times the largest rounding term, so that a step left
    undone, or taken with another sign or learning rate, cannot pass.  ``carried`` (a tensor or 0), what
    an Adam step makes of the two sides' gradient difference, is taken off the difference first.
    """
    after, before, d_ref = (t.detach().cpu().double() for t in (after, before, d_ref))
    rounding = adds * torch.finfo(torch.float32).eps * (after.abs() + (before + d_ref).abs())
    scale = float(d_ref.abs().max())
    if not scale > 10 * float(rounding.max()):
        raise AssertionError(f"the reference step (largest {scale:.3e}) is lost in the tables' fp32 rounding ({float(rounding.max()):.3e})")
    excess = torch.clamp_min((after - before - d_ref).abs() - carried, 0.0)
    return float((excess / (rtol * d_ref.abs() + atol_rel * scale + rounding)).max()), scale


def ctr_kernel_class(name):
    """``kernel_class`` with the gathers, the embedding backward (a sort, then segment sums) and the reductions apart."""
    lowered = name.lower()
    for keys, label in ((("indexselect", "index_select"), "gathers (embedding lookups)"),
                        (("radix", "sort"), "sorts (embedding backward)"),
                        (("segment", "compute_grad_weight", "sum_and_scatter", "embedding_backward"), "segment sums (embedding backward)"),
                        (("gemv",), "matrix products (cuBLAS / CUTLASS)"),
                        (("reduce_kernel",), "reductions (BatchNorm statistics, loss, sums)")):
        if any(k in lowered for k in keys):
            return label
    return kernel_class(name)


def ctr_serving_phase(cycles_per_ms):
    """bench.py's small config through CTRTrainer.predict / evaluate; the card's logits against the CPU's on the
    same weights; then one predict batch at the Criteo-full geometry under the "auto" layout."""
    b, small = CTR["batch"], [CTR["vocab"]] * CTR["n_sparse"]
    model = ctr_model(small, seed=0, device=CARD)
    trainer = CTRTrainer(model, optimizer_params=CTR_OPT)
    n = CTR_SERVE_BATCHES * b
    x, y = ctr_data(n, small, seed=0)
    loader = ArrayLoader(x, y, batch_size=b)
    trainer.predict(model, loader)  # warm-up: cuBLAS handles, the allocator
    walls, preds = [], None
    for _ in range(3):
        t0 = time.perf_counter()
        preds = trainer.predict(model, loader)  # ends in a host read of the probabilities
        walls.append(time.perf_counter() - t0)
    seconds = float(np.median(walls))
    if preds.shape != (n,) or preds.dtype != np.float32 or not (np.isfinite(preds).all() and ((preds > 0) & (preds < 1)).all()):
        raise AssertionError(f"predict gave {preds.shape} {preds.dtype} probabilities out of (0, 1)")
    exact, bucketed = trainer.evaluate(model, loader), trainer.evaluate(model, loader, bucketed=True)
    print(f"  small config B{b}: predict {seconds / CTR_SERVE_BATCHES * 1e3:.3f} ms per batch, {n / seconds:,.0f} examples/s "
          f"(host clock, median of 3 passes over {CTR_SERVE_BATCHES} batches); AUC on random labels: exact {exact:.5f}, bucketed {bucketed:.5f}")
    if not (0.0 <= exact <= 1.0 and abs(exact - bucketed) < CTR_BUCKET_ATOL):
        raise AssertionError(f"the bucketed AUC {bucketed} is not within {CTR_BUCKET_ATOL} of the exact {exact}")

    xb = {k: torch.from_numpy(v[:b]).to(CARD) for k, v in x.items()}
    device, wall = timed(lambda: trainer._probabilities(xb), cycles_per_ms)
    print(f"  one predict batch (the model's forward and a sigmoid): device {device:.4f} ms, host clock {wall:.4f} ms, device idle {1 - device / wall:.0%} (medians of {REPS})")

    cpu = ctr_model(small, seed=0, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    with torch.inference_mode():
        ref = cpu.eval()({k: v.cpu() for k, v in xb.items()})
        got = model.eval()(xb)
    r = ratio_of(got, ref, CTR_LOGIT_RTOL, CTR_LOGIT_ATOL)
    print(f"  card vs CPU eval logits, same weights, B{b}: max abs err {float((got.cpu() - ref).abs().max()):.3e}, max |d|/(atol+rtol|ref|) {r:.3f} (rtol {CTR_LOGIT_RTOL}, atol {CTR_LOGIT_ATOL})")
    if r > 1.0:
        raise AssertionError("the card's DeepFM logits disagree with the CPU's")
    del model, trainer, cpu

    full = ctr_model(VOCABS_FULL, seed=3, device=CARD)
    shapes = {k: tuple(v.shape) for k, v in full.EmbeddingCollection_0.named_parameters()}
    expected = {"fused_d16_table": (8_100_032, 16), "C6_table": (200_000, 16), "C7_table": (100_032, 16),
                **{f"C{i}_table": (v, 16) for i, v in enumerate(VOCABS_FULL) if v < 100_000}}
    if shapes != expected:
        raise AssertionError(f"the Criteo-full \"auto\" layout gave {shapes}, expected {expected}")
    trainer = CTRTrainer(full, optimizer_params=CTR_OPT)
    xf, yf = ctr_data(b, VOCABS_FULL, seed=3, zipf=True)
    t0 = time.perf_counter()
    preds = trainer.predict(full, ArrayLoader(xf, yf, batch_size=b))
    first = time.perf_counter() - t0
    if preds.shape != (b,) or not (np.isfinite(preds).all() and ((preds > 0) & (preds < 1)).all()):
        raise AssertionError("the Criteo-full predict gave probabilities out of (0, 1)")
    xb = {k: torch.from_numpy(v).to(CARD) for k, v in xf.items()}
    device, wall = timed(lambda: trainer._probabilities(xb), cycles_per_ms)
    table_mb = sum(math.prod(s) for s in shapes.values()) * 4 / 1e6
    print(f"  Criteo-full geometry (bench.py:51), \"auto\": fused_d16_table {shapes['fused_d16_table']} and {len(shapes) - 1} per-feature tables, {table_mb:,.0f} MB of fp32 tables; "
          f"one predict batch of {b}: {first * 1e3:.3f} ms host clock (first call), then device {device:.4f} ms, host clock {wall:.4f} ms, device idle {1 - device / wall:.0%}")


def adam_update(g, p0):
    """The first Adam step's update in float64 (weight decay in the gradient, m_hat = g, v_hat = g²)."""
    g = g.double() + CTR_OPT["weight_decay"] * p0.double()
    return g / (g.abs() + 1e-8)


def ctr_step_against_cpu(b):
    """One CTRTrainer step of a partial batch (padded by cycling rows, weight 0) on the card and on the CPU from the
    same weights: the loss, every gradient, every parameter after Adam and the BatchNorm statistics.  Adam's first
    step is about lr * sign(g), so a parameter is also allowed what the update rule makes of the two gradients'
    difference (the Dense biases in front of a BatchNorm have an exact gradient of 0, so theirs are rounding noise)."""
    small = [CTR["vocab"]] * CTR["n_sparse"]
    card = ctr_model(small, seed=2, device=CARD)
    cpu = ctr_model(small, seed=2, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    p0 = {k: v.detach().clone() for k, v in cpu.named_parameters()}
    x, y = ctr_data(b - 1000, small, seed=4)
    lr = CTR_OPT["lr"]
    losses = [CTRTrainer(m, optimizer_params=CTR_OPT, device=d).train_one_epoch(ArrayLoader(x, y, batch_size=b), log_interval=0) for m, d in ((card, CARD), (cpu, "cpu"))]
    if not (np.isfinite(losses).all() and math.isclose(losses[0], losses[1], rel_tol=CTR_LOSS_RTOL, abs_tol=CTR_LOSS_ATOL)):
        raise AssertionError(f"one step's loss: card {losses[0]}, CPU {losses[1]}")

    floor = CTR_NOISE_REL * max(float(p.grad.abs().max()) for p in cpu.parameters())
    worst = {"grad": 0.0, "param": 0.0, "stats": 0.0}
    for (name, a), p in zip(card.named_parameters(), cpu.parameters(), strict=True):
        g, r = a.grad.cpu(), p.grad
        if name in CTR_BN_INVARIANT:
            if float(g.abs().max()) >= floor or float(r.abs().max()) >= floor:
                raise AssertionError(f"{name}: a gradient the batch mean removes is not rounding noise")
        else:
            worst["grad"] = max(worst["grad"], ratio_of(g, r, CTR_GRAD_RTOL, CTR_GRAD_ATOL_REL * float(r.abs().max()) + 1e-12))
        # what is left of the difference once the update rule's share is taken off, over Adam's tolerance
        carried = lr * (adam_update(g, p0[name]) - adam_update(r, p0[name])).abs()
        excess = (a.detach().cpu().double() - p.detach().double()).abs() - carried
        worst["param"] = max(worst["param"], float((excess / (CTR_ADAM_UPDATE_TOL * lr + CTR_ADAM_RTOL * p.detach().double().abs())).max()))
        if torch.equal(p.detach(), p0[name]) and r.any():
            raise AssertionError(f"{name} did not move")
    for a, p in zip(card.buffers(), cpu.buffers(), strict=True):
        worst["stats"] = max(worst["stats"], ratio_of(a, p, CTR_STATS_RTOL, CTR_STATS_ATOL))
    print(f"  one train step, card vs CPU from the same weights, a partial batch of {b - 1000} padded to {b}: loss {losses[0]:.7f} vs {losses[1]:.7f}; "
          f"worst max |d|/tol: gradients {worst['grad']:.3f} (rtol {CTR_GRAD_RTOL}, atol {CTR_GRAD_ATOL_REL} x the tensor's max), "
          f"parameters after Adam {worst['param']:.3f} (rtol {CTR_ADAM_RTOL}, atol {CTR_ADAM_UPDATE_TOL} x lr, beyond the update rule's share), BatchNorm statistics {worst['stats']:.3f} (rtol {CTR_STATS_RTOL}, atol {CTR_STATS_ATOL})")
    if max(worst.values()) > 1.0:
        raise AssertionError(f"one train step on the card disagrees with the CPU: {worst}")


def ctr_fit_check(b):
    """fit on learnable data (the label from C0's parity and I0): the test AUC passes 0.65 within 3 epochs."""
    small = [CTR["vocab"]] * CTR["n_sparse"]
    x, _ = ctr_data(CTR_FIT_BATCHES * b, small, seed=5)
    y = ((x["C0"] % 2) + x["I0"] > 0.5).astype(np.float32)
    train, val, test = DataGenerator(x, y, seed=0).generate_dataloader(split_ratio=[0.7, 0.15], batch_size=b)
    trainer = CTRTrainer(ctr_model(small, seed=5, device=CARD), optimizer_params=CTR_OPT, n_epoch=3, model_path=CTR_MODEL_PATH)
    t0 = time.perf_counter()
    trainer.fit(train, val, log_interval=0)
    auc = trainer.evaluate(trainer.model, test)
    print(f"  fit, 3 epochs of {train.n} rows (label from C0's parity and I0): test AUC {auc:.5f} ({time.perf_counter() - t0:.2f} s with validation)")
    if not auc > 0.65:
        raise AssertionError(f"fit reached a test AUC of {auc}, not above 0.65")


def ctr_training_phase():
    """bench.py's small config through CTRTrainer.train_one_epoch on both loaders; the stages of one step; its kernels
    by class; a step against the CPU; fit on learnable data."""
    b, small = CTR["batch"], [CTR["vocab"]] * CTR["n_sparse"]
    n = CTR_TRAIN_BATCHES * b
    x, y = ctr_data(n, small, seed=1)
    loaders = {"ArrayLoader": ArrayLoader(x, y, batch_size=b), "DeviceCachedLoader": DeviceCachedLoader(x, y, batch_size=b, group_size=CTR_TRAIN_BATCHES)}
    trainers = {}
    for name, loader in loaders.items():
        trainer = CTRTrainer(ctr_model(small, seed=1, device=CARD), optimizer_params=CTR_OPT)
        before = [p.detach().clone() for p in trainer.model.parameters()]
        trainer.train_one_epoch(loader, log_interval=0)  # warm-up: cuBLAS handles, the allocator, Adam's state
        seconds, losses = [], []
        for _ in range(CTR_EPOCHS):
            t0 = time.perf_counter()
            losses.append(trainer.train_one_epoch(loader, log_interval=0))  # ends in a host read of the losses
            seconds.append(time.perf_counter() - t0)
        med = float(np.median(seconds))
        print(f"  {name}: {n / med:,.0f} examples/s, {med / CTR_TRAIN_BATCHES * 1e3:.3f} ms per step (host clock, median of {CTR_EPOCHS} epochs of "
              f"{CTR_TRAIN_BATCHES} steps of {b}; epochs {min(seconds) * 1e3:.1f}-{max(seconds) * 1e3:.1f} ms); train loss {losses[0]:.6f} -> {losses[-1]:.6f}")
        if not all(math.isfinite(v) and 0 < v < 2 for v in losses):
            raise AssertionError(f"training loss out of range ({name}): {losses}")
        moved = [not torch.equal(p.detach(), q) for p, q in zip(trainer.model.parameters(), before)]
        if not all(moved):
            raise AssertionError(f"{moved.count(False)} parameters did not move ({name})")
        trainers[name] = trainer

    # where a step's time goes: device time per call of each stage as the sum of torch.profiler's kernel events, host
    # clock by wall_ms
    trainer = trainers["DeviceCachedLoader"]
    xs, ys, ws = next(loaders["DeviceCachedLoader"].device_groups())
    dx, dy, dw = {k: v[0] for k, v in xs.items()}, ys[0], ws[0]
    model = trainer.model.train()
    ec = model.EmbeddingCollection_0

    def embed():
        return ec(dx, model.deep_features, squeeze_dim=True), ec(dx, model.fm_features)

    def embed_lr_fm():
        _, fm = embed()
        return model.LR_0(fm.reshape(fm.shape[0], -1)) + model.FM_0(fm)

    def loss_backward():
        trainer.optimizer.zero_grad(set_to_none=True)
        trainer.loss_fn(dx, dy, dw).backward()

    stages = {
        "embed": ("the embedding lookups (26 gathers) and the dense concat", embed),
        "lr_fm": ("+ LR and FM", embed_lr_fm),
        "forward": ("the model's forward (+ the MLP with BatchNorm)", lambda: model(dx, generator=trainer.generator)),
        "loss": ("+ the weighted BCE", lambda: trainer.loss_fn(dx, dy, dw)),
        "backward": ("+ backward", loss_backward),
        "step": ("train_step (+ Adam and zero_grad)", lambda: trainer.train_step(dx, dy, dw)),
    }
    walls = {key: wall_ms(fn) for key, (_, fn) in stages.items()}  # every host clock before the profiler first runs
    t = {}
    for key, (stage, fn) in stages.items():
        t[key] = sum(ms for ms, _ in profile_kernels(fn, steps=5).values())
        print(f"  stage {stage}: device {t[key]:.4f} ms (kernels, torch.profiler, 5 calls), host clock {walls[key]:.4f} ms (median of {REPS}), device idle {1 - t[key] / walls[key]:.0%}")
    print(f"  by difference (device ms): gathers {t['embed']:.4f}, LR + FM {t['lr_fm'] - t['embed']:.4f}, MLP {t['forward'] - t['lr_fm']:.4f}, "
          f"loss {t['loss'] - t['forward']:.4f}, backward {t['backward'] - t['loss']:.4f}, Adam and zero_grad {t['step'] - t['backward']:.4f}")
    kernel_breakdown(f"DeepFM B{b}", lambda: trainer.train_step(dx, dy, dw), steps=5, classify=ctr_kernel_class, top=8)
    print(f"  dense step: {sync_text(count_syncs(lambda: trainer.train_step(dx, dy, dw)))}")

    ctr_step_against_cpu(b)
    ctr_fit_check(b)


# ---------------------------------------------------------------------------
# 7. sparse row-wise embedding updates: DeepFM at the Criteo-full geometry, HSTU through K1 and K2
# ---------------------------------------------------------------------------

# CUDA runtime calls that block the host until the device is done
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")


def count_syncs(fn, steps=3):
    """Host synchronisations per call of ``fn``, counted two ways.

    ``calls``: the CUDA runtime calls that wait for the device (``SYNC_CALLS``) among torch.profiler's CPU
    events, per call, less those of profiling a call that does nothing (the ``torch.cuda.synchronize`` that
    ends the profiled calls, the profiler's own).  ``warned``: the warnings of
    ``torch.cuda.set_sync_debug_mode("warn")`` in one call, a prototype that does not see every
    synchronising operation, with the lines that raised them.
    """
    from torch.profiler import ProfilerActivity, profile

    def runtime_syncs(f):
        f()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                f()
            torch.cuda.synchronize()
        return {e.key: e.count for e in prof.key_averages() if e.key in SYNC_CALLS}

    base, counted = runtime_syncs(lambda: None), runtime_syncs(fn)
    calls = {k: (counted.get(k, 0) - base.get(k, 0)) / steps for k in SYNC_CALLS}
    calls = {k: v for k, v in calls.items() if v}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    warned = [w for w in caught if "called a synchronizing CUDA operation" in str(w.message)]
    where = sorted({f"{os.path.basename(w.filename)}:{w.lineno}" for w in warned})
    return sum(calls.values()), calls, len(warned), where


def sync_text(counted):
    total, calls, warned, where = counted
    detail = ", ".join(f"{k} {v:g}" for k, v in calls.items()) or "none"
    return f"{total:g} host synchronisations per step by torch.profiler's runtime calls ({detail}, beyond profiling a call that does nothing); set_sync_debug_mode(\"warn\") saw {warned}" + (f" ({', '.join(where)})" if where else "")


def optimizer_tensors(optimizer):
    """``(the parameters an optimizer steps, the parameters it holds state for, its state tensors)``."""
    parts = getattr(optimizer, "optimizers", [optimizer])
    params = [p for opt in parts for g in opt.param_groups for p in g["params"]]
    keyed = [p for opt in parts for p in opt.state]
    states = [v for opt in parts for s in opt.state.values() for v in s.values() if isinstance(v, torch.Tensor)]
    return params, keyed, states


def check_sparse_tables_left_out(trainer):
    """The sparse tables took no gradient, and the dense optimizer neither steps one nor holds state for one."""
    params, keyed, _ = optimizer_tensors(trainer.optimizer)
    for name, table in trainer.sparse_tables.items():
        if table.grad is not None:
            raise AssertionError(f"{name} took a dense gradient in a sparse step")
        if any(p is table for p in params + keyed):
            raise AssertionError(f"the dense optimizer steps {name} or holds state for it")


def ctr_sparse_step_against_cpu(b):
    """bench.py's small config with every table fused (one (260,032, 16) table): one sparse step of "sgd" and of
    "adagrad", card against CPU from the same weights and batch (the loss, the dense parameters after Adam, the
    table, the accumulators); sparse SGD's table against table - lr * (the dense table gradient) of a separate
    dense backward on the card.  index_add_'s float atomics sum in another order on the card."""
    small = [CTR["vocab"]] * CTR["n_sparse"]
    x, y = ctr_data(b - 1000, small, seed=8)
    xp, yp, wp = pad_batch(x, y, b)
    # each feature owns its rows of the fused table: an SGD step adds into a row once per occurrence of its id
    adds = {"sgd": max(int(np.bincount(xp[f"C{i}"]).max()) for i in range(CTR["n_sparse"])), "adagrad": 1}
    lr = CTR_OPT["lr"]
    for method in ("sgd", "adagrad"):
        card = ctr_model(small, seed=7, device=CARD)
        cpu = ctr_model(small, seed=7, device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
        p0 = {k: v.detach().clone() for k, v in cpu.named_parameters()}
        trainers = [CTRTrainer(m, optimizer_params=CTR_OPT, sparse_embedding=method, device=d) for m, d in ((card, CARD), (cpu, "cpu"))]
        (name,) = trainers[0].sparse_tables
        if tuple(p0[name].shape) != CTR_SPARSE_FUSED_SMALL:
            raise AssertionError(f"the fused small config gave {name} {tuple(p0[name].shape)}, expected {CTR_SPARSE_FUSED_SMALL}")
        losses = [tr.train_one_epoch(ArrayLoader(x, y, batch_size=b), log_interval=0) for tr in trainers]
        if not (np.isfinite(losses).all() and math.isclose(losses[0], losses[1], rel_tol=CTR_LOSS_RTOL, abs_tol=CTR_LOSS_ATOL)):
            raise AssertionError(f"one {method} sparse step's loss: card {losses[0]}, CPU {losses[1]}")

        worst = {"param": 0.0, "table": 0.0, "step": 0.0, "accum": 0.0}
        for (pname, a), p in zip(card.named_parameters(), cpu.parameters(), strict=True):
            if pname == name:
                continue
            carried = lr * (adam_update(a.grad.cpu(), p0[pname]) - adam_update(p.grad, p0[pname])).abs()
            excess = (a.detach().cpu().double() - p.detach().double()).abs() - carried
            worst["param"] = max(worst["param"], float((excess / (CTR_ADAM_UPDATE_TOL * lr + CTR_ADAM_RTOL * p.detach().double().abs())).max()))
        table_card, table_cpu = trainers[0].sparse_tables[name], trainers[1].sparse_tables[name]
        worst["table"] = ratio_of(table_card, table_cpu, CTR_TABLE_RTOL, CTR_TABLE_ATOL)
        worst["step"], moved = step_ratio(table_card, p0[name], table_cpu.detach().double() - p0[name].double(), CTR_STEP_RTOL[method], CTR_GRAD_ATOL_REL, adds[method])
        acc_card, acc_cpu = trainers[0].sparse_accums[name], trainers[1].sparse_accums[name]
        worst["accum"] = ratio_of(acc_card, acc_cpu, CTR_ACCUM_RTOL, CTR_ACCUM_ATOL_REL * float(acc_cpu.max()) + 1e-30)
        check_sparse_tables_left_out(trainers[0])
        print(f"  {method}: one sparse step, card vs CPU from the same weights, {b - 1000} rows padded to {b}: loss {losses[0]:.7f} vs {losses[1]:.7f}; worst max |d|/tol: "
              f"dense parameters after Adam {worst['param']:.3f} (beyond the update rule's share), the table {worst['table']:.3f} (max abs err "
              f"{float((table_card.detach().cpu() - table_cpu.detach()).abs().max()):.3e}; rtol {CTR_TABLE_RTOL}, atol {CTR_TABLE_ATOL}), the table's step {worst['step']:.3f} "
              f"(largest step {moved:.3e}; rtol {CTR_STEP_RTOL[method]}, atol {CTR_GRAD_ATOL_REL} x the largest step, plus {adds[method]} fp32 roundings of each table), accumulators {worst['accum']:.3f} (rtol {CTR_ACCUM_RTOL}, atol {CTR_ACCUM_ATOL_REL} x the largest)")
        if max(worst.values()) > 1.0:
            raise AssertionError(f"one {method} sparse step on the card disagrees with the CPU: {worst}")
        if method == "sgd":  # sparse SGD is dense SGD: the same weights through a dense backward on the card
            dense = ctr_model(small, seed=7, device=CARD)
            dense_trainer = CTRTrainer(dense, optimizer_params=CTR_OPT)
            dense.train()
            dx, dy, dw = dense_trainer._to_device(xp, yp.astype(np.float32), wp)
            dense_trainer.loss_fn(dx, dy, dw).backward()
            dense_table = dict(dense.named_parameters())[name]
            r_table = ratio_of(table_card, dense_table.detach() - lr * dense_table.grad, CTR_TABLE_RTOL, CTR_TABLE_ATOL)
            r, moved = step_ratio(table_card, p0[name], -lr * dense_table.grad.double(), CTR_STEP_RTOL["sgd"], CTR_GRAD_ATOL_REL, adds["sgd"])
            print(f"  sgd: the sparse step's table against table - lr * (the dense table gradient), on the card: max |d|/tol {r_table:.3f} (rtol {CTR_TABLE_RTOL}, "
                  f"atol {CTR_TABLE_ATOL}); its step against -lr * (the dense table gradient) {r:.3f} (largest step {moved:.3e}; "
                  f"rtol {CTR_STEP_RTOL['sgd']}, atol {CTR_GRAD_ATOL_REL} x the largest step, plus {adds['sgd']} fp32 roundings of the table)")
            if max(r_table, r) > 1.0:
                raise AssertionError("sparse SGD's table is not dense SGD's")
            del dense, dense_trainer


def ctr_sparse_fit_check(b):
    """fit with sparse_embedding="adagrad" on learnable data (the label from C0's parity and I0), every table fused."""
    small = [CTR["vocab"]] * CTR["n_sparse"]
    x, _ = ctr_data(CTR_FIT_BATCHES * b, small, seed=9)
    y = ((x["C0"] % 2) + x["I0"] > 0.5).astype(np.float32)
    train, val, test = DataGenerator(x, y, seed=0).generate_dataloader(split_ratio=[0.7, 0.15], batch_size=b)
    trainer = CTRTrainer(ctr_model(small, seed=9, device=CARD), optimizer_params=CTR_OPT, n_epoch=3, model_path=CTR_MODEL_PATH, sparse_embedding="adagrad")
    t0 = time.perf_counter()
    trainer.fit(train, val, log_interval=0)
    auc = trainer.evaluate(trainer.model, test)
    print(f"  sparse adagrad fit, 3 epochs of {train.n} rows: test AUC {auc:.5f} ({time.perf_counter() - t0:.2f} s with validation)")
    if not auc > 0.65:
        raise AssertionError(f"sparse fit reached a test AUC of {auc}, not above 0.65")


def ctr_sparse_phase(cycles_per_ms):
    """DeepFM at the Criteo-full geometry (bench.py:122-152: VOCABS_FULL, zipf(1.2) ids, "auto", batch 4096) with
    sparse_embedding="adagrad" on DeviceCachedLoader: the first step's rows, examples/s, a step's stages, host
    synchronisations, memory; one dense-Adam step at the same geometry; then the small config fused, card against
    CPU, and fit."""
    b = CTR["batch"]
    n = CTR_TRAIN_BATCHES * b
    x, y = ctr_data(n, VOCABS_FULL, seed=6, zipf=True)
    loader = DeviceCachedLoader(x, y, batch_size=b, group_size=CTR_TRAIN_BATCHES)
    model = ctr_model(VOCABS_FULL, seed=6, device=CARD)
    trainer = CTRTrainer(model, optimizer_params=CTR_OPT, sparse_embedding="adagrad")
    (name,) = trainer.sparse_tables
    table, accum = trainer.sparse_tables[name], trainer.sparse_accums[name]
    if tuple(table.shape) != (8_100_032, 16):
        raise AssertionError(f"the sparse table is {name} {tuple(table.shape)}")
    ec = model.EmbeddingCollection_0
    xs, ys, ws = next(loader.device_groups())
    dx, dy, dw = {k: v[0] for k, v in xs.items()}, ys[0], ws[0]

    # the first step of a fresh trainer: the batch's rows moved, every other row and accumulator is as it was
    ids = torch.cat([dx[owner].to(torch.int64) + off for owner, (_, off) in ec.layout.offsets.items()])
    touched = torch.zeros(table.shape[0], dtype=torch.bool, device=CARD)
    touched[ids] = True
    before = table.detach().clone()
    trainer.train_step(dx, dy, dw)
    check_sparse_tables_left_out(trainer)
    moved = (table.detach() != before).any(dim=1)
    n_touched, n_moved, stray = int(touched.sum()), int(moved[touched].sum()), int((moved & ~touched).sum())
    stray_accum, zero_accum = int(((accum != 0) & ~touched).sum()), int((accum[touched] == 0).sum())
    print(f"  first step: {ids.numel()} fused ids, {n_touched} distinct rows; {n_moved} of them moved, {stray} other rows changed, "
          f"{stray_accum} other accumulators non-zero, {zero_accum} touched accumulators zero; {name}.grad is None")
    if stray or stray_accum or n_moved != n_touched or zero_accum:
        raise AssertionError("the sparse step changed rows outside the batch, or left a touched row unchanged")
    del before, touched, moved

    trainer.train_one_epoch(loader, log_interval=0)  # warm-up: the allocator, Adam's state over the rest
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seconds, losses = [], []
    for _ in range(CTR_EPOCHS):
        t0 = time.perf_counter()
        losses.append(trainer.train_one_epoch(loader, log_interval=0))
        seconds.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    med = float(np.median(seconds))
    print(f"  sparse adagrad, DeviceCachedLoader: {n / med:,.0f} examples/s, {med / CTR_TRAIN_BATCHES * 1e3:.3f} ms per step (host clock, median of {CTR_EPOCHS} epochs of "
          f"{CTR_TRAIN_BATCHES} steps of {b}; epochs {min(seconds) * 1e3:.1f}-{max(seconds) * 1e3:.1f} ms); train loss {losses[0]:.6f} -> {losses[-1]:.6f}")
    if not all(math.isfinite(v) and 0 < v < 2 for v in losses):
        raise AssertionError(f"sparse training loss out of range: {losses}")
    accum_mb = sum(a.numel() * a.element_size() for a in trainer.sparse_accums.values()) / 1e6
    params, _, states = optimizer_tensors(trainer.optimizer)
    state_mb = sum(s.numel() * s.element_size() for s in states) / 1e6
    print(f"  memory: accumulators {accum_mb:.1f} MB, Adam state over the rest ({sum(p.numel() for p in params):,} parameters) {state_mb:.1f} MB, "
          f"peak allocated {peak:.3f} GB over the timed epochs")

    # a step's stages: device ms as the sum of torch.profiler's kernel events, as the dense DeepFM phase takes them,
    # host clock by wall_ms
    model.train()

    def forward():
        trainer.optimizer.zero_grad(set_to_none=True)
        with record_rows(trainer.sparse_tables) as rec:
            loss = trainer.loss_fn(dx, dy, dw)
        return loss, rec

    def backward():
        loss, rec = forward()
        loss.backward()
        return rec

    def adam():
        rec = backward()
        trainer.optimizer.step()
        return rec

    stages = {
        "forward": ("the forward and loss, the recorder open (21 gathers, LR, FM, MLP, BCE)", forward),
        "backward": ("+ backward (20 sorted per-feature embedding backwards; the fused rows' gradient)", backward),
        "adam": ("+ Adam over the rest", adam),
        "step": ("train_step (+ the row-wise Adagrad update of the fused table)", lambda: trainer.train_step(dx, dy, dw)),
    }
    walls = {key: wall_ms(fn) for key, (_, fn) in stages.items()}
    t = {}
    for key, (stage, fn) in stages.items():
        t[key] = sum(ms for ms, _ in profile_kernels(fn, steps=5).values())
        print(f"  stage {stage}: device {t[key]:.4f} ms (kernels, torch.profiler, 5 calls), host clock {walls[key]:.4f} ms (median of {REPS}), device idle {1 - t[key] / walls[key]:.0%}")
    print(f"  by difference (device ms): forward {t['forward']:.4f}, backward {t['backward'] - t['forward']:.4f}, Adam over the rest {t['adam'] - t['backward']:.4f}, "
          f"sparse update {t['step'] - t['adam']:.4f}")
    print(f"  sparse step: {sync_text(count_syncs(lambda: trainer.train_step(dx, dy, dw)))}")
    kernel_breakdown(f"DeepFM Criteo-full sparse B{b}", lambda: trainer.train_step(dx, dy, dw), steps=5, classify=ctr_kernel_class, top=8)

    # the update alone, behind a spin wait (it reads nothing back to the host)
    records = adam()
    grads = [(n_, ids_.reshape(-1), rows.grad.reshape(-1, rows.shape[-1])) for n_, ids_, rows in records.records]
    flat_ids = torch.cat([g[1].to(torch.int64) for g in grads])
    flat_grads = torch.cat([g[2] for g in grads])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rowwise_adagrad_update(table, accum, flat_ids, flat_grads, trainer.lr)
        sparse_sgd_update(table, flat_ids, flat_grads, 0.0)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    print(f"  rowwise_adagrad_update and sparse_sgd_update of {flat_ids.numel()} ids ran under torch.cuda.set_sync_debug_mode(\"error\")")
    device, wall = timed(lambda: apply_sparse_table_updates(trainer.sparse_tables, trainer.sparse_accums, records.records, "adagrad", trainer.lr), cycles_per_ms)
    print(f"  the update alone (apply_sparse_table_updates: dedup by sort, row-wise Adagrad on {flat_ids.numel()} ids): device {device:.4f} ms, host clock {wall:.4f} ms, "
          f"device idle {1 - device / wall:.0%} (medians of {REPS})")
    del records, grads, flat_ids, flat_grads

    # the same geometry and batch with dense Adam over every table
    dense = CTRTrainer(model, optimizer_params=CTR_OPT)
    dense.train_step(dx, dy, dw)  # warm-up: Adam's moments over the tables
    wall = wall_ms(lambda: dense.train_step(dx, dy, dw))
    device = sum(ms for ms, _ in profile_kernels(lambda: dense.train_step(dx, dy, dw), steps=5).values())
    syncs_dense = sync_text(count_syncs(lambda: dense.train_step(dx, dy, dw)))
    _, _, states = optimizer_tensors(dense.optimizer)
    print(f"  dense Adam step, the same geometry and batch: device {device:.4f} ms (kernels, torch.profiler, 5 calls), host clock {wall:.4f} ms (median of {REPS}), "
          f"device idle {1 - device / wall:.0%}; {syncs_dense}; Adam state {sum(s.numel() * s.element_size() for s in states) / 1e6:,.1f} MB")
    del dense, trainer, model, loader

    old = set_fused_default(True)
    try:
        ctr_sparse_step_against_cpu(b)
        ctr_sparse_fit_check(b)
    finally:
        set_fused_default(old)


def hstu_sparse_grads_against_dense(sparse, dense, batch):
    """The hooks' recorded rows' gradients, scattered into zero (V, d) tables, against the dense gradients of the
    same tables, from the same weights and equally seeded generators, both through K1 and K2."""
    worst = (0.0, "")
    for tr in (sparse, dense):
        tr.model.train()
        tr.model.zero_grad(set_to_none=True)  # also the tables another trainer of the same model stepped
        tr.generator.manual_seed(11)
    with record_rows(sparse.sparse_tables) as rec:
        loss = sparse.loss_fn(*batch)
    loss.backward()
    dense_loss = dense.loss_fn(*batch)
    dense_loss.backward()
    loss, dense_loss = float(loss.detach()), float(dense_loss.detach())
    if not math.isclose(loss, dense_loss, rel_tol=1e-6):
        raise AssertionError(f"the recorded and the dense loss differ: {loss} vs {dense_loss}")
    scattered = {name: torch.zeros_like(t) for name, t in sparse.sparse_tables.items()}
    for name, ids, grads in pair_sparse_grads(rec.records):
        scattered[name].index_add_(0, ids.to(torch.int64), grads)
    for name, got in scattered.items():
        table = sparse.sparse_tables[name]
        if table.grad is not None:
            raise AssertionError(f"{name} took a dense gradient inside the recorder")
        ref = getattr(dense.model, name.rsplit(".", 1)[-1]).grad
        diff = (got - ref).abs()
        ratio = float((diff / (GRAD_ATOL_REL * float(ref.abs().max()) + 1e-12 + GRAD_RTOL * ref.abs())).max())
        worst = max(worst, (ratio, name))
        if not (torch.isfinite(got).all() and ratio <= 1.0):
            raise AssertionError(f"the recorded row gradients of {name} disagree with its dense gradient: max abs err {float(diff.max()):.3e}, ratio {ratio:.3f}")
    if scattered["token_embedding"][0].any():
        raise AssertionError("PAD row 0 took a gradient")
    return worst


def hstu_sparse_phase():
    """The full-width untied HSTU (PERF.md §4) with the sampled softmax (1024 negatives) and
    sparse_embedding="adagrad" through SeqTrainer.train_one_epoch, on data with PAD prefixes: tokens/s, a step's
    device time and host clock, its synchronisations, K1's and K2's launches per step; PAD row 0 stays 0 and the
    output projection's fill row 0 unchanged; the recorded row gradients against the dense ones, chunked 8192 and
    sampled, through K1 and K2."""
    l, vocab, n_layers = SERVE["max_seq_len"], SERVE["vocab_size"], SERVE["n_layers"]
    cfg = {**SERVE, "tie_embeddings": False}
    data = serving_data(BATCH * TRAIN_BATCHES, l, vocab, seed=7, pad=True)
    loader = SeqLoader(*data, batch_size=BATCH)
    first = SeqLoader(*(a[:BATCH] for a in data), batch_size=BATCH)
    model = HSTUModel(**cfg, generator=torch.Generator().manual_seed(7), device="cuda")
    trainer = SeqTrainer(model, loss_type="sampled_softmax", loss_params=HSTU_SAMPLED, sparse_embedding="adagrad")
    if set(trainer.sparse_tables) != {"token_embedding", "output_projection"}:
        raise AssertionError(f"the sparse tables are {sorted(trainer.sparse_tables)}")
    out_row0 = model.output_projection[0].detach().clone()
    trainer.train_one_epoch(first, log_interval=0)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    loss = trainer.train_one_epoch(loader, log_interval=0)
    seconds = time.perf_counter() - t0
    counts = read_counts()
    expected = {**{k: 0 for k in COUNTERS}, "hstu_rab_fwd": n_layers * TRAIN_BATCHES, "hstu_rab_bwd": n_layers * TRAIN_BATCHES}
    print(f"  launches over {TRAIN_BATCHES} sparse steps, {n_layers} layers: " + ", ".join(f"{k} {v}" for k, v in counts.items()))
    if counts != expected:
        raise AssertionError(f"the sparse HSTU step did not run K1 and K2 once per layer: {counts}, expected {expected}")
    tokens = BATCH * TRAIN_BATCHES * l
    print(f"  sampled softmax ({HSTU_SAMPLED['num_negatives']} negatives), sparse adagrad: train loss {loss:.6f}, {tokens / seconds:,.0f} tokens/s, "
          f"{seconds / TRAIN_BATCHES * 1e3:.3f} ms per step of {BATCH} x L{l} (host clock, {TRAIN_BATCHES} steps)")
    if not math.isfinite(loss):
        raise AssertionError(f"sparse HSTU training loss {loss}")
    check_sparse_tables_left_out(trainer)
    if model.token_embedding[0].any() or not torch.equal(model.output_projection[0], out_row0):
        raise AssertionError("the fill row 0 of a sparse table changed")
    print("  token_embedding's PAD row 0 is exactly 0 and output_projection's fill row 0 unchanged")

    toks, _, tds, tgts = next(iter(first))
    batch = tuple(torch.from_numpy(a).cuda() for a in (toks, tds, tgts))
    wall = wall_ms(lambda: trainer.train_step(*batch))
    device = sum(ms for ms, _ in profile_kernels(lambda: trainer.train_step(*batch), steps=5).values())
    print(f"  a sparse step: device {device:.4f} ms (kernels, torch.profiler, 5 calls), host clock {wall:.4f} ms (median of {REPS}), device idle {1 - device / wall:.0%}; "
          f"{sync_text(count_syncs(lambda: trainer.train_step(*batch)))}")
    kernel_breakdown("HSTU sparse sampled", lambda: trainer.train_step(*batch), steps=5)

    # the recorded rows' gradients against the dense ones, from the same weights
    plain = HSTUModel(**cfg, device="cuda")
    plain.load_state_dict(model.state_dict())
    pairs = {
        "chunked 8192": (SeqTrainer(model, vocab_chunk_size=8192, sparse_embedding="sgd"), SeqTrainer(plain, vocab_chunk_size=8192)),
        "sampled softmax": (SeqTrainer(model, loss_type="sampled_softmax", loss_params=HSTU_SAMPLED, sparse_embedding="sgd"), SeqTrainer(plain, loss_type="sampled_softmax", loss_params=HSTU_SAMPLED)),
    }
    for label, (sparse, dense) in pairs.items():
        ratio, worst_name = hstu_sparse_grads_against_dense(sparse, dense, batch)
        print(f"  {label}: recorded row gradients ({', '.join(sparse.sparse_tables)}) scattered vs the dense table gradients, one batch through K1 and K2: "
              f"worst max |d|/(atol+rtol|ref|) {ratio:.3f} ({worst_name}; rtol {GRAD_RTOL}, atol {GRAD_ATOL_REL} x the tensor's max |ref|); PAD row 0's gradient 0")
    return counts


# ---------------------------------------------------------------------------
# 9. the ranking zoo through CTRTrainer: Criteo-shaped and sequence models
# ---------------------------------------------------------------------------

def zoo_model(name, seed, device):
    """One configuration of the zoo at full width, random weights from ``seed``."""
    kw = {"generator": torch.Generator().manual_seed(seed), "device": device}
    if name in ZOO_SEQ:
        return zoo_seq_model(name, **kw)
    vocab, dim = CTR["vocab"], CTR["dim"]
    sparse, dense = ctr_features([vocab] * CTR["n_sparse"])
    mlp = CTR_MLP
    if name in ("DeepFFM", "FatDeepFFM"):
        n = CTR["n_sparse"]
        cross = tuple(SparseFeature(f"C{i}", vocab_size=vocab * n, embed_dim=dim) for i in range(n))  # field-aware ids x·F + offset
        linear = tuple(SparseFeature(f"C{i}", vocab_size=vocab, embed_dim=1) for i in range(n))
        if name == "DeepFFM":
            return ranking.DeepFFM(linear, cross, dim, mlp, **kw)
        return ranking.FatDeepFFM(linear, cross, dim, 2, mlp, **kw)
    return {
        "WideDeep": lambda: ranking.WideDeep(dense, sparse, mlp, **kw),
        "DCN": lambda: ranking.DCN(sparse + dense, 3, mlp, **kw),
        "DCNv2": lambda: ranking.DCNv2(sparse + dense, 3, mlp, model_structure="parallel", use_low_rank_mixture=True, low_rank=32, num_experts=4, **kw),
        "DCNv2_stacked": lambda: ranking.DCNv2(sparse + dense, 3, mlp, model_structure="stacked", use_low_rank_mixture=False, **kw),
        "EDCN": lambda: ranking.EDCN(sparse, 2, mlp, **kw),
        "AFM": lambda: ranking.AFM(sparse, dim, t=64, **kw),
        "AutoInt": lambda: ranking.AutoInt(sparse, dense, num_layers=3, num_heads=2, mlp_params=mlp, **kw),
        "FiBiNet": lambda: ranking.FiBiNet(sparse, mlp, bilinear_type="field_interaction", **kw),
    }[name]()


def zoo_seq_model(name, **kw):
    """DIN, BST or DIEN on the Amazon-Electronics shape, with the example's widths."""
    s, d = ZOO_SEQ_SHAPE, ZOO_SEQ_SHAPE["dim"]
    profile = (SparseFeature("user_id", s["users"], d),)
    target = (SparseFeature("target_item_id", s["items"], d, padding_idx=0), SparseFeature("target_cate_id", s["cates"], d, padding_idx=0))
    history = (SequenceFeature("hist_item_id", s["items"], d, pooling="concat", shared_with="target_item_id", padding_idx=0),
               SequenceFeature("hist_cate_id", s["cates"], d, pooling="concat", shared_with="target_cate_id", padding_idx=0))
    head = {"dims": (64, 32), "dropout": 0.0}
    if name == "DIN":
        return ranking.DIN(profile, history, target, head, {"dims": (36,), "activation": "dice"}, **kw)
    if name == "BST":
        return ranking.BST(profile, history, target, head, nhead=2, dropout=0.0, num_layers=1, max_seq_len=s["seq_len"] + 1, dim_feedforward=64, **kw)
    neg = (SequenceFeature("neg_hist_item_id", s["items"], d, pooling="concat", shared_with="target_item_id", padding_idx=0),)
    return ranking.DIEN(profile, history[:1], neg, target[:1], head, alpha=0.2, **kw)


def zoo_data(name, n, seed):
    """Criteo-shaped data as bench.py's (``ctr_data``), or histories of lengths 1-50 post-padded to L50 with
    a share of all-PAD rows, uniform items and categories, the negatives as the example draws them."""
    if name not in ZOO_SEQ:
        return ctr_data(n, [CTR["vocab"]] * CTR["n_sparse"], seed)
    s, rng = ZOO_SEQ_SHAPE, np.random.default_rng(seed)
    lengths = rng.integers(1, s["seq_len"] + 1, n)
    lengths[rng.uniform(size=n) < s["all_pad_share"]] = 0
    valid = np.arange(s["seq_len"])[None, :] < lengths[:, None]
    hist = np.where(valid, rng.integers(1, s["items"], (n, s["seq_len"])), 0).astype(np.int32)
    neg = np.where(hist > 0, (hist + rng.integers(1, s["items"] - 1, hist.shape)) % s["items"], 0)
    x = {"user_id": rng.integers(0, s["users"], n).astype(np.int32), "hist_item_id": hist,
         "hist_cate_id": np.where(valid, rng.integers(1, s["cates"], hist.shape), 0).astype(np.int32),
         "neg_hist_item_id": np.where((neg == 0) & (hist > 0), 1, neg).astype(np.int32),
         "target_item_id": rng.integers(1, s["items"], n).astype(np.int32), "target_cate_id": rng.integers(1, s["cates"], n).astype(np.int32)}
    return x, rng.integers(0, 2, n).astype(np.float32)


def shift_invariant(names):
    """The Dense biases right in front of a BatchNorm: the batch mean removes them, so the loss does not depend on them."""
    out = set()
    for name in names:
        m = re.match(r"(.*)Dense_(\d+)\.bias$", name)
        if m and f"{m.group(1)}BatchNorm_{m.group(2)}.weight" in names:
            out.add(name)
    return out


@torch.no_grad()
def redraw_tables(model, seed, suffixes=("_table",)):
    """Every embedding table (a parameter whose name ends in one of ``suffixes``) redrawn at N(0, 0.3²), as the
    CPU parity tests do: with tables near their 1e-4 start, BST's target position is nearly the same position
    embedding in every row, and the train-mode BatchNorm of its MLP divides by a variance that E[x²] − E[x]²
    loses to fp32 rounding, on either device; SINE's concept scores lie within rounding of each other."""
    g = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        if name.endswith(suffixes):
            p.copy_(0.3 * torch.randn(p.shape, generator=g))


@contextlib.contextmanager
def kink_branches(masks, replay):
    """Record the branch that every relu / leaky_relu took (``replay=False``, appending ``x > 0`` to ``masks``),
    or take the recorded branches in the same order (``replay=True``); yields ``[count]`` of the elements whose
    own branch differs from the recorded one.  A ReLU input within rounding of 0 takes one branch on one device
    and the other on the other: the forward barely moves, but that element's gradient is whole on one side and 0
    on the other, and a train-mode BatchNorm spreads it over its column.  With 10^5-10^6 such inputs in a step
    that happens; replaying the card's branches on the CPU compares the gradients of the same function."""
    relu, leaky = torch.relu, F.leaky_relu
    recorded, crossed = iter(list(masks)), [0]

    def branch(x):
        if not replay:
            masks.append((x > 0).cpu())
            return x > 0
        m = next(recorded).to(x.device)
        crossed[0] += int((m != (x > 0)).sum())
        return m

    torch.relu = lambda x: torch.where(branch(x), x, torch.zeros_like(x))
    F.leaky_relu = lambda x, negative_slope=0.01, inplace=False: torch.where(branch(x), x, negative_slope * x)
    try:
        yield crossed
    finally:
        torch.relu, F.leaky_relu = relu, leaky


def against_cpu(label, cpu, outputs, train_step, b, atol_rel=0.0, first_update=adam_update):
    """A model on the CPU against a copy on the card: ``outputs(model, device)``, a dict of output tensors in
    eval mode (max abs err of the first; the absolute tolerance ``CTR_LOGIT_ATOL`` plus ``atol_rel`` times the
    output's largest magnitude), then ``train_step(model, device)``, one step of a fresh trainer on a
    partial batch padded to ``b`` returning its loss: the loss, every gradient, every parameter's step (after
    minus before, ``step_ratio``, less what the first update ``first_update(g, p0)`` (Adam's, with weight decay in
    the gradient, unless given) makes of the gradients' difference) and the
    BatchNorm statistics.  A gradient is a sum over the rows that may cancel, so its error scales with the
    terms and not with the sum: the absolute part of its tolerance is relative to the model's largest gradient.
    The CPU's step takes the branches the card's ReLUs took (``kink_branches``).  The Dense biases in front of a
    BatchNorm do not change the loss: their gradients are rounding noise, of a size that says nothing (the
    BatchNorm divides by the batch's standard deviation), and are not compared; their steps are, less Adam's
    share.  Any other gradient that is exactly 0 must be noise on both sides, below b·eps of the largest
    gradient.  Returns ``(worst, where, max_abs, losses, unmoved, (inputs across 0, inputs))``."""
    model = copy.deepcopy(cpu).to(CARD)
    with torch.inference_mode():
        got, ref = outputs(model.eval(), CARD), outputs(cpu.eval(), "cpu")
    worst = {key: ratio_of(got[key], ref[key], CTR_LOGIT_RTOL, CTR_LOGIT_ATOL + atol_rel * float(ref[key].abs().max())) for key in ref}
    first = next(iter(ref))
    max_abs = float((got[first].cpu() - ref[first]).abs().max())

    p0 = {k: v.detach().clone() for k, v in cpu.named_parameters()}
    masks, losses = [], []
    for m, d, replay in ((model, CARD, False), (cpu, "cpu", True)):
        with kink_branches(masks, replay) as crossed:
            losses.append(train_step(m, d))
    if not (np.isfinite(losses).all() and math.isclose(losses[0], losses[1], rel_tol=CTR_LOSS_RTOL, abs_tol=CTR_LOSS_ATOL)):
        raise AssertionError(f"{label}: one step's loss, card {losses[0]}, CPU {losses[1]}")
    lr, eps = CTR_OPT["lr"], torch.finfo(torch.float32).eps
    largest = max(float(p.grad.abs().max()) for p in cpu.parameters() if p.grad is not None)
    floor = b * eps * largest
    worst.update(grad=0.0, step=0.0, stats=0.0)
    where, still = {}, []
    invariant = shift_invariant({k for k, _ in cpu.named_parameters()})
    for (pname, a), p in zip(model.named_parameters(), cpu.parameters(), strict=True):
        g, r = a.grad.cpu(), p.grad
        if pname in invariant:
            pass
        elif float(r.abs().max()) < floor:  # an exact 0: both must be rounding noise
            if float(g.abs().max()) >= floor:
                raise AssertionError(f"{label} {pname}: a gradient that is exactly 0 reads {float(g.abs().max()):.3e} on the card")
        elif ratio_of(g, r, CTR_GRAD_RTOL, CTR_GRAD_ATOL_REL * largest) > worst["grad"]:
            worst["grad"], where["grad"] = ratio_of(g, r, CTR_GRAD_RTOL, CTR_GRAD_ATOL_REL * largest), pname
        d_ref = p.detach() - p0[pname]
        if not d_ref.any():  # a zero parameter with an exact zero gradient: neither side moves it
            if not torch.equal(a.detach().cpu(), p0[pname]):
                raise AssertionError(f"{label} {pname} moved on the card and not on the CPU")
            still.append(pname)
            continue
        carried = lr * (first_update(g, p0[pname]) - first_update(r, p0[pname])).abs()
        step = step_ratio(a, p0[pname], d_ref, CTR_GRAD_RTOL, CTR_ADAM_UPDATE_TOL, carried=carried)[0]
        if step > worst["step"]:
            worst["step"], where["step"] = step, pname
    for a, p in zip(model.buffers(), cpu.buffers(), strict=True):
        if p.is_floating_point():
            worst["stats"] = max(worst["stats"], ratio_of(a, p, CTR_STATS_RTOL, CTR_STATS_ATOL))
    return worst, where, max_abs, losses, still, (crossed[0], sum(m.numel() for m in masks))


def zoo_against_cpu(name, b):
    """A fresh model from a seed with its tables redrawn, on the CPU and a copy on the card (a model trained on
    random labels grows sharp enough that fp32 rounding, not the device, decides its gradients), through
    ``against_cpu``: eval logits (DIEN's aux loss) on ``b`` rows, then one step of a fresh CTRTrainer on a
    partial batch padded to ``b`` on each."""
    cpu = zoo_model(name, seed=2, device="cpu")
    redraw_tables(cpu, seed=4)
    x, y = zoo_data(name, b, seed=3)

    def outputs(m, d):
        out = m({k: torch.from_numpy(v).to(d) for k, v in x.items()})
        return {"logits": out[0], "aux": out[1].reshape(1)} if name == "DIEN" else {"logits": out}

    xs, ys = {k: v[: b - 100] for k, v in x.items()}, y[: b - 100]

    def train_step(m, d):
        return CTRTrainer(m, optimizer_params=CTR_OPT, loss_mode=name != "DIEN", device=d).train_one_epoch(ArrayLoader(xs, ys, batch_size=b), log_interval=0)

    worst, where, max_abs, losses, still, kinks = against_cpu(name, cpu, outputs, train_step, b)
    if still != [k for k in ZOO_UNMOVED.get(name, ()) if k in still]:
        raise AssertionError(f"{name}: {still} kept their values in a step")
    return worst, where, max_abs, losses, still, kinks


def zoo_config(name):
    """One configuration: CTRTrainer.train_one_epoch on DeviceCachedLoader (examples/s, ms per step, every
    parameter moved), a step's device time, host clock and launches, predict, and the card against the CPU."""
    b = CTR["batch"]
    model = zoo_model(name, seed=0, device=CARD)
    n_params = sum(p.numel() for p in model.parameters())
    trainer = CTRTrainer(model, optimizer_params=CTR_OPT, loss_mode=name != "DIEN")
    x, y = zoo_data(name, ZOO_STEPS * b, seed=1)
    loader = DeviceCachedLoader(x, y, batch_size=b, group_size=ZOO_STEPS)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    trainer.train_one_epoch(loader, log_interval=0)  # warm-up: cuBLAS handles, the allocator, Adam's state
    seconds, losses = [], []
    for _ in range(ZOO_EPOCHS):
        t0 = time.perf_counter()
        losses.append(trainer.train_one_epoch(loader, log_interval=0))  # ends in a host read of the losses
        seconds.append(time.perf_counter() - t0)
    med = float(np.median(seconds))
    if not all(math.isfinite(v) and 0 < v < 5 for v in losses):
        raise AssertionError(f"{name}: training loss out of range: {losses}")
    unmoved = [k for k, p in model.named_parameters() if torch.equal(p.detach(), before[k])]
    exempt = ZOO_UNMOVED.get(name, ())
    if [k for k in unmoved if k not in exempt]:
        raise AssertionError(f"{name}: {[k for k in unmoved if k not in exempt]} did not move")
    for k in exempt:  # by construction: an exact zero gradient, so only weight decay moves them
        if model.get_parameter(k).grad.any():
            raise AssertionError(f"{name} {k}: a gradient that is 0 by construction is not")

    xs, ys, ws = next(loader.device_groups())
    dx, dy, dw = {k: v[0] for k, v in xs.items()}, ys[0], ws[0]
    step = lambda: trainer.train_step(dx, dy, dw)  # noqa: E731
    wall = wall_ms(step, reps=10)
    kernels = profile_kernels(step, steps=3)
    device, launches = sum(ms for ms, _ in kernels.values()), sum(n for _, n in kernels.values())
    classes = {}
    for key, (ms, n) in kernels.items():
        total_ms, total_n = classes.get(ctr_kernel_class(key), (0.0, 0))
        classes[ctr_kernel_class(key)] = (total_ms + ms, total_n + n)

    predict_loader = ArrayLoader(x, y, batch_size=b)
    trainer.predict(model, predict_loader)  # warm-up
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        preds = trainer.predict(model, predict_loader)
        walls.append(time.perf_counter() - t0)
    pred_s = float(np.median(walls))
    if preds.shape != (ZOO_STEPS * b,) or not (np.isfinite(preds).all() and ((preds >= 0) & (preds <= 1)).all()):
        raise AssertionError(f"{name}: predict gave probabilities out of [0, 1]")

    worst, where, max_abs, step_losses, still, kinks = zoo_against_cpu(name, ZOO_CHECK_BATCH)
    row = dict(name=name, params=n_params, ms_step=med / ZOO_STEPS * 1e3, ex_s=ZOO_STEPS * b / med, device_ms=device, host_ms=wall, idle=1 - device / wall,
               launches=launches, predict_ms=pred_s / ZOO_STEPS * 1e3, predict_ex_s=ZOO_STEPS * b / pred_s, worst=worst, max_abs=max_abs)
    print(f"  {name} ({n_params:,} parameters): train {row['ex_s']:,.0f} examples/s, {row['ms_step']:.3f} ms per step (host clock, median of {ZOO_EPOCHS} epochs of "
          f"{ZOO_STEPS} steps of {b}), loss {losses[0]:.5f} -> {losses[-1]:.5f}; a step: device {device:.4f} ms (torch.profiler kernels, 3 steps), host clock {wall:.4f} ms "
          f"(median of 10), device idle {row['idle']:.0%}, {launches:.1f} launches; predict {row['predict_ms']:.3f} ms per batch, {row['predict_ex_s']:,.0f} examples/s")
    print("    a step's kernels by class: " + "; ".join(f"{label} {ms:.4f} ms ({n:.0f})" for label, (ms, n) in sorted(classes.items(), key=lambda kv: -kv[1][0])[:4]))
    print(f"    card vs CPU, same weights, B{ZOO_CHECK_BATCH}: eval logits max abs err {max_abs:.3e}, worst max |d|/tol: "
          + ", ".join(f"{k} {v:.3f}" + (f" ({where[k]})" if k in where else "") for k, v in worst.items())
          + f" (logits rtol {CTR_LOGIT_RTOL} atol {CTR_LOGIT_ATOL}; gradients rtol {CTR_GRAD_RTOL} atol {CTR_GRAD_ATOL_REL} x the model's largest; steps rtol {CTR_GRAD_RTOL} atol {CTR_ADAM_UPDATE_TOL} x"
          f" the largest step, beyond Adam's share); one step's loss {step_losses[0]:.7f} vs {step_losses[1]:.7f}; the CPU step took the card's ReLU branches, {kinks[0]} of {kinks[1]:,} inputs"
          " on the other side of 0 there" + (f"; unmoved by construction: {still}" if still else ""))
    if max(worst.values()) > 1.0:
        raise AssertionError(f"{name}: the card disagrees with the CPU: {worst}")
    return row


def zoo_fit_check(name, b):
    """fit on learnable data to a test AUC above 0.65 within 3 epochs: DCNv2 on the label of the DeepFM check
    (C0's parity and I0), DIN on the target category's parity."""
    x, _ = zoo_data(name, ZOO_FIT_BATCHES * b, seed=5)
    y = (((x["C0"] % 2) + x["I0"] > 0.5) if name not in ZOO_SEQ else (x["target_cate_id"] % 2 == 1)).astype(np.float32)
    train, val, test = DataGenerator(x, y, seed=0).generate_dataloader(split_ratio=[0.7, 0.15], batch_size=b)
    trainer = CTRTrainer(zoo_model(name, seed=5, device=CARD), optimizer_params=CTR_OPT, n_epoch=3, model_path=CTR_MODEL_PATH)
    t0 = time.perf_counter()
    trainer.fit(train, val, log_interval=0)
    auc = trainer.evaluate(trainer.model, test)
    print(f"  {name} fit, 3 epochs of {train.n} rows: test AUC {auc:.5f} ({time.perf_counter() - t0:.2f} s with validation)")
    if not auc > 0.65:
        raise AssertionError(f"{name}: fit reached a test AUC of {auc}, not above 0.65")


def zoo_phase():
    t0 = time.perf_counter()
    rows = [zoo_config(name) for name in ZOO_CRITEO + ZOO_SEQ]
    print("  summary (ms per step / examples/s host clock; device ms, host ms, idle and launches of one step; predict ms per batch of 4096):")
    for r in rows:
        print(f"    {r['name']:14s} {r['ms_step']:9.3f} ms {r['ex_s']:12,.0f} ex/s | device {r['device_ms']:8.4f} host {r['host_ms']:8.4f} idle {r['idle']:4.0%} launches {r['launches']:7.1f} | predict {r['predict_ms']:8.3f} ms")
    for name in ("DCNv2", "DIN"):
        zoo_fit_check(name, CTR["batch"])
    print(f"  ranking zoo phase: {time.perf_counter() - t0:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# 10. matching through MatchTrainer, and exact top-k retrieval
# ---------------------------------------------------------------------------

# MovieLens-1M's widths (examples/matching/run_ml_matching.py:33-58, benchmarks/configs/matching/*.yaml): 6,040 users
# and 3,706 movies, ids shifted by one (0 is PAD), d16, user MLP (64, 16), histories of up to 20 items, 3 negatives, B256
ML1M = dict(users=6040, items=3706, dim=16, seq_len=20, n_neg=3, batch=256)
MATCH_CONFIGS = ("DSSM", "DSSMSENet", "FaceBookDSSM", "YoutubeDNN", "YoutubeSBC", "GRU4Rec", "NARM", "STAMP", "SASRec", "MIND", "ComirecSA", "ComirecDR", "SINE", "DSSM:in_batch")
MATCH_MODES = {"DSSM": 0, "DSSMSENet": 0, "FaceBookDSSM": 1, "SASRec": 1}  # the rest list-wise (mode 2)
MATCH_FULL_SOFTMAX = ("NARM", "STAMP")  # list-wise over every movie, the label the positive's id
MATCH_TOWERS = ("NARM", "STAMP", "SASRec")  # their item tower needs an item feature: the same weights built with one
MATCH_TABLES = ("_table", "_embedding", "position_emb")
MATCH_STEPS, MATCH_EPOCHS = 8, 3  # steps per timed epoch on DeviceCachedLoader, timed epochs
# a score is a dot product whose fp32 rounding (another summation order in cuBLAS than on the CPU) scales with its
# terms, not with the score: NARM's and STAMP's full-softmax scores of size 10-30 cancel to near 0, so the card
# against the CPU takes an absolute tolerance of 1e-6 of the largest score beside CTR_LOGIT_ATOL
MATCH_SCORE_ATOL_REL = 1e-6
# fit on histories and positives from one of MATCH_FIT["clusters"] groups of movies per user (user_id % clusters):
# chance recall@10 is 10 / 3,707 = 0.27%, and the check asks for ten times that; knowing the group alone gives up
# to 10 / 12.  MIND's capsules learn the groups more slowly than YoutubeDNN's mean-pooled history
MATCH_FIT = dict(rows=40_960, test=2048, epochs={"YoutubeDNN": 3, "MIND": 5}, clusters=300, chance_times=10)
MATCH_MODEL_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_match")
# YoutubeDNN at the production geometry of BASELINE.md:321-328 (benchmarks/models.py:39 for the user MLP): 200,000
# users, an 8,000,000 x 64 item table, 20-item mean-pooled histories sharing it, in-batch negatives, B1024, zipf ids
PROD = dict(users=200_000, items=8_000_000, dim=64, seq_len=20, batch=1024, steps=8, epochs=3)
SERVE_TOPK = dict(users=8192, user_batch=128, k=10, check_users=256, check_batch=32)


def match_model(name, seed, device, towers=False):
    """One configuration at ML-1M's widths, random weights from ``seed``, dropout 0; ``towers`` builds NARM,
    STAMP and SASRec with an item feature (no other parameter), so their item tower exists."""
    s, d = ML1M, ML1M["dim"]
    kw = {"generator": torch.Generator().manual_seed(seed), "device": device}
    n_users, n_items = s["users"] + 1, s["items"] + 1
    user = SparseFeature("user_id", n_users, d, padding_idx=0)
    hist_mean = SequenceFeature("hist_movie_id", n_items, d, pooling="mean", shared_with="movie_id", padding_idx=0)
    hist = SequenceFeature("hist_movie_id", n_items, d, pooling="concat", shared_with="movie_id", padding_idx=0)
    item = (SparseFeature("movie_id", n_items, d, padding_idx=0),)
    neg = (SequenceFeature("neg_items", n_items, d, pooling="concat", shared_with="movie_id", padding_idx=0),)
    mlp = {"dims": (64, d), "dropout": 0.0}
    frame = dict(user_features=(user,), history_features=(hist,), item_features=item, neg_item_feature=neg)
    base = name.partition(":")[0]
    if base in ("DSSM", "DSSMSENet"):
        return getattr(matching, base)((user, hist_mean), item, mlp, mlp, **kw)
    if base == "FaceBookDSSM":
        return matching.FaceBookDSSM((user, hist_mean), item, (SparseFeature("neg_item", n_items, d, shared_with="movie_id", padding_idx=0),), mlp, mlp, **kw)
    if base == "YoutubeDNN":
        return matching.YoutubeDNN((user, hist_mean), item, neg, mlp, **kw)
    if base == "YoutubeSBC":
        return matching.YoutubeSBC((user, hist_mean), item, (DenseFeature("sample_weight"),), mlp, mlp, batch_size=s["batch"], n_neg=s["n_neg"], **kw)
    if base == "GRU4Rec":
        return matching.GRU4Rec(**frame, user_params={**mlp, "num_layers": 1}, **kw)
    if base == "MIND":
        return matching.MIND(**frame, max_length=s["seq_len"], **kw)
    if base == "ComirecSA":
        return matching.ComirecSA(**frame, **kw)
    if base == "ComirecDR":
        return matching.ComirecDR(**frame, max_length=s["seq_len"], **kw)
    if base == "SINE":
        return matching.SINE(("hist_movie_id",), ("movie_id",), ("neg_items",), n_items, d, hidden_dim=32, num_concept=10, num_intention=4, seq_max_len=s["seq_len"], **kw)
    session = SequenceFeature("hist_movie_id", n_items, d, pooling="concat", padding_idx=0)
    target = SparseFeature("movie_id", n_items, d, padding_idx=0) if towers else None
    if base == "NARM":
        return matching.NARM(session, hidden_dim=32, emb_dropout_p=0.0, session_rep_dropout_p=0.0, item_feature=target, **kw)
    if base == "STAMP":
        return matching.STAMP(session, weight_std=0.05, emb_std=0.05, item_feature=target, **kw)
    seqs = (SequenceFeature("seq", n_items, d, pooling="concat", padding_idx=0),) + tuple(SequenceFeature(f, n_items, d, pooling="concat", shared_with="seq", padding_idx=0) for f in ("pos", "neg"))
    target = SparseFeature("movie_id", n_items, d, shared_with="seq", padding_idx=0) if towers else None
    return matching.SASRec(seqs, max_len=s["seq_len"], dropout_rate=0.0, num_blocks=2, num_heads=1, item_feature=target, **kw)


def match_data(n, seed, clusters=None):
    """ML-1M-shaped rows: a user, a history of 1-20 movies post-padded to L20, the positive, 3 negatives (and one
    for the pair-wise model), SASRec's aligned next-item and negative sequences, YoutubeSBC's word2vec sample weight
    of the positive, and random 0/1 labels.  With ``clusters``, the history and the positive come from the user's
    group of movies (``user_id % clusters``), a signal to learn."""
    s, rng = ML1M, np.random.default_rng(seed)
    l, n_items = s["seq_len"], s["items"]
    users = rng.integers(1, s["users"] + 1, n)
    if clusters:
        size = n_items // clusters
        draw = lambda shape: 1 + (users % clusters).reshape(-1, *[1] * (len(shape) - 1)) * size + rng.integers(0, size, shape)  # noqa: E731
    else:
        draw = lambda shape: rng.integers(1, n_items + 1, shape)  # noqa: E731
    lengths = rng.integers(1, l + 1, n)
    valid = np.arange(l)[None, :] < lengths[:, None]
    hist = np.where(valid, draw((n, l)), 0).astype(np.int32)
    movie = draw((n,)).astype(np.int32)
    pos = np.where(valid, np.concatenate([hist[:, 1:], np.zeros((n, 1), np.int32)], axis=1), 0)
    pos[np.arange(n), lengths - 1] = movie
    negs = rng.integers(1, n_items + 1, (n, s["n_neg"])).astype(np.int32)
    weight = get_item_sample_weight(movie.tolist())
    x = {"user_id": users.astype(np.int32), "hist_movie_id": hist, "movie_id": movie, "neg_items": negs, "neg_item": negs[:, 0].copy(),
         "seq": hist, "pos": pos.astype(np.int32), "neg": np.where(valid, rng.integers(1, n_items + 1, (n, l)), 0).astype(np.int32),
         "sample_weight": np.array([weight[m] for m in movie.tolist()], np.float32)}
    return x, rng.integers(0, 2, n).astype(np.float32)


def match_labels(name, x, y):
    """The labels a configuration trains on: random 0/1 for the point-wise mode, the positive's id for the
    full-softmax session models, else column 0 (the positive)."""
    if MATCH_MODES.get(name, 2) == 0:
        return y
    return x["movie_id"].astype(np.int64) if name in MATCH_FULL_SOFTMAX else np.zeros(len(y), np.int64)


def match_trainer(name, model, device, **kw):
    return MatchTrainer(model, mode=MATCH_MODES.get(name.partition(":")[0], 2), in_batch_neg=name.endswith(":in_batch"), optimizer_params=CTR_OPT, device=device, **kw)


@contextlib.contextmanager
def given_routing_start(seed):
    """MIND's routing start drawn from a CPU generator seeded ``seed`` on every device and in every mode (the
    trainer's generators differ between the card and the CPU), so one step can be compared."""
    draw = layers.routing_start
    layers.routing_start = lambda shape, training, generator, device: torch.randn(shape, generator=torch.Generator().manual_seed(seed)).to(device)
    try:
        yield
    finally:
        layers.routing_start = draw


def dead_gate_biases(model):
    """The tower biases of a DSSMSENet whose SENet gate of one tower is closed for every input.  A gate over one
    or two fields is ``relu(w1 · relu(w0 · mean))`` with single weights and no bias: where ``w1`` is not positive
    it reads 0 for every row, that tower's MLP sees 0, its BatchNorms pass their bias 0 to ReLUs at 0, and the
    tower's embedding is 0; the score, a product of the two towers, is then 0 whatever the other tower does, so
    no bias of either tower takes a gradient (weight decay moves only the non-zero weights).  The same holds in
    the JAX package."""
    gates = [getattr(model, f"{tower}_senet", None) for tower in ("user", "item")]
    if not any(g is not None and not (g.Dense_1.weight > 0).any() for g in gates):
        return set()
    return {k for k, _ in model.named_parameters() if k.startswith(("user_mlp.", "item_mlp.")) and k.endswith(".bias")}


def match_against_cpu(name, b):
    """A fresh model from a seed with its tables redrawn at N(0, 0.3²), on the CPU and a copy on the card
    (``against_cpu``): the eval scores on ``b`` rows, then one step of a fresh MatchTrainer in the
    configuration's mode on a partial batch padded to ``b``."""
    cpu = match_model(name, seed=2, device="cpu")
    redraw_tables(cpu, seed=4, suffixes=MATCH_TABLES)
    x, y = match_data(b, seed=3)
    y = match_labels(name.partition(":")[0], x, y)

    def outputs(m, d):
        out = m({k: torch.from_numpy(v).to(d) for k, v in x.items()})
        return {"pos": out[0], "neg": out[1]} if isinstance(out, tuple) else {"scores": out}

    xs, ys = {k: v[: b - 16] for k, v in x.items()}, y[: b - 16]

    def train_step(m, d):
        with given_routing_start(seed=6):
            return match_trainer(name, m, d).train_one_epoch(ArrayLoader(xs, ys, batch_size=b), log_interval=0)

    result = against_cpu(name, cpu, outputs, train_step, b, atol_rel=MATCH_SCORE_ATOL_REL)
    if set(result[4]) - dead_gate_biases(cpu):
        raise AssertionError(f"{name}: {result[4]} kept their values in a step")
    return result


def match_config(name, all_users, all_items):
    """One configuration, its tables redrawn: MatchTrainer.train_one_epoch on DeviceCachedLoader (examples/s, ms
    per step, every parameter moved), a step's device time, host clock and launches, inference_embedding of every user and
    every movie, and the card against the CPU."""
    b, base = ML1M["batch"], name.partition(":")[0]
    model = match_model(name, seed=0, device=CARD)
    # tables at N(0, 0.3²): from the 1e-4 start DSSMSENet's SENet gates read ~1e-8 and its BatchNorms (eps 1e-5)
    # give every ReLU an input of 0, so no bias of its towers takes a gradient
    redraw_tables(model, seed=0, suffixes=MATCH_TABLES)
    n_params = sum(p.numel() for p in model.parameters())
    trainer = match_trainer(name, model, CARD)
    x, y = match_data(MATCH_STEPS * b, seed=1)
    loader = DeviceCachedLoader(x, match_labels(base, x, y), batch_size=b, group_size=MATCH_STEPS)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    trainer.train_one_epoch(loader, log_interval=0)  # warm-up
    seconds, losses = [], []
    for _ in range(MATCH_EPOCHS):
        t0 = time.perf_counter()
        losses.append(trainer.train_one_epoch(loader, log_interval=0))
        seconds.append(time.perf_counter() - t0)
    med = float(np.median(seconds))
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{name}: training loss not finite: {losses}")
    unmoved = [k for k, p in model.named_parameters() if torch.equal(p.detach(), before[k])]
    if set(unmoved) - dead_gate_biases(model):
        raise AssertionError(f"{name}: {sorted(set(unmoved) - dead_gate_biases(model))} did not move")

    xs, ys, ws = next(loader.device_groups())
    dx, dy, dw = {k: v[0] for k, v in xs.items()}, ys[0], ws[0]
    step = lambda: trainer.train_step(dx, dy, dw)  # noqa: E731
    wall = wall_ms(step, reps=10)
    kernels = profile_kernels(step, steps=3)
    device, launches = sum(ms for ms, _ in kernels.values()), sum(n for _, n in kernels.values())

    towers, embedder = model, trainer
    if base in MATCH_TOWERS:
        towers = match_model(name, seed=0, device=CARD, towers=True)
        towers.load_state_dict(model.state_dict())
        embedder = match_trainer(name, towers, CARD)
    t0 = time.perf_counter()
    user_emb = embedder.inference_embedding(towers, "user", ArrayLoader(all_users, batch_size=1024), None)
    item_emb = embedder.inference_embedding(towers, "item", ArrayLoader(all_items, batch_size=1024), None)
    embed_s = time.perf_counter() - t0
    n_users, n_items = len(all_users["user_id"]), len(all_items["movie_id"])
    if user_emb.shape[0] != n_users or item_emb.shape != (n_items, ML1M["dim"]) or not (np.isfinite(user_emb).all() and np.isfinite(item_emb).all()):
        raise AssertionError(f"{name}: inference_embedding gave users {user_emb.shape}, items {item_emb.shape}")

    worst, where, max_abs, step_losses, still, kinks = match_against_cpu(name, b)
    row = dict(name=name, params=n_params, ms_step=med / MATCH_STEPS * 1e3, ex_s=MATCH_STEPS * b / med, device_ms=device, host_ms=wall, idle=1 - device / wall, launches=launches, embed_ms=embed_s * 1e3)
    print(f"  {name} (mode {MATCH_MODES.get(base, 2)}{', in-batch negatives' if name.endswith(':in_batch') else ''}; {n_params:,} parameters): train {row['ex_s']:,.0f} examples/s, "
          f"{row['ms_step']:.3f} ms per step (host clock, median of {MATCH_EPOCHS} epochs of {MATCH_STEPS} steps of {b}), loss {losses[0]:.5f} -> {losses[-1]:.5f}; a step: device "
          f"{device:.4f} ms (torch.profiler kernels, 3 steps), host clock {wall:.4f} ms (median of 10), device idle {row['idle']:.0%}, {launches:.1f} launches; inference_embedding "
          f"of {n_users} users {tuple(user_emb.shape)} and {n_items} movies {tuple(item_emb.shape)}: {row['embed_ms']:.1f} ms")
    print(f"    card vs CPU, same weights, B{b}: eval scores max abs err {max_abs:.3e}, worst max |d|/tol: "
          + ", ".join(f"{k} {v:.3f}" + (f" ({where[k]})" if k in where else "") for k, v in worst.items())
          + f" (scores rtol {CTR_LOGIT_RTOL} atol {CTR_LOGIT_ATOL} + {MATCH_SCORE_ATOL_REL} x the largest; gradients rtol {CTR_GRAD_RTOL} atol {CTR_GRAD_ATOL_REL} x the model's largest; steps rtol {CTR_GRAD_RTOL} atol "
          f"{CTR_ADAM_UPDATE_TOL} x the largest step, beyond Adam's share); one step's loss {step_losses[0]:.7f} vs {step_losses[1]:.7f}; the CPU step took the card's ReLU branches, "
          f"{kinks[0]} of {kinks[1]:,} inputs on the other side of 0 there" + (f"; unmoved behind a closed SENet gate: {still}" if still else ""))
    if max(worst.values()) > 1.0:
        raise AssertionError(f"{name}: the card disagrees with the CPU: {worst}")
    return row


def match_fit_check(name):
    """fit on rows whose history and positive come from the user's group of movies, then match_evaluation on the
    card: exact top-10 of each test row's user embedding over every movie, recall@10 above ten times chance."""
    b, epochs = ML1M["batch"], MATCH_FIT["epochs"][name]
    floor = MATCH_FIT["chance_times"] * 10 / (ML1M["items"] + 1)
    x, _ = match_data(MATCH_FIT["rows"], seed=5, clusters=MATCH_FIT["clusters"])
    y = np.zeros(MATCH_FIT["rows"], np.int64)
    trainer = match_trainer(name, match_model(name, seed=5, device=CARD), CARD, n_epoch=epochs, model_path=MATCH_MODEL_PATH)
    t0 = time.perf_counter()
    trainer.fit(ArrayLoader(x, y, batch_size=b, shuffle=True), log_interval=0)
    fit_s = time.perf_counter() - t0
    test, _ = match_data(MATCH_FIT["test"], seed=6, clusters=MATCH_FIT["clusters"])
    all_items = {"movie_id": np.arange(ML1M["items"] + 1)}
    user_emb = trainer.inference_embedding(trainer.model, "user", ArrayLoader(test, batch_size=1024), MATCH_MODEL_PATH)
    item_emb = trainer.inference_embedding(trainer.model, "item", ArrayLoader(all_items, batch_size=1024), MATCH_MODEL_PATH)
    t0 = time.perf_counter()
    out = match_evaluation(user_emb, item_emb, {"user_id": np.arange(MATCH_FIT["test"]), "movie_id": test["movie_id"]}, all_items, item_col="movie_id", topk=10, device=CARD)
    recall = float(out["Recall"][0].split(": ")[1])
    print(f"  {name} fit, {epochs} epochs of {MATCH_FIT['rows']} rows ({fit_s:.2f} s); match_evaluation on the card ({(time.perf_counter() - t0) * 1e3:.1f} ms) of "
          f"{MATCH_FIT['test']} test rows over {ML1M['items'] + 1} movies: recall@10 {recall:.4f} (chance {10 / (ML1M['items'] + 1):.4f}; " + ", ".join(v[0] for v in out.values()) + ")")
    if not recall > floor:
        raise AssertionError(f"{name}: fit reached a recall@10 of {recall}, not above {floor:.4f}")


def matching_phase():
    t0 = time.perf_counter()
    all_users, _ = match_data(ML1M["users"], seed=8)
    all_users["user_id"] = np.arange(1, ML1M["users"] + 1, dtype=np.int32)  # every user once
    all_users = {k: v for k, v in all_users.items() if not k.startswith("neg")}
    all_items = {"movie_id": np.arange(ML1M["items"] + 1, dtype=np.int32)}
    rows = [match_config(name, all_users, all_items) for name in MATCH_CONFIGS]
    print(f"  summary (ms per step / examples/s host clock; device ms, host ms, idle and launches of one step; inference_embedding ms of {ML1M['users']} users and {ML1M['items'] + 1} movies):")
    for r in rows:
        print(f"    {r['name']:14s} {r['ms_step']:8.3f} ms {r['ex_s']:11,.0f} ex/s | device {r['device_ms']:7.4f} host {r['host_ms']:8.4f} idle {r['idle']:4.0%} launches {r['launches']:7.1f} | embed {r['embed_ms']:7.1f} ms")
    for name in ("YoutubeDNN", "MIND"):
        match_fit_check(name)
    print(f"  matching phase: {time.perf_counter() - t0:.1f} s")
    return rows


def prod_model(device):
    """YoutubeDNN at the production geometry, random weights from a seed: under "auto" the 8M-row item table
    fuses (and takes the row-wise update), the 200,000-row user table stays a per-feature table under Adam."""
    p, d = PROD, PROD["dim"]
    user = SparseFeature("user_id", p["users"], d)
    hist = SequenceFeature("hist_item_id", p["items"], d, pooling="mean", shared_with="item_id")
    item = (SparseFeature("item_id", p["items"], d),)
    neg = (SequenceFeature("neg_items", p["items"], d, pooling="concat", shared_with="item_id"),)
    return matching.YoutubeDNN((user, hist), item, neg, {"dims": (64, d)}, generator=torch.Generator().manual_seed(10), device=device)


def prod_data(n, seed):
    """Users uniform, 20-item histories and positives zipf(1.2) over the 8M items."""
    p, rng = PROD, np.random.default_rng(seed)
    return {"user_id": rng.integers(0, p["users"], n).astype(np.int32), "hist_item_id": (rng.zipf(1.2, (n, p["seq_len"])) % p["items"]).astype(np.int32),
            "item_id": (rng.zipf(1.2, n) % p["items"]).astype(np.int32)}


def retrieval_phase(item_emb, user_emb, cycles_per_ms):
    """Exact top-k of SERVE_TOPK["users"] users over every item through brute_force_topk, a user batch bounding the
    (U, N) score matrix; a batch's product and top-k timed apart beside their bounds; 256 users against the CPU."""
    k, ub = SERVE_TOPK["k"], SERVE_TOPK["user_batch"]
    items = torch.from_numpy(item_emb).to(CARD)
    users = torch.from_numpy(user_emb).to(CARD)
    n, d, u = items.shape[0], items.shape[1], users.shape[0]
    brute_force_topk(users[:ub], items, k, batch_size=ub, device=CARD)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids, scores = brute_force_topk(users, items, k, batch_size=ub, device=CARD)
    total = time.perf_counter() - t0
    batch = users[:ub]
    dev_ms, wall = timed(lambda: topk_scores(batch, items, k), cycles_per_ms, reps=10)
    prod_ms, _ = timed(lambda: batch @ items.T, cycles_per_ms, reps=10)
    score = batch @ items.T
    topk_ms, _ = timed(lambda: torch.topk(score, k, dim=1), cycles_per_ms, reps=10)
    del score
    flop_ms = 2 * ub * n * d / PEAK_FP32_FLOPS * 1e3
    corpus_ms = n * d * 4 / PEAK_HBM_BYTES * 1e3
    score_ms = 2 * ub * n * 4 / PEAK_HBM_BYTES * 1e3  # written by the product, read by the top-k
    batches = -(-u // ub)
    print(f"  exact top-{k} of {u} users over {n:,} items, {ub} users a batch ({ub * n * 4 / 1e9:.2f} GB of scores): {total * 1e3:.1f} ms in all (host clock, ids and scores "
          f"back on the host), {total / batches * 1e3:.3f} ms per user batch, {u / total:,.0f} users/s")
    print(f"    one user batch (timed, median of 10): product + top-k device {dev_ms:.3f} ms (host clock {wall:.3f} ms); the product alone {prod_ms:.3f} ms, the top-k alone "
          f"{topk_ms:.3f} ms; bounds: operations 2·U·N·D = {2 * ub * n * d / 1e9:.1f} GFLOP at {PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s (fp32, TF32 off) {flop_ms:.3f} ms; bytes: the corpus "
          f"once {corpus_ms:.3f} ms + the score matrix written and read {score_ms:.3f} ms = {corpus_ms + score_ms:.3f} ms (a fused product and top-k: {corpus_ms:.3f} ms); bound "
          f"{max(flop_ms, corpus_ms + score_ms):.3f} ms by {'operations' if flop_ms > corpus_ms + score_ms else 'bytes'}; all {batches} batches: {batches * dev_ms:.1f} ms of device time "
          f"against a bound of {batches * max(flop_ms, corpus_ms + score_ms):.1f} ms")
    m = SERVE_TOPK["check_users"]
    t0 = time.perf_counter()
    ref_ids, ref_scores = brute_force_topk(user_emb[:m], item_emb, k, batch_size=SERVE_TOPK["check_batch"], device="cpu")
    cpu_s = time.perf_counter() - t0
    err = float(np.abs(scores[:m] - ref_scores).max())
    distinct = np.all(np.diff(ref_scores, axis=1) < -1e-5, axis=1)
    same = bool(np.array_equal(ids[:m][distinct], ref_ids[distinct]))
    print(f"    {m} users against the CPU's top-{k} ({cpu_s:.1f} s there): scores max abs err {err:.3e} (atol 1e-5); ids equal on the {int(distinct.sum())} users whose "
          f"scores are distinct by more than 1e-5: {same}")
    if err > 1e-5 or not same:
        raise AssertionError("the card's top-k disagrees with the CPU's")
    del items, users


def prod_phase(cycles_per_ms):
    """YoutubeDNN at the production geometry with in-batch negatives and sparse_embedding="adagrad" on
    DeviceCachedLoader: the first step's rows, examples/s, a step's stages, host synchronisations, memory; the item
    tower's inference_embedding over every item; exact top-10 retrieval; one dense-Adam step beside it."""
    t0 = time.perf_counter()
    p, b = PROD, PROD["batch"]
    model = prod_model(CARD)
    trainer = MatchTrainer(model, mode=2, in_batch_neg=True, optimizer_params=CTR_OPT, sparse_embedding="adagrad")
    (name,) = trainer.sparse_tables
    table, accum = trainer.sparse_tables[name], trainer.sparse_accums[name]
    user_table = model.embedding.user_id_table
    print(f"  model built in {time.perf_counter() - t0:.1f} s: the sparse table {name} {tuple(table.shape)} ({table.numel() * 4 / 1e9:.2f} GB); "
          f"the user table {tuple(user_table.shape)} under Adam (below \"auto\"'s fuse threshold)")
    rows = ((p["items"] // 64 + 1) * 64, p["users"] if p["users"] < 65536 else -(-p["users"] // 64) * 64)  # ops/embedding.py's padding
    if name != "embedding.fused_d64_table" or tuple(table.shape) != (rows[0], 64) or tuple(user_table.shape) != (rows[1], 64):
        raise AssertionError(f"the production tables are {name} {tuple(table.shape)} and {tuple(user_table.shape)}")
    x = prod_data(p["steps"] * b, seed=11)
    loader = DeviceCachedLoader(x, None, batch_size=b, group_size=p["steps"])
    xs, _, ws = next(loader.device_groups())
    dx, dw = {k: v[0] for k, v in xs.items()}, ws[0]

    ids = torch.cat([dx["hist_item_id"].reshape(-1), dx["item_id"]]).to(torch.int64)
    touched = torch.zeros(table.shape[0], dtype=torch.bool, device=CARD)
    touched[ids] = True
    before = table.detach().clone()
    trainer.train_step(dx, None, dw)
    check_sparse_tables_left_out(trainer)
    moved = (table.detach() != before).any(dim=1)
    n_touched, n_moved, stray = int(touched.sum()), int(moved[touched].sum()), int((moved & ~touched).sum())
    stray_accum, zero_accum = int(((accum != 0) & ~touched).sum()), int((accum[touched] == 0).sum())
    print(f"  first step: {ids.numel()} item ids, {n_touched} distinct rows; {n_moved} of them moved, {table.shape[0] - n_touched:,} untouched rows of which {stray} changed, "
          f"{stray_accum} other accumulators non-zero, {zero_accum} touched accumulators zero; {name}.grad is None")
    if stray or stray_accum or n_moved != n_touched or zero_accum:
        raise AssertionError("the sparse step changed rows outside the batch, or left a touched row unchanged")
    del before, touched, moved

    trainer.train_one_epoch(loader, log_interval=0)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seconds, losses = [], []
    for _ in range(p["epochs"]):
        t1 = time.perf_counter()
        losses.append(trainer.train_one_epoch(loader, log_interval=0))
        seconds.append(time.perf_counter() - t1)
    peak = torch.cuda.max_memory_allocated() / 1e9
    med = float(np.median(seconds))
    print(f"  sparse adagrad, in-batch negatives ({b - 1} a row), DeviceCachedLoader: {p['steps'] * b / med:,.0f} examples/s, {med / p['steps'] * 1e3:.3f} ms per step (host clock, "
          f"median of {p['epochs']} epochs of {p['steps']} steps of {b}); train loss {losses[0]:.5f} -> {losses[-1]:.5f}; peak allocated {peak:.3f} GB over the timed epochs")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"production training loss not finite: {losses}")

    model.train()

    def forward():
        trainer.optimizer.zero_grad(set_to_none=True)
        with record_rows(trainer.sparse_tables) as rec:
            loss = trainer.loss_fn(dx, None, dw)
        return loss, rec

    def backward():
        loss, rec = forward()
        loss.backward()
        return rec

    def adam():
        rec = backward()
        trainer.optimizer.step()
        return rec

    stages = {
        "forward": ("the forward and loss, the recorder open (user and item towers, the (B, B) scores, the sampler's sort, CE)", forward),
        "backward": ("+ backward (the user table's dense gradient; the recorded rows' gradients)", backward),
        "adam": ("+ Adam over the rest (the user table and the MLP)", adam),
        "step": ("train_step (+ the row-wise Adagrad update of the item table)", lambda: trainer.train_step(dx, None, dw)),
    }
    walls = {key: wall_ms(fn, reps=10) for key, (_, fn) in stages.items()}
    t = {}
    for key, (stage, fn) in stages.items():
        t[key] = sum(ms for ms, _ in profile_kernels(fn, steps=3).values())
        print(f"  stage {stage}: device {t[key]:.4f} ms (kernels, torch.profiler, 3 calls), host clock {walls[key]:.4f} ms (median of 10), device idle {1 - t[key] / walls[key]:.0%}")
    print(f"  by difference (device ms): forward {t['forward']:.4f}, backward {t['backward'] - t['forward']:.4f}, Adam over the rest {t['adam'] - t['backward']:.4f}, "
          f"row-wise update {t['step'] - t['adam']:.4f}")
    print(f"  sparse step: {sync_text(count_syncs(lambda: trainer.train_step(dx, None, dw)))}")
    kernel_breakdown(f"YoutubeDNN production sparse B{b}", lambda: trainer.train_step(dx, None, dw), steps=3, classify=ctr_kernel_class, top=6)

    t1 = time.perf_counter()
    item_emb = trainer.inference_embedding(model, "item", ArrayLoader({"item_id": np.arange(p["items"], dtype=np.int32)}, batch_size=65536), None)
    item_s = time.perf_counter() - t1
    serve = prod_data(SERVE_TOPK["users"], seed=12)
    user_emb = trainer.inference_embedding(model, "user", ArrayLoader({k: serve[k] for k in ("user_id", "hist_item_id")}, batch_size=b), None)
    norms = np.linalg.norm(item_emb, axis=1)
    print(f"  item tower inference_embedding over all {p['items']:,} items: {item_s:.2f} s ({p['items'] / item_s:,.0f} items/s, batches of 65,536, the (N, 64) result back on the host); "
          f"norms {norms.min():.6f}-{norms.max():.6f}")
    if item_emb.shape != (p["items"], p["dim"]) or not np.isfinite(item_emb).all() or np.abs(norms - 1).max() > 1e-5:
        raise AssertionError("the item tower's embeddings are not unit vectors of the expected shape")
    retrieval_phase(item_emb, user_emb, cycles_per_ms)
    del item_emb, user_emb

    dense = MatchTrainer(model, mode=2, in_batch_neg=True, optimizer_params=CTR_OPT)
    dense.train_step(dx, None, dw)  # warm-up: Adam's moments over every table
    wall = wall_ms(lambda: dense.train_step(dx, None, dw), reps=10)
    device = sum(ms for ms, _ in profile_kernels(lambda: dense.train_step(dx, None, dw), steps=3).values())
    _, _, states = optimizer_tensors(dense.optimizer)
    print(f"  dense Adam step, the same geometry and batch: device {device:.4f} ms (kernels, torch.profiler, 3 calls), host clock {wall:.4f} ms (median of 10), "
          f"device idle {1 - device / wall:.0%}; Adam state {sum(s.numel() * s.element_size() for s in states) / 1e9:.2f} GB; peak allocated {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    del dense, trainer, model, loader
    print(f"  production phase: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# 11. multi-task through MTLTrainer
# ---------------------------------------------------------------------------

# Ali-CCP's schema, read from the committed sample (benchmarks/data/ali_ccp/ali_ccp_sample.csv, 200 rows): 23 sparse
# fields at d16 (build_aliccp_multitask_dataset's embed_dim) and the 8 D* dense fields; each vocabulary the
# sample's largest id + 1, as benchmarks/datasets.py:230-258 (_aliccp_frame) computes it
ALICCP_CSV = os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchmarks", "data", "ali_ccp", "ali_ccp_sample.csv")
ALICCP_DENSE = ("D109_14", "D110_14", "D127_14", "D150_14", "D508", "D509", "D702", "D853")
MTL = dict(dim=16, batch=4096, steps=8, epochs=3)
MTL_TASKS = ("classification", "classification")  # [cvr, ctr], the reference's task order
# the repo's multi-task defaults (benchmarks/models.py:56-70): bottoms and experts of 64, towers of 32; MMOE 4 experts;
# PLE one level of 2 specific experts a task and 1 shared; ESMM's two towers of 32
MTL_CONFIGS = ("SharedBottom", "ESMM", "MMOE", "PLE", "AITM")
MTL_ADAPTIVE = ("uwl", "gradnorm", "metabalance")
MTL_FIT = dict(rows=20_000, batch=256, epochs=2, auc=0.6)
MTL_MODEL_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_mtl")


def aliccp_schema():
    """``(sparse columns, dense columns, {column: vocabulary})`` of the Ali-CCP sample, read with the csv module."""
    with open(ALICCP_CSV, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    dense = [c for c in header if c in ALICCP_DENSE]
    sparse = [c for c in header if c not in dense and c not in ("click", "purchase")]
    vocab = {c: max(int(r[header.index(c)]) for r in body) + 1 for c in sparse}
    return sparse, dense, vocab


def mtl_features():
    sparse, dense, vocab = aliccp_schema()
    return tuple(SparseFeature(c, vocab_size=vocab[c], embed_dim=MTL["dim"]) for c in sparse), tuple(DenseFeature(c) for c in dense)


def mtl_model(name, seed, device, fused=False):
    """One of the five classes at the repo's multi-task widths over Ali-CCP's schema, random weights from a seed
    (``fused``: every table in one fused parameter).  ESMM takes the features split in half as
    benchmarks/models.py splits them (its towers read the sparse ones)."""
    sparse, dense = mtl_features()
    feats = sparse + dense
    towers = ({"dims": (32,)}, {"dims": (32,)})
    kw = dict(generator=torch.Generator().manual_seed(seed), device=device)
    old = set_fused_default(True) if fused else None
    try:
        if name == "SharedBottom":
            return multi_task.SharedBottom(features=feats, task_types=MTL_TASKS, bottom_params={"dims": (64,)}, tower_params_list=towers, **kw)
        if name == "MMOE":
            return multi_task.MMOE(features=feats, task_types=MTL_TASKS, n_expert=4, expert_params={"dims": (64,)}, tower_params_list=towers, **kw)
        if name == "PLE":
            return multi_task.PLE(features=feats, task_types=MTL_TASKS, n_level=1, n_expert_specific=2, n_expert_shared=1, expert_params={"dims": (64,)}, tower_params_list=towers, **kw)
        if name == "AITM":
            return multi_task.AITM(features=feats, n_task=2, bottom_params={"dims": (64,)}, tower_params_list=towers, **kw)
        half = len(feats) // 2
        return multi_task.ESMM(user_features=feats[:half], item_features=feats[half:], cvr_params={"dims": (32,)}, ctr_params={"dims": (32,)}, **kw)
    finally:
        if fused:
            set_fused_default(old)


def mtl_data(n, seed, esmm=False):
    """Seeded rows of Ali-CCP's schema: uniform ids below each vocabulary, normal dense values, and the labels of
    _aliccp_frame's synthetic rule (benchmarks/datasets.py:252-255): a click from field 101 and D508, then a
    purchase given the click from the next sparse field of the sample's header (121, where the synthetic schema
    has 102) and D509.  ``[cvr, ctr]``; ESMM ``[cvr, ctr, ctcvr]`` (examples/ranking/mtl_common.py:36-39)."""
    sparse, dense, vocab = aliccp_schema()
    rng = np.random.default_rng(seed)
    x = {c: rng.integers(0, vocab[c], n).astype(np.int32) for c in sparse}
    x.update({c: rng.normal(size=n).astype(np.float32) for c in dense})
    l_click = (x["101"] % 3 == 0) * 1.4 + x["D508"] * 0.5 - 0.6
    click = (rng.random(n) < 1 / (1 + np.exp(-l_click))).astype(np.float32)
    l_buy = (x[sparse[1]] % 2) * 1.1 + x["D509"] * 0.4 - 1.2
    purchase = (click * (rng.random(n) < 1 / (1 + np.exp(-l_buy)))).astype(np.float32)
    ys = np.stack([purchase, click], axis=1)
    return x, (np.concatenate([ys, ys[:, :1] * ys[:, 1:2]], axis=1) if esmm else ys)


def mtl_tasks(name):
    return ("classification",) * 3 if name == "ESMM" else MTL_TASKS


def mtl_against_cpu(name, b, adaptive=None):
    """A fresh model from a seed with its tables redrawn, on the CPU and a copy on the card (``against_cpu``): the
    eval probabilities on ``b`` rows, then one step of a fresh MTLTrainer (``adaptive``) on a partial batch
    padded to ``b``: the task losses, gradients, every parameter's step, the BatchNorm statistics (one update
    under every method); the loss weights and MetaBalance's norms.  Returns ``(against_cpu's result,
    {"card": trainer, "cpu": trainer})``."""
    cpu = mtl_model(name, seed=2, device="cpu")
    redraw_tables(cpu, seed=4)
    x, ys = mtl_data(b, seed=3, esmm=name == "ESMM")
    xs, yss = {k: v[: b - 96] for k, v in x.items()}, ys[: b - 96]
    trainers, task_losses = {}, {}

    def outputs(m, d):
        return {"probabilities": m({k: torch.from_numpy(v).to(d) for k, v in x.items()})}

    def train_step(m, d):  # against_cpu steps the card's copy first
        key = ("card", "cpu")[len(trainers)]
        trainers[key] = MTLTrainer(m, mtl_tasks(name), optimizer_params=CTR_OPT, adaptive_params={"method": adaptive} if adaptive else None, device=d)
        task_losses[key] = trainers[key].train_one_epoch(ArrayLoader(xs, yss, batch_size=b), log_interval=0)
        return float(np.sum(task_losses[key]))

    result = against_cpu(name + (f" ({adaptive})" if adaptive else ""), cpu, outputs, train_step, b)
    np.testing.assert_allclose(task_losses["card"], task_losses["cpu"], rtol=CTR_LOSS_RTOL, atol=CTR_LOSS_ATOL)
    if result[4]:
        raise AssertionError(f"{name}: {result[4]} kept their values in a step")
    card, ref = trainers["card"], trainers["cpu"]
    if adaptive in ("uwl", "gradnorm"):
        np.testing.assert_allclose(card.loss_weight.detach().cpu().numpy(), ref.loss_weight.detach().numpy(), rtol=0, atol=1e-6)
    if adaptive == "metabalance":
        largest = max(float(v.max()) for v in ref.mb_norms.values())
        for key, v in ref.mb_norms.items():
            np.testing.assert_allclose(card.mb_norms[key].cpu().numpy(), v.numpy(), rtol=2 * CTR_GRAD_RTOL, atol=CTR_GRAD_ATOL_REL * largest, err_msg=key)
    return result, trainers


def mtl_config(name):
    """One class: MTLTrainer.train_one_epoch on DeviceCachedLoader (examples/s, ms per step, every parameter moved), a
    step's device time, host clock, idle share and launches, predict, and the card against the CPU."""
    b = MTL["batch"]
    model = mtl_model(name, seed=0, device=CARD)
    n_params = sum(p.numel() for p in model.parameters())
    trainer = MTLTrainer(model, mtl_tasks(name), optimizer_params=CTR_OPT)
    x, ys = mtl_data(MTL["steps"] * b, seed=1, esmm=name == "ESMM")
    loader = DeviceCachedLoader(x, ys, batch_size=b, group_size=MTL["steps"])
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    trainer.train_one_epoch(loader, log_interval=0)  # warm-up
    seconds, losses = [], []
    for _ in range(MTL["epochs"]):
        t0 = time.perf_counter()
        losses.append(trainer.train_one_epoch(loader, log_interval=0))  # ends in a host read of the losses
        seconds.append(time.perf_counter() - t0)
    med = float(np.median(seconds))
    if not np.isfinite(losses).all():
        raise AssertionError(f"{name}: training loss not finite: {losses}")
    unmoved = [k for k, p in model.named_parameters() if torch.equal(p.detach(), before[k])]
    if unmoved:
        raise AssertionError(f"{name}: {unmoved} did not move")
    xs, yss, ws = next(loader.device_groups())
    dx, dy, dw = {k: v[0] for k, v in xs.items()}, yss[0], ws[0]
    step = lambda: trainer.train_step(dx, dy, dw)  # noqa: E731
    wall = wall_ms(step, reps=10)
    kernels = profile_kernels(step, steps=3)
    device, launches = sum(ms for ms, _ in kernels.values()), sum(n for _, n in kernels.values())
    predict_loader = ArrayLoader(x, ys, batch_size=b)
    trainer.predict(model, predict_loader)  # warm-up
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        preds = trainer.predict(model, predict_loader)
        walls.append(time.perf_counter() - t0)
    pred_s = float(np.median(walls))
    if preds.shape != (MTL["steps"] * b, len(mtl_tasks(name))) or not (np.isfinite(preds).all() and ((preds >= 0) & (preds <= 1)).all()):
        raise AssertionError(f"{name}: predict gave {preds.shape}, or probabilities out of [0, 1]")
    (worst, where, max_abs, step_losses, _, kinks), _ = mtl_against_cpu(name, b)
    row = dict(name=name, params=n_params, ms_step=med / MTL["steps"] * 1e3, ex_s=MTL["steps"] * b / med, device_ms=device, host_ms=wall, idle=1 - device / wall,
               launches=launches, predict_ms=pred_s / MTL["steps"] * 1e3, worst=worst)
    print(f"  {name} ({n_params:,} parameters): train {row['ex_s']:,.0f} examples/s, {row['ms_step']:.3f} ms per step (host clock, median of {MTL['epochs']} epochs of "
          f"{MTL['steps']} steps of {b}), task losses {np.round(losses[0], 5).tolist()} -> {np.round(losses[-1], 5).tolist()}; a step: device {device:.4f} ms (torch.profiler kernels, 3 steps), "
          f"host clock {wall:.4f} ms (median of 10), device idle {row['idle']:.0%}, {launches:.1f} launches; predict {row['predict_ms']:.3f} ms per batch")
    print(f"    card vs CPU, same weights, B{b}: eval probabilities max abs err {max_abs:.3e}, worst max |d|/tol: " + ", ".join(f"{k} {v:.3f}" + (f" ({where[k]})" if k in where else "") for k, v in worst.items())
          + f" (probabilities rtol {CTR_LOGIT_RTOL} atol {CTR_LOGIT_ATOL}; gradients rtol {CTR_GRAD_RTOL} atol {CTR_GRAD_ATOL_REL} x the model's largest; steps rtol {CTR_GRAD_RTOL} atol {CTR_ADAM_UPDATE_TOL} x"
          f" the largest step, beyond Adam's share); one step's summed task losses {step_losses[0]:.7f} vs {step_losses[1]:.7f}; the CPU step took the card's ReLU branches, {kinks[0]} of {kinks[1]:,} inputs on the other side of 0 there")
    if max(worst.values()) > 1.0:
        raise AssertionError(f"{name}: the card disagrees with the CPU: {worst}")
    return row


def mtl_adaptive_check(method):
    """MMOE under UWL, GradNorm or MetaBalance: one step card against CPU, the loss weights and norms."""
    (worst, where, _, step_losses, _, _), trainers = mtl_against_cpu("MMOE", MTL["batch"], adaptive=method)
    card = trainers["card"]
    if method in ("uwl", "gradnorm"):
        lw = card.loss_weight.detach().cpu().numpy()
        extra = f"loss weights {lw.tolist()} (CPU {trainers['cpu'].loss_weight.detach().numpy().tolist()}, atol 1e-6)"
        if method == "gradnorm":
            leaf = dict(card.model.named_parameters())[card.gradnorm_leaf]
            extra += f", summing to {float(lw.sum()):.7f}; GradNorm's leaf {card.gradnorm_leaf}, flax {mtl_utils.flax_keystr(card.gradnorm_leaf, leaf.ndim)}"
            if abs(float(lw.sum()) - 2.0) > 1e-5:
                raise AssertionError(f"GradNorm's weights sum to {lw.sum()}, not 2")
    else:
        norms = {k: v.cpu() for k, v in card.mb_norms.items()}
        extra = f"MetaBalance's norms of {len(norms)} parameters, largest {max(float(v.max()) for v in norms.values()):.4e}, against the CPU's (rtol {2 * CTR_GRAD_RTOL}, atol {CTR_GRAD_ATOL_REL} x the largest)"
    print(f"  MMOE {method}: one step card vs CPU, worst max |d|/tol: " + ", ".join(f"{k} {v:.3f}" + (f" ({where[k]})" if k in where else "") for k, v in worst.items())
          + f"; summed task losses {step_losses[0]:.7f} vs {step_losses[1]:.7f}; {extra}")
    if max(worst.values()) > 1.0:
        raise AssertionError(f"MMOE {method}: the card disagrees with the CPU: {worst}")


def mtl_sparse_check():
    """MMOE under UWL with every table fused and sparse_embedding="adagrad": one step card against CPU from the same
    weights (the task losses and loss weights; the table's step against a dense-gradient reference, the row-wise
    Adagrad step of the CPU's dense table gradient of the same loss), 0 host synchronisations a step."""
    b, lr = MTL["batch"], CTR_OPT["lr"]
    card = mtl_model("MMOE", seed=7, device=CARD, fused=True)
    cpu = mtl_model("MMOE", seed=7, device="cpu", fused=True)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    dense_ref = copy.deepcopy(cpu)
    x, ys = mtl_data(b - 96, seed=8)
    trainers = [MTLTrainer(m, MTL_TASKS, optimizer_params=CTR_OPT, adaptive_params={"method": "uwl"}, sparse_embedding="adagrad", device=d) for m, d in ((card, CARD), (cpu, "cpu"))]
    (name,) = trainers[0].sparse_tables
    t0 = trainers[1].sparse_tables[name].detach().clone()
    losses = [t.train_one_epoch(ArrayLoader(x, ys, batch_size=b), log_interval=0) for t in trainers]
    np.testing.assert_allclose(losses[0], losses[1], rtol=CTR_LOSS_RTOL, atol=CTR_LOSS_ATOL)
    check_sparse_tables_left_out(trainers[0])
    lw = [t.loss_weight.detach().cpu().numpy().copy() for t in trainers]
    np.testing.assert_allclose(lw[0], lw[1], rtol=0, atol=1e-6)
    # the reference: the dense table gradient of the same loss on the CPU, deduplicated into the row-wise Adagrad update
    ref_trainer = MTLTrainer(dense_ref, MTL_TASKS, optimizer_params=CTR_OPT, adaptive_params={"method": "uwl"}, device="cpu")
    dense_ref.train()
    xp, yp, wp = pad_batch(x, ys, b)
    dx, dy, dw = ref_trainer._to_device(xp, yp.astype(np.float32), wp)
    mtl_trainer._aggregate_losses(ref_trainer.task_losses(dense_ref(dx), dy, dw), ref_trainer.loss_weight, "uwl", False).backward()
    table_grad = dict(dense_ref.named_parameters())[name].grad
    rows = torch.nonzero(table_grad.abs().amax(1) > 0).reshape(-1)
    ref_table = t0.clone()
    rowwise_adagrad_update(ref_table, torch.zeros(t0.shape[0]), rows, table_grad[rows], lr)
    table_card = trainers[0].sparse_tables[name].detach().cpu()
    # a row whose exact gradient is 0 (field 126's one id: a constant input, which the BatchNorm after the first
    # Dense takes out) holds rounding noise, and Adagrad scales any nonzero row to a step of about lr: such a row
    # is held only to Adagrad's largest step, lr sqrt(D), on both sides
    noise = table_grad.abs().amax(1) < b * torch.finfo(torch.float32).eps * float(table_grad.abs().max())
    for t in (table_card, ref_table):
        if float((t - t0).abs().amax(1)[noise].max()) > lr * math.sqrt(t0.shape[1]) * (1 + 1e-5):
            raise AssertionError("a sparse table row with a zero gradient took more than Adagrad's largest step")
    r, moved = step_ratio(table_card[~noise], t0[~noise], ref_table[~noise].double() - t0[~noise].double(), CTR_STEP_RTOL["adagrad"], CTR_GRAD_ATOL_REL)
    gx, gy, gw = next(DeviceCachedLoader(x, ys, batch_size=b, group_size=1).device_groups())
    syncs = count_syncs(lambda: trainers[0].train_step({k: v[0] for k, v in gx.items()}, gy[0], gw[0]), steps=2)
    print(f"  MMOE, UWL, every table fused {tuple(table_card.shape)}, sparse_embedding=\"adagrad\": one step card vs CPU, task losses {np.round(losses[0], 7).tolist()} vs {np.round(losses[1], 7).tolist()}, "
          f"loss weights {lw[0].tolist()}; the table's step against the row-wise Adagrad step of the CPU's dense table gradient ({len(rows)} rows; {int(noise[rows].sum())} with an exact gradient of 0, held to lr sqrt(D)): max |d|/tol {r:.3f} (largest step {moved:.3e}; "
          f"rtol {CTR_STEP_RTOL['adagrad']}, atol {CTR_GRAD_ATOL_REL} x the largest step); a train_step: {sync_text(syncs)}")
    if r > 1.0:
        raise AssertionError(f"the sparse MTL step's table disagrees with the dense-gradient reference: {r}")
    if syncs[0]:
        raise AssertionError(f"a sparse MTL step synchronised with the host {syncs[0]} times")


def mtl_fit_check(name):
    """fit on the learnable rows for MTL_FIT epochs at B256 (early stopping on the click task), then the test AUC of
    the click task above MTL_FIT["auc"]."""
    x, ys = mtl_data(MTL_FIT["rows"], seed=5)
    n_train, n_val = int(0.8 * MTL_FIT["rows"]), int(0.9 * MTL_FIT["rows"])

    def part(lo, hi):
        return {k: v[lo:hi] for k, v in x.items()}, ys[lo:hi]

    b = MTL_FIT["batch"]
    trainer = MTLTrainer(mtl_model(name, seed=5, device=CARD), MTL_TASKS, optimizer_params=CTR_OPT, n_epoch=MTL_FIT["epochs"], earlystop_taskid=1, model_path=MTL_MODEL_PATH)
    t0 = time.perf_counter()
    log = trainer.fit(ArrayLoader(*part(0, n_train), batch_size=b, shuffle=True), ArrayLoader(*part(n_train, n_val), batch_size=b))
    fit_s = time.perf_counter() - t0
    scores = trainer.evaluate(trainer.model, ArrayLoader(*part(n_val, MTL_FIT["rows"]), batch_size=b))
    print(f"  {name} fit, {MTL_FIT['epochs']} epochs of {n_train} rows at B{b} ({fit_s:.2f} s with validation; validation AUCs [cvr, ctr] {[np.round(s, 5).tolist() for s in log]}): "
          f"test AUC cvr {scores[0]:.5f}, ctr {scores[1]:.5f}")
    if not scores[1] > MTL_FIT["auc"]:
        raise AssertionError(f"{name}: fit reached a click AUC of {scores[1]}, not above {MTL_FIT['auc']}")


def mtl_phase():
    t0 = time.perf_counter()
    sparse, dense = mtl_features()
    print(f"  Ali-CCP schema of {os.path.relpath(ALICCP_CSV, os.path.dirname(os.path.abspath(__file__)))}: {len(sparse)} sparse fields at d{MTL['dim']} "
          f"(vocabularies of {sum(f.vocab_size for f in sparse)} rows in all, the largest {max(f.vocab_size for f in sparse)}), {len(dense)} dense fields")
    rows = [mtl_config(name) for name in MTL_CONFIGS]
    print(f"  summary (ms per step / examples/s host clock; device ms, host ms, idle and launches of one step; predict ms per batch of {MTL['batch']}):")
    for r in rows:
        print(f"    {r['name']:12s} {r['ms_step']:8.3f} ms {r['ex_s']:11,.0f} ex/s | device {r['device_ms']:7.4f} host {r['host_ms']:8.4f} idle {r['idle']:4.0%} launches {r['launches']:7.1f} | predict {r['predict_ms']:7.3f} ms")
    for method in MTL_ADAPTIVE:
        mtl_adaptive_check(method)
    mtl_sparse_check()
    for name in ("MMOE", "PLE"):
        mtl_fit_check(name)
    print(f"  multi-task phase: {time.perf_counter() - t0:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# 12. RQ-VAE through RQVAETrainer
# ---------------------------------------------------------------------------

# the JAX package's defaults (models/generative/rqvae.py:111-123): in_dim 768, three codebooks of 256, e_dim 64, layers
# (512, 256, 128); Sinkhorn at 0.003 on the last stage, no k-means init (numpy k-means on 8,192 x 256 clusters is host
# work, covered by the CPU tests); 12,101 items, the Amazon-Beauty item count TIGER trains RQ-VAE on, as seeded
# Gaussian clusters in 768-d (the repo holds no item text embeddings); B1024, fit's default
RQ = dict(items=12_101, clusters=1_000, in_dim=768, batch=1024, epochs=3, sk_epsilons=(0.0, 0.0, 0.003))
RQ_MODEL_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_rqvae")


def rq_model(seed, device):
    return RQVAEModel(in_dim=RQ["in_dim"], sk_epsilons=RQ["sk_epsilons"], generator=torch.Generator().manual_seed(seed), device=device)


def rq_data(seed):
    """``(items (12,101, 768) fp32, each item's cluster)``."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(RQ["clusters"], RQ["in_dim"]))
    cluster = rng.integers(0, RQ["clusters"], RQ["items"])
    return (centers[cluster] + rng.normal(size=(RQ["items"], RQ["in_dim"])) * 0.3).astype(np.float32), cluster


def rq_codes_against_cpu(card_model, data):
    """The nearest codes of stages 1 and 2 of every item on the card against the CPU's from the same weights; a
    differing code is an argmin tie when the CPU's distances to the two codes lie within fp32 rounding of each
    other (1e-5 of the distance plus 1e-6), and fails the run otherwise.  Returns ``(stage-1 differences,
    stage-2 differences, ties)``."""
    cpu = copy.deepcopy(card_model).cpu().eval()
    with torch.inference_mode():
        got = torch.cat([card_model.get_indices(torch.from_numpy(data[s:s + RQ["batch"]]).to(CARD)) for s in range(0, len(data), RQ["batch"])]).cpu()
        residual = cpu.encode(torch.from_numpy(data))
        ref = cpu.get_indices(torch.from_numpy(data))
        ties, diffs = 0, []
        for i in range(2):
            emb = getattr(cpu.rq, f"vq_layers_{i}").embedding
            d = (residual**2).sum(1, keepdim=True) + (emb**2).sum(1)[None, :] - 2 * residual @ emb.T
            bad = torch.nonzero(got[:, i] != ref[:, i]).reshape(-1)
            diffs.append(int(bad.numel()))
            tie = (d[bad, got[bad, i]] - d[bad, ref[bad, i]]).abs() <= 1e-5 * d[bad, ref[bad, i]].abs() + 1e-6
            ties += int(tie.sum())
            if not tie.all():
                raise AssertionError(f"stage {i + 1}: {int((~tie).sum())} codes differ between the card and the CPU beyond an argmin tie")
            residual = residual - emb[ref[:, i]]
    return diffs[0], diffs[1], ties


def rqvae_phase():
    """RQVAEModel at the JAX package's default widths through RQVAETrainer: one step card against CPU (loss, every
    parameter's step, the codes), fit ms per epoch, a step's device time and idle share, generate_semantic_ids over
    every item (ms, the collision rate before and after the retries), the stage-1 and stage-2 codes card against CPU."""
    t0 = time.perf_counter()
    b = RQ["batch"]
    data, _ = rq_data(seed=0)
    cpu = rq_model(seed=2, device="cpu")
    d1, d2, ties = rq_codes_against_cpu(copy.deepcopy(cpu).to(CARD).eval(), data[:b])

    def outputs(m, d):
        out, rq_loss, idx = m(torch.from_numpy(data[:b]).to(d), use_sk=True)
        if (idx[:, 2] != 0).any():
            raise AssertionError("the third stage's Sinkhorn at 0.003 gave a code other than 0: it did not overflow to NaN")
        return {"reconstruction": out, "rq_loss": rq_loss.reshape(1)}

    def train_step(m, d):
        return RQVAETrainer(m, optimizer_params=CTR_OPT, device=d, model_path=RQ_MODEL_PATH).train_one_epoch(data[:b], b)

    worst, where, max_abs, losses, still, kinks = against_cpu("RQ-VAE", cpu, outputs, train_step, b)
    print(f"  one step card vs CPU, B{b}, same weights: eval reconstruction max abs err {max_abs:.3e}; worst max |d|/tol: " + ", ".join(f"{k} {v:.3f}" + (f" ({where[k]})" if k in where else "") for k, v in worst.items())
          + f"; loss {losses[0]:.7f} vs {losses[1]:.7f}; ReLU inputs on the other side of 0 there: {kinks[0]} of {kinks[1]:,}" + (f"; unmoved: {still}" if still else "")
          + f"; stage-1 / stage-2 codes {d1} / {d2} differ ({ties} argmin ties), stage 3 code 0 on both (Sinkhorn at 0.003 overflows)")
    if max(worst.values()) > 1.0 or still:
        raise AssertionError(f"RQ-VAE: the card disagrees with the CPU: {worst}, unmoved {still}")

    model = rq_model(seed=0, device=CARD)
    trainer = RQVAETrainer(model, optimizer_params=CTR_OPT, n_epoch=RQ["epochs"], eval_step=RQ["epochs"], model_path=RQ_MODEL_PATH)
    t1 = time.perf_counter()
    best_loss, best_rate = trainer.fit(data, batch_size=b)
    fit_s = time.perf_counter() - t1
    xb = torch.from_numpy(data[:b]).to(CARD)
    step = lambda: trainer.train_step(xb)  # noqa: E731
    wall = wall_ms(step, reps=10)
    kernels = profile_kernels(step, steps=3)
    device, launches = sum(ms for ms, _ in kernels.values()), sum(n for _, n in kernels.values())
    before = trainer.evaluate(data, b)
    t1 = time.perf_counter()
    sids = trainer.generate_semantic_ids(data, batch_size=b)
    gen_s = time.perf_counter() - t1
    strs = [str(v) for v in sids.values()]
    after = (len(strs) - len(set(strs))) / len(strs)
    print(f"  fit: {RQ['epochs']} epochs of {RQ['items'] // b} steps of {b} ({RQ['items']} items, {RQ['clusters']} clusters in {RQ['in_dim']}-d), {fit_s / RQ['epochs'] * 1e3:.1f} ms per epoch "
          f"(host clock; the collision rate of the last epoch and the checkpoints included), best loss {best_loss:.5f}, collision rate {best_rate:.5f}; a step: device {device:.4f} ms "
          f"(torch.profiler kernels, 3 steps), host clock {wall:.4f} ms (median of 10), device idle {1 - device / wall:.0%}, {launches:.1f} launches")
    print(f"  generate_semantic_ids of {RQ['items']} items: {gen_s * 1e3:.1f} ms, {trainer.retry_passes} retry passes (Sinkhorn at 0.003 on the colliding groups' last stage), "
          f"collision rate {before:.5f} before the retries, {after:.5f} after")
    d1, d2, ties = rq_codes_against_cpu(model.eval(), data)
    print(f"  stage-1 and stage-2 codes of every item, card vs CPU from the trained weights: {d1} and {d2} differ, {ties} of them argmin ties (within fp32 rounding)")
    if not (np.isfinite(best_loss) and len(sids) == RQ["items"]):
        raise AssertionError("RQ-VAE: fit or generate_semantic_ids failed")
    print(f"  RQ-VAE phase: {time.perf_counter() - t0:.1f} s")



# ---------------------------------------------------------------------------
# 13. HLLM through SeqTrainer; TIGER with trie-constrained beam search
# ---------------------------------------------------------------------------

# HLLM at the JAX package's defaults (models/generative/hllm.py:66-76): d 512, 8 heads, 4 layers, max_seq_len 256, 2048 sqrt
# time buckets, temperature 0.07, the relative bias; on the HSTU cell's geometry (hstu_train_bench.py:57-58,95): V40,000, B8,
# L256.  The frozen table: seeded clustered stand-ins for LLM item encodings (vocab // 16 clusters), and left-padded histories
# of L/2..L items that stay in one cluster, as examples/generative/run_hllm.py:24-48 makes them (the repo holds no LLM
# encodings).  The card against the CPU at B2; fit on 1,024 users split 0.8 / 0.1 / 0.1 by SequenceDataGenerator
HLLM = dict(vocab=40_000, d_model=512, n_heads=8, n_layers=4, max_seq_len=256, batch=8, check_batch=2, chunk=8192, negatives=1024, serve_batches=8, fit_users=1024, fit_epochs=2, chance_times=10)
HLLM_MODEL_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_hllm")
# cosine logits of up to 1/0.07: an absolute tolerance of 1e-5 of the largest beside CTR_LOGIT_ATOL (the 512-term dot
# products of 4 layers, rounded in another order on each device, scaled by 14.3)
HLLM_LOGIT_ATOL_REL = 1e-5
# TIGER at the paper's widths (arXiv:2305.05065 §4): d 128, 4 encoder and 4 decoder layers, d_ff 1024, dropout 0.1, B256,
# optax.adamw(1e-3)'s update (examples/generative/run_rqvae_tiger.py:57: weight decay 1e-4); 4 heads of 32, since the repo's
# _MHA splits d_model (tiger.py:32-33) and cannot hold the paper's 6 heads of 64.  Semantic ids: RQVAETrainer with k-means
# init (10 iterations a stage) on the RQ-VAE phase's 12,101 seeded items, the codebooks as the init leaves them: Adam at
# 1e-3 collapses them on these clusters (three epochs left 222 distinct ids of 12,101 on an H100), which would leave
# TIGER's trie next to trivial, where the init gives about 9,600.  Histories at Amazon-Beauty's counts
# (22,363 users, 12,101 items, 5 + Poisson(3.9) interactions a user, about 8.9), each within one of the items' 1,000
# clusters, with repeat purchases: each item is the user's favourite of that cluster with probability 0.5, else any item
# of the cluster (the repo holds no Amazon-Beauty interactions), up to 20 items (60 tokens) of input.  Two gates: recall@10
# above ten times uniform chance over the ids, and recall@1 (the best beam) above three times that of a ranker that
# knows the target's cluster and nothing else (1 / the cluster's distinct ids, averaged over the test users); only the
# favourite, read from the history, beats that, so a search that ranks badly inside a trie branch fails.  900 steps:
# after 300 the model has not learned the favourite yet, and recall@1 stays below the gate
TIGER = dict(d_model=128, n_heads=4, n_layers=4, d_ff=1024, dropout=0.1, batch=256, users=22_363, extra_len=3.9, repeat=0.5, max_his_len=20, steps=900, beams=10,
             new_tokens=3, test_users=1024, check_batch=64, check_users=32, kmeans_iters=10, chance_times=10, cluster_times=3)
TIGER_MODEL_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_tiger")
TIGER_OPT = dict(lr=1e-3, weight_decay=1e-4)
# a beam's score is a sum of 3 log-probabilities of 8 layers' outputs, rounded in another order on each device
TIGER_SCORE_ATOL = 1e-4


@contextlib.contextmanager
def given_negatives(negs):
    """The sampled softmax's negatives given: the same ids on both devices, whose generators would draw their own."""
    draw = chunked_ce.sampled_candidates
    chunked_ce.sampled_candidates = lambda toks, tgts, gen, v, s, ignore: (chunked_ce.shifted_labels(toks, tgts, ignore), torch.from_numpy(negs).to(toks.device))
    try:
        yield
    finally:
        chunked_ce.sampled_candidates = draw


def hllm_items(seed):
    """``(V, d)`` fp32 clustered item encodings, PAD row 0 (examples/generative/run_hllm.py:24-31)."""
    rng = np.random.default_rng(seed)
    n_clusters = HLLM["vocab"] // 16
    centers = rng.normal(size=(n_clusters, HLLM["d_model"]))
    emb = centers[np.arange(HLLM["vocab"]) % n_clusters] + 0.15 * rng.normal(size=(HLLM["vocab"], HLLM["d_model"]))
    emb[0] = 0.0
    return emb.astype(np.float32)


def hllm_data(n, seed):
    """``(tokens, positions, targets, time_diffs)``: each user's L/2..L items and target from one cluster (the ids
    ``c + k · V // 16``), left-padded, an hour between interactions (examples/generative/run_hllm.py:34-48)."""
    v, l = HLLM["vocab"], HLLM["max_seq_len"]
    n_clusters = v // 16
    rng = np.random.default_rng(seed)
    c = rng.integers(0, n_clusters, n)
    lengths = rng.integers(l // 2, l + 1, n)
    k_lo, k_hi = (c == 0).astype(np.int64), (v - 1 - c) // n_clusters
    seq = c[:, None] + n_clusters * (k_lo[:, None] + (rng.random((n, l + 1)) * (k_hi - k_lo + 1)[:, None]).astype(np.int64))
    valid = np.arange(l)[None, :] >= (l - lengths)[:, None]
    toks = np.where(valid, seq[:, :l], 0).astype(np.int32)
    tds = np.where(valid, (l - 1 - np.arange(l))[None, :] * 3600, 0).astype(np.int32)
    return toks, np.broadcast_to(np.arange(l, dtype=np.int32), (n, l)).copy(), seq[:, l].astype(np.int32), tds


def hllm_model(items, seed, device, dropout=0.0):
    h = HLLM
    return HLLMModel(items, h["vocab"], d_model=h["d_model"], n_heads=h["n_heads"], n_layers=h["n_layers"], max_seq_len=h["max_seq_len"], dropout=dropout,
                     generator=torch.Generator().manual_seed(seed), device=device)


def step_stats(name, step, steps=3):
    """``(device ms, host-clock ms, launches)`` of one call of ``step``: torch.profiler's kernel sums (printed by class,
    the top 5 by name), the median host clock of 10."""
    wall = wall_ms(step, reps=10)
    kernels = profile_kernels(step, steps)
    return print_breakdown(name, kernels, steps, ctr_kernel_class, top=5), wall, sum(n for _, n in kernels.values())


def hllm_phase(cycles_per_ms):
    """HLLMModel at the JAX package's defaults through SeqTrainer: the card against the CPU (logits; one step of the
    dense, chunked and sampled losses), serving (evaluate, predict_logits), a chunked step's device time, host clock,
    idle share and launches, and fit to a top-1 hit above ten times chance; the frozen table never moves."""
    t0 = time.perf_counter()
    h = HLLM
    l, b = h["max_seq_len"], h["check_batch"]
    items = hllm_items(seed=0)
    table = torch.from_numpy(items / np.maximum(np.linalg.norm(items, axis=-1, keepdims=True), 1e-8))
    toks, pos, tgts, tds = hllm_data(b, seed=2)
    negs = np.random.default_rng(3).integers(1, h["vocab"], h["negatives"])
    cpu = hllm_model(items, seed=1, device="cpu")

    def outputs(m, d):
        return {"logits": m(torch.from_numpy(toks).to(d), torch.from_numpy(tds).to(d))}

    for name, kw in (("dense", {}), (f"chunked {h['chunk']}", {"vocab_chunk_size": h["chunk"]}), (f"sampled softmax, {h['negatives']} given negatives", {"loss_type": "sampled_softmax", "loss_params": {"num_negatives": h["negatives"]}})):
        def train_step(m, d, kw=kw):
            with given_negatives(negs):
                return SeqTrainer(m, optimizer_params=CTR_OPT, model_path=HLLM_MODEL_PATH, device=d, **kw).train_one_epoch(SeqLoader(toks, pos, tgts, tds, batch_size=b), log_interval=0)

        model = copy.deepcopy(cpu)
        worst, where, max_abs, losses, still, kinks = against_cpu(f"HLLM {name}", model, outputs, train_step, b * l, atol_rel=HLLM_LOGIT_ATOL_REL)
        print(f"  {name}: one step card vs CPU, B{b} x L{l}, same weights: eval logits max abs err {max_abs:.3e}; worst max |d|/tol: " + ", ".join(f"{k} {v:.3f}" + (f" ({where[k]})" if k in where else "") for k, v in worst.items())
              + f"; loss {losses[0]:.7f} vs {losses[1]:.7f}; ReLU inputs on the other side of 0 there: {kinks[0]} of {kinks[1]:,}" + (f"; unmoved: {still}" if still else ""))
        if max(worst.values()) > 1.0 or still or not torch.equal(model.item_embeddings, table):
            raise AssertionError(f"HLLM {name}: the card disagrees with the CPU: {worst}, unmoved {still}")
    del cpu, model

    # serving: evaluate and predict_logits over B8 x L256 requests
    model = hllm_model(items, seed=4, device=CARD)
    data = hllm_data(h["batch"] * h["serve_batches"], seed=5)
    loader = SeqLoader(*data, batch_size=h["batch"])
    trainers = {"dense": SeqTrainer(model, model_path=HLLM_MODEL_PATH), f"chunked {h['chunk']}": SeqTrainer(model, vocab_chunk_size=h["chunk"], model_path=HLLM_MODEL_PATH)}
    for tr in trainers.values():  # warm-up
        tr.evaluate(loader)
        tr.predict_logits(loader)
    torch.cuda.synchronize()
    tokens = h["batch"] * h["serve_batches"] * l
    losses = []
    for name, tr in trainers.items():
        t1 = time.perf_counter()
        loss, top1 = tr.evaluate(loader)
        t_eval = time.perf_counter() - t1
        t1 = time.perf_counter()
        logits = tr.predict_logits(loader)
        t_pred = time.perf_counter() - t1
        losses.append(loss)
        print(f"  serving {name}: eval loss {loss:.6f}, top-1 {top1:.4f}, {tokens / t_eval:,.0f} tokens/s, {t_eval / h['serve_batches'] * 1e3:.3f} ms per request of {h['batch']} x L{l}; "
              f"predict_logits {t_pred / h['serve_batches'] * 1e3:.3f} ms per batch (host clock, {h['serve_batches']} requests)")
        if not (math.isfinite(loss) and 0 < loss < 2 * math.log(h["vocab"]) / 0.07) or logits.shape != (len(data[0]), h["vocab"]) or not np.isfinite(logits).all():
            raise AssertionError(f"HLLM serving output out of range ({name})")
    if not math.isclose(losses[0], losses[1], rel_tol=1e-5):
        raise AssertionError(f"HLLM dense and chunked eval losses differ: {losses}")
    toks_d, _, tds_d, tgts_d = (torch.from_numpy(a).to(CARD) for a in next(iter(loader)))
    with torch.inference_mode():
        for name, tr in trainers.items():
            device, wall = timed(lambda tr=tr: tr.eval_step(toks_d, tds_d, tgts_d), cycles_per_ms)
            print(f"  serving {name} eval_step of one request: device {device:.4f} ms, host clock {wall:.4f} ms, device idle {1 - device / wall:.0%} (medians of {REPS})")

    # training: the chunked step (the HSTU cell's path), dense and the sampled softmax beside it
    for name, kw in ((f"chunked {h['chunk']}", {"vocab_chunk_size": h["chunk"]}), ("dense", {}), (f"sampled softmax {h['negatives']}", {"loss_type": "sampled_softmax", "loss_params": {"num_negatives": h["negatives"]}})):
        tr = SeqTrainer(hllm_model(items, seed=6, device=CARD, dropout=0.1), model_path=HLLM_MODEL_PATH, **kw)
        tr.train_one_epoch(SeqLoader(*(a[:h["batch"]] for a in data), batch_size=h["batch"]), log_interval=0)  # warm-up
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss = tr.train_one_epoch(loader, log_interval=0)
        seconds = time.perf_counter() - t1
        device, wall, launches = step_stats(f"HLLM {name}", lambda tr=tr: tr.train_step(toks_d, tds_d, tgts_d))
        print(f"  training {name}: loss {loss:.6f}, {tokens / seconds:,.0f} tokens/s, {seconds / h['serve_batches'] * 1e3:.3f} ms per step of {h['batch']} x L{l} (host clock, {h['serve_batches']} steps); "
              f"a step: device {device:.4f} ms (torch.profiler kernels, 3 steps), host clock {wall:.4f} ms (median of 10), device idle {1 - device / wall:.0%}, {launches:.1f} launches")
        if not math.isfinite(loss) or not torch.equal(tr.model.item_embeddings.cpu(), table):
            raise AssertionError(f"HLLM training {name}: loss {loss} or the frozen table moved")
    del trainers, model, tr

    # fit on users whose histories and targets stay in one cluster; evaluate on held-out users
    train, val, test = SequenceDataGenerator(*hllm_data(h["fit_users"], seed=7), seed=0).generate_dataloader(batch_size=h["batch"], split_ratio=(0.8, 0.1, 0.1))
    tr = SeqTrainer(hllm_model(items, seed=8, device=CARD, dropout=0.1), vocab_chunk_size=h["chunk"], n_epoch=h["fit_epochs"], model_path=HLLM_MODEL_PATH)
    _, before = tr.evaluate(test)
    t1 = time.perf_counter()
    tr.fit(train, val)
    fit_s = time.perf_counter() - t1
    loss, after = tr.evaluate(test)
    chance = 1 / (h["vocab"] - 1)
    print(f"  fit: {h['fit_epochs']} epochs of {len(train)} chunked steps ({fit_s:.1f} s with validation); held-out top-1 {after:.4f} "
          f"(before fit {before:.4f}; chance {chance:.2e}, {h['chance_times']}x chance {h['chance_times'] * chance:.2e}), loss {loss:.4f}")
    if not after > h["chance_times"] * chance or not torch.equal(tr.model.item_embeddings.cpu(), table):
        raise AssertionError(f"HLLM fit: top-1 {after} not above {h['chance_times']}x chance, or the frozen table moved")
    print(f"  HLLM phase: {time.perf_counter() - t0:.1f} s")


def tiger_model(vocab, seed, device, dropout=TIGER["dropout"]):
    t = TIGER
    return TIGERModel(vocab, d_model=t["d_model"], n_heads=t["n_heads"], n_enc_layers=t["n_layers"], n_dec_layers=t["n_layers"], d_ff=t["d_ff"], dropout=dropout,
                      max_len=3 * t["max_his_len"], generator=torch.Generator().manual_seed(seed), device=device)


def tiger_samples(item_tokens, cluster, seed):
    """build_tiger_samples over seeded histories: per user 5 + Poisson(3.9) items of one of the items' clusters of at
    least two distinct semantic ids, each the user's favourite item of it with probability ``repeat``, else drawn
    from the cluster.  Returns post-padded ``(train x, train labels, test x, test labels)``, the mean history length
    and, per test sample, the number of distinct semantic ids in its cluster."""
    t = TIGER
    rng = np.random.default_rng(seed)
    members = [np.nonzero(cluster == c)[0] for c in range(cluster.max() + 1)]
    n_ids = [len({tuple(item_tokens[int(i)]) for i in m}) for m in members]
    members, n_ids = zip(*[(m, n) for m, n in zip(members, n_ids) if n >= 2])
    lengths = 5 + rng.poisson(t["extra_len"], t["users"])
    histories, user_ids = {}, []
    for u in range(t["users"]):
        c = rng.integers(len(members))
        drawn = rng.choice(members[c], lengths[u])
        histories[u] = np.where(rng.random(lengths[u]) < t["repeat"], rng.choice(members[c]), drawn).tolist()
        user_ids.append(n_ids[c])
    tx, ty, vx, vy = build_tiger_samples(histories, item_tokens, max_his_len=t["max_his_len"], eos_token_id=1)
    pad = lambda seqs, n, value=0: pad_sequences(seqs, maxlen=n, padding="post", value=value)  # noqa: E731
    width = 3 * t["max_his_len"]
    return pad(tx, width), pad(ty, 4, -100), pad(vx, width), pad(vy, 4, -100), float(np.mean(lengths)), np.asarray(user_ids)


def adamw_first_update(g, p0):
    """AdamW's first update in float64 (the decoupled decay is the same on both sides): m_hat = g, v_hat = g²."""
    g = g.double()
    return g / (g.abs() + 1e-8)


def beam_scores(model, x, beams):
    """The teacher-forced sum of log-probabilities of each beam under ``model`` (on the CPU, in eval mode)."""
    model.eval()
    with torch.inference_mode():
        enc, mask = model.encode(torch.from_numpy(x))
        out = []
        for i, seqs in enumerate(beams):
            dec = torch.tensor([[model.pad_token_id] + s[:-1] for s in seqs])
            logp = torch.log_softmax(model.decode(dec, enc[i:i + 1].expand(len(seqs), -1, -1), mask[i:i + 1].expand(len(seqs), -1)), -1)
            out.append(logp.gather(-1, torch.tensor(seqs)[..., None])[..., 0].sum(-1).tolist())
    return out


def tiger_phase():
    """TIGER at the paper's widths: semantic ids from RQVAETrainer with k-means init, samples from seeded histories,
    the card against the CPU (loss, logits, one AdamW step; generate's beams up to near-ties), a step's device time,
    host clock, idle share and launches, a few hundred steps, then trie-constrained generate (10 beams, 3 new tokens)
    to a recall@10 over the semantic ids above ten times chance and a recall@1 above three times that of knowing the
    target's cluster."""
    t0 = time.perf_counter()
    t = TIGER
    data, cluster = rq_data(seed=0)
    rq_trainer = RQVAETrainer(RQVAEModel(in_dim=RQ["in_dim"], sk_epsilons=RQ["sk_epsilons"], kmeans_init=True, kmeans_iters=t["kmeans_iters"], generator=torch.Generator().manual_seed(3), device=CARD),
                              n_epoch=0, model_path=TIGER_MODEL_PATH)
    t1 = time.perf_counter()
    rq_trainer.fit(data, batch_size=RQ["batch"])  # the k-means init of the three codebooks, no epoch
    sids = rq_trainer.generate_semantic_ids(data, batch_size=RQ["batch"])
    vocab, item_tokens = semantic_id_vocab(sids)
    codes = {tuple(v) for v in item_tokens.values()}
    print(f"  semantic ids (RQVAETrainer's k-means init, {t['kmeans_iters']} iterations a stage; generate_semantic_ids): {time.perf_counter() - t1:.1f} s; {len(vocab)} code tokens, "
          f"{len(codes):,} distinct ids over {len(item_tokens):,} items (collision rate {1 - len(codes) / len(item_tokens):.4f})")
    x, y, test_x, test_y, mean_len, cluster_ids = tiger_samples(item_tokens, cluster, seed=4)
    n_vocab = len(vocab) + 2  # PAD 0, EOS 1
    print(f"  samples: {t['users']:,} users, {mean_len:.2f} interactions a user, {len(x):,} train and {len(test_x):,} test samples, inputs of up to {x.shape[1]} tokens, vocab {n_vocab}")

    # the card against the CPU, dropout 0 (the devices' generators draw their own masks)
    b = t["check_batch"]
    cpu = tiger_model(n_vocab, seed=5, device="cpu", dropout=0.0)
    xb, yb = torch.from_numpy(x[:b]), torch.from_numpy(y[:b])

    def outputs(m, d):
        loss, logits = m(xb.to(d), labels=yb.to(d))
        return {"logits": logits, "loss": loss.reshape(1)}

    def train_step(m, d):
        opt = torch.optim.AdamW(m.parameters(), **TIGER_OPT)
        m.train()
        loss, _ = m(xb.to(d), labels=yb.to(d))
        loss.backward()
        opt.step()
        return float(loss.detach())

    worst, where, max_abs, losses, still, kinks = against_cpu("TIGER", cpu, outputs, train_step, b * 4, first_update=adamw_first_update)
    print(f"  one AdamW step card vs CPU, B{b}, same weights: eval logits max abs err {max_abs:.3e}; worst max |d|/tol: " + ", ".join(f"{k} {v:.3f}" + (f" ({where[k]})" if k in where else "") for k, v in worst.items())
          + f"; loss {losses[0]:.7f} vs {losses[1]:.7f}; ReLU inputs on the other side of 0 there: {kinks[0]} of {kinks[1]:,}" + (f"; unmoved: {still}" if still else ""))
    if max(worst.values()) > 1.0 or still:
        raise AssertionError(f"TIGER: the card disagrees with the CPU: {worst}, unmoved {still}")

    # training at B256 with dropout 0.1, then trie-constrained generate
    model = tiger_model(n_vocab, seed=6, device=CARD)
    opt = torch.optim.AdamW(model.parameters(), **TIGER_OPT)
    gen = torch.Generator(device=CARD).manual_seed(7)
    rng = np.random.default_rng(8)
    xd, yd = torch.from_numpy(x).to(CARD), torch.from_numpy(y).to(CARD)

    def step(idx):
        model.train()
        opt.zero_grad(set_to_none=True)
        loss, _ = model(xd[idx], labels=yd[idx], generator=gen)
        loss.backward()
        opt.step()
        return loss.detach()

    batches = [torch.from_numpy(rng.integers(0, len(x), t["batch"])).to(CARD) for _ in range(t["steps"])]
    first = float(step(batches[0]))
    t1 = time.perf_counter()
    losses = torch.stack([step(idx) for idx in batches[1:]])
    last = float(losses[-20:].mean())
    train_s = time.perf_counter() - t1
    device, wall, launches = step_stats(f"TIGER B{t['batch']}", lambda: step(batches[0]))
    print(f"  training: {t['steps']} AdamW steps of {t['batch']}, loss {first:.4f} -> {last:.4f} (mean of the last 20), {(t['steps'] - 1) * t['batch'] / train_s:,.0f} samples/s, "
          f"{train_s / (t['steps'] - 1) * 1e3:.3f} ms per step (host clock); a step: device {device:.4f} ms (torch.profiler kernels, 3 steps), host clock {wall:.4f} ms (median of 10), "
          f"device idle {1 - device / wall:.0%}, {launches:.1f} launches")
    if not (math.isfinite(last) and last < first):
        raise AssertionError(f"TIGER training did not lower the loss: {first} -> {last}")

    trie = Trie([toks + [1] for toks in item_tokens.values()])
    n_test = t["test_users"]
    hits, firsts, gen_s = 0, 0, []
    for s in range(0, n_test, t["batch"]):
        t1 = time.perf_counter()
        out = generate(model, test_x[s:s + t["batch"]], t["new_tokens"], t["beams"], trie, eos_token_id=1)
        gen_s.append(time.perf_counter() - t1)
        for beams, lab in zip(out, test_y[s:s + t["batch"]]):
            target = tuple(int(v) for v in lab[:3])
            hits += int(target in {tuple(bm[:3]) for bm in beams})
            firsts += int(bool(beams) and tuple(beams[0][:3]) == target)
    recall, recall1, chance = hits / n_test, firsts / n_test, t["beams"] / len(codes)
    # a ranker that knows the target's cluster and draws k of its distinct ids
    cluster10, cluster1 = float(np.mean(np.minimum(1.0, t["beams"] / cluster_ids[:n_test]))), float(np.mean(1.0 / cluster_ids[:n_test]))
    print(f"  generate (trie, {t['beams']} beams, {t['new_tokens']} new tokens): {np.median(gen_s) * 1e3:.1f} ms per batch of {t['batch']} users (median of {len(gen_s)}), "
          f"{t['batch'] / np.median(gen_s):,.0f} users/s; over the semantic ids of {n_test} held-out users: recall@{t['beams']} {recall:.4f} "
          f"(uniform chance {chance:.2e}, {t['chance_times']}x {t['chance_times'] * chance:.2e}; knowing the cluster {cluster10:.4f}), "
          f"recall@1 {recall1:.4f} (knowing the cluster {cluster1:.4f}, {t['cluster_times']}x {t['cluster_times'] * cluster1:.4f})")
    if not recall > t["chance_times"] * chance:
        raise AssertionError(f"TIGER recall@{t['beams']} {recall} not above {t['chance_times']}x chance")
    if not recall1 > t["cluster_times"] * cluster1:
        raise AssertionError(f"TIGER recall@1 {recall1} not above {t['cluster_times']}x that of knowing the cluster ({cluster1})")

    # generate on the card against the CPU from the trained weights: the same beams but at a near-tie
    cpu = copy.deepcopy(model).cpu()
    xs = test_x[: t["check_users"]]
    got, ref = generate(model, xs, t["new_tokens"], t["beams"], trie, eos_token_id=1), generate(cpu, xs, t["new_tokens"], t["beams"], trie, eos_token_id=1, device="cpu")
    got_s, ref_s = beam_scores(cpu, xs, got), beam_scores(cpu, xs, ref)
    ties, worst = 0, 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        # the first beam where the two lists part, if any: it and every beam before it must score alike
        k = next((j for j, (a, c) in enumerate(zip(g, r)) if a != c), len(g) if len(g) == len(r) else min(len(g), len(r)))
        gaps = [abs(a - c) for a, c in zip(got_s[i][:k + 1], ref_s[i][:k + 1])]
        worst = max([worst] + gaps)
        if max(gaps, default=0.0) > TIGER_SCORE_ATOL:
            raise AssertionError(f"TIGER generate, user {i}: the card's beams {g} (scores {got_s[i]}) differ from the CPU's {r} ({ref_s[i]}) beyond a near-tie")
        ties += int(g != r)
    print(f"  generate card vs CPU, {len(xs)} users x {t['beams']} beams: {len(xs) - ties} users' beams equal, {ties} differ from a near-tie on "
          f"(beam scores within {TIGER_SCORE_ATOL} there); largest score difference over the compared beams {worst:.2e}")
    print(f"  TIGER phase: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# 14. bf16 mixed precision (basic/precision.py): the bf16 K1 and K2, and bf16
#     HSTU, DeepFM, DSSM and MMOE through their trainers
# ---------------------------------------------------------------------------

PEAK_BF16_FLOPS = 989e12  # dense bf16 on the tensor cores (NVIDIA data sheet, H100 SXM)
BF16_KERNELS = {"hstu_rab_fwd_bf16": ("hstu_rab_fwd_bf16.cu", "hstu_rab_attention.py:267"), "hstu_rab_bwd_bf16": ("hstu_rab_bwd_bf16.cu", "hstu_rab_attention.py:459"),
                "hstu_rab_bwd_dq_bf16": ("hstu_rab_bwd_bf16.cu", "hstu_rab_attention.py:313"), "hstu_rab_bwd_dkv_bf16": ("hstu_rab_bwd_bf16.cu", "hstu_rab_attention.py:404"),
                "hstu_attn_fwd_bf16": ("hstu_attn_fwd_bf16.cu", "hstu_attention.py:45")}
BF16_RAB_KERNELS = tuple(BF16_KERNELS)[:4]  # the kernel phase's; K3-bf16 has the attention phase's cases
# a bf16 kernel against its plain bf16 version (out, dq, dk, dv): one bf16 ulp of the largest element, since a
# rounding of attn or ds, or of an f32 sum taken in another order, may flip; dpos, dts (f32 sums of up to
# B*L^2/2 terms): as the fp32 tables, at twice the absolute part
BF16_ULP_REL = 2**-7
BF16_TABLE_RTOL, BF16_TABLE_ATOL_REL = 1e-4, 2e-4
# and the kernel rounds as the plain bf16 version: its distance to it is at most this share of the plain
# version's distance to the fp32 kernel's result (a kernel that computed in fp32 fails)
BF16_SHARE = 0.25
# a model's bf16 step on the card against the CPU's: cuBLAS and the kernels sum in other orders than the CPU,
# so a rounding to bf16 may flip anywhere and carry through the layers: the loss to 1e-2 relative, each
# output and gradient to 2**-4 of its tensor's largest element
BF16_LOSS_RTOL, BF16_ATOL_REL = 1e-2, 2**-4
BF16_HSTU_FIT = dict(users=1024, epochs=2, window=2048, chance_times=10)


def bf16_case(c):
    """A kernel case with q, k and v rounded to bf16."""
    return {**c, **{n: c[n].to(torch.bfloat16) for n in ("q", "k", "v")}}


def bf16_bounds(flops, nbytes):
    """(bound ms, what bounds it, ms from bytes, ms from FLOPs): bytes at their dtypes against the HBM rate,
    FLOPs against the bf16 tensor-core peak."""
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes"), t_bytes, t_ops


def bf16_compare(name, got, plain, f32):
    """max abs err of ``got`` against ``plain`` within the bf16 tolerances, and nearer to it than BF16_SHARE of
    the plain version's distance to the fp32 result; returns (max abs err, the share)."""
    got, plain, f32 = got.float().cpu(), plain.float().cpu(), f32.float().cpu()
    scale = float(plain.abs().max())
    tables = name.split()[-1] in ("dpos", "dts")
    rtol, atol = (BF16_TABLE_RTOL, BF16_TABLE_ATOL_REL * scale + 1e-12) if tables else (0.0, BF16_ULP_REL * scale + 1e-12)
    diff = (got - plain).abs()
    err = float(diff.max())
    if not (torch.isfinite(got).all() and bool((diff <= atol + rtol * plain.abs()).all())):
        raise AssertionError(f"{name}: the bf16 kernel disagrees with its plain bf16 version: max abs err {err:.3e} (atol {atol:.3e}, rtol {rtol})")
    gap = float((plain - f32).norm())
    share = float(diff.norm()) / gap if gap > 0 else 0.0
    if not tables and share > BF16_SHARE:
        raise AssertionError(f"{name}: the bf16 kernel is {share:.3f} of the way from its plain bf16 version to fp32")
    return err, share


def bf16_rab_kernels(c, args, thr):
    """``{kernel: {output: tensor}}`` of K1, K2, K2a and K2b on one case: the bf16 kernels on bf16 values, the fp32
    ones on fp32 values (``c`` the forward's case, ``args`` the backward's arguments; the wrappers take either)."""
    return {"hstu_rab_fwd_bf16": {"out": run_kernel(c)}, **{k + "_bf16": dict(zip(spec["outs"], spec["fn"](*args, thr))) for k, spec in BWD_KERNELS.items()}}


def bf16_kernel_phase(cases, cycles_per_ms):
    """The bf16 K1, K2, K2a and K2b on the kernel phase's cases and the bucket sweep, against the plain bf16 versions
    and the fp32 kernels; timed (device and host clock) at the serving shape and at L1024 beside the plain bf16
    version and the fp32 kernels, with bounds from bf16 bytes and bf16 tensor-core FLOPs."""
    worst = {k: 0.0 for k in BF16_RAB_KERNELS}
    timings = {}
    for name, c32 in cases.items():
        c = bf16_case(c32)
        has_time = c["ts"] is not None
        g32 = torch.from_numpy(np.random.default_rng(10).normal(size=tuple(c["v"].shape)).astype(np.float32)).cuda()
        g = g32.to(torch.bfloat16)
        args = (c["q"], c["k"], c["v"], g, c["pos_w"], c["ts_w"], c["ts"], c["mask"], c["alpha"], c["max_seq_len"], c["cfg"])
        got = bf16_rab_kernels(c, args, c["thr"])
        plain = {"out": rab.plain_forward_bf16(*args[:3], *args[4:], has_time), **dict(zip(GRAD_NAMES, rab.plain_backward_bf16(*args, has_time)))}
        cf = {**c, **{n: c[n].float() for n in ("q", "k", "v")}}  # the same bf16 values in fp32
        args32 = (cf["q"], cf["k"], cf["v"], g.float(), *args[4:])
        f32 = bf16_rab_kernels(cf, args32, c["thr"])
        torch.cuda.synchronize()
        dtypes = {(k, o): t.dtype for k, outs in got.items() for o, t in outs.items()}
        if any(dt != (torch.float32 if o in ("dpos", "dts") else torch.bfloat16) for (_, o), dt in dtypes.items()):
            raise AssertionError(f"bf16 kernels' output dtypes: {dtypes}")
        parts = []
        for kernel, outs in got.items():
            for key, t in outs.items():
                err, share = bf16_compare(f"{name} {kernel} {key}", t, plain[key], f32[kernel][key])
                worst[kernel] = max(worst[kernel], err)
                gap = float((plain[key].float() - f32[kernel][key].float()).abs().max())
                parts.append(f"{kernel} {key} {err:.2e} (share {share:.3f}; plain bf16 vs fp32 kernel {gap:.2e})")
        print(f"  {name}: max abs err against the plain bf16 version " + ", ".join(parts))
        if c["mask"] is not None and not bool(c["mask"][0].any()) and not bool((got["hstu_rab_fwd_bf16"]["out"][0] == 0).all()):
            raise AssertionError("bf16: a fully masked row must give zeros")
        if name.startswith("serve") or "L1024" in name:
            dqk, dv, pairs = c["q"].shape[-1], c["v"].shape[-1], valid_pairs(c)
            fwd_plain = timed(lambda: rab.plain_forward_bf16(*args[:3], *args[4:], has_time), cycles_per_ms)
            bwd_plain = timed(lambda: rab.plain_backward_bf16(*args, has_time), cycles_per_ms)
            for kernel in BF16_RAB_KERNELS:
                out_bytes = sum(t.numel() * t.element_size() for t in got[kernel].values())
                if kernel == "hstu_rab_fwd_bf16":  # inputs read, the bf16 output written
                    (ms, wall), (f32_ms, _) = timed(lambda: run_kernel(c), cycles_per_ms), timed(lambda: run_kernel(cf), cycles_per_ms)
                    b, (p_ms, p_wall) = bf16_bounds(2 * pairs * (dqk + dv), input_bytes(c) + out_bytes), fwd_plain
                else:  # inputs and g read, the kernel's outputs written
                    spec = BWD_KERNELS[kernel.removesuffix("_bf16")]
                    (ms, wall), (f32_ms, _) = timed(lambda: spec["fn"](*args, c["thr"]), cycles_per_ms), timed(lambda: spec["fn"](*args32, c["thr"]), cycles_per_ms)
                    fq, fv = spec["fma"]
                    b, (p_ms, p_wall) = bf16_bounds(2 * pairs * (fq * dqk + fv * dv), input_bytes(c) + g.numel() * 2 + out_bytes), bwd_plain
                timings.setdefault(kernel, {})[name] = dict(ms=ms, plain_ms=p_ms, bound_ms=b[0], bound_by=b[1])
                print(f"    {kernel} device {ms:.4f} ms (fp32 kernel {f32_ms:.4f} ms), plain bf16 {p_ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]}: bf16 bytes {b[2]:.4f} ms, "
                      f"bf16 FLOPs at {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s {b[3]:.4f} ms); host clock kernel {wall:.4f} ms, plain {p_wall:.4f} ms")
            print(f"    {pairs:,} valid pairs; medians of {REPS}; the plain bf16 backward computes all five gradients")
    for cfg in rab.SWEEP_CFGS:  # every bucket edge and |dt| = 2**31, the plain bf16 version on the CPU
        c = bf16_case(sweep_case(cfg))
        g = torch.from_numpy(np.random.default_rng(31).normal(size=tuple(c["v"].shape)).astype(np.float32)).to(torch.bfloat16)
        args = (c["q"], c["k"], c["v"], g, c["pos_w"], c["ts_w"], c["ts"], c["mask"], c["alpha"], c["max_seq_len"], c["cfg"])
        dev = {k: v.cuda() if isinstance(v, torch.Tensor) else v for k, v in c.items()}
        got = bf16_rab_kernels(dev, [a.cuda() if isinstance(a, torch.Tensor) else a for a in args], dev["thr"])
        plain = {"out": rab.plain_forward_bf16(*args[:3], *args[4:], True), **dict(zip(GRAD_NAMES, rab.plain_backward_bf16(*args, True)))}
        errs = []
        for kernel, outs in got.items():
            for key, t in outs.items():
                err, _ = bf16_compare(f"bucket sweep {tuple(cfg)} {kernel} {key}", t, plain[key], plain[key])
                worst[kernel] = max(worst[kernel], err)
                errs.append(f"{kernel} {key} {err:.2e}")
        print(f"  bf16 bucket sweep {tuple(cfg)}, L{c['max_seq_len']}: max abs err " + ", ".join(errs))
    print(f"  tolerances: out, dq, dk, dv {BF16_ULP_REL} x the tensor's max |plain| (one bf16 ulp), and at most {BF16_SHARE} of the plain bf16 version's distance to the fp32 kernel (L2); "
          f"dpos, dts rtol {BF16_TABLE_RTOL}, atol {BF16_TABLE_ATOL_REL} x the table's max")
    return {k: dict(max_abs_err=worst[k], **next(iter(timings[k].values()))) for k in BF16_RAB_KERNELS}


def bf16_attention_phase(cases, cycles_per_ms):
    """K3-bf16 through the op on the attention phase's cases with q, k, v rounded to bf16 and the bias in f32 (every
    case) and in bf16 ((a), (b), (f)): against ``plain_forward_bf16`` and the fp32 K3 on the same values; one
    backward each on (a) and (b); its launches over these op calls; timed at (a) and (g) beside the plain bf16
    version and the fp32 K3, with bounds from the bytes at their dtypes and 989 TFLOP/s."""
    attn.launches_bf16 = 0
    calls, worst, timings = 0, 0.0, {}
    variants = [(name, torch.float32) for name in cases] + [(name, torch.bfloat16) for name in cases if name.startswith(("(a)", "(b)", "(f)"))]
    for name, bias_dtype in variants:
        c32 = cases[name]
        c = {**bf16_case(c32), "bias": c32["bias"].to(bias_dtype)}
        label = f"{name}, {str(bias_dtype).removeprefix('torch.')} bias"
        with torch.no_grad():
            out = run_op(c)
            calls += 1
            f32 = run_op({**c, **{n: c[n].float() for n in ("q", "k", "v", "bias")}})
        plain = attn.plain_forward_bf16(c["q"], c["k"], c["v"], c["bias"], c["mask"], c["alpha"], c["max_seq_len"])
        torch.cuda.synchronize()
        if out.dtype != torch.bfloat16:
            raise AssertionError(f"hstu_attn_fwd_bf16's output is {out.dtype}")
        err, share = bf16_compare(f"hstu_attn_fwd_bf16, {label}", out, plain, f32)
        worst = max(worst, err)
        print(f"  {label}: max abs err {err:.3e} (max |plain| {float(plain.float().abs().max()):.3e}), share {share:.3f} of the plain bf16 version's distance to fp32 K3 "
              f"({float((plain.float() - f32).abs().max()):.2e})")
        if c["mask"] is not None and not bool(c["mask"][0].any()) and not bool((out[0] == 0).all()):
            raise AssertionError("K3-bf16: a fully masked row must give zeros")
        if name.startswith(("(a)", "(b)")) and bias_dtype == torch.bfloat16:
            g = torch.from_numpy(np.random.default_rng(11).normal(size=tuple(c["v"].shape)).astype(np.float32)).cuda().to(torch.bfloat16)
            got, ref = ([t.detach().clone().requires_grad_(True) for t in (c["q"], c["k"], c["v"], c["bias"])] for _ in range(2))
            hstu_attention(*got, c["mask"], c["alpha"], c["max_seq_len"]).backward(g)
            calls += 1
            attn.dense_forward(*ref, c["mask"], c["alpha"], c["max_seq_len"]).backward(g)
            torch.cuda.synchronize()
            errs = []
            for gname, a, r in zip(("dq", "dk", "dv", "dbias"), got, ref):
                if a.grad.dtype != torch.bfloat16 or a.grad.shape != r.shape:
                    raise AssertionError(f"K3-bf16's backward ({gname}, {label}): {a.grad.dtype} {tuple(a.grad.shape)}")
                errs.append(f"{gname} {bf16_compare(f'{label} {gname}', a.grad, r.grad, r.grad)[0]:.2e}")
            print(f"    backward through the op (dbias {tuple(got[3].grad.shape)}), bf16, against autograd of the plain version: max abs err " + ", ".join(errs))
    launches = attn.launches_bf16
    print(f"  hstu_attn_fwd_bf16 launches {launches} over {calls} op calls on bf16 q, k, v; tolerance one bf16 ulp ({BF16_ULP_REL}) of the largest element, share at most {BF16_SHARE}")
    if launches != calls:
        raise AssertionError(f"hstu_attention did not launch K3-bf16 once per bf16 call: {launches} launches, {calls} calls")
    for name, c32 in cases.items():  # timed after the count: these calls launch too
        if not name.startswith(("(a)", "(g)")):
            continue
        c = bf16_case(c32)
        cf = {**c, **{n: c[n].float() for n in ("q", "k", "v")}}
        with torch.no_grad():
            (ms, wall), (f32_ms, _) = timed(lambda: run_op(c), cycles_per_ms), timed(lambda: run_op(cf), cycles_per_ms)
            plain_ms, plain_wall = timed(lambda: attn.plain_forward_bf16(c["q"], c["k"], c["v"], c["bias"], c["mask"], c["alpha"], c["max_seq_len"]), cycles_per_ms)
        b, h, l, dqk = c["q"].shape
        dv, pairs = c["v"].shape[-1], valid_pairs(c)
        keys = torch.ones((b, l), dtype=torch.bool, device=CARD) if c["mask"] is None else c["mask"]
        bias_elems = pairs if c["bias"].shape[0] == b else h * int(keys.any(0).to(torch.int64).cumsum(0).sum())
        nbytes = 2 * (2 * c["q"].numel() + 2 * c["v"].numel()) + (0 if c["mask"] is None else keys.numel()) + c["bias"].element_size() * bias_elems
        bb = bf16_bounds(2 * pairs * (dqk + dv), nbytes)
        timings[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bb[0], bound_by=bb[1])
        print(f"  {name}, f32 bias: hstu_attn_fwd_bf16 device {ms:.4f} ms (fp32 K3 {f32_ms:.4f} ms), plain bf16 {plain_ms:.4f} ms, bound {bb[0]:.4f} ms ({bb[1]}: "
              f"bytes {bb[2]:.4f} ms, FLOPs {bb[3]:.4f} ms); host clock kernel {wall:.4f} ms, plain {plain_wall:.4f} ms; {pairs:,} valid pairs; medians of {REPS}")
    return dict(launches=launches, max_abs_err=worst, **timings[next(iter(timings))])


def check_f32_state(label, trainer):
    """Parameters, buffers and optimizer state in f32 under the bf16 policy."""
    opts = trainer.optimizer.optimizers if hasattr(trainer.optimizer, "optimizers") else (trainer.optimizer,)
    dtypes = {p.dtype for p in trainer.model.parameters()} | {b.dtype for b in trainer.model.buffers() if b.is_floating_point()}
    dtypes |= {v.dtype for o in opts for s in o.state.values() for v in s.values() if torch.is_tensor(v) and v.is_floating_point() and v.ndim > 0}
    if dtypes != {torch.float32}:
        raise AssertionError(f"{label}: parameters, buffers or optimizer state not float32 under bf16: {dtypes}")


def bn_biases(model):
    """The biases of the Dense layers in front of an MLP's BatchNorm: their exact gradient is 0 (the batch mean
    removes them), so their values are rounding noise of a size that says nothing."""
    return {f"{name}.Dense_{i}.bias" for name, m in model.named_modules() if isinstance(m, layers.MLP) for i in range(len(m.dims))}


def bf16_against_cpu(label, build, loss_fn):
    """One bf16 step of ``build(device) -> trainer`` (a fresh model from a seed) on the CPU and on the card:
    ``loss_fn(trainer, device)`` in train mode under the trainer's bf16 policy, its gradients, then the optimizer's
    step; the loss to BF16_LOSS_RTOL; each gradient to BF16_ATOL_REL of its largest CPU element plus twice the CPU's
    own bf16 rounding error (its largest distance to the same step in f32): two bf16 computations of one function
    in other summation orders each lie within their rounding error of it, and a gradient that is exactly 0 in f32
    (a constant input that a BatchNorm removes) is rounding noise on both sides.  The ``bn_biases`` are not
    compared.  Parameters and optimizer state f32 on both."""
    ref = build("cpu")
    ref.model.train()
    with precision_scope("f32"):
        loss_fn(ref, "cpu").backward()
    g32 = {n: p.grad.detach().clone() for n, p in ref.model.named_parameters() if p.grad is not None}
    del ref
    res, skip = [], ()
    for device in ("cpu", CARD):
        trainer = build(device)
        trainer.model.train()
        skip = bn_biases(trainer.model)
        trainer.optimizer.zero_grad(set_to_none=True)
        with precision_scope(trainer.precision):
            loss = loss_fn(trainer, device)
        loss.backward()
        grads = {n: p.grad.detach().float().cpu() for n, p in trainer.model.named_parameters() if p.grad is not None}
        trainer.optimizer.step()
        check_f32_state(f"{label} on {device}", trainer)
        res.append((float(loss), grads))
    (l_cpu, g_cpu), (l_card, g_card) = res
    worst, where = 0.0, ""
    for name, r in g_cpu.items():
        if name in skip:
            continue
        ratio = float((g_card[name] - r).abs().max()) / (BF16_ATOL_REL * float(r.abs().max()) + 2 * float((r - g32[name]).abs().max()) + 1e-12)
        if ratio > worst:
            worst, where = ratio, name
    print(f"  {label}: one bf16 step card vs CPU, loss {l_card:.6f} vs {l_cpu:.6f}; worst gradient max |d| / ({BF16_ATOL_REL} x the tensor's max + 2 x the CPU's bf16-f32 distance) "
          f"{worst:.3f} ({where}; {len(skip & set(g_cpu))} BatchNorm-removed biases of {len(g_cpu)} not compared); parameters and optimizer state float32")
    if not (math.isfinite(l_card) and math.isclose(l_card, l_cpu, rel_tol=BF16_LOSS_RTOL)) or worst > 1.0:
        raise AssertionError(f"{label}: the card's bf16 step disagrees with the CPU's: loss {l_card} vs {l_cpu}, gradient ratio {worst} ({where})")


def bf16_hstu_phase(cycles_per_ms):
    """The full-width HSTU under SeqTrainer(precision="bf16"): serving (evaluate, predict_logits), training with the
    chunked, dense and sampled losses, a chunked step's device time, host clock, idle share and launches, a chunked
    step through the split backward and the layers' backward timed through K2-bf16 and through K2a-bf16 + K2b-bf16,
    each loss's step card against CPU (the chunked one through the split backward too), and fit on successor
    histories to a top-1 above ten times chance.  Returns the bf16 rab kernels' launches: K1-bf16's and K2-bf16's
    in the serving and training runs, K2a-bf16's and K2b-bf16's in the split step."""
    t0 = time.perf_counter()
    l, vocab, n_layers = SERVE["max_seq_len"], SERVE["vocab_size"], SERVE["n_layers"]
    model = HSTUModel(**SERVE, generator=torch.Generator().manual_seed(0), device="cuda")
    loader = SeqLoader(*serving_data(BATCH * N_BATCHES, l, vocab), batch_size=BATCH)
    servers = {"dense": SeqTrainer(model, precision="bf16"), "chunked 8192": SeqTrainer(model, vocab_chunk_size=8192, precision="bf16")}
    for tr in servers.values():
        tr.evaluate(loader)
    torch.cuda.synchronize()
    reset_counts()
    tokens = BATCH * N_BATCHES * l
    for name, tr in servers.items():
        t1 = time.perf_counter()
        loss, top1 = tr.evaluate(loader)
        t_eval = time.perf_counter() - t1
        t1 = time.perf_counter()
        logits = tr.predict_logits(loader)
        t_pred = time.perf_counter() - t1
        print(f"  serving {name} (bf16): eval loss {loss:.6f}, top-1 {top1:.4f}, {tokens / t_eval:,.0f} tokens/s, {t_eval / N_BATCHES * 1e3:.3f} ms per request of {BATCH} sequences; "
              f"predict_logits {t_pred / N_BATCHES * 1e3:.3f} ms per request")
        if not (math.isfinite(loss) and 0 < loss < 2 * math.log(vocab)) or logits.dtype != np.float32 or not np.isfinite(logits).all():
            raise AssertionError(f"bf16 serving output out of range ({name})")
    serve_counts = read_counts()
    print("  serving launches: " + ", ".join(f"{k} {v}" for k, v in serve_counts.items()))
    if serve_counts["hstu_rab_fwd_bf16"] != 2 * len(servers) * N_BATCHES * n_layers or serve_counts["hstu_rab_fwd"] or serve_counts["hstu_rab_bwd_bf16"]:
        raise AssertionError(f"the bf16 serving path did not run the bf16 K1 once per layer per forward: {serve_counts}")
    toks, _, tds, tgts = (torch.from_numpy(a).cuda() for a in next(iter(loader)))
    with torch.inference_mode():
        device, wall = timed(lambda: servers["chunked 8192"].eval_step(toks, tds, tgts), cycles_per_ms)
    print(f"  stage eval_step chunked 8192 (bf16): device {device:.4f} ms, host clock {wall:.4f} ms, device idle {1 - device / wall:.0%} (medians of {REPS})")
    del servers, model
    gc.collect()
    torch.cuda.empty_cache()

    # training: the three losses, TRAIN_BATCHES steps each after a warm-up step
    data = serving_data(BATCH * TRAIN_BATCHES, l, vocab, seed=1, pad=False)
    loader, first = SeqLoader(*data, batch_size=BATCH), SeqLoader(*(a[:BATCH] for a in data), batch_size=BATCH)
    kinds = {"chunked 8192": dict(vocab_chunk_size=8192), "dense": dict(), "sampled 1024": dict(loss_type="sampled_softmax", loss_params=HSTU_SAMPLED)}
    trainers = {name: SeqTrainer(HSTUModel(**SERVE, generator=torch.Generator().manual_seed(1), device="cuda"), precision="bf16", **kw) for name, kw in kinds.items()}
    for tr in trainers.values():
        tr.train_one_epoch(first, log_interval=0)
    torch.cuda.synchronize()
    reset_counts()
    for name, tr in trainers.items():
        t1 = time.perf_counter()
        loss = tr.train_one_epoch(loader, log_interval=0)
        seconds = time.perf_counter() - t1
        print(f"  training {name} (bf16): train loss {loss:.6f}, {BATCH * TRAIN_BATCHES * l / seconds:,.0f} tokens/s, {seconds / TRAIN_BATCHES * 1e3:.3f} ms per step of {BATCH} x L{l} (host clock, {TRAIN_BATCHES} steps)")
        if not (math.isfinite(loss) and 0 < loss < 2 * math.log(vocab)):
            raise AssertionError(f"bf16 training loss out of range ({name}): {loss}")
        check_f32_state(f"HSTU {name}", tr)
    train_counts = read_counts()
    steps = len(trainers) * TRAIN_BATCHES
    print(f"  training launches over {steps} steps, {n_layers} layers: " + ", ".join(f"{k} {v}" for k, v in train_counts.items()))
    expected = {**{k: 0 for k in COUNTERS}, "hstu_rab_fwd_bf16": n_layers * steps, "hstu_rab_bwd_bf16": n_layers * steps}
    if train_counts != expected:
        raise AssertionError(f"the bf16 training path did not run the bf16 K1 and K2 once per layer per step: {train_counts}, expected {expected}")
    toks, _, tds, tgts = (torch.from_numpy(a).cuda() for a in next(iter(first)))
    for name, tr in trainers.items():
        device, wall, launched = step_stats(f"HSTU {name} (bf16)", lambda tr=tr: tr.train_step(toks, tds, tgts))
        print(f"  a {name} step (bf16): device {device:.4f} ms (torch.profiler kernels, 3 steps), host clock {wall:.4f} ms (median of 10), device idle {1 - device / wall:.0%}, "
              f"{launched:.1f} launches, {BATCH * l / wall * 1e3:,.0f} tokens/s by the host clock")

    # the split backward: one chunked step with _FUSED_BWD[0] = False, K2a-bf16 and K2b-bf16 once per layer
    tr = trainers["chunked 8192"]
    reset_counts()
    rab._FUSED_BWD[0] = False
    try:
        split_loss = tr.train_one_epoch(first, log_interval=0)
    finally:
        rab._FUSED_BWD[0] = True
    split_counts = read_counts()
    print(f"  a chunked 8192 step through the split backward (bf16, _FUSED_BWD[0] = False): loss {split_loss:.6f}; launches " + ", ".join(f"{k} {v}" for k, v in split_counts.items()))
    expected = {**{k: 0 for k in COUNTERS}, "hstu_rab_fwd_bf16": n_layers, "hstu_rab_bwd_dq_bf16": n_layers, "hstu_rab_bwd_dkv_bf16": n_layers}
    if split_counts != expected or not math.isfinite(split_loss):
        raise AssertionError(f"the bf16 split step did not run K1-bf16, K2a-bf16 and K2b-bf16 once per layer: {split_counts}, expected {expected}; loss {split_loss}")
    # the layers' backward (a cotangent on the hidden states) through K2-bf16 and through K2a-bf16 + K2b-bf16
    cotangent = torch.from_numpy(np.random.default_rng(2).normal(size=(BATCH, l, SERVE["d_model"])).astype(np.float32)).cuda().to(torch.bfloat16)

    def layers(backward, split=False):
        rab._FUSED_BWD[0] = not split
        try:
            tr.optimizer.zero_grad(set_to_none=True)
            with precision_scope("bf16"):
                hidden = tr.model(toks, tds, return_hidden=True, generator=tr.generator)["hidden"]
            if backward:
                hidden.backward(cotangent)
        finally:
            rab._FUSED_BWD[0] = True

    tr.model.train()
    t = {key: timed(fn, cycles_per_ms) for key, fn in (("forward", lambda: layers(False)), ("fused", lambda: layers(True)), ("split", lambda: layers(True, split=True)))}
    for key, stage in (("forward", f"forward, {n_layers} HSTU layers (hidden states, autograd on)"), ("fused", "forward + backward of the hidden states through K2-bf16"),
                       ("split", "forward + backward of the hidden states through K2a-bf16 + K2b-bf16 (_FUSED_BWD[0] = False)")):
        print(f"  stage {stage} (bf16): device {t[key][0]:.4f} ms, host clock {t[key][1]:.4f} ms (medians of {REPS})")
    print(f"  the layers' backward by difference (bf16, device ms): through K2-bf16 {t['fused'][0] - t['forward'][0]:.4f}, "
          f"through K2a-bf16 + K2b-bf16 {t['split'][0] - t['forward'][0]:.4f}")
    del trainers, tr
    gc.collect()
    torch.cuda.empty_cache()

    # one step of each loss on the card against the CPU's plain bf16 path, B2
    b = 2
    toks, _, tgts, tds = serving_data(b, l, vocab, seed=3, pad=True)
    negs = np.random.default_rng(4).integers(1, vocab, HSTU_SAMPLED["num_negatives"])
    for name, kw in kinds.items():
        def build(device, kw=kw):
            return SeqTrainer(HSTUModel(**SERVE, generator=torch.Generator().manual_seed(2)), precision="bf16", device=device, **kw)

        def loss_of(trainer, device):
            return trainer.loss_fn(*(torch.from_numpy(a).to(device) for a in (toks, tds, tgts)))

        with given_negatives(negs):
            bf16_against_cpu(f"HSTU {name} B{b}", build, loss_of)
        if name == "chunked 8192":  # and through the split backward: K2a-bf16 + K2b-bf16 on the card
            rab._FUSED_BWD[0] = False
            try:
                bf16_against_cpu(f"HSTU {name} B{b}, _FUSED_BWD[0] = False", build, loss_of)
            finally:
                rab._FUSED_BWD[0] = True
    gc.collect()

    # fit: successor histories (each user's items run s, s + 1, ... through a window of ids; the target is the
    # next), a rule the model must learn from the data, held out on other users' starts
    f = BF16_HSTU_FIT
    rng = np.random.default_rng(5)
    start = rng.integers(0, f["window"], f["users"] + 256)
    ids = (start[:, None] + np.arange(l + 1)[None, :]) % f["window"] + 1
    hist = (ids[:, :l].astype(np.int32), np.broadcast_to(np.arange(l, dtype=np.int32), (len(start), l)).copy(), ids[:, l].astype(np.int32),
            np.broadcast_to((l - 1 - np.arange(l)) * 60, (len(start), l)).astype(np.int32).copy())
    train = SeqLoader(*(a[: f["users"]] for a in hist), batch_size=BATCH)
    test = SeqLoader(*(a[f["users"]:] for a in hist), batch_size=BATCH)
    tr = SeqTrainer(HSTUModel(**SERVE, generator=torch.Generator().manual_seed(6), device="cuda"), n_epoch=f["epochs"], vocab_chunk_size=8192, precision="bf16", model_path=HLLM_MODEL_PATH + "_hstu_bf16")
    before = tr.evaluate(test)[1]
    t1 = time.perf_counter()
    tr.fit(train)
    after = tr.evaluate(test)[1]
    chance = 1 / (vocab - 1)
    print(f"  fit (bf16), {f['epochs']} epochs of {f['users']} successor histories over {f['window']} ids, chunked 8192: held-out top-1 {after:.4f} (before {before:.4f}; chance {chance:.2e}, "
          f"{f['chance_times']}x chance {f['chance_times'] * chance:.2e}), {time.perf_counter() - t1:.1f} s")
    if not after > f["chance_times"] * chance:
        raise AssertionError(f"bf16 HSTU fit: top-1 {after} not above {f['chance_times']}x chance")
    print(f"  bf16 HSTU phase: {time.perf_counter() - t0:.1f} s")
    return {**{k: serve_counts[k] + train_counts[k] for k in ("hstu_rab_fwd_bf16", "hstu_rab_bwd_bf16")},
            **{k: split_counts[k] for k in ("hstu_rab_bwd_dq_bf16", "hstu_rab_bwd_dkv_bf16")}}


def bf16_ctr_match_mtl_phase():
    """DeepFM at bench.py's small config under CTRTrainer(precision="bf16"): examples/s of train_one_epoch, a step's
    device time, host clock, idle share and launches, one step card against CPU, fit above a test AUC of 0.65;
    DSSM with in-batch negatives and MMOE under UWL and MetaBalance: one step each card against CPU."""
    t0 = time.perf_counter()
    b, small = CTR["batch"], [CTR["vocab"]] * CTR["n_sparse"]
    x, y = ctr_data(CTR_TRAIN_BATCHES * b, small, seed=3)
    trainer = CTRTrainer(ctr_model(small, seed=1, device=CARD), optimizer_params=CTR_OPT, precision="bf16")
    loader = ArrayLoader(x, y, batch_size=b)
    trainer.train_one_epoch(loader, log_interval=0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loss = trainer.train_one_epoch(loader, log_interval=0)
    seconds = time.perf_counter() - t1
    print(f"  DeepFM training (bf16, ArrayLoader): loss {loss:.6f}, {CTR_TRAIN_BATCHES * b / seconds:,.0f} examples/s, {seconds / CTR_TRAIN_BATCHES * 1e3:.3f} ms per step of {b}")
    yb, wb = torch.as_tensor(y[:b], device=CARD), torch.ones(b, device=CARD)
    batch = {k: torch.as_tensor(x[k][:b], device=CARD) for k in x}
    device, wall, launched = step_stats("DeepFM B4096 (bf16)", lambda: trainer.train_step(batch, yb, wb))
    print(f"  a DeepFM step (bf16): device {device:.4f} ms (torch.profiler kernels, 3 steps), host clock {wall:.4f} ms (median of 10), device idle {1 - device / wall:.0%}, {launched:.1f} launches")
    check_f32_state("DeepFM", trainer)
    xs, ys = ctr_data(b, small, seed=4)

    def ctr_loss(tr, d):
        return tr.loss_fn({k: torch.from_numpy(v).to(d) for k, v in xs.items()}, torch.from_numpy(ys).to(d), torch.ones(b, device=d))

    bf16_against_cpu(f"DeepFM B{b}", lambda d: CTRTrainer(ctr_model(small, seed=2, device="cpu"), optimizer_params=CTR_OPT, precision="bf16", device=d), ctr_loss)
    x, _ = ctr_data(CTR_FIT_BATCHES * b, small, seed=5)
    y = ((x["C0"] % 2) + x["I0"] > 0.5).astype(np.float32)
    train, val, test = DataGenerator(x, y, seed=0).generate_dataloader(split_ratio=[0.7, 0.15], batch_size=b)
    fit = CTRTrainer(ctr_model(small, seed=5, device=CARD), optimizer_params=CTR_OPT, n_epoch=3, model_path=CTR_MODEL_PATH + "_bf16", precision="bf16")
    fit.fit(train, val, log_interval=0)
    auc = fit.evaluate(fit.model, test)
    print(f"  DeepFM fit (bf16), 3 epochs of {train.n} rows: test AUC {auc:.5f}")
    if not auc > 0.65:
        raise AssertionError(f"bf16 DeepFM fit reached a test AUC of {auc}, not above 0.65")

    mb = 256
    mx, _ = match_data(mb, seed=6)

    def redrawn(model, seed):  # tables at N(0, 0.3²): at their 1e-4 start every score is near 0 and bf16 rounds nothing
        with torch.no_grad():
            redraw_tables(model, seed)
        return model

    def dssm_loss(tr, d):
        return tr.loss_fn({k: torch.from_numpy(v).to(d) for k, v in mx.items()}, None, torch.ones(mb, device=d))

    bf16_against_cpu(f"DSSM in-batch B{mb}", lambda d: MatchTrainer(redrawn(match_model("DSSM", seed=7, device="cpu"), 7), mode=2, in_batch_neg=True, optimizer_params=CTR_OPT, precision="bf16", device=d),
                     dssm_loss)
    tx, tys = mtl_data(MTL["batch"], seed=8)
    for method in ("uwl", "metabalance"):
        def build(d, method=method):
            return MTLTrainer(redrawn(mtl_model("MMOE", seed=9, device="cpu"), 9), MTL_TASKS, adaptive_params={"method": method}, optimizer_params=CTR_OPT, precision="bf16", device=d)

        def mtl_loss(tr, d):
            losses = tr.task_losses(tr.model({k: torch.from_numpy(v).to(d) for k, v in tx.items()}), torch.from_numpy(tys).to(d), torch.ones(MTL["batch"], device=d))
            return mtl_trainer._aggregate_losses(losses, tr.loss_weight, tr.adaptive_method, False)

        bf16_against_cpu(f"MMOE {method} B{MTL['batch']}", build, mtl_loss)
        tr = build(CARD)
        losses = tr.train_one_epoch(ArrayLoader(tx, tys, batch_size=MTL["batch"]), log_interval=0)
        check_f32_state(f"MMOE {method} after train_one_epoch", tr)
        if not np.all(np.isfinite(losses)):
            raise AssertionError(f"MMOE {method} (bf16): non-finite losses {losses}")
    print(f"  bf16 DeepFM, DSSM and MMOE phase: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# 16. the trainer lifecycle: step checkpoints and exact resume, export, profiling
# ---------------------------------------------------------------------------

LIFECYCLE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_lifecycle")
LIFE = dict(steps=8, half=4, ctr_steps=16, ctr_every=8, ctr_epochs=5)
# a resumed HSTU run through K2 lies within the run-to-run spread: its distance from either straight run,
# ||a - b|| / ||b|| over all parameters (rel_l2), is at most twice the two straight runs'.  K2 adds dq with
# red.global.add (and the embedding backward adds with atomics outside deterministic algorithms): the spread is not 0.
# Through K2a + K2b under deterministic algorithms every sum has a fixed order and the runs agree bit for bit.
# rel_l2 sums over every element that those atomics move, so it varies
# by 1.3x at most between pairs of runs, while rel_diff, one element's largest step (always in token_embedding, where
# Adam moves a near-zero gradient either way), varies by 3x, so that one pair of it against another fails a correct
# resume by chance; a resume that loses Adam's moments moves rel_l2 by 1e5x (tools/hstu_resume_spread.py)
SPREAD_FACTOR = 2.0
# an exported program runs the model's own operations and K1: within 1e-6 of the largest eager logit
EXPORT_ATOL_REL = 1e-6


def rel_diff(a, b):
    """``(the largest over the tensors of max |a - b| / max |b|, that tensor's name)``."""
    return max((float((a[k] - b[k]).abs().max()) / max(float(b[k].abs().max()), 1e-30), k) for k in b)


def rel_l2(a, b):
    """``||a - b|| / ||b||`` over all the tensors at once, in float64."""
    num = sum(float((a[k].double() - b[k].double()).square().sum()) for k in b)
    return math.sqrt(num / max(sum(float(b[k].double().square().sum()) for k in b), 1e-300))


@contextlib.contextmanager
def deterministic_algorithms():
    """``torch.use_deterministic_algorithms(True)`` with cuBLAS's deterministic workspace (which it requires); both
    restored on exit.  The rab backward then takes the split pair K2a + K2b (``_RabAttentionKernel``)."""
    prior = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        if prior is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = prior


def check_equal(label, runs):
    """Every run's tensors equal the first run's bit for bit: ``runs`` is ``{label: {name: tensor}}``."""
    (first_label, first), *rest = runs.items()
    differ = {lb: [k for k in first if not torch.equal(run[k], first[k])] for lb, run in rest}
    print(f"  {label}: " + "; ".join(f"{lb}: {len(d)} of {len(first)} tensors differ from {first_label}" for lb, d in differ.items()))
    if any(differ.values()):
        raise AssertionError(f"{label}: the runs differ: {differ}")


def params_of(trainer):
    out = {k: v.detach().clone() for k, v in trainer.model.named_parameters()}
    out.update({f"accum:{k}": v.detach().clone() for k, v in trainer.sparse_accums.items()})
    return out


def state_mismatches(a, b):
    """The paths at which two train states differ (tensors by ``torch.equal``, on their devices)."""
    fa, fb = dict(flat_tensors(a)), dict(flat_tensors(b))
    if fa.keys() != fb.keys():
        return sorted(fa.keys() ^ fb.keys())
    return [k for k, v in fa.items() if not (torch.equal(v, fb[k]) and v.device == fb[k].device if isinstance(v, torch.Tensor) else v == fb[k])]


def check_resume(label, straight, resumed):
    """The resumed run's parameters against two straight runs': ``rel_l2`` held to the spread, ``rel_diff`` shown."""
    spread, got = rel_l2(straight[1], straight[0]), max(rel_l2(resumed, s) for s in straight)
    (d_spread, at_s), (d_got, at_g), (d_got2, _) = rel_diff(straight[1], straight[0]), rel_diff(resumed, straight[0]), rel_diff(resumed, straight[1])
    print(f"  {label}: ||a - b|| / ||b|| over the {len(resumed)} tensors: the resumed run against the farther straight run {got:.3e}, the two straight runs {spread:.3e} "
          f"(the bound {SPREAD_FACTOR:g} x the spread); each tensor's max |d| over its max, the largest: resumed vs straight run 1 {d_got:.3e} ({at_g}), "
          f"vs run 2 {d_got2:.3e}, the two straight runs {d_spread:.3e} ({at_s})")
    if got > SPREAD_FACTOR * spread:
        raise AssertionError(f"{label}: the resumed run differs from a straight one by {got:.3e}, beyond {SPREAD_FACTOR:g} x the run-to-run spread {spread:.3e}")


def lifecycle_hstu(cycles_per_ms, directory):
    """The serving HSTU through SeqTrainer (chunked 8192, dropout 0): 8 steps straight twice, 4 + a checkpoint + a
    fresh trainer resumed + 4, on the fused backward (K2: within twice the run-to-run spread, K2's dq being summed in
    a varying order) and the split one (K2a + K2b under deterministic algorithms: bit for bit); the state's round
    trip bit for bit, the checkpoint's bytes and save / restore time; then export, int8 and fp16 export of the trained model,
    one request of B8 x L256 through each program; the registered op's dispatch cost; a traced step."""
    l, vocab, n_layers = SERVE["max_seq_len"], SERVE["vocab_size"], SERVE["n_layers"]
    data = serving_data(BATCH * LIFE["steps"], l, vocab, seed=11, pad=False)
    half = BATCH * LIFE["half"]
    loaders = {"all": SeqLoader(*data, batch_size=BATCH), "first": SeqLoader(*(a[:half] for a in data), batch_size=BATCH),
               "second": SeqLoader(*(a[half:] for a in data), batch_size=BATCH)}

    def build():
        return SeqTrainer(HSTUModel(**SERVE, generator=torch.Generator().manual_seed(11), device=CARD), vocab_chunk_size=8192)

    total = {k: 0 for k in COUNTERS}

    def take():
        """The launches since the last take (added to the phase's total), the counts set to 0."""
        counts = read_counts()
        reset_counts()
        for k, v in counts.items():
            total[k] += v
        return counts

    trained = None
    steps = 2 * LIFE["steps"] + 2 * LIFE["half"]
    reset_counts()
    for fused, kernels in ((True, "K2"), (False, "K2a + K2b")):
        ckpt_dir = os.path.join(directory, f"hstu_{'fused' if fused else 'split'}")
        rab._FUSED_BWD[0] = fused
        with contextlib.ExitStack() as stack:
            stack.callback(rab._FUSED_BWD.__setitem__, 0, True)
            if not fused:
                stack.enter_context(deterministic_algorithms())
            straight = []
            for _ in range(2):
                tr = build()
                tr.train_one_epoch(loaders["all"], log_interval=0)
                straight.append(params_of(tr))
                del tr
            first = build()
            ckpt = first.enable_step_checkpointing(ckpt_dir, every_n_steps=LIFE["half"], max_to_keep=1)
            first.train_one_epoch(loaders["first"], log_interval=0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            first.maybe_step_checkpoint()
            save_s = time.perf_counter() - t0
            nbytes = os.path.getsize(ckpt.path(LIFE["half"]))
            resumed = build()
            resumed.enable_step_checkpointing(ckpt_dir, every_n_steps=LIFE["half"], max_to_keep=1)
            t0 = time.perf_counter()
            step = resumed.maybe_resume()
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            bad = state_mismatches(resumed.train_state(), first.train_state())
            print(f"  HSTU through {kernels}: checkpoint of step {step}, {nbytes:,} bytes (the model, Adam's moments, the step), saved in {save_s * 1e3:.1f} ms, "
                  f"restored in {restore_s * 1e3:.1f} ms; the state's round trip: {len(bad)} of {len(list(flat_tensors(first.train_state())))} leaves differ")
            if step != LIFE["half"] or bad:
                raise AssertionError(f"HSTU ({kernels}): the resumed state is not the saved one bit for bit: step {step}, {bad[:5]}")
            del first
            resumed.train_one_epoch(loaders["second"], log_interval=0)
            if fused:
                check_resume(f"HSTU through {kernels}, {LIFE['steps']} steps", straight, params_of(resumed))
            else:
                check_equal(f"HSTU through {kernels} under deterministic algorithms, {LIFE['steps']} steps",
                            {"the first straight run": straight[0], "the second straight run": straight[1], "the resumed run": params_of(resumed)})
        counts = take()
        expected = {**{k: 0 for k in COUNTERS}, "hstu_rab_fwd": n_layers * steps, **({"hstu_rab_bwd": n_layers * steps} if fused else {"hstu_rab_bwd_dq": n_layers * steps, "hstu_rab_bwd_dkv": n_layers * steps})}
        print(f"  HSTU through {kernels}: launches over {steps} steps, {n_layers} layers: " + ", ".join(f"{k} {v}" for k, v in counts.items() if v))
        if counts != expected:
            raise AssertionError(f"the resume runs did not launch each kernel once per layer per step: {counts}, expected {expected}")
        shutil.rmtree(ckpt_dir)
        if fused:
            trained = resumed
        del straight, resumed
        torch.cuda.empty_cache()

    # the registered op: its dispatcher's host cost against the ctypes launch it wraps, at the serving shape (a
    # measurement beside the path: its launches are not counted)
    c = rab_case(21, BATCH, l, l)
    args = (c["q"], c["k"], c["v"], c["pos_w"], c["ts_w"], c["ts"], c["mask"], c["thr"], c["alpha"], c["max_seq_len"], c["cfg"])
    host_us = {}
    for name, fn in (("registered op", rab._op_forward), ("ctypes launch", rab._launch)):
        for _ in range(3):
            fn(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn(*args)
        host_us[name] = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
    reset_counts()
    print(f"  K1 at B{BATCH} H8 L{l} d32, host time to enqueue one call (mean of 200): the registered op {host_us['registered op']:.1f} us, the ctypes launch alone "
          f"{host_us['ctypes launch']:.1f} us: the dispatcher adds {host_us['registered op'] - host_us['ctypes launch']:.1f} us a call, {n_layers} calls a forward")
    # the chunked step with K1 through the registered op, and through the ctypes launch alone, in turn
    toks, _, tds, tgts = (torch.from_numpy(a).to(CARD) for a in next(iter(loaders["first"])))
    via_op = rab._op_forward
    for label in ("the registered op", "the ctypes launch alone", "the registered op"):
        rab._op_forward = via_op if label == "the registered op" else rab._launch
        try:
            device, wall = timed(lambda: trained.train_step(toks, tds, tgts), cycles_per_ms)
        finally:
            rab._op_forward = via_op
        print(f"  chunked 8192 train_step, K1 through {label}: device {device:.4f} ms, host clock {wall:.4f} ms, device idle {1 - device / wall:.0%} (medians of {REPS})")

    # export the trained model and serve one request through each program
    request = (toks, tds)
    take()
    path = trained.export(os.path.join(directory, "hstu"), example_input=request)
    traced = take()["hstu_rab_fwd"]
    run, _ = texport.load_exported(path)
    out = run(request)
    torch.cuda.synchronize()
    per_call = take()["hstu_rab_fwd"]
    with torch.inference_mode():
        trained.model.eval()
        eager = trained.model(toks, tds)
    err, largest = float((out - eager).abs().max()), float(eager.abs().max())
    program_ms = timed(lambda: run(request), cycles_per_ms)
    with torch.inference_mode():
        eager_ms = timed(lambda: trained.model(toks, tds), cycles_per_ms)
    evaluate_ms = wall_ms(lambda: trained.evaluate(SeqLoader(*(a[:BATCH] for a in data), batch_size=BATCH)))
    print(f"  export: {os.path.getsize(path):,} bytes, {traced} launches while tracing; one request of {BATCH} x L{l}: {per_call} hstu_rab_fwd launches a call, "
          f"max |program - eager| {err:.3e} of the largest logit {largest:.3e} (bound {EXPORT_ATOL_REL:g} x); the program {program_ms[0]:.4f} ms device, {program_ms[1]:.4f} ms host clock "
          f"a request; the eager forward {eager_ms[0]:.4f} / {eager_ms[1]:.4f} ms; SeqTrainer.evaluate {evaluate_ms:.4f} ms a request (host clock, with its loss and top-1)")
    if traced or per_call != n_layers or not err <= EXPORT_ATOL_REL * largest or out.shape != (BATCH, l, vocab):
        raise AssertionError(f"the exported HSTU: {traced} launches while tracing, {per_call} a call (expected {n_layers}), error {err:.3e} of {largest:.3e}")
    params = dict(trained.model.named_parameters())
    rows = texport.linear_weight_names(trained.model)
    for quant_mode in ("int8", "fp16"):
        qpath = trained.export_quantized(os.path.join(directory, f"hstu_{quant_mode}"), example_input=request, quant_mode=quant_mode)
        qrun, _ = texport.load_exported(qpath)
        take()
        qout = qrun(request)
        torch.cuda.synchronize()
        q_launches = take()["hstu_rab_fwd"]
        qerr = texport.quantization_error(params, quant_mode, rows)
        k = sum(p.ndim == 2 for p in params.values()) if quant_mode == "int8" else len(params)
        diff, q_ms = float((qout - out).abs().max()), timed(lambda: qrun(request), cycles_per_ms)
        print(f"  export_quantized {quant_mode}: {os.path.getsize(qpath):,} bytes against {os.path.getsize(path):,} ({os.path.getsize(qpath) / os.path.getsize(path):.3f}); "
              f"{q_launches} hstu_rab_fwd launches a call; max |{quant_mode} - fp32| {diff:.3e}, bound {k} quantized tensors x quantization_error {qerr:.3e} x the largest "
              f"logit = {k * qerr * largest:.3e}; {q_ms[0]:.4f} ms device, {q_ms[1]:.4f} ms host clock a request")
        if q_launches != n_layers or not 0 < diff <= k * qerr * largest or not os.path.getsize(qpath) < os.path.getsize(path):
            raise AssertionError(f"the {quant_mode} export: {q_launches} launches, difference {diff:.3e}, {os.path.getsize(qpath)} bytes")
    del run, out, eager

    # one traced step: the trace names K1's and K2's kernels and the annotated span
    trace_dir = os.path.join(directory, "trace")
    trained.model.train()
    torch.cuda.reset_peak_memory_stats()
    with trace(trace_dir):
        with annotate("lifecycle/hstu_train_step"):
            trained.train_step(toks, tds, tgts)
    with open(os.path.join(trace_dir, "trace.json")) as f:
        text = f.read()
    need = {"K1": "hstu_rab_fwd_kernel", "K2": "bwd_fused_kernel<", "the annotated span": "lifecycle/hstu_train_step"}
    missing = [k for k, key in need.items() if key not in text]
    peak = device_memory_stats()[f"cuda:{torch.cuda.current_device()}"]["allocated_bytes.all.peak"]
    print(f"  trace of one step: {len(text):,} bytes of Chrome trace naming " + ", ".join(f"{k} ({key!r})" for k, key in need.items() if k not in missing)
          + f"; peak allocated over the step {peak / 1e9:.3f} GB (device_memory_stats)")
    if missing:
        raise AssertionError(f"the trace does not name {missing}")
    take()
    del trained
    torch.cuda.empty_cache()
    return total


def lifecycle_ctr(directory):
    """DeepFM at the Criteo-full geometry with sparse Adagrad on the prefetching loop (ArrayLoader): examples/s and
    idle against synchronous copies; step checkpoints every 8 steps, one kept; resume against two straight runs."""
    b, n_steps, every = CTR["batch"], LIFE["ctr_steps"], LIFE["ctr_every"]
    x, y = ctr_data(n_steps * b, VOCABS_FULL, seed=12, zipf=True)
    half = n_steps * b // 2
    loaders = {"all": ArrayLoader(x, y, batch_size=b), "first": ArrayLoader({k: v[:half] for k, v in x.items()}, y[:half], batch_size=b),
               "second": ArrayLoader({k: v[half:] for k, v in x.items()}, y[half:], batch_size=b)}

    def build():
        return CTRTrainer(ctr_model(VOCABS_FULL, seed=12, device=CARD), optimizer_params=CTR_OPT, sparse_embedding="adagrad")

    tr = build()
    tr.train_one_epoch(loaders["all"], log_interval=0)  # warm-up: the allocator, Adam's state, pinned buffers
    # the loop's own prefetching, and synchronous copies (each host group copied when the loop takes it), epochs in turn
    ways = {"prefetch_to_device two groups ahead": tr._groups, "synchronous copies": lambda loader: (tr._to_device(*group) for group in tr._iter_groups(loader))}
    seconds = {name: [] for name in ways}
    for _ in range(LIFE["ctr_epochs"]):
        for name, groups in ways.items():
            tr._groups = groups
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.train_one_epoch(loaders["all"], log_interval=0)
            seconds[name].append(time.perf_counter() - t0)
    for name, groups in ways.items():
        tr._groups = groups
        device = sum(ms for ms, _ in profile_kernels(lambda: tr.train_one_epoch(loaders["all"], log_interval=0), steps=1).values())
        med = float(np.median(seconds[name]))
        print(f"  DeepFM Criteo-full sparse adagrad on ArrayLoader, {name}: {n_steps * b / med:,.0f} examples/s, {med / n_steps * 1e3:.3f} ms per step "
              f"(host clock, median of {LIFE['ctr_epochs']} epochs of {n_steps} steps, the two ways in turn; epochs {min(seconds[name]) * 1e3:.1f}-{max(seconds[name]) * 1e3:.1f} ms), "
              f"an epoch's kernels {device:.3f} ms of device time, device idle {1 - device / (med * 1e3):.0%}")
    del tr
    torch.cuda.empty_cache()

    # the resume, bit for bit.  With index_add_'s float atomics two straight runs differ, and not by a stable spread:
    # on the H100 they land in two clusters 2.7e-3 apart (on a BatchNorm bias, as Adam's step of a near-zero gradient
    # goes either way) and 5e-6 to 6e-4 apart inside one, resumed runs in either (tools/ctr_lifecycle_diagnostics.py).
    # Under torch.use_deterministic_algorithms every operation of the step is deterministic, so the straight runs
    # agree bit for bit and the resumed run must equal them
    with deterministic_algorithms():
        straight, resumed = lifecycle_ctr_runs(build, loaders, directory, every, n_steps)
    differ = {label: [k for k in run if not torch.equal(run[k], straight[0][k])] for label, run in (("the second straight run", straight[1]), ("the resumed run", resumed))}
    print(f"  DeepFM Criteo-full, {n_steps} steps under torch.use_deterministic_algorithms: " + "; ".join(f"{label}: {len(d)} of {len(run)} tensors differ from the first straight run"
                                                                                                       for (label, d), run in zip(differ.items(), (straight[1], resumed)))
          + f" (the parameters, the fused table's accumulators)")
    if any(differ.values()):
        raise AssertionError(f"DeepFM Criteo-full: the runs differ under deterministic algorithms: {differ}")
    del resumed, straight
    torch.cuda.empty_cache()


def lifecycle_ctr_runs(build, loaders, directory, every, n_steps):
    """Two straight runs (the first checkpointing every ``every`` steps, one kept: the steps saved, the file kept,
    bytes and seconds) and a resumed one (``every`` steps, its own checkpoint, a fresh trainer, ``maybe_resume``,
    the rest); returns their ``params_of``."""
    straight = []
    for i in range(2):
        tr = build()
        if i == 0:  # checkpoints every 8 steps, one kept
            ckpt_dir = os.path.join(directory, "ctr_straight")
            ckpt = tr.enable_step_checkpointing(ckpt_dir, every_n_steps=every, max_to_keep=1)
            saves, save = [], ckpt.save

            def timed_save(step, state, save=save, saves=saves):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                path = save(step, state)
                saves.append((step, time.perf_counter() - t0, os.path.getsize(path)))
                return path

            ckpt.save = timed_save
        tr.train_one_epoch(loaders["all"], log_interval=0)
        if i == 0:
            kept = sorted(os.listdir(ckpt_dir))
            print(f"  step checkpoints every {every} steps over {n_steps}, max_to_keep=1: saved at steps {[s for s, _, _ in saves]} "
                  + ", ".join(f"{nb:,} bytes in {sec:.3f} s" for _, sec, nb in saves) + f" (the table, its row accumulators, the rest and its Adam state); kept {kept}")
            if [s for s, _, _ in saves] != list(range(every, n_steps + 1, every)) or kept != [f"ckpt_{n_steps}.pt"]:
                raise AssertionError(f"the CTR loop's checkpoints: saved {saves}, kept {kept}")
            shutil.rmtree(ckpt_dir)
        straight.append(params_of(tr))
        del tr
        torch.cuda.empty_cache()
    ckpt_dir = os.path.join(directory, "ctr_resume")
    first = build()
    first.enable_step_checkpointing(ckpt_dir, every_n_steps=every, max_to_keep=1)
    first.train_one_epoch(loaders["first"], log_interval=0)  # checkpoints itself at step 8
    del first
    torch.cuda.empty_cache()
    resumed = build()
    resumed.enable_step_checkpointing(ckpt_dir, every_n_steps=every, max_to_keep=1)
    t0 = time.perf_counter()
    step = resumed.maybe_resume()
    torch.cuda.synchronize()
    print(f"  resumed at step {step} in {time.perf_counter() - t0:.3f} s")
    if step != every:
        raise AssertionError(f"the CTR run resumed at step {step}, not {every}")
    resumed.train_one_epoch(loaders["second"], log_interval=0)
    shutil.rmtree(ckpt_dir)
    return straight, params_of(resumed)


def lifecycle_phase(cycles_per_ms):
    """The lifecycle phase: HSTU's resume, export and trace (K1, K2, K2a, K2b), then DeepFM's checkpoints on the
    prefetching loop (none of the port's kernels); returns the HSTU part's launches."""
    t0 = time.perf_counter()
    os.makedirs(LIFECYCLE_DIR, exist_ok=True)
    try:
        launches = lifecycle_hstu(cycles_per_ms, LIFECYCLE_DIR)
        print("  the HSTU lifecycle's launches (resume runs, a timed step, export and serving, the traced step): " + ", ".join(f"{k} {v}" for k, v in launches.items() if v))
        reset_counts()
        lifecycle_ctr(LIFECYCLE_DIR)
        if any(read_counts().values()):
            raise AssertionError(f"the DeepFM lifecycle launched an HSTU kernel: {read_counts()}")
    finally:
        shutil.rmtree(LIFECYCLE_DIR, ignore_errors=True)
    print(f"  lifecycle phase: {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# 16. The (data, model) mesh: ranks started by parallel.distributed.spawn
# ---------------------------------------------------------------------------

MESH_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_mesh")
MESH = dict(steps=4, vocab=65536, topk_items=1_000_000, topk_users=2048, topk_dim=64, topk_batch=512, k=10, ctr_steps=4)
# tests/test_sharding.py's tolerances: HSTU (:255) loss rtol, parameters rtol / atol; the sparse DeepFM (:402)
MESH_HSTU_TOL = (3e-4, 3e-3, 3e-4)
MESH_CTR_TOL = (2e-4, 2e-3, 2.5e-3)


def mesh_hstu(vocab, seed):
    return HSTUModel(**{**SERVE, "vocab_size": vocab}, generator=torch.Generator().manual_seed(seed), device=CARD)


def mesh_state(trainer):
    """The unsharded parameters and sparse accumulators of a trainer, on the card (a collective under a mesh)."""
    st = trainer.train_state()
    out = {k: v for k, v in st["model"].items() if k in dict(trainer.model.named_parameters())}
    out.update({f"accum:{k}": v for k, v in st["sparse_accums"].items()})
    return out


def mesh_compare(label, got, ref, loss, ref_loss, tol, lr_steps=0.0, still=None):
    """``got`` against ``ref``: the loss at rtol ``tol[0]``, every tensor at rtol / atol ``tol[1:]``; a Dense bias in
    front of a BatchNorm (its exact gradient is 0: Adam moves it by noise) within ``lr_steps`` more, and the rows that
    ``still`` names (``{tensor: (row indices, slack)}``, rows whose exact gradient is 0) within their slack more."""
    loss_rtol, rtol, atol = tol
    bad, invariant = [], shift_invariant(set(ref))
    if not np.allclose(loss, ref_loss, rtol=loss_rtol, atol=0.0):
        bad.append(f"loss {loss} vs {ref_loss}")
    worst = (0.0, "")
    for k, r in ref.items():
        g = got[k].to(r.device)
        slack = lr_steps if k in invariant else 0.0
        if still and k in still:
            rows, extra = still[k]
            slack = torch.zeros(r.shape[:1] + (1,) * (r.ndim - 1), device=r.device)
            slack[rows] = extra
        excess = float(((g - r).abs() - (atol + slack + rtol * r.abs())).max())
        if not (isinstance(slack, torch.Tensor) or slack):  # the noise-moved tensors aside
            worst = max(worst, (float((g - r).abs().max()) / max(float(r.abs().max()), 1e-30), k))
        if excess > 0:
            bad.append(f"{k} by {excess:.3e}")
    print(f"    {label}: loss {np.round(loss, 7).tolist()} (mesh=None {np.round(ref_loss, 7).tolist()}); the largest difference {worst[0]:.3e} of a tensor's largest value ({worst[1]}; "
          f"the tensors with an exact gradient of 0 aside); "
          f"{len(ref)} tensors within rtol {rtol:g} atol {atol:g}: {'yes' if not bad else 'NO'}")
    if bad:
        raise AssertionError(f"{label} does not match mesh=None: {bad[:5]}")


def mesh_world_of_one():
    """(a) A world of one over NCCL, this process its rank: the serving HSTU under mesh=None and under the (1, 1)
    mesh.  Under ``torch.use_deterministic_algorithms`` (the embedding backward's atomics otherwise make two mesh=None
    runs differ; the rab backward takes K2a + K2b, whose every sum has a fixed order): one step's gradients, and four
    steps' parameters, equal to mesh=None's bit for bit, the rab tables' too.  Four steps through K2 (deterministic
    algorithms off, since they would take the split pair): within twice the spread of two mesh=None runs
    (``rel_l2``), K2's dq being summed in a varying order.  Returns the mesh runs' launches."""
    from torch_rechub_tpu_torch.parallel import create_mesh
    from torch_rechub_tpu_torch.parallel import distributed as pdist

    pdist.initialize(f"file://{os.path.join(MESH_DIR, 'store')}", 1, 0, backend="nccl")
    try:
        mesh = create_mesh(1, 1)
        print(f"  (a) {mesh}")
        l, n_layers, steps = SERVE["max_seq_len"], SERVE["n_layers"], MESH["steps"]
        data = serving_data(BATCH * steps, l, SERVE["vocab_size"], seed=13)
        loaders = {1: SeqLoader(*(a[:BATCH] for a in data), batch_size=BATCH), steps: SeqLoader(*data, batch_size=BATCH)}
        counts = {k: 0 for k in COUNTERS}

        def run(with_mesh, n):
            """(loss, parameters, gradients, ms a step of host clock) of ``n`` steps of a fresh trainer; the mesh
            run's launches counted."""
            tr = SeqTrainer(mesh_hstu(SERVE["vocab_size"], 13), vocab_chunk_size=8192, mesh=mesh if with_mesh else None, model_path=MESH_DIR)
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            loss = tr.train_one_epoch(loaders[n], log_interval=0)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / n * 1e3
            if with_mesh:
                for k, v in read_counts().items():
                    counts[k] += v
            return loss, params_of(tr), {k: p.grad for k, p in tr.model.named_parameters() if p.grad is not None}, ms

        with deterministic_algorithms():
            (_, _, g0, _), (_, _, g1, _), (_, _, gm, _) = run(False, 1), run(False, 1), run(True, 1)
            differ, straight = [k for k in g0 if not torch.equal(gm[k], g0[k])], [k for k in g0 if not torch.equal(g1[k], g0[k])]
            print(f"    one step through K2a + K2b: the mesh's gradients against mesh=None's: {len(g0) - len(differ)} of {len(g0)} equal bit for bit; differ: {differ or 'none'} "
                  f"(between two mesh=None steps: {straight or 'none'})")
            if differ or straight:
                raise AssertionError(f"(a) the (1, 1) mesh's gradients differ from mesh=None's, or two mesh=None runs from each other: {differ}, {straight}")
            straight = [run(False, steps) for _ in range(2)]
            loss, got, _, ms = run(True, steps)
            print(f"    {steps} steps through K2a + K2b: loss {loss:.7f} (mesh=None {straight[0][0]:.7f}, {straight[1][0]:.7f}); a step {ms:.2f} ms of host clock with the mesh, "
                  f"{straight[1][3]:.2f} without")
            check_equal(f"  {steps} steps through K2a + K2b, parameters", {"the first mesh=None run": straight[0][1], "the second": straight[1][1], "the mesh run": got})
        kernels = "K2"  # deterministic algorithms off: they would take the split pair
        straight = [run(False, steps) for _ in range(2)]
        loss, got, _, ms = run(True, steps)
        spread, diff = rel_l2(straight[1][1], straight[0][1]), max(rel_l2(got, s[1]) for s in straight)
        (d_spread, at_s), (d_diff, at_d) = rel_diff(straight[1][1], straight[0][1]), min(rel_diff(got, straight[0][1]), rel_diff(got, straight[1][1]))
        print(f"    {steps} steps through {kernels}: loss {loss:.7f} (mesh=None {straight[0][0]:.7f}, {straight[1][0]:.7f}); a step {ms:.2f} ms of host clock with the mesh, "
              f"{straight[1][3]:.2f} without; ||a - b|| / ||b||: the mesh run against the farther mesh=None run {diff:.3e}, the two mesh=None runs {spread:.3e}; "
              f"each tensor's max |d| over its max, the largest: the mesh run against the nearer mesh=None run {d_diff:.3e} ({at_d}), the two mesh=None runs {d_spread:.3e} ({at_s})")
        if diff > SPREAD_FACTOR * spread:
            raise AssertionError(f"(a) through {kernels}, the (1, 1) mesh differs from mesh=None by {diff:.3e}, beyond {SPREAD_FACTOR:g} x the spread {spread:.3e}")
        expected = {**{k: 0 for k in COUNTERS}, "hstu_rab_fwd": n_layers * (1 + 2 * steps), "hstu_rab_bwd": n_layers * steps, "hstu_rab_bwd_dq": n_layers * (1 + steps), "hstu_rab_bwd_dkv": n_layers * (1 + steps)}
        print("    (a) launches of the mesh runs: " + ", ".join(f"{k} {v}" for k, v in counts.items() if v))
        if counts != expected:
            raise AssertionError(f"(a) the mesh runs did not launch each kernel once per layer per step: {counts}, expected {expected}")
    finally:
        torch.distributed.destroy_process_group()
    return counts


class CollectiveClock:
    """While open, every all-reduce and all-gather of ``parallel.distributed`` (and the sparse updates' gathers of
    ``trainers/sparse.py``) runs between two synchronisations of the card and adds its host clock to ``ms`` and one to
    ``calls``; those made inside ``inside`` (``(module, function name)``: Sinkhorn's) are summed apart as well.  The
    synchronisations stall the step around each collective, so a step timed under the clock includes them."""

    def __init__(self, inside=()):
        self.inside, self.ms, self.calls, self.inside_ms, self.inside_calls, self.depth, self.off = inside, 0.0, 0, 0.0, 0, 0, False

    @contextlib.contextmanager
    def paused(self):
        """The collectives run uncounted (a check's own gathers)."""
        self.off = True
        try:
            yield
        finally:
            self.off = False

    def _timed(self, fn):
        def call(*args, **kw):
            if self.off:
                return fn(*args, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            self.ms, self.calls = self.ms + ms, self.calls + 1
            if self.depth:
                self.inside_ms, self.inside_calls = self.inside_ms + ms, self.inside_calls + 1
            return out
        return call

    def _nested(self, fn):
        def call(*args, **kw):
            self.depth += 1
            try:
                return fn(*args, **kw)
            finally:
                self.depth -= 1
        return call

    def __enter__(self):
        from torch_rechub_tpu_torch.parallel import distributed as pdist
        from torch_rechub_tpu_torch.trainers import sparse

        self.saved = [(pdist, "all_reduce"), (pdist, "all_gather"), (sparse, "all_gather")] + list(self.inside)
        self.saved = [(m, name, getattr(m, name)) for m, name in self.saved]
        for i, (m, name, fn) in enumerate(self.saved):
            setattr(m, name, self._timed(fn) if i < 3 else self._nested(fn))
        return self

    def __exit__(self, *exc):
        for m, name, fn in reversed(self.saved):
            setattr(m, name, fn)


def step_clock(trainer):
    """Wrap ``trainer.train_step`` to record each step's CUDA-event ms (the card synchronised after each step);
    returns the list it appends to."""
    inner, times = trainer.train_step, []

    def timed_step(*batch):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(*batch)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        return out

    trainer.train_step = timed_step
    return times


def mesh_ranks(rank, out_path, shapes=((2, 1), (1, 2))):
    """(b)-(d) on the ranks of ``shapes`` (two gloo ranks sharing the card by default): the HSTU at a vocab of 65,536
    under each mesh against the same rank's mesh=None run; DeepFM at the Criteo-full geometry with sparse Adagrad under
    the last mesh; exact top-k over 1M items split over the ranks against the unsharded call."""
    from torch_rechub_tpu_torch.parallel import create_mesh
    from torch_rechub_tpu_torch.parallel import distributed as pdist
    from torch_rechub_tpu_torch.parallel.mesh import reshard, row_shard

    torch.backends.cuda.matmul.allow_tf32 = False
    meshes = {shape: create_mesh(*shape) for shape in shapes}
    first = meshes[shapes[0]]
    staged = pdist.host_staged(torch.zeros(1, device=CARD), first.data_group)
    if rank == 0:
        print(f"  (b) {first.size} ranks, backend {first.backend}, rank 0 on {torch.cuda.get_device_name(CARD)}; collectives on CUDA tensors "
              f"{'staged through host memory (parallel.distributed.host_staged: gloo)' if staged else 'on the card'}")
    counts = {k: 0 for k in COUNTERS}
    n_layers, steps, vocab = SERVE["n_layers"], MESH["steps"], MESH["vocab"]
    data = SeqLoader(*serving_data(BATCH * steps, SERVE["max_seq_len"], vocab, seed=14), batch_size=BATCH)

    # (b) HSTU: the rank's own mesh=None run is the reference
    ref_tr = SeqTrainer(mesh_hstu(vocab, 14), vocab_chunk_size=8192, model_path=MESH_DIR)
    ref_loss = ref_tr.train_one_epoch(data, log_interval=0)
    ref = params_of(ref_tr)
    del ref_tr
    for shape, mesh in meshes.items():
        tr = SeqTrainer(mesh_hstu(vocab, 14), vocab_chunk_size=8192, mesh=mesh, model_path=MESH_DIR)
        step_ms, reduce_ms, inner_reduce = step_clock(tr), [], pdist.all_reduce_gradients

        def timed_reduce(params, group):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            inner_reduce(params, group)
            torch.cuda.synchronize()
            reduce_ms.append((time.perf_counter() - t0) * 1e3)

        pdist.all_reduce_gradients = timed_reduce
        reset_counts()
        try:
            loss = tr.train_one_epoch(data, log_interval=0)
        finally:
            pdist.all_reduce_gradients = inner_reduce
        mine = read_counts()
        for k, v in mine.items():
            counts[k] += v
        table = tr.model.token_embedding
        grads = sum(p.numel() for p in tr.model.parameters() if row_shard(p) is None) + sum(p.numel() for p in tr.model.parameters() if row_shard(p) is not None)
        print(f"    (b) {shape} rank {rank} at {(mesh.data_index, mesh.model_index)}: {BATCH // shape[0]} rows a step; token table {tuple(table.shape)} {table.numel() * 4:,} bytes"
              f"{' (a row shard)' if row_shard(table) is not None else ''}; launches " + ", ".join(f"{k} {v}" for k, v in mine.items() if v)
              + f"; CUDA-event ms a step " + ", ".join(f"{t:.2f}" for t in step_ms) + f"; gradient all-reduce ({grads * 4:,} bytes) ms a step, host clock " + ", ".join(f"{t:.2f}" for t in reduce_ms))
        got = mesh_state(tr)
        if rank == 0:
            mesh_compare(f"(b) HSTU V{vocab} under {shape}", got, ref, loss, ref_loss, MESH_HSTU_TOL)
        expected = {**{k: 0 for k in COUNTERS}, "hstu_rab_fwd": n_layers * steps, "hstu_rab_bwd": n_layers * steps}
        if mine != expected:
            raise AssertionError(f"(b) {shape}: rank {rank} did not launch K1 and K2 once per layer per step: {mine}, expected {expected}")
        del tr, got
    del ref
    torch.cuda.empty_cache()

    # (c) DeepFM at the Criteo-full geometry, sparse Adagrad, under the last mesh, against the rank's mesh=None run;
    # both under torch.use_deterministic_algorithms (index_add_'s atomics otherwise split runs into two clusters, §15)
    mesh = meshes[shapes[-1]]
    b = CTR["batch"]
    x, y = ctr_data(MESH["ctr_steps"] * b, VOCABS_FULL, seed=16, zipf=True)
    prior = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        runs = {}
        for label, m in (("none", None), ("mesh", mesh)):
            tr = CTRTrainer(ctr_model(VOCABS_FULL, seed=16, device=CARD), optimizer_params=CTR_OPT, sparse_embedding="adagrad", mesh=m, model_path=MESH_DIR)
            (name,) = tr.sparse_tables
            table = tr.sparse_tables[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = tr.train_one_epoch(ArrayLoader(x, y, batch_size=b), log_interval=0)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / MESH["ctr_steps"] * 1e3
            print(f"    (c) DeepFM Criteo-full {'mesh=None' if m is None else shapes[-1]} rank {rank}: {name} {tuple(table.shape)} {table.numel() * 4:,} bytes"
                  f"{' (a row shard)' if row_shard(table) is not None else ''}; {ms:.1f} ms a step of host clock (B{b}, {MESH['ctr_steps']} steps)")
            runs[label] = (loss, tr)
        (loss, tr), (ref_loss, ref_tr) = runs["mesh"], runs["none"]
        params = dict(tr.model.named_parameters())
        got = {k: v for k, v in tr.model.state_dict().items() if k in params}
        got.update({f"accum:{k}": v for k, v in tr.sparse_accums.items()})
        ref = {k: reshard(v, params[k]) for k, v in ref_tr.model.state_dict().items() if k in params}
        ref.update({f"accum:{k}": reshard(v, tr.sparse_tables[k]) for k, v in ref_tr.sparse_accums.items()})
        mesh_compare(f"(c) DeepFM Criteo-full under {shapes[-1]}, rank {rank}'s rows", got, ref, loss, ref_loss, MESH_CTR_TOL, lr_steps=2 * CTR_OPT["lr"] * MESH["ctr_steps"])
        del runs, tr, ref_tr, got, ref, params
    finally:
        torch.use_deterministic_algorithms(False)
        if prior is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = prior
    torch.cuda.empty_cache()

    # (d) exact top-k over a 1M-item corpus split over the two ranks, against the unsharded call
    rng = np.random.default_rng(17)
    users = torch.as_tensor(rng.normal(size=(MESH["topk_users"], MESH["topk_dim"])).astype(np.float32), device=CARD)
    items = torch.as_tensor(rng.normal(size=(MESH["topk_items"], MESH["topk_dim"])).astype(np.float32), device=CARD)
    timings = {}
    for label, m in (("unsharded", None), ("split", first)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timings[label] = brute_force_topk(users, items, MESH["k"], batch_size=MESH["topk_batch"], mesh=m) + ((time.perf_counter() - t0) * 1e3,)
    (idx0, val0, ms0), (idx1, val1, ms1) = timings["unsharded"], timings["split"]
    same = int((idx0 == idx1).all(axis=1).sum())
    print(f"    (d) rank {rank}: top-{MESH['k']} of {MESH['topk_users']} users over {MESH['topk_items']:,} items: the split call {ms1:.1f} ms, the unsharded {ms0:.1f} ms "
          f"(host clock, every rank at once); {same} of {MESH['topk_users']} users' indices equal; scores max |d| {float(np.abs(val0 - val1).max()):.3e}")
    if same != MESH["topk_users"]:
        raise AssertionError(f"(d) the split top-k differs from the unsharded one for {MESH['topk_users'] - same} users")
    np.savez(out_path.replace(".npz", f"_rank{rank}.npz"), **counts)
    torch.distributed.barrier()


# tests/test_sharding.py:308-328: the task losses' rtol, the parameters' rtol / atol; the loss weights' rtol / atol (:311)
MESH_MTL_TOL = (5e-4, 3e-3, 5e-4)
MESH_LOSS_WEIGHT_TOL = (1e-3, 1e-4)
# the RQ-VAE: the loss's rtol, the parameters' rtol / atol (tests/test_sharding.py:351, :369)
MESH_RQ_TOL = (1e-4, 2e-3, 2e-4)
# MMOE at the multi-task phase's geometry (Ali-CCP's schema, d16, global B4096), 4 steps; the RQ-VAE phase's model and
# items, one epoch of B1024 with the k-means init cut from 100 Lloyd iterations to 10 (host time on every rank), at the
# phase's Sinkhorn epsilons (0.003 on stage 3, which overflows to code 0) and again at 0.1 on stage 3, which does not
MESH_MTL = dict(steps=4, methods=(None, "uwl", "gradnorm", "metabalance"))
MESH_RQ = dict(kmeans_iters=10, epochs=1, sk_epsilons=(RQ["sk_epsilons"], RQ["sk_epsilons"][:-1] + (0.1,)))


def constant_rows(model, steps):
    """The embedding rows of the sample's one-id fields (field 126): a constant input, which the BatchNorm after the
    first Dense takes out, so their exact gradient is 0 and the optimizer moves them by rounding noise, Adam by up to
    lr and row-wise Adagrad (from a zero accumulator) by up to lr sqrt(D) a step.  ``{parameter: (rows, slack)}`` for
    ``mesh_compare`` over ``steps`` steps, the unsharded table's rows."""
    sparse, _, vocab = aliccp_schema()
    slack = steps * CTR_OPT["lr"] * math.sqrt(MTL["dim"])
    offsets = model.embedding.layout.offsets
    out = {}
    for c in (c for c in sparse if vocab[c] == 1):
        if c in offsets:
            name = next(n for n, p in model.named_parameters() if n.startswith("embedding.fused_d"))
            out.setdefault(name, ([], slack))[0].append(offsets[c][1])
        else:
            out[f"embedding.{c}_table"] = ([0], slack)
    return out


def mesh_mtl(rank):
    """(e) MMOE under (2, 1) with the mean, UWL, GradNorm and MetaBalance, and under (1, 2) with every table fused and
    sparse Adagrad (the fused table row-sharded), each against the rank's own mesh=None run from the same seeded
    weights: the task losses, every parameter (and the sparse accumulators, the loss weights), a step's CUDA-event ms and
    the collectives' host ms.  Returns the seconds it took."""
    from torch_rechub_tpu_torch.parallel import create_mesh
    from torch_rechub_tpu_torch.parallel.mesh import row_shard

    t0 = time.perf_counter()
    meshes = {shape: create_mesh(*shape) for shape in ((2, 1), (1, 2))}
    b, steps = MTL["batch"], MESH_MTL["steps"]
    x, ys = mtl_data(steps * b, seed=18)
    runs = [(m, False, None, (2, 1)) for m in MESH_MTL["methods"]] + [(None, True, "adagrad", (1, 2))]
    for method, fused, sparse, shape in runs:
        label = f"MMOE {method or 'mean'}{', fused, sparse Adagrad' if fused else ''} under {shape}"
        trained = {}
        for key, mesh in (("none", None), ("mesh", meshes[shape])):
            tr = MTLTrainer(mtl_model("MMOE", seed=18, device=CARD, fused=fused), MTL_TASKS, optimizer_params=CTR_OPT, adaptive_params={"method": method} if method else None,
                            sparse_embedding=sparse, mesh=mesh, model_path=MESH_DIR)
            times = step_clock(tr) if mesh is not None else []
            with CollectiveClock() as clock:
                loss = tr.train_one_epoch(ArrayLoader(x, ys, batch_size=b), log_interval=0)
            trained[key] = (loss, mesh_state(tr), None if tr.loss_weight is None else tr.loss_weight.detach().clone(), times, clock, tr)
        (loss, got, lw, times, clock, tr), (ref_loss, ref, ref_lw, _, _, _) = trained["mesh"], trained["none"]
        tables = [f"{n} {tuple(p.shape)} (a row shard of {row_shard(p).rows} rows)" for n, p in tr.model.named_parameters() if row_shard(p) is not None]
        print(f"  (e) rank {rank}: {label}, {b // shape[0]} rows a step; CUDA-event ms a step (a synchronisation around each collective) " + ", ".join(f"{t:.2f}" for t in times)
              + f"; collectives {clock.calls / steps:.0f} a step, {clock.ms / steps:.2f} ms of host clock a step (each between two synchronisations)"
              + (f"; {', '.join(tables)}" if tables else "; no table sharded")
              + ("" if tr.gradnorm_leaf is None else f"; GradNorm's leaf {tr.gradnorm_leaf}"))
        if rank == 0:
            mesh_compare(f"(e) {label}", got, ref, loss, ref_loss, MESH_MTL_TOL, lr_steps=2 * CTR_OPT["lr"] * steps, still=constant_rows(tr.model, steps))
        if lw is not None:
            ok = torch.allclose(lw, ref_lw, rtol=MESH_LOSS_WEIGHT_TOL[0], atol=MESH_LOSS_WEIGHT_TOL[1])
            print(f"    rank {rank}: loss weights {lw.cpu().numpy().tolist()} (mesh=None {ref_lw.cpu().numpy().tolist()}; rtol {MESH_LOSS_WEIGHT_TOL[0]:g} atol {MESH_LOSS_WEIGHT_TOL[1]:g}): {'yes' if ok else 'NO'}")
            if not ok:
                raise AssertionError(f"(e) {label}: rank {rank}'s loss weights {lw} differ from mesh=None's {ref_lw}")
        if fused and not tables:
            raise AssertionError(f"(e) {label}: the fused table was not row-sharded")
        del trained, tr, got, ref
    return time.perf_counter() - t0


def mesh_rqvae(rank, sk_epsilons):
    """(f) The RQ-VAE phase's model at ``sk_epsilons`` with the k-means init, one epoch under (2, 1) in lockstep with
    the rank's own mesh=None run.  The first step, from the same weights, is held: the codes over the global batch
    equal, the loss within rtol 1e-4, every gradient within rtol 2e-3 and 1e-4 of the model's largest (mesh=None
    taking the ReLU branches the mesh run took, ``kink_branches``), every parameter after Adam within rtol 2e-3 /
    atol 2e-4, and 2 lr more where the sign of the gradient plus the weight decay differed (Adam moves an element
    by about lr whatever its gradient's size).  The later steps part: a code on either side of an argmin near-tie
    flips with the rounding of another summation order, and Adam's sign of a gradient within rounding of 0 moves an
    element either way; they are reported, not held: the rows whose codes differ a step, the largest parameter
    difference, the epoch's loss, the share of items whose nearest codes are equal after the epoch.  The same
    numbers, and the first step's Adam sign flips, are reported for a control: a third run, mesh=None from the same
    weights, that takes each batch's rows in a seeded random order, so it computes the same function with another
    summation order over the batch (what the mesh changes: a rank's half, then the sum of the halves) and nothing
    else changes.  Also a step's CUDA-event ms (with a
    synchronisation of the card around each collective) and the collectives' (Sinkhorn's apart) host ms.  Returns
    the seconds it took."""
    from torch_rechub_tpu_torch.models.generative import rqvae as rq_module
    from torch_rechub_tpu_torch.parallel import create_mesh
    from torch_rechub_tpu_torch.parallel import distributed as pdist
    from torch_rechub_tpu_torch.parallel.mesh import shard_batch

    t0 = time.perf_counter()
    mesh = create_mesh(2, 1)
    data, _ = rq_data(seed=0)
    b, lr, wd = RQ["batch"], CTR_OPT["lr"], CTR_OPT["weight_decay"]
    trainers, init_s = {}, {}
    for key, m in (("none", None), ("mesh", mesh), ("shuffled", None)):
        model = RQVAEModel(in_dim=RQ["in_dim"], sk_epsilons=sk_epsilons, kmeans_init=True, kmeans_iters=MESH_RQ["kmeans_iters"], generator=torch.Generator().manual_seed(19), device=CARD)
        trainers[key] = RQVAETrainer(model, optimizer_params=CTR_OPT, n_epoch=MESH_RQ["epochs"], model_path=MESH_DIR, mesh=m)
        if key == "shuffled":  # mesh=None's k-means codebooks
            model.load_state_dict(trainers["none"].model.state_dict())
            continue
        t1 = time.perf_counter()
        trainers[key].init_state_from_data(data)  # the k-means init; under the mesh, checked equal on every rank
        init_s[key] = time.perf_counter() - t1
    ref, tr, shuffled = trainers["none"], trainers["mesh"], trainers["shuffled"]
    params, ref_params, shuffled_params = (dict(t.model.named_parameters()) for t in (tr, ref, shuffled))
    invariant = shift_invariant(set(ref_params))
    times = step_clock(tr)
    codes, losses, diffs, orders = {k: [] for k in trainers}, {k: [] for k in trainers}, {"mesh": [], "shuffled": []}, []
    order_gen = torch.Generator().manual_seed(rank)
    forward = rq_module.ResidualVectorQuantizer.forward
    owner = {id(t.model.rq): key for key, t in trainers.items()}

    latest = {}  # each trainer's codes of its latest step, written by its forward inside a replayed CUDA graph too

    def recorded(self, *args, **kw):
        out = forward(self, *args, **kw)
        key = owner[id(self)]
        if key not in latest:  # a trainer's first step is eager: the buffer is made outside any capture
            latest[key] = torch.empty_like(out[2])
        latest[key].copy_(out[2])
        return out

    def step(key, x):
        losses[key].append(trainers[key].train_step(x))
        codes[key].append(latest[key].clone())

    def record_diffs():
        for key, p in (("mesh", params), ("shuffled", shuffled_params)):
            diffs[key].append(rel_diff(*({k: v for k, v in d.items() if k not in invariant} for d in (p, ref_params))))

    for t in trainers.values():
        t.set_lr(t.epoch_lr(0))
    rq_module.ResidualVectorQuantizer.forward = recorded
    try:
        with CollectiveClock(inside=((rq_module, "sinkhorn_algorithm"), (rq_module, "center_distances"))) as clock:
            for step_i, xb in enumerate(ref._iter_batches(data, b, epoch=0)):
                x = torch.from_numpy(xb).to(CARD)
                orders.append(torch.randperm(b, generator=order_gen).to(CARD))
                step("shuffled", x[orders[-1]])
                if step_i:
                    step("mesh", shard_batch(x, mesh))
                    step("none", x)
                    record_diffs()
                    continue
                p0 = {k: p.detach().clone() for k, p in ref_params.items()}
                masks = []
                with kink_branches(masks, replay=False):
                    step("mesh", shard_batch(x, mesh))
                with clock.paused():
                    masks = [pdist.all_gather(m.to(CARD), mesh.data_group) for m in masks]
                with kink_branches(masks, replay=True) as crossed:
                    step("none", x)
                first = first_step_check(params, ref_params, p0, lr, wd, invariant)
                control_flips = first_step_check(shuffled_params, ref_params, p0, lr, wd, invariant)["flips"]
                record_diffs()
    finally:
        rq_module.ResidualVectorQuantizer.forward = forward
    n_steps = len(times)
    none_codes = torch.stack(codes["none"])
    differ = {"mesh": (pdist.all_gather(torch.stack(codes["mesh"]), mesh.data_group, dim=1) != none_codes).any(dim=2).sum(dim=1).tolist(),
              "shuffled": (torch.stack([c[o.argsort()] for c, o in zip(codes["shuffled"], orders)]) != none_codes).any(dim=2).sum(dim=1).tolist()}
    step_losses = [float(losses[k][0]) for k in ("mesh", "none")]
    loss = {k: float(torch.stack(v).mean()) for k, v in losses.items()}
    nearest = ref._indices(data, b, use_sk=False)
    same = {k: float((t._indices(data, b, use_sk=False) == nearest).all(axis=1).mean()) for k, t in (("mesh", tr), ("shuffled", shuffled))}
    last = np.asarray(none_codes[:, :, -1].cpu())
    print(f"  (f) rank {rank}: RQ-VAE {RQ['items']:,} x {RQ['in_dim']}, B{b} ({b // 2} rows a rank), sk_epsilons {sk_epsilons}: k-means init ({MESH_RQ['kmeans_iters']} iterations) "
          f"{init_s['mesh']:.1f} s under the mesh (checked equal on both ranks), {init_s['none']:.1f} s without; CUDA-event ms a step (a synchronisation around each collective) "
          + ", ".join(f"{t:.2f}" for t in times)
          + f"; collectives {clock.calls / n_steps:.0f} a step, {clock.ms / n_steps:.2f} ms of host clock a step, of them Sinkhorn's and center_distances' {clock.inside_calls / n_steps:.0f}, "
          f"{clock.inside_ms / n_steps:.2f} ms (each between two synchronisations, the mesh=None runs' steps in between); stage 3's training codes take {len(np.unique(last))} values"
          + (" (Sinkhorn's plan overflows to NaN: code 0)" if (last == 0).all() else ""))
    print(f"    the first step: codes of {b} rows equal: {differ['mesh'][0] == 0}; loss {step_losses[0]:.7f} (mesh=None {step_losses[1]:.7f}); the largest gradient excess over rtol {MESH_RQ_TOL[1]:g} and "
          f"{CTR_GRAD_ATOL_REL:g} of the model's largest {first['grad'][0]:.2e} ({first['grad'][1]}; mesh=None took the mesh run's ReLU branches, {crossed[0]} of its inputs on the other side of 0); "
          f"the parameters' largest excess over rtol {MESH_RQ_TOL[1]:g} / atol {MESH_RQ_TOL[2]:g} and 2 lr where Adam's sign differed ({first['flips']:,} elements) {first['param'][0]:.2e} ({first['param'][1]})")
    for key, what in (("mesh", "then, not held, the mesh run"), ("shuffled", f"the control, mesh=None on each batch's rows shuffled ({control_flips:,} elements' Adam sign differed at the first step)")):
        print(f"    {what} against mesh=None: rows whose codes differ a step {differ[key]}; the largest parameter difference of a tensor's largest a step (the Dense biases in front of a "
              "BatchNorm aside) " + ", ".join(f"{d:.1e}" for d, _ in diffs[key])
              + f"; the epoch's loss {loss[key]:.7f} (mesh=None {loss['none']:.7f}); every item's nearest codes after the epoch equal to mesh=None's: {same[key]:.5f}")
    if differ["mesh"][0] or not math.isclose(*step_losses, rel_tol=MESH_RQ_TOL[0]) or first["grad"][0] > 0 or first["param"][0] > 0:
        raise AssertionError(f"(f) rank {rank}: the RQ-VAE's first step under (2, 1) differs from mesh=None's: codes {differ['mesh'][0]}, losses {step_losses}, {first}")
    return time.perf_counter() - t0


def first_step_check(params, ref_params, p0, lr, wd, invariant):
    """The mesh run's gradients and parameters after the first step against mesh=None's (see ``mesh_rqvae``):
    ``{"grad": (largest excess over the model's largest gradient, tensor), "param": (largest excess, tensor),
    "flips": elements whose Adam sign differed}``; the Dense biases in front of a BatchNorm (``invariant``: exact
    gradient 0) take 2 lr and no gradient check."""
    _, rtol, atol = MESH_RQ_TOL
    with torch.no_grad():
        largest = max(float(p.grad.abs().max()) for p in ref_params.values())
        grad, param, flips = (-1.0, ""), (-1.0, ""), 0
        for k, r in ref_params.items():
            g, gr = params[k].grad, r.grad
            flipped = torch.sign(g + wd * p0[k]) != torch.sign(gr + wd * p0[k])
            flips += int(flipped.sum())
            if k not in invariant:
                grad = max(grad, (float(((g - gr).abs() - (rtol * gr.abs() + CTR_GRAD_ATOL_REL * largest)).max()) / largest, k))
            slack = 2 * lr * (flipped.to(r.dtype) if k not in invariant else 1.0)
            param = max(param, (float(((params[k] - r).abs() - (atol + rtol * r.abs() + slack)).max()), k))
    return {"grad": grad, "param": param, "flips": flips}


def mesh_trainer_ranks(rank, out_path):
    """(b)-(f) on two gloo ranks sharing the card: ``mesh_ranks``, then the multi-task and RQ-VAE trainers, which launch
    none of the port's kernels."""
    mesh_ranks(rank, out_path)
    reset_counts()
    seconds = mesh_mtl(rank), sum(mesh_rqvae(rank, eps) for eps in MESH_RQ["sk_epsilons"])
    counts = read_counts()
    print(f"  rank {rank}: (e) {seconds[0]:.1f} s, (f) {seconds[1]:.1f} s; the port's kernels launched there: " + ", ".join(f"{k} {v}" for k, v in counts.items()))
    if any(counts.values()):
        raise AssertionError(f"(e) or (f) launched an HSTU attention kernel: {counts}")
    torch.distributed.barrier()


def mesh_phase():
    """(a) a world of one over NCCL (this process), (b)-(f) two gloo ranks sharing the card; returns the launches,
    summed over the ranks, of the mesh trainers' runs."""
    from torch_rechub_tpu_torch.parallel import distributed as pdist

    t0 = time.perf_counter()
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    os.makedirs(MESH_DIR)
    torch.cuda.empty_cache()
    try:
        launches = mesh_world_of_one()
        t1 = time.perf_counter()
        pdist.spawn(mesh_trainer_ranks, 2, args=(os.path.join(MESH_DIR, "two.npz"),), backend="gloo", timeout_s=600)
        for rank in range(2):
            for k, v in np.load(os.path.join(MESH_DIR, f"two_rank{rank}.npz")).items():
                launches[k] += int(v)
    finally:
        shutil.rmtree(MESH_DIR, ignore_errors=True)
    print(f"  the mesh phase's launches, summed over ranks: " + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
          + f"; (a) {t1 - t0:.1f} s, (b)-(f) {time.perf_counter() - t1:.1f} s, the processes' start included")
    return launches


# ---------------------------------------------------------------------------
# 17. approximate retrieval: the native HNSW index against exact top-k on the card
# ---------------------------------------------------------------------------

# the production YoutubeDNN's width (BASELINE.md:321-328: d64, L2-normalised towers, so the inner product is the cosine),
# seeded unit-norm items and users around 1,000 cluster centres at a noise as large as a centre; the index at
# serving/hnsw.py's defaults (M 16, ef_construction 200, ef_search 64).  The corpus is cut from the production 8M items
# to 30,000: the build is one host thread.  The legacy engines on a 5,000-item part.
ANN = dict(items=30_000, dim=64, clusters=1_000, noise=1.0, users=1024, batch=128, k=10, M=16, ef_construction=200, ef_search=64, recall=0.9, legacy_items=5_000)
ANN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_ann")


def ann_data(seed):
    """``(items, users)``: unit-norm fp32 rows around seeded cluster centres."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(ANN["clusters"], ANN["dim"]))

    def rows(n):
        x = centers[rng.integers(0, ANN["clusters"], n)] + rng.normal(size=(n, ANN["dim"])) * ANN["noise"]
        return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)

    return rows(ANN["items"]), rows(ANN["users"])


def ann_phase(cycles_per_ms):
    """(g) The native HNSW index (``builder_factory("hnsw")``, a host index) over the items, given as card tensors:
    build seconds, recall@10 of every user against the card's exact ``brute_force_topk`` (above ``ANN["recall"]``),
    ms per batch of users on the host beside the card's exact batch, the index's bytes, a save / load round trip with
    equal ids; the legacy ``Annoy`` engine (the native HNSW without annoy) and ``Faiss`` engine (brute force on the card
    without faiss) on one batch each against what they stand for."""
    from torch_rechub_tpu_torch.serving import builder_factory
    from torch_rechub_tpu_torch.utils.match import Annoy, Faiss

    t0 = time.perf_counter()
    shutil.rmtree(ANN_DIR, ignore_errors=True)
    os.makedirs(ANN_DIR)
    k, bsz = ANN["k"], ANN["batch"]
    items_np, users_np = ann_data(seed=20)
    items, users = torch.from_numpy(items_np).to(CARD), torch.from_numpy(users_np).to(CARD)
    exact, exact_scores = brute_force_topk(users, items, k, batch_size=bsz)
    exact_dev, exact_wall = timed(lambda: topk_scores(users[:bsz], items, k), cycles_per_ms)
    builder = builder_factory("hnsw", metric="ip", M=ANN["M"], ef_construction=ANN["ef_construction"], ef_search=ANN["ef_search"])
    try:
        t1 = time.perf_counter()
        with builder.from_embeddings(items) as index:
            build_s = time.perf_counter() - t1
            ids, sims = index.query(users, k)
            walls = []
            for _ in range(5):
                t1 = time.perf_counter()
                index.query(users[:bsz], k)
                walls.append((time.perf_counter() - t1) * 1e3)
            path = os.path.join(ANN_DIR, "items.hnsw")
            t1 = time.perf_counter()
            index.save(path)
            save_s = time.perf_counter() - t1
            size = index.size
        t1 = time.perf_counter()
        with builder.from_index_file(path) as loaded:
            load_s = time.perf_counter() - t1
            again = loaded.query(users_np, k)[0]
        nbytes = os.path.getsize(path)
    finally:
        shutil.rmtree(ANN_DIR, ignore_errors=True)
    recall = float(np.mean([len(set(ids[i]) & set(exact[i])) / k for i in range(len(ids))]))
    sim_err = float(np.abs(sims - np.take_along_axis(users_np @ items_np.T, ids, 1)).max())
    print(f"  (g) HNSW over {size:,} items of d{ANN['dim']} (M {ANN['M']}, ef_construction {ANN['ef_construction']}, ef_search {ANN['ef_search']}, metric ip): built in {build_s:.2f} s (one host thread); "
          f"recall@{k} of {len(ids)} users against the card's exact top-{k}: {recall:.5f} (gate > {ANN['recall']}); a batch of {bsz} users {float(np.median(walls)):.2f} ms on the host (median of 5) "
          f"against the card's exact batch {exact_dev:.4f} ms of device time, {exact_wall:.4f} ms of host clock; the index file {nbytes:,} bytes ({nbytes / items_np.nbytes:.2f} x the items), "
          f"saved in {save_s * 1e3:.1f} ms, loaded in {load_s * 1e3:.1f} ms, {int((again == ids).all(axis=1).sum())} of {len(ids)} users' ids equal after the round trip; "
          f"similarities against the host's dot products max |d| {sim_err:.2e}")
    if recall <= ANN["recall"]:
        raise AssertionError(f"(g) HNSW recall@{k} {recall} is not above {ANN['recall']}")
    if not np.array_equal(again, ids):
        raise AssertionError("(g) the index loaded from its file answers otherwise than the one saved")

    # the legacy engines on one batch each, against what they stand for
    part = items[: ANN["legacy_items"]]
    engine = Annoy(metric="dot")
    kind = type(engine._builder).__name__
    got = engine.fit(part).query(users[:bsz], k)
    with builder_factory("hnsw", metric="ip").from_embeddings(part) as index:
        want = index.query(users[:bsz], k)
    faiss_engine = Faiss(metric="ip")
    faiss_kind = type(faiss_engine._builder).__name__
    fgot = faiss_engine.fit(items).query(users[:bsz], k)
    print(f"    legacy engines on a batch of {bsz} users: Annoy(metric=\"dot\") took {kind} over {len(part):,} items, ids equal to builder_factory(\"hnsw\", metric=\"ip\")'s: "
          f"{np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])}; Faiss(metric=\"ip\") took {faiss_kind} on {getattr(faiss_engine._builder, 'device', None) or CARD}, ids equal to brute_force_topk's: "
          f"{np.array_equal(fgot[0], exact[:bsz])}, scores max |d| {float(np.abs(fgot[1] - exact_scores[:bsz]).max()):.2e}; phase {time.perf_counter() - t0:.1f} s")
    if kind == "HnswBuilder" and not (np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])):
        raise AssertionError("(g) the legacy Annoy engine's HNSW answers otherwise than the native HNSW builder")
    if faiss_kind == "BruteForceBuilder" and not np.array_equal(fgot[0], exact[:bsz]):
        raise AssertionError("(g) the legacy Faiss engine's brute force answers otherwise than brute_force_topk")


# ---------------------------------------------------------------------------
# 18. the examples (examples_torch/) through their argv entries
# ---------------------------------------------------------------------------

EXAMPLES_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples_torch")
NUM = r"(-?\d+(?:\.\d+)?(?:e[-+]?\d+)?|nan)"
_MATCH_LINE = r"^defaultdict\(<class 'list'>, \{'NDCG': \['NDCG@10: " + NUM + r"'\].*'Precision': \['Precision@10: " + NUM + r"'\]\}\)$"
_AUC_LINE, _MTL_LINE, _HSTU_LINE = r"^test auc: " + NUM + "$", r"^final scores: \[", r"^hit@10 \(seen filtered\): " + NUM + "$"
# every script but the two production recipes, at its defaults with one epoch (TIGER: 50 steps, the first print),
# and the line of its result
EXAMPLE_RUNS = {
    "ranking/run_criteo.py": (["--epoch", "1"], _AUC_LINE),
    "ranking/run_avazu.py": (["--epoch", "1"], _AUC_LINE),
    "ranking/run_ali_ccp_ctr_ranking.py": (["--epoch", "1"], _AUC_LINE),
    "ranking/run_amazon_electronics.py": (["--epoch", "1"], r"^test AUC: " + NUM + "$"),
    "ranking/run_dien.py": (["--epoch", "1"], r"^test AUC: " + NUM + "$"),
    "ranking/run_multi_task.py": (["--epoch", "1"], _MTL_LINE),
    "ranking/run_ali_ccp_multi_task.py": (["--epoch", "1"], _MTL_LINE),
    "ranking/run_aliexpress.py": (["--epoch", "1"], _MTL_LINE),
    "ranking/run_census.py": (["--epoch", "1"], _MTL_LINE),
    "ranking/run_gradnorm.py": (["--epoch", "1"], _MTL_LINE),
    "ranking/run_metabalance.py": (["--epoch", "1"], _MTL_LINE),
    "matching/run_ml_matching.py": (["--epoch", "1"], _MATCH_LINE),
    "matching/run_ml_youtube_dnn.py": (["--epoch", "1"], _MATCH_LINE),
    "matching/run_ml_youtube_sbc.py": (["--epoch", "1"], _MATCH_LINE),
    "matching/run_ml_gru4rec.py": (["--epoch", "1"], _MATCH_LINE),
    "matching/run_ml_mind.py": (["--epoch", "1"], _MATCH_LINE),
    "matching/run_ml_comirec.py": (["--epoch", "1"], _MATCH_LINE),
    "matching/run_ml_sine.py": (["--epoch", "1"], _MATCH_LINE),
    "matching/run_ml_facebook_dssm.py": (["--epoch", "1"], _MATCH_LINE),
    "matching/run_ml_dssm.py": (["--epoch", "1"], _MATCH_LINE),
    "matching/run_dssm.py": (["--epoch", "1"], _MATCH_LINE),
    "matching/run_sbr.py": (["--epoch", "1"], r"^test metrics: \{'NDCG@20': " + NUM + ".*'Precision@20': " + NUM + r"\}$"),
    "matching/run_yidian_sbc.py": (["--epoch", "1"], r"^test metrics: \{'NDCG@10': " + NUM + ".*'Precision@10': " + NUM + r"\}$"),
    "matching/movielens_utils.py": ([], None),
    "generative/run_hstu.py": (["--epoch", "1"], _HSTU_LINE),
    "generative/run_hstu_movielens.py": (["--epoch", "1"], _HSTU_LINE),
    "generative/run_hstu_amazon_books.py": (["--epoch", "1"], _HSTU_LINE),
    "generative/run_hllm.py": (["--epoch", "1"], r"^test loss: " + NUM + "  top-1 hit: " + NUM + "$"),
    "generative/run_hllm_movielens.py": (["--epoch", "1"], r"^test loss: " + NUM + "  top-1 hit: " + NUM + "$"),
    "generative/run_hllm_amazon_books.py": (["--epoch", "1"], r"^test loss: " + NUM + "  top-1 hit: " + NUM + "$"),
    "generative/run_rqvae_tiger.py": (["--rqvae_epochs", "1", "--tiger_steps", "50"], r"^recall@5 over semantic ids: " + NUM + "$"),
    "generative/run_rqvae_amazon_books.py": (["--rqvae_epochs", "1"], r"^semantic-id vocab: \d+ tokens over 500 items$"),
    "generative/run_tiger_amazon_books.py": (["--rqvae_epochs", "1", "--tiger_steps", "50"], r"^recall@5 over semantic ids: " + NUM + "$"),
    "generative/run_tiger_movielens.py": (["--rqvae_epochs", "1", "--tiger_steps", "50"], r"^recall@5 over semantic ids: " + NUM + "$"),
    "serving/run_quantize_export.py": (["--epoch", "1"], r"^bruteforce: build " + NUM + " ms, " + NUM + r" ms/query, self-top1 hit " + NUM + "$"),
}
# the production HSTU recipe at BASELINE.md's Amazon-Books geometry: V686k, d256, 4 layers of 4 heads of 64, B8 x L256,
# 2048 sampled negatives, both tables sparse (row-wise Adagrad)
PROD_HSTU_ARGV = ["--vocab", "686000", "--d_model", "256", "--n_layers", "4", "--batch_size", "8", "--seq_len", "256", "--num_negatives", "2048", "--epoch", "1"]
PROD_HSTU_STEPS = 64  # steps of the timed window (the recipe's train split holds 100 batches of 8)
EXAMPLES_PHASE_S = 180.0
# the mesh run's epoch loss and AUC against the run without a mesh: the same function, index_add_'s atomics apart
CRITEO_MESH_RTOL, CRITEO_MESH_AUC_ATOL = 1e-3, 1e-3
MTL_DATA = {"run_multi_task.py": "build_census_multitask_dataset", "run_census.py": "build_census_multitask_dataset", "run_aliexpress.py": "build_aliexpress_multitask_dataset",
            "run_ali_ccp_multi_task.py": "build_aliccp_multitask_dataset", "run_gradnorm.py": "build_aliccp_multitask_dataset", "run_metabalance.py": "build_aliccp_multitask_dataset"}


class HSTUCalls:
    """While open: the forwards of every ``HSTUModel`` (a global forward hook) and ``SeqTrainer.train_step`` calls."""

    def __enter__(self):
        self.forwards = self.steps = 0
        step = SeqTrainer.train_step

        def counted(trainer, *args, **kwargs):
            self.steps += 1
            return step(trainer, *args, **kwargs)

        def hook(module, args, output):
            if isinstance(module, HSTUModel):
                self.forwards += 1

        self._step, SeqTrainer.train_step = step, counted
        self._hook = torch.nn.modules.module.register_module_forward_hook(hook)
        return self

    def __exit__(self, *exc):
        SeqTrainer.train_step = self._step
        self._hook.remove()


def run_example(rel, argv, directory):
    """``examples_torch/<rel>`` as ``__main__`` with ``argv``, ``--device`` unset, in a working directory of its own
    under ``directory``, where its ``--save_dir`` (relative by default, also through a preset) lands:
    ``(its standard output, wall seconds)``.  ``sys.argv``, ``sys.path`` and the working directory are
    restored; on a failure the output's tail is printed before the error."""
    import io
    import runpy
    import tempfile

    path = os.path.join(EXAMPLES_DIR, rel)
    cwd = tempfile.mkdtemp(prefix=os.path.basename(rel)[:-3] + "_", dir=directory)
    argv0, path0, cwd0, out = sys.argv, list(sys.path), os.getcwd(), io.StringIO()
    sys.argv = [path] + list(argv)
    t0 = time.perf_counter()
    try:
        os.chdir(cwd)
        with contextlib.redirect_stdout(out):
            runpy.run_path(path, run_name="__main__")
        torch.cuda.synchronize()
    except BaseException:
        print(out.getvalue()[-4000:])
        raise
    finally:
        os.chdir(cwd0)
        sys.argv, sys.path[:] = argv0, path0
    return out.getvalue(), time.perf_counter() - t0


def result_line(rel, out, pattern):
    """The script's last line matching ``pattern``; its numbers finite, but nan where a task's test labels hold one
    class (the AliExpress sample's 24 test rows hold no positive: AUC undefined there)."""
    lines = [line for line in out.splitlines() if re.search(pattern, line)]
    if not lines:
        raise AssertionError(f"{rel}: no line of its output matches {pattern!r}: {out[-2000:]}")
    values = [float(v) for v in re.findall(NUM, lines[-1].split(":", 1)[-1])]
    undefined = set()
    if os.path.basename(rel) in MTL_DATA:
        from examples_torch import datasets

        y = getattr(datasets, MTL_DATA[os.path.basename(rel)])().y_test
        undefined = {i for i in range(y.shape[1]) if len(set(y[:, i].tolist())) < 2}
    if not all(math.isfinite(v) != (i in undefined) for i, v in enumerate(values)):
        raise AssertionError(f"{rel}: its result is not finite where it is defined: {lines[-1]}")
    return lines[-1]


def prod_kernels_check(cycles_per_ms):
    """K1 and K2 at the production recipe's shape (B8 H4 L256, dqk = dv = 64, suffix padding) against their plain
    versions at the kernel phases' tolerances; device ms beside their bounds.  Returns the max abs errs."""
    c = rab_case(41, 8, 256, 256, h=4, d=64)
    out, ref = run_kernel(c), run_plain(c)
    err, ratio = check_close("hstu_rab_fwd at B8 H4 L256 dqk 64", out, ref, KERNEL_RTOL, KERNEL_ATOL)
    worst = {"hstu_rab_fwd": err, "hstu_rab_bwd": 0.0}
    (ms, wall), (plain_ms, _) = timed(lambda: run_kernel(c), cycles_per_ms), timed(lambda: run_plain(c), cycles_per_ms)
    print(f"  K1 hstu_rab_fwd at B8 H4 L256 dqk = dv = 64: max abs err {err:.3e} (ratio {ratio:.3f}); device {ms:.4f} ms (plain {plain_ms:.4f} ms), {bounds_text(rab_bound(c))}, host clock {wall:.4f} ms")
    g = torch.from_numpy(np.random.default_rng(42).normal(size=tuple(c["v"].shape)).astype(np.float32)).cuda()
    args = (c["q"], c["k"], c["v"], g, c["pos_w"], c["ts_w"], c["ts"], c["mask"], c["alpha"], c["max_seq_len"], c["cfg"], c["thr"])
    want = dict(zip(GRAD_NAMES, rab.dense_backward(*args[:-1], True)))
    got = dict(zip(GRAD_NAMES, rab.rab_backward_fused(*args)))
    parts = []
    for name, t in got.items():
        r = want[name]
        rtol, atol = (TABLE_RTOL, TABLE_ATOL_REL * float(r.abs().max()) + 1e-12) if name in ("dpos", "dts") else (BWD_RTOL, BWD_ATOL)
        e, q = check_close(f"hstu_rab_bwd's {name} at B8 H4 L256 dqk 64", t, r, rtol, atol)
        worst["hstu_rab_bwd"] = max(worst["hstu_rab_bwd"], e)
        parts.append(f"{name} {e:.2e} ({q:.3f})")
    (ms, wall), (plain_ms, _) = timed(lambda: rab.rab_backward_fused(*args), cycles_per_ms), timed(lambda: rab.dense_backward(*args[:-1], True), cycles_per_ms)
    print(f"  K2 hstu_rab_bwd at the same shape: max abs err (ratio) {', '.join(parts)}; device {ms:.4f} ms (plain backward {plain_ms:.4f} ms), "
          f"{bounds_text(bwd_bound(c, g, 'hstu_rab_bwd', got.values()))}, host clock {wall:.4f} ms (medians of {REPS})")
    occ = rab.occupancy(256, 64, 64, 256, 128)
    print("  at L256 dqk 64 dv 64: " + "; ".join(f"{k}: {n} CTAs per SM, {r} registers, {b:,} B shared per CTA, {v}" for k, (n, r, b, v) in occ.items() if k in ("hstu_rab_fwd", "hstu_rab_bwd")))
    return worst


def prod_hstu_against_cpu(recipe, args):
    """One step of the recipe built by its own ``build`` (dropout 0, 2048 given negatives), card against CPU from the
    same weights: the loss; the dense parameters' gradients (the HSTU sparse phase's GRAD_RTOL, GRAD_ATOL_REL x each
    tensor's largest) and their Adam steps (beyond what the first update makes of the gradients' difference); both
    tables' steps on the rows the batch touched (``step_ratio``, the sparse Adagrad tolerance) and every other row
    unchanged; the accumulators."""
    _, cpu_model, cpu_tr = recipe.build(args, torch.device("cpu"), dropout=0.0)
    (train, _, _), card_model, card_tr = recipe.build(args, CARD, dropout=0.0)
    card_model.load_state_dict({k: v.to(CARD) for k, v in cpu_model.state_dict().items()})
    p0 = {k: v.detach().clone() for k, v in cpu_model.named_parameters()}
    toks, pos, tds, tgts = next(iter(train))
    negs = np.random.default_rng(43).integers(1, args.vocab, args.num_negatives)
    with given_negatives(negs):
        losses = [tr.train_one_epoch(SeqLoader(toks, pos, tgts, tds, batch_size=args.batch_size), log_interval=0) for tr in (card_tr, cpu_tr)]
    if not (np.isfinite(losses).all() and math.isclose(losses[0], losses[1], rel_tol=CTR_LOSS_RTOL, abs_tol=CTR_LOSS_ATOL)):
        raise AssertionError(f"the production HSTU's step: loss card {losses[0]}, CPU {losses[1]}")
    lr = card_tr.optimizer.param_groups[0]["lr"]
    worst, where = {"grad": 0.0, "param": 0.0, "table": 0.0, "accum": 0.0}, {}
    for (name, a), p in zip(card_model.named_parameters(), cpu_model.parameters(), strict=True):
        if name in cpu_tr.sparse_tables:
            continue
        r = p.grad
        g_ratio = ratio_of(a.grad, r, GRAD_RTOL, GRAD_ATOL_REL * float(r.abs().max()) + 1e-30)
        carried = lr * (adam_update(a.grad.cpu(), p0[name]) - adam_update(r, p0[name])).abs()
        excess = (a.detach().cpu().double() - p.detach().double()).abs() - carried
        p_ratio = float((excess / (CTR_ADAM_UPDATE_TOL * lr + CTR_ADAM_RTOL * p.detach().double().abs())).max())
        for key, v in (("grad", g_ratio), ("param", p_ratio)):
            if v > worst[key]:
                worst[key], where[key] = v, name
    rows = {"token_embedding": np.unique(toks), "output_projection": np.unique(np.concatenate([tgts.ravel(), toks.ravel(), negs]))}
    for name, ids in rows.items():
        ids = torch.from_numpy(ids.astype(np.int64))
        got, ref, before = card_tr.sparse_tables[name].detach().cpu(), cpu_tr.sparse_tables[name].detach(), p0[name]
        rest = torch.ones(len(ref), dtype=torch.bool)
        rest[ids] = False
        if not (torch.equal(got[rest], before[rest]) and torch.equal(ref[rest], before[rest])):
            raise AssertionError(f"the production HSTU's step moved rows of {name} that the batch did not touch")
        step, _ = step_ratio(got[ids], before[ids], ref[ids].double() - before[ids].double(), 2 * GRAD_RTOL, GRAD_ATOL_REL)
        acc_ref = cpu_tr.sparse_accums[name]
        accum = ratio_of(card_tr.sparse_accums[name], acc_ref, 2 * GRAD_RTOL, 1e-6 * float(acc_ref.max()) + 1e-30)
        worst["table"], worst["accum"] = max(worst["table"], step), max(worst["accum"], accum)
    check_sparse_tables_left_out(card_tr)
    print(f"  one step card vs CPU from the same weights (the recipe's build, dropout 0, {args.num_negatives} given negatives, B{args.batch_size} x L{args.seq_len}): "
          f"loss {losses[0]:.7f} vs {losses[1]:.7f}; worst max |d|/tol: " + ", ".join(f"{k} {v:.3f}" + (f" ({where[k]})" if k in where else "") for k, v in worst.items())
          + f" (gradients rtol {GRAD_RTOL}, atol {GRAD_ATOL_REL} x the tensor's max; tables' steps on the touched rows rtol {2 * GRAD_RTOL}, atol {GRAD_ATOL_REL} x the largest step; "
          f"the rest of each table unchanged)")
    if max(worst.values()) > 1.0:
        raise AssertionError(f"the production HSTU's step on the card disagrees with the CPU: {worst}")


def examples_phase(cycles_per_ms):
    """Every script of ``examples_torch/`` through its argv entry on the card (``--device`` unset), the HSTU
    kernels' launches gated; the production HSTU recipe at full width with its step card against CPU, its step
    time and memory; the Criteo-full recipe without and with a (1, 1) mesh.  Returns the phase's launches."""
    import tempfile

    t_phase = time.perf_counter()
    counts = {k: 0 for k in COUNTERS}
    results = {}
    with tempfile.TemporaryDirectory() as directory:

        def gated(rel, argv, pattern, hstu_layers=0):
            """Run one script with the counts reset just before and read just after: K1 once per layer per HSTU
            forward, K2 once per layer per training step, nothing else."""
            torch.cuda.synchronize()
            reset_counts()
            attn.launches = attn.launches_bf16 = 0
            with HSTUCalls() as calls:
                out, seconds = run_example(rel, argv, directory)
            got = {**read_counts(), "hstu_attn_fwd": attn.launches, "hstu_attn_fwd_bf16": attn.launches_bf16}
            want = {k: 0 for k in got}
            want.update(hstu_rab_fwd=hstu_layers * calls.forwards, hstu_rab_bwd=hstu_layers * calls.steps)
            if got != want or (hstu_layers and not calls.steps):
                raise AssertionError(f"{rel} launched {got}, expected {want} ({calls.forwards} HSTU forwards, {calls.steps} training steps)")
            for k in counts:
                counts[k] += got[k]
            line = "" if pattern is None else result_line(rel, out, pattern)
            results[rel] = (seconds, line)
            hstu = f"; K1 {got['hstu_rab_fwd']} launches over {calls.forwards} forwards, K2 {got['hstu_rab_bwd']} over {calls.steps} steps" if hstu_layers else ""
            print(f"  {rel} {' '.join(argv)}: {seconds:.2f} s; {line or 'imported'}{hstu}")
            return out, calls.steps

        for rel, (argv, pattern) in EXAMPLE_RUNS.items():
            layers = 2 if rel.startswith("generative/run_hstu") else 0  # run_hstu.py's --n_layers default
            gated(rel, argv, pattern, layers)
        small = time.perf_counter() - t_phase
        print(f"  the {len(EXAMPLE_RUNS)} small scripts (mtl_common.py runs inside the multi-task ones): {small:.1f} s")

        # the production HSTU recipe at full width
        rel = "generative/run_hstu_production_vocab.py"
        flags = dict(zip(PROD_HSTU_ARGV[::2], PROD_HSTU_ARGV[1::2]))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out, steps = gated(rel, PROD_HSTU_ARGV, r"^test loss " + NUM + " top1 acc " + NUM + rf" \(vocab={flags['--vocab']}, S={flags['--num_negatives']}\)$", hstu_layers=4)
        peak = torch.cuda.max_memory_allocated()
        (_, epoch_s), = re.findall(r"^epoch: 0 train loss: " + NUM + r" \(" + NUM + r"s\)$", out, re.M)
        fit_tokens = steps * int(flags["--batch_size"]) * int(flags["--seq_len"])
        print(f"  {rel}: peak memory {peak / 2**30:.2f} GiB (max_memory_allocated); fit's epoch {epoch_s} s over {steps} steps, "
              f"{fit_tokens / float(epoch_s):,.0f} tokens/s (the recipe's own clock, its first step included)")
        del out
        gc.collect()
        torch.cuda.empty_cache()
        recipe = importlib.import_module("examples_torch.generative.run_hstu_production_vocab")
        args = recipe.parse_args(PROD_HSTU_ARGV + ["--save_dir", os.path.join(directory, "prod")])
        (train, _, _), model, trainer = recipe.build(args, CARD)
        b, l = args.batch_size, args.seq_len
        batches = [a[: b * (PROD_HSTU_STEPS + 1)] for a in (train.seq_tokens, train.seq_positions, train.targets, train.seq_time_diffs)]
        trainer.train_one_epoch(SeqLoader(*(a[:b] for a in batches), batch_size=b), log_interval=0)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = trainer.train_one_epoch(SeqLoader(*(a[b:] for a in batches), batch_size=b), log_interval=0)
        seconds = time.perf_counter() - t0
        step = tuple(torch.from_numpy(a[:b]).to(CARD) for a in (batches[0], batches[3], batches[2]))
        device, wall, launches = step_stats("production HSTU", lambda: trainer.train_step(*step))
        print(f"  training at V{args.vocab:,}, d{args.d_model}, {args.n_layers} layers of 4 heads of {args.d_model // 4}, S{args.num_negatives}, sparse Adagrad: loss {loss:.6f}, "
              f"{PROD_HSTU_STEPS * b * l / seconds:,.0f} tokens/s, {seconds / PROD_HSTU_STEPS * 1e3:.3f} ms per step of {b} x L{l} (host clock, {PROD_HSTU_STEPS} steps); "
              f"a step: device {device:.4f} ms (torch.profiler kernels, 3 steps), host clock {wall:.4f} ms (median of 10), device idle {1 - device / wall:.0%}, {launches:.1f} launches")
        del model, trainer, train, step
        gc.collect()
        torch.cuda.empty_cache()
        prod_hstu_against_cpu(recipe, args)
        gc.collect()
        torch.cuda.empty_cache()
        worst = prod_kernels_check(cycles_per_ms)

        # the Criteo-full recipe, and again on a (1, 1) mesh over NCCL (torchrun's environment of one rank)
        rel = "ranking/run_criteo_production.py"
        line = r"^train AUC \(bucketed, device-side\): " + NUM + "$"
        runs = {"no mesh": gated(rel, [], line)[0]}
        env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port())}
        prior = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            out, _ = gated(rel, ["--mesh", "1,1"], line)
        finally:
            if torch.distributed.is_initialized():
                torch.distributed.destroy_process_group()
            for k, v in prior.items():
                if v is None:
                    os.environ.pop(k)
                else:
                    os.environ[k] = v
        runs["--mesh 1,1"] = out
        stats = {}
        for name, text in runs.items():
            (loss, rate), = re.findall(r"^epoch 0: loss " + NUM + r"  ([\d,]+) examples/s$", text, re.M)
            stats[name] = (float(loss), float(rate.replace(",", "")), float(re.findall(line, text, re.M)[-1]))
        print("  Criteo-full recipe (scale 1.0, 64 steps of 4096, sparse Adagrad): " + "; ".join(f"{k}: loss {v[0]:.5f}, {v[1]:,.0f} examples/s, AUC {v[2]:.4f}" for k, v in stats.items()))
        (l0, _, a0), (l1, _, a1) = stats.values()
        if not (math.isclose(l1, l0, rel_tol=CRITEO_MESH_RTOL) and abs(a1 - a0) <= CRITEO_MESH_AUC_ATOL):
            raise AssertionError(f"the Criteo-full recipe on the (1, 1) mesh parts from the run without one: {stats}")

    total = time.perf_counter() - t_phase
    print(f"  examples phase: {len(results)} script runs, {total:.1f} s (the small scripts {small:.1f} s; the limit {EXAMPLES_PHASE_S:.0f} s)")
    if total > EXAMPLES_PHASE_S:
        raise AssertionError(f"the examples phase took {total:.1f} s, beyond {EXAMPLES_PHASE_S:.0f} s")
    return counts, worst


# ---------------------------------------------------------------------------
# 19. determinism: the fixed-order table gradients
# ---------------------------------------------------------------------------

TABLE_ENTRIES = {"hstu_rab_bwd": (rab.rab_backward_fused, GRAD_NAMES), "hstu_rab_bwd_dq": (rab.rab_backward_dq, ("dq", "dpos", "dts"))}
DETERMINISM = dict(steps=4)


def determinism_phase(cycles_per_ms):
    """K2, K2a, K2-bf16 and K2a-bf16 launched twice at the serving shape, at L1024 and at the production recipe's
    shape: dpos and dts (and K2a's dq) equal bit for bit; each call's device ms (the table sums' second kernel
    included).  Four steps of the serving HSTU twice under deterministic algorithms: the split pair, the parameters
    bit for bit.  Returns the HSTU runs' launches (the twice-launched checks are not counted)."""
    cases = {"the serving shape, B8 H8 L256 d32": rab_case(51, 8, 256, 256), "B8 H8 L1024 d32": rab_case(52, 8, 1024, 1024),
             "the production recipe's B8 H4 L256 d64": rab_case(53, 8, 256, 256, h=4, d=64)}
    for label, c32 in cases.items():
        for bf16 in (False, True):
            c = bf16_case(c32) if bf16 else c32
            g = torch.from_numpy(np.random.default_rng(54).normal(size=tuple(c["v"].shape)).astype(np.float32)).cuda().to(c["v"].dtype)
            args = (c["q"], c["k"], c["v"], g, c["pos_w"], c["ts_w"], c["ts"], c["mask"], c["alpha"], c["max_seq_len"], c["cfg"], c["thr"])
            parts = []
            for entry, (fn, names) in TABLE_ENTRIES.items():
                first = [t.clone() for t in fn(*args)]
                second = fn(*args)
                torch.cuda.synchronize()
                equal = {n: torch.equal(a, b) for n, a, b in zip(names, first, second) if not (entry == "hstu_rab_bwd" and n == "dq")}
                if not all(equal.values()):
                    raise AssertionError(f"{entry}{'_bf16' if bf16 else ''} at {label}: two launches differ in {[n for n, e in equal.items() if not e]}")
                ms, wall = timed(lambda: fn(*args), cycles_per_ms)
                parts.append(f"{entry}{'_bf16' if bf16 else ''}: {', '.join(equal)} bit for bit, device {ms:.4f} ms (host clock {wall:.4f} ms)")
            print(f"  {label}: " + "; ".join(parts))
            del first, second
    b = rab.table_scratch(8, 8, 1024, 128, "meta")
    print(f"  the table sums' scratch at B8 H8 L1024 with 128 buckets: {b.numel() * 4:,} bytes (a slice of L + nb + 1 floats for each CTA of 32 rows)")

    reset_counts()
    l, vocab = SERVE["max_seq_len"], SERVE["vocab_size"]
    data = serving_data(BATCH * DETERMINISM["steps"], l, vocab, seed=55)
    runs = {}
    with deterministic_algorithms():
        for label in ("the first run", "the second run"):
            tr = SeqTrainer(HSTUModel(**SERVE, generator=torch.Generator().manual_seed(55), device=CARD), vocab_chunk_size=8192)
            tr.train_one_epoch(SeqLoader(*data, batch_size=BATCH), log_interval=0)
            runs[label] = params_of(tr)
            del tr
    counts = read_counts()
    check_equal(f"the serving HSTU, {DETERMINISM['steps']} steps through SeqTrainer under deterministic algorithms, twice", runs)
    n = SERVE["n_layers"] * DETERMINISM["steps"] * 2
    expected = {**{k: 0 for k in COUNTERS}, "hstu_rab_fwd": n, "hstu_rab_bwd_dq": n, "hstu_rab_bwd_dkv": n}
    print("  launches of the two runs: " + ", ".join(f"{k} {v}" for k, v in counts.items() if v))
    if counts != expected:
        raise AssertionError(f"the deterministic runs did not take K1 and the split pair once per layer per step: {counts}, expected {expected}")
    return counts


# ---------------------------------------------------------------------------
# 20. wide heads: the width-tiled variants
# ---------------------------------------------------------------------------

WIDE_SHAPES = ((160, 160), (256, 256), (320, 64), (64, 320), (384, 384))
WIDE_L = (200, 1024)
# examples_torch/generative/run_hstu.py at --d_model 1024: 4 heads of dqk = dv = 256, its default vocab and depth
WIDE_MODEL = dict(vocab=200, d_model=1024, n_layers=2, batch=8, seq_len=256)


def wide_case(seed, l, dqk, dv, b=2, h=2):
    """A rab case at dqk x dv, shuffled stamps and a scattered mask with one empty row."""
    c = rab_case(seed, b, l, max(l, 256), times="shuffled", mask="scattered", h=h, d=dqk)
    c["v"] = torch.from_numpy((np.random.default_rng(seed + 1).normal(size=(b, h, l, dv)) * 0.3).astype(np.float32)).cuda()
    return c


def wide_check(label, c, bf16):
    """The ten entries at one case: K1, K2, K2a + K2b and K3 (the case's own rab, materialised) against their plain
    versions, fp32 or bf16.  Returns the max abs errs by kernel name."""
    sfx = "_bf16" if bf16 else ""
    has_time = c["ts"] is not None
    c16 = bf16_case(c) if bf16 else c
    g32 = torch.from_numpy(np.random.default_rng(61).normal(size=tuple(c["v"].shape)).astype(np.float32)).cuda()
    g = g32.to(c16["v"].dtype)
    fwd_args = (c16["q"], c16["k"], c16["v"], c["pos_w"], c["ts_w"], c["ts"], c["mask"], c["alpha"], c["max_seq_len"], c["cfg"])
    bwd_args = (c16["q"], c16["k"], c16["v"], g, c["pos_w"], c["ts_w"], c["ts"], c["mask"], c["alpha"], c["max_seq_len"], c["cfg"], c["thr"])
    errs = {}
    out = run_kernel(c16)
    if bf16:
        f32_in = (*(c16[n].float() for n in ("q", "k", "v")), *fwd_args[3:])
        errs["hstu_rab_fwd" + sfx] = bf16_compare(f"{label} hstu_rab_fwd_bf16", out, rab.plain_forward_bf16(*fwd_args, has_time), rab.dense_forward(*f32_in, has_time))[0]
        plain = dict(zip(GRAD_NAMES, rab.plain_backward_bf16(*bwd_args[:-1], has_time)))
        f32 = dict(zip(GRAD_NAMES, rab.dense_backward(*(c16[n].float() for n in ("q", "k", "v")), g.float(), *bwd_args[4:-1], has_time)))
    else:
        errs["hstu_rab_fwd"] = check_close(f"{label} hstu_rab_fwd", out, run_plain(c), KERNEL_RTOL, KERNEL_ATOL)[0]
        plain = dict(zip(GRAD_NAMES, rab.dense_backward(*bwd_args[:-1], has_time)))
    for kernel, spec in BWD_KERNELS.items():
        got = dict(zip(spec["outs"], spec["fn"](*bwd_args)))
        worst = 0.0
        for o, t in got.items():
            if bf16:
                err = bf16_compare(f"{label} {kernel}_bf16 {o}", t, plain[o], f32[o])[0]
            else:
                tables = o in ("dpos", "dts")
                rtol, atol = (TABLE_RTOL, TABLE_ATOL_REL * float(plain[o].abs().max()) + 1e-12) if tables else (BWD_RTOL, BWD_ATOL)
                err = check_close(f"{label} {kernel} {o}", t, plain[o], rtol, atol)[0]
            worst = max(worst, err)
        errs[kernel + sfx] = worst
    bias = rab.dense_bias(c["pos_w"], c["ts_w"], c["ts"], c["q"].shape[2], c["max_seq_len"], c["cfg"], has_time).contiguous()
    with torch.no_grad():
        k3 = hstu_attention(c16["q"], c16["k"], c16["v"], bias, c["mask"], c["alpha"], c["max_seq_len"])
    if bf16:
        ref = attn.plain_forward_bf16(c16["q"], c16["k"], c16["v"], bias, c["mask"], c["alpha"], c["max_seq_len"]).float()
        err = float((k3.float() - ref).abs().max())
        if not (torch.isfinite(k3.float()).all() and err <= BF16_ULP_REL * float(ref.abs().max())):
            raise AssertionError(f"{label} hstu_attn_fwd_bf16: max abs err {err:.3e} beyond one bf16 ulp of the largest output")
        errs["hstu_attn_fwd_bf16"] = err
    else:
        errs["hstu_attn_fwd"] = check_close(f"{label} hstu_attn_fwd", k3, attn.dense_forward(c["q"], c["k"], c["v"], bias, c["mask"], c["alpha"], c["max_seq_len"]), KERNEL_RTOL, KERNEL_ATOL)[0]
    torch.cuda.synchronize()
    return errs


def wide_model(device, precision=None):
    kw = WIDE_MODEL
    model = HSTUModel(vocab_size=kw["vocab"], d_model=kw["d_model"], n_heads=4, n_layers=kw["n_layers"], dqk=kw["d_model"] // 4, dv=kw["d_model"] // 4, max_seq_len=kw["seq_len"],
                      dropout=0.0, generator=torch.Generator().manual_seed(63), device=device)
    return SeqTrainer(model, precision=precision, device=device)


def wide_phase(cycles_per_ms):
    """The ten kernels against their plain versions at the wide shapes (every check takes the width-tiled
    variant); the variants the model launches timed at (256, 256); the full-width HSTU at d_model 1024 (4 heads
    of 256): one step card against CPU, ``evaluate`` in fp32 and bf16.  Returns the model runs' launches and the
    ``kernels`` line's entries of those variants (their checks' max abs errs, their times and bounds)."""
    worst = {}
    reset_counts()
    attn.launches_wide.clear()
    for l in WIDE_L:
        for dqk, dv in WIDE_SHAPES:
            c = wide_case(60 + dqk + dv + l, l, dqk, dv)
            parts = []
            for bf16 in (False, True):
                for name, e in wide_check(f"L{l} ({dqk}, {dv})", c, bf16).items():
                    worst[name] = max(worst.get(name, 0.0), e)
                    parts.append(f"{name} {e:.2e}")
            print(f"  L{l} ragged to a scattered mask, dqk {dqk} dv {dv}, B2 H2, shuffled stamps: max abs err " + ", ".join(parts))
            del c
    print("  launches of the width-tiled variants in these checks: " + ", ".join(f"{k} {v}" for k, v in sorted({**rab.launches_wide, **attn.launches_wide}.items())))
    occ = {**rab.occupancy(1024, 256, 256, 1024, 128), **{f"{k} (bf16)": v for k, v in rab.occupancy_bf16(1024, 256, 256, 1024, 128).items()}}
    print("  L1024 dqk 256 dv 256: " + "; ".join(f"{k}: {n} CTAs per SM, {r} registers, {b:,} B shared per CTA, {v}" for k, (n, r, b, v) in occ.items()))

    # the variants run_hstu.py's d_model 1024 model launches, at its head width: device ms beside the plain
    # version's and the function's bound (the least time the card could take for the same work: 3xTF32 or bf16
    # on the tensor cores; the variants run fp32 FMAs, so their fp32-FMA bound is printed beside it)
    c = wide_case(70, 1024, 256, 256, b=8, h=4)
    c16 = bf16_case(c)
    has_time = c["ts"] is not None
    g = torch.from_numpy(np.random.default_rng(71).normal(size=tuple(c["v"].shape)).astype(np.float32)).cuda()
    args = (c["q"], c["k"], c["v"], g, c["pos_w"], c["ts_w"], c["ts"], c["mask"], c["alpha"], c["max_seq_len"], c["cfg"], c["thr"])
    fwd16 = (c16["q"], c16["k"], c16["v"], c["pos_w"], c["ts_w"], c["ts"], c["mask"], c["alpha"], c["max_seq_len"], c["cfg"], has_time)
    outs, out16 = rab.rab_backward_fused(*args), run_kernel(c16)
    b16 = bf16_bounds(2 * valid_pairs(c) * 2 * 256, input_bytes(c16) + out16.numel() * 2)
    runs = {
        "hstu_rab_fwd": (lambda: run_kernel(c), lambda: run_plain(c), rab_bound(c)),
        "hstu_rab_bwd": (lambda: rab.rab_backward_fused(*args), lambda: rab.dense_backward(*args[:-1], has_time), bwd_bound(c, g, "hstu_rab_bwd", outs)),
        "hstu_rab_fwd_bf16": (lambda: run_kernel(c16), lambda: rab.plain_forward_bf16(*fwd16), dict(fp32=None, tensor=None, bound_ms=b16[0], bound_by=b16[1])),
    }
    timings = {}
    reset_counts()
    for name, (kernel, plain, b) in runs.items():
        (ms, wall), (p_ms, _) = timed(kernel, cycles_per_ms, reps=10), timed(plain, cycles_per_ms, reps=3, warmup=1)  # the plain backward: 1 s a call
        timings[name] = dict(ms=ms, plain_ms=p_ms, bound_ms=b["bound_ms"], bound_by=b["bound_by"])
        extra = f"; fp32-FMA bound {b['fp32'][0]:.4f} ms ({b['fp32'][1]})" if b["fp32"] else f" (bf16 tensor-core FLOPs {b16[3]:.4f} ms, bytes {b16[2]:.4f} ms)"
        print(f"  {wide_name(name)} at B8 H4 L1024 dqk = dv = 256: device {ms:.4f} ms ({ms / b['bound_ms']:.1f}x the bound), host clock {wall:.4f} ms, plain {p_ms:.4f} ms, "
              f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}){extra}; medians of 10 (the plain version's of 3)")
    taken = read_counts()
    if any(taken.get(name, 0) for name in runs) or not all(taken.get(wide_name(name), 0) for name in runs):
        raise AssertionError(f"the timed calls at (256, 256) did not all take the width-tiled variants: {taken}")
    del c, c16, g, args, outs, out16, runs
    torch.cuda.empty_cache()

    # the full-width model: one step card against CPU from the same weights, then evaluate in fp32 and bf16
    kw = WIDE_MODEL
    data = serving_data(kw["batch"], kw["seq_len"], kw["vocab"], seed=64)
    reset_counts()
    rab.launches_wide.clear()
    trainers = {"cpu": wide_model(torch.device("cpu")), "card": wide_model(CARD)}
    losses = {d: tr.train_one_epoch(SeqLoader(*data, batch_size=kw["batch"]), log_interval=0) for d, tr in trainers.items()}
    if not (np.isfinite(list(losses.values())).all() and math.isclose(losses["card"], losses["cpu"], rel_tol=CTR_LOSS_RTOL, abs_tol=CTR_LOSS_ATOL)):
        raise AssertionError(f"the d_model 1024 HSTU's step: loss card {losses['card']}, CPU {losses['cpu']}")
    ratio, where = 0.0, ""
    for (name, a), p in zip(trainers["card"].model.named_parameters(), trainers["cpu"].model.parameters(), strict=True):
        r = ratio_of(a.grad, p.grad, GRAD_RTOL, GRAD_ATOL_REL * float(p.grad.abs().max()) + 1e-30)
        if r > ratio:
            ratio, where = r, name
    print(f"  run_hstu.py's HSTU at --d_model 1024 (4 heads of 256, {kw['n_layers']} layers, V{kw['vocab']}, dropout 0), one step of B{kw['batch']} x L{kw['seq_len']} card "
          f"against CPU from the same weights: loss {losses['card']:.7f} vs {losses['cpu']:.7f}; worst gradient max |d|/(atol+rtol|ref|) {ratio:.3f} ({where}; rtol {GRAD_RTOL}, "
          f"atol {GRAD_ATOL_REL} x the tensor's max)")
    if ratio > 1.0:
        raise AssertionError(f"the d_model 1024 HSTU's gradients on the card disagree with the CPU's: {ratio:.3f} ({where})")
    del trainers
    loader = SeqLoader(*data, batch_size=kw["batch"])
    evals = {precision: wide_model(CARD, precision).evaluate(loader) for precision in (None, "bf16")}
    print(f"  evaluate (loss, top-1): fp32 {evals[None]}, bf16 {evals['bf16']}")
    if not all(np.isfinite(v).all() for v in evals.values()) or not math.isclose(evals["bf16"][0], evals[None][0], rel_tol=BF16_LOSS_RTOL):
        raise AssertionError(f"the d_model 1024 HSTU's evaluate: {evals}")
    counts = read_counts()
    n = kw["n_layers"]
    expected = {**{k: 0 for k in COUNTERS}, wide_name("hstu_rab_fwd"): 2 * n, wide_name("hstu_rab_bwd"): n, wide_name("hstu_rab_fwd_bf16"): n}
    print("  the model runs' launches: " + ", ".join(f"{k} {v}" for k, v in counts.items() if v))
    if counts != expected:
        raise AssertionError(f"the d_model 1024 HSTU did not launch each kernel's width-tiled variant (and only it) once per layer: {counts}, expected {expected}")
    torch.cuda.empty_cache()
    return counts, {wide_name(name): {**t, "max_abs_err": worst[name]} for name, t in timings.items()}


# ---------------------------------------------------------------------------
# 21. the tutorials
# ---------------------------------------------------------------------------

TUTORIALS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tutorials_torch")
TUTORIALS_PHASE_S = 120.0


def tutorials_phase():
    """Every code cell of the seven notebooks of ``tutorials_torch/`` in order, one namespace a notebook, from that
    directory as Jupyter runs them, on the card (``TORCH_RECHUB_DEVICE`` unset); each notebook's seconds and the last
    line it printed; its temporary directory removed."""
    names = sorted(f for f in os.listdir(TUTORIALS_DIR) if f.endswith(".ipynb"))
    if len(names) != 7:
        raise AssertionError(f"tutorials_torch/ holds {names}, not the seven notebooks")
    prior, cwd = os.environ.pop("TORCH_RECHUB_DEVICE", None), os.getcwd()
    reset_counts()
    t_phase = time.perf_counter()
    try:
        for name in names:
            with open(os.path.join(TUTORIALS_DIR, name)) as f:
                cells = ["".join(c["source"]) for c in json.load(f)["cells"] if c["cell_type"] == "code"]
            ns, buf = {}, io.StringIO()
            os.chdir(TUTORIALS_DIR)
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(buf):
                    for i, src in enumerate(cells):
                        exec(compile(src, f"{name}::cell{i}", "exec"), ns)
                torch.cuda.synchronize()
            finally:
                os.chdir(cwd)
            seconds = time.perf_counter() - t0
            lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
            print(f"  {name}: {len(cells)} code cells on {ns['DEVICE']} in {seconds:.2f} s; its last line: {lines[-1][:160] if lines else '(none)'}")
            if ns["DEVICE"].type != "cuda":
                raise AssertionError(f"{name} ran on {ns['DEVICE']}, not the card")
            shutil.rmtree(ns["OUT"], ignore_errors=True)
    finally:
        if prior is not None:
            os.environ["TORCH_RECHUB_DEVICE"] = prior
    total = time.perf_counter() - t_phase
    print(f"  the seven notebooks: {total:.1f} s (limit {TUTORIALS_PHASE_S:g} s); the port's kernels launched: " + (", ".join(f"{k} {v}" for k, v in read_counts().items() if v) or "none"))
    if total > TUTORIALS_PHASE_S:
        raise AssertionError(f"the tutorials took {total:.1f} s, beyond {TUTORIALS_PHASE_S:g} s")
    if any(read_counts().values()):
        raise AssertionError(f"a tutorial launched an HSTU attention kernel: {read_counts()}")


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False  # bf16 GEMMs sum in f32, as the CPU's
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    print("build:")
    seconds = _build.build_all()
    for name, log in _build.build_log.items():
        print(f"  {name}:\n" + "\n".join("    " + line for line in log.strip().splitlines()))
    print(f"  built in {seconds:.2f} s")
    for shape in ((256, 32, 32, 256, 128), (1024, 32, 32, 1024, 128)):
        occ = {**rab.occupancy(*shape), "hstu_attn_fwd": attn.occupancy(*shape[:3])}
        print(f"  L{shape[0]} dqk {shape[1]} dv {shape[2]}: " + "; ".join(f"{k}: {c} CTAs per SM, {r} registers, {b:,} B shared per CTA, {v}" for k, (c, r, b, v) in occ.items()))
    c, r, b, v = attn.occupancy(1024, 256, 128)
    print(f"  dqk 256 dv 128 (32-key stages): hstu_attn_fwd: {c} CTAs per SM, {r} registers, {b:,} B shared per CTA, {v}")
    for shape in ((256, 32, 32, 256, 128), (1024, 32, 32, 1024, 128)):
        occ = {**{k: rab.launch_shape_bf16(k, *shape) for k in ("hstu_rab_fwd_bf16",) + rab.BWD_ENTRIES_BF16},
               **{f"hstu_attn_fwd_bf16 ({name} bias)": attn.occupancy_bf16(*shape[:3], name == "bf16") for name in ("f32", "bf16")}}
        print(f"  L{shape[0]} dqk {shape[1]} dv {shape[2]}, bf16: " + "; ".join(f"{k}: {c} CTAs per SM, {r} registers, {b:,} B shared per CTA, {st} ring stages, {v}" for k, (c, r, b, st, v) in occ.items()))
    print("  dqk 256 dv 128, bf16: " + "; ".join(f"hstu_attn_fwd_bf16 ({name} bias): {c} CTAs per SM, {r} registers, {b:,} B shared per CTA, {st} ring stages, {v}"
                                            for name in ("f32", "bf16") for c, r, b, st, v in [attn.occupancy_bf16(1024, 256, 128, name == "bf16")]))

    cycles_per_ms = spin_cycles_per_ms()
    cases = kernel_cases()
    print("kernel phase (hstu_rab_fwd vs plain PyTorch, fp32):")
    measured = {"hstu_rab_fwd": kernel_phase(cases, cycles_per_ms)}
    print("backward kernel phase (hstu_rab_bwd, hstu_rab_bwd_dq + hstu_rab_bwd_dkv vs the plain backward, fp32):")
    measured.update(backward_phase(cases, cycles_per_ms))
    print("bucket sweep (hstu_rab_fwd, hstu_rab_bwd and hstu_rab_bwd_dq + hstu_rab_bwd_dkv at every threshold -1, 0, +1 and |dt| = 2**31, vs the plain version on the CPU):")
    for name, err in sweep_phase().items():
        measured[name]["max_abs_err"] = max(measured[name]["max_abs_err"], err)
    print(f"bf16 kernel phase (hstu_rab_fwd_bf16, hstu_rab_bwd_bf16, hstu_rab_bwd_dq_bf16 + hstu_rab_bwd_dkv_bf16 vs their plain bf16 versions and the fp32 kernels; "
          f"the bucket sweep in bf16; bounds at {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16):")
    print("  " + subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0])
    measured.update(bf16_kernel_phase(cases, cycles_per_ms))
    torch.cuda.empty_cache()
    del cases
    print("materialised-bias attention phase (hstu_attention: hstu_attn_fwd vs plain PyTorch and vs hstu_rab_fwd, fp32):")
    bcases = bias_cases()
    k3 = attention_phase(bcases, cycles_per_ms)
    print("bf16 materialised-bias attention phase (hstu_attention on bf16 q, k, v: hstu_attn_fwd_bf16 vs plain_forward_bf16 and the fp32 K3; f32 and bf16 bias):")
    k3_bf16 = bf16_attention_phase(bcases, cycles_per_ms)
    del bcases
    torch.cuda.empty_cache()

    print("serving phase (full-width HSTU through SeqTrainer):")
    launches = collections.defaultdict(int, {name: 0 for name in COUNTERS})  # wide_name(...) keys where a variant ran
    launches["hstu_rab_fwd"] = serving_phase(cycles_per_ms)
    print("training phase (full-width HSTU through SeqTrainer.train_one_epoch):")
    for name, n in training_phase(cycles_per_ms).items():
        launches[name] += n

    # the DeepFM path runs PyTorch's own kernels only: none of the port's is launched there
    reset_counts()
    attn.launches = attn.launches_bf16 = 0
    print("DeepFM serving phase (bench.py's small config through CTRTrainer.predict / evaluate; one batch at the Criteo-full geometry):")
    ctr_serving_phase(cycles_per_ms)
    print("DeepFM training phase (bench.py's small config through CTRTrainer.train_one_epoch; a step against the CPU; fit):")
    ctr_training_phase()
    print("DeepFM sparse training phase (the Criteo-full geometry with sparse_embedding=\"adagrad\"; the small config fused, card against CPU; fit):")
    t0 = time.perf_counter()
    ctr_sparse_phase(cycles_per_ms)
    print(f"  DeepFM sparse training phase: {time.perf_counter() - t0:.1f} s")
    print("ranking zoo phase (10 Criteo-shaped and 3 sequence configurations through CTRTrainer; card against CPU; fit):")
    zoo_phase()
    print("matching phase (the 13 classes at MovieLens-1M's widths through MatchTrainer; card against CPU; fit and match_evaluation):")
    matching_phase()
    print("production matching phase (YoutubeDNN, 8M items, in-batch negatives, sparse_embedding=\"adagrad\"; exact top-10 retrieval over 8M items):")
    prod_phase(cycles_per_ms)
    print("multi-task phase (the 5 classes over Ali-CCP's schema through MTLTrainer; UWL, GradNorm, MetaBalance; sparse tables; card against CPU; fit):")
    mtl_phase()
    print("RQ-VAE phase (RQVAEModel at the default widths through RQVAETrainer; generate_semantic_ids; card against CPU):")
    rqvae_phase()
    print("HLLM phase (HLLMModel at the default widths through SeqTrainer on the HSTU cell's geometry; card against CPU; serving, training, fit):")
    hllm_phase(cycles_per_ms)
    print("TIGER phase (TIGERModel at the paper's widths on RQ-VAE semantic ids; card against CPU; AdamW steps; trie-constrained generate, recall@10 and @1):")
    tiger_phase()
    print("bf16 DeepFM, DSSM and MMOE phase (precision=\"bf16\" through CTRTrainer, MatchTrainer and MTLTrainer; card against CPU; fit):")
    bf16_ctr_match_mtl_phase()
    ctr_launches = {**read_counts(), "hstu_attn_fwd": attn.launches, "hstu_attn_fwd_bf16": attn.launches_bf16}
    print("  the port's kernels launched by the DeepFM, ranking zoo, matching, multi-task, RQ-VAE, HLLM and TIGER phases: " + ", ".join(f"{k} {v}" for k, v in ctr_launches.items()))
    if any(ctr_launches.values()):
        raise AssertionError(f"the DeepFM, ranking zoo, matching, multi-task, RQ-VAE, HLLM or TIGER path launched an HSTU attention kernel: {ctr_launches}")

    reset_counts()
    print("HSTU sparse training phase (the full-width untied HSTU, sampled softmax, sparse_embedding=\"adagrad\", through K1 and K2):")
    t0 = time.perf_counter()
    for name, n in hstu_sparse_phase().items():
        launches[name] += n
    print(f"  HSTU sparse training phase: {time.perf_counter() - t0:.1f} s")
    print("bf16 HSTU phase (the full-width HSTU under SeqTrainer(precision=\"bf16\"): serving, training with three losses through the bf16 K1 and K2, "
          "a step through K2a-bf16 + K2b-bf16; card against CPU; fit):")
    launches.update(bf16_hstu_phase(cycles_per_ms))
    print("lifecycle phase (the serving HSTU: 8 steps straight twice and 4 + a checkpoint + resume + 4, through K2 and through K2a + K2b; export, int8 and fp16 "
          "export served one request each; the registered op's dispatch cost; a traced step.  DeepFM at the Criteo-full geometry with sparse Adagrad on the "
          "prefetching loop: step checkpoints, resume):")
    for name, n in lifecycle_phase(cycles_per_ms).items():
        launches[name] += n
    print("mesh phase ((a) the serving HSTU on a (1, 1) mesh over NCCL against mesh=None through K2a + K2b and K2; two gloo ranks sharing the card: (b) the HSTU at "
          "V65,536 under (2, 1) and (1, 2), (c) DeepFM at the Criteo-full geometry with sparse Adagrad under (1, 2), (d) exact top-10 over 1M items split over the ranks, "
          "(e) MMOE over Ali-CCP's schema under (2, 1) with the mean, UWL, GradNorm and MetaBalance and under (1, 2) fused with sparse Adagrad, (f) the RQ-VAE with its k-means init "
          "under (2, 1)):")
    print("  " + subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0])
    for name, n in mesh_phase().items():
        launches[name] += n
    print("approximate retrieval phase ((g) the native HNSW index over 30,000 unit-norm items of d64 against exact top-10 on the card; the legacy Annoy and Faiss engines):")
    reset_counts()
    ann_phase(cycles_per_ms)
    if any(read_counts().values()):
        raise AssertionError(f"the retrieval phase launched an HSTU attention kernel: {read_counts()}")
    print("examples phase (every script of examples_torch/ through its argv entry on the card; the production HSTU recipe at V686k, d256, 4 x 64 heads, B8 x L256, "
          "S2048 through K1 and K2, its step card against CPU; the Criteo-full recipe without and with a (1, 1) mesh):")
    print("  " + subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0])
    example_launches, example_errs = examples_phase(cycles_per_ms)
    for name, n in example_launches.items():
        launches[name] += n
    for name, err in example_errs.items():
        measured[name]["max_abs_err"] = max(measured[name]["max_abs_err"], err)
    print("determinism phase (K2, K2a, K2-bf16 and K2a-bf16 twice at the serving shape, L1024 and the production recipe's shape: dpos and dts bit for bit, timed; "
          "the serving HSTU's 4 steps twice under torch.use_deterministic_algorithms through the split pair):")
    print("  " + subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0])
    t0 = time.perf_counter()
    for name, n in determinism_phase(cycles_per_ms).items():
        launches[name] += n
    print(f"  determinism phase: {time.perf_counter() - t0:.1f} s")
    print("wide-head phase (the ten kernels at (dqk, dv) = (160, 160), (256, 256), (320, 64), (64, 320), (384, 384), L200 and L1024, fp32 and bf16, against their plain "
          "versions; the width-tiled K1, K2 and K1-bf16 timed at (256, 256); run_hstu.py's HSTU at --d_model 1024: a step card against CPU, evaluate in fp32 and bf16):")
    t0 = time.perf_counter()
    wide_launches, wide_measured = wide_phase(cycles_per_ms)
    for name, n in wide_launches.items():
        launches[name] += n
    print(f"  wide-head phase: {time.perf_counter() - t0:.1f} s")
    print("tutorials phase (every code cell of the seven notebooks of tutorials_torch/ on the card):")
    tutorials_phase()

    sources = {"hstu_rab_fwd": ("hstu_rab_fwd.cu", "hstu_rab_attention.py:267"), **{k: ("hstu_rab_bwd.cu", f"hstu_rab_attention.py:{v['line']}") for k, v in BWD_KERNELS.items()},
               "hstu_attn_fwd": ("hstu_attn_fwd.cu", "hstu_attention.py:45"), **BF16_KERNELS}
    launches["hstu_attn_fwd"] = k3.pop("launches")  # the op's own path: it lies on no model's path
    launches["hstu_attn_fwd_bf16"] = k3_bf16.pop("launches")
    measured.update(hstu_attn_fwd=k3, hstu_attn_fwd_bf16=k3_bf16)
    measured.update(wide_measured)
    for name in [name for name, n in launches.items() if n and name not in sources]:  # the width-tiled variants the paths launched
        base = name.removesuffix("_wide")
        if name not in measured:
            raise AssertionError(f"{base}'s width-tiled variant ran on a path but was not timed: {dict(launches)}")
        sources[name] = ("hstu_wide.cuh", sources[base][1])
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"torch_rechub_tpu_torch/csrc/{src}",
        "replaces": f"torch_rechub_tpu/ops/pallas/{tpu}",
        "launches": launches[name],  # serving, training, sparse training, lifecycle, mesh and examples paths (bf16: the bf16 ones; K2a-, K2b-bf16 the split step); K3: the calls of its own phase
        "max_abs_err": measured[name]["max_abs_err"],
        "ms": measured[name]["ms"],
        "plain_ms": measured[name]["plain_ms"],
        "bound_ms": measured[name]["bound_ms"],
        "bound_by": measured[name]["bound_by"],
        # no single PyTorch call computes silu attention, or its backward, with a
        # rab bias: scaled_dot_product_attention has a softmax
        "library_ms": None,
    } for name, (src, tpu) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
