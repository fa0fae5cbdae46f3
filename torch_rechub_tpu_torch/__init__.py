"""PyTorch / CUDA port of ``torch_rechub_tpu`` for NVIDIA Hopper (H100).

The JAX package ``torch_rechub_tpu`` is the reference; this package mirrors
its module paths and its package surface (``__all__`` of the package and of
``basic``, ``ops`` and ``utils``), so each counterpart is easy to find.  It
imports ``torch`` and ``numpy`` only: never ``jax``, ``flax``, ``optax`` or
the JAX package.  Importing it builds nothing: the CUDA kernels are built
with ``nvcc`` at their first launch.

What it holds: the feature schema and ``EmbeddingCollection``; the ranking
zoo (DeepFM and the rest) through ``CTRTrainer``; the 13 matching models
through ``MatchTrainer`` and exact top-k retrieval (``serving``); the
multi-task models through ``MTLTrainer`` and RQ-VAE through
``RQVAETrainer``; HSTU, HLLM and TIGER through ``SeqTrainer`` and their own
loops; sparse row-wise embedding updates and bf16 mixed precision
(``basic/precision.py``) on every trainer; the trainer lifecycle (step
checkpoints with exact resume, ``torch.export`` and quantized export, the
model summary, profiling hooks) and the Parquet input pipeline (``data``).
Every TPU kernel of the JAX
package is a CUDA kernel written for Hopper (``csrc/``), in fp32 and bf16:
HSTU's rab attention forward (K1) and backward (K2, or the split K2a + K2b),
and the materialised-bias attention ``ops.cuda.hstu_attention`` (K3).  The
(data, model) mesh of ``torch.distributed`` ranks (``parallel``) trains
``SeqTrainer``, ``CTRTrainer`` and ``MatchTrainer`` and splits exact
retrieval.  Not ported yet: ``mesh=`` on ``MTLTrainer`` and
``RQVAETrainer``, the approximate retrieval backends and the benchmark
registry and examples.
"""

__version__ = "0.1.0"

from .basic import features
from .basic.features import DenseFeature, SequenceFeature, SparseFeature

__all__ = ["DenseFeature", "SparseFeature", "SequenceFeature", "features", "__version__"]
