"""PyTorch / CUDA port of ``torch_rechub_tpu`` for NVIDIA Hopper (H100).

The JAX package ``torch_rechub_tpu`` is the reference; this package mirrors
its module paths so each counterpart is easy to find.  It imports ``torch``
and ``numpy`` only: never ``jax``, ``flax``, ``optax`` or the JAX package.

Ported so far: the HSTU serving and training paths (``HSTUModel`` through
``SeqTrainer.fit`` / ``train_one_epoch`` / ``evaluate`` / ``predict_logits``),
whose attention runs hand-written CUDA kernels on the card, forward
(``csrc/hstu_rab_fwd.cu``) and backward (``csrc/hstu_rab_bwd.cu``); and
the materialised-bias op ``ops.cuda.hstu_attention`` (``csrc/hstu_attn_fwd.cu``);
the DeepFM / CTR path and the ranking zoo through ``CTRTrainer``, with sparse
row-wise embedding updates; the 13 matching models through ``MatchTrainer``
and exact top-k retrieval (``serving``).
"""

__version__ = "0.1.0"
