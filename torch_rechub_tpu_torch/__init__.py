"""PyTorch / CUDA port of ``torch_rechub_tpu`` for NVIDIA Hopper (H100).

The JAX package ``torch_rechub_tpu`` is the reference; this package mirrors
its module paths so each counterpart is easy to find.  It imports ``torch``
and ``numpy`` only: never ``jax``, ``flax``, ``optax`` or the JAX package.

Ported so far: the HSTU serving path (``HSTUModel`` inference through
``SeqTrainer.evaluate`` / ``SeqTrainer.predict_logits``), whose attention
runs a hand-written CUDA kernel (``csrc/hstu_rab_fwd.cu``) on the card.
"""

__version__ = "0.1.0"
