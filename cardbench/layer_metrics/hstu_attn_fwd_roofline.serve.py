"""The HSTU attention forward's share of its roofline in serving (K1 in eval), as the training one."""

from cardbench.layer_metrics._attention import forward as read  # noqa: F401
