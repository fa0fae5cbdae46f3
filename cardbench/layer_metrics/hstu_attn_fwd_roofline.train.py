"""The HSTU attention forward's share of its roofline in training: the frozen K1 bound at each traced
step's shapes and valid pairs, times the calls, over the device time of every kernel that implements it."""

from cardbench.layer_metrics._attention import forward as read  # noqa: F401
