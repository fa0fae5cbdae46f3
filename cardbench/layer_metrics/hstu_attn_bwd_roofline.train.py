"""The HSTU attention backward's share of its roofline: the frozen bound of the fused backward (K2) at
each traced step's shapes, times the calls, over the device time of every kernel that implements the backward."""

from cardbench.layer_metrics._attention import backward as read  # noqa: F401
