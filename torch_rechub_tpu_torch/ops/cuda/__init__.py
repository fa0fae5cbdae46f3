from typing import Dict, Tuple

from . import hstu_attention as _attention
from . import hstu_rab_attention as _rab_attention
from .hstu_attention import hstu_attention

__all__ = ["hstu_attention", "launch_counts", "add_launch_counts", "kernel_switches"]

_COUNTING = (_attention, _rab_attention)  # the modules whose ``launches*`` counters count the port's kernel launches


def launch_counts() -> Dict[Tuple[str, ...], int]:
    """Every kernel launch counter of the port: ``{(module, counter): n}``, and ``{(module, counter, entry): n}`` for
    the per-entry counts of the width-tiled variants (``launches_wide``)."""
    out = {}
    for mod in _COUNTING:
        for name, value in vars(mod).items():
            if not name.startswith("launches"):
                continue
            if isinstance(value, dict):
                out.update({(mod.__name__, name, entry): n for entry, n in value.items()})
            else:
                out[(mod.__name__, name)] = value
    return out


def add_launch_counts(counts: Dict[Tuple[str, ...], int]) -> None:
    """Add ``counts`` (keys as :func:`launch_counts` gives them, negative counts allowed) to the launch counters: a
    CUDA graph's replay advances them by the launches its capture counted."""
    mods = {mod.__name__: mod for mod in _COUNTING}
    for key, n in counts.items():
        mod = mods[key[0]]
        if len(key) == 2:
            setattr(mod, key[1], getattr(mod, key[1]) + n)
        else:
            table = getattr(mod, key[1])
            table[key[2]] = table.get(key[2], 0) + n


def kernel_switches() -> tuple:
    """The process-wide switches that choose which of the port's kernels a call launches: the rab attention's fused
    backward (K2) or its split pair (K2a + K2b), ``hstu_rab_attention._FUSED_BWD``."""
    return (_rab_attention._FUSED_BWD[0],)
