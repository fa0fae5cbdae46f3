from .aitm import AITM, AttentionLayer
from .esmm import ESMM
from .mmoe import MMOE
from .ple import CGC, PLE
from .shared_bottom import SharedBottom

__all__ = ["SharedBottom", "ESMM", "MMOE", "PLE", "CGC", "AITM", "AttentionLayer"]
