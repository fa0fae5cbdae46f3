"""Comirec (arXiv:2005.09347), controllable multi-interest retrieval.

Counterpart of ``torch_rechub_tpu/models/matching/comirec.py``: MIND's
frame (``mind.MultiInterestFrame``) with two interest extractors,
``ComirecSA`` (self-attentive ``MultiInterestSA``) and ``ComirecDR``
(capsule routing, bilinear type 2).
"""

from __future__ import annotations

from typing import Optional

import torch

from ...basic.layers import CapsuleNetwork, MultiInterestSA
from .mind import MultiInterestFrame


class ComirecSA(MultiInterestFrame):
    """Comirec (arXiv:2005.09347) with the self-attentive extractor ``MultiInterestSA``."""

    def __init__(self, user_features=(), history_features=(), item_features=(), neg_item_feature=(), temperature: float = 1.0, interest_num: int = 4, generator: Optional[torch.Generator] = None, device=None):
        super().__init__(user_features, history_features, item_features, neg_item_feature, temperature, interest_num, generator, device)
        self.multi_interest_sa = MultiInterestSA(self.history_features[0].embed_dim, interest_num, generator=generator, device=device)

    def _interests(self, hist, mask, generator):
        return self.multi_interest_sa(hist, mask[..., None])


class ComirecDR(MultiInterestFrame):
    """Comirec with capsule routing, bilinear type 2 (a per-position weight, routing from 0)."""

    def __init__(self, user_features=(), history_features=(), item_features=(), neg_item_feature=(), temperature: float = 1.0, interest_num: int = 4, max_length: int = 50, generator: Optional[torch.Generator] = None, device=None):
        super().__init__(user_features, history_features, item_features, neg_item_feature, temperature, interest_num, generator, device)
        self.max_length = max_length
        self.capsule = CapsuleNetwork(self.history_features[0].embed_dim, max_length, bilinear_type=2, interest_num=interest_num, generator=generator, device=device)

    def _interests(self, hist, mask, generator):
        return self.capsule(hist, mask, generator)
