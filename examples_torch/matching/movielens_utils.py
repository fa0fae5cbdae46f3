"""MovieLens evaluation helper of the PyTorch port (as ``examples/matching/movielens_utils.py``): exact top-k
retrieval on the card + ``topk_metrics``, with the multi-interest merge handled inside
``torch_rechub_tpu_torch.serving.match_evaluation``."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from torch_rechub_tpu_torch.serving import match_evaluation  # noqa: F401  (public re-export)
