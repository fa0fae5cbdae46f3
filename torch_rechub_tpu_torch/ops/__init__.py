from .chunked_ce import chunked_last_logits, chunked_logsumexp, chunked_next_token_loss
from .embedding import EmbeddingCollection, feature_mask, pool_sequence

__all__ = ["EmbeddingCollection", "feature_mask", "pool_sequence", "chunked_logsumexp", "chunked_next_token_loss", "chunked_last_logits"]
