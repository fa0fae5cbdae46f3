from .ctr_trainer import CTRTrainer
from .match_trainer import MatchTrainer
from .mtl_trainer import MTLTrainer
from .rqvae_trainer import RQVAETrainer
from .seq_trainer import SeqTrainer

__all__ = ["CTRTrainer", "MatchTrainer", "MTLTrainer", "RQVAETrainer", "SeqTrainer"]
