from .ctr_trainer import CTRTrainer
from .match_trainer import MatchTrainer
from .seq_trainer import SeqTrainer

__all__ = ["CTRTrainer", "MatchTrainer", "SeqTrainer"]
