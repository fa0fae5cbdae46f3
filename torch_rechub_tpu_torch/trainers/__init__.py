from .ctr_trainer import CTRTrainer
from .seq_trainer import SeqTrainer

__all__ = ["CTRTrainer", "SeqTrainer"]
