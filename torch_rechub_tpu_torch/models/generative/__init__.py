from .hllm import HLLMModel, HLLMTransformerBlock
from .hstu import HSTUModel
from .rqvae import RQVAEModel, ResidualVectorQuantizer, VectorQuantizer
from .tiger import TIGERModel

__all__ = ["HSTUModel", "HLLMModel", "HLLMTransformerBlock", "RQVAEModel", "ResidualVectorQuantizer", "VectorQuantizer", "TIGERModel"]
