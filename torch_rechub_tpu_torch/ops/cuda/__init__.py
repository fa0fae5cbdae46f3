from .hstu_attention import hstu_attention

__all__ = ["hstu_attention"]
