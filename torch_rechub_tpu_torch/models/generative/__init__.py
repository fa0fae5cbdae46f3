from .hstu import HSTUModel

__all__ = ["HSTUModel"]
