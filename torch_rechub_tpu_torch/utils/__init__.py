from . import data

__all__ = ["data"]
