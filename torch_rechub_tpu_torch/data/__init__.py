from .convert import pa_array_to_numpy
from .dataset import ParquetIterableDataset, prefetch_to_device

__all__ = ["ParquetIterableDataset", "pa_array_to_numpy", "prefetch_to_device"]
