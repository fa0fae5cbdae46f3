"""pyarrow -> numpy conversion.

Counterpart of ``torch_rechub_tpu/data/convert.py``; ``pyarrow`` is imported
where it is used, so the package imports without it.
"""

from __future__ import annotations

import numpy as np


def pa_array_to_numpy(array, dtype=np.float32) -> np.ndarray:
    """Convert a pyarrow array/chunked-array to a dense numpy array.

    Scalars become 1-D; fixed-width lists become 2-D; ragged lists raise
    (matching the reference's rejection of ragged columns).
    """
    import pyarrow as pa

    if isinstance(array, pa.ChunkedArray):
        array = array.combine_chunks()
    if pa.types.is_list(array.type) or pa.types.is_large_list(array.type) or pa.types.is_fixed_size_list(array.type):
        if pa.types.is_fixed_size_list(array.type):
            width = array.type.list_size
        else:
            widths = np.diff(np.asarray(array.offsets))
            if len(widths) and not np.all(widths == widths[0]):
                raise ValueError(f"ragged list column (widths {np.unique(widths)[:5]}...) cannot convert to a dense array")
            width = int(widths[0]) if len(widths) else 0
        flat = np.asarray(array.flatten(), dtype=dtype)
        return flat.reshape(-1, width)
    return np.asarray(array, dtype=dtype)
