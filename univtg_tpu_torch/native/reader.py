"""Python surface of the native .npz feature reader; after
``univtg_tpu/native/reader.py``.

``read_npz(path)`` decodes one per-id feature archive in one ctypes call:
the C++ side (native/src/feature_reader.cpp) parses the zip, inflates the
DEFLATE stream, parses the npy header, converts f2/f8 to f32 and fuses the
row L2 normalization, all with the GIL released. A file it cannot handle
(zip64, not 2-D, exotic dtypes, corruption) comes back as None, and
``FeatureSource`` reads it with np.load; ``rejections`` counts them. A
library that does not build raises (native/build.py). The C++ side reads a
batch of paths on a thread pool; the JAX module's ``read_npz_batch`` is not
ported until a loader batches its reads.

Reference semantics being accelerated: np.load(...)[key].astype(float32)
followed by l2_normalize (main/dataset.py:680-696,
utils/basic_utils.py:97-99).
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

from univtg_tpu_torch.native.build import load_feature_reader

# files this process's reads returned None for; a caller resets and reads it
# to show that its files went through the native path
rejections = 0
_count_lock = threading.Lock()


def native_io_enabled() -> bool:
    """Native feature IO is opt-in (UNIVTG_NATIVE_IO=1): its L2 norm
    accumulates in float64 like numpy's but may differ from np.linalg.norm
    in the last ulp, so the default path stays bit-identical to numpy."""
    return os.environ.get("UNIVTG_NATIVE_IO", "0") == "1"


def read_npz(
    path: str, key: str = "features", normalize: bool = True
) -> Optional[np.ndarray]:
    """Read one .npz feature file natively: a float32 (rows, cols) array, or
    None when the reader rejects the file (not 2-D, zip64, exotic dtype,
    corruption, missing)."""
    global rejections
    lib = load_feature_reader()
    c_paths = (ctypes.c_char_p * 1)(path.encode())
    out_ptrs = (ctypes.POINTER(ctypes.c_float) * 1)()
    out_rows = (ctypes.c_int64 * 1)()
    out_cols = (ctypes.c_int64 * 1)()
    lib.read_npz_batch(c_paths, 1, key.encode(), 1 if normalize else 0,
                       out_ptrs, out_rows, out_cols, 1)
    try:
        rows, cols = out_rows[0], out_cols[0]
        if rows < 0 or not out_ptrs[0]:
            with _count_lock:
                rejections += 1
            return None
        buf = np.ctypeslib.as_array(out_ptrs[0], shape=(int(rows), int(cols)))
        return np.array(buf, dtype=np.float32)  # own the memory
    finally:
        lib.free_feature_buffers(out_ptrs, 1)
