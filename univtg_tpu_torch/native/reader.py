"""Python surface of the native .npz feature reader; after
``univtg_tpu/native/reader.py``.

``read_npz_batch(paths)`` decodes many per-id feature archives in one
ctypes call (``read_npz(path)`` one): the C++ side
(native/src/feature_reader.cpp) parses the zip, inflates the DEFLATE
stream, parses the npy header, converts f2/f8 to f32 and fuses the row L2
normalization, all with the GIL released, on its own thread pool. A file it
cannot handle (zip64, not 2-D, exotic dtypes, corruption) comes back as
None, and ``FeatureSource`` reads it with np.load; ``rejections`` counts
them. A library that does not build raises (native/build.py), where JAX's
returns None.

Reference semantics being accelerated: np.load(...)[key].astype(float32)
followed by l2_normalize (main/dataset.py:680-696,
utils/basic_utils.py:97-99).
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional, Sequence

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


def read_npz_batch(
    paths: Sequence[str],
    key: str = "features",
    normalize: bool = True,
    n_threads: int = 8,
) -> List[Optional[np.ndarray]]:
    """Read many .npz feature files natively, in one call on the C++ side's
    thread pool of ``n_threads``: a list aligned with ``paths`` of float32
    (rows, cols) arrays, or None for each file the reader rejects (not 2-D,
    zip64, exotic dtype, corruption, missing); ``[]`` for no paths."""
    global rejections
    lib = load_feature_reader()
    if not paths:
        return []
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    out_ptrs = (ctypes.POINTER(ctypes.c_float) * n)()
    out_rows = (ctypes.c_int64 * n)()
    out_cols = (ctypes.c_int64 * n)()
    lib.read_npz_batch(c_paths, n, key.encode(), 1 if normalize else 0,
                       out_ptrs, out_rows, out_cols, n_threads)
    results: List[Optional[np.ndarray]] = []
    try:
        for i in range(n):
            rows, cols = out_rows[i], out_cols[i]
            if rows < 0 or not out_ptrs[i]:
                results.append(None)
                continue
            buf = np.ctypeslib.as_array(out_ptrs[i], shape=(int(rows), int(cols)))
            results.append(np.array(buf, dtype=np.float32))  # own the memory
    finally:
        lib.free_feature_buffers(out_ptrs, n)
    with _count_lock:
        rejections += sum(r is None for r in results)
    return results


def read_npz(
    path: str, key: str = "features", normalize: bool = True
) -> Optional[np.ndarray]:
    """Read one .npz feature file natively: a float32 (rows, cols) array, or
    None when the reader rejects the file."""
    return read_npz_batch([path], key=key, normalize=normalize, n_threads=1)[0]
