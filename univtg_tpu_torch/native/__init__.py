"""Native host kernels of the port, built with g++ at first use
(native/build.py): batched detection AP (src/ap_kernel.cpp, run by
evals/ap.py:detection_ap_batch) and the .npz feature reader
(src/feature_reader.cpp, native/reader.py, opt-in through
UNIVTG_NATIVE_IO=1)."""
from univtg_tpu_torch.native.build import load_ap_kernel  # noqa: F401
