"""Build and load the port's native host kernels; after
``univtg_tpu/native/build.py``.

g++ compiles each ``native/src/<name>.cpp`` into a shared library with a
plain C interface, loaded with ``ctypes``. The build runs at first use, into
``univtg_tpu_torch/_build/`` (git-ignored), keyed by a hash of the source,
the flags, the compiler's version and the target that ``-march=native``
resolves to on this CPU, so an edited source, another g++ or another CPU
rebuilds and an unchanged build loads at once. Each build writes a
temporary file and renames it into place, so processes building at once
never load half a library. A failed compile or dlopen raises
``NativeBuildError`` quoting the compiler: there is no quiet numpy fallback
(the JAX package's loader returns None there).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, Sequence

SRC_DIR = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_libraries: dict[str, ctypes.CDLL] = {}
_compiler_ids: dict[str, bytes] = {}


class NativeBuildError(RuntimeError):
    """The compiler is missing, refused a source, or its library did not load."""


def _compiler_identity() -> bytes:
    """``CXX --version`` and the target options ``-march=native`` turns on
    here (``-Q --help=target``); probed once per process and compiler."""
    ident = _compiler_ids.get(CXX)
    if ident is None:
        outs = []
        for args in (("--version",), ("-march=native", "-Q", "--help=target")):
            try:
                proc = subprocess.run([CXX, *args], capture_output=True, check=True)
            except (OSError, subprocess.CalledProcessError) as e:
                raise NativeBuildError(f"cannot run {CXX!r}: {e}") from e
            outs.append(proc.stdout)
        ident = _compiler_ids[CXX] = b"\0".join(outs)
    return ident


def library_path(src_name: str, libs: Sequence[str] = ()) -> Path:
    """Where the build of ``src/<src_name>`` lands (it may not exist yet)."""
    h = hashlib.sha256("\0".join((CXX, *CXX_FLAGS, *libs)).encode())
    h.update(b"\0" + _compiler_identity())
    h.update(b"\0" + (SRC_DIR / src_name).read_bytes())
    return BUILD_DIR / f"lib{Path(src_name).stem}-{h.hexdigest()[:16]}.so"


def build(src_name: str, libs: Sequence[str] = ()) -> Path:
    """Compile ``src/<src_name>`` unless its hashed build exists; return the
    library path."""
    so = library_path(src_name, libs)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [CXX, *CXX_FLAGS, str(SRC_DIR / src_name), "-o", str(tmp), *libs]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise NativeBuildError(f"cannot run {CXX!r} to build {src_name}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(
            f"{CXX} failed on {src_name} (exit {proc.returncode}):\n"
            f"{proc.stderr[-4000:]}"
        )
    os.replace(tmp, so)  # atomic: no process ever loads half a file
    return so


def _load(src_name: str, configure: Callable[[ctypes.CDLL], None],
          libs: Sequence[str] = ()) -> ctypes.CDLL:
    """Build (at first use), dlopen and declare the signatures; one load per
    process."""
    with _lock:
        lib = _libraries.get(src_name)
        if lib is None:
            path = build(src_name, libs)
            try:
                lib = ctypes.CDLL(str(path))
                configure(lib)
            except (OSError, AttributeError) as e:
                raise NativeBuildError(f"cannot load {path}: {e}") from e
            _libraries[src_name] = lib
        return lib


def _configure_ap(lib: ctypes.CDLL) -> None:
    lib.detection_ap_batch.argtypes = [
        ctypes.POINTER(ctypes.c_double),  # gt
        ctypes.POINTER(ctypes.c_int64),  # gt_off
        ctypes.POINTER(ctypes.c_double),  # pred
        ctypes.POINTER(ctypes.c_double),  # scores
        ctypes.POINTER(ctypes.c_int64),  # pred_off
        ctypes.c_int64,  # n_queries
        ctypes.POINTER(ctypes.c_double),  # thds
        ctypes.c_int64,  # n_thds
        ctypes.c_int64,  # n_threads
        ctypes.POINTER(ctypes.c_double),  # out
    ]
    lib.detection_ap_batch.restype = None


def load_ap_kernel() -> ctypes.CDLL:
    """The detection-AP library (src/ap_kernel.cpp)."""
    return _load("ap_kernel.cpp", _configure_ap)


def _configure_reader(lib: ctypes.CDLL) -> None:
    lib.read_npz_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),  # paths
        ctypes.c_int64,  # n
        ctypes.c_char_p,  # key
        ctypes.c_int32,  # normalize
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),  # out_ptrs
        ctypes.POINTER(ctypes.c_int64),  # out_rows (or -errcode)
        ctypes.POINTER(ctypes.c_int64),  # out_cols
        ctypes.c_int64,  # n_threads
    ]
    lib.read_npz_batch.restype = None
    lib.free_feature_buffers.argtypes = [
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64,
    ]
    lib.free_feature_buffers.restype = None


def load_feature_reader() -> ctypes.CDLL:
    """The npz feature-reader library (src/feature_reader.cpp, with zlib)."""
    return _load("feature_reader.cpp", _configure_reader, ("-lz",))
