"""Build and load the port's hand-written CUDA kernels.

Each source ``univtg_tpu_torch/csrc/<name>.cu`` compiles with ``nvcc`` into a
shared library with a plain C interface, loaded with ``ctypes``. The build
runs at first use, into ``univtg_tpu_torch/_build/`` (git-ignored), and is
cached there by a hash of the source, of every ``csrc/`` header it includes
(``#include "x.cuh"``, followed transitively) and of the flags, so an edited
source or header rebuilds and an unchanged one loads in milliseconds.
Nothing is built while a module is imported: the CPU tests import every
module on hosts that have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC_DIR.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, into the log
)

_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)

_lock = threading.Lock()
_libraries: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def find_nvcc() -> str:
    """Path of ``nvcc``: $CUDA_HOME/bin, then $PATH, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
        "/usr/local/cuda/bin): the CUDA kernels of univtg_tpu_torch are "
        "compiled at first use and need the CUDA toolkit"
    )


def source_files(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every ``csrc/`` file it includes with quotes,
    transitively, in a fixed order."""
    files, todo = [], [CSRC_DIR / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in files:
            continue
        files.append(path)
        for inc in _INCLUDE.findall(path.read_text()):
            todo.append(path.parent / inc)
    return files


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` lands (it may not exist yet)."""
    h = hashlib.sha256("\0".join(NVCC_FLAGS).encode())
    for path in source_files(name):
        h.update(b"\0" + path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its hashed build exists; return the
    library path. The compiler's output goes to a ``.log`` beside it."""
    so = library_path(name)
    if so.exists():
        return so
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    so.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed on {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stderr[-4000:]}"
        )
    os.replace(tmp, so)  # atomic: concurrent builders never load half a file
    return so


def build_log(name: str) -> str:
    """The compiler output of the current build of ``name`` ('' if none)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load_library(name: str) -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/<name>.cu``; one load per process."""
    with _lock:
        lib = _libraries.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _libraries[name] = lib
        return lib
