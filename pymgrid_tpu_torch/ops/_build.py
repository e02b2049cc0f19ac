"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``pymgrid_tpu_torch/build/`` at first use, then
bound with ``ctypes``.  The library name carries a hash of the source, the
flags and any ``-D`` defines, so an edit rebuilds.  ``--fmad=false`` keeps
every product rounded before it feeds an add, as PyTorch's eager ops round
it.  ``-Xptxas -v`` reports each kernel's registers, spills and shared memory;
the report is kept beside the library (:func:`build_report`).  A missing
``nvcc`` or a failed build raises: nothing falls back.
"""
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build_library", "build_report", "load_library"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit")


def _library_path(name, defines):
    src = CSRC / f"{name}.cu"
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    return src, flags, BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_library(name, defines=()):
    """Compile ``csrc/<name>.cu`` with the ``-D`` ``defines`` (if not built
    yet); return the .so path."""
    src, flags, lib = _library_path(name, defines)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *flags, "-o", tmp, str(src)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
        Path(f"{lib}.ptxas.txt").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)  # atomic: a concurrent process never sees a partial file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def build_report(name, defines=()):
    """The ``-Xptxas -v`` report of ``csrc/<name>.cu``'s build (builds it if
    needed)."""
    return Path(f"{build_library(name, defines)}.ptxas.txt").read_text()


@functools.lru_cache(maxsize=None)
def load_library(name, defines=()):
    """Build (once) and ``ctypes``-load ``csrc/<name>.cu``."""
    return ctypes.CDLL(str(build_library(name, tuple(defines))))
