"""Build the hand-written CUDA kernels of ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xptxas -v -shared \
        -Xcompiler -fPIC -o build/kernels/<name>_<hash>.so csrc/<name>.cu

and the host code of ``csrc/<name>.c`` (``utils/imageio.py``'s PNG row
unfiltering and resize, its JPEG decoder and encoder, the BMP and HDR
run-length loops of ``utils/rasters.py``, the TIFF PackBits and LZW of
``utils/tiff.py``, the GIF LZW of ``utils/gif.py`` and the WebP codecs of
``utils/webp.py``) with the host's C compiler, ``cc -O2 -shared -fPIC``, on
every machine, at first use, into
``build/kernels/`` at the repository root, under a name keyed on a hash of
the source, so an edited source is rebuilt and an unchanged one is not.  ``build_all`` starts one ``nvcc`` per source, all at
once.  Nothing is built or loaded at import time, so the port imports on a
machine without ``nvcc`` or a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
SOURCES = ("correlation", "photometric", "regularizer", "gather")
HOST_SOURCES = ("gif", "imageio", "jpeg", "jpeg2000", "jpeg_enc", "rle", "tiff", "webp")

_libs: dict[str, ctypes.CDLL] = {}
# ptxas's report (registers, shared memory, spills per kernel) of each source
# built in this process: nvcc runs with -Xptxas -v, which changes no code
ptxas_log: dict[str, str] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _cc() -> str:
    for cand in (os.environ.get("CC"), shutil.which("cc"), shutil.which("gcc")):
        if cand:
            return cand
    raise RuntimeError("no C compiler found: set CC or put cc on PATH")


def _paths(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC, f"{name}.c" if name in HOST_SOURCES else f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return src, os.path.join(BUILD_DIR, f"{name}_{digest}.so")


def _start(name: str):
    """(library path, running nvcc or None when the library is current)."""
    src, lib_path = _paths(name)
    if os.path.exists(lib_path):
        return lib_path, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    if name in HOST_SOURCES:
        cmd = [_cc(), "-O2", "-shared", "-fPIC", "-o", tmp, src]
    else:
        cmd = [
            _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC", "-o", tmp, src,
        ]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return lib_path, (proc, cmd, tmp)


def _finish(lib_path: str, job) -> str:
    if job is None:
        return lib_path
    proc, cmd, tmp = job
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed ({proc.returncode}):\n{' '.join(cmd)}\n{err}")
    name = os.path.basename(lib_path).rsplit("_", 1)[0]
    if name not in HOST_SOURCES:
        ptxas_log[name] = err
    os.replace(tmp, lib_path)  # atomic: a concurrent build never sees half a file
    return lib_path


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` if its source changed; return the library path."""
    return _finish(*_start(name))


def build_all() -> dict[str, str]:
    """Build every source in parallel (one nvcc each); {name: library path}."""
    jobs = {name: _start(name) for name in SOURCES}
    return {name: _finish(*job) for name, job in jobs.items()}


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """Build if needed, load once, and declare each function's argument types.

    Every exported function returns an int: a kernel's launch its
    ``cudaError_t``.
    """
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
    return lib


def check_launch(err: int, name: str) -> None:
    """Raise if a launch function returned a CUDA error (0 is success)."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


P = ctypes.c_void_p  # a device pointer or the stream
I = ctypes.c_int
