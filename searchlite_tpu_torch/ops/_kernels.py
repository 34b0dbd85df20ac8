"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface. At first use it is
compiled with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into
``build/kernels/`` at the repository root (keyed by a hash of the
source and the shared ``csrc/*.cuh`` headers, so an edited kernel never
loads a stale library) and loaded with
``ctypes``. A failed build raises: there is no other path to fall back
to. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# seconds each library took to build in this process (0.0 = reused)
BUILD_SECONDS: dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels "
            "cannot be built")
    return path


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless a library of the same source
    hash exists; returns the library path. Raises RuntimeError with the
    compiler's output when nvcc fails."""
    src = os.path.join(_CSRC, f"{name}.cu")
    h = hashlib.sha1()
    # the source and every shared header it may include
    for path in [src] + sorted(os.path.join(_CSRC, f)
                               for f in os.listdir(_CSRC)
                               if f.endswith(".cuh")):
        with open(path, "rb") as fh:
            h.update(fh.read())
    digest = h.hexdigest()[:12]
    out = os.path.join(_BUILD, f"lib{name}-{digest}.so")
    if os.path.exists(out):
        BUILD_SECONDS.setdefault(name, 0.0)
        return out
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, src]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {src} (exit {res.returncode}):\n"
            f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    with open(os.path.join(_BUILD, f"{name}.ptxas.txt"), "w") as fh:
        fh.write(res.stdout + res.stderr)
    return out


def build_all(names) -> None:
    """Compile several ``csrc/<name>.cu`` at once, one nvcc each, all
    started together. Raises the first build's error."""
    from concurrent.futures import ThreadPoolExecutor

    names = list(names)
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        for fut in [pool.submit(build, n) for n in names]:
            fut.result()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _LIBS[name] = lib
    return lib
