"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``ops/csrc/<name>.cu`` has a plain C interface, so it compiles with
``nvcc`` alone into a shared library (no PyTorch headers — seconds, not
minutes) and binds through ``ctypes``.  The library lands in
``torchdistpackage_tpu_torch/_build/<name>-<hash>/``, keyed by a hash of
the source and the flags, so an edited source rebuilds and an unchanged
one is reused.  Nothing here runs at import time: the CPU tests import
every module on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()  # guards _LOCKS; each source builds under its own
_LOCKS: Dict[str, threading.Lock] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
#: name -> {"seconds": build wall time (0.0 when reused), "log": nvcc's
#: stderr, which holds ptxas' registers / shared memory / spills, "path":
#: the library}
BUILD_INFO: Dict[str, Dict[str, object]] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the port's CUDA kernels "
        "are built from source at first use on a machine with the CUDA "
        "toolkit")


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; raises on a failed
    build with nvcc's output.  Thread-safe, with one lock per source, so
    several sources build at once (see :func:`load_all`); the library is
    cached per process."""
    with _LOCK:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
        if name in _LIBS:
            return _LIBS[name]
        src = CSRC / f"{name}.cu"
        # the headers beside the sources are part of every build's key
        headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
        digest = hashlib.sha256(
            src.read_bytes() + headers
            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        out_dir = BUILD_DIR / f"{name}-{digest}"
        lib_path = out_dir / f"lib{name}.so"
        log_path = out_dir / "nvcc.log"
        t0 = time.perf_counter()
        if not lib_path.exists():
            nvcc = _nvcc()
            out_dir.mkdir(parents=True, exist_ok=True)
            tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
            proc = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {src.name} "
                    f"(exit {proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
            log_path.write_text(proc.stderr)
            os.replace(tmp, lib_path)  # atomic: a reader never sees half
        BUILD_INFO[name] = {
            "seconds": time.perf_counter() - t0,
            "log": log_path.read_text() if log_path.exists() else "",
            "path": str(lib_path),
        }
        lib = ctypes.CDLL(str(lib_path))
        _LIBS[name] = lib
        return lib


def load_all(names) -> Dict[str, ctypes.CDLL]:
    """Build every named source at once, one ``nvcc`` each, started
    together; raises the first build's error."""
    from concurrent.futures import ThreadPoolExecutor

    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(load, names)))
