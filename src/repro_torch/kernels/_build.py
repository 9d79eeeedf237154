"""Build ``csrc/*.cu`` with nvcc at first use and load them with ctypes.

Every source becomes its own shared library with a plain C interface
(``extern "C"`` functions that launch on the stream they are given and
return ``cudaGetLastError()``).  All sources compile at once, one ``nvcc``
process each, into ``build/repro_torch/`` at the repository root, named by
a hash of the source, the shared headers (``csrc/*.cuh``) and the flags
so that an unchanged source is not built again.  Nothing is built when
the module is imported.
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

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_DEFAULT = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}     # source name -> nvcc/ptxas output


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if NVCC_DEFAULT.exists():
        return str(NVCC_DEFAULT)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or /usr/local/cuda/bin)")


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):   # sources may include them
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every ``csrc/*.cu`` not built yet, all in parallel, and load
    them.  Returns the seconds spent.  Raises if a build fails."""
    t0 = time.perf_counter()
    with _lock:
        sources = sorted(CSRC.glob("*.cu"))
        todo = [s for s in sources if s.stem not in _libs]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for src in todo:
            out = _target(src)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs[src] = (out, tmp, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for src, (out, tmp, proc) in procs.items():
            log, _ = proc.communicate()
            build_log[src.stem] = log
            if proc.returncode:
                failed.append(f"{src.name}:\n{log}")
            else:
                os.replace(tmp, out)   # atomic: readers never see half
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for src in todo:
            _libs[src.stem] = ctypes.CDLL(str(_target(src)))
    return time.perf_counter() - t0


def function(source: str, name: str, argtypes, restype=ctypes.c_int):
    """The C function ``name`` of ``csrc/<source>.cu``, declared with
    ``argtypes`` and ``restype`` (by default ``int``: the CUDA error
    code)."""
    if source not in _libs:
        build_all()
    fn = getattr(_libs[source], name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = restype
    return fn
