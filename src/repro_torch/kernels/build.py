"""Build the CUDA kernels from ``csrc/`` on first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (loaded with ``ctypes``), under
``build/kernels/`` at the root of the checkout. The file name carries a hash
of the source, of every ``csrc/`` header it includes (``#include "..."``,
followed through headers) and of the flags, so an edited source or header is
rebuilt and an unchanged one is loaded as it is. The libraries link no
driver library: the flash kernel's tensor maps come from the driver through
``cudaGetDriverEntryPoint``. ``build_all`` starts one ``nvcc`` per
source, all at once. A missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("flash_prefill", "paged_decode")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# per kernel: {"seconds": build time or 0.0 when cached, "ptxas": log text}
build_info: Dict[str, dict] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.M)


def sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and the ``csrc/`` files it includes, directly or
    through another, in the order first met."""
    out, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in out:
            continue
        out.append(path)
        todo += [CSRC / inc for inc in _INCLUDE.findall(path.read_text())
                 if (CSRC / inc).is_file()]
    return out


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, nvcc: str):
    """Start ``nvcc`` for one source into a temporary file; None when the
    library for this source already exists."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.monotonic()


def _finish(name: str, job) -> None:
    proc, tmp, out, t0 = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    out.with_suffix(".log").write_text(log)
    build_info[name] = {"seconds": time.monotonic() - t0, "ptxas": log}


def build_all(names: Optional[List[str]] = None) -> Dict[str, dict]:
    """Build every kernel that is not built yet, one ``nvcc`` per source,
    all started together; returns ``build_info``."""
    names = list(names or KERNELS)
    with _lock:
        nvcc = nvcc_path()
        jobs = {n: _start(n, nvcc) for n in names}
        for n, job in jobs.items():
            if job is not None:
                _finish(n, job)
            elif n not in build_info:
                log = _target(n).with_suffix(".log")
                build_info[n] = {"seconds": 0.0, "ptxas": log.read_text()
                                 if log.exists() else ""}
    return build_info


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return _libs[name]
