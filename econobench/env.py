"""Process set-up shared by the entry points: any build or kernel cache
inside the checkout at a fixed path, and the checkout's ``src`` and root
on ``sys.path``."""
from __future__ import annotations

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def setup() -> None:
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "nv_compute_cache")
    os.environ.setdefault("OMP_NUM_THREADS", "2")
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
