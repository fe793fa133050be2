"""Builds the port's host C++ (the resource arbiter) and loads it.

Counterpart of `spark_rapids_tpu/native/build.py`, for the port's own copy
of `resource_adaptor.cpp`. The library is compiled with g++ at first use,
from the source in the checkout, into `spark_rapids_tpu_torch/_build/`
(listed in .gitignore), as `ops/cuda_build.py` builds the CUDA sources: it
is named by the hash of its source and flags, so an edited source never
loads a stale build, and no library is committed.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

_SRC_DIR = Path(__file__).resolve().parent
_BUILD_DIR = _SRC_DIR.parent / "_build"
FLAGS = ("-std=c++17", "-O2", "-fPIC", "-shared", "-pthread")
_LOCK = threading.Lock()


def library_path(name: str) -> Path:
    src = (_SRC_DIR / f"{name}.cpp").read_bytes()
    digest = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()
    return _BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str = "resource_adaptor") -> Path:
    """Compile lib<name>.so if there is no current one; return its path.
    Raises with g++'s output when the compile fails."""
    out = library_path(name)
    with _LOCK:
        if out.exists():
            return out
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", *FLAGS, "-o", str(tmp), str(_SRC_DIR / f"{name}.cpp")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {name}.cpp "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
        return out


def build_seconds(name: str = "resource_adaptor") -> float:
    """Seconds a build of lib<name>.so took here, 0.0 when a current
    library was already there."""
    if library_path(name).exists():
        return 0.0
    t0 = time.perf_counter()
    build(name)
    return time.perf_counter() - t0
