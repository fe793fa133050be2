"""Builds the port's host C++ and loads it.

Counterpart of `spark_rapids_tpu/native/build.py`, for the port's own
copies of `resource_adaptor.cpp` (the arbiter), `parquet_footer.cpp` and
`parquet_reader.cpp`. A library is compiled with g++ at first use, from
its source in the checkout, into `spark_rapids_tpu_torch/_build/` (listed
in .gitignore), as `ops/cuda_build.py` builds the CUDA sources: it is
named by the hash of its source and flags, so an edited source never
loads a stale build, and no library is committed. One file lock per
library lets one process compile while the others wait for its result.

The reader links only the codec libraries this machine has
(`link_flags`): zlib for GZIP pages and libzstd.so.1 for ZSTD pages, each
with a macro that compiles its branch in; a page whose library is absent
raises a RuntimeError that names it. Snappy is decoded in the source
itself, so libsnappy is never needed.
"""
from __future__ import annotations

import ctypes.util
import fcntl
import functools
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Tuple

_SRC_DIR = Path(__file__).resolve().parent
_BUILD_DIR = _SRC_DIR.parent / "_build"
FLAGS = ("-std=c++17", "-O2", "-fPIC", "-shared", "-pthread", "-Wall",
         "-Wextra")
_LOCK = threading.Lock()


@functools.lru_cache(maxsize=None)
def link_flags(name: str) -> Tuple[str, ...]:
    """The defines and libraries lib<name>.so is built with: for the
    reader, each codec library that `ctypes.util.find_library` finds."""
    if name != "parquet_reader":
        return ()
    out = []
    for lib, macro in (("z", "PQR_HAVE_ZLIB"), ("zstd", "PQR_HAVE_ZSTD")):
        found = ctypes.util.find_library(lib)
        if found:
            out += [f"-D{macro}=1", f"-l:{found}"]
    return tuple(out)


def library_path(name: str) -> Path:
    src = (_SRC_DIR / f"{name}.cpp").read_bytes()
    flags = " ".join(FLAGS + link_flags(name))
    digest = hashlib.sha256(src + flags.encode()).hexdigest()
    return _BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def compile_command(name: str, out: Path) -> list:
    return ["g++", *FLAGS, "-o", str(out), str(_SRC_DIR / f"{name}.cpp"),
            *link_flags(name)]


def build(name: str = "resource_adaptor") -> Path:
    """Compile lib<name>.so if there is no current one; return its path.
    Raises with g++'s output when the compile fails."""
    out = library_path(name)
    with _LOCK:
        if out.exists():
            return out
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(_BUILD_DIR / f".lock-{name}", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if out.exists():        # another process built it meanwhile
                return out
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(compile_command(name, tmp),
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed for {name}.cpp "
                                   f"(exit {proc.returncode}):\n"
                                   f"{proc.stderr}")
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
