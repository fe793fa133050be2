"""Builds the port's CUDA sources into shared libraries and loads them.

Each `csrc/<name>.cu` compiles with nvcc for `sm_90a` into a shared library
with a plain C interface, loaded through ctypes. The build runs at first
use, from the sources in the checkout, into `spark_rapids_tpu_torch/_build/`
(listed in .gitignore). A library is named by the hash of its source and
flags, so an edited source never loads a stale build. `build()` starts one
nvcc per source, all at once.
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
from typing import Dict, Sequence

SOURCES = ("hash_join", "row_hash", "partition_hist", "fused_select",
           "topk", "groupby", "decimal128", "row_conversion", "cast_string",
           "cast_decimal", "cast_string_to_float", "number_to_string",
           "parse_uri", "map_utils", "bloom_filter", "datetime_rebase",
           "timezones", "zorder", "histogram")

_SRC_DIR = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# per source: the float casts and the percentile's interpolation keep
# every multiply and add rounded on its own, as the CPU computes them (no
# fused multiply-add)
EXTRA_FLAGS = {"cast_string_to_float": ("-fmad=false",),
               "number_to_string": ("-fmad=false",),
               "histogram": ("-fmad=false",)}


def flags(name: str) -> tuple:
    return _FLAGS + EXTRA_FLAGS.get(name, ())

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card, which needs the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (_SRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(flags(name)).encode()).hexdigest()
    return _BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, float]:
    """Compile every named source that has no current library, one nvcc
    each, started together. Returns seconds per compiled source; raises
    with the compiler's output when one fails. The compiler's report
    (`-Xptxas -v`: registers, shared memory, spills) is kept beside each
    library as `<library>.log`."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *flags(name), "-o", str(tmp),
               str(_SRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    secs, errors = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        out.with_name(out.name + ".log").write_text(log)
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def compiler_report(name: str) -> str:
    """nvcc's `-Xptxas -v` output for a built library ('' if not built)."""
    log = library_path(name).with_name(library_path(name).name + ".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
        return lib
