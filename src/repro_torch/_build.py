"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into
``build/repro_torch/<name>-<hash>.so`` at the root of the checkout, with a
plain C interface.  The hash covers the source, the ``csrc`` headers it
includes (``#include "sm90.cuh"``) and the compiler flags, so an edited
source or header is rebuilt and an unchanged one is loaded as it is.
Nothing is compiled when the package is imported: the first launch of a
kernel builds its library, and :func:`build` compiles several sources at
once, one ``nvcc`` process each.

Every C entry point returns a CUDA error code; :func:`check` turns a
non-zero code into an exception.
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
from typing import Callable, Dict, Iterable, Sequence

__all__ = ["SOURCES", "BUILD_DIR", "build", "function", "check", "count_launch", "setup_seconds"]

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "repro_torch"
SOURCES = ("hotspot", "spmm", "flash_attention", "flash_attention_wide", "flash_attention_bwd",
           "flash_attention_f32", "flash_attention_f32_bwd", "ssd_scan")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_functions: Dict[tuple, Callable[..., int]] = {}
# host seconds this process spent on each library: nvcc's, where it built one
# (``build``), and loading it (``function``)
_built: Dict[str, float] = {}
_loaded: Dict[str, float] = {}


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"  # the toolkit's default install prefix
    if os.access(default, os.X_OK):
        return default
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
        "kernels are compiled from csrc/ at their first launch"
    )


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    todo, seen = [f"{name}.cu"], set()
    while todo:  # the source, then the headers it includes from csrc, in order
        file = todo.pop(0)
        if file in seen:
            continue
        seen.add(file)
        text = (SRC_DIR / file).read_bytes()
        digest.update(text)
        todo.extend(inc.decode() for inc in _INCLUDE.findall(text))
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES, *, verbose: bool = False) -> Dict[str, float]:
    """Compile every named source whose library is missing; return seconds each.

    All ``nvcc`` processes start together and are all waited for before a
    failure is raised.  ``verbose`` adds ``-Xptxas -v`` and prints what the
    compiler said (registers, shared memory and spills per kernel).
    """
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = _library_path(name)
        if target.exists():
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        procs[name] = (time.perf_counter(), tmp, target, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    seconds: Dict[str, float] = {name: 0.0 for name in names}
    failures = []
    for name, (t0, tmp, target, proc) in procs.items():
        output, _ = proc.communicate()
        seconds[name] = _built[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed on csrc/{name}.cu:\n{output}")
            continue
        if verbose and output:
            print(output, end="" if output.endswith("\n") else "\n")
        os.replace(tmp, target)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def function(library: str, name: str, argtypes: Sequence) -> Callable[..., int]:
    """The C entry point ``name`` of ``csrc/<library>.cu``, built on first use.

    ``argtypes`` must give ``ctypes.c_void_p`` for every pointer and the
    stream, or ctypes would pass them as 32-bit ints.
    """
    key = (library, name)
    with _lock:
        fn = _functions.get(key)
        if fn is None:
            lib = _libs.get(library)
            if lib is None:
                build([library])
                t0 = time.perf_counter()
                lib = ctypes.CDLL(str(_library_path(library)))
                _loaded[library] = time.perf_counter() - t0
                err = getattr(lib, f"{library}_error_string")
                err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
                _libs[library] = lib
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
            _functions[key] = fn
        return fn


def setup_seconds() -> Dict[str, Dict[str, float]]:
    """{"built": {library: nvcc's seconds}, "loaded": {library: seconds to
    load it}} of what this process built and loaded so far: a run that
    found its libraries built lists none under "built"."""
    with _lock:
        return {"built": dict(_built), "loaded": dict(_loaded)}


def check(library: str, err: int, what: str) -> None:
    """Raise if a C entry point of ``library`` returned a CUDA error."""
    if err:
        text = getattr(_libs[library], f"{library}_error_string")(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({text})")


_count_lock = threading.Lock()


def count_launch(wrapper, attr: str = "launches") -> None:
    """Add one to ``wrapper.launches`` (or another count of it, such as
    ``backward_launches``); wrappers call it where they launch."""
    with _count_lock:
        setattr(wrapper, attr, getattr(wrapper, attr) + 1)
