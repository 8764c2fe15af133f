"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` into ``build/pilottai_tpu_torch/<name>-<hash>.so``
at first use and loaded with ``ctypes``; the hash covers the source, the
``csrc`` headers it includes (``#include "hopper.cuh"``) and the flags,
so an edited kernel or header rebuilds and an unchanged one loads.
Nothing is built when a module is imported: the CPU tests import every
module on a machine with no ``nvcc``.

``build_libraries`` starts one ``nvcc`` per source at once and waits for
all of them, so a cold start pays for the slowest kernel, not the sum.
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
from typing import Dict, Iterable, Mapping, Tuple

PACKAGE = Path(__file__).resolve().parents[2]
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE.parent / "build" / "pilottai_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
#: What each build took and what ``ptxas -v`` said (registers, spills),
#: by kernel name; filled when a library is compiled.
build_log: Dict[str, Tuple[float, str]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def source_bytes(src: Path, seen=None) -> bytes:
    """The bytes a build of ``src`` reads from its tree: the source and,
    recursively, every header it includes with quotes (resolved beside the
    including file, as the preprocessor does)."""
    seen = set() if seen is None else seen
    src = Path(src).resolve()
    if src in seen:
        return b""
    seen.add(src)
    data = src.read_bytes()
    parts = [data]
    for name in _INCLUDE.findall(data):
        header = src.parent / name.decode()
        if header.exists():
            parts.append(source_bytes(header, seen))
    return b"".join(parts)


def library_path(name: str, src: Path) -> Path:
    """Where the build of ``src`` lands: named by the hash of what it reads
    and the flags."""
    digest = hashlib.sha256(source_bytes(src) + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_sources(sources: Mapping[str, Path]) -> Dict[str, ctypes.CDLL]:
    """Compile ``{name: path to .cu}`` in parallel (or reuse the build of
    an identical source) and load each library."""
    pending = {}
    libs: Dict[str, ctypes.CDLL] = {}
    for name, src in sources.items():
        out = library_path(name, src)
        if out.exists():
            libs[name] = ctypes.CDLL(str(out))
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        pending[name] = (proc, tmp, out, time.perf_counter())
    for name, (proc, tmp, out, t0) in pending.items():
        log, _ = proc.communicate()
        build_log[name] = (time.perf_counter() - t0, log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)
        libs[name] = ctypes.CDLL(str(out))
    return libs


def build_libraries(names: Iterable[str]) -> Dict[str, ctypes.CDLL]:
    """Build (in parallel) and load the named kernels of ``csrc/``."""
    names = list(names)
    with _lock:
        missing = {n: CSRC / f"{n}.cu" for n in names if n not in _loaded}
        if missing:
            _loaded.update(build_sources(missing))
        return {name: _loaded[name] for name in names}


def load_library(name: str) -> ctypes.CDLL:
    return build_libraries([name])[name]
