"""Build and load the hand-written CUDA kernels.

Each source ``csrc/<name>.cu`` (with the shared ``csrc/*.cuh`` headers)
compiles with ``nvcc`` for ``sm_90a`` into a shared library with a plain
C interface, loaded with ``ctypes``. The library lands in
``build/lir_tpu_torch/`` at the root of the checkout, under a name keyed
on a hash of its source, the headers and the flags, so an edited source
rebuilds and an unchanged one is reused. A failed compile raises: there
is no fallback. :func:`build_seconds` is the wall time spent compiling
so far (a compile in progress included): the dispatch watchdog
(guard/watchdog.py) takes it out of a dispatch's elapsed time, so a
kernel built at first use neither trips nor calibrates a deadline.
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
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "lir_tpu_torch"
SOURCES = ("flash_decode", "cascade_prefill", "flash_attention", "row_gemm",
           "stream_fold", "sample", "kv_int8_attention")
# Head dims the tile kernels of csrc/attn_tile.cuh and csrc/attn_mma.cuh
# are instantiated for.
TILE_HEAD_DIMS = (32, 64, 80, 96, 128)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
# Compiler output (ptxas register / shared-memory report) of each build.
BUILD_LOGS: Dict[str, str] = {}
# Wall seconds of finished compile rounds, and the start of each round
# in progress (keyed by the building thread).
_BUILD_LOCK = threading.Lock()
_BUILD_DONE_S = 0.0
_BUILD_ACTIVE: Dict[int, float] = {}


def build_seconds() -> float:
    """Wall seconds spent in compile rounds so far, a round in progress
    counted up to now."""
    now = time.monotonic()
    with _BUILD_LOCK:
        return _BUILD_DONE_S + sum(now - t for t in _BUILD_ACTIVE.values())


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    # The key covers the shared headers too: an edited header rebuilds.
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every library in ``names`` (default: all) that is not
    built yet: one ``nvcc`` per source, all started together. Returns
    the seconds each compile took (0.0 for a library already built)."""
    global _BUILD_DONE_S
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    running = []
    seconds = {name: 0.0 for name in names}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, out, tmp, proc, time.perf_counter()))
    if not running:
        return seconds
    me = threading.get_ident()
    with _BUILD_LOCK:
        _BUILD_ACTIVE[me] = time.monotonic()
    try:
        _wait(running, seconds)
    finally:
        with _BUILD_LOCK:
            _BUILD_DONE_S += time.monotonic() - _BUILD_ACTIVE.pop(me)
    return seconds


def _wait(running, seconds: Dict[str, float]) -> None:
    failures = []
    for name, out, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu "
                            f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib


def sass(name: str) -> str:
    """The SASS of the built library of ``csrc/<name>.cu``, by
    ``cuobjdump -sass`` from the toolkit of the nvcc that built it."""
    build([name])
    tool = Path(_nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(library_path(name))],
                         capture_output=True, text=True, check=True)
    return out.stdout


def check(err: int, what: str) -> None:
    """Raise when a C entry point returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
