"""Build, load and launch the port's hand-written CUDA kernels.

Each ``yat_tpu_torch/csrc/*.cu`` file has a plain C interface and compiles
with one ``nvcc`` call into a shared library of its own under
``yat_tpu_torch/_build/``, which ``ctypes`` loads (no PyTorch headers, so a
build takes seconds).  A library is built at the first launch of one of its
kernels, or all at once by :func:`build_all`, which starts one ``nvcc`` per
source together.  The library's file name carries a hash of its sources
and flags, so an edited kernel is rebuilt.

A :class:`CudaKernel` is one C entry point.  Its ``launches`` counter goes
up by one for every launch that the CUDA runtime accepted, and only there:
a run can show that it went through the kernel.  Two handles may share an
entry point and count apart (K2's kernel also serves the JAX package's
folded-layout kernel K4).  A :class:`LaunchCounter` alone counts the calls
of a branch that launches no kernel of the port (the XLA attention
branch), so a run can show that it was never taken.
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
from typing import Dict, List, Optional, Sequence

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes of the C entry points (csrc/common.cuh)
DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1}

_lock = threading.Lock()
_libraries: Dict[str, ctypes.CDLL] = {}
# every kernel the package defines, by name (filled as modules import)
KERNELS: Dict[str, "CudaKernel"] = {}
# every launch counter, kernels' and branches', by name
COUNTERS: Dict[str, "LaunchCounter"] = {}


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on PATH."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
            "CUDA kernels are built from yat_tpu_torch/csrc at first use")
    return found


def library_path(source: str) -> Path:
    """Where the library of ``source`` lives, named by a hash of every
    file in csrc/ it may include and of the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cuh")) + [CSRC_DIR / source]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def _start(source: str, nvcc: str):
    out = library_path(source)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return source, out, tmp, cmd, proc


def build(sources: Sequence[str]) -> Dict[str, str]:
    """Compile the libraries of ``sources`` that are not built yet, one
    ``nvcc`` per source, all started together.  Returns the compiler's
    output (register and shared-memory use) by source; raises with that
    output when a compile fails."""
    todo = [s for s in dict.fromkeys(sources) if not library_path(s).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    jobs = [_start(s, nvcc) for s in todo]
    logs: Dict[str, str] = {}
    failed: List[str] = []
    for source, out, tmp, cmd, proc in jobs:
        log, _ = proc.communicate()
        logs[source] = log
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def build_all() -> Dict[str, object]:
    """Build every kernel library of the package in parallel; returns the
    wall-clock seconds and the compiler logs."""
    t0 = time.perf_counter()
    with _lock:
        logs = build(sorted({k.source for k in KERNELS.values()}))
    return {"seconds": time.perf_counter() - t0, "logs": logs}


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    with _lock:
        lib = _libraries.get(source)
        if lib is None:
            build([source])
            lib = ctypes.CDLL(str(library_path(source)))
            lib.yat_error_string.argtypes = [ctypes.c_int]
            lib.yat_error_string.restype = ctypes.c_char_p
            _libraries[source] = lib
        return lib


class LaunchCounter:
    """A named count, set to 0 by :func:`reset_launch_counts`."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        COUNTERS[name] = self


class CudaKernel(LaunchCounter):
    """One C entry point of a ``csrc`` library with its launch counter.

    ``argtypes`` are the ctypes of the entry point's arguments (pointers and
    the stream as ``c_void_p``); the entry point returns the
    ``cudaError_t`` of its launch."""

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence[type]):
        super().__init__(name)
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self._fn: Optional[ctypes._CFuncPtr] = None
        KERNELS[name] = self

    def function(self, symbol: Optional[str] = None, argtypes=None,
                 restype=ctypes.c_int):
        """A ctypes function of this kernel's library (the entry point by
        default; helpers such as shared-memory queries by name)."""
        if symbol is None and self._fn is not None:
            return self._fn
        fn = getattr(load(self.source), symbol or self.symbol)
        fn.argtypes = self.argtypes if symbol is None else list(argtypes or [])
        fn.restype = restype
        if symbol is None:
            self._fn = fn
        return fn

    def launch(self, *args) -> None:
        """Launch on the arguments' stream; raise if the runtime refused."""
        err = self.function()(*args)
        if err != 0:
            msg = load(self.source).yat_error_string(err).decode()
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA "
                               f"error {err} ({msg})")
        self.launches += 1


def dtype_code(t) -> int:
    code = DTYPE_CODES.get(str(t.dtype))
    if code is None:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, got "
                        f"{t.dtype}")
    return code


def stream_of(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def reset_launch_counts() -> None:
    for c in COUNTERS.values():
        c.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: c.launches for name, c in COUNTERS.items()}
