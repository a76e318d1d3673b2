"""ctypes bindings for the C++ JPEG decode and resize (``native/decode.cpp``).

Counterpart of ``yat_tpu/data/native.py``.  The library is built at first
use with ``g++ -O3 -march=native`` against libjpeg into
``yat_tpu_torch/_build/``, named by a hash of the source, the flags and the
host's CPU (a library built for another CPU is never loaded); the JAX
package's own build product next to the source is never read or written.

The rule is the JAX package's: the image samplers decode through this
library when it is available, else through cv2 one image at a time.  The
choice is visible: :func:`available` says whether the library loaded,
:func:`unavailable_reason` why not, the failure is printed once, and the
samplers report their decoder (``ImageBucketSampler.decoder``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "decode.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-ljpeg", "-lpthread")


class _Native:
    """The loaded library, or why it is not there (one per process)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.tried = False
        self.lib: Optional[ctypes.CDLL] = None
        self.reason: Optional[str] = None


_STATE = _Native()


def _cpu_tag() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def library_path() -> Path:
    """Where the library for this source, these flags and this CPU lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(_cpu_tag().encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libyatdecode-{h.hexdigest()[:16]}.so"


def _build() -> Path:
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"g++ did not run: {e}") from e
    if proc.returncode != 0:
        tail = (proc.stderr or proc.stdout).strip().splitlines()[-3:]
        raise RuntimeError("g++ failed: " + " | ".join(tail))
    os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> None:
    c_int_p = ctypes.POINTER(ctypes.c_int)
    lib.yat_jpeg_dims.restype = ctypes.c_int
    lib.yat_jpeg_dims.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                  c_int_p, c_int_p]
    lib.yat_decode_batch_u8.restype = None
    lib.yat_decode_batch_u8.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), c_int_p, ctypes.c_int]


def _load() -> Optional[ctypes.CDLL]:
    st = _STATE
    with st.lock:
        if st.tried:
            return st.lib
        st.tried = True
        try:
            lib = ctypes.CDLL(str(_build()))
            _bind(lib)
            st.lib = lib
        except (RuntimeError, OSError, AttributeError) as e:
            st.reason = str(e)
            print(f"[native] JPEG decoder unavailable, images decode "
                  f"through cv2: {st.reason}")
        return st.lib


def available() -> bool:
    """Whether the native decoder built and loaded (built on first call)."""
    return _load() is not None


def unavailable_reason() -> Optional[str]:
    """Why the native decoder is not available, or None when it is."""
    _load()
    return _STATE.reason


def jpeg_dims(data: bytes) -> Optional[Tuple[int, int]]:
    """(height, width) from the JPEG header, without a decode; None for a
    header libjpeg rejects."""
    lib = _load()
    if lib is None:
        return None
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.yat_jpeg_dims(data, len(data), ctypes.byref(h),
                         ctypes.byref(w)) != 0:
        return None
    return h.value, w.value


def decode_batch(datas: List[bytes], target_h: int, target_w: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """JPEG bytes → (uint8 pixels ``[N, target_h, target_w, 3]``, status
    int32 ``[N]``, 0 where the decode succeeded), one thread per image up
    to the CPU count.  Pixels stay uint8: the encoders normalise on the
    device."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native decode unavailable: {_STATE.reason}")
    n = len(datas)
    num_threads = min(n, os.cpu_count() or 1)
    status = np.empty((n,), np.int32)
    arr_ptr = (ctypes.c_char_p * n)(*datas)
    arr_len = (ctypes.c_size_t * n)(*[len(d) for d in datas])
    out = np.empty((n, target_h, target_w, 3), np.uint8)
    lib.yat_decode_batch_u8(
        arr_ptr, arr_len, n, target_h, target_w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), num_threads)
    return out, status
