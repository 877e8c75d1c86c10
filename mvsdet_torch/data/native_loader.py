"""ctypes binding for the port's native image library (port of
mvsdet_tpu/data/native_loader.py).

`_native/image_ops.cpp` decodes JPEG and PNG files (libjpeg, libpng) and
resizes them bilinearly, one image or a thread-pooled batch.  It is built
with g++ at first use into `<repo>/build/native/`, under a name that
carries the hash of the source and the flags, so an edited source is never
served by a stale library; never beside the source, and never the JAX
package's library.  Where it cannot be built (no libjpeg or libpng
headers), or a library built elsewhere does not load, `load` raises with
the reason: it does not return None.  `data/pipeline.py` decides what to do
then (cv2, or an error naming both).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "_native" / "image_ops.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
LIBS = ("-ljpeg", "-lpng", "-pthread")

_lock = threading.Lock()
_loaded: List[ctypes.CDLL] = []

_u8p = ctypes.POINTER(ctypes.c_ubyte)
_f32p = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "mvsdet_load_resize_rgb": [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                               _u8p],
    "mvsdet_load_depth_png": [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                              _f32p, ctypes.c_float],
    "mvsdet_load_batch_rgb": [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                              ctypes.c_int, ctypes.c_int, _u8p, ctypes.c_int],
}


def library_path() -> Path:
    """Where the library is built for the current source and flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"libimage_ops-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except FileNotFoundError as exc:
        raise RuntimeError(f"native image library: g++ not found ({exc})") \
            from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native image library: g++ exited {proc.returncode} (it needs "
            f"libjpeg's and libpng's headers and libraries):\n"
            f"{proc.stderr.strip()}")
    os.replace(tmp, out)            # atomic: other processes never see a part


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed.  Raises RuntimeError when
    it cannot be built or loaded."""
    with _lock:
        if not _loaded:
            path = library_path()
            if not path.exists():
                _build(path)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as exc:      # built elsewhere: a library it
                raise RuntimeError(     # links against is not here
                    f"native image library {path} does not load: {exc}") \
                    from exc
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = ctypes.c_int, argtypes
            _loaded.append(lib)
        return _loaded[0]


def load_resize_rgb(path: str, hw: Tuple[int, int]) -> np.ndarray:
    """Decode one JPEG/PNG and resize to (h, w); returns (h, w, 3) uint8."""
    h, w = hw
    out = np.empty((h, w, 3), np.uint8)
    rc = load().mvsdet_load_resize_rgb(path.encode(), h, w,
                                       out.ctypes.data_as(_u8p))
    if rc != 0:
        raise IOError(f"native decode failed ({rc}): {path}")
    return out


def load_depth_png(path: str, hw: Tuple[int, int],
                   scale: float = 1e-3) -> np.ndarray:
    """Decode a 16-bit mm depth PNG, resize, convert to metres."""
    h, w = hw
    out = np.empty((h, w), np.float32)
    rc = load().mvsdet_load_depth_png(path.encode(), h, w,
                                      out.ctypes.data_as(_f32p), scale)
    if rc != 0:
        raise IOError(f"native depth decode failed ({rc}): {path}")
    return out


def load_batch_rgb(paths: List[str], hw: Tuple[int, int],
                   n_threads: int = 0) -> np.ndarray:
    """Thread-pooled batch decode+resize -> (n, h, w, 3) uint8."""
    lib = load()
    h, w = hw
    n = len(paths)
    out = np.empty((n, h, w, 3), np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    if n_threads <= 0:
        n_threads = min(8, os.cpu_count() or 1)
    bad = lib.mvsdet_load_batch_rgb(arr, n, h, w, out.ctypes.data_as(_u8p),
                                    n_threads)
    if bad:
        raise IOError(f"{bad}/{n} images failed to decode")
    return out

