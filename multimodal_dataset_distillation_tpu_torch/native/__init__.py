"""Native (C++) host components: the ``fastimage`` JPEG decode pool.

The port's own copy of ``multimodal_dataset_distillation_tpu/native/``:
the same ``fastimage.cpp`` and the same ctypes surface (:func:`get_fastimage`,
:func:`is_jpeg`, :func:`read_dims`, :func:`decode_batch`).  The library is
built with ``g++ -O3 -shared ... -ljpeg`` at first use into
``build/native/`` at the repository root (listed in ``.gitignore``).
Callers handle :func:`get_fastimage` returning ``None`` (no compiler or no
libjpeg: one printed line) and an image the pool cannot decode by falling
back to PIL.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "fastimage.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_SO = _BUILD_DIR / "_fastimage.so"
_lock = threading.Lock()
_lib = None
_tried = False


class _FiTask(ctypes.Structure):
    _fields_ = [
        ("data", ctypes.c_void_p),
        ("size", ctypes.c_int64),
        ("crop_x", ctypes.c_int32),
        ("crop_y", ctypes.c_int32),
        ("crop_w", ctypes.c_int32),
        ("crop_h", ctypes.c_int32),
        ("hflip", ctypes.c_int32),
    ]


def _build() -> Optional[Path]:
    if _SO.exists() and _SO.stat().st_mtime >= _SRC.stat().st_mtime:
        return _SO
    try:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(
                ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", str(_SRC),
                 "-ljpeg", "-o", tmp],
                check=True, capture_output=True, timeout=300)
            os.replace(tmp, _SO)  # atomic: old or new, never half
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return _SO
    except (OSError, subprocess.SubprocessError) as e:
        print(f"fastimage: native build unavailable ({e}); using PIL")
        return None


def get_fastimage():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        so = _build()
        if so is None:
            return None
        lib = ctypes.CDLL(str(so))
        lib.fi_read_dims.restype = ctypes.c_int
        lib.fi_read_dims.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                     ctypes.POINTER(ctypes.c_int32),
                                     ctypes.POINTER(ctypes.c_int32)]
        lib.fi_decode_batch.restype = ctypes.c_int
        lib.fi_decode_batch.argtypes = [ctypes.POINTER(_FiTask),
                                        ctypes.c_int32, ctypes.c_void_p,
                                        ctypes.c_int32, ctypes.c_int32]
        _lib = lib
        return _lib


def is_jpeg(data: bytes) -> bool:
    return len(data) > 3 and data[:3] == b"\xff\xd8\xff"


def read_dims(data: bytes) -> Optional[Tuple[int, int]]:
    """(width, height) of a JPEG byte string, header-only parse."""
    lib = get_fastimage()
    if lib is None or not is_jpeg(data):
        return None
    w = ctypes.c_int32()
    h = ctypes.c_int32()
    buf = (ctypes.c_char * len(data)).from_buffer_copy(data)
    if lib.fi_read_dims(ctypes.addressof(buf), len(data),
                        ctypes.byref(w), ctypes.byref(h)) != 0:
        return None
    return int(w.value), int(h.value)


def decode_batch(items: Sequence[Tuple[bytes, Tuple[int, int, int, int], bool]],
                 out_size: int,
                 n_threads: Optional[int] = None) -> Tuple[np.ndarray, List[int]]:
    """Decode JPEGs to (N, out_size, out_size, 3) uint8 RGB.

    items: (jpeg_bytes, (crop_x, crop_y, crop_w, crop_h), hflip) per image.
    Returns (array, failed_indices): failed slots are zeros, and the caller
    decodes those with PIL.
    """
    lib = get_fastimage()
    if lib is None:
        raise RuntimeError("fastimage native library unavailable")
    n = len(items)
    out = np.zeros((n, out_size, out_size, 3), np.uint8)
    keep = []  # the buffers stay alive through the call
    tasks = (_FiTask * n)()
    for i, (data, (cx, cy, cw, ch), flip) in enumerate(items):
        buf = (ctypes.c_char * len(data)).from_buffer_copy(data)
        keep.append(buf)
        tasks[i] = _FiTask(ctypes.addressof(buf), len(data),
                           cx, cy, cw, ch, int(flip))
    nt = n_threads or min(8, os.cpu_count() or 1)
    nfail = lib.fi_decode_batch(tasks, n, out.ctypes.data_as(ctypes.c_void_p),
                                out_size, nt)
    failed = []
    if nfail:
        failed = [i for i in range(n) if not out[i].any()]
    return out, failed
