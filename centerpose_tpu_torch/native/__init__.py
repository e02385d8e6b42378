"""Native (C++) host code: the soft-NMS core and the GT-encoder fill loop.

Counterpart of ``centerpose_tpu/native``, with copies of its two sources
(``soft_nms.cpp``, ``encoder.cpp``).  The shared library has a plain C ABI,
is loaded with ctypes and is built with ``g++`` at first use into
``centerpose_tpu_torch/build/``.  Its file name carries a hash of the
sources and the flags, so an edited source is rebuilt, and it is compiled
to a temporary file of the building process and then renamed: processes
that build at the same moment each write their own file, and a reader
never opens a half-written library.  Every entry point has a numpy
fallback (``available()`` says which path is live); setting
``CENTERPOSE_DISABLE_NATIVE=1`` forces the fallbacks.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "build"
_SOURCES = ("soft_nms.cpp", "encoder.cpp")
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
_build_failed = False


def library_path() -> Path:
    """The library's path: its name hashes the flags and both sources."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in _SOURCES:
        h.update(src.encode())
        h.update((_DIR / src).read_bytes())
    return BUILD_DIR / f"libcp_native_{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile the library unless it exists; returns its path.  Raises
    with the compiler's message when ``g++`` fails or is missing."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *_FLAGS, "-o", str(tmp), *(str(_DIR / s) for s in _SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so)
    finally:
        if tmp.exists():
            tmp.unlink()
    return so


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library (built if needed), or None when it cannot be."""
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            lib = ctypes.CDLL(str(build_library()))
        except (OSError, RuntimeError, subprocess.SubprocessError):
            _build_failed = True
            return None
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.soft_nms_39.restype = ctypes.c_int
        lib.soft_nms_39.argtypes = [
            f32p, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_int, i32p,
        ]
        lib.encode_targets.restype = ctypes.c_int
        lib.encode_targets.argtypes = [
            f32p, f32p, i32p,                       # bboxes, joints, vis
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            f32p, f32p, f32p, f32p, f32p,           # hm, hm_hp, wh, hps, reg
            i32p, f32p, f32p, f32p, i32p, f32p,     # ind..hp_mask
        ]
        _lib = lib
    return _lib


def available() -> bool:
    """True when the native library is built and loaded (and not disabled
    by ``CENTERPOSE_DISABLE_NATIVE``)."""
    if os.environ.get("CENTERPOSE_DISABLE_NATIVE"):
        return False
    return _load() is not None


def soft_nms_39_native(dets: np.ndarray, sigma: float = 0.5, nt: float = 0.5,
                       thresh: float = 0.001, method: int = 2):
    """Native soft-NMS; the surviving rows in pick order, or None when the
    library is unavailable (the caller falls back to numpy).  ``dets`` is
    not modified."""
    if not available():
        return None
    dets = np.ascontiguousarray(dets, dtype=np.float32).copy()
    n = dets.shape[0]
    keep = np.zeros((max(n, 1),), np.int32)
    n_keep = _lib.soft_nms_39(dets, n, sigma, nt, thresh, method, keep)
    return dets[keep[:n_keep]]


def encode_targets_native(bboxes: np.ndarray, joints: np.ndarray,
                          vis: np.ndarray, out_res: int, rot_nonzero: bool,
                          out: dict) -> bool:
    """Fill the target dict's arrays in place with the C++ core.

    ``out`` holds C-contiguous float32/int32 arrays with ``data/encode.py``'s
    shapes: hm [R,R,1], hm_hp [R,R,J], wh/reg [K,2], hps/hps_mask [K,2J],
    ind/reg_mask [K], hp_offset [K*J,2], hp_ind/hp_mask [K*J].  Returns
    False when the library is unavailable."""
    if not available():
        return False
    num_objs, num_joints = vis.shape
    _lib.encode_targets(
        np.ascontiguousarray(bboxes, np.float32),
        np.ascontiguousarray(joints, np.float32),
        np.ascontiguousarray(vis, np.int32),
        num_objs, num_joints, out_res, int(rot_nonzero),
        out["hm"].reshape(-1), out["hm_hp"].reshape(-1),
        out["wh"].reshape(-1), out["hps"].reshape(-1), out["reg"].reshape(-1),
        out["ind"], out["reg_mask"], out["hps_mask"].reshape(-1),
        out["hp_offset"].reshape(-1), out["hp_ind"], out["hp_mask"],
    )
    return True
