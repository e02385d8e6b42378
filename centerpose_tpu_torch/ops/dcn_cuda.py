"""DCNv2 site policy and the Hopper kernel of the om-fused forward (K1).

Counterpart of ``centerpose_tpu/ops/dcn_pallas.py``.  Two parts:

* **Site policy.**  The JAX package decides per DCN site, from its shape and
  a TPU VMEM estimate, whether the fused Pallas kernels run it, and at what
  y-clamp radius R (``resolve_max_dy``, ``pallas_supported``,
  ``fused_om_supported``).  A site the kernels take computes DCNv2 with dy
  clipped to +-R; a site they refuse falls back to the unclamped XLA op.
  So the function a site computes depends on that arithmetic, and the
  flagship snapshot was trained under it.  This module keeps its own copy
  of the arithmetic, so that the port computes the same function at every
  site.  It is a statement about the reference, not about H100 limits.
* **K1 kernel.**  ``dcn_v2_fused`` launches the CUDA kernel of
  ``csrc/dcn_fused.cu`` (offset/mask conv + clamped bilinear gather +
  GEMM) for a CUDA tensor and uses the plain version
  (``ops/dcn.py: dcn_v2_fused_plain``) for a CPU tensor.  The library is
  built with ``nvcc`` at first use, into ``centerpose_tpu_torch/build/``,
  keyed by a hash of the sources, and loaded with ``ctypes``.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

from centerpose_tpu_torch.ops.dcn import dcn_v2_fused_plain

# ---------------------------------------------------------------------------
# Site policy: a copy of the reference's dispatch arithmetic
# (dcn_pallas.py: DEFAULT_MAX_DY, resolve_max_dy, pallas_supported,
# fused_om_supported and the VMEM estimates they call).
# ---------------------------------------------------------------------------

_VMEM_LIMIT = 14 * 1024 * 1024

# Per-width y-clamp radii of the reference (sized there from the learned
# offset envelope of a converged flagship).
DEFAULT_MAX_DY = {16: 24, 32: 12, 64: 12, 128: 6}

# Structural cap of the reference's row-major kernels.
_ROWMAJOR_DY_CAP = 6


def default_max_dy(w: int) -> int:
    return DEFAULT_MAX_DY.get(w, _ROWMAJOR_DY_CAP)


def resolve_max_dy(h: int, w: int, cin: int, cout: int, max_dy: int = 0) -> int:
    """The clamp radius a site runs with: explicit ``max_dy`` (0 = per-width
    default), lowered to the row-major cap where the grouped layout does not
    apply."""
    md = int(max_dy) if max_dy else default_max_dy(w)
    if _grouped_ok(h, w, cin, cout, md):
        return md
    return min(md, _ROWMAJOR_DY_CAP)


def _grouped_dy_ok(grp: int, br: int, max_dy: int) -> bool:
    shift = max_dy + 1
    m_lo = -(shift // grp + 1)
    m_hi = (grp - 1 + shift + 1) // grp
    return 8 + m_lo >= 0 and m_hi <= 8


def _roundup(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def _rowmajor_br(h: int, w: int, cin: int, cout: int) -> int:
    if h % 16 == 0 and pallas_vmem_bytes(h, w, cin, cout, br=16) <= _VMEM_LIMIT:
        return 16
    return 8


def pallas_vmem_bytes(h: int, w: int, cin: int, cout: int, max_dy: int = 4,
                      br: int = 8) -> int:
    slab = br + 16
    x_slab = 4 * slab * _roundup(cin, 8) * _roundup(w, 128)
    z_buf = 2 * slab * _roundup(9 * cout, 8) * _roundup(w, 128)
    wmat = 4 * _roundup(9 * cout, 8) * _roundup(cin, 128)
    out_blk = 2 * 4 * br * _roundup(cout, 8) * _roundup(w, 128)
    offs = 2 * 4 * (br * _roundup(18, 8) * _roundup(w, 128)
                    + br * _roundup(9, 8) * _roundup(w, 128))
    a_buf = 4 * br * _roundup(w, 8) * _roundup(w, 128)
    return x_slab + z_buf + wmat + out_blk + offs + a_buf


def grouped_vmem_bytes(h: int, w: int, cin: int, cout: int, max_dy: int = 4,
                       br: int = 0) -> int:
    grp = 128 // w
    hg = h // grp
    if not br:
        br = min(8, hg)
    slab = br + 16
    xs = 4 * slab * _roundup(cin, 8) * 128
    z_buf = 2 * slab * _roundup(cout, 8) * 128
    wmat = 2 * _roundup(9 * cout, 8) * _roundup(cin, 128)
    out_blk = 2 * 4 * br * _roundup(cout, 8) * 128
    offs = 2 * 4 * br * (_roundup(18, 8) + _roundup(9, 8)) * 128
    a_buf = 4 * br * 128 * 128
    return xs + z_buf + wmat + out_blk + offs + a_buf


def _grouped_br(h: int, w: int, cin: int, cout: int, max_dy: int = 4) -> int:
    grp = 128 // w
    hg = h // grp
    for br in (16, 8, min(8, hg)):
        if (0 < br <= hg and hg % br == 0
                and _grouped_dy_ok(grp, br, max_dy)
                and grouped_vmem_bytes(h, w, cin, cout, max_dy, br)
                <= _VMEM_LIMIT):
            return br
    return 0


def _rowmajor_ok(h: int, w: int, cin: int, cout: int, max_dy: int = 4) -> bool:
    return (w <= 128 and h % 8 == 0 and max_dy <= _ROWMAJOR_DY_CAP
            and pallas_vmem_bytes(h, w, cin, cout) <= _VMEM_LIMIT)


def _grouped_ok(h: int, w: int, cin: int, cout: int, max_dy: int = 4) -> bool:
    if w not in (16, 32, 64) or h % (128 // w):
        return False
    return _grouped_br(h, w, cin, cout, max_dy) > 0


def pallas_supported(h: int, w: int, cin: int, cout: int, kernel: int = 3,
                     stride: int = 1, dilation: int = 1,
                     deformable_groups: int = 1, max_dy: int = 0) -> bool:
    """True where the reference runs the site through a fused (clamped)
    kernel; False where it falls back to the unclamped XLA op."""
    if not (kernel == 3 and stride == 1 and dilation == 1
            and deformable_groups == 1):
        return False
    md = resolve_max_dy(h, w, cin, cout, max_dy)
    return _grouped_ok(h, w, cin, cout, md) or _rowmajor_ok(h, w, cin, cout, md)


def _fom_extra_bytes(wl: int, cin: int, br: int) -> int:
    zom = 2 * (br + 2) * 288 * wl
    om = 2 * 4 * br * 32 * wl
    omw = 2 * 288 * _roundup(cin, 128)
    omb = 4 * 32 * wl
    return zom + om + omw + omb


def _fom_saved_bytes(wl: int, br: int) -> int:
    return 2 * 4 * br * (_roundup(18, 8) + _roundup(9, 8)) * wl


def _rowmajor_fom_ok(h: int, w: int, cin: int, cout: int, max_dy: int) -> bool:
    if w != 128 or h % 8 or max_dy > _ROWMAJOR_DY_CAP:
        return False
    br = _rowmajor_br(h, w, cin, cout)
    return (pallas_vmem_bytes(h, w, cin, cout, max_dy, br)
            + _fom_extra_bytes(w, cin, br) - _fom_saved_bytes(w, br)
            <= _VMEM_LIMIT)


def _grouped_fom_br(h: int, w: int, cin: int, cout: int, max_dy: int) -> int:
    grp = 128 // w
    hg = h // grp
    for br in (16, 8, min(8, hg)):
        if (0 < br <= hg and hg % br == 0
                and _grouped_dy_ok(grp, br, max_dy)
                and grouped_vmem_bytes(h, w, cin, cout, max_dy, br)
                + _fom_extra_bytes(128, cin, br) - _fom_saved_bytes(128, br)
                <= _VMEM_LIMIT):
            return br
    return 0


def _grouped_fom_ok(h: int, w: int, cin: int, cout: int, max_dy: int) -> bool:
    if w not in (16, 32, 64) or h % (128 // w):
        return False
    return _grouped_fom_br(h, w, cin, cout, max_dy) > 0


def fused_om_supported(h: int, w: int, cin: int, cout: int, kernel: int = 3,
                       stride: int = 1, dilation: int = 1,
                       deformable_groups: int = 1, max_dy: int = 0) -> bool:
    """True where the reference runs the site through its om-fused kernel."""
    if not (kernel == 3 and stride == 1 and dilation == 1
            and deformable_groups == 1):
        return False
    md = resolve_max_dy(h, w, cin, cout, max_dy)
    return (_grouped_fom_ok(h, w, cin, cout, md)
            or _rowmajor_fom_ok(h, w, cin, cout, md))


@functools.lru_cache(maxsize=None)
def site_max_dy(h: int, w: int, cin: int, cout: int, dcn_impl: str,
                max_dy: int = 0) -> Optional[int]:
    """The y-clamp radius a DCN site computes with at inference, as the
    reference's ``models/dla.py: DCN`` dispatches it: R where a fused kernel
    takes the site (om-fused or not, both resolve R the same way), ``None``
    (unclamped) where it falls back to XLA, and always ``None`` under
    ``dcn_impl="xla"``."""
    if dcn_impl in ("xla", "xla_patch"):
        return None
    if dcn_impl not in ("pallas", "pallas_full"):
        raise NotImplementedError(f"dcn_impl={dcn_impl!r} is not ported")
    if (fused_om_supported(h, w, cin, cout, max_dy=max_dy)
            or pallas_supported(h, w, cin, cout, max_dy=max_dy)):
        return resolve_max_dy(h, w, cin, cout, max_dy)
    return None


# ---------------------------------------------------------------------------
# K1: build, load, launch
# ---------------------------------------------------------------------------

_PKG = Path(__file__).resolve().parent.parent
_SOURCES = (_PKG / "csrc" / "dcn_fused.cu",)
BUILD_DIR = _PKG / "build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
KERNELS_PER_CALL = 2  # __global__ launches of one cp_dcn_v2_fused_forward

_lib_lock = threading.Lock()
_lib: list = []  # the loaded ctypes library, once built


def find_nvcc() -> str:
    """nvcc from ``CUDA_HOME``/``CUDA_PATH``, then ``PATH``, then
    /usr/local/cuda (the order of torch.utils.cpp_extension)."""
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.isfile("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    """Where the built library lives: the name carries a hash of the
    sources and flags, so an edited source is rebuilt."""
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for src in _SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcp_dcn_{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile the kernel sources with nvcc unless the hashed library
    exists; returns its path.  The compiler's report (registers, shared
    memory, spills) is kept beside it as ``.log``."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), *map(str, _SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return so


def _library() -> ctypes.CDLL:
    with _lib_lock:
        if not _lib:
            lib = ctypes.CDLL(str(build_library()))
            fn = lib.cp_dcn_v2_fused_forward
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                           + [ctypes.c_int] * 5
                           + [ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _lib.append(lib)
        return _lib[0]


def _check(name: str, t: torch.Tensor, shape: tuple, dtype: torch.dtype,
           device: torch.device) -> None:
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def dcn_v2_fused(x: torch.Tensor, omw: torch.Tensor, omb: torch.Tensor,
                 weight: torch.Tensor, bias: Optional[torch.Tensor],
                 max_dy: Optional[float]) -> torch.Tensor:
    """Om-fused DCNv2 forward (K1).  x [B,H,W,Cin] NHWC, omw [3,3,Cin,27],
    omb [27], weight [3,3,Cin,Cout], bias [Cout] or None; ``max_dy`` is the
    site's clamp radius or None (unclamped).  -> [B,H,W,Cout] in x's dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (x, omw, omb and weight float32 or bfloat16, all one dtype; bias
    float32, added before the output's rounding as the reference does;
    all contiguous) or raises."""
    if x.device.type == "cpu":
        return dcn_v2_fused_plain(x, omw, omb, weight, bias, max_dy)
    if x.device.type != "cuda":
        raise RuntimeError(f"dcn_v2_fused: no kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"dcn_v2_fused: dtype {x.dtype} (float32 or bfloat16)")
    if x.dim() != 4:
        raise ValueError(f"x: expected [B,H,W,Cin], got {tuple(x.shape)}")
    b, h, w, cin = x.shape
    cout = weight.shape[-1]
    dev, dt = x.device, x.dtype
    if bias is None:
        bias = torch.zeros(cout, dtype=torch.float32, device=dev)
    _check("x", x, (b, h, w, cin), dt, dev)
    _check("omw", omw, (3, 3, cin, 27), dt, dev)
    _check("omb", omb, (27,), dt, dev)
    _check("weight", weight, (3, 3, cin, cout), dt, dev)
    _check("bias", bias, (cout,), torch.float32, dev)
    lib = _library()
    om = torch.empty((b, h, w, 27), dtype=torch.float32, device=dev)
    y = torch.empty((b, h, w, cout), dtype=dt, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.cp_dcn_v2_fused_forward(
            _DTYPE_CODE[dt], x.data_ptr(), omw.data_ptr(), omb.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), om.data_ptr(), y.data_ptr(),
            b, h, w, cin, cout, -1.0 if max_dy is None else float(max_dy),
            stream)
    if rc != 0:
        raise RuntimeError(f"dcn_v2_fused: CUDA error {rc} at launch "
                           f"(x {tuple(x.shape)} {dt}, Cout {cout})")
    dcn_v2_fused.launches += KERNELS_PER_CALL
    dcn_v2_fused.launches_by_site[(cin, cout, h, w)] += KERNELS_PER_CALL
    return y


# Launch counts of the kernels: a successful call adds one per kernel it
# launched (KERNELS_PER_CALL: the om conv, then the product), nothing else
# does.  Callers reset them with ``reset_launch_counts``.
dcn_v2_fused.launches = 0
dcn_v2_fused.launches_by_site = collections.Counter()


def reset_launch_counts() -> None:
    dcn_v2_fused.launches = 0
    dcn_v2_fused.launches_by_site.clear()
