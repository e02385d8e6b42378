"""DCNv2 site policy and the Hopper kernels: the om-fused forward (K1), the
forward from explicit offsets (K2) and the backward (the function of K3, K4
and K5 in one call).

Counterpart of ``centerpose_tpu/ops/dcn_pallas.py``.  Three parts:

* **Site policy.**  The JAX package decides per DCN site, from its shape and
  a TPU VMEM estimate, whether the fused Pallas kernels run it, and at what
  y-clamp radius R (``resolve_max_dy``, ``pallas_supported``,
  ``fused_om_supported``).  A site the kernels take computes DCNv2 with dy
  clipped to +-R; a site they refuse falls back to the unclamped XLA op.
  So the function a site computes depends on that arithmetic, and the
  flagship snapshot was trained under it.  This module keeps its own copy
  of the arithmetic, so that the port computes the same function at every
  site: ``site_max_dy`` at inference, ``train_site_max_dy`` in training,
  and ``train_site_edge_grad``, the clamp's gradient at exactly +-R, which
  follows the reference's backward dispatch (its kernels pass 1 there, its
  XLA fallback 0.5).  It is a statement about the reference, not about
  H100 limits.
* **Kernels.**  ``csrc/dcn_fused.cu`` holds K1 (offset/mask conv +
  clamped bilinear gather + GEMM; in bf16 one warp-specialised wgmma
  launch per call) and K2 (the same kernel on explicit offsets and mask);
  ``csrc/dcn_bwd.cu`` the backward of both; ``csrc/dcn_hopper.cuh`` the
  Hopper helpers they share.  Each source is built with ``nvcc`` at first
  use into a library of its own in ``centerpose_tpu_torch/build/`` (one
  ``nvcc`` per source, all started together), keyed by a hash of the
  source, the headers it includes and the flags, and loaded with
  ``ctypes``.  ``forward_plan`` is the bf16 forward's launch plan (tile,
  split of the reduction, ring stages, shared memory), computed here from
  the shapes and checked by the kernel's entry point.
* **Operators and autograd.**  K1 is the ``torch.library`` operator
  ``centerpose::dcn_v2_fused`` (a fake kernel for tracing, a FLOP formula,
  the plain version on the CPU, the kernel on CUDA), so that
  ``torch.export`` and ``torch.compile`` keep it as one node; its
  registered gradient launches the backward kernel (the reference's
  ``_fused_fwd``/``_fused_bwd``).  K2 (``dcn_v2``) is a
  ``torch.autograd.Function`` on a CUDA tensor with the same backward
  (``_fwd``/``_bwd``/``_bwd_core``); it and the backward are bound by
  ``ctypes`` and cannot be traced.  A CPU tensor takes the plain version
  (``ops/dcn.py``), differentiated by autograd; a CUDA tensor launches the
  kernel or raises.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import math
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from centerpose_tpu_torch.ops.dcn import dcn_v2 as dcn_v2_plain
from centerpose_tpu_torch.ops.dcn import (dcn_v2_backward_plain,
                                          dcn_v2_fused_plain, offset_mask)

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


def _grouped_bwd_vmem(h: int, w: int, cin: int, cout: int, max_dy: int,
                      compact: bool) -> int:
    grp = 128 // w
    hg = h // grp
    br = min(8, hg)
    pad_g = math.ceil((max_dy + 2) / grp)
    hpad = hg + 2 * pad_g
    xb = 2 if compact else 4
    x_blk = xb * hpad * _roundup(cin, 8) * 128
    dx_buf = 4 * hpad * _roundup(cin, 8) * 128
    cols = 2 * 4 * br * _roundup(cin, 8) * 128
    ct_blk = 2 * 4 * br * 128 * _roundup(cout, 128)
    doffm = 2 * 4 * br * (_roundup(18, 8) + 2 * _roundup(9, 8)) * 128
    w_in = xb * _roundup(9 * cin, 8) * _roundup(cout, 128)
    dw = 4 * _roundup(9 * cin, 8) * _roundup(cout, 128)
    a_buf = 4 * br * 128 * 128
    return x_blk + dx_buf + cols + ct_blk + doffm + w_in + dw + a_buf


def _grouped_bwd_mode(h: int, w: int, cin: int, cout: int,
                      max_dy: int = 4) -> Optional[str]:
    if w not in (16, 32, 64) or 128 % w:
        return None
    grp = 128 // w
    hg, rem = divmod(h, grp)
    if rem:
        return None
    br = min(8, hg)
    if hg % br:
        return None
    if _grouped_bwd_vmem(h, w, cin, cout, max_dy, False) <= _VMEM_LIMIT:
        return "f32"
    if _grouped_bwd_vmem(h, w, cin, cout, max_dy, True) <= _VMEM_LIMIT:
        return "compact"
    return None


def _grouped_bwd_ok(h: int, w: int, cin: int, cout: int,
                    max_dy: int = 4) -> bool:
    """The reference runs its fused grouped backward (K3) here."""
    return _grouped_bwd_mode(h, w, cin, cout, max_dy) is not None


def _rowmajor_dx_ok(h: int, w: int, cin: int, cout: int,
                    max_dy: int = 4) -> bool:
    if w != 128 or h % 8 or max_dy > _ROWMAJOR_DY_CAP:
        return False
    br = _rowmajor_br(h, w, cin, cout)
    slab = br + 16
    slabs = 4 * slab * (_roundup(2 * 9, 8) + _roundup(9, 8)
                        + _roundup(cout, 8)) * w
    dcols = 2 * slab * 9 * cin * w
    wmat = 4 * _roundup(9 * cin, 8) * _roundup(cout, 128)
    out_blk = 2 * 4 * br * _roundup(cin, 8) * w
    a_buf = 4 * br * w * w
    return slabs + dcols + wmat + out_blk + a_buf <= _VMEM_LIMIT


def _rowmajor_grads_vmem(h: int, w: int, cin: int, cout: int) -> int:
    br = _rowmajor_br(h, w, cin, cout)
    slab = br + 16
    xs = 4 * slab * _roundup(cin, 8) * w
    in_blk = 2 * 4 * br * (_roundup(18, 8) + _roundup(9, 8)
                           + _roundup(cout, 8)) * w
    out_blk = 2 * 4 * br * (_roundup(18, 8) + _roundup(9, 8)) * w
    wmats = 2 * 4 * _roundup(9 * cin, 8) * _roundup(cout, 128)
    dcols = 2 * br * cin * w
    cols = 4 * br * cin * w
    a_buf = (4 + 4 + 2 + 2) * br * w * w
    samples = 2 * 4 * br * _roundup(cin, 8) * w
    return xs + in_blk + out_blk + wmats + dcols + cols + a_buf + samples


def _rowmajor_split_ok(h: int, w: int, cin: int, cout: int,
                       max_dy: int = 4) -> bool:
    """The reference runs its split W=128 backward (K4 + K5) here."""
    return (_rowmajor_dx_ok(h, w, cin, cout, max_dy)
            and _rowmajor_grads_vmem(h, w, cin, cout) <= _VMEM_LIMIT)


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


@functools.lru_cache(maxsize=None)
def site_om_fused(h: int, w: int, cin: int, cout: int, dcn_impl: str,
                  max_dy: int = 0) -> bool:
    """True where the reference's ``models/dla.py: DCN`` takes the site
    through its om-fused kernel at inference: under ``pallas`` or
    ``pallas_full`` and inside ``fused_om_supported``'s envelope.  Every
    other site computes the offset/mask conv in the compute dtype and then
    the DCN from explicit offsets, as in training."""
    if dcn_impl in ("xla", "xla_patch"):
        return False
    if dcn_impl not in ("pallas", "pallas_full"):
        raise NotImplementedError(f"dcn_impl={dcn_impl!r} is not ported")
    return fused_om_supported(h, w, cin, cout, max_dy=max_dy)


@functools.lru_cache(maxsize=None)
def train_site_max_dy(h: int, w: int, cin: int, cout: int, dcn_impl: str,
                      max_dy: int = 0) -> Optional[int]:
    """The y-clamp radius a DCN site computes with in training, as the
    reference's ``models/dla.py: DCN`` dispatches it with ``train=True``
    (the om-fused kernel is inference-only there): R where
    ``pallas_supported`` takes the site into ``dcn_v2_pallas``, ``None``
    (the unclamped XLA fallback) elsewhere and under ``dcn_impl="xla"``."""
    if dcn_impl in ("xla", "xla_patch"):
        return None
    if dcn_impl not in ("pallas", "pallas_full"):
        raise NotImplementedError(f"dcn_impl={dcn_impl!r} is not ported")
    if pallas_supported(h, w, cin, cout, max_dy=max_dy):
        return resolve_max_dy(h, w, cin, cout, max_dy)
    return None


@functools.lru_cache(maxsize=None)
def train_site_edge_grad(h: int, w: int, cin: int, cout: int, dcn_impl: str,
                         max_dy: int = 0) -> float:
    """The gradient the y-clamp passes at exactly |dy| = R at a clamped
    site, as the reference's ``_bwd_core`` computes it: 1.0 where it runs
    its backward kernels (``dcn_impl="pallas_full"`` and K3's
    ``_grouped_bwd_ok`` or K4+K5's ``_rowmajor_split_ok``), 0.5 where it
    falls back to the VJP of ``_xla_fwd_clamped`` (``jnp.clip``'s gradient
    on the edge): the other clamped sites, and every site under
    ``dcn_impl="pallas"``.  1.0 at an unclamped site, where it is unused.
    The om-fused forward's backward dispatches the same way."""
    if train_site_max_dy(h, w, cin, cout, dcn_impl, max_dy) is None:
        return 1.0
    md = resolve_max_dy(h, w, cin, cout, max_dy)
    if dcn_impl == "pallas_full" and (
            _grouped_bwd_ok(h, w, cin, cout, md)
            or _rowmajor_split_ok(h, w, cin, cout, md)):
        return 1.0
    return 0.5


# ---------------------------------------------------------------------------
# Kernels: build, load, launch
# ---------------------------------------------------------------------------

_PKG = Path(__file__).resolve().parent.parent
# one library per source: "fwd" holds K1 and K2, "bwd" the backward
_SOURCES = {"fwd": _PKG / "csrc" / "dcn_fused.cu",
            "bwd": _PKG / "csrc" / "dcn_bwd.cu"}
BUILD_DIR = _PKG / "build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# __global__ launches of one K1 call: bf16 one (om conv and product in one
# block, split sites in one cluster launch), float32 two (om conv, product)
KERNELS_PER_CALL = {torch.bfloat16: 1, torch.float32: 2}
_SMEM_LIMIT = 232448  # bytes of shared memory a block may use on Hopper

_lib_lock = threading.Lock()
_libs: dict = {}  # name -> the loaded ctypes library, once built


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


_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.M)


def _local_headers(src: Path) -> list:
    """The headers ``src`` includes with quotes, and those they include,
    found beside the including file; each once, in first-seen order."""
    seen, todo = [], [src]
    while todo:
        cur = todo.pop(0)
        for name in _INCLUDE.findall(cur.read_text()):
            hdr = (cur.parent / name).resolve()
            if hdr.is_file() and hdr not in seen:
                seen.append(hdr)
                todo.append(hdr)
    return seen


def library_path(name: str) -> Path:
    """Where the library built from source ``name`` lives: the file name
    carries a hash of the flags, the source and every header it includes,
    so an edited source or header is rebuilt."""
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    h.update(_SOURCES[name].read_bytes())
    for hdr in _local_headers(_SOURCES[name]):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"libcp_dcn_{name}_{h.hexdigest()[:16]}.so"


def build_library() -> dict:
    """Compile every kernel source whose hashed library is missing, one
    ``nvcc`` per source, all started together; returns {name: path}.  The
    compiler's report (registers, shared memory, spills) is kept beside
    each library as ``.log``.  Each file is written under a name of this
    process and then renamed, so processes that build at once (the ranks
    of a data-parallel run) each write their own and a reader never opens
    half of one."""
    paths = {name: library_path(name) for name in _SOURCES}
    todo = {name: so for name, so in paths.items() if not so.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    procs = {}
    for name, so in todo.items():
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *_NVCC_FLAGS, "-o", str(tmp), str(_SOURCES[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errors = []
    for name, (tmp, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {_SOURCES[name].name} failed "
                          f"({proc.returncode}):\n{err}")
            continue
        log = tmp.with_name(f"{tmp.name}.log")
        log.write_text(out + err)
        os.replace(log, todo[name].with_suffix(".log"))
        os.replace(tmp, todo[name])
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def _library(name: str) -> ctypes.CDLL:
    with _lib_lock:
        if not _libs:
            paths = build_library()
            ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            fwd = ctypes.CDLL(str(paths["fwd"]))
            fwd.cp_dcn_v2_fused_forward.argtypes = (
                [i32] + [ptr] * 7 + [i32] * 5 + [f32] + [i32] * 3 + [ptr])
            fwd.cp_dcn_v2_forward.argtypes = (
                [i32] + [ptr] * 6 + [i32] * 5 + [f32] + [i32] * 3 + [ptr])
            bwd = ctypes.CDLL(str(paths["bwd"]))
            bwd.cp_dcn_v2_backward.argtypes = (
                [i32, i32] + [ptr] * 6 + [i32] + [ptr] * 5 + [i32] * 5
                + [f32, f32, ptr])
            bwd.cp_dcn_v2_backward_plan.argtypes = [i32] * 7 + [ptr]
            for fn in (fwd.cp_dcn_v2_fused_forward, fwd.cp_dcn_v2_forward,
                       bwd.cp_dcn_v2_backward, bwd.cp_dcn_v2_backward_plan):
                fn.restype = i32
            _libs.update(fwd=fwd, bwd=bwd)
        return _libs[name]


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


def _check_x(fn: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise RuntimeError(f"{fn}: no kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{fn}: dtype {x.dtype} (float32 or bfloat16)")
    if x.dim() != 4:
        raise ValueError(f"x: expected [B,H,W,Cin], got {tuple(x.shape)}")


def _radius(max_dy: Optional[float]) -> float:
    return -1.0 if max_dy is None else float(max_dy)


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(rc: int, fn: str, x: torch.Tensor, cout: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA error {rc} at launch "
                           f"(x {tuple(x.shape)} {x.dtype}, Cout {cout})")


def _site(x: torch.Tensor, cout: int) -> tuple:
    b, h, w, cin = x.shape
    return (cin, cout, h, w)


def _bias_or_zeros(bias: Optional[torch.Tensor], cout: int,
                   dev: torch.device) -> torch.Tensor:
    if bias is None:
        return torch.zeros(cout, dtype=torch.float32, device=dev)
    return bias


# The bf16 forward kernel (dcn_gemm_wgmma in csrc/dcn_fused.cu): its tile,
# its reduction chunks, its ring and its shared memory, mirrored here so
# that the plan is a function of the shapes the CPU tests can reach.
_TILE_M = 64          # pixels per block: one consumer warpgroup's wgmma M
_CHUNK = 64           # input channels per ring stage (the stage's K)
_OM_N = 32            # om columns: 27 padded to a wgmma N
_SMS = 132            # SMs of an H100 SXM
_SM_SMEM = 233472     # shared memory of one SM (228 KB)
_BLOCK_RESERVED = 1024  # shared memory the runtime keeps per block
_MAX_SPLIT = 8        # blocks of one cluster (the portable limit)
_MAX_STAGES = 4


def _align128(v: int) -> int:
    return _roundup(v, 128)


def fwd_smem_bytes(kp: int, stages: int) -> int:
    """Dynamic shared memory of one bf16 forward block (``FwdLayout`` in
    csrc/dcn_fused.cu): the ring of A [64 x 64] and B [64 x kp] bf16
    stages, their mbarriers, two corner tables, the f32 om tile and om
    partial, three slots of om weight rows [64][27] bf16."""
    stage = _TILE_M * _CHUNK * 2 + _CHUNK * kp * 2
    return (stages * stage + _align128(16 * stages) + 2 * 4 * _TILE_M * 12
            + _TILE_M * 27 * 4 + _TILE_M * _OM_N * 4 + 3 * _CHUNK * 27 * 2)


def _split_cost(tiles: int, chunks: int, resident: int, split: int) -> int:
    """Chunk steps of the longest block of a plan: waves of blocks times
    the chunks each takes, plus one for the cross-block reduction."""
    waves = -(-tiles * split // resident)
    return waves * -(-chunks // split) + (split > 1)


@functools.lru_cache(maxsize=None)
def forward_plan(dtype: torch.dtype, b: int, h: int, w: int, cin: int,
                 cout: int) -> dict:
    """The launch plan of one K1 or K2 call, a pure function of the shapes.

    bfloat16: one block per 64-pixel tile covering all of Cout (padded to
    ``n_pad``, a multiple of 64 up to 256); the 9*Cin reduction runs in
    ``chunks`` steps of (tap, 64 channels), j -> tap j // ``slices``.
    Where the tiles leave SMs idle, ``split`` blocks of one cluster share a
    tile, rank r taking chunks ``chunk_ranges[r]`` and summing output rows
    ``reduce_rows[r]`` in rank order (deterministic).  ``stages`` ring
    stages: as many as fit with two blocks per SM where Cout <= 128 (the
    registers allow two there), else one block per SM; at most four.
    float32: the CUDA-core kernels, 64 x 64 output tiles, no split."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"dcn_v2 forward: dtype {dtype}")
    if min(b, h, w, cin, cout) < 1:
        raise ValueError(f"dcn_v2 forward: shape {(b, h, w, cin, cout)}")
    npix = b * h * w
    tiles = -(-npix // _TILE_M)
    if dtype == torch.float32:
        return dict(kernel="f32", launches=KERNELS_PER_CALL[dtype],
                    tile_m=_TILE_M, tiles=tiles, col_tiles=-(-cout // 64),
                    n_pad=_roundup(cout, 64), split=1, stages=0, smem=0,
                    slices=-(-cin // 32), chunk=32,
                    chunks=9 * -(-cin // 32),
                    chunk_ranges=((0, 9 * -(-cin // 32)),),
                    reduce_rows=((0, _TILE_M),), grid=(tiles, -(-cout // 64)))
    if cout > 256:
        raise ValueError(f"dcn_v2 forward: Cout {cout} > 256 (bfloat16)")
    if npix >= (1 << 31) // 8:
        raise ValueError(f"dcn_v2 forward: {npix} pixels")
    nt = -(-cout // 64)
    kp = 64 * nt
    per_sm = 2 if nt <= 2 else 1
    room = min(_SM_SMEM // per_sm - _BLOCK_RESERVED, _SMEM_LIMIT)
    stage = _TILE_M * _CHUNK * 2 + _CHUNK * kp * 2
    stages = min(_MAX_STAGES, (room - fwd_smem_bytes(kp, 0)) // stage)
    smem = fwd_smem_bytes(kp, stages)
    slices = -(-cin // _CHUNK)
    chunks = 9 * slices
    resident = _SMS * per_sm  # blocks the card holds at once
    split = 1
    if tiles < resident:
        split = min(range(1, min(_MAX_SPLIT, chunks) + 1),
                    key=lambda s: (_split_cost(tiles, chunks, resident, s),
                                   s))
    return dict(kernel="wgmma", launches=KERNELS_PER_CALL[dtype],
                tile_m=_TILE_M, tiles=tiles, col_tiles=1, n_pad=kp,
                split=split, stages=stages, smem=smem, slices=slices,
                chunk=_CHUNK, chunks=chunks,
                chunk_ranges=tuple((r * chunks // split,
                                    (r + 1) * chunks // split)
                                   for r in range(split)),
                reduce_rows=tuple((r * _TILE_M // split,
                                   (r + 1) * _TILE_M // split)
                                  for r in range(split)),
                grid=(tiles * split,))


def launch_fused_forward(x, omw, omb, weight, bias, max_dy):
    """One K1 call: -> (y [B,H,W,Cout] in x's dtype, om [B,H,W,27] f32 with
    the raw offsets in channels 0..17 and the sigmoid-ed mask in 18..26)."""
    _check_x("dcn_v2_fused", x)
    b, h, w, cin = x.shape
    cout = weight.shape[-1]
    dev, dt = x.device, x.dtype
    bias = _bias_or_zeros(bias, cout, dev)
    _check("x", x, (b, h, w, cin), dt, dev)
    _check("omw", omw, (3, 3, cin, 27), dt, dev)
    _check("omb", omb, (27,), dt, dev)
    _check("weight", weight, (3, 3, cin, cout), dt, dev)
    _check("bias", bias, (cout,), torch.float32, dev)
    lib = _library("fwd")
    plan = forward_plan(dt, b, h, w, cin, cout)
    om = torch.empty((b, h, w, 27), dtype=torch.float32, device=dev)
    y = torch.empty((b, h, w, cout), dtype=dt, device=dev)
    with torch.cuda.device(dev):
        rc = lib.cp_dcn_v2_fused_forward(
            _DTYPE_CODE[dt], x.data_ptr(), omw.data_ptr(), omb.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), om.data_ptr(), y.data_ptr(),
            b, h, w, cin, cout, _radius(max_dy), plan["split"],
            plan["stages"], plan["smem"], _stream(dev))
    _raise_on(rc, "dcn_v2_fused", x, cout)
    dcn_v2_fused.launches += plan["launches"]
    dcn_v2_fused.launches_by_site[_site(x, cout)] += plan["launches"]
    return y, om


def launch_forward(x, offset, mask, weight, bias, max_dy):
    """One K2 call: x, offset [B,H,W,18], mask [B,H,W,9] and weight in one
    dtype (float32 or bfloat16), bias float32 or None -> y in x's dtype."""
    _check_x("dcn_v2", x)
    b, h, w, cin = x.shape
    cout = weight.shape[-1]
    dev, dt = x.device, x.dtype
    bias = _bias_or_zeros(bias, cout, dev)
    _check("x", x, (b, h, w, cin), dt, dev)
    _check("offset", offset, (b, h, w, 18), dt, dev)
    _check("mask", mask, (b, h, w, 9), dt, dev)
    _check("weight", weight, (3, 3, cin, cout), dt, dev)
    _check("bias", bias, (cout,), torch.float32, dev)
    lib = _library("fwd")
    plan = forward_plan(dt, b, h, w, cin, cout)
    y = torch.empty((b, h, w, cout), dtype=dt, device=dev)
    with torch.cuda.device(dev):
        rc = lib.cp_dcn_v2_forward(
            _DTYPE_CODE[dt], x.data_ptr(), offset.data_ptr(),
            mask.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            y.data_ptr(), b, h, w, cin, cout, _radius(max_dy),
            plan["split"], plan["stages"], plan["smem"], _stream(dev))
    _raise_on(rc, "dcn_v2", x, cout)
    dcn_v2.launches += 1
    dcn_v2.launches_by_site[_site(x, cout)] += 1
    return y


@functools.lru_cache(maxsize=None)
def backward_plan(dtype: torch.dtype, off_dtype: torch.dtype, b: int, h: int,
                  w: int, cin: int, cout: int) -> dict:
    """The backward kernel's launch plan for a shape: its largest block's
    shared memory and its workspace (bytes: dcols for the dx pass, the
    corner lists, and the partial sums that are reduced in a fixed
    order)."""
    out = (ctypes.c_longlong * 2)()
    rc = _library("bwd").cp_dcn_v2_backward_plan(
        _DTYPE_CODE[dtype], _DTYPE_CODE[off_dtype], b, h, w, cin, cout, out)
    if rc != 0:
        raise ValueError(f"dcn_v2_backward: no plan for x [{b},{h},{w},{cin}]"
                         f" {dtype}, Cout {cout} (CUDA error {rc})")
    return dict(smem=out[0], workspace=out[1])


def launch_backward(x, offset, mask, weight, ct, max_dy, edge_grad,
                    dx_in_x_dtype=False):
    """One backward call (the function of K3, K4 and K5): x and weight in
    one dtype, offset [B,H,W,18] and mask [B,H,W,9] (sigmoid-ed) float32 or
    x's dtype, cotangent ct [B,H,W,Cout] -> (dx, doffset, dmask, dW, dbias)
    in f32, dx in x's dtype where ``dx_in_x_dtype``.  ``edge_grad``: the
    clamp's gradient at exactly |dy| = max_dy.  Every sum runs in a fixed
    order: two calls on the same inputs give the same bits."""
    _check_x("dcn_v2_backward", x)
    b, h, w, cin = x.shape
    cout = weight.shape[-1]
    dev, dt = x.device, x.dtype
    odt = offset.dtype
    if odt not in (torch.float32, dt):
        raise TypeError(f"offset: dtype {odt} (float32 or {dt})")
    _check("x", x, (b, h, w, cin), dt, dev)
    _check("offset", offset, (b, h, w, 18), odt, dev)
    _check("mask", mask, (b, h, w, 9), odt, dev)
    _check("weight", weight, (3, 3, cin, cout), dt, dev)
    _check("ct", ct, (b, h, w, cout), dt, dev)
    lib = _library("bwd")
    plan = backward_plan(dt, odt, b, h, w, cin, cout)
    if plan["smem"] > _SMEM_LIMIT:
        raise ValueError(f"dcn_v2_backward: Cout {cout} needs {plan['smem']} "
                         f"bytes of shared memory (at most {_SMEM_LIMIT})")
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((b, h, w, cin), dtype=dt if dx_in_x_dtype else
                     torch.float32, device=dev)
    doff = torch.empty((b, h, w, 18), **f32)
    dmask = torch.empty((b, h, w, 9), **f32)
    dw = torch.empty((3, 3, cin, cout), **f32)
    dbias = torch.empty((cout,), **f32)
    ws = torch.empty((plan["workspace"],), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        rc = lib.cp_dcn_v2_backward(
            _DTYPE_CODE[dt], _DTYPE_CODE[odt], x.data_ptr(),
            offset.data_ptr(), mask.data_ptr(), weight.data_ptr(),
            ct.data_ptr(), dx.data_ptr(), int(dx_in_x_dtype),
            doff.data_ptr(), dmask.data_ptr(),
            dw.data_ptr(), dbias.data_ptr(), ws.data_ptr(), b, h, w, cin,
            cout, _radius(max_dy), float(edge_grad), _stream(dev))
    _raise_on(rc, "dcn_v2_backward", x, cout)
    dcn_v2_backward.launches += 1
    dcn_v2_backward.launches_by_site[_site(x, cout)] += 1
    return dx, doff, dmask, dw, dbias


def dcn_v2_backward(x, offset, mask, weight, ct, max_dy, edge_grad=1.0):
    """The backward kernel's function: gradients of ``dcn_v2`` at x,
    offset, mask, weight and bias for the cotangent ``ct``, each cast as
    the reference's ``_dcn_pallas_grouped_bwd_impl`` casts it (dx to x's
    dtype, doffset and dmask to theirs, dW to the weight's, dbias f32).
    ``edge_grad``: the clamp's gradient at exactly |dy| = max_dy
    (``train_site_edge_grad``).  A CPU tensor takes the plain version
    (autograd of ``ops/dcn.dcn_v2``); a CUDA tensor launches the kernel or
    raises."""
    if x.device.type == "cpu":
        return dcn_v2_backward_plain(x, offset, mask, weight, ct, max_dy,
                                     edge_grad)
    ct = ct.to(x.dtype).contiguous()
    dx, doff, dmask, dw, dbias = launch_backward(x, offset, mask, weight, ct,
                                                 max_dy, edge_grad, True)
    return (dx, doff.to(offset.dtype), dmask.to(mask.dtype),
            dw.to(weight.dtype), dbias)


class _DcnV2(torch.autograd.Function):
    """K2 forward, backward kernel backward (``dcn_v2_pallas``'s VJP with
    ``kernel_bwd=True``)."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias, max_dy, edge_grad):
        ctx.max_dy = max_dy
        ctx.edge_grad = edge_grad
        ctx.has_bias = bias is not None
        ctx.save_for_backward(x, offset, mask, weight)
        return launch_forward(x, offset, mask, weight, bias, max_dy)

    @staticmethod
    def backward(ctx, gy):
        x, offset, mask, weight = ctx.saved_tensors
        dx, doff, dmask, dw, dbias = dcn_v2_backward(
            x, offset, mask, weight, gy, ctx.max_dy, ctx.edge_grad)
        return (dx, doff, dmask, dw, dbias if ctx.has_bias else None, None,
                None)


def dcn_v2(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
           weight: torch.Tensor, bias: Optional[torch.Tensor],
           max_dy: Optional[float], edge_grad: float = 1.0) -> torch.Tensor:
    """DCNv2 forward from explicit offsets (K2), differentiable.  x
    [B,H,W,Cin] NHWC, offset [B,H,W,18] (dy, dx per tap), mask [B,H,W,9]
    (sigmoid-ed), weight [3,3,Cin,Cout], bias [Cout] or None; ``max_dy`` is
    the site's clamp radius or None (unclamped), ``edge_grad`` the clamp's
    gradient at exactly |dy| = max_dy.  -> [B,H,W,Cout] in x's dtype.

    A CPU tensor takes the plain version (``ops/dcn.dcn_v2``); a CUDA
    tensor launches the kernel (x, offset, mask and weight float32 or
    bfloat16, all one dtype; bias float32; all contiguous) or raises, and
    its gradient launches the backward kernel."""
    if x.device.type == "cpu":
        return dcn_v2_plain(x, offset, mask, weight, bias, max_dy, edge_grad)
    return _DcnV2.apply(x, offset, mask, weight, bias, max_dy, edge_grad)


def _fused_plain_om(x, omw, omb, weight, bias, max_dy, edge_grad):
    """The plain version of K1 with K1's two outputs: y, and om [B,H,W,27]
    f32 (the raw offsets, then the sigmoid-ed mask)."""
    offset, mask = offset_mask(x, omw, omb)
    y = dcn_v2_plain(x, offset, mask, weight, bias, max_dy, edge_grad)
    return y, torch.cat([offset, mask], -1)


@torch.library.custom_op("centerpose::dcn_v2_fused", mutates_args=(),
                         device_types="cpu")
def dcn_v2_fused_op(x: torch.Tensor, omw: torch.Tensor, omb: torch.Tensor,
                    weight: torch.Tensor, bias: Optional[torch.Tensor],
                    max_dy: Optional[float], edge_grad: float
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 as one operator, ``centerpose::dcn_v2_fused``: -> (y, om), as
    ``launch_fused_forward``.  The CPU implementation is the plain version;
    the CUDA one launches the kernel (and counts the launch, also in a
    replay of an exported or compiled program)."""
    return _fused_plain_om(x, omw, omb, weight, bias, max_dy, edge_grad)


@dcn_v2_fused_op.register_kernel("cuda")
def _(x, omw, omb, weight, bias, max_dy, edge_grad):
    return launch_fused_forward(x, omw, omb, weight, bias, max_dy)


@dcn_v2_fused_op.register_fake
def _(x, omw, omb, weight, bias, max_dy, edge_grad):
    b, h, w, _ = x.shape
    return (x.new_empty((b, h, w, weight.shape[-1])),
            x.new_empty((b, h, w, 27), dtype=torch.float32))


def _fused_setup(ctx, inputs, output):
    x, omw, omb, weight, bias, max_dy, edge_grad = inputs
    ctx.max_dy, ctx.edge_grad = max_dy, edge_grad
    ctx.has_bias = bias is not None
    ctx.save_for_backward(x, omw, omb, weight, output[1])


def _fused_backward(ctx, gy, _):
    """As the reference's ``_fused_bwd`` on a CUDA tensor: the backward
    kernel on the om the forward wrote (never replayed), dmask chained
    through the sigmoid, then the om conv's VJP in f32.  On the CPU:
    autograd of the plain version."""
    x, omw, omb, weight, om = ctx.saved_tensors
    if x.device.type == "cpu":
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_()
                      for t in (x, omw, omb, weight)]
            bias = torch.zeros(weight.shape[-1], requires_grad=True)
            y = dcn_v2_fused_plain(*leaves, bias, ctx.max_dy, ctx.edge_grad)
            dx, domw, domb, dw, dbias = torch.autograd.grad(
                y, [*leaves, bias], gy.to(y.dtype))
    else:
        offset = om[..., :18].contiguous()
        mask = om[..., 18:].contiguous()  # K1 stores the sigmoid-ed mask
        dx, doff, dmask, dw, dbias = launch_backward(
            x, offset, mask, weight, gy.to(x.dtype).contiguous(),
            ctx.max_dy, ctx.edge_grad)
        dom = torch.cat([doff, dmask * mask * (1.0 - mask)], -1)
        dom = dom.permute(0, 3, 1, 2)  # NCHW view
        x32 = x.float().permute(0, 3, 1, 2)
        omw32 = omw.float().permute(3, 2, 0, 1)  # [27, Cin, 3, 3]
        dx_om = torch.nn.grad.conv2d_input(x32.shape, omw32, dom, padding=1)
        domw = torch.nn.grad.conv2d_weight(x32, omw32.shape, dom,
                                           padding=1).permute(2, 3, 1, 0)
        domb = dom.sum((0, 2, 3))
        dx = dx + dx_om.permute(0, 2, 3, 1)
    return (dx.to(x.dtype), domw.to(omw.dtype), domb.to(omb.dtype),
            dw.to(weight.dtype), dbias if ctx.has_bias else None, None, None)


dcn_v2_fused_op.register_autograd(_fused_backward, setup_context=_fused_setup)


@register_flop_formula(torch.ops.centerpose.dcn_v2_fused)
def _fused_flops(x_shape, omw_shape, omb_shape, weight_shape, *args,
                 **kwargs) -> int:
    """The om conv and the product: 2 B H W 9 Cin (Cout + 27)."""
    b, h, w, cin = x_shape
    return 2 * b * h * w * 9 * cin * (weight_shape[-1] + 27)


def dcn_v2_fused(x: torch.Tensor, omw: torch.Tensor, omb: torch.Tensor,
                 weight: torch.Tensor, bias: Optional[torch.Tensor],
                 max_dy: Optional[float],
                 edge_grad: float = 1.0) -> torch.Tensor:
    """Om-fused DCNv2 forward (K1), differentiable.  x [B,H,W,Cin] NHWC,
    omw [3,3,Cin,27], omb [27], weight [3,3,Cin,Cout], bias [Cout] or None;
    ``max_dy`` is the site's clamp radius or None (unclamped), ``edge_grad``
    the clamp's gradient at exactly |dy| = max_dy in the backward.  ->
    [B,H,W,Cout] in x's dtype.

    It calls the operator ``centerpose::dcn_v2_fused`` (``torch.export``
    and ``torch.compile`` keep it as one node), except on the CPU with
    gradients on, where the plain version is differentiated by autograd.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (x, omw, omb and weight float32 or bfloat16, all one dtype; bias
    float32, added before the output's rounding as the reference does;
    all contiguous) or raises, and its gradient launches the backward
    kernel."""
    if x.device.type == "cpu" and torch.is_grad_enabled():
        return dcn_v2_fused_plain(x, omw, omb, weight, bias, max_dy,
                                  edge_grad)
    return dcn_v2_fused_op(x, omw, omb, weight, bias,
                           None if max_dy is None else float(max_dy),
                           float(edge_grad))[0]


# Launch counts of the kernels: a successful launch adds to its wrapper's
# count (KERNELS_PER_CALL[dtype] for a K1 call: one in bf16, two in
# float32; one for a K2 call; one for a backward call), nothing else does.
# Callers reset them with ``reset_launch_counts``.
COUNTED = (dcn_v2_fused, dcn_v2, dcn_v2_backward)
for _fn in COUNTED:
    _fn.launches = 0
    _fn.launches_by_site = collections.Counter()


def reset_launch_counts() -> None:
    for fn in COUNTED:
        fn.launches = 0
        fn.launches_by_site.clear()
