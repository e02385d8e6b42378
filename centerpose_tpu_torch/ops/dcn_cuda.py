"""DCNv2 site policy and the Hopper kernels: the om-fused forward (K1), the
forward from explicit offsets (K2) and the backward (K3, K4, K5 in one).

Counterpart of ``centerpose_tpu/ops/dcn_pallas.py``.  Three parts:

* **Site policy.**  The JAX package decides per DCN site, from its shape and
  a TPU VMEM estimate, whether the fused Pallas kernels run it, and at what
  y-clamp radius R (``resolve_max_dy``, ``pallas_supported``,
  ``fused_om_supported``).  A site the kernels take computes DCNv2 with dy
  clipped to +-R; a site they refuse falls back to the unclamped XLA op.
  So the function a site computes depends on that arithmetic, and the
  flagship snapshot was trained under it.  This module keeps its own copy
  of the arithmetic, so that the port computes the same function at every
  site: ``site_max_dy`` at inference, ``train_site_max_dy`` in training.
  It is a statement about the reference, not about H100 limits.
* **Kernels.**  ``csrc/dcn_fused.cu`` holds K1 (offset/mask conv +
  clamped bilinear gather + GEMM) and K2 (its product kernel on explicit
  offsets and mask); ``csrc/dcn_bwd.cu`` the backward of both.  Each source
  is built with ``nvcc`` at first use into a library of its own in
  ``centerpose_tpu_torch/build/`` (one ``nvcc`` per source, all started
  together), keyed by a hash of the source and flags, and loaded with
  ``ctypes``.
* **Autograd.**  ``dcn_v2_fused`` (K1) and ``dcn_v2`` (K2) are
  ``torch.autograd.Function``s on a CUDA tensor, with the backward kernel
  as their backward (the reference's ``_fused_fwd``/``_fused_bwd`` and
  ``_fwd``/``_bwd``/``_bwd_core``).  A CPU tensor takes the plain version
  (``ops/dcn.py``), differentiated by autograd; a CUDA tensor launches the
  kernel or raises.
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

from centerpose_tpu_torch.ops.dcn import dcn_v2 as dcn_v2_plain
from centerpose_tpu_torch.ops.dcn import (dcn_v2_backward_plain,
                                          dcn_v2_fused_plain)

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
KERNELS_PER_CALL = 2  # __global__ launches of one K1 call (om conv, product)
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


def library_path(name: str) -> Path:
    """Where the library built from source ``name`` lives: the file name
    carries a hash of the source and flags, so an edited source is
    rebuilt."""
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    h.update(_SOURCES[name].read_bytes())
    return BUILD_DIR / f"libcp_dcn_{name}_{h.hexdigest()[:16]}.so"


def build_library() -> dict:
    """Compile every kernel source whose hashed library is missing, one
    ``nvcc`` per source, all started together; returns {name: path}.  The
    compiler's report (registers, shared memory, spills) is kept beside
    each library as ``.log``."""
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
        todo[name].with_suffix(".log").write_text(out + err)
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
                [i32] + [ptr] * 7 + [i32] * 5 + [f32, ptr])
            fwd.cp_dcn_v2_forward.argtypes = (
                [i32] + [ptr] * 6 + [i32] * 5 + [f32, ptr])
            bwd = ctypes.CDLL(str(paths["bwd"]))
            bwd.cp_dcn_v2_backward.argtypes = (
                [i32, i32, ptr, ptr, i32, ptr, i32, ptr, ptr] + [ptr] * 5
                + [i32] * 5 + [f32, ptr])
            bwd.cp_dcn_v2_backward_smem.argtypes = [i32, i32]
            for fn in (fwd.cp_dcn_v2_fused_forward, fwd.cp_dcn_v2_forward,
                       bwd.cp_dcn_v2_backward, bwd.cp_dcn_v2_backward_smem):
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
    om = torch.empty((b, h, w, 27), dtype=torch.float32, device=dev)
    y = torch.empty((b, h, w, cout), dtype=dt, device=dev)
    with torch.cuda.device(dev):
        rc = lib.cp_dcn_v2_fused_forward(
            _DTYPE_CODE[dt], x.data_ptr(), omw.data_ptr(), omb.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), om.data_ptr(), y.data_ptr(),
            b, h, w, cin, cout, _radius(max_dy), _stream(dev))
    _raise_on(rc, "dcn_v2_fused", x, cout)
    dcn_v2_fused.launches += KERNELS_PER_CALL
    dcn_v2_fused.launches_by_site[_site(x, cout)] += KERNELS_PER_CALL
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
    y = torch.empty((b, h, w, cout), dtype=dt, device=dev)
    with torch.cuda.device(dev):
        rc = lib.cp_dcn_v2_forward(
            _DTYPE_CODE[dt], x.data_ptr(), offset.data_ptr(),
            mask.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            y.data_ptr(), b, h, w, cin, cout, _radius(max_dy), _stream(dev))
    _raise_on(rc, "dcn_v2", x, cout)
    dcn_v2.launches += 1
    dcn_v2.launches_by_site[_site(x, cout)] += 1
    return y


def launch_backward(x, offset, mask, weight, ct, max_dy):
    """One backward call (the function of K3, K4 and K5): x and weight in
    one dtype, offset [B,H,W,18] and mask [B,H,W,9] (sigmoid-ed) float32 or
    x's dtype, cotangent ct [B,H,W,Cout] -> f32 (dx, doffset, dmask, dW,
    dbias).  dx, dW and dbias are summed with atomics, in an order that
    varies from run to run."""
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
    smem = lib.cp_dcn_v2_backward_smem(_DTYPE_CODE[dt], cout)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"dcn_v2_backward: Cout {cout} needs {smem} bytes "
                         f"of shared memory (at most {_SMEM_LIMIT})")
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.zeros((b, h, w, cin), **f32)
    doff = torch.empty((b, h, w, 18), **f32)
    dmask = torch.empty((b, h, w, 9), **f32)
    dw = torch.zeros((3, 3, cin, cout), **f32)
    dbias = torch.zeros((cout,), **f32)
    with torch.cuda.device(dev):
        rc = lib.cp_dcn_v2_backward(
            _DTYPE_CODE[dt], _DTYPE_CODE[odt], x.data_ptr(),
            offset.data_ptr(), 18, mask.data_ptr(), 9, weight.data_ptr(),
            ct.data_ptr(), dx.data_ptr(), doff.data_ptr(), dmask.data_ptr(),
            dw.data_ptr(), dbias.data_ptr(), b, h, w, cin, cout,
            _radius(max_dy), _stream(dev))
    _raise_on(rc, "dcn_v2_backward", x, cout)
    dcn_v2_backward.launches += 1
    dcn_v2_backward.launches_by_site[_site(x, cout)] += 1
    return dx, doff, dmask, dw, dbias


def dcn_v2_backward(x, offset, mask, weight, ct, max_dy):
    """The backward kernel's function: gradients of ``dcn_v2`` at x,
    offset, mask, weight and bias for the cotangent ``ct``, each cast as
    the reference's ``_dcn_pallas_grouped_bwd_impl`` casts it (dx to x's
    dtype, doffset and dmask to theirs, dW to the weight's, dbias f32).
    A CPU tensor takes the plain version (autograd of ``ops/dcn.dcn_v2``);
    a CUDA tensor launches the kernel or raises."""
    if x.device.type == "cpu":
        return dcn_v2_backward_plain(x, offset, mask, weight, ct, max_dy)
    ct = ct.to(x.dtype).contiguous()
    dx, doff, dmask, dw, dbias = launch_backward(x, offset, mask, weight, ct,
                                                 max_dy)
    return (dx.to(x.dtype), doff.to(offset.dtype), dmask.to(mask.dtype),
            dw.to(weight.dtype), dbias)


class _DcnV2(torch.autograd.Function):
    """K2 forward, backward kernel backward (``dcn_v2_pallas``'s VJP with
    ``kernel_bwd=True``)."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias, max_dy):
        ctx.max_dy = max_dy
        ctx.has_bias = bias is not None
        ctx.save_for_backward(x, offset, mask, weight)
        return launch_forward(x, offset, mask, weight, bias, max_dy)

    @staticmethod
    def backward(ctx, gy):
        x, offset, mask, weight = ctx.saved_tensors
        dx, doff, dmask, dw, dbias = dcn_v2_backward(
            x, offset, mask, weight, gy, ctx.max_dy)
        return (dx, doff, dmask, dw, dbias if ctx.has_bias else None, None)


def dcn_v2(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
           weight: torch.Tensor, bias: Optional[torch.Tensor],
           max_dy: Optional[float]) -> torch.Tensor:
    """DCNv2 forward from explicit offsets (K2), differentiable.  x
    [B,H,W,Cin] NHWC, offset [B,H,W,18] (dy, dx per tap), mask [B,H,W,9]
    (sigmoid-ed), weight [3,3,Cin,Cout], bias [Cout] or None; ``max_dy`` is
    the site's clamp radius or None (unclamped).  -> [B,H,W,Cout] in x's
    dtype.

    A CPU tensor takes the plain version (``ops/dcn.dcn_v2``); a CUDA
    tensor launches the kernel (x, offset, mask and weight float32 or
    bfloat16, all one dtype; bias float32; all contiguous) or raises, and
    its gradient launches the backward kernel."""
    if x.device.type == "cpu":
        return dcn_v2_plain(x, offset, mask, weight, bias, max_dy)
    return _DcnV2.apply(x, offset, mask, weight, bias, max_dy)


class _DcnV2Fused(torch.autograd.Function):
    """K1 forward; backward as the reference's ``_fused_bwd``: the backward
    kernel on the om the forward wrote (never replayed), dmask chained
    through the sigmoid, then the om conv's VJP in f32."""

    @staticmethod
    def forward(ctx, x, omw, omb, weight, bias, max_dy):
        y, om = launch_fused_forward(x, omw, omb, weight, bias, max_dy)
        ctx.max_dy = max_dy
        ctx.has_bias = bias is not None
        ctx.save_for_backward(x, omw, omb, weight, om)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, omw, omb, weight, om = ctx.saved_tensors
        offset = om[..., :18].contiguous()
        mask = om[..., 18:].contiguous()  # K1 stores the sigmoid-ed mask
        dx, doff, dmask, dw, dbias = launch_backward(
            x, offset, mask, weight, gy.to(x.dtype).contiguous(), ctx.max_dy)
        dom = torch.cat([doff, dmask * mask * (1.0 - mask)], -1)
        dom = dom.permute(0, 3, 1, 2)  # NCHW view
        x32 = x.float().permute(0, 3, 1, 2)
        omw32 = omw.float().permute(3, 2, 0, 1)  # [27, Cin, 3, 3]
        dx_om = torch.nn.grad.conv2d_input(x32.shape, omw32, dom, padding=1)
        domw = torch.nn.grad.conv2d_weight(x32, omw32.shape, dom, padding=1)
        dx = dx + dx_om.permute(0, 2, 3, 1)
        return (dx.to(x.dtype), domw.permute(2, 3, 1, 0).to(omw.dtype),
                dom.sum((0, 2, 3)).to(omb.dtype), dw.to(weight.dtype),
                dbias if ctx.has_bias else None, None)


def dcn_v2_fused(x: torch.Tensor, omw: torch.Tensor, omb: torch.Tensor,
                 weight: torch.Tensor, bias: Optional[torch.Tensor],
                 max_dy: Optional[float]) -> torch.Tensor:
    """Om-fused DCNv2 forward (K1), differentiable.  x [B,H,W,Cin] NHWC,
    omw [3,3,Cin,27], omb [27], weight [3,3,Cin,Cout], bias [Cout] or None;
    ``max_dy`` is the site's clamp radius or None (unclamped).  ->
    [B,H,W,Cout] in x's dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (x, omw, omb and weight float32 or bfloat16, all one dtype; bias
    float32, added before the output's rounding as the reference does;
    all contiguous) or raises, and its gradient launches the backward
    kernel."""
    if x.device.type == "cpu":
        return dcn_v2_fused_plain(x, omw, omb, weight, bias, max_dy)
    return _DcnV2Fused.apply(x, omw, omb, weight, bias, max_dy)


# Launch counts of the kernels: a successful launch adds to its wrapper's
# count (KERNELS_PER_CALL for a K1 call: the om conv, then the product; one
# for a K2 call; one for a backward call), nothing else does.  Callers reset
# them with ``reset_launch_counts``.
COUNTED = (dcn_v2_fused, dcn_v2, dcn_v2_backward)
for _fn in COUNTED:
    _fn.launches = 0
    _fn.launches_by_site = collections.Counter()


def reset_launch_counts() -> None:
    for fn in COUNTED:
        fn.launches = 0
        fn.launches_by_site.clear()
