"""Modulated deformable convolution v2 (DCNv2), plain PyTorch.

Counterpart of ``centerpose_tpu/ops/dcn.py``: the bilinear gather + im2col
GEMM formulation, written with tensor ops only.  It is the reference the
hand-written CUDA kernel (``ops/dcn_cuda.py``) is held against, and the path
every DCN site takes for a tensor on the CPU.

Layouts are the JAX op's: NHWC activations, weight ``[3, 3, Cin, Cout]``,
offset ``[B, H, W, 18]`` with (dy, dx) interleaved per tap, mask
``[B, H, W, 9]`` already passed through the sigmoid.  Only the DLA-34
configuration is supported: 3x3 kernel, stride 1, padding 1, dilation 1, one
deformable group.

Arithmetic runs in float32 whatever the input type (bf16 values are exact in
f32); the gathered samples are rounded to the input type before the
product, as the reference's im2col GEMM takes them, and the result is cast
back to the input type.  The kernel does the same, so the two differ in
summation order and in where that order moves a rounding.

``dcn_v2`` is also the plain version of the training forward (K2), and its
autograd the plain version of the backward kernel.  The backward runs in
f32 as the kernels' does: the samples' rounding passes the gradient
through unrounded, and the gradients of x, offsets, mask and weight are
summed in f32 and cast to their input's type once.  The y-clamp passes the
full gradient where -R <= dy <= R, inclusive, and none outside, as the
reference kernels' ``clamp_pass`` does (``torch.clamp``'s gradient; JAX's
``jnp.clip`` gives 0.5 at exactly +-R).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

# Tap offsets of a 3x3 kernel, row-major over (ky, kx).
_KY = (-1, -1, -1, 0, 0, 0, 1, 1, 1)
_KX = (-1, 0, 1, -1, 0, 1, -1, 0, 1)


def clamp_dy(offset: torch.Tensor, max_dy: Optional[float]) -> torch.Tensor:
    """Clip the y component of every tap offset to [-max_dy, max_dy]
    (``None``: unchanged).  The semantics of ``_xla_fwd_clamped`` in the
    JAX package: the per-site clamp of the fused TPU kernels."""
    if max_dy is None:
        return offset
    off = offset.reshape(*offset.shape[:-1], 9, 2)
    dy = off[..., 0].clamp(-float(max_dy), float(max_dy))
    return torch.stack([dy, off[..., 1]], -1).reshape(offset.shape)


def dcn_v2(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
           weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
           max_dy: Optional[float] = None) -> torch.Tensor:
    """x [B,H,W,Cin], offset [B,H,W,18], mask [B,H,W,9], weight
    [3,3,Cin,Cout] -> [B,H,W,Cout].  ``max_dy`` clips dy before sampling."""
    b, h, w, cin = x.shape
    kh, kw, wcin, cout = weight.shape
    if (kh, kw) != (3, 3) or wcin != cin:
        raise ValueError(f"weight {tuple(weight.shape)} for x {tuple(x.shape)}")
    if offset.shape != (b, h, w, 18) or mask.shape != (b, h, w, 9):
        raise ValueError(f"offset {tuple(offset.shape)} / mask "
                         f"{tuple(mask.shape)} for x {tuple(x.shape)}")
    dev, f32 = x.device, torch.float32
    off = clamp_dy(offset.to(f32), max_dy).reshape(b, h, w, 9, 2)
    m = mask.to(f32)
    ky = torch.tensor(_KY, dtype=f32, device=dev)
    kx = torch.tensor(_KX, dtype=f32, device=dev)
    oy = torch.arange(h, dtype=f32, device=dev)[:, None, None]
    ox = torch.arange(w, dtype=f32, device=dev)[None, :, None]
    sy = (oy + ky) + off[..., 0]  # [B, H, W, 9]
    sx = (ox + kx) + off[..., 1]
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    wy1 = sy - y0
    wx1 = sx - x0
    x_flat = x.reshape(b, h * w, cin).to(f32)
    samples = None
    for cy, cx, wgt in ((0, 0, (1 - wy1) * (1 - wx1)), (0, 1, (1 - wy1) * wx1),
                        (1, 0, wy1 * (1 - wx1)), (1, 1, wy1 * wx1)):
        yc = y0 + cy
        xc = x0 + cx
        valid = (yc >= 0) & (yc <= h - 1) & (xc >= 0) & (xc <= w - 1)
        idx = (yc.clamp(0, h - 1) * w + xc.clamp(0, w - 1)).long()
        idx = idx.reshape(b, h * w * 9, 1).expand(-1, -1, cin)
        gathered = torch.gather(x_flat, 1, idx)  # [B, HW9, Cin]
        wfull = (wgt * valid.to(f32) * m).reshape(b, h * w * 9, 1)
        term = gathered * wfull
        samples = term if samples is None else samples + term
    cols = samples.reshape(b * h * w, 9 * cin)
    # rounded to the input type in value, unrounded in the gradient
    cols = cols + (cols.detach().to(x.dtype).to(f32) - cols.detach())
    out = cols @ weight.to(f32).reshape(9 * cin, cout)
    if bias is not None:
        out = out + bias.to(f32)
    return out.reshape(b, h, w, cout).to(x.dtype)


def dcn_v2_backward_plain(x: torch.Tensor, offset: torch.Tensor,
                          mask: torch.Tensor, weight: torch.Tensor,
                          ct: torch.Tensor, max_dy: Optional[float]):
    """Plain version of the backward kernel: the gradients of ``dcn_v2`` at
    (x, offset, mask, weight, bias) for the cotangent ``ct`` [B,H,W,Cout],
    by autograd, each in its input's dtype (dbias float32)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, offset, mask,
                                                        weight)]
        bias = torch.zeros(weight.shape[-1], device=x.device,
                           requires_grad=True)
        y = dcn_v2(*leaves, bias, max_dy)
        return torch.autograd.grad(y, [*leaves, bias], ct.to(y.dtype))


def offset_mask(x: torch.Tensor, omw: torch.Tensor,
                omb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The DCN module's ``conv_offset_mask``: om = conv3x3(x; omw) + omb in
    f32, split into offsets [B,H,W,18] and sigmoid-ed mask [B,H,W,9]."""
    f32 = torch.float32
    om = F.conv2d(x.to(f32).permute(0, 3, 1, 2), omw.to(f32).permute(3, 2, 0, 1),
                  omb.to(f32), padding=1).permute(0, 2, 3, 1)
    return om[..., :18], torch.sigmoid(om[..., 18:])


def dcn_v2_fused_plain(x: torch.Tensor, omw: torch.Tensor, omb: torch.Tensor,
                       weight: torch.Tensor, bias: Optional[torch.Tensor],
                       max_dy: Optional[float]) -> torch.Tensor:
    """Plain version of the om-fused forward (K1): the offset/mask conv,
    then the y-clamped ``dcn_v2``.  The function ``dcn_v2_pallas_fused``
    computes in the JAX package."""
    offset, mask = offset_mask(x, omw, omb)
    return dcn_v2(x, offset, mask, weight, bias, max_dy)
