"""Peaks of the card and the least time a DCN kernel call can take.

Frozen copies of the port's ``chip_smoke.py`` arithmetic (``HBM_BPS``,
``PEAK_FLOPS``, ``k1_bound``, ``train_bounds``) at the commit that defined
the benchmark: each input is read once and each output written once, in
its dtype, and the products run at the published dense peak of the type.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the
700 W power limit): 989 TFLOP/s in bf16, 67 TFLOP/s in float32 outside
the tensor cores, 3.35 TB/s of HBM.
"""

from __future__ import annotations

from typing import List, Tuple

HBM_BPS = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def _elem(dtype: str) -> int:
    return 4 if dtype == "float32" else 2


def _bound_ms(nbytes: float, flops: float, dtype: str) -> Tuple[float, str]:
    t_bytes = nbytes / HBM_BPS
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def k1_bound(b: int, hw: int, cin: int, cout: int,
             dtype: str) -> Tuple[float, str]:
    """(bound ms, 'bytes' | 'operations') of one K1 call (the om-fused
    forward): x, the om and main weights and biases read once, y written
    once; the main product and the om conv at the peak of the type."""
    elem = _elem(dtype)
    npix = b * hw * hw
    nbytes = elem * (npix * cin + 9 * cin * cout + cout + 9 * cin * 27 + 27
                     + npix * cout)
    flops = 2.0 * npix * 9 * cin * (cout + 27)
    return _bound_ms(nbytes, flops, dtype)


def train_bounds(b: int, hw: int, cin: int, cout: int,
                 dtype: str) -> List[Tuple[float, str]]:
    """[(bound ms, by) of one K2 call, (bound ms, by) of one backward
    call]: inputs read once and outputs written once in their dtypes (the
    backward reads x, offset, mask, weight and the cotangent, writes dx,
    doffset, dmask, dW and an f32 dbias); forward 2 P 9 Cin Cout
    operations, backward twice that."""
    elem = _elem(dtype)
    npix = b * hw * hw
    prod = 2.0 * npix * 9 * cin * cout
    fwd_bytes = elem * (npix * (cin + 18 + 9 + cout) + 9 * cin * cout) \
        + 4 * cout
    bwd_bytes = (elem * (2 * npix * (cin + 18 + 9) + 2 * 9 * cin * cout
                         + npix * cout) + 4 * cout)
    return [_bound_ms(fwd_bytes, prod, dtype),
            _bound_ms(bwd_bytes, 2 * prod, dtype)]
