"""The CUDA kernel against its plain version, on the card.

These tests need a CUDA device and nvcc; elsewhere they skip.  On the card
(JAX is not needed, so the JAX test configuration is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from centerpose_tpu_torch.ops import dcn_cuda as dc
from centerpose_tpu_torch.ops.dcn import dcn_v2_fused_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card, see module doc)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _args(seed, b, h, w, cin, cout, dtype, dev, om_scale=8.0):
    r = np.random.default_rng(seed)
    arrs = (r.normal(size=(b, h, w, cin)),
            r.normal(size=(3, 3, cin, 27)) * om_scale / np.sqrt(9 * cin),
            r.normal(size=(27,)),
            r.normal(size=(3, 3, cin, cout)) / np.sqrt(9 * cin),
            r.normal(size=(cout,)))
    # the bias stays float32 (the kernel adds it before the output rounding)
    return [torch.tensor(a, dtype=dtype if i < 4 else torch.float32,
                         device=dev) for i, a in enumerate(arrs)]


# ragged shapes: pixels not a multiple of the 64-pixel tile, Cin not a
# multiple of the 32-channel slice, Cout not a multiple of the 64 tile
@pytest.mark.parametrize("b,h,w,cin,cout,r", [
    (1, 5, 7, 3, 5, None), (2, 9, 13, 40, 70, 2.0), (1, 16, 16, 512, 256, 24),
    (2, 32, 48, 96, 130, 0.5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_matches_plain(cuda, b, h, w, cin, cout, r, dtype):
    args = _args(cin + cout, b, h, w, cin, cout, dtype, cuda)
    dc.reset_launch_counts()
    got = dc.dcn_v2_fused(*args, r)
    assert dc.dcn_v2_fused.launches == dc.KERNELS_PER_CALL
    ref = dcn_v2_fused_plain(*args, r)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b, h, w, cout)
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    # f32: summation order only; bf16: the final rounding (an ulp or two)
    assert err <= (1e-4 if dtype == torch.float32 else 1e-2) * scale


def test_k1_rejects_bad_operands(cuda):
    args = _args(0, 1, 8, 8, 16, 16, torch.float32, cuda)
    with pytest.raises(TypeError):
        dc.dcn_v2_fused(args[0].half(), *[a.half() for a in args[1:]], None)
    with pytest.raises(TypeError):
        dc.dcn_v2_fused(args[0], args[1].bfloat16(), *args[2:], None)
    with pytest.raises(TypeError):
        dc.dcn_v2_fused(*args[:4], args[4].bfloat16(), None)
    with pytest.raises(ValueError):
        dc.dcn_v2_fused(args[0].permute(0, 2, 1, 3), *args[1:], None)
    with pytest.raises(ValueError):
        dc.dcn_v2_fused(args[0], args[1][:, :, :8], *args[2:], None)
