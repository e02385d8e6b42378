"""The port's ``tools/offsets_hist.py`` against the reference model.

The reference's own tool reads the output of ``conv_offset_mask``, which is
now a parameter holder (``centerpose_tpu/models/dla.py: _OffsetMaskParams``
returns its kernel and bias), so it cannot produce the offsets.  Here the
reference's offsets are computed as its explicit DCN path computes them:
each DCN module's input, read with ``flax.linen.intercept_methods``, through
the site's ``conv_offset_mask`` kernel and bias.  dla_34 from the snapshot
at 128x128 in float32 on 2 images of the synthetic val split."""

from __future__ import annotations

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centerpose_tpu_torch.data.synthetic import SyntheticEvalDataset
from centerpose_tpu_torch.inference.detector import Detector
from centerpose_tpu_torch.tools import offsets_hist

from _torch_port import release_compiled, release_resources  # noqa: F401
from _torch_port import NPZ, jax_cfg, jax_variables, rel_err

SMALL = ["model.input_res", "128", "model.output_res", "32",
         "model.compute_dtype", "float32"]
RECORDED = (Path(__file__).resolve().parent.parent / "output"
            / "offsets_hist.json")
# Both forwards sum the same float32 products in another order at every
# conv; the offsets of the deepest sites read ~1e-6 of their largest
# magnitude apart, and a wrong site, tap or channel is off by its own size.
TOL_OFFSETS = 1e-4


@pytest.fixture(scope="module")
def images():
    cfg = offsets_hist.tool_config("pallas_full", SMALL)
    return offsets_hist.encode_images(cfg, SyntheticEvalDataset(2, seed=2))


def _om(x, kernel, bias):
    """The reference's offset/mask conv (its explicit DCN path): NHWC x,
    HWIO kernel, 'SAME' 3x3."""
    from jax import lax

    om = lax.conv_general_dilated(
        x, jnp.asarray(kernel), (1, 1), [(1, 1)] * 2,
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    return om + jnp.asarray(bias)


def _fused_plain(x, omw, omb, weight, bias=None, stride=1, padding=1,
                 dilation=1, deformable_groups=1, kernel_bwd=False, max_dy=0,
                 chsec_in=False, chsec_out=False):
    """``dcn_v2_pallas_fused`` through the reference's plain f32 version of
    its kernels: the om conv, then ``_xla_fwd_clamped`` at the radius the
    kernel resolves."""
    from centerpose_tpu.ops import dcn_pallas as dp

    if chsec_in:
        x = jnp.transpose(x, (0, 1, 3, 2))
    om = _om(x.astype(jnp.float32), omw.astype(jnp.float32),
             omb.astype(jnp.float32))
    b, h, w, cin = x.shape
    md = dp.resolve_max_dy(h, w, cin, weight.shape[-1], max_dy)
    y = dp._xla_fwd_clamped(x, om[..., :18], jax.nn.sigmoid(om[..., 18:]),
                            weight, bias, stride=1, padding=1, dilation=1,
                            g=1, max_dy=md)
    return jnp.transpose(y, (0, 1, 3, 2)) if chsec_out else y


def _explicit_plain(x, offset, mask, weight, bias=None, stride=1, padding=1,
                    dilation=1, deformable_groups=1, kernel_bwd=False,
                    max_dy=0):
    """``dcn_v2_pallas`` through ``_xla_fwd_clamped``, likewise."""
    from centerpose_tpu.ops import dcn_pallas as dp

    b, h, w, cin = x.shape
    md = dp.resolve_max_dy(h, w, cin, weight.shape[-1], max_dy)
    return dp._xla_fwd_clamped(x, offset, mask, weight, bias, stride=1,
                               padding=1, dilation=1, g=1, max_dy=md)


@pytest.fixture(scope="module")
def reference_offsets(images, monkeypatch_module):
    """{impl: {site path: offsets [N, H, W, 18]}} of the reference's dla_34
    from the snapshot under ``xla`` and ``pallas_full`` (its Pallas
    kernels through their plain f32 version, ``_xla_fwd_clamped``): each
    DCN module's input through its ``conv_offset_mask`` conv, as the
    reference's explicit path computes the offsets
    (``centerpose_tpu/models/dla.py: DCN``)."""
    import flax.linen as nn

    from centerpose_tpu.models.dla import DCN
    from centerpose_tpu.models.factory import create_model
    from centerpose_tpu.ops import dcn_pallas as dp

    monkeypatch_module.setattr(dp, "dcn_v2_pallas_fused", _fused_plain)
    monkeypatch_module.setattr(dp, "dcn_v2_pallas", _explicit_plain)
    variables = jax_variables()
    out = {}
    for impl in ("xla", "pallas_full"):
        inputs = {}

        def keep(next_fun, args, kwargs, context):
            m = context.module
            if isinstance(m, DCN) and context.method_name == "__call__":
                x = args[0]
                inputs[m.path] = (jnp.transpose(x, (0, 1, 3, 2)) if m.chsec
                                  else x)
            return next_fun(*args, **kwargs)

        with nn.intercept_methods(keep):
            create_model(jax_cfg(128, impl)).apply(
                variables, jnp.asarray(images), train=False)
        out[impl] = {}
        for path, x in inputs.items():
            node = variables["params"]
            for part in path:
                node = node[part]
            om = _om(x, node["conv_offset_mask"]["kernel"],
                     node["conv_offset_mask"]["bias"])
            out[impl]["/".join(path) + "/conv_offset_mask"] = np.asarray(
                om[..., :18])
    return out


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


@pytest.mark.parametrize("impl", ["pallas_full", "xla"])
def test_offsets_equal_the_reference_models(impl, images, reference_offsets):
    """Every site's recorded offsets (under ``pallas_full`` the om-fused
    sites' from K1's ``om``, the others' from the explicit path; under
    ``xla`` every site's from the explicit path) equal the reference
    model's under the same ``dcn_impl``, within TOL_OFFSETS of the site's
    largest magnitude.  On these images the clamp binds (|dy| up to 6.63 at
    a site clamped at R = 6), so the two impls' deeper sites read
    different inputs."""
    cfg = offsets_hist.tool_config(impl, SMALL)
    det = Detector(cfg, offsets_hist.state_dict(cfg, NPZ), device="cpu")
    got = offsets_hist.site_offsets(det.model, images, "cpu")
    want = reference_offsets[impl]
    assert {offsets_hist.site_name(n) for n in got} == set(want)
    for name, off in got.items():
        ref = want[offsets_hist.site_name(name)]
        assert off.shape == ref.shape, name
        assert rel_err(off, ref) < TOL_OFFSETS, (name, rel_err(off, ref))


def test_rows_have_the_recorded_sites_and_fields(images, reference_offsets):
    """The tool's rows name the 16 sites of ``output/offsets_hist.json``
    (the reference tool's last recorded run) with its fields, in its
    order; each row's statistics are those of the site's offsets."""
    recorded = json.loads(RECORDED.read_text())
    cfg = offsets_hist.tool_config("pallas_full", SMALL)
    det = Detector(cfg, offsets_hist.state_dict(cfg, NPZ), device="cpu")
    rows = offsets_hist.site_rows(
        det.model, offsets_hist.site_offsets(det.model, images, "cpu"))
    assert len(rows) == 16
    assert [r["site"] for r in rows] == [r["site"] for r in
                                         recorded["sites"]]
    assert all(list(r) == list(recorded["sites"][0]) for r in rows)
    for row in rows:
        off = reference_offsets["pallas_full"][row["site"]]
        ady = np.abs(off[..., 0::2])
        assert row["shape"] == list(off.shape[1:3])
        assert row["dy_max"] == pytest.approx(ady.max(), abs=1e-3)
        assert 0.0 <= row["frac_dy_clamped"] <= row["frac_dy_gt1"] <= 1.0


def test_cli_skip_ap_writes_its_json(tmp_path):
    """``main`` with ``--skip-ap`` writes the reference's keys but ``ap``
    and ``ap_delta_pallas_vs_xla`` (an AP run's only)."""
    path = tmp_path / "offsets.json"
    ret = offsets_hist.main(["--device", "cpu", "--images", "2",
                             "--skip-ap", "--json", str(path), *SMALL])
    written = json.loads(path.read_text())
    assert written == json.loads(json.dumps(ret))
    recorded = json.loads(RECORDED.read_text())
    assert set(written) == set(recorded) - {"ap", "ap_delta_pallas_vs_xla"}
    assert written["n_images"] == 2 and len(written["sites"]) == 16
    assert written["worst_frac_dy_clamped"] == max(
        r["frac_dy_clamped"] for r in written["sites"])
    assert written["ckpt"] == "output/dla34_hard_artifact/params_f16.npz"
