"""Port parity: config tree, weight bridge and the DCN site policy."""

import dataclasses

import numpy as np
import pytest
import torch

import centerpose_tpu.ops.dcn_pallas as dp
from centerpose_tpu.config import defaults as jdefaults
from centerpose_tpu_torch.config import defaults as tdefaults
from centerpose_tpu_torch.ops import dcn_cuda as dc
from centerpose_tpu_torch.weights import state_dict_from_npz, torch_key

from _torch_port import NPZ, torch_cfg, torch_model

# dla_34 DCN sites (Cin, Cout, H=W at 512x512 input); the map size at another
# input resolution scales with it.
SITES_512 = [(512, 256, 16), (256, 256, 32), (256, 128, 32), (128, 128, 64),
             (128, 64, 64), (256, 64, 32), (64, 64, 128)]


def test_config_tree_and_opts_match_reference():
    assert (dataclasses.asdict(tdefaults.default_config())
            == dataclasses.asdict(jdefaults.default_config()))
    opts = ["model.name", "dla_34", "model.dcn_max_dy", "8",
            "test.flip_test", "true", "train.lr_step", "[10,20]"]
    assert (dataclasses.asdict(tdefaults.load_config(opts=opts))
            == dataclasses.asdict(jdefaults.load_config(opts=opts)))


def test_config_loads_flagship_yaml():
    path = "experiments/dla_34_512x512.yaml"
    got = tdefaults.load_config(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jdefaults.load_config(path))
    assert (got.model.dcn_impl, got.model.compute_dtype) == (
        "pallas_full", "bfloat16")
    with pytest.raises(KeyError):
        tdefaults.update_config(got, {"model.no_such_knob": 1})


def test_weight_bridge_uses_every_key():
    sd = state_dict_from_npz(NPZ)
    with np.load(NPZ) as data:
        keys = data.files
        n_params = sum(data[k].size for k in keys if k.startswith("params:"))
        n_stats = sum(data[k].size for k in keys
                      if k.startswith("batch_stats:"))
        conv = "params:['base']['base_layer']['Conv_0']['kernel']"
        dcn = "params:['ida_up']['node_1']['DCN_0']['kernel']"
        om = "params:['ida_up']['node_1']['DCN_0']['conv_offset_mask']['kernel']"
        raw = {k: data[k].astype(np.float32) for k in (conv, dcn, om)}
    assert len(keys) == 347 and len(sd) == 347
    # conv HWIO -> OIHW; DCN and om kernels keep the op's [3,3,Cin,*] layout
    np.testing.assert_array_equal(sd[torch_key(conv)].numpy(),
                                  raw[conv].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd[torch_key(dcn)].numpy(), raw[dcn])
    np.testing.assert_array_equal(sd[torch_key(om)].numpy(), raw[om])
    assert tuple(sd[torch_key(om)].shape) == (3, 3, 64, 27)
    assert torch_key("batch_stats:['base']['level0']['BatchNorm_0']['var']") \
        == "base.level0.BatchNorm_0.running_var"

    model = torch_model(torch_cfg(128))  # strict load: nothing left over
    assert sum(p.numel() for p in model.parameters()) == n_params == 20095962
    assert sum(b.numel() for n, b in model.named_buffers()
               if n.endswith(("running_mean", "running_var"))) == n_stats


@pytest.mark.parametrize("res", [128, 384, 512, 640])
def test_site_policy_matches_reference(res):
    for cin, cout, hw512 in SITES_512:
        hw = hw512 * res // 512
        args = (hw, hw, cin, cout)
        assert dc.resolve_max_dy(*args) == dp.resolve_max_dy(*args)
        assert dc.pallas_supported(*args) == dp.pallas_supported(*args)
        assert dc.fused_om_supported(*args) == dp.fused_om_supported(*args)
        for md in (3, 8):
            assert (dc.resolve_max_dy(*args, md)
                    == dp.resolve_max_dy(*args, md))
            assert (dc.pallas_supported(*args, max_dy=md)
                    == dp.pallas_supported(*args, max_dy=md))


def test_site_policy_at_512_and_xla():
    got = [dc.site_max_dy(hw, hw, cin, cout, "pallas_full")
           for cin, cout, hw in SITES_512]
    assert got == [24, 12, 12, 12, 12, 12, 6]
    assert all(dc.fused_om_supported(hw, hw, cin, cout)
               for cin, cout, hw in SITES_512)
    assert all(dc.site_max_dy(hw, hw, cin, cout, "xla") is None
               for cin, cout, hw in SITES_512)
    # 128x128 input: maps 4..32; some sites fall back to the unclamped op
    got128 = [dc.site_max_dy(hw // 4, hw // 4, cin, cout, "pallas_full")
              for cin, cout, hw in SITES_512]
    assert None in got128 and any(r is not None for r in got128)
    with pytest.raises(NotImplementedError):
        dc.site_max_dy(16, 16, 64, 64, "conv")


def test_dla34_has_16_dcn_sites_over_7_shapes():
    from centerpose_tpu_torch.models.dla import DCN

    model = torch_model(torch_cfg(128))
    shapes = []

    def hook(mod, inp, out):
        shapes.append((mod.in_features, mod.features, inp[0].shape[2]))

    hs = [m.register_forward_hook(hook) for m in model.modules()
          if isinstance(m, DCN)]
    with torch.no_grad():
        model(torch.zeros(1, 128, 128, 3))
    for h in hs:
        h.remove()
    assert len(shapes) == 16
    want = {(cin, cout, hw // 4) for cin, cout, hw in SITES_512}
    assert set(shapes) == want
