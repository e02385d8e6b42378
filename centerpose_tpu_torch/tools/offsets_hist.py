"""Learned DCN offsets against the per-site y-clamp, counterpart of
``tools/offsets_hist.py``.

Runs a dla_34 snapshot (``head_conv`` 256, ``pallas_full``, bfloat16: the
reference tool's config) over the synthetic val split
(``SyntheticEvalDataset(n, seed=2)``, each image encoded as for evaluation)
and keeps every DCN site's offsets: at an om-fused site the raw offsets
that K1 itself computed (``ops/dcn_cuda.dcn_v2_fused_op``'s ``om``,
channels 0-17; on the CPU its plain version), elsewhere the explicit
path's ``offset`` (the om conv) that K2 reads.  Per site it reports the
|dy| and |dx| quantiles and how often |dy| passes 1, 4 and the clamp
radius R (``ops/dcn_cuda.resolve_max_dy``, as the reference tool reads
it), under the reference's field and site names; then, unless
``--skip-ap``, OKS AP of the same weights and images under ``pallas_full``
(clamped) and ``xla`` (unclamped):

    python -m centerpose_tpu_torch.tools.offsets_hist \\
        [--ckpt output/dla34_hard_artifact/params_f16.npz] [--images 32] \\
        [--json port_output/offsets_hist.json] [--skip-ap] [--device cpu] \\
        [KEY VALUE ...]

``--ckpt``: an f16 snapshot (``.npz``) or a checkpoint of the port's
``tools/train.py``.  ``KEY VALUE`` overrides follow the reference tool's
config (e.g. ``model.input_res 128 model.output_res 32``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
from typing import Dict, List

import numpy as np
import torch

from centerpose_tpu_torch.config import Config, load_config
from centerpose_tpu_torch.data.encode import encode_example
from centerpose_tpu_torch.data.synthetic import SyntheticEvalDataset
from centerpose_tpu_torch.inference.detector import Detector
from centerpose_tpu_torch.tools.evaluate import (ROOT, SNAPSHOT,
                                                 checkpoint_state_dict,
                                                 no_tf32)
from centerpose_tpu_torch.weights import state_dict_from_npz

# The reference tool's config (on the defaults), with its DCN impl.
OPTS = ["model.name", "dla_34", "model.head_conv", "256",
        "model.dcn_impl", "pallas_full", "model.compute_dtype", "bfloat16"]
BATCH = 8  # images per forward


def tool_config(impl: str = "pallas_full", opts=()) -> Config:
    """The reference tool's config under ``impl``, then ``opts``."""
    base = OPTS[:5] + [impl] + OPTS[6:]
    return load_config(None, base + list(opts))


def state_dict(cfg: Config, ckpt: str) -> Dict[str, torch.Tensor]:
    """The weights of ``ckpt``: an ``.npz`` snapshot or a port checkpoint
    (a relative path that is not there is read from the repository's
    root)."""
    if not os.path.exists(ckpt):
        ckpt = str(ROOT / ckpt)
    if ckpt.endswith(".npz"):
        return state_dict_from_npz(ckpt)
    return checkpoint_state_dict(cfg, ckpt)


def encode_images(cfg: Config, ds: SyntheticEvalDataset) -> np.ndarray:
    """[N, H, W, 3] float32: each image of ``ds`` encoded for evaluation,
    as the reference tool does (``encode_example(..., is_train=False)``)."""
    batch = []
    for i in range(len(ds)):
        img, anns = ds.get_raw(i)
        batch.append(encode_example(img, anns, cfg, None, False)["input"])
    return np.stack(batch)


def site_name(module_name: str) -> str:
    """A DCN module's name in the reference's path form, the one its tool
    reports (``dla_up.ida_0.node_1.DCN_0`` ->
    ``dla_up/ida_0/node_1/DCN_0/conv_offset_mask``)."""
    return module_name.replace(".", "/") + "/conv_offset_mask"


@contextlib.contextmanager
def record_offsets(model: torch.nn.Module):
    """Inside: every call of a DCN site of ``model`` (``models/dla.DCN``)
    keeps its offsets [B, H, W, 18] (dy, dx per tap; float32, on the host)
    in the yielded {module name: [tensors]}: K1's own ``om`` at an
    om-fused site, the ``offset`` K2 reads elsewhere.  The sites compute
    as they do outside it."""
    from centerpose_tpu_torch.models import dla
    from centerpose_tpu_torch.ops.dcn_cuda import dcn_v2_fused_op

    names = {m: n for n, m in model.named_modules() if isinstance(m, dla.DCN)}
    kept: Dict[str, List[torch.Tensor]] = {n: [] for n in names.values()}
    calling = [""]  # the site whose forward runs now
    hooks = [m.register_forward_pre_hook(
        lambda m, args: calling.__setitem__(0, names[m])) for m in names]
    fused, explicit = dla.dcn_v2_fused, dla.dcn_v2

    def fused_keeping_om(x, omw, omb, weight, bias, max_dy, edge_grad=1.0):
        y, om = dcn_v2_fused_op(x, omw, omb, weight, bias,
                                None if max_dy is None else float(max_dy),
                                float(edge_grad))
        kept[calling[0]].append(om[..., :18].float().cpu())
        return y

    def explicit_keeping_offset(x, offset, mask, *args):
        kept[calling[0]].append(offset.float().cpu())
        return explicit(x, offset, mask, *args)

    dla.dcn_v2_fused, dla.dcn_v2 = fused_keeping_om, explicit_keeping_offset
    try:
        yield kept
    finally:
        dla.dcn_v2_fused, dla.dcn_v2 = fused, explicit
        for h in hooks:
            h.remove()


def site_offsets(model: torch.nn.Module, images: np.ndarray,
                 device: str) -> Dict[str, np.ndarray]:
    """{module name: offsets [N, H, W, 18] float32} of every DCN site of
    the eval ``model`` over ``images`` (``encode_images``), BATCH at a
    time."""
    with torch.inference_mode(), record_offsets(model) as kept:
        for i in range(0, len(images), BATCH):
            model(torch.from_numpy(images[i:i + BATCH]).to(device))
    return {n: torch.cat(v).numpy() for n, v in kept.items()}


def site_row(name: str, offsets: np.ndarray, cin: int, cout: int) -> dict:
    """The reference tool's row of one site: |dy| and |dx| quantiles and
    extremes, and the fractions of taps with |dy| past 1, 4 and R."""
    from centerpose_tpu_torch.ops.dcn_cuda import resolve_max_dy

    ady = np.abs(offsets[..., 0::2]).ravel()
    adx = np.abs(offsets[..., 1::2]).ravel()
    h, w = offsets.shape[1:3]
    md = resolve_max_dy(h, w, cin, cout)

    def q(a, p):
        return round(float(np.percentile(a, p)), 4)

    return {
        "site": site_name(name),
        "shape": [int(h), int(w)],
        "max_dy": int(md),
        "dy_p50": q(ady, 50), "dy_p99": q(ady, 99),
        "dy_max": round(float(ady.max()), 4),
        "dx_p50": q(adx, 50), "dx_p99": q(adx, 99),
        "dx_max": round(float(adx.max()), 4),
        "frac_dy_gt1": round(float((ady > 1.0).mean()), 6),
        "frac_dy_gt4": round(float((ady > 4.0).mean()), 6),
        "frac_dy_clamped": round(float((ady > md).mean()), 6),
    }


def site_rows(model: torch.nn.Module,
              offsets: Dict[str, np.ndarray]) -> List[dict]:
    """``site_row`` of every site, ordered by the reference's site path."""
    mods = dict(model.named_modules())
    rows = [site_row(n, off, mods[n].in_features, mods[n].features)
            for n, off in offsets.items()]
    return sorted(rows, key=lambda r: r["site"])


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="learned DCN offsets against "
                                            "the per-site y-clamp")
    p.add_argument("--ckpt", default=str(SNAPSHOT.relative_to(ROOT)),
                   help="an f16 snapshot (.npz) or a port checkpoint")
    p.add_argument("--images", type=int, default=32)
    p.add_argument("--json", default="port_output/offsets_hist.json")
    p.add_argument("--skip-ap", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("opts", nargs="*", help="KEY VALUE config overrides")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the tool; returns what it writes to ``--json``."""
    args = parse_args(argv)
    no_tf32()
    cfg = tool_config("pallas_full", args.opts)
    sd = state_dict(cfg, args.ckpt)
    ds = SyntheticEvalDataset(args.images, seed=2)
    ds.render()  # drawn once for the offsets and both AP rows
    det = Detector(cfg, sd, device=args.device)
    offsets = site_offsets(det.model, encode_images(cfg, ds), args.device)
    sites = site_rows(det.model, offsets)
    for row in sites:
        print(json.dumps(row), flush=True)
    worst = max(r["frac_dy_clamped"] for r in sites)
    print(f"worst clamp-binding fraction across sites: {worst:.6f}",
          flush=True)
    out = {"ckpt": args.ckpt, "n_images": args.images, "sites": sites,
           "worst_frac_dy_clamped": worst}
    del det

    if not args.skip_ap:
        from centerpose_tpu_torch.eval.harness import evaluate_detector

        out["ap"] = {}
        for impl in ("pallas_full", "xla"):
            det = Detector(tool_config(impl, args.opts), sd,
                           device=args.device)
            results, _, wall = evaluate_detector(det, ds.items(), workers=2)
            stats = ds.run_eval(results)
            out["ap"][impl] = {k: round(float(v), 4) for k, v in stats.items()
                               if not k.startswith("bbox")}
            print(impl, "AP", stats["AP"], f"({wall:.1f}s)", flush=True)
        out["ap_delta_pallas_vs_xla"] = round(
            out["ap"]["pallas_full"]["AP"] - out["ap"]["xla"]["AP"], 4)

    os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
    with open(args.json, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", args.json)
    return out


if __name__ == "__main__":
    main()
