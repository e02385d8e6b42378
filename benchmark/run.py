"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json`` and the program
(``centerpose_tpu_torch``).  The cell names a configuration and a traffic
mix (``harness/manifest.py``); the traffic's ``kind`` names the driver
(``drivers/<kind>.py``) that sets up, warms up, measures for ``--seconds``
and checks what the timed path produced against the plain reference.
With ``--trace 1`` the driver also records a stretch under the profiler
and the line carries the cell's per-layer metrics (``metrics/<name>.py``)
in place of its end-to-end ones.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown`` with
``--trace 1``), then ``checks``: each number compared, with its limit.
The same numbers close standard error.  Without a CUDA device (or with
fewer than the cell asks for) the run prints no result and exits 2; it
exits 3 if a forbidden module (``harness/guard.py``) was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "benchmark" / ".cache"
# build and kernel caches at fixed paths inside the checkout; no library
# the port uses may load JAX by itself
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@dataclass
class Context:
    """What a driver gets: the cell, its configuration file, traffic and
    limits, the seed and window, the device, and the clock's start."""
    root: Path
    cell: dict
    cfg: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t0: float = T0
    overrides: dict = field(default_factory=dict)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def device_info(count: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count}


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def result(ctx: Context, manifest, out: dict) -> dict:
    """The result line of a driver's ``out``."""
    cell = ctx.cell
    metrics = {}
    if ctx.trace:
        info = dict(out["info"], cfg=ctx.cfg, traffic=ctx.traffic)
        for m in manifest.layer_metrics(cell):
            v = manifest.reader(m["name"]).read(out["trace"], info)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in manifest.e2e_metrics(cell):
            metrics[m["name"]] = {"value": out["metrics"][m["name"]],
                                  "unit": m["unit"]}
    checks = {name: {"value": v, "limit": lim}
              for name, (v, lim) in out["checks"].items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics}
    if ctx.device == "cuda":
        line["device"] = dict(device_info(cell["chips"]),
                              memory_peak_bytes=out["memory_peak_bytes"])
    else:
        line["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                          "memory_peak_bytes": 0}
    if ctx.trace:
        t = out["trace"]
        line["device"]["busy_s"] = t.busy_s
        line["device"]["window_s"] = (t.end_us - t.start_us) / 1e6
        line["breakdown"] = {"device_ops": t.top_ops(),
                             "idle_gaps": t.idle_gaps()}
    line["checks"] = checks
    return line


def execute(ctx: Context, manifest) -> dict:
    """Drive the cell and build its result line (no checks for a chip)."""
    driver = manifest.driver(ctx.traffic["kind"])
    return result(ctx, manifest, driver.run(ctx))


def main(argv=None) -> int:
    args = parse_args(argv)
    from benchmark.harness import guard
    from benchmark.harness.manifest import Manifest

    manifest = Manifest()
    cell = manifest.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['name']} needs {cell['chips']} CUDA device(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    ctx = Context(ROOT, cell, manifest.config(cell), manifest.traffic(cell),
                  manifest.limits(cell), args.seed % (1 << 63), args.seconds,
                  bool(args.trace))
    out = manifest.driver(ctx.traffic["kind"]).run(ctx)
    print(f"setup_s {out['metrics']['setup_s']!r}", file=sys.stderr)
    if ctx.trace:
        print(f"profile read in {out['trace'].read_s:.1f} s", file=sys.stderr)
    line = result(ctx, manifest, out)
    bad = guard.forbidden_loaded()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    print(f"card: {power_limit()}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
