"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  Everything that belongs to one of them sits in a file of its own
under ``benchmark/``, so that a cell, a configuration, a traffic mix or a
per-layer metric is added by adding files and entries, never by editing
a file that is there:

* a configuration: the ``file`` its ``configs`` entry names (JSON);
* a traffic mix: ``traffic/<traffic>.json``, parameters that the driver
  of its ``kind`` (``drivers/<kind>.py``) reads;
* a cell's correctness limits: ``limits/<cell>.json``;
* a per-layer metric: ``metrics/<name>.py``, whose ``read`` takes the
  traced stretch and returns the number or None.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / "BENCHMARK.json"

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


class Manifest:
    """The parsed manifest and lookups by name.  ``bench_dir``: where the
    files it names live (a copy's, in the tests)."""

    def __init__(self, path: Path = MANIFEST, bench_dir: Path = BENCH_DIR):
        self.path = Path(path)
        self.bench_dir = Path(bench_dir)
        self.root = self.bench_dir.parent
        self.data = json.loads(self.path.read_text())
        self.configs = {c["name"]: c for c in self.data["configs"]}
        self.workloads = {w["name"]: w for w in self.data["workloads"]}
        self.end_to_end = {m["name"]: m for m in self.data["end_to_end"]}
        self.per_layer = {m["name"]: m for m in self.data["per_layer"]}

    def cell(self, name: str) -> dict:
        if name not in self.workloads:
            raise KeyError(f"no workload {name!r} in {self.path.name}; "
                           f"have {sorted(self.workloads)}")
        return self.workloads[name]

    def config(self, cell: dict) -> dict:
        entry = self.configs[cell["config"]]
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, cell: dict) -> dict:
        path = self.bench_dir / "traffic" / f"{cell['traffic']}.json"
        return json.loads(path.read_text())

    def limits(self, cell: dict) -> dict:
        path = self.bench_dir / "limits" / f"{cell['name']}.json"
        return json.loads(path.read_text())

    def e2e_metrics(self, cell: dict) -> List[dict]:
        """The end-to-end metrics ``cell`` reports."""
        return [m for m in self.data["end_to_end"]
                if cell["name"] in m.get("workloads", [cell["name"]])]

    def layer_metrics(self, cell: dict) -> List[dict]:
        """The per-layer metrics ``cell`` reports."""
        return [m for m in self.data["per_layer"]
                if cell["name"] in m.get("workloads", [cell["name"]])]

    def driver(self, kind: str):
        return load_module(self.bench_dir / "drivers" / f"{kind}.py",
                           f"bench_driver_{kind}")

    def reader(self, metric: str):
        return load_module(self.bench_dir / "metrics" / f"{metric}.py",
                           "bench_metric_" + metric.replace(".", "_")
                           .replace("-", "_"))


def load_module(path: Path, name: str):
    """The module in the file ``path``, loaded under ``name``."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def problems(m: Manifest) -> List[str]:
    """What in the manifest breaks the naming rules or names a file that is
    not there; empty when all is well."""
    out: List[str] = []
    names: Dict[tuple, str] = {}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in m.data[group]:
            n = entry["name"]
            if not NAME.fullmatch(n):
                out.append(f"{group}: bad name {n!r}")
            kind = "metric" if group in ("end_to_end", "per_layer") else group
            if (kind, n) in names:
                out.append(f"{group}: {n!r} twice")
            names[(kind, n)] = group
    for metric in m.data["end_to_end"] + m.data["per_layer"]:
        if not UNIT.fullmatch(metric["unit"]):
            out.append(f"{metric['name']}: bad unit {metric['unit']!r}")
        if metric["better"] not in ("lower", "higher"):
            out.append(f"{metric['name']}: better {metric['better']!r}")
        for w in metric.get("workloads", []):
            if w not in m.workloads:
                out.append(f"{metric['name']}: unknown workload {w!r}")
    for c in m.data["configs"]:
        if not (m.root / c["file"]).is_file():
            out.append(f"config {c['name']}: no file {c['file']}")
        for key in c["reduced"]:
            if not NAME.fullmatch(key):
                out.append(f"config {c['name']}: bad reduced key {key!r}")
    for w in m.data["workloads"]:
        if w["config"] not in m.configs:
            out.append(f"{w['name']}: unknown config {w['config']!r}")
        for path in (m.bench_dir / "traffic" / f"{w['traffic']}.json",
                     m.bench_dir / "limits" / f"{w['name']}.json"):
            if not path.is_file():
                out.append(f"{w['name']}: no file {path.name}")
        reported = {x["name"] for x in m.e2e_metrics(w)}
        if "setup_s" not in reported or len(reported) < 2:
            out.append(f"{w['name']}: reports {sorted(reported)}")
        layer = m.layer_metrics(w)
        if not layer:
            out.append(f"{w['name']}: no per-layer metric")
        for metric in layer:
            if metric["moves"] not in reported:
                out.append(f"{w['name']}: {metric['name']} moves "
                           f"{metric['moves']}, which it does not report")
    for metric in m.data["per_layer"]:
        if not (m.bench_dir / "metrics" / f"{metric['name']}.py").is_file():
            out.append(f"{metric['name']}: no reader")
        if metric["moves"] not in m.end_to_end:
            out.append(f"{metric['name']}: moves unknown {metric['moves']!r}")
    return out

