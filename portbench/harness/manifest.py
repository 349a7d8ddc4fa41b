"""``BENCHMARK.json`` and the files it names, found by name.

A configuration is ``portbench/configs/<name>.json`` (its ``file`` in the
manifest), a traffic mix ``portbench/traffic/<name>.json``, a cell's
correctness limits ``portbench/limits/<cell>.json``, a per-layer metric
``portbench/metrics/<name>.py``.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _json(path: Path) -> Dict:
    return json.loads(path.read_text())


def load(root: Path = ROOT) -> Dict:
    return _json(root / "BENCHMARK.json")


def cell(manifest: Dict, name: str) -> Dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(manifest: Dict, name: str) -> Dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return _json(ROOT / c["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> Dict:
    return _json(BENCH / "traffic" / f"{name}.json")


def limits(cell_name: str) -> Dict[str, float]:
    return _json(BENCH / "limits" / f"{cell_name}.json")


def end_to_end(manifest: Dict, cell_name: str) -> List[Dict]:
    return [m for m in manifest["end_to_end"] if cell_name in m.get("workloads", [cell_name])]


def per_layer(manifest: Dict, cell_name: str) -> List[Dict]:
    """The cell's per-layer metrics: those that list it, and those with no
    list whose end-to-end metric the cell reports."""
    reported = {m["name"] for m in end_to_end(manifest, cell_name)}
    return [m for m in manifest["per_layer"]
            if cell_name in m.get("workloads", [cell_name] if m["moves"] in reported else [])]


def problems(manifest: Dict) -> List[str]:
    """What in the manifest breaks its naming rules or names a file that is
    not there."""
    out = []
    named = [("config", c["name"]) for c in manifest["configs"]]
    named += [("workload", w["name"]) for w in manifest["workloads"]]
    named += [("workload config", w["config"]) for w in manifest["workloads"]]
    named += [("traffic", w["traffic"]) for w in manifest["workloads"]]
    named += [("metric", m["name"]) for m in manifest["end_to_end"] + manifest["per_layer"]]
    named += [("reduced key", k) for c in manifest["configs"] for k in c["reduced"]]
    out += [f"{what} name {n!r}" for what, n in named if not NAME.match(n)]
    out += [f"unit {m['unit']!r} of {m['name']}" for m in manifest["end_to_end"] +
            manifest["per_layer"] if not UNIT.match(m["unit"])]
    for c in manifest["configs"]:
        if not (ROOT / c["file"]).is_file():
            out.append(f"config file {c['file']}")
    for w in manifest["workloads"]:
        for path in (BENCH / "traffic" / f"{w['traffic']}.json",
                     BENCH / "limits" / f"{w['name']}.json"):
            if not path.is_file():
                out.append(f"{path.relative_to(ROOT)} of {w['name']}")
    for m in manifest["per_layer"]:
        if not (BENCH / "metrics" / f"{m['name']}.py").is_file():
            out.append(f"reader of {m['name']}")
    return out
