"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<config>.<traffic>`` of ``workloads`` reads ``benchmark/configs/<config>.json``
(the configuration as it is run), ``benchmark/reference/<config>.py`` (its plain
reference), ``benchmark/traffic/<traffic>.json`` (the clip pool's recipe and the
cell's flags), ``benchmark/limits/<cell>.json`` (the limit of each number its
comparison reads) and, for each per-layer metric it reports, the reader
``benchmark/metrics/<metric>.py``. Adding a configuration, a traffic mix or a
metric is adding those files and the entries that name them.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load(path: str = MANIFEST) -> Dict:
    with open(path) as f:
        return json.load(f)


def _by_name(entries: List[Dict], name: str, what: str) -> Dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(bench: Dict, workload: str) -> Dict:
    return _by_name(bench["workloads"], workload, "workload")


def config_path(name: str, bench_dir: str = BENCH_DIR) -> str:
    return os.path.join(bench_dir, "configs", name + ".json")


def traffic_path(name: str, bench_dir: str = BENCH_DIR) -> str:
    return os.path.join(bench_dir, "traffic", name + ".json")


def limits_path(workload: str, bench_dir: str = BENCH_DIR) -> str:
    """The cell's limits on the numbers its comparison reads."""
    return os.path.join(bench_dir, "limits", workload + ".json")


def metric_path(name: str, bench_dir: str = BENCH_DIR) -> str:
    return os.path.join(bench_dir, "metrics", name + ".py")


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def reference_module(config: str):
    """``benchmark.reference.<config>``: make_weights, outputs, errors, video_flops."""
    return importlib.import_module(f"benchmark.reference.{config}")


def metric_reader(name: str, bench_dir: str = BENCH_DIR):
    """The ``read(ctx)`` function of ``benchmark/metrics/<name>.py``."""
    path = metric_path(name, bench_dir)
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + re.sub(r"\W", "_", name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def end_to_end_for(bench: Dict, workload: str) -> List[Dict]:
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or workload in m["workloads"]]


def per_layer_for(bench: Dict, workload: str) -> List[Dict]:
    """The per-layer metrics the cell reports: those that list it, and those
    without a list whose moved metric the cell reports."""
    e2e = {m["name"] for m in end_to_end_for(bench, workload)}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def check_names(bench: Dict) -> List[str]:
    """Problems with names and units (empty when none)."""
    problems = []
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench.get(section, []):
            names.append((section, e["name"]))
            for key in ("name", "config", "traffic"):
                if key in e and not NAME_RE.match(e[key]):
                    problems.append(f"{section}: bad {key} {e[key]!r}")
            if "unit" in e and not UNIT_RE.match(e["unit"]):
                problems.append(f"{section}: bad unit {e['unit']!r}")
            for key in e.get("reduced", []):
                if not NAME_RE.match(key):
                    problems.append(f"{section}: bad reduced key {key!r}")
    for section in ("configs", "workloads"):
        seen = [n for s, n in names if s == section]
        if len(seen) != len(set(seen)):
            problems.append(f"{section}: duplicate names")
    metrics = [n for s, n in names if s in ("end_to_end", "per_layer")]
    if len(metrics) != len(set(metrics)):
        problems.append("duplicate metric names")
    return problems


def missing_files(bench: Dict, bench_dir: str = BENCH_DIR) -> List[str]:
    """Files a cell or metric names that are not there (empty when none)."""
    missing = []
    for w in bench["workloads"]:
        for path in (config_path(w["config"], bench_dir), traffic_path(w["traffic"], bench_dir),
                     os.path.join(bench_dir, "reference", w["config"] + ".py"),
                     limits_path(w["name"], bench_dir)):
            if not os.path.exists(path):
                missing.append(path)
    for m in bench["per_layer"]:
        if not os.path.exists(metric_path(m["name"], bench_dir)):
            missing.append(metric_path(m["name"], bench_dir))
    return missing


def merged(base: Dict, dry: Optional[Dict]) -> Dict:
    """``base`` with a dry run's overrides: ``flags`` appended (the last flag
    wins), every other key replaced, a dict merged one level down."""
    if not dry:
        return base
    out = dict(base)
    for key, value in dry.items():
        if key == "flags":
            out["flags"] = list(base.get("flags", [])) + list(value)
        elif isinstance(value, dict) and isinstance(base.get(key), dict):
            out[key] = {**base[key], **value}
        else:
            out[key] = value
    return out
