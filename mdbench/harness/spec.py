"""A cell of ``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  The configuration's file is the ``file`` of its ``configs`` entry;
the traffic mix is ``mdbench/traffic/<traffic>.json``; the metrics a cell
reports are the ``end_to_end`` and ``per_layer`` entries whose
``workloads`` list it, or that have no such list; each per-layer metric is
read by ``mdbench/metrics/<name>.py``.  Nothing here knows a cell, a
configuration or a metric by name.
"""

import importlib.util
import json
import re
from pathlib import Path

#: the root of the checkout (this file is mdbench/harness/spec.py).
ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "mdbench"

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_benchmark(root=ROOT):
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def applies(metric, workload):
    """True when `metric` (an end_to_end or per_layer entry) is reported
    in the cell named `workload`."""

    cells = metric.get("workloads")
    return cells is None or workload in cells


def load_module(path, name):
    """The Python file `path` as a module named `name`."""

    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def generator(name):
    return load_module(BENCH / "generators" / f"{name}.py",
                       f"mdbench_generator_{name}")


def reference(kind):
    return load_module(BENCH / "reference" / f"{kind}.py",
                       f"mdbench_reference_{kind}")


def metric_reader(name):
    return load_module(BENCH / "metrics" / f"{name}.py",
                       f"mdbench_metric_{name.replace('.', '_')}")


def cell(name, root=ROOT):
    """Everything one run of the cell `name` needs: ``name``, ``chips``,
    ``config`` (the configuration file's content, with ``name``),
    ``traffic`` (the traffic file's content, with ``name``),
    ``end_to_end`` and ``per_layer`` (the metric entries it reports)."""

    bench = load_benchmark(root)
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise SystemExit(f"no cell named {name!r} in BENCHMARK.json")
    entry = entries[0]
    configs = {c["name"]: c for c in bench["configs"]}
    config_entry = configs[entry["config"]]
    with open(Path(root) / config_entry["file"]) as f:
        config = json.load(f)
    config["name"] = entry["config"]
    with open(Path(root) / "mdbench" / "traffic"
              / f"{entry['traffic']}.json") as f:
        traffic = json.load(f)
    traffic["name"] = entry["traffic"]
    return {
        "name": name,
        "chips": int(entry["chips"]),
        "config": config,
        "traffic": traffic,
        "end_to_end": [m for m in bench["end_to_end"] if applies(m, name)],
        "per_layer": [m for m in bench["per_layer"] if applies(m, name)],
    }
