"""BENCHMARK.json against the contract's form, and the harness finding a
cell, a configuration and a metric by name."""

import json
import shutil

import pytest

from mdbench.harness import spec as specs

BENCH = specs.load_benchmark()
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def names():
    out = [("config", c["name"]) for c in BENCH["configs"]]
    out += [("workload", w["name"]) for w in BENCH["workloads"]]
    out += [("metric", m["name"]) for m in METRICS]
    out += [("traffic", w["traffic"]) for w in BENCH["workloads"]]
    out += [("reduced", k) for c in BENCH["configs"] for k in c["reduced"]]
    return out


@pytest.mark.parametrize("kind,name", names())
def test_names_use_allowed_characters(kind, name):
    assert specs.NAME.match(name), (kind, name)


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_units_and_directions(metric):
    m = next(x for x in METRICS if x["name"] == metric)
    assert specs.UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")


def test_names_are_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        seen = [x["name"] for x in group]
        assert len(seen) == len(set(seen))


def test_keys_are_exactly_the_contracts():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["why"]) <= 200 and "\n" not in c["why"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_names_an_existing_configuration(cell):
    w = next(x for x in BENCH["workloads"] if x["name"] == cell)
    configs = {c["name"]: c for c in BENCH["configs"]}
    assert w["config"] in configs
    assert (specs.ROOT / configs[w["config"]]["file"]).is_file()
    assert (specs.BENCH / "traffic" / f"{w['traffic']}.json").is_file()


def test_four_chip_cells_are_at_most_a_quarter():
    fours = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    assert fours <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_setup_another_metric_and_a_layer(cell):
    c = specs.cell(cell)
    e2e = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c["per_layer"]
    for m in c["per_layer"]:
        assert m["moves"] in e2e
        assert (specs.BENCH / "metrics" / f"{m['name']}.py").is_file()
    for entry in c["traffic"]["analyses"]:
        assert (specs.BENCH / "reference"
                / f"{entry['reference']}.py").is_file()
    assert (specs.BENCH / "generators"
            / f"{c['config']['generator']}.py").is_file()


def test_every_config_is_used_by_a_cell():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_run_seconds_fit_the_full_check():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_command_and_paths():
    assert BENCH["command"] == ["python3", "mdbench/run.py"]
    assert BENCH["paths"] == ["mdbench"]
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_a_cell_is_added_by_adding_files(tmp_path):
    """A new traffic file and a new BENCHMARK.json entry in a copy are
    found by name, with no other file of the harness edited."""

    shutil.copytree(specs.BENCH, tmp_path / "mdbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    traffic = json.loads((specs.BENCH / "traffic" / "fused.json").read_text())
    traffic["pass_frames"] = 64
    (tmp_path / "mdbench" / "traffic" / "fused_short.json").write_text(
        json.dumps(traffic))
    bench["workloads"].append({"name": "lj100k.fused_short",
                               "config": "lj100k", "traffic": "fused_short",
                               "chips": 1, "why": "a test cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = specs.cell("lj100k.fused_short", root=tmp_path)
    assert cell["traffic"]["pass_frames"] == 64
    assert cell["config"]["n_atoms"] == 100000
    assert {m["name"] for m in cell["end_to_end"]} == {"setup_s"}
    assert cell["chips"] == 1
