"""The judgement sees what it must: at a size a test run holds, on the
CPU through the program's plain versions, a run of each cell is correct;
the control (the program's own lower-precision paths, and the references
computed in a lower precision in the place of those without one) is not;
and each fault planted under the timed path (``harness/faults.py``) makes
the run not correct, or stops it.  The harness's look for a card is
skipped: ``run.run_cell`` is driven directly."""

import argparse
import json

import numpy as np
import pytest
import torch

from mdbench import control, run
from mdbench.harness import faults, judge, passes
from mdbench.harness import spec as specs

CELLS = [w["name"] for w in specs.load_benchmark()["workloads"]
         if w["chips"] == 1]
#: traffic files of jobs over ranks, run on the first cell's
#: configuration whether or not BENCHMARK.json has a cell of them yet.
RANK_TRAFFIC = sorted(p.stem for p in (specs.BENCH / "traffic").glob("*.json")
                      if json.loads(p.read_text()).get("ranks", 1) > 1)
#: sizes a test run holds (3 cells of the 6 A cut an axis).
SMALL = {"random_walk": {"n_atoms": 3000, "box": 18.5},
         "polymer_chains": {"n_chains": 60, "n_atoms": 3000, "box": 18.5}}


def ranks_cell(traffic_name):
    """A cell of the traffic `traffic_name` (a job over ranks) on
    ``lj100k``, from the files alone."""

    cell = specs.cell("lj100k.fused")
    cell["traffic"] = json.loads(
        (specs.BENCH / "traffic" / f"{traffic_name}.json").read_text())
    cell["name"] = f"lj100k.{traffic_name}"
    cell["chips"] = cell["traffic"]["ranks"]
    return cell


def small(name, cell=None):
    cell = cell or specs.cell(name)
    cell["config"]["rehearse"] = SMALL[cell["config"]["generator"]]
    cell["traffic"]["rehearse"] = {"pass_frames": 8}
    return cell


def run_small(cell, capsys, wrap=None):
    args = argparse.Namespace(rehearse=True, seed=2147483999, seconds=0.0,
                              trace=0)
    run.run_cell(args, cell, torch.device("cpu"), lambda: None, wrap=wrap)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name, capsys):
    out = run_small(small(name), capsys)
    assert out["correct"], out["checks"]
    assert out["measured"] is False


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_a_fault_under_the_timed_path_is_not_correct(name, fault, capsys):
    try:
        out = run_small(small(name), capsys, wrap=faults.wrap(fault))
    except Exception:  # the run stops: it prints no result
        return
    assert out["correct"] is False, (fault, out["checks"])


def run_ranks(cell, capsys, fault=None):
    """A rehearsal of a cell over ranks: gloo ranks on the CPU."""

    from mdbench.harness import ranks

    args = argparse.Namespace(rehearse=True, seed=2147483996, seconds=0.0,
                              trace=0, workload=cell["name"])
    ranks.main(args, cell, 0.0, fault=fault)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("traffic", RANK_TRAFFIC)
def test_a_sound_job_over_ranks_is_correct(traffic, capsys):
    out = run_ranks(small(None, ranks_cell(traffic)), capsys)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", faults.RANK_FAULTS)
@pytest.mark.parametrize("traffic", RANK_TRAFFIC)
def test_a_job_without_the_exchange_is_not_correct(traffic, fault, capsys):
    try:
        out = run_ranks(small(None, ranks_cell(traffic)), capsys,
                        fault=fault)
    except SystemExit:  # a rank stopped: the run prints no result
        return
    assert out["correct"] is False, out["checks"]


def control_verdict(cell, device, seed):
    config, traffic = run.sized(cell, device.type == "cpu")
    frames, dims = specs.generator(config["generator"]).make(
        config, int(traffic["pass_frames"]), seed, device)
    from mdhelper_tpu_torch.core.universe import Universe

    universe = Universe.from_arrays(frames, dims, dt=1.0)
    answers = judge.wants(frames, dims, traffic, config, device)
    taken = control.control_taken(universe, frames, dims, traffic, config,
                                  device)
    return judge.verdict([taken], answers, traffic)


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    correct, failed, widest, limits = control_verdict(
        small(name), torch.device("cpu"), 2147483998)
    assert not correct and failed == 1, widest


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_at_the_cells_size_is_not_correct(name, card):
    correct, _, widest, _ = control_verdict(specs.cell(name), card,
                                            2147483997)
    assert not correct, widest
    assert np.isfinite(list(widest.values())).any()
