"""The check fails what it should: the float8 control in the program's
place, and each fault a cell can have planted underneath the timed path,
at a size a test run holds (the chip runs read them at the cells' sizes;
PERF.md gives those readings)."""
import json

import pytest

from portbench import faults, run
from portbench.reference.check import judge
from portbench.tests.tinycell import add_tiny_cells


@pytest.fixture(scope="module")
def plans(tmp_path_factory):
    root = add_tiny_cells(str(tmp_path_factory.mktemp("bench")))
    return {k: run.plan_cell(root, f"tiny.{k}") for k in ("train", "render")}


@pytest.mark.parametrize("kind", ["train", "render"])
def test_control_fails_the_check(plans, kind, capsys):
    plan = plans[kind]
    run.readings(plan, [21, 22, 23], device="cpu")
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert len(lines) == 3
    for line in lines:
        assert judge(line["program"], plan.limits)[0]
        assert not judge(line["control"], plan.limits)[0]
        for fault in ("half_batch", "frozen_state", "altered_answer"):
            if fault in line:
                assert not judge(line[fault], plan.limits)[0], fault


def _chunks(plan):
    W, H = plan.config["scene"]["img_wh"]
    return -(-W * H // plan.traffic["chunk"])


@pytest.mark.parametrize("kind,fault", [
    ("train", lambda plan: faults.frozen_state()),
    ("train", lambda plan: faults.half_batch()),
    ("render", lambda plan: faults.altered_answer(_chunks(plan)))],
    ids=["frozen_state", "half_batch", "altered_answer"])
def test_a_run_with_a_fault_reads_not_correct(plans, kind, fault):
    plan = plans[kind]
    with fault(plan):
        out = run.run_cell(plan, 31, 0.5, False, device="cpu")
    assert out["correct"] is False and out["failed"] > 0


def test_a_sound_run_reads_correct(plans):
    out = run.run_cell(plans["train"], 31, 0.5, False, device="cpu")
    assert out["correct"] is True
