"""The harness is driven by data: every cell's files are found by name, a
new cell is new files and entries only, the result line has its schema, a
run without a card fails, and the import guard catches JAX and the JAX
package by whole top-level name."""
import json
import os
import subprocess
import sys
import types

import pytest

from portbench import run
from portbench.tests.tinycell import ROOT, add_tiny_cells


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", [w["name"] for w in _bench()["workloads"]])
def test_every_cell_found_by_name(name):
    plan = run.plan_cell(ROOT, name)
    assert plan.config["name"] == plan.workload["config"]
    assert plan.traffic["kind"] in ("train", "render")
    assert {m["name"] for m in plan.end_to_end} >= {"setup_s"}
    assert len(plan.end_to_end) >= 2 and plan.per_layer
    for m in plan.end_to_end + plan.per_layer:
        assert callable(run.reader(plan.metrics_dir, m["name"]))
    numbers = ({"loss_gap", "grad_gap", "change_gap"}
               if plan.traffic["kind"] == "train"
               else {"color_gap", "mask_mismatch"})
    assert set(plan.limits) == numbers


def test_config_files_hold_the_preset_as_run():
    from pointnerf_tpu_torch.presets import scene_preset
    for c in _bench()["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            d = json.load(f)
        preset = json.loads(scene_preset(d["preset"]).to_json())
        changed = {k.split(".", 1)[1] for k in d["changed_from_preset"]}
        for section, fields in preset.items():
            for k, v in fields.items():
                if section == "query" and k in changed:
                    continue
                assert d["pointnerf"][section][k] == v, (c["name"], k)
        assert sorted(c["reduced"]) == sorted(d["changed_from_preset"])


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return add_tiny_cells(str(tmp_path_factory.mktemp("bench")))


def test_new_cell_is_new_files_only(tiny_root):
    """The copy differs from the repo's benchmark by added files and by
    added entries of BENCHMARK.json alone."""
    for dirpath, _dirs, files in os.walk(os.path.join(ROOT, "portbench")):
        rel = os.path.relpath(dirpath, ROOT)
        for f in files:
            if f.endswith(".pyc"):
                continue
            with open(os.path.join(dirpath, f), "rb") as a, \
                    open(os.path.join(tiny_root, rel, f), "rb") as b:
                assert a.read() == b.read(), os.path.join(rel, f)
    old = _bench()
    with open(os.path.join(tiny_root, "BENCHMARK.json")) as f:
        new = json.load(f)
    for key in ("configs", "workloads"):
        assert new[key][:len(old[key])] == old[key]
    plan = run.plan_cell(tiny_root, "tiny.train")
    assert plan.config["name"] == "tiny"
    assert plan.traffic["pool_batches"] == 4
    assert {m["name"] for m in plan.per_layer} == {
        m["name"] for m in old["per_layer"]
        if "lego.train" in m["workloads"]}


def test_new_per_layer_metric_is_a_file_and_an_entry(tiny_root, tmp_path):
    root = str(tmp_path)
    import shutil
    shutil.copytree(os.path.join(tiny_root, "portbench"),
                    os.path.join(root, "portbench"))
    with open(os.path.join(tiny_root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["per_layer"].append({
        "name": "train.units_in_stretch", "unit": "steps", "better": "higher",
        "source": "program_counter", "layer": "step / request driver",
        "moves": "train_rays_per_s", "workloads": ["tiny.train"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    with open(os.path.join(root, "portbench", "metrics",
                           "train.units_in_stretch.py"), "w") as f:
        f.write("def read(ctx):\n    return ctx.stretch_units or None\n")
    plan = run.plan_cell(root, "tiny.train")
    assert "train.units_in_stretch" in {m["name"] for m in plan.per_layer}
    ctx = run.Context(cell=None, window={}, setup_s=1.0, stretch_units=7)
    assert run.read_metrics(plan, ctx, plan.per_layer[-1:]) == {
        "train.units_in_stretch": {"value": 7.0, "unit": "steps"}}


@pytest.mark.parametrize("kind", ["train", "render"])
def test_tiny_cell_runs_and_result_line_has_its_schema(tiny_root, kind):
    plan = run.plan_cell(tiny_root, f"tiny.{kind}")
    out = run.run_cell(plan, 2 ** 31 + 17, 0.5, False, device="cpu")
    json.loads(json.dumps(out))
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "check"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    assert set(out["metrics"]) == {f"{kind}_rays_per_s", "setup_s"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for v in out["check"].values():
        assert set(v) == {"value", "limit"}


def test_run_without_a_card_fails_and_prints_no_result():
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "lego.train", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0
    assert "{" not in p.stdout
    assert "CUDA card" in p.stderr


@pytest.mark.parametrize("name,caught", [
    ("jax", True), ("jax.numpy", True), ("jaxlib", True), ("flax.linen", True),
    ("pointnerf_tpu", True), ("pointnerf_tpu.ops.query", True),
    ("pointnerf_tpu_torch", False), ("jaxtyping", False),
    ("pointnerf_tpu_torch_extra", False)])
def test_import_guard_compares_whole_top_level_names(monkeypatch, name,
                                                     caught):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    found = run.forbidden_modules()
    assert (name.split(".")[0] in found) is caught


def test_guard_fails_the_run_and_prints_no_result(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "run_cell", lambda *a, **k: {
        "correct": True, "check": {}})
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc = run.main(["--workload", "lego.train", "--seconds", "1"])
    cap = capsys.readouterr()
    assert rc != 0 and "{" not in cap.out and "jax" in cap.err


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
def test_card_run_prints_a_correct_line(card):
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "lego.train", "--seed", "5", "--seconds", "2",
                        "--trace", "1"], cwd=ROOT, capture_output=True,
                       text=True)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["busy_s"] > 0


def _imports(path):
    import ast
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    base = os.path.join(ROOT, "portbench", sub)
    for dirpath, _d, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not set(_imports(path)) & set(run.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        assert "pointnerf_tpu_torch" not in set(_imports(path)), path


class _FakeMeter:
    """Stands in for trace.WindowMeter on the CPU: 2 ms of device time a
    unit."""

    def __init__(self):
        self.busy_s, self.segments, self.started = 0.0, 0, False

    def warm(self):
        pass

    def start(self, now):
        self.started = True

    def tick(self, now):
        self.busy_s += 2e-3

    def stop(self):
        self.busy_s += 2e-3
        self.segments += 1


def test_device_clock_metric_reads_the_whole_window(tiny_root, tmp_path,
                                                    monkeypatch):
    """A cell whose end-to-end metrics include one of the device's clock
    runs its untraced window under the meter and reads it per unit."""
    import shutil
    from portbench import trace
    root = str(tmp_path)
    shutil.copytree(os.path.join(tiny_root, "portbench"),
                    os.path.join(root, "portbench"))
    with open(os.path.join(tiny_root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for m in bench["end_to_end"]:
        if m["name"] == "train_device_ms_per_step":
            m["workloads"].append("tiny.train")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    made = []
    monkeypatch.setattr(trace, "WindowMeter",
                        lambda: made.append(_FakeMeter()) or made[-1])
    plan = run.plan_cell(root, "tiny.train")
    out = run.run_cell(plan, 2 ** 31 + 19, 0.5, False, device="cpu")
    assert len(made) == 1 and made[0].started
    assert out["metrics"]["train_device_ms_per_step"]["value"] == \
        pytest.approx(2.0)
    assert out["metrics"]["train_device_ms_per_step"]["unit"] == "ms"


def test_scene241_train_is_judged_by_its_device_time():
    """The cell whose host sets the pace reports the device's time a step
    end to end, and its rate per layer."""
    plan = run.plan_cell(ROOT, "scene241.train")
    e2e = {m["name"]: m for m in plan.end_to_end}
    assert set(e2e) == {"train_device_ms_per_step", "setup_s"}
    assert e2e["train_device_ms_per_step"]["source"] == "device_trace"
    per = {m["name"] for m in plan.per_layer}
    assert "train_dev.rays_per_s" in per
    assert all(m["moves"] == "train_device_ms_per_step"
               for m in plan.per_layer)
    lego = run.plan_cell(ROOT, "lego.train")
    assert {m["name"] for m in lego.end_to_end} == {"train_rays_per_s",
                                                   "setup_s"}
