"""Run one cell of the port's benchmark once, and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with an NVIDIA card. The cell, its
configuration, its traffic mix and its metrics are found by name:
`BENCHMARK.json` names them, `portbench/configs/<config>.json` holds the
configuration as it is run, `portbench/traffic/<traffic>.json` the traffic,
`portbench/limits/<workload>.json` the limits of its check and
`portbench/metrics/<metric>.py` the reader of each metric.

The run builds the cell from the seed (set-up: the scene, the weights, the
grid and tables, the kernels' build on a checkout's first run, the warm-up
of every shape the traffic uses), drives it for `--seconds` (with
`--trace 1`, then a short profiled stretch), reads the peak memory, frees
the program's state and checks what the window produced against the plain
reference. The last line of standard output is one JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error and the last key of that object.

`--readings` (not a benchmark run) prints, for each of the given seeds, the
numbers of the check for the program, for the control (the reference with
its products in float8) and for the faults a cell can have: the readings
the limits are set from.
"""
import time

T0 = time.time()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, NamedTuple, Optional  # noqa: E402

# one process, one host thread of math: the loop's host side is Python
# dispatch, and idle OpenMP / BLAS workers spinning beside it on a shared
# host make the rates swing from run to run
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# module names (top-level, compared whole) that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "pointnerf_tpu")


class Plan(NamedTuple):
    """Everything BENCHMARK.json and the cell's files say about one cell."""
    workload: Dict
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]
    metrics_dir: str


def _load_json(path: str):
    with open(path) as f:
        return json.load(f)


def plan_cell(root: str, name: str) -> Plan:
    """Find a cell's files by the names in `root`/BENCHMARK.json."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    wl = {w["name"]: w for w in bench["workloads"]}.get(name)
    if wl is None:
        raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")
    cfg = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    here = os.path.join(root, "portbench")
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if name in m.get("workloads", [name] if m["moves"] in reported
                            else [])]
    return Plan(workload=wl,
                config=_load_json(os.path.join(root, cfg["file"])),
                traffic=_load_json(os.path.join(here, "traffic",
                                                wl["traffic"] + ".json")),
                limits=_load_json(os.path.join(here, "limits",
                                               name + ".json")),
                end_to_end=e2e, per_layer=per,
                metrics_dir=os.path.join(here, "metrics"))


def reader(metrics_dir: str, name: str):
    """The `read(ctx)` function of portbench/metrics/<name>.py."""
    path = os.path.join(metrics_dir, name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Context(NamedTuple):
    """What a metric reader gets: the cell, the window's counts, the set-up
    time and, in a traced run, the stretch's trace, calls and units."""
    cell: object
    window: Dict[str, float]
    setup_s: float
    trace: Optional[object] = None
    calls: Optional[object] = None
    stretch_units: int = 0


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def read_metrics(plan: Plan, ctx: Context, which: List[Dict]) -> Dict:
    out = {}
    for m in which:
        v = reader(plan.metrics_dir, m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def check_cell(plan: Plan, cell) -> tuple:
    """(correct, failed units, {name: {"value", "limit"}}) of the window's
    output; frees the program's state first."""
    from portbench.reference import check
    if cell.kind == "train":
        prog = cell.program_train_readings()
        cell.free_program()
        numbers = check.train_numbers(prog, cell.reference_train())
        ok, checked = check.judge(numbers, plan.limits)
        return ok, 0 if ok else len(prog["losses"]), checked
    cols = [s["color"] for s in cell.samples]
    masks = [s["mask"] for s in cell.samples]
    cell.free_program()
    ref_cols, ref_masks = cell.reference_colors()
    numbers, per_frame = check.render_numbers(cols, masks, ref_cols,
                                              ref_masks)
    ok, checked = check.judge(numbers, plan.limits)
    failed = sum(1 for bad, gap in per_frame
                 if bad > plan.limits["mask_mismatch"]
                 or gap > plan.limits["color_gap"])
    return ok, failed, checked


def _per_tenth(win) -> List[int]:
    """Units ended in each tenth of the window (host clock, for reading
    how steady a run was)."""
    edges = [win["wall_s"] * (i + 1) / 10 for i in range(10)]
    out, i = [0] * 10, 0
    for t in win["unit_ends_s"]:
        while i < 9 and t > edges[i]:
            i += 1
        out[i] += 1
    return out


def run_cell(plan: Plan, seed: int, seconds: float, trace: bool,
             device: str = "cuda") -> Dict:
    """One run of the cell; returns the result object."""
    import torch
    from portbench.cell import Cell
    from portbench.trace import Calls, WindowMeter, traced
    torch.set_num_threads(1)
    cell = Cell(plan.config, plan.traffic, seed, device)
    cell.setup()
    # an end-to-end metric of the device's own clock reads the whole
    # window's busy time; the untraced window of a --trace 1 run stays bare
    meter = None
    if not trace and any(m["source"] == "device_trace"
                         for m in plan.end_to_end):
        meter = WindowMeter()
        meter.warm()
    setup_s = time.time() - T0
    win = cell.window(seconds, meter)
    print(f"portbench: {win['units']} units in {win['wall_s']:.3f} s; units "
          f"a tenth of the window: {_per_tenth(win)}", file=sys.stderr)
    if "device_busy_s" in win:
        print(f"portbench: device busy {win['device_busy_s']:.6f} s of the "
              f"window, read in {win['device_segments']} segments",
              file=sys.stderr)
    ctx = Context(cell=cell, window=win, setup_s=setup_s)
    dev_info = {"platform": "gpu" if device == "cuda" else device,
                "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                         else device),
                "count": plan.workload["chips"]}
    result = {}
    if trace:
        calls = Calls()
        n = plan.traffic["traced_units"]
        tr = traced(lambda: [cell.unit() for _ in range(n)], calls)
        ctx = ctx._replace(trace=tr, calls=calls, stretch_units=n)
        result["metrics"] = read_metrics(plan, ctx, plan.per_layer)
        calls.k1.clear()        # they hold the program's tables
        dev_info["busy_s"] = tr.busy_s
        dev_info["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    else:
        result["metrics"] = read_metrics(plan, ctx, plan.end_to_end)
    dev_info["memory_peak_bytes"] = (
        int(torch.cuda.max_memory_allocated(0)) if device == "cuda" else 0)
    correct, failed, checked = check_cell(plan, cell)
    out = {"correct": bool(correct), "attempted": int(win["units"]),
           "failed": int(failed), "metrics": result["metrics"],
           "device": dev_info}
    if "breakdown" in result:
        out["breakdown"] = result["breakdown"]
    out["check"] = checked
    return out


def readings(plan: Plan, seeds: List[int], device: str = "cuda",
             full: int = 3) -> None:
    """Print one JSON line per seed with the check's numbers for the
    program and, on the first `full` seeds, for the control and each fault
    the cell can have."""
    from portbench import faults
    from portbench.cell import Cell
    from portbench.reference import check
    for i, seed in enumerate(seeds):
        t0 = time.time()
        cell = Cell(plan.config, plan.traffic, seed, device)
        cell.setup()
        line = {"seed": seed, "kind": cell.kind}
        if cell.kind == "train":
            prog = cell.program_train_readings()
            half = faults.replay_half_batch(cell) if i < full else None
            cell.free_program()
            ref = cell.reference_train()
            line["program"] = check.train_numbers(prog, ref)
            line["worst"] = check.worst_leaves(prog, ref)
            if i < full:
                ctl = cell.reference_train(quant="fp8")
                line["control"] = check.train_numbers(ctl, ref)
                line["half_batch"] = check.train_numbers(half, ref)
                # a step that returns its state unchanged leaves Adam's
                # moments at zero and every leaf where it was
                line["frozen_state"] = check.train_numbers(
                    dict(prog, grad={k: 0.0 for k in prog["grad"]},
                         change={k: 0.0 for k in prog["change"]}), ref)
        else:
            for _ in range(plan.traffic["readings_frames"]):
                cell.unit()
            cols = [s["color"] for s in cell.samples]
            masks = [s["mask"] for s in cell.samples]
            W, H = cell.scene.wh
            with faults.altered_answer(-(-W * H // plan.traffic["chunk"])):
                cell.unit()
            bad = cell.samples.pop()
            cell.free_program()
            ref_c, ref_m = cell.reference_colors()
            line["program"] = check.render_numbers(cols, masks, ref_c,
                                                   ref_m)[0]
            if i < full:
                ctl_c, ctl_m = cell.reference_colors(quant="fp8")
                line["control"] = check.render_numbers(ctl_c, ctl_m, ref_c,
                                                       ref_m)[0]
                cell.samples = [bad]
                rb_c, rb_m = cell.reference_colors()
                line["altered_answer"] = check.render_numbers(
                    [bad["color"]], [bad["mask"]], rb_c, rb_m)[0]
        line["seconds"] = time.time() - t0
        print(json.dumps(line), flush=True)
        del cell
        import torch
        if device == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--readings", type=int, nargs="*", default=None,
                   metavar="SEED", help="print the check's readings for "
                   "these seeds instead of a run")
    args = p.parse_args(argv)
    plan = plan_cell(ROOT, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < plan.workload["chips"]:
        print(f"portbench: the cell needs {plan.workload['chips']} CUDA "
              f"card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f": no run on the CPU", file=sys.stderr)
        return 2
    if args.readings is not None:
        readings(plan, args.readings)
        return 0
    out = run_cell(plan, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}: the benchmark measures the "
              f"PyTorch port alone", file=sys.stderr)
        return 3
    for k, v in out["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
