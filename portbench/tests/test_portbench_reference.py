"""The plain reference against the port's plain path at a tiny size: the
integer decisions equal, the numbers of the check at float32 rounding when
the program decodes in float32."""
import json

import pytest
import torch

from portbench import run
from portbench.cell import Cell
from portbench.reference import check, plain
from portbench.tests.tinycell import add_tiny_cells


@pytest.fixture(scope="module")
def plans(tmp_path_factory):
    root = add_tiny_cells(str(tmp_path_factory.mktemp("bench")))
    return {k: run.plan_cell(root, f"tiny.{k}") for k in ("train", "render")}


def _f32(plan):
    cfg = json.loads(json.dumps(plan.config))
    cfg["pointnerf"]["train"]["compute_dtype"] = "f32"
    return cfg


def test_neighbors_and_shading_points_equal_the_programs(plans):
    from pointnerf_tpu_torch.ops.query import (generate_shading_points,
                                               knn_query)
    plan = plans["render"]
    cell = Cell(plan.config, plan.traffic, 3, "cpu")
    cell.setup()
    cam, item = cell.frame_item(0)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    raydir, campos, rot = t(item["raydir"]), t(cam.campos), t(cam.rot)
    q = cell.cfg.query
    loc_w, mask = generate_shading_points(
        cell.grid, campos, raydir, cell.cfg.render.near_plane,
        cell.cfg.render.far_plane, q)
    pid, _d2 = knn_query(loc_w, mask, cell.pc.xyz, cell.grid, q)
    geo = plain.Geometry(cell.pts0.xyz, cell.raw["query"])
    depths = plain.ray_depths(raydir.shape[0], q.z_depth_dim,
                              cell.cfg.render.near_plane,
                              cell.cfg.render.far_plane, 0.0, None, "cpu")
    rloc, rmask = plain.shading_points(geo, campos, raydir, depths, q.SR)
    assert torch.equal(rmask, mask) and torch.equal(rloc, loc_w)
    assert mask.any()
    flat = mask.reshape(-1)
    rp = geo.knn(loc_w.reshape(-1, 3)[flat], flat[flat])
    assert torch.equal(rp, pid.reshape(-1, q.K)[flat].long())


def test_train_readings_at_float32(plans):
    plan = plans["train"]
    cell = Cell(_f32(plan), plan.traffic, 11, "cpu")
    cell.setup()
    prog = cell.program_train_readings()
    n = check.train_numbers(prog, cell.reference_train())
    assert n["loss_gap"] < 1e-5 and n["grad_gap"] < 1e-5
    assert n["change_gap"] < 1e-4


def test_render_readings_at_float32(plans):
    plan = plans["render"]
    cell = Cell(_f32(plan), plan.traffic, 12, "cpu")
    cell.setup()
    cell.unit()
    cols = [s["color"] for s in cell.samples]
    masks = [s["mask"] for s in cell.samples]
    rc, rm = cell.reference_colors()
    n, _ = check.render_numbers(cols, masks, rc, rm)
    assert n["mask_mismatch"] == 0
    assert n["color_gap"] < 1e-4
