"""The yardstick's arithmetic on hand-computed cases."""
import pytest
import torch

from portbench import counting as c
from portbench.trace import reduce_events

W = c.Widths(Fi=2, Dd=1, E=1, Ff=0, Fd=0, H=4, K=2, L1=1, L3=1, bf16=True)


def test_decode_counts():
    assert W.x1 == 3
    assert c.layer_inputs(W) == [3, 5]
    assert c.decode_flops(10, W) == 2 * 10 * (3 * 4 + 5 * 4 + 4)
    assert c.param_count(W) == (3 * 4 + 4) + (5 * 4 + 4) + 4 + 1
    nbytes, ops, t, by = c.decode_bound(10, 12, W)
    assert (nbytes, ops, by) == (10 * 5 * 4 + 45 * 4 + 6 * 5 * 4, 720,
                                 "bytes")
    assert t == pytest.approx(500 / 3.35e12)
    nbytes, ops, t, by = c.decode_bound(10, 12, W, backward=True)
    assert (nbytes, ops) == (500 + 12 * 4 + 12 * 5 * 4 + 45 * 4, 2160)


def test_decode_bound_by_operations_on_the_f32_peak():
    w = W._replace(H=256, bf16=False)
    _b, ops, t, by = c.decode_bound(1000, 1000, w)
    assert by == "operations" and t == pytest.approx(ops / 67e12)


def test_color_and_march_counts():
    assert c.color_flops(5, [4, 3, 2]) == 2 * 5 * (12 + 6)
    nbytes, flops, t, by = c.k2_bound(2, 3, 3)
    assert (nbytes, flops, by) == (6 * 21 + 12 + 24 + 24 + 8, 90, "bytes")


def test_k1_stats_and_bound():
    dead = 1e8
    nbr_xyz = torch.tensor([[0.0, dead, 0.0, dead, 0.0, dead],
                            [1.0, 2.0, 1.0, 2.0, 1.0, 2.0]])
    dslot = torch.tensor([0, 0, 1, -1], dtype=torch.int32)
    ok = torch.tensor([True, True, True, True])
    pid = torch.tensor([[5, -1], [5, -1], [7, 8], [-1, -1]],
                       dtype=torch.int32)
    st = c.k1_stats(nbr_xyz, dslot, ok, pid)
    assert st == {"selecting": 3, "distinct_rows": 2, "live_in_rows": 3,
                  "live_of_selecting": 4, "winners": 3}
    nbytes, flops, _t, by = c.k1_bound(st, C=4, QP=2, K=2)
    assert (nbytes, flops, by) == (16 + 24 + 12 + 36 + 20 + 64, 32, "bytes")


class _Ev:
    def __init__(self, name, s, e, cuda):
        self.name = name
        self.time_range = type("R", (), {"start": s, "end": e})()
        self.device_type = (torch.autograd.DeviceType.CUDA if cuda
                            else torch.autograd.DeviceType.CPU)


def test_trace_busy_union_and_idle_gaps_by_innermost_range():
    ev = [_Ev("k1", 0, 10, True), _Ev("k2", 5, 15, True),
          _Ev("k1", 30, 40, True), _Ev("a", 12, 50, False),
          _Ev("b", 20, 25, False), _Ev("a", 12, 50, True)]
    tr = reduce_events(ev, 50e-6, {"a", "b"})
    assert tr.busy_s == pytest.approx(25e-6)
    assert tr.kernels == {"k1": [2, pytest.approx(20e-6)],
                          "k2": [1, pytest.approx(10e-6)]}
    assert tr.gaps == {"b": pytest.approx(15e-6)}
    assert tr.seconds(("k1",)) == pytest.approx(20e-6)
    bd = tr.breakdown()
    assert bd["device_ops"][0][0] == "k1" and bd["idle_gaps"][0][0] == "b"


def test_merge_intervals_is_the_union():
    from portbench.trace import merge_intervals
    assert merge_intervals([]) == []
    assert merge_intervals([(5, 7), (0, 2), (1, 3), (3, 4), (6, 6.5)]) == [
        [0, 4], [5, 7]]
