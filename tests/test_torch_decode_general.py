"""The general decode kernels' layout on the CPU (the kernels themselves,
csrc/fused_decode_any.cu and csrc/fused_decode_bwd_any.cu, run on the card:
tests/test_torch_cuda.py).

- The zero padding they rely on is exact: a mirror of their padded
  arithmetic in PyTorch — every layer width padded to the product's
  granularity with the weights and biases as `pack_any_weights` /
  `pack_any_bias` lay them out, extras at columns [H, H + E) of the block3
  input, and the rows padded to whole tiles with rows that have no source
  (x = 0, w = 0, zero upstream gradients) — gives `fused_decode_plain`'s
  and `fused_decode_bwd_plain`'s outputs within 1e-6 of each one's scale,
  in both roundings, and zero in every padded entry of dW / db and of the
  input gradient. Both sides run their products in float64 with the same
  rounding points, so that no summation order moves a bf16 rounding.
- `pack_any_weights` round-trips to the weights with zeros in every pad, on
  the tensor cores (bf16, one stream) and on the CUDA cores (f32, the W^T
  stream too).
- `general_plan`, the Python mirror of the kernels' tile planner: whole
  groups per tile and the padding rows the source states, for K in {1, 3,
  6, 8, 12, 64, 100}; the H = 512 and K = 6 plans in shared memory; the one
  workspace placement.
- `route` takes the general kernels for exactly the specs it took before.
- `fused_decode_bwd_plain` fed branch masks (another side's leaky-ReLU
  branches, as the card tests feed it the general K4's): its own give the
  same bits, and one flipped branch moves that row's gradients alone.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pointnerf_tpu_torch.ops import fused_decode as fd
from pointnerf_tpu_torch.ops.fused_decode import (DecodeSpec, build_x,
                                                  fused_decode_bwd_plain,
                                                  fused_decode_plain,
                                                  general_pads, general_plan,
                                                  layer_inputs,
                                                  pack_any_bias,
                                                  pack_any_weights,
                                                  prep_weights, route)


def _spec(**kw):
    d = dict(Fi=32, Dd=6, E=7, Ff=3, Fd=5, H=256, K=8, L1=2, L3=2,
             neg_slope=0.01, bf16=True)
    d.update(kw)
    return DecodeSpec(**d)


def _case(spec, G, seed=3):
    rng = np.random.RandomState(seed)
    M, H = G * spec.K, spec.H
    ins = [torch.from_numpy(rng.normal(0, s, (M, n)).astype(np.float32))
           for s, n in ((0.5, spec.Fi), (0.05, spec.Dd), (0.5, spec.E))]
    w = rng.rand(M, 1) * (rng.rand(M, 1) > 0.3)
    ins.append(torch.from_numpy(w.astype(np.float32)))
    g = torch.Generator().manual_seed(seed)

    def dense(n):
        return {"w": torch.randn((n, H), generator=g) * (2.0 / n) ** 0.5,
                "b": torch.randn((H,), generator=g) * 0.1}
    dims = layer_inputs(spec)
    params = {"block1": [dense(n) for n in dims[:spec.L1]],
              "block3": [dense(n) for n in dims[spec.L1:]],
              "alpha": [{"w": torch.randn((H, 1), generator=g) * 0.1,
                         "b": torch.zeros((1,))}]}
    gf = torch.from_numpy(rng.normal(0, 1, (G, H)).astype(np.float32))
    ga = torch.from_numpy(rng.normal(0, 1, (G, 1)).astype(np.float32))
    return ins, params, gf, ga


def _unpack(buf, spec, plan):
    """The padded [kp_l, Hp] weights of each layer from the packed buffer
    (the forward stream)."""
    out, off = [], 0
    for kp in general_pads(spec, plan):
        out.append(buf[off:off + kp * plan.Hp].view(kp, plan.Hp))
        off += kp * plan.Hp
    return out, off


def _mirror(ins, params, spec, gf, ga):
    """The general kernels' padded forward and backward in float64: returns
    (fagg, alpha), (g_w, g_extras, the padded input gradient g_x [Mp, kp0],
    the padded dW_l [kp_l, Hp] and db_l [Hp], dwa, dba)."""
    plan = general_plan(spec)
    H, E, K, L1, L = spec.H, spec.E, spec.K, spec.L1, spec.L1 + spec.L3
    Hp, pads = plan.Hp, general_pads(spec, plan)
    dt = torch.float64
    r = lambda t: fd._round(t.float(), spec.bf16).to(dt)   # noqa: E731
    Ws, bs, wa, ba = prep_weights(params, spec)
    Wp = [t.to(dt) for t in _unpack(pack_any_weights(Ws, spec, plan),
                                    spec, plan)[0]]
    bias = pack_any_bias(bs, spec, plan).view(L, Hp).to(dt)
    feat, dists, extras, w = (r(t) for t in ins)
    M = feat.shape[0]
    pr = -M % plan.T                         # rows with no source
    x = r(build_x(feat.float(), dists.float(), spec))
    h = F.pad(x, (0, pads[0] - spec.x1, 0, pr))
    ex = F.pad(extras, (0, 0, 0, pr))
    wr = F.pad(w, (0, 0, 0, pr))
    acts, zs = [], []
    for i in range(L):
        if i == L1:
            h = torch.cat([h[:, :H], ex, h.new_zeros((M + pr,
                                                      pads[i] - H - E))], 1)
        acts.append(h)
        zs.append(h @ Wp[i] + bias[i])
        h = r(torch.where(zs[-1] > 0, zs[-1], zs[-1] * spec.neg_slope))
    assert not bool(h[:, H:].any())          # the padded columns stay 0
    wap = F.pad(wa.to(dt), (0, Hp - H))
    za = h @ wap + ba.to(dt)
    G = M // K
    fagg = (h[:M, :H] * w).view(G, K, H).sum(1)
    alpha = (fd._softplus(za[:M, None] - 1.0) * w).view(G, K).sum(1)
    g_f = F.pad(gf.to(dt).repeat_interleave(K, 0), (0, Hp - H, 0, pr))
    g_a = F.pad(ga.to(dt).repeat_interleave(K, 0), (0, 0, 0, pr))
    g_w = (h * g_f).sum(1, keepdim=True) + fd._softplus(za[:, None] - 1.0) \
        * g_a
    g_za = g_a * wr * torch.sigmoid(za[:, None] - 1.0)
    dwa, dba = (h * g_za).sum(0)[:H], g_za.sum(0)
    g_h = g_f * wr + g_za * wap
    dWs, dbs = [None] * L, [None] * L
    for i in reversed(range(L)):
        g_z = g_h * torch.where(zs[i] > 0, 1.0, spec.neg_slope)
        dbs[i] = g_z.sum(0)
        g_zr = r(g_z)
        dWs[i] = acts[i].t() @ g_zr
        g_h = g_zr @ Wp[i].t()
        if i == L1:
            g_extras = g_h[:M, H:H + E]
            g_h = F.pad(g_h[:, :H], (0, Hp - H))
    return ((fagg.float(), alpha.float()[:, None]),
            (g_w[:M].float(), g_extras.float(), g_h, dWs, dbs, dwa.float(),
             dba.float()))


PAD_CASES = {"h48": dict(H=48, L1=1, L3=2),
             "k6": dict(K=6, H=64),
             "e0_x20": dict(Fi=4, Dd=3, E=0, Ff=2, Fd=0, H=20, L1=1, L3=1),
             "k100": dict(H=40, K=100, L1=1, L3=1)}


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("case", sorted(PAD_CASES))
def test_padding_is_exact(case, bf16):
    spec = _spec(bf16=bf16, **PAD_CASES[case])
    plan = general_plan(spec)
    G = 2 * plan.gpt + 1 if spec.K <= plan.T else 3
    ins, params, gf, ga = _case(spec, G)
    (fm, am), (gw, gex, gx, dWs, dbs, dwa, dba) = _mirror(ins, params, spec,
                                                          gf, ga)
    fp, ap = fused_decode_plain(*ins, params, spec, dtype=torch.float64)
    _gf, _gd, gex_p, gw_p, gp = fused_decode_bwd_plain(
        *ins, params, spec, gf, ga, dtype=torch.float64)
    H, L = spec.H, spec.L1 + spec.L3
    pads, ins_w = general_pads(spec, plan), layer_inputs(spec)
    dW_p = [layer["w"] for n in ("block1", "block3") for layer in gp[n]]
    db_p = [layer["b"] for n in ("block1", "block3") for layer in gp[n]]
    pairs = [(fm, fp), (am, ap), (gw, gw_p), (gex, gex_p),
             (dwa, gp["alpha"][0]["w"].reshape(-1)),
             (dba, gp["alpha"][0]["b"])]
    for i in range(L):
        assert tuple(dWs[i].shape) == (pads[i], plan.Hp)
        assert not bool(dWs[i][ins_w[i]:].any())
        assert not bool(dWs[i][:, H:].any())
        assert not bool(dbs[i][H:].any())
        pairs += [(dWs[i][:ins_w[i], :H].float(), dW_p[i]),
                  (dbs[i][:H].float(), db_p[i])]
    assert not bool(gx[:, spec.x1:].any())
    assert not bool(gx[ins[0].shape[0]:].any())   # rows with no source
    for a, b in pairs:
        assert a.shape == b.shape
        if not b.numel():
            continue                    # no extras (E = 0)
        s = float(b.abs().max())
        assert s > 0
        assert float((a - b).abs().max()) <= 1e-6 * s


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("kw", [dict(H=48), dict(H=320, L1=1, L3=1),
                                dict(Fi=8, Ff=0, Fd=0, E=0, H=20, K=100,
                                     L1=1, L3=1)])
def test_pack_any_weights_round_trip(kw, bf16):
    """Every weight reads back from its padded block (both streams on the
    CUDA cores), and every pad is zero."""
    spec = _spec(bf16=bf16, **kw)
    plan = general_plan(spec, backward=True)
    assert plan.kind == ("tensor_cores" if bf16 else "cuda_cores")
    g = torch.Generator().manual_seed(0)
    Ws = [torch.randn((n, spec.H), generator=g).to(torch.bfloat16).float()
          for n in layer_inputs(spec)]
    buf = pack_any_weights(Ws, spec, plan, backward=True)
    assert buf.dtype == (torch.bfloat16 if bf16 else torch.float32)
    blocks, n = _unpack(buf, spec, plan)
    pads = general_pads(spec, plan)
    assert buf.numel() == n * (1 if bf16 else 2)
    off = n
    for W, kp, blk in zip(Ws, pads, blocks):
        k = W.shape[0]
        views = [blk.float()]
        if not bf16:
            views.append(buf[off:off + kp * plan.Hp].view(plan.Hp, kp).t())
            off += kp * plan.Hp
        for t in views:
            assert torch.equal(t[:k, :spec.H], W)
            assert not bool(t[k:].any()) and not bool(t[:, spec.H:].any())
    bias = pack_any_bias([torch.ones(spec.H)] * len(Ws), spec, plan)
    assert bias.shape == (len(Ws) * plan.Hp,)
    assert float(bias.sum()) == len(Ws) * spec.H


@pytest.mark.parametrize("K", [1, 3, 6, 8, 12, 64, 100])
@pytest.mark.parametrize("bf16", [True, False])
def test_general_plan_whole_groups(K, bf16):
    """A K3 item holds whole groups: T // K of them and T - (T // K) K rows
    with no source where K <= T (K = 6 at T = 64: 10 groups, 60 rows and 4
    padding rows), else one group in ceil(K / T) slabs of T rows."""
    spec = _spec(K=K, H=48, bf16=bf16)
    p = general_plan(spec)
    assert p.T in fd.GENERAL_TILES and p.ws == 0
    assert p.smem <= fd.SMEM_BYTES
    if K <= p.T:
        assert (p.gpt, p.slabs) == (p.T // K, 1)
        assert 0 <= p.T - p.gpt * K < K
    else:
        assert p.gpt == 1 and p.slabs == -(-K // p.T)
        assert (p.slabs - 1) * p.T < K <= p.slabs * p.T
    if K == 6:
        assert p.T == 64 and p.gpt * K == 60


def test_general_plan_phase30_shapes():
    """The phase-30 shapes plan in shared memory: bench widths at H = 512
    (K3 bf16 on the tensor cores with 64-row tiles, K4 with 32; f32 on the
    CUDA cores with 32) and at K = 6 (64-row tiles); pads to 32 on the
    tensor cores, 16 on the CUDA cores."""
    want = {(512, 8, True, False): ("tensor_cores", 64),
            (512, 8, True, True): ("tensor_cores", 32),
            (512, 8, False, False): ("cuda_cores", 32),
            (512, 8, False, True): ("cuda_cores", 32),
            (256, 6, True, False): ("tensor_cores", 64),
            (256, 6, True, True): ("tensor_cores", 64),
            (256, 6, False, False): ("cuda_cores", 64)}
    for (H, K, bf16, bwd), (kind, T) in want.items():
        p = general_plan(_spec(H=H, K=K, bf16=bf16), backward=bwd)
        assert (p.kind, p.T, p.ws) == (kind, T, 0), (H, K, bf16, bwd)
        assert p.smem <= fd.SMEM_BYTES
        assert (p.Hp, p.kp0, p.kpE) == (
            (H, 288, 288 if H == 256 else 544) if bf16 else
            (H, 288, 272 if H == 256 else 528))


def test_general_plan_workspace_case():
    """The one workspace placement: a first layer 1,744 wide (f32) is past
    a CUDA-core tile of 16 rows; in bf16 K3 still fits a tensor-core tile
    of 16 rows, and K4 does from a 2,880-wide one on."""
    spec = _spec(Fi=240, H=40, L1=1, L3=1, bf16=False)
    for bwd in (False, True):
        p = general_plan(spec, backward=bwd)
        assert (p.kind, p.T) == ("cuda_cores", 64) and p.ws > 0
    p = general_plan(spec._replace(bf16=True))
    assert (p.kind, p.T, p.ws) == ("tensor_cores", 16, 0)
    wide = _spec(Fi=400, H=40, L1=1, L3=1)
    assert general_plan(wide).kind == "tensor_cores"
    p = general_plan(wide, backward=True)
    assert (p.kind, p.T) == ("cuda_cores", 64) and p.ws > 0


@pytest.mark.parametrize("kw,fwd,bwd", [
    ({}, "tensor_core", "tensor_core"),           # bench_config
    (dict(bf16=False), "cuda_core", "cuda_core"),
    (dict(H=48), "general", "general"),
    (dict(H=320), "general", "general"),
    (dict(H=512, bf16=False), "general", "general"),
    (dict(K=6), "general", "general"),
    (dict(K=6, bf16=False), "general", "general"),
    (dict(L1=5, L3=4), "general", "general"),
    (dict(Fi=64), "general", "general"),          # x1 = 508 > 320 in bf16
    (dict(Fi=40, bf16=False), "cuda_core", "cuda_core"),
    (dict(Fi=64, bf16=False), "cuda_core", "general"),
    (dict(Fi=8, Ff=0, Fd=0, E=0, H=20, K=100, L1=1, L3=1), "general",
     "general"),
])
def test_route_unchanged(kw, fwd, bwd):
    """`route` returns the general kernels for the specs it returned them
    for before their redesign (tests/test_torch_decode.py's table)."""
    spec = _spec(**kw)
    assert route(spec) == fwd
    assert route(spec, backward=True) == bwd


def _branches(ins, params, spec):
    """Each layer's z > 0 [M, H] as `fused_decode_bwd_plain` computes it."""
    r = lambda t: fd._round(t.float(), spec.bf16)   # noqa: E731
    feat, dists, extras, _w = [r(t) for t in ins]
    Ws, bs, _wa, _ba = prep_weights(params, spec)
    h, masks = r(build_x(feat, dists, spec)), []
    for i in range(spec.L1 + spec.L3):
        if i == spec.L1:
            h = torch.cat([h, extras], -1)
        z = h @ Ws[i] + bs[i]
        masks.append(z > 0)
        h = r(torch.where(masks[-1], z, z * spec.neg_slope))
    return masks


@pytest.mark.parametrize("bf16", [True, False])
def test_plain_bwd_fed_branches(bf16):
    """Fed its own branches the plain backward gives the same bits; fed one
    flipped branch (layer 1, a row with weight), that row's gradients move
    and no other row's."""
    from pointnerf_tpu_torch.train.optim import tree_leaves
    spec = _spec(H=48, K=6, bf16=bf16)
    ins, params, gf, ga = _case(spec, 20)
    own = tree_leaves(fused_decode_bwd_plain(*ins, params, spec, gf, ga))
    masks = _branches(ins, params, spec)
    fed = tree_leaves(fused_decode_bwd_plain(*ins, params, spec, gf, ga,
                                             masks=masks))
    for a, b in zip(own, fed):
        assert torch.equal(a, b)
    row = int((ins[3][:, 0] != 0).nonzero()[0])
    flipped = [m.clone() for m in masks]
    flipped[1][row, 3] = ~flipped[1][row, 3]
    moved = tree_leaves(fused_decode_bwd_plain(*ins, params, spec, gf, ga,
                                               masks=flipped))
    other = torch.ones(ins[0].shape[0], dtype=torch.bool)
    other[row] = False
    for a, b in zip(own[:4], moved[:4]):
        assert torch.equal(a[other], b[other])
    assert not torch.equal(own[0][row], moved[0][row])
