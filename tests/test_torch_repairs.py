"""A fault of the port against the JAX package, with a planted case.

- Leaky ReLU at exactly 0: jax.nn.leaky_relu and flax's nn.leaky_relu are
  where(x >= 0, x, s x), slope 1 at 0, where torch's F.leaky_relu has slope
  s. A hidden unit whose weight column and bias are zero has a
  pre-activation of exactly 0 on every row; the gradients into it are held
  against JAX's at 2e-4 of scale, in the unfused decode
  (models/aggregator._act) and in the MVS embedding's premlp
  (mvs/points_init.MvsPointsInit.embed_points)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pointnerf_tpu.models.aggregator import aggregate as j_aggregate
from pointnerf_tpu.models.points import SampledPoints as JSP
from pointnerf_tpu.mvs import points_init as jpi
from pointnerf_tpu_torch.convert import mvs_variables_from_jax, params_from_jax
from pointnerf_tpu_torch.models import aggregator as ta
from pointnerf_tpu_torch.models.points import SampledPoints as TSP
from pointnerf_tpu_torch.mvs import points_init as tpi
from test_torch_decode import _case
from test_torch_mvs import F_DIM, H, V, W, cams, jax_mvs_variables

TOL = 2e-4


def _close(got, ref, what):
    ref = np.asarray(ref, np.float64)
    err = np.abs(np.asarray(got, np.float64) - ref).max()
    assert err <= TOL * max(np.abs(ref).max(), 1e-12), (what, err)


def test_unfused_decode_leaky_relu_gradient_at_zero():
    cfg, params, sp, sl, slw, rd = _case(seed=1, R=8, SR=6, K=4)
    cfg = cfg.replace(agg=dataclasses.replace(cfg.agg, fused_decode=False))
    # hidden unit 3 of block1's first layer: pre-activation exactly 0
    b1 = params["block1"][0]
    params["block1"][0] = {"w": b1["w"].at[:, 3].set(0.0),
                           "b": b1["b"].at[3].set(0.0)}
    ct = np.random.RandomState(9).normal(
        size=(8, 6, 1 + cfg.agg.shading_color_channel_num)).astype(np.float32)

    def j_loss(p):
        out = j_aggregate(p, cfg.agg, JSP(**{k: jnp.asarray(v)
                                             for k, v in sp.items()}),
                          jnp.asarray(sl), jnp.asarray(slw), jnp.asarray(rd),
                          cfg.query.vsize, Rw2c=jnp.eye(3))
        return jnp.sum(out.features * ct)
    jg = jax.jit(jax.grad(j_loss))(params)

    tp = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    for layers in tp.values():
        for layer in layers:
            for v in layer.values():
                v.requires_grad_(True)
    out = ta.aggregate(tp, cfg.agg, TSP(**{k: torch.from_numpy(v.copy())
                                           for k, v in sp.items()}),
                       torch.from_numpy(sl), torch.from_numpy(slw),
                       torch.from_numpy(rd), cfg.query.vsize,
                       Rw2c=torch.eye(3))
    (out.features * torch.from_numpy(ct)).sum().backward()
    # the planted unit's column takes a gradient only through the slope at 0
    assert np.abs(np.asarray(jg["block1"][0]["w"][:, 3])).max() > 0
    for name in ("block1", "block3"):
        for i, layer in enumerate(tp[name]):
            for k in ("w", "b"):
                _close(layer[k].grad.numpy(), jg[name][i][k],
                       f"{name}.{i}.{k}")


def test_premlp_leaky_relu_gradient_at_zero():
    """A two-layer premlp (the activation sits between its layers)."""
    _m, variables = jax_mvs_variables()
    model = jpi.MvsPointsInit(point_features_dim=F_DIM, premlp_layers=2)
    variables = jax.tree.map(np.array, variables)
    rng = np.random.RandomState(5)
    variables["params"]["premlp_1"] = {
        "kernel": (rng.randn(F_DIM, F_DIM) / np.sqrt(F_DIM)).astype(
            np.float32),
        "bias": (0.05 * rng.randn(F_DIM)).astype(np.float32)}
    # hidden unit 5 of premlp's first layer: pre-activation exactly 0
    variables["params"]["premlp_0"]["kernel"][:, 5] = 0.0
    variables["params"]["premlp_0"]["bias"][5] = 0.0
    rng = np.random.RandomState(6)
    imgs = rng.rand(V, H, W, 3).astype(np.float32)
    feats = rng.randn(V, H // 4, W // 4, 32).astype(np.float32)
    Ks, w2cs = cams()
    xyz = np.stack([rng.uniform(-0.6, 0.6, 40), rng.uniform(-0.3, 0.3, 40),
                    rng.uniform(2.5, 5.0, 40)], -1).astype(np.float32)
    conf = rng.rand(40, 1).astype(np.float32)
    campos = np.linalg.inv(w2cs[0])[:3, 3]
    ct = rng.randn(40, F_DIM).astype(np.float32)

    def j_loss(params):
        emb = model.apply({**variables, "params": params},
                          *[jnp.asarray(a) for a in (xyz, imgs, feats, Ks,
                                                     w2cs, campos, conf)],
                          method=model.embed_points)[0]
        return jnp.sum(emb * ct)
    jg = jax.grad(j_loss)(variables["params"])

    tvars = mvs_variables_from_jax(variables, device="cpu")
    names = [k for k in tvars["params"] if k.startswith("premlp.")]
    for k in names:
        tvars["params"][k].requires_grad_(True)
    emb = tpi.mvs_apply(tpi.MvsPointsInit(point_features_dim=F_DIM,
                                          premlp_layers=2), tvars,
                        torch.tensor(xyz), tpi.images_nchw(imgs, "cpu"),
                        torch.tensor(feats.transpose(0, 3, 1, 2).copy()),
                        torch.tensor(Ks), torch.tensor(w2cs),
                        torch.tensor(campos), torch.tensor(conf),
                        method="embed_points")[0]
    (emb * torch.from_numpy(ct)).sum().backward()
    assert np.abs(np.asarray(jg["premlp_0"]["kernel"][:, 5])).max() > 0
    assert len(names) == 4
    for k in names:
        _, i, leaf = k.split(".")
        ref = jg[f"premlp_{i}"]["kernel" if leaf == "weight" else "bias"]
        ref = np.asarray(ref).T if leaf == "weight" else np.asarray(ref)
        _close(tvars["params"][k].grad.numpy(), ref, k)
