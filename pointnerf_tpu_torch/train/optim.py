"""Two-group optimization: shading MLPs vs neural-point payloads.

Counterpart of `pointnerf_tpu/train/optim.py`: `lr_schedule`, the two-group
Adam of `make_optimizer` (optax.adam per group with b1 0.9, b2 0.999,
eps 1e-8), `apply_grad_flags`, `freeze_points`, `hit_boost`, `alter_mask`,
`masked_updates` and `alternated_update`.

The Adam here is plain functions on tensors, not `torch.optim.Adam`: the
training step scales the point group's Adam *update* by `hit_boost` before
applying it, and `convert.train_state_from_jax` carries the JAX optimizer
state (mu, nu and count per group) over as it is; `torch.optim.Adam` applies
its update inside `step()` and keeps its own state layout. The arithmetic is
optax's: moments (1 - b) * g + b * m, bias correction by the group's own
count after the increment, the schedule read at the count before it, and
update = -lr * mu_hat / (sqrt(nu_hat) + eps).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

from ..config import PointNeRFConfig, PointsConfig
from ..models.points import PointCloud

B1, B2, EPS = 0.9, 0.999, 1e-8
GROUPS = ("mlp", "points")


class AdamState(NamedTuple):
    count: torch.Tensor   # [] int32: updates this group has taken
    mu: Any               # first moments, shaped like the group's params
    nu: Any               # second moments


def tree_map(fn, *trees):
    """fn over the tensor leaves of nested dicts, lists and NamedTuples."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *[x[k] for x in trees]) for k in t}
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*[tree_map(fn, *xs) for xs in zip(*trees)])
    if isinstance(t, (list, tuple)):
        return type(t)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def lr_schedule(base_lr: float, cfg: PointNeRFConfig
                ) -> Union[float, Callable[[torch.Tensor], torch.Tensor]]:
    """lr at an update count: base_lr * lr_decay_exp ** (count /
    lr_decay_iters) for "iter_exponential_decay", float32 as in JAX."""
    t = cfg.train
    if t.lr_policy == "iter_exponential_decay":
        def sched(count: torch.Tensor) -> torch.Tensor:
            e = count.float() / float(t.lr_decay_iters)
            return base_lr * torch.pow(torch.tensor(
                t.lr_decay_exp, dtype=torch.float32, device=count.device), e)
        return sched
    if t.lr_policy in ("none", ""):
        return base_lr
    raise ValueError(f"unsupported lr_policy {t.lr_policy}")


def init_optimizer(params: Dict[str, Any],
                   groups: Tuple[str, ...] = GROUPS) -> Dict[str, AdamState]:
    """Zero moments and count for each group ({"mlp", "points"}, or the
    feed-forward step's {"mlp", "mvs"})."""
    out = {}
    for g in groups:
        dev = tree_leaves(params[g])[0].device
        zeros = tree_map(torch.zeros_like, params[g])
        out[g] = AdamState(count=torch.zeros((), dtype=torch.int32,
                                             device=dev),
                           mu=zeros, nu=tree_map(torch.zeros_like, zeros))
    return out


def adam_update(grads, state: AdamState, lr, b1: float = B1,
                b2: float = B2) -> Tuple[Any, AdamState]:
    """One optax.adam step for one group: (updates, new state)."""
    mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state.mu)
    nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads, state.nu)
    count = state.count + 1
    c = count.float()
    bc1 = 1 - torch.pow(torch.tensor(b1, device=c.device), c)
    bc2 = 1 - torch.pow(torch.tensor(b2, device=c.device), c)
    step = -(lr(state.count) if callable(lr) else torch.tensor(
        lr, dtype=torch.float32, device=c.device))
    updates = tree_map(lambda m, v: step * ((m / bc1) / (torch.sqrt(v / bc2)
                                                         + EPS)), mu, nu)
    return updates, AdamState(count=count, mu=mu, nu=nu)


def apply_grad_flags(pc_grads: PointCloud, cfg: PointsConfig) -> PointCloud:
    """Zero gradients of frozen point attributes."""
    def z(g, on):
        return g if on else torch.zeros_like(g)
    return PointCloud(xyz=z(pc_grads.xyz, cfg.xyz_grad),
                      features=z(pc_grads.features, cfg.feat_grad),
                      conf=z(pc_grads.conf, cfg.conf_grad),
                      color=z(pc_grads.color, cfg.color_grad),
                      dirs=z(pc_grads.dirs, cfg.dir_grad))


def freeze_points(pc: PointCloud, cfg: PointsConfig) -> PointCloud:
    """Detach frozen attributes before the forward pass, so autograd builds
    no backward scatter for them."""
    def f(x, on):
        return x if on else x.detach()
    return PointCloud(xyz=f(pc.xyz, cfg.xyz_grad),
                      features=f(pc.features, cfg.feat_grad),
                      conf=f(pc.conf, cfg.conf_grad),
                      color=f(pc.color, cfg.color_grad),
                      dirs=f(pc.dirs, cfg.dir_grad))


def hit_boost(hit_ema: torch.Tensor, boost_max: float,
              pow_: float = 0.5) -> torch.Tensor:
    """Per-point update boost for gradient-starved payloads:
    clip((mean/ema)**pow_, 1, boost_max) over hit-active points, 1 for
    never-hit points."""
    active = hit_ema > 1e-8
    mean_ema = (torch.where(active, hit_ema, 0.0).sum()
                / active.float().sum().clamp(min=1.0))
    boost = (mean_ema / hit_ema.clamp(min=1e-8)) ** pow_
    return torch.where(active, boost.clamp(1.0, boost_max), 1.0)


def alter_mask(step: torch.Tensor, alter_step: int):
    """(mlp_active, points_active) for the alternation schedule."""
    if alter_step == 0:
        on = torch.ones((), dtype=torch.bool, device=step.device)
        return on, on
    phase = (step // alter_step) % 2
    return phase == 0, phase == 1


def masked_updates(updates: Dict[str, Any], mlp_on, other_on):
    """Scale update groups by the alternation mask: the "mlp" group follows
    mlp_on, every other group other_on."""
    return {k: tree_map(lambda u, on=(mlp_on if k == "mlp" else other_on):
                        u * on.float(), v)
            for k, v in updates.items()}


def alternated_update(grads, opt_state: Dict[str, AdamState],
                      step: torch.Tensor, alter_step: int,
                      cfg: PointNeRFConfig, lrs: Optional[Dict] = None):
    """Every group's Adam update, with the reference's alternation: on an
    off phase a group's updates are zero and its moments and count are
    carried through unchanged (not decayed, not advanced). `lrs` maps each
    group to its learning rate or schedule; by default the per-scene pair,
    "mlp" at lr and "points" at plr."""
    if lrs is None:
        lrs = {"mlp": lr_schedule(cfg.train.lr, cfg),
               "points": lr_schedule(cfg.train.plr, cfg)}
    updates, new_opt = {}, {}
    for g in lrs:
        updates[g], new_opt[g] = adam_update(grads[g], opt_state[g], lrs[g])
    if alter_step <= 0:
        return updates, new_opt
    mlp_on, other_on = alter_mask(step, alter_step)
    updates = masked_updates(updates, mlp_on, other_on)
    for g in lrs:
        on = mlp_on if g == "mlp" else other_on
        new_opt[g] = tree_map(lambda n, o, on=on: torch.where(on, n, o),
                              new_opt[g], opt_state[g])
    return updates, new_opt
