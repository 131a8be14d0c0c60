"""The sharded path: a (dp, mp) mesh of torch.distributed ranks, rays
data-parallel over dp and the neural point cloud sharded over mp.

Counterpart of `pointnerf_tpu/parallel/` (`mesh.py`, `multihost.py`,
`sharded.py`), with the collectives of its `shard_map` programs in
`collectives.py`. Exports what the JAX package's `__init__` exports.
"""
from .mesh import make_mesh
from .sharded import (ShardedScene, build_sharded_scene,
                      create_sharded_neural2d_state,
                      create_sharded_train_state, make_sharded_eval_step,
                      make_sharded_neural2d_step, make_sharded_train_step,
                      partition_points)
