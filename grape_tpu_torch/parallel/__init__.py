"""Trajectory parallelism over ``torch.distributed`` (counterpart of
``grape_tpu.parallel``)."""

from .mesh import (
    make_mesh, make_host_chip_mesh, init_distributed, shard_problem,
    build_fg_sharded, build_f_sharded, ensemble_trajectories, traj_axes,
)

__all__ = [
    "make_mesh", "make_host_chip_mesh", "init_distributed", "shard_problem",
    "build_fg_sharded", "build_f_sharded", "ensemble_trajectories",
    "traj_axes",
]
