"""The rank mesh: ('data', 'tile') over the ranks of a `torch.distributed`
world.

The port of the JAX package's `parallel/mesh.py`. One process is one rank
and drives one device, so the mesh lays out ranks where the JAX one lays
out devices:

  * ``data`` — cameras a step (one a data group; the state is replicated
    and the gradients are averaged over the group),
  * ``tile`` — image row bands (each rank composites only its band, and
    the band images are gathered for the loss).

Rank ``d·tile + t`` sits at (d, t), the row-major layout of
``np.asarray(devices).reshape(data, tile)``. The Gaussian shards of
``gauss_shard`` ride the ``tile`` axis (`parallel/sharded.py`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch.distributed as dist


def rank_layout(data: int = 1, tile: Optional[int] = None,
                world_size: int = 1) -> np.ndarray:
    """[data, tile] ranks of the mesh; `tile` defaults to filling the world.
    Raises `ValueError` where the JAX package's `make_device_mesh` does."""
    if tile is None:
        if world_size % data != 0:
            raise ValueError(f"{world_size} devices not divisible by data={data}")
        tile = world_size // data
    if data * tile != world_size:
        raise ValueError(f"data*tile = {data * tile} != {world_size} devices")
    return np.arange(world_size).reshape(data, tile)


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """This rank's place in the mesh and its two process groups: `data_group`
    holds the ranks of its column (one a data group, this tile band),
    `tile_group` those of its row (every band of its camera)."""

    data: int
    tile: int
    rank: int
    d: int
    t: int
    data_group: object
    tile_group: object

    @property
    def shape(self) -> dict:
        return {"data": self.data, "tile": self.tile}

    @property
    def size(self) -> int:
        return self.data * self.tile


def make_rank_mesh(data: int = 1, tile: Optional[int] = None) -> RankMesh:
    """The mesh over the initialised world (`distributed.initialize`).

    Every rank creates every group, in the same order (`dist.new_group` is
    collective over the world): first the `data` groups, one a band, then
    the `tile` groups, one a camera."""
    layout = rank_layout(data, tile, dist.get_world_size())
    n_data, n_tile = layout.shape
    rank = dist.get_rank()
    d, t = (int(i) for i in np.argwhere(layout == rank)[0])
    data_groups = [dist.new_group([int(r) for r in layout[:, j]]) for j in range(n_tile)]
    tile_groups = [dist.new_group([int(r) for r in layout[i, :]]) for i in range(n_data)]
    return RankMesh(data=n_data, tile=n_tile, rank=rank, d=d, t=t,
                    data_group=data_groups[t], tile_group=tile_groups[d])
