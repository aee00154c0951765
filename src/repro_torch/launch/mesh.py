"""Production meshes: the JAX package's ``launch/mesh.py`` in torch.

Functions (never module-level constants), so that importing this module
touches no process group.  The production grid is abstract: axis names and
sizes, which ``models.sharding`` reads and the dry-run lays over a fake
default group of as many ranks.  The live grid is the distributed index's
``make_mesh`` over the default process group.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

__all__ = ["Grid", "make_production_mesh", "make_local_mesh"]


@dataclasses.dataclass(frozen=True)
class Grid:
    """A grid of ranks by shape and axis names, with no rank behind it."""

    dims: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """Each axis name's size, in the grid's order (``jax`` Mesh.shape)."""
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return math.prod(self.dims)

    @property
    def label(self) -> str:
        return "x".join(map(str, self.dims))


def make_production_mesh(*, multi_pod: bool = False) -> Grid:
    """16x16 = 256 ranks per pod; 2 pods = 512 ranks when multi_pod."""
    if multi_pod:
        return Grid((2, 16, 16), ("pod", "data", "model"))
    return Grid((16, 16), ("data", "model"))


def make_local_mesh(device=None):
    """The live ``(world, 1)`` grid over the default process group, with the
    production axis names (``dist_index.make_mesh``; ``device`` as for
    ``dist_index.rank_device``)."""
    import torch.distributed as dist

    from repro_torch.launch.dist_index import make_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_local_mesh needs an initialized default process group")
    return make_mesh((dist.get_world_size(), 1), ("data", "model"), device)
