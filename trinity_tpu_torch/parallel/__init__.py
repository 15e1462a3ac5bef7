"""Sharded serving: a segment range-partitioned over a list of devices."""

from trinity_tpu_torch.parallel.mesh import (
    MeshExecutor,
    MeshSourcesCollection,
    split_segment,
)

__all__ = ["MeshExecutor", "MeshSourcesCollection", "split_segment"]
