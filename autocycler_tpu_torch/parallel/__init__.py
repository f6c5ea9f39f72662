"""Many isolates at once: the (data, seq) mesh of torch devices, the
batched distance steps and trim tracebacks over it, and the fleet
runner's planning and bucketed contraction."""

from .batch import (batched_membership_intersections, encode_batch,
                    multi_isolate_distance_step, sharded_multi_isolate_step,
                    sharded_overlap_tracebacks)
from .mesh import (Mesh, make_mesh, make_multihost_mesh, mesh_axis_sizes,
                   place_leading_axis)

__all__ = [
    "Mesh",
    "batched_membership_intersections",
    "encode_batch",
    "make_mesh",
    "make_multihost_mesh",
    "mesh_axis_sizes",
    "multi_isolate_distance_step",
    "place_leading_axis",
    "sharded_multi_isolate_step",
    "sharded_overlap_tracebacks",
]
