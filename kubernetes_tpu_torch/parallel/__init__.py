"""Pipelined scheduling cycles (parallel/pipeline.py) and the node mesh:
the mesh and its padding (mesh.py), the collectives (collectives.py), the
routed step on the mesh (sharded.py) and the ring layer (ring.py)."""

from .mesh import NodeMesh, make_mesh  # noqa: F401
from .pipeline import PipelinedBatchLoop, PipelinedRunner, run_serial  # noqa: F401
from .ring import all_to_all_pods_to_nodes, ring_match  # noqa: F401
from .sharded import sharded_schedule_batch, sharded_schedule_batch_routed  # noqa: F401

__all__ = ["NodeMesh", "PipelinedBatchLoop", "PipelinedRunner", "all_to_all_pods_to_nodes", "make_mesh", "ring_match",
           "run_serial", "sharded_schedule_batch", "sharded_schedule_batch_routed"]
