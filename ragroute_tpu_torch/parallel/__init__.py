"""Multi-device scaling: meshes, sharded federated search, clusters.

PyTorch port of :mod:`ragroute_tpu.parallel`. One process:
:func:`make_mesh` over the visible cards (or one device named several
times), :class:`ShardedSearch` / :class:`MeshStreamedEngine` over it. Several
processes (:mod:`ragroute_tpu_torch.parallel.multihost`): join the process
group, build the global mesh with the ``idx`` axis inside each process,
and lockstep-feed serving batches from the HTTP process.
"""

from ragroute_tpu_torch.parallel.mesh import Mesh, make_mesh, parse_mesh_spec
from ragroute_tpu_torch.parallel.multihost import (LockstepEngine,
                                                   initialize as
                                                   initialize_multihost,
                                                   make_multihost_mesh)
from ragroute_tpu_torch.parallel.sharded import (ShardedSearch,
                                                 sharded_ivf_topk,
                                                 sharded_shard_topk)
from ragroute_tpu_torch.parallel.streamed_mesh import MeshStreamedEngine

__all__ = ["Mesh", "make_mesh", "parse_mesh_spec", "MeshStreamedEngine",
           "ShardedSearch", "sharded_ivf_topk", "sharded_shard_topk",
           "LockstepEngine", "initialize_multihost", "make_multihost_mesh"]
