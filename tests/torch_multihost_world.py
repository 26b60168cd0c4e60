"""The world both sides of ``test_torch_multihost.py`` build (the
subprocess workers import it; it imports torch and the port only)."""

import torch

from ragroute_tpu_torch.index import ShardSet, make_synthetic_world
from ragroute_tpu_torch.router import CorpusRouter, RouterBank


def world_and_engine_parts(impl: str):
    """A 1,024-doc medrag world from seed 21, its host-staged shard set
    (with a 16-cluster IVF or a low-rank layout for those impls), a router
    from seed 3 and the bank."""
    syn = make_synthetic_world("medrag", docs_per_source=1024,
                               num_queries=16, seed=21, with_payloads=False)
    kw = ({"ivf_clusters": 16} if impl == "ivf"
          else {"lowrank": -1} if impl == "lowrank" else {})
    ss = ShardSet.build(syn.world, syn.embeddings, dtype=torch.float32,
                        device="host", **kw)
    router = CorpusRouter.from_seed(syn.world.router_input_dim, 3).eval()
    return syn, ss, router, RouterBank.create(syn.world, syn.centroids)
