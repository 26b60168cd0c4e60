"""The system under test: the port's ``FederatedSearchEngine``.

The harness reaches the program only through this module: it builds the
engine through the port's own set-up path (``ShardSet.build`` with the
configuration's storage form and layout, the router from weights the
benchmark made), launches a batch (``search_submit``) and takes its answer
(``PendingSearch.wait``). The port is imported here, inside the functions,
so that the harness's other modules import without it.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np


def build(cfg: dict, rows: Dict[str, np.ndarray],
          centroids: Dict[str, np.ndarray], router_state, device,
          cache_root: str):
    """The engine over the configuration's world, and the facts of its
    layout that the per-layer metrics count work with: ``{source: {"n",
    "d", "dtype", and for a cluster-probed layout "clusters", "slots",
    "probes"}}``."""
    from ragroute_tpu_torch.config import IVF_NPROBE_DIVISOR, get_world
    from ragroute_tpu_torch.engine.engine import FederatedSearchEngine
    from ragroute_tpu_torch.index.shard import ShardSet
    from ragroute_tpu_torch.router import CorpusRouter, RouterBank

    world = get_world(cfg["world"]["name"])
    eng_cfg = cfg["engine"]
    kw = {}
    if eng_cfg.get("ivf_clusters"):
        kw["ivf_clusters"] = eng_cfg["ivf_clusters"]
        kw["ivf_cache_dirs"] = {
            s.name: os.path.join(cache_root, "layouts", cfg["name"], s.name)
            for s in world.sources}
    shard_set = ShardSet.build(world, rows, dtype=eng_cfg["dtype"],
                               device=device, **kw)
    router = CorpusRouter(world.router_input_dim)
    router.load_state_dict({k: v.to("cpu") for k, v in router_state.items()})
    router = router.to(device).eval()
    bank = RouterBank.create(world, centroids, device=device)
    engine = FederatedSearchEngine(shard_set, router, bank,
                                   impl=eng_cfg["impl"])
    k = world.k
    shapes = {}
    for s in shard_set.shards:
        d = next(x.embed_dim for x in world.sources if x.name == s.name)
        shape = {"n": s.n_docs, "d": d, "dtype": eng_cfg["dtype"]}
        if eng_cfg["impl"] == "ivf" and s.ivf is not None:
            c, _, slots = s.ivf.docs.shape
            nprobe = max(1, s.ivf.n_clusters // IVF_NPROBE_DIVISOR)
            shape.update(clusters=c, slots=slots, probes=int(
                min(max(nprobe, -(-k // min(k, slots))), c)))
        shapes[s.name] = shape
    return engine, shapes


def source_names(engine):
    return [s.name for s in engine.world.sources]


def submit(engine, queries: Dict[str, np.ndarray], strategy: str):
    """Launch one batch; the answer is taken by :func:`answer`."""
    return engine.search_submit(queries, strategy=strategy,
                                fetch_candidates=False)


def answer(pending) -> Dict[str, np.ndarray]:
    """Wait for a launched batch: ``mask [B, N]``, ``score``, ``shard``,
    ``local [B, k]``, ``count [B]`` on the host."""
    out = pending.wait()
    return {"mask": out.mask, "score": out.merged_score,
            "shard": out.merged_shard, "local": out.merged_local,
            "count": out.merged_valid}
