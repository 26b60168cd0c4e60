"""Routing strategies as boolean masks over federated sources.

PyTorch port of :mod:`ragroute_tpu.router.strategies`: ``ragroute`` (MLP
gate, ``p > threshold``), ``all``, ``random`` (exactly ``random_subset``
sources per query, uniformly) and ``none``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ragroute_tpu_torch.config import ROUTING_STRATEGIES, WorldConfig


def routing_mask(world: WorldConfig, strategy: str, probs: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 threshold: Optional[float] = None) -> torch.Tensor:
    """``[B, N]`` boolean routing mask.

    ``probs`` are the router's sigmoid probabilities (read by ``ragroute``
    only); ``generator`` (on the probs' device) drives ``random``;
    ``threshold`` overrides the world's pinned decision threshold."""
    if strategy not in ROUTING_STRATEGIES:
        raise ValueError(f"Unknown routing strategy: {strategy!r}; "
                         f"expected one of {ROUTING_STRATEGIES}")
    bsz, n = probs.shape
    if n != world.num_sources:
        raise ValueError(f"probs last dim {n} != {world.num_sources} sources")
    if strategy == "ragroute":
        t = world.router_threshold if threshold is None else threshold
        return probs > t
    if strategy == "all":
        return torch.ones((bsz, n), dtype=torch.bool, device=probs.device)
    if strategy == "none":
        return torch.zeros((bsz, n), dtype=torch.bool, device=probs.device)
    # random: the `random_subset` smallest of n iid uniforms per row
    u = torch.rand((bsz, n), generator=generator, device=probs.device)
    kth = torch.sort(u, dim=1).values[:, world.random_subset - 1:
                                      world.random_subset]
    return u <= kth
