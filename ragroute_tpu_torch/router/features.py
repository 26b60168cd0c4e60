"""Router feature construction on the serving device.

PyTorch port of :mod:`ragroute_tpu.router.features`. Per corpus the router
scores ``[pad(query) ‖ pad(centroid) ‖ one_hot(corpus id)]``, the query
from that corpus's own encoder, both embeddings zero-padded to the world's
``embed_pad_len``, whitened by a fitted StandardScaler where the world
uses one. :func:`build_features` builds the whole ``[B, N, D_in]`` tensor
at once.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ragroute_tpu_torch.config import WorldConfig


@dataclasses.dataclass
class RouterBank:
    """Per-world constant tensors for router feature construction."""

    centroids: torch.Tensor     # [N, pad] f32, zero-padded corpus centroids
    onehot: torch.Tensor        # [N, onehot_dim] f32
    scaler_mean: torch.Tensor   # [D_in] f32 (zeros when no scaler)
    scaler_scale: torch.Tensor  # [D_in] f32 (ones when no scaler)

    @classmethod
    def create(cls, world: WorldConfig, centroids: Mapping[str, np.ndarray],
               scaler: Optional[Tuple[np.ndarray, np.ndarray]] = None,
               device="cpu") -> "RouterBank":
        """Build the bank from per-source centroids (native dims) and an
        optional StandardScaler ``(mean, scale)`` over the feature vector."""
        n = world.num_sources
        pad = world.embed_pad_len
        cent = np.zeros((n, pad), dtype=np.float32)
        for i, src in enumerate(world.sources):
            c = np.asarray(centroids[src.name], dtype=np.float32)
            cent[i, : c.shape[0]] = c
        oh = np.zeros((n, world.router_input_dim - 2 * pad), dtype=np.float32)
        for i, src in enumerate(world.sources):
            oh[i, world.onehot_id(src.name)] = 1.0
        if scaler is None:
            mean = np.zeros((world.router_input_dim,), np.float32)
            scale = np.ones((world.router_input_dim,), np.float32)
        else:
            mean = np.asarray(scaler[0], np.float32)
            scale = np.asarray(scaler[1], np.float32)
            if mean.shape != (world.router_input_dim,):
                raise ValueError(f"scaler mean shape {mean.shape} != "
                                 f"({world.router_input_dim},)")
        return cls(*(torch.from_numpy(a).to(device)
                     for a in (cent, oh, mean, scale)))

    def to(self, device) -> "RouterBank":
        return RouterBank(*(getattr(self, f.name).to(device)
                            for f in dataclasses.fields(self)))


def build_features(world: WorldConfig, bank: RouterBank,
                   query_embs: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Scaled router features ``[B, N_sources, D_in]`` from per-encoder
    ``[B, d_enc]`` query embeddings."""
    padded = {}
    for enc in world.encoders:
        q = query_embs[enc].to(torch.float32)
        d = q.shape[-1]
        if d > world.embed_pad_len:
            raise ValueError(
                f"encoder {enc} dim {d} exceeds pad {world.embed_pad_len}")
        padded[enc] = F.pad(q, (0, world.embed_pad_len - d))
    bsz = next(iter(padded.values())).shape[0]
    per_source = [
        torch.cat([padded[src.encoder],
                   bank.centroids[i].expand(bsz, -1),
                   bank.onehot[i].expand(bsz, -1)], dim=-1)
        for i, src in enumerate(world.sources)]
    x = torch.stack(per_source, dim=1)                   # [B, N, D]
    return (x - bank.scaler_mean) / bank.scaler_scale
