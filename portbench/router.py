"""The router MLP in plain PyTorch (the port's ``CorpusRouter`` layout):
per (query, source), ``[pad(query) | pad(centroid) | one-hot]`` through
Linear -> LayerNorm -> ReLU for each hidden width, then Linear to one
logit; a source is routed where the sigmoid passes the threshold."""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F


def features(r: dict, queries: List[torch.Tensor],
             centroids: torch.Tensor) -> torch.Tensor:
    """``[Q, N, input_dim]`` from each source's query rows ``[Q, d_i]``
    and the ``[N, d_max]`` centroids."""
    pad = r["embed_pad"]
    onehot_dim = r["input_dim"] - 2 * pad
    feats = []
    for si, q in enumerate(queries):
        c = centroids[si]
        oh = torch.zeros(onehot_dim, device=q.device)
        oh[r["onehot"][si]] = 1.0
        feats.append(torch.cat([
            F.pad(q, (0, pad - q.shape[1])),
            F.pad(c, (0, pad - c.shape[0])).expand(q.shape[0], -1),
            oh.expand(q.shape[0], -1)], dim=1))
    return torch.stack(feats, dim=1)


def hidden(r: dict, state: Dict[str, torch.Tensor],
           x: torch.Tensor) -> torch.Tensor:
    """The last hidden layer's activations."""
    h = x
    for i in range(1, len(r["hidden"]) + 1):
        h = F.linear(h, state[f"fc{i}.weight"], state[f"fc{i}.bias"])
        h = F.layer_norm(h, (h.shape[-1],), state[f"ln{i}.weight"],
                         state[f"ln{i}.bias"], eps=r["ln_eps"])
        h = torch.relu(h)
    return h


def routed(r: dict, state: Dict[str, torch.Tensor],
           x: torch.Tensor) -> torch.Tensor:
    """``[Q, N]`` routing decisions."""
    last = len(r["hidden"]) + 1
    logit = F.linear(hidden(r, state, x), state[f"fc{last}.weight"],
                     state[f"fc{last}.bias"])[..., 0]
    return torch.sigmoid(logit) > r["threshold"]
