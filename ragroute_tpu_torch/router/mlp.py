"""The corpus-routing MLP ("CorpusRoutingNN") as a torch module.

Architecture parity with the reference router (and
:mod:`ragroute_tpu.router.mlp`): Linear(d, 256) -> LayerNorm -> ReLU ->
Linear(256, 128) -> LayerNorm -> ReLU -> Linear(128, 1), LayerNorm eps
1e-5, run once per (query, corpus) feature vector. Serving runs it in eval
mode, where the reference's Dropout(0.4) layers are the identity, so
:meth:`CorpusRouter.forward` leaves them out; training runs
:meth:`CorpusRouter.forward_train`, with inverted dropout after each ReLU
drawn from a ``torch.Generator`` the caller passes (``nn.Dropout`` takes
none, so dropout is no module state). The sigmoid and threshold live in the
engine and :mod:`ragroute_tpu_torch.router.strategies`.
"""

from __future__ import annotations

import math

import torch
from torch import nn

HIDDEN1 = 256
HIDDEN2 = 128
LN_EPS = 1e-5
DROPOUT_RATE = 0.4      # reference router.py:42,46


def dropout(h: torch.Tensor, generator: torch.Generator,
            rate: float = DROPOUT_RATE) -> torch.Tensor:
    """Inverted dropout: keep each entry with probability ``1 - rate``
    (``rand < keep``), scaled by ``1 / keep``; zero the rest."""
    keep = 1.0 - rate
    mask = torch.rand(h.shape, generator=generator, device=h.device) < keep
    return torch.where(mask, h / keep, torch.zeros((), dtype=h.dtype,
                                                   device=h.device))


class CorpusRouter(nn.Module):
    """``[..., input_dim]`` features -> ``[...]`` logits."""

    def __init__(self, input_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(input_dim, HIDDEN1)
        self.ln1 = nn.LayerNorm(HIDDEN1, eps=LN_EPS)
        self.fc2 = nn.Linear(HIDDEN1, HIDDEN2)
        self.ln2 = nn.LayerNorm(HIDDEN2, eps=LN_EPS)
        self.fc3 = nn.Linear(HIDDEN2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.ln1(self.fc1(x)))
        h = torch.relu(self.ln2(self.fc2(h)))
        return self.fc3(h)[..., 0]

    def forward_train(self, x: torch.Tensor,
                      generator: torch.Generator) -> torch.Tensor:
        """Train-mode forward: dropout(0.4) after each ReLU, its masks drawn
        from ``generator`` (on ``x``'s device)."""
        h = dropout(torch.relu(self.ln1(self.fc1(x))), generator)
        h = dropout(torch.relu(self.ln2(self.fc2(h))), generator)
        return self.fc3(h)[..., 0]

    @classmethod
    def from_seed(cls, input_dim: int, seed: int = 0,
                  device="cpu") -> "CorpusRouter":
        """Fresh parameters drawn from a seeded ``torch.Generator``:
        uniform(+-1/sqrt(fan_in)) weights and biases (torch.nn.Linear's
        default bounds), unit LayerNorm scales, zero LayerNorm biases."""
        model = cls(input_dim)
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for fc in (model.fc1, model.fc2, model.fc3):
                bound = 1.0 / math.sqrt(fc.in_features)
                fc.weight.uniform_(-bound, bound, generator=g)
                fc.bias.uniform_(-bound, bound, generator=g)
        return model.to(device).eval()
