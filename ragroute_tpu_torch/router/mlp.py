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


KEEP = 1.0 - DROPOUT_RATE


def dropout_masks(batch_shape, generator: torch.Generator, device):
    """The keep masks ``forward_train`` draws from ``generator``, in its
    order: ``[*batch_shape, 256]`` after the first ReLU, then ``[...,
    128]`` after the second, each entry kept with probability ``KEEP``
    (``rand < KEEP``). Drawn for a whole batch, their row slices serve its
    parts (the dp-sharded training step)."""
    return tuple(torch.rand((*batch_shape, width), generator=generator,
                            device=device) < KEEP
                 for width in (HIDDEN1, HIDDEN2))


def dropout(h: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Inverted dropout under a keep mask of ``dropout_masks``: the kept
    entries scaled by ``1 / KEEP``, the rest zero."""
    return torch.where(mask, h / KEEP, torch.zeros((), dtype=h.dtype,
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

    def forward(self, x: torch.Tensor, masks=None) -> torch.Tensor:
        """Eval forward; with ``masks`` (``dropout_masks``) the train-mode
        forward under those dropout masks."""
        h = torch.relu(self.ln1(self.fc1(x)))
        if masks is not None:
            h = dropout(h, masks[0])
        h = torch.relu(self.ln2(self.fc2(h)))
        if masks is not None:
            h = dropout(h, masks[1])
        return self.fc3(h)[..., 0]

    def forward_train(self, x: torch.Tensor,
                      generator: torch.Generator) -> torch.Tensor:
        """Train-mode forward: dropout(0.4) after each ReLU, its masks drawn
        from ``generator`` (on ``x``'s device)."""
        return self(x, dropout_masks(x.shape[:-1], generator, x.device))

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
