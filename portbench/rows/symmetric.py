"""Per-row symmetric quantization to ``[-levels, levels]``."""

import torch


def encode(x, levels: int):
    amax = x.abs().amax(dim=1)
    scale = torch.where(amax <= 0, torch.ones_like(amax), amax / float(levels))
    codes = torch.clamp(torch.round(x / scale[:, None]), -levels, levels)
    return codes, scale
