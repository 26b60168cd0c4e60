"""Low-rank coarse-scan index for two-stage exact retrieval.

PyTorch port of :mod:`ragroute_tpu.index.lowrank`. ``impl="lowrank"`` scores
a shard in two dense stages:

1. **coarse**: the whole shard against a rank-``r`` projection of the stored
   documents (``[n, r]`` bf16 slab, the same fused product + top-k kernel),
   keeping ``k' = refine_mult * k`` candidates per query;
2. **refine**: the ``k'`` candidates' stored rows are gathered and rescored
   exactly, then the final top-k is taken. Recall is lost only when a true
   top-k doc falls outside the coarse top-k'.

The basis is the eigendecomposition of the stored documents' covariance.
The coarse slab is always mean-centred before projection, whatever the
store's own centring: a per-query constant offset never changes per-query
ordering in any score mode, while centring removes the common component
that otherwise dominates bf16 rounding. Rank selection is energy-based: the
smallest multiple-of-128 rank whose eigen-spectrum covers ``energy`` of the
total variance; a spectrum too flat for a profitable projection (rank above
half the dimension) returns ``None`` and the engine scans that shard
exactly.

``eigh`` leaves each eigenvector's sign open. The JAX package takes
whatever LAPACK returns; this build does the same with the same numpy call
on the same matrix, so on one machine the two are bit-equal (the tests hold
that). The ``.npz`` cache format is the JAX package's.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np
import torch

from ragroute_tpu_torch.config import (LOWRANK_MAX_RANK_FRACTION as
                                       MAX_RANK_FRACTION,
                                       LOWRANK_MOMENT_SAMPLE_ROWS as
                                       MOMENT_SAMPLE_ROWS,
                                       LOWRANK_RANK_MULTIPLE as RANK_MULTIPLE)
from ragroute_tpu_torch.index.ivf import _bf16_from_bits, _np

logger = logging.getLogger("lowrank")

RANK_ALIGN = 16     # column multiple of the stored basis and coarse slab


@dataclasses.dataclass
class LowRankData:
    """Tensors of one shard's low-rank coarse index on one device.

    ``docs_lr`` is padded to the same row count as the shard's full slab,
    so the shard's gain bias (the l2 ``-|d|^2`` term and the ``-inf``
    padding sentinel) applies to the coarse scan unchanged. ``mu`` is the
    mean subtracted before projection: coarse gains are true gains minus
    the per-(query, shard) constant ``q_gain . mu``, harmless within a
    shard and restored explicitly where coarse scores are returned (the
    int4 coarse-authoritative mode of ``ops/lowrank_topk.py``)."""

    basis: torch.Tensor         # [d, rp] f32 orthonormal columns
    docs_lr: torch.Tensor       # [n_pad, rp] bf16 projected stored docs
    mu: torch.Tensor            # [d] f32 projection centring mean
    rank: int                   # r; rp is r rounded up to RANK_ALIGN
    energy: float               # captured variance fraction

    @property
    def device(self) -> torch.device:
        return self.docs_lr.device

    def to(self, device) -> "LowRankData":
        return dataclasses.replace(
            self, basis=self.basis.to(device),
            docs_lr=self.docs_lr.to(device), mu=self.mu.to(device))

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.basis, self.docs_lr, self.mu))


def _pad_rank(x: np.ndarray) -> np.ndarray:
    """Zero columns up to a multiple of ``RANK_ALIGN``: the fused scan on
    the card takes that width only, and a zero column adds nothing to any
    coarse gain, so every rank is served and the result stays exact."""
    pad = -x.shape[1] % RANK_ALIGN
    return np.pad(x, ((0, 0), (0, pad))) if pad else x


def select_rank(eigvals_desc: np.ndarray, energy: float,
                rank: Optional[int] = None) -> Optional[int]:
    """Smallest multiple-of-128 rank covering ``energy`` of the spectrum.

    ``rank`` overrides the energy rule (still clamped to the dimension).
    Returns ``None`` when the profitable-rank policy refuses (needed rank
    above ``MAX_RANK_FRACTION * d``: a too-flat spectrum)."""
    d = int(eigvals_desc.shape[0])
    if rank is not None:
        return int(min(max(rank, 1), d))
    total = float(eigvals_desc.sum())
    if total <= 0.0:
        return None
    cum = np.cumsum(eigvals_desc) / total
    need = int(np.searchsorted(cum, energy) + 1)
    r = min(-(-need // RANK_MULTIPLE) * RANK_MULTIPLE, d)
    if r > MAX_RANK_FRACTION * d:
        return None
    return r


def build_lowrank(
    emb: np.ndarray,
    *,
    n_pad: int,
    rank: Optional[int] = None,
    energy: float = 0.99,
    chunk: int = 65536,
    device="cpu",
) -> Optional[LowRankData]:
    """Build the coarse index for one shard and place it on ``device``.

    Args:
      emb: ``[n, d]`` float32 stored-form documents (already
        cos-normalized / mean-centred exactly as the full slab stores
        them, before any dtype quantization).
      n_pad: row count of the shard's padded full slab (docs_lr matches
        it so the shard bias applies unchanged).
      rank: explicit rank override; default picks by ``energy``.
      energy: captured-variance fraction for automatic rank selection.

    Returns ``None`` when the corpus spectrum is too flat for a
    profitable projection (see :func:`select_rank`)."""
    emb = np.asarray(emb, np.float32)
    n, d = emb.shape
    mu = emb.mean(axis=0, dtype=np.float64).astype(np.float32)
    step = max(1, n // MOMENT_SAMPLE_ROWS)
    sample = np.ascontiguousarray(emb[::step]) - mu
    moment = sample.T @ sample                        # [d, d]
    w, v = np.linalg.eigh(moment.astype(np.float64))  # ascending
    w, v = w[::-1], v[:, ::-1]
    r = select_rank(np.maximum(w, 0.0), energy, rank)
    if r is None:
        logger.warning(
            "lowrank build refused: spectrum too flat (%.3f energy at "
            "rank %d of %d); shard will use the exact exhaustive scan",
            float(np.cumsum(np.maximum(w, 0.0))[int(MAX_RANK_FRACTION * d) - 1]
                  / max(w.sum(), 1e-30)),
            int(MAX_RANK_FRACTION * d), d)
        return None
    basis = np.ascontiguousarray(v[:, :r]).astype(np.float32)
    cap = float(np.maximum(w[:r], 0.0).sum() / max(w.sum(), 1e-30))

    # the projection runs in numpy f32 on the host (the same products as
    # the JAX package's build); the bf16 cast goes through torch
    docs_lr = torch.zeros((n_pad, r + -r % RANK_ALIGN), dtype=torch.bfloat16)
    for off in range(0, n, chunk):
        end = min(off + chunk, n)
        docs_lr[off:end, :r] = torch.from_numpy(
            (emb[off:end] - mu) @ basis).to(torch.bfloat16)
    logger.info("lowrank build: n=%d d=%d rank=%d energy=%.4f "
                "(+%.0f%% index bytes, %.1fx fewer coarse FLOPs)",
                n, d, r, cap, 100.0 * 2 * r / (4.0 * d), d / r)
    return LowRankData(
        basis=torch.from_numpy(_pad_rank(basis)).to(device),
        docs_lr=docs_lr.to(device),
        mu=torch.from_numpy(mu).to(device),
        rank=r,
        energy=cap,
    )


def lowrank_from_reference(fields, device="cpu") -> LowRankData:
    """Carry a coarse index across from the JAX package: ``fields`` maps
    ``basis``, ``docs_lr`` (uint16 bit view of the bf16 slab), ``mu`` and
    ``energy`` to numpy arrays, exactly the keys :func:`save_lowrank`
    writes; gives the port's dataclass on ``device``."""
    basis = np.ascontiguousarray(fields["basis"], dtype=np.float32)
    return LowRankData(
        basis=torch.from_numpy(_pad_rank(basis)).to(device),
        docs_lr=_bf16_from_bits(
            _pad_rank(np.asarray(fields["docs_lr"]))).to(device),
        mu=torch.from_numpy(
            np.ascontiguousarray(fields["mu"], dtype=np.float32)).to(device),
        rank=int(basis.shape[1]),
        energy=float(fields["energy"]),
    )


# -- persistence -------------------------------------------------------------

def save_lowrank(lr: LowRankData, path: str, *,
                 fingerprint: Optional[str] = None) -> None:
    """Persist a coarse index (npz, the JAX package's keys; bf16 stored as
    a uint16 bit view). ``fingerprint`` (``ivf.ivf_fingerprint`` of the
    source embeddings) binds the cache to its corpus."""
    np.savez(
        path,
        basis=_np(lr.basis)[:, :lr.rank],          # without the zero columns
        docs_lr=_np(lr.docs_lr)[:, :lr.rank],
        mu=_np(lr.mu),
        energy=np.float64(lr.energy),
        fingerprint=np.asarray(fingerprint or ""),
    )


def load_lowrank(path: str, expect_fingerprint: Optional[str] = None,
                 device="cpu") -> Optional[LowRankData]:
    """Load a coarse index written by :func:`save_lowrank` (of either
    package); ``None`` (and a warning) on a fingerprint mismatch: the
    caller rebuilds."""
    with np.load(path) as z:
        if expect_fingerprint is not None:
            stored = str(z["fingerprint"]) if "fingerprint" in z else ""
            if stored != expect_fingerprint:
                logger.warning(
                    "lowrank cache %s does not match current embeddings "
                    "(stored fingerprint %r vs %r); rebuilding",
                    path, stored[:12], expect_fingerprint[:12])
                return None
        if "mu" not in z:   # an older cache format: rebuild
            logger.warning("lowrank cache %s predates the mu field; "
                           "rebuilding", path)
            return None
        return lowrank_from_reference({k: z[k] for k in z.files}, device)
