"""The plain reference: routed federated search in plain PyTorch.

It takes only what the benchmark made (the world's seeds, through
:class:`portbench.world.World`) and imports nothing of the program. From
the raw rows it works out again what the program's set-up derives: the
centroids and the router's features and decisions, each source's stored
rows (normalised for cos, mean-centred where the stored form is lossy and
the score is dot or l2, then in the stored form of :mod:`portbench.rows`),
each routed source's exact top-k in f32 (no TF32) and the merge (ties to the
lower source, then the better rank within it).

Scores are natural: dot and cos higher is better, l2 a squared distance,
lower is better. Work runs in blocks of rows so that a source of millions of
rows fits beside its gains.
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from portbench import router
from portbench.world import World, full_f32

DOC_BLOCK = 1 << 16


class Reference:
    """Stored rows of every source in one stored form, and the router."""

    def __init__(self, cfg: dict, world: World, form: str,
                 router_state: Dict[str, torch.Tensor]):
        torch.backends.cuda.matmul.allow_tf32 = False
        rows = importlib.import_module(f"portbench.rows.{form}")
        w = cfg["world"]
        self.k = w["k"]
        self.world = world
        self.form = form
        # the scan's query operand: the port's kernels round it to the
        # rows' compute type (bf16 for bf16, int8 and int4 rows)
        self.query_dtype = getattr(torch, cfg["reference"]["query"])
        self.modes = [s["score_mode"] for s in w["sources"]]
        self.encoders = [s["encoder"] for s in w["sources"]]
        self.router_cfg = w["router"]
        self.mat: List[torch.Tensor] = []
        self.scale: List[Optional[torch.Tensor]] = []
        self.center: List[Optional[torch.Tensor]] = []
        self.bias: List[Optional[torch.Tensor]] = []
        self.rms: List[float] = []        # rms norm of a stored row
        self.centroids = world.centroids()
        self.router = router_state
        for si, mode in enumerate(self.modes):
            x = world.rows(si)
            if mode == "cos":
                x = x / torch.clamp(torch.linalg.vector_norm(
                    x, dim=1, keepdim=True), min=1e-12)
            mu = None
            if mode in ("dot", "l2") and rows.LOSSY:
                mu = x.double().mean(dim=0).float()
                x = x - mu
            self.bias.append(-(x * x).sum(dim=1) if mode == "l2" else None)
            mat, scale = rows.encode(x)
            del x
            self.mat.append(mat)
            self.scale.append(scale)
            self.center.append(mu)
            sq = (mat * mat).sum(dim=1)
            if scale is not None:
                sq = sq * scale * scale
            self.rms.append(float(sq.mean().sqrt()))

    # -- router -----------------------------------------------------------

    def route(self, queries: Dict[str, torch.Tensor], strategy: str
              ) -> torch.Tensor:
        """``[Q, N]`` routing decisions: the router over its features
        built from the centroids made again here (``ragroute``), or every
        source (``all``), or none."""
        r = self.router_cfg
        n = len(self.modes)
        q0 = queries[self.encoders[0]]
        if strategy == "all":
            return torch.ones((q0.shape[0], n), dtype=torch.bool,
                              device=q0.device)
        if strategy == "none":
            return torch.zeros((q0.shape[0], n), dtype=torch.bool,
                               device=q0.device)
        if strategy != "ragroute":
            raise ValueError(f"the reference routes no {strategy!r}")
        with full_f32():
            x = router.features(r, [queries[e] for e in self.encoders],
                                self.centroids)
            return router.routed(r, self.router, x)

    # -- scores -----------------------------------------------------------

    def _query_form(self, si: int, q: torch.Tensor) -> torch.Tensor:
        """The query in gain form for source ``si``, as the scan's operand:
        gain = q'.row * scale + bias."""
        mode, mu = self.modes[si], self.center[si]
        q = q.float()
        if mode == "cos":
            q = q / torch.clamp(torch.linalg.vector_norm(
                q, dim=1, keepdim=True), min=1e-12)
        elif mode == "l2":
            q = 2.0 * (q if mu is None else q - mu)
        return q.to(self.query_dtype).float()

    def _natural(self, si: int, gain: torch.Tensor, q: torch.Tensor
                 ) -> torch.Tensor:
        mode, mu = self.modes[si], self.center[si]
        q = q.float()
        if mode == "l2":
            qc = q if mu is None else q - mu
            return (qc * qc).sum(dim=1, keepdim=True) - gain
        if mode == "dot" and mu is not None:
            return gain + (q @ mu)[:, None]
        return gain

    def source_topk(self, si: int, q: torch.Tensor):
        """Exact top-k of one source for every query: ``(gain [Q, k],
        local [Q, k])``, best first."""
        qf = self._query_form(si, q)
        mat, scale, bias = self.mat[si], self.scale[si], self.bias[si]
        best_g = best_i = None
        for lo in range(0, mat.shape[0], DOC_BLOCK):
            hi = min(lo + DOC_BLOCK, mat.shape[0])
            g = qf @ mat[lo:hi].T
            if scale is not None:
                g = g * scale[lo:hi]
            if bias is not None:
                g = g + bias[lo:hi]
            kk = min(self.k, hi - lo)
            bg, bi = torch.topk(g, kk, dim=1)
            bi = bi + lo
            if best_g is not None:
                bg = torch.cat([best_g, bg], dim=1)
                bi = torch.cat([best_i, bi], dim=1)
                bg, pos = torch.topk(bg, min(self.k, bg.shape[1]), dim=1)
                bi = torch.gather(bi, 1, pos)
            best_g, best_i = bg, bi
        return best_g, best_i

    def answer(self, queries: Dict[str, torch.Tensor], mask: torch.Tensor):
        """The merged answer under ``mask``: ``(score [Q, k], shard [Q, k],
        local [Q, k], count [Q])``; past ``count`` shard is -1."""
        k = self.k
        keys, locs = [], []
        for si in range(len(self.modes)):
            q = queries[self.encoders[si]]
            g, idx = self.source_topk(si, q)
            nat = self._natural(si, g, q)
            key = -nat if self.modes[si] == "l2" else nat
            pad = k - key.shape[1]
            if pad:
                key = F.pad(key, (0, pad), value=float("-inf"))
                idx = F.pad(idx, (0, pad))
            keys.append(torch.where(mask[:, si:si + 1], key,
                                    torch.full_like(key, float("-inf"))))
            locs.append(idx)
        key = torch.cat(keys, dim=1)                    # [Q, N * k]
        loc = torch.cat(locs, dim=1)
        top, pos = torch.sort(key, dim=1, descending=True, stable=True)
        top, pos = top[:, :k], pos[:, :k]
        valid = top > float("-inf")
        shard = torch.where(valid, pos // k, -1)
        local = torch.where(valid, torch.gather(loc, 1, pos), 0)
        l2 = self.modes[0] == "l2"
        score = torch.where(valid, -top if l2 else top,
                            torch.full_like(top, float("nan")))
        return score, shard, local, valid.sum(dim=1)

    def score_of(self, queries: Dict[str, torch.Tensor], shard: torch.Tensor,
                 local: torch.Tensor):
        """The reference's natural score of each named doc, and a scale to
        measure gaps in: ``|q|`` times the rms norm of its source's stored
        rows. ``(score [Q, k], scale [Q, k])``; NaN where ``shard`` names
        no doc."""
        score = torch.full(shard.shape, float("nan"), device=shard.device)
        unit = torch.full(shard.shape, float("nan"), device=shard.device)
        for si in range(len(self.modes)):
            sel = shard == si
            if not bool(sel.any()):
                continue
            qi, kj = torch.nonzero(sel, as_tuple=True)
            li = local[qi, kj]
            n = self.mat[si].shape[0]
            ok = (li >= 0) & (li < n)
            qi, kj, li = qi[ok], kj[ok], li[ok]
            q = queries[self.encoders[si]][qi]
            qf = self._query_form(si, q)
            g = (qf * self.mat[si][li]).sum(dim=1)
            if self.scale[si] is not None:
                g = g * self.scale[si][li]
            if self.bias[si] is not None:
                g = g + self.bias[si][li]
            nat = self._natural_rows(si, g, q)
            score[qi, kj] = nat
            unit[qi, kj] = torch.linalg.vector_norm(q.float(), dim=1) * self.rms[si]
        return score, unit

    def _natural_rows(self, si: int, gain: torch.Tensor, q: torch.Tensor
                      ) -> torch.Tensor:
        return self._natural(si, gain[:, None], q)[:, 0]
