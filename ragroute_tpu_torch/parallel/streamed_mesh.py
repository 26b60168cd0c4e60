"""Capacity tier x mesh: the hostrefine engine served over devices.

PyTorch port of :mod:`ragroute_tpu.parallel.streamed_mesh`. Every ``idx``
cell owns a row slice of each source's device-resident coarse slab (and of
fully resident sources' exact rows); the candidates are gathered and merged
like the flat mesh path's (:func:`parallel.sharded.sharded_shard_topk`: K1
per cell, then one tie-stable top-k of the row), and the host exact-rescores
the merged candidate ids from its RAM rows.

* Each cell keeps ``k'`` candidates before the gather, so the merged list
  is the exact coarse top-``k'`` of the whole slab, as on one card.
* The global mask-gated cut across sources, the exact rescore and the
  dispatch / complete split the pipelined batcher uses are the single-card
  engine's (:class:`engine.streamed.StreamedSearchEngine`) unchanged: only
  its two scans run sharded. A world where no source has a coarse slab
  takes the per-source path there, as on one card (the JAX package's mesh
  engine concatenates an empty list in that case and raises).
* Clustered (probed) coarse slabs are a single-card optimisation: build
  mesh worlds with ``cluster_coarse=False``; each cell scans its flat
  slice.
* Single-process meshes only, as in the JAX package: a cluster would need
  the host rows partitioned per process.
"""

from __future__ import annotations

from typing import Optional

from ragroute_tpu_torch.engine.streamed import StreamedSearchEngine
from ragroute_tpu_torch.index.streamed import StreamedShardSet
from ragroute_tpu_torch.ops.topk import NEG_INF
from ragroute_tpu_torch.parallel.mesh import Mesh
from ragroute_tpu_torch.parallel.sharded import (MeshRows, _rows_of,
                                                 sharded_shard_topk)


class MeshStreamedEngine(StreamedSearchEngine):
    """Hostrefine capacity tier over a ``(dp, idx)`` mesh, with the
    single-card tier's host-facing contract (the batcher's pipelined
    worker and both front ends serve it unchanged)."""

    def __init__(self, shard_set: StreamedShardSet, router, bank,
                 mesh: Mesh, *, threshold: Optional[float] = None,
                 seed: int = 0, k_refine: Optional[int] = None):
        if shard_set.tier != "hostrefine":
            raise ValueError(
                "MeshStreamedEngine serves tier='hostrefine' (the stream "
                "tier's per-batch slab upload is a single-chip design)")
        if any(s.coarse_cl is not None for s in shard_set.sources):
            raise ValueError(
                "clustered coarse slabs are single-chip; build the mesh "
                "world with cluster_coarse=False (each device scans its "
                "flat slice — the mesh already divides the gain count)")
        if mesh.multiprocess:
            raise ValueError(
                "multi-process meshes need per-host refine over "
                "partitioned host rows; MeshStreamedEngine serves "
                "single-process (one host, many chips) meshes")
        self.mesh = mesh
        self.dp = mesh.shape["dp"]
        self.n_idx = mesh.shape["idx"]
        super().__init__(shard_set, router, bank, threshold=threshold,
                         seed=seed, k_refine=k_refine)
        self._res_sh, self._coarse_sh = [], []
        for s in shard_set.sources:
            res = coarse = None
            if s.res_docs is not None:
                res = (MeshRows(mesh, s.res_docs),
                       MeshRows(mesh, s.res_bias, pad=NEG_INF),
                       None if s.res_scale is None
                       else MeshRows(mesh, s.res_scale))
                # the sharded copies replace the originals (no double
                # residency); device_bytes reads them alike
                s.res_docs, s.res_bias, s.res_scale = res
            if s.coarse_docs is not None:
                coarse = (MeshRows(mesh, s.coarse_docs),
                          MeshRows(mesh, s.coarse_bias, pad=NEG_INF),
                          None if s.coarse_scale is None
                          else MeshRows(mesh, s.coarse_scale))
                s.coarse_docs, s.coarse_bias, s.coarse_scale = coarse
            self._res_sh.append(res)
            self._coarse_sh.append(coarse)

    def _device_embs(self, query_embs):
        embs = super()._device_embs(query_embs)
        for arr in embs.values():
            _rows_of(self.mesh, arr.shape[0])
        return embs

    def _resident_topk(self, i, q, k):
        docs, bias, scale = self._res_sh[i]
        return sharded_shard_topk(self.mesh, q, docs, bias, k,
                                  mode=self._modes[i], scale=scale,
                                  packed4=self.shard_set.packed4)

    def _coarse_topk(self, i, qt, kp):
        docs, bias, scale = self._coarse_sh[i]
        return sharded_shard_topk(self.mesh, qt, docs, bias,
                                  min(kp, docs.n_local), mode="dot",
                                  scale=scale)
