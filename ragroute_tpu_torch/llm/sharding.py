"""Tensor-parallel decoder over a ``(dp, idx)`` mesh.

Port of :mod:`ragroute_tpu.llm.sharding`. The JAX package only annotates
the weights (``PartitionSpec``s over a mesh axis) and lets GSPMD insert the
collectives; here the Megatron layout is explicit and the decoder has a
forward of its own:

* ``wq`` / ``wk`` / ``wv`` and ``gate`` / ``up`` are split on their output
  axis: cell ``(d, i)`` holds query heads ``[i*H/n, (i+1)*H/n)``, KV heads
  ``[i*Hkv/n, (i+1)*Hkv/n)`` (so every query head stays with its KV head,
  as ``_attend``'s ``[Hkv, G]`` grouping needs) and an ``I/n`` slice of the
  MLP; q/k/v and the MLP's first products need no communication;
* ``wo`` and ``down`` are split on their input axis: each cell's product is
  a partial sum, moved to the row's first cell (``.to()``) and added there,
  and the hidden state goes back to every cell of the row;
* an untied ``lm_head`` is split on the vocabulary and its logits are
  concatenated on the row's first cell; a tied head is computed once there;
* the norms and the embedding are replicated;
* the KV cache is split on its KV-head axis as ``wk`` / ``wv`` are, so
  attention reads only the cell's own slice (a float cache, or int8 codes
  with per-(position, head) scales);
* the batch is split over the ``dp`` rows (``data_spec``), and the rows'
  results are gathered on ``mesh.primary``.

Each cell's slices live on its device. Where several cells share a device
(``cuda:0`` named eight times; the CPU in the tests) a slice is a view of
the unsharded weight, so a mesh of one card costs no weight memory.

A :class:`TPDecoder` goes wherever a ``Decoder`` goes: ``generate``,
``prefill``, ``decode_step`` and both generation services, with the
shared-prefix KV, an int8 cache and speculative windows. It implements the
five methods through which the engines reach a ``Decoder``'s weights
(``embed_lookup``, ``logits``, ``init_cache``, ``prefill_layers``,
``decode_layers``); values that live in the cells (fresh K/V, cache
planes, the prefix KV) are :class:`Split` tensors, which the engines index,
stack and write into the cache as they do plain tensors. Weights are
float: the JAX layout has no spec for quantized matrices, so ``QuantW`` /
``QuantW4`` are refused.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ragroute_tpu_torch.llm.model import (Decoder, DecoderConfig,
                                          DecoderLayer, QuantW, QuantW4,
                                          _attend, _embed_lookup, _mlp, _mm,
                                          _qkv, _rms, cache_read, cache_write,
                                          init_cache)
from ragroute_tpu_torch.parallel.mesh import Mesh, batch_rows

Tensor = torch.Tensor
Rows = List[Tuple[int, int]]


def decoder_param_specs(cfg: DecoderConfig, axis: str = "idx") -> Dict:
    """How each weight splits, as the JAX package's ``PartitionSpec`` tree
    (a spec is a tuple: ``(None, axis)`` splits the output axis, ``(axis,
    None)`` the input axis, ``()`` replicates)."""
    layer = {
        "ln1": (), "ln2": (),
        "wq": (None, axis), "wk": (None, axis), "wv": (None, axis),
        "wo": (axis, None),
        "gate": (None, axis), "up": (None, axis),
        "down": (axis, None),
    }
    if cfg.qk_norm:
        layer["q_norm"] = ()
        layer["k_norm"] = ()
    specs = {
        "embed": (),
        "ln_f": (),
        "layers": [dict(layer) for _ in range(cfg.num_layers)],
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = (None, axis)
    return specs


def data_spec(mesh: Mesh, dp_axis: str = "dp") -> Tuple:
    """Batch split of input_ids / attention_mask: over the mesh's data axis
    when it has more than one row, else replicated."""
    if mesh.shape.get(dp_axis, 1) > 1:
        return (dp_axis, None)
    return (None, None)


def _on(t, dev):
    return t.to(dev) if isinstance(t, Tensor) else t


class Split:
    """A logical tensor laid out over a mesh's cells: ``parts[d][i]`` (on
    ``mesh.devices[d][i]``) holds head block ``i`` of axis ``hax`` and, when
    ``bax`` is set, the batch rows ``rows[d]`` of axis ``bax``; without it
    every dp row holds all of them. A cache plane (``spare``) has one more
    batch row a cell, never read, where a write whose target row lives in
    another dp row lands."""

    def __init__(self, mesh: Mesh, parts, *, hax: int,
                 bax: Optional[int] = None, rows: Optional[Rows] = None,
                 spare: bool = False):
        self.mesh = mesh
        self.parts = parts
        self.hax, self.bax, self.rows, self.spare = hax, bax, rows, spare

    @property
    def shape(self) -> torch.Size:
        s = list(self.parts[0][0].shape)
        s[self.hax] = sum(p.shape[self.hax] for p in self.parts[0])
        if self.bax is not None:
            s[self.bax] = self.rows[-1][1]
        return torch.Size(s)

    def _like(self, parts, hax, bax) -> "Split":
        return Split(self.mesh, parts, hax=hax, bax=bax,
                     rows=self.rows if bax is not None else None)

    def __getitem__(self, index) -> "Split":
        """Basic indexing by ints and whole slices, never on the head axis.
        An int on the batch axis picks that row from the dp row holding it
        and hands a copy to every dp row (``k[:, 0]`` of a prefix)."""
        index = index if isinstance(index, tuple) else (index,)
        if not all(isinstance(x, int) or (isinstance(x, slice)
                                          and x == slice(None))
                   for x in index):
            raise IndexError(f"a Split takes ints and ':' only, got {index}")
        if len(index) > self.hax and index[self.hax] != slice(None):
            raise IndexError("a Split is not indexed on its head axis")

        def shift(ax):
            return ax - sum(isinstance(x, int) for x in index[:ax])

        hax = shift(self.hax)
        if (self.bax is not None and len(index) > self.bax
                and isinstance(index[self.bax], int)):
            r = index[self.bax]
            d = next(d for d, (lo, hi) in enumerate(self.rows) if lo <= r < hi)
            local = list(index)
            local[self.bax] = r - self.rows[d][0]
            src = [p[tuple(local)] for p in self.parts[d]]
            parts = [[s.to(dev) for s, dev in zip(src, row)]
                     for row in self.mesh.devices]
            return self._like(parts, hax, None)
        parts = [[p[index] for p in row] for row in self.parts]
        return self._like(parts, hax,
                          None if self.bax is None else shift(self.bax))

    @classmethod
    def stack(cls, splits: Sequence["Split"]) -> "Split":
        """``torch.stack`` on a new leading axis, cell by cell."""
        s0 = splits[0]
        parts = [[torch.stack([s.parts[d][i] for s in splits])
                  for i in range(len(row))] for d, row in enumerate(s0.parts)]
        return s0._like(parts, s0.hax + 1,
                        None if s0.bax is None else s0.bax + 1)

    def _whole_batch(self, d: int, i: int) -> Tensor:
        """Head block ``i`` of every batch row, on cell ``(d, i)``."""
        dev = self.mesh.devices[d][i]
        if self.bax is None:
            return self.parts[d][i]
        if len(self.parts) == 1:
            return self.parts[0][i]
        return torch.cat([row[i].to(dev) for row in self.parts], dim=self.bax)

    def write_into(self, cache: Dict[str, "Split"], name: str,
                   index: tuple) -> None:
        """``cache_write`` of this K or V into a tensor-parallel cache:
        ``index`` is ``(layer, batch rows, positions...)`` over the whole
        batch. A slice of the batch axis takes each dp row's own rows (this
        value's batch split must be the cache's); a tensor of target rows
        sends every row's head block to each dp row, which keeps the
        entries whose target it holds and sends the rest to its spare
        row."""
        plane = cache[name]
        bidx = index[1]
        for d, row in enumerate(self.mesh.devices):
            lo, hi = plane.rows[d]
            for i, dev in enumerate(row):
                cell = {n: p.parts[d][i] for n, p in cache.items()}
                if isinstance(bidx, slice):
                    if (bidx.start not in (None, 0) or bidx.step is not None
                            or bidx.stop not in (None, plane.shape[1])
                            or self.rows != plane.rows):
                        raise ValueError(
                            "a tensor-parallel cache takes batch slices only "
                            "of its own whole batch, split as it is")
                    local = (index[0], slice(0, hi - lo)) + index[2:]
                    payload = self.parts[d][i]
                else:
                    payload = self._whole_batch(d, i)
                    r = bidx.to(dev)
                    if plane.spare:
                        r = torch.where((r >= lo) & (r < hi), r - lo, hi - lo)
                    local = ((_on(index[0], dev), r)
                             + tuple(_on(x, dev) for x in index[2:]))
                cache_write(cell, name, payload, local)


def _add_on(acc: Optional[Tensor], part: Tensor, dev) -> Tensor:
    """The row reduction: a cell's partial sum moved to ``dev`` and added."""
    part = part.to(dev)
    return part if acc is None else acc + part


class TPDecoder:
    """A decoder's weights laid out over a mesh (``shard_decoder_params``):
    ``cells[d][i]`` is a :class:`Decoder` of cell ``(d, i)``'s slices, with
    ``cell_cfg`` its head counts (``H/n``, ``Hkv/n``)."""

    def __init__(self, mesh: Mesh, cfg: DecoderConfig,
                 cells: List[List[Decoder]]):
        n = mesh.shape["idx"]
        self.mesh = mesh
        self.cfg = cfg
        self.cells = cells
        self.cell_cfg = dataclasses.replace(
            cfg, num_heads=cfg.num_heads // n,
            num_kv_heads=cfg.num_kv_heads // n)

    @property
    def ln_f(self) -> Tensor:
        """The primary cell's replica: ``params_device`` reads its device."""
        return self.cells[0][0].ln_f

    def _rows(self, batch: int) -> Rows:
        return batch_rows(batch, self.mesh.shape["dp"])

    def embed_lookup(self, ids: Tensor) -> Tensor:
        return _embed_lookup(self.cells[0][0], ids)

    def init_cache(self, cfg: DecoderConfig, batch: int, max_len: int,
                   dtype) -> Dict[str, Split]:
        """A ``[L, B, S, Hkv, Dh]`` cache (int8: with ``ks`` / ``vs``) split
        over the cells: batch rows over dp, KV heads over idx."""
        rows = self._rows(batch)
        spare = len(rows) > 1
        cells = [[init_cache(self.cell_cfg, hi - lo + spare, max_len, dtype,
                             device=dev) for dev in row]
                 for row, (lo, hi) in zip(self.mesh.devices, rows)]
        return {name: Split(self.mesh,
                            [[c[name] for c in row] for row in cells],
                            hax=3, bax=1, rows=rows, spare=spare)
                for name in cells[0][0]}

    def _stack(self, cfg: DecoderConfig, h: Tensor, positions: Tensor,
               kmask: Tensor, inv_freq: Tensor, prefix_kv, cache, write):
        devs = self.mesh.devices
        lcfg = self.cell_cfg
        rows = self._rows(h.shape[0])
        hs = [h[lo:hi].to(row[0]) for row, (lo, hi) in zip(devs, rows)]

        def per_cell(t):
            return [[t[lo:hi].to(dev) for dev in row]
                    for row, (lo, hi) in zip(devs, rows)]

        pos, km = per_cell(positions), per_cell(kmask)
        inv = [[inv_freq.to(dev) for dev in row] for row in devs]
        ks, vs = [], []
        for li in range(cfg.num_layers):
            q = [[None] * len(row) for row in devs]
            k = [[None] * len(row) for row in devs]
            v = [[None] * len(row) for row in devs]
            for d, row in enumerate(devs):
                x = _rms(hs[d], self.cells[d][0].layers[li].ln1, cfg.rms_eps)
                for i, dev in enumerate(row):
                    q[d][i], k[d][i], v[d][i] = _qkv(
                        self.cells[d][i].layers[li], lcfg, x.to(dev),
                        pos[d][i], inv[d][i])
            kk = Split(self.mesh, k, hax=2, bax=0, rows=rows)
            vv = Split(self.mesh, v, hax=2, bax=0, rows=rows)
            if cache is None:
                ks.append(kk)
                vs.append(vv)
            else:
                write(cache, li, kk, vv)
            for d, row in enumerate(devs):
                nd = rows[d][1] - rows[d][0]
                acc = None
                for i in range(len(row)):
                    layer = self.cells[d][i].layers[li]
                    if cache is None:
                        ck, cv, ksc, vsc = k[d][i], v[d][i], None, None
                    else:
                        cell = {n: p.parts[d][i] for n, p in cache.items()}
                        ck, ksc = cache_read(cell, "k", li)
                        cv, vsc = cache_read(cell, "v", li)
                        ck, cv = ck[:nd], cv[:nd]
                        ksc = None if ksc is None else ksc[:nd]
                        vsc = None if vsc is None else vsc[:nd]
                    pkv = (None if prefix_kv is None else
                           (prefix_kv[0].parts[d][i][li],
                            prefix_kv[1].parts[d][i][li]))
                    ctx = _attend(q[d][i], ck, cv, km[d][i], lcfg,
                                  k_scale=ksc, v_scale=vsc, prefix_kv=pkv)
                    acc = _add_on(acc, _mm(ctx, layer.wo), row[0])
                hs[d] = hs[d] + acc.to(hs[d].dtype)
                x = _rms(hs[d], self.cells[d][0].layers[li].ln2, cfg.rms_eps)
                acc = None
                for i, dev in enumerate(row):
                    acc = _add_on(acc, _mlp(self.cells[d][i].layers[li],
                                            x.to(dev)), row[0])
                hs[d] = hs[d] + acc.to(hs[d].dtype)
        return torch.cat([x.to(self.mesh.primary) for x in hs]), ks, vs

    def prefill_layers(self, cfg, h, positions, kmask, *, inv_freq,
                       prefix_kv=None):
        return self._stack(cfg, h, positions, kmask, inv_freq, prefix_kv,
                           None, None)

    def decode_layers(self, cfg, h, positions, kmask, cache, write, *,
                      inv_freq, prefix_kv=None):
        return self._stack(cfg, h, positions, kmask, inv_freq, prefix_kv,
                           cache, write)[0]

    def logits(self, cfg: DecoderConfig, h: Tensor) -> Tensor:
        out = []
        for d, (row, (lo, hi)) in enumerate(zip(self.mesh.devices,
                                                self._rows(h.shape[0]))):
            first = self.cells[d][0]
            x = _rms(h[lo:hi].to(row[0]), first.ln_f, cfg.rms_eps)
            if cfg.tie_embeddings:
                lg = _mm(x, first.embed.T)
            else:
                lg = torch.cat([_mm(x.to(dev), self.cells[d][i].lm_head)
                                .to(row[0]) for i, dev in enumerate(row)],
                               dim=-1)
            out.append(lg.to(self.mesh.primary))
        return torch.cat(out)


def shard_decoder_params(params: Decoder, cfg: DecoderConfig, mesh: Mesh,
                         axis: str = "idx") -> TPDecoder:
    """Lay a decoder out over the mesh in the tensor-parallel layout. The
    split axes must divide the axis size (num_kv_heads and
    intermediate_size are the binding ones)."""
    n = mesh.shape[axis]
    if cfg.num_kv_heads % n:
        raise ValueError(
            f"num_kv_heads={cfg.num_kv_heads} not divisible by mesh "
            f"axis {axis!r}={n}")
    if cfg.intermediate_size % n:
        raise ValueError(
            f"intermediate_size={cfg.intermediate_size} not divisible "
            f"by mesh axis {axis!r}={n}")
    if axis != "idx":
        raise ValueError(
            f"the tensor-parallel decoder splits its weights over 'idx' and "
            f"the batch over 'dp' (got axis {axis!r})")
    if mesh.multiprocess:
        raise ValueError("the tensor-parallel decoder runs in one process")
    quant = [name for name, w in params.items()
             if isinstance(w, (QuantW, QuantW4))]
    quant += [f"layers.{li}.{name}" for li, layer in enumerate(params.layers)
              for name, w in layer.items()
              if isinstance(w, (QuantW, QuantW4))]
    if quant:
        raise ValueError(
            f"tensor-parallel sharding takes float weights; {quant[0]} is "
            f"quantized ({len(quant)} matrices): the JAX layout has no spec "
            f"for QuantW / QuantW4")
    specs = decoder_param_specs(cfg, axis)

    def piece(w: Tensor, spec: tuple, i: int, dev) -> Tensor:
        if spec == (None, axis):
            w = w.tensor_split(n, dim=1)[i]
        elif spec == (axis, None):
            w = w.tensor_split(n, dim=0)[i]
        return w.to(dev)

    cells = [[Decoder({name: piece(w, specs[name], i, dev)
                       for name, w in params.items()},
                      [DecoderLayer({name: piece(w, specs["layers"][li][name],
                                                 i, dev)
                                     for name, w in layer.items()})
                       for li, layer in enumerate(params.layers)])
              for i, dev in enumerate(row)]
             for row in mesh.devices]
    return TPDecoder(mesh, cfg, cells)
