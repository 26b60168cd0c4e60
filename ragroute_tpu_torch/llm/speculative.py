"""Prompt-lookup speculative decoding for the slot engine, on the device.

Port of :mod:`ragroute_tpu.llm.speculative`. RAG answers quote the
retrieved context, so the cheapest draft ("find the current bigram earlier
in this slot's own token history and copy what followed it") is accepted
often exactly where this system generates. A chunk of steps runs with no
host read:

* draft: each slot matches its last two tokens against its history (the
  latest match wins) and copies the following W-1 tokens;
* verify: one forward over the W-token window (the fed token plus the
  drafts) with per-slot ragged positions; the longest prefix of drafts that
  equals the greedy chain is accepted, plus one bonus token;
* commit: accepted tokens' K/V are already in the cache; rejected entries
  lie beyond the advanced ``counts``, are masked by every later key mask,
  and are overwritten.

Speculative decoding emits the same tokens as plain greedy decoding;
greedy only (the service refuses ``temperature > 0`` with a window).
"""

from __future__ import annotations

import torch

from ragroute_tpu_torch.llm.model import (DecoderConfig, cache_write,
                                          inv_freq_tensor)

Tensor = torch.Tensor


def draft_from_history(toks: Tensor, counts: Tensor, window: int) -> Tensor:
    """For each row, the ``window-1`` tokens that followed the LATEST
    earlier occurrence of the bigram ``(toks[c-1], toks[c])`` (c =
    counts). toks: [B, S] history (valid in [0, c]); counts: [B]. Returns
    drafts [B, window-1] int32 (arbitrary tokens when nothing matches:
    verification makes any draft safe)."""
    b, s = toks.shape
    iota = torch.arange(s, device=toks.device)
    t1 = torch.gather(toks, 1, (counts - 1).clamp_min(0)[:, None].long())
    t2 = torch.gather(toks, 1, counts[:, None].long())
    nxt = torch.cat([toks[:, 1:], toks[:, -1:]], dim=1)
    # match at j: (toks[j], toks[j+1]) == (t1, t2), far enough from the
    # tail that the whole continuation toks[j+2 : j+window+1] is known
    match = ((toks == t1) & (nxt == t2)
             & (iota[None, :] + window <= counts[:, None]))
    m = torch.where(match, iota[None, :], -1).amax(dim=1)      # [B]
    src = m[:, None] + 2 + torch.arange(window - 1, device=toks.device)[None]
    src = src.clamp(0, s - 1)
    return torch.gather(toks, 1, src.long()).to(torch.int32)


def spec_decode_chunk(params, cfg: DecoderConfig, state, steps: int,
                      window: int, eos_id: int, pad_id: int,
                      prefix_kv=None, pos0: int = 0):
    """``steps`` speculative verify-steps over every slot. Each step drafts
    ``window-1`` tokens from the slot's history and verifies the window in
    one forward; 1..window tokens commit per step per slot.

    Returns (state, tokens [steps, slots, window], n_emitted [steps,
    slots]): step s emits ``tokens[s, b, :n[s, b]]`` for slot b.
    ``prefix_kv``/``pos0``: shared-prefix serving (histories hold only the
    post-prefix tokens; positions offset by ``pos0``)."""
    cache, counts, tok, active, budget, tstep, toks = state
    dev = counts.device
    inv_freq = inv_freq_tensor(cfg, dev)
    s_max = cache["k"].shape[2]
    n_slots = counts.shape[0]
    rows = torch.arange(n_slots, device=dev)
    w = window
    iw = torch.arange(w, device=dev)
    iota = torch.arange(s_max, device=dev)
    out_toks, out_n = [], []
    for _ in range(steps):
        # the fed token enters the history first, so the draft bigram is
        # (toks[c-1], toks[c])
        toks[rows, counts.long()] = tok
        drafts = draft_from_history(toks, counts, w)           # [B, w-1]
        fed = torch.cat([tok[:, None], drafts], dim=1)         # [B, w]
        dpos = (counts[:, None] + 1 + iw[None, :w - 1]).clamp(0, s_max - 1)
        toks[rows[:, None], dpos.long()] = drafts

        slot_positions = counts[:, None] + iw[None, :]         # [B, w]
        positions = pos0 + slot_positions
        kmask = iota[None, None, :] <= slot_positions[:, :, None]  # [B,w,S]
        slot_pos = slot_positions.clamp(0, s_max - 1).long()

        def write(cache, li, k, v):
            at_window = (li, rows[:, None], slot_pos)
            cache_write(cache, "k", k, at_window)
            cache_write(cache, "v", v, at_window)

        h = params.embed_lookup(fed)                           # [B, w, D]
        h = params.decode_layers(cfg, h, positions, kmask, cache, write,
                                 inv_freq=inv_freq, prefix_kv=prefix_kv)
        logits = params.logits(cfg, h)                         # [B, w, V]
        greedy = torch.argmax(logits, dim=-1).to(torch.int32)

        # accept the longest prefix of drafts matching the greedy chain
        ok = drafts == greedy[:, :w - 1]                       # [B, w-1]
        prefix = torch.cumprod(ok.to(torch.int32), dim=1)
        n_emit = 1 + prefix.sum(dim=1, dtype=torch.int32)      # [B] 1..w
        # truncate at the first emitted eos
        emit_mask = iw[None, :] < n_emit[:, None]
        is_eos = (greedy == eos_id) & emit_mask
        first_eos = torch.where(is_eos, iw[None, :], w).amin(dim=1)
        n_emit = torch.minimum(n_emit, first_eos + 1)
        # budget caps (exact: never emit past the budget)
        n_emit = torch.minimum(n_emit, budget)
        n_emit = torch.where(active, n_emit, 0).to(torch.int32)

        emit_mask = iw[None, :] < n_emit[:, None]
        out = torch.where(emit_mask, greedy, pad_id).to(torch.int32)
        last = torch.gather(out, 1,
                            (n_emit - 1).clamp_min(0)[:, None].long())[:, 0]
        tok = torch.where(active & (n_emit > 0), last, tok).to(torch.int32)
        counts = counts + n_emit
        budget = budget - n_emit
        done = active & ((first_eos < w) | (budget <= 0)
                         | (counts >= s_max - w - 1))
        active = active & ~done
        tstep += 1
        out_toks.append(out)
        out_n.append(n_emit)
    state = (cache, counts, tok, active, budget, tstep, toks)
    return state, torch.stack(out_toks), torch.stack(out_n)
