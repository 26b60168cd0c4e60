"""Plans of the deep top-k lists (``csrc/deep_topk.cuh``), as pure functions.

The three top-k kernels keep a list per row in a warp or a thread up to a
depth of :data:`SHALLOW_MAX` (160); a deeper list, which the TPU kernels
take as readily as a shallow one, is built from gains in device memory: runs
of at most :data:`RUN` positions are selected and sorted by one block each,
then the runs' sorted lists of a row merge in pairs, cut to ``k`` after
every level, until one list remains (:func:`list_levels`). The functions
here say how a launch is cut (runs, chunks of docs, slices of rows) and how
large its workspace is; the wrappers allocate what they say and the CUDA
launchers walk the same plan. A workspace is sized from a cap of
:data:`WORKSPACE_CAP` bytes (or the ``cap`` a caller passes, as the checks
do to force chunks and slices at a small size), never from the card's free
memory.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

SHALLOW_MAX = 160            # deepest list of the shallow paths (KMAX)
RUN = 8192                   # positions a select block holds (RUN_MAX)
WORD = 8                     # bytes of a list entry (key << 32 | ~position)
WORKSPACE_CAP = 256 << 20    # bytes of one deep launch's workspace
MAX_CHUNK = 1 << 21          # K1: docs a chunk (grid.y of its gain kernel)
# K1's deep fold (csrc/fused_topk.cu): the deepest list it takes (a warp
# sorts a row's list in shared memory), and the candidate slots a (row,
# split) gets past its list, at least
FOLD_MAX_K = 1024
FOLD_SLACK = 32
# the sample each row's owner scans before the split to seed the row's
# bound: FOLD_SAMPLE_PER_K docs an entry of the list, in the scan's tiles of
# FOLD_TILE docs, at most FOLD_SAMPLE_MAX_TILES of them, for lists up to
# FOLD_SAMPLE_MAX_K (its words are cut in a warp's room of 1,024 in shared
# memory, which must take k and another 256). A larger sample seeds a
# tighter bound for more tiles of products: device ms at B = 512, k' = 128,
# d = 128, the 8k buffer, 6 / 8 / 12 docs an entry: 83,886 docs 0.442 /
# 0.447 / 0.466, 104,857 0.509 / 0.476 / 0.492, 125,829 0.663 / 0.525 /
# 0.534 (H100 80GB HBM3, 700.00 W, measure.py's FOLD_SWEEP_TIMER)
FOLD_SAMPLE_PER_K = 8
FOLD_TILE = 192     # the wgmma scan's doc tile (fused_topk.W_TILE_D)
FOLD_SAMPLE_MAX_TILES = 16
FOLD_SAMPLE_MAX_K = 512
# lists up to FOLD_WIDE_K over splits of at most FOLD_SHORT_TILES tiles get
# twice the candidate slots (fold_cap): the longest split read where the
# wider buffer did not lose
FOLD_WIDE_K = 128
FOLD_SHORT_TILES = 42


def list_levels(splits: int, kr: int, k: int) -> List[Tuple[int, int]]:
    """``(lists, length)`` of a row after each merge level: ``splits``
    sorted lists of ``kr`` entries merged in pairs (an odd one out passes
    through), each output cut to ``k``."""
    out, n, length = [], splits, kr
    while n > 1:
        n, length = -(-n // 2), min(k, 2 * length)
        out.append((n, length))
    return out


def list_entries(splits: int, kr: int, k: int) -> int:
    """Words a row of each ping-pong buffer holds: the runs' lists and every
    merge level but the last, which goes to the caller's destination; 0 for
    one run (the select writes the destination itself)."""
    if splits <= 1:
        return 0
    sizes = [splits * kr] + [n * length
                             for n, length in list_levels(splits, kr, k)[:-1]]
    return max(sizes)


class StreamPlan(NamedTuple):
    """K2's deep launch over ``[B, M]``: runs of ``run`` positions (as even
    as the run limit allows), rows in slices of ``rows``."""
    run: int
    splits: int
    kr: int
    rows: int
    entries: int            # words a row of ws_a and of ws_b
    workspace_bytes: int    # ws_a + ws_b + dst of one slice


def stream_plan(bsz: int, m: int, k: int,
                cap: Optional[int] = None) -> StreamPlan:
    cap = WORKSPACE_CAP if cap is None else cap
    splits = -(-m // RUN)
    run = -(-m // splits)
    kr = min(k, run)
    entries = list_entries(splits, kr, k)
    per_row = WORD * (2 * entries + (k if splits > 1 else 0))
    rows = bsz if per_row == 0 else max(1, min(bsz, cap // per_row))
    return StreamPlan(run, splits, kr, rows, entries, rows * per_row)


class FusedPlan(NamedTuple):
    """K1's deep launch: query rows in slices of ``rows``, docs in chunks of
    ``chunk`` (a multiple of :data:`RUN`, or all of them); each chunk's
    ``[rows, chunk]`` f32 gains are cut to ``kr`` a run of :data:`RUN`,
    merged to one list, and merged into the slice's running list of ``k``."""
    rows: int
    chunk: int
    splits: int             # runs of a full chunk
    kr: int
    entries: int            # words a row of ws_a and of ws_b
    workspace_bytes: int    # gains + ws_a + ws_b + two running lists


def _fused_row_bytes(chunk: int, k: int) -> Tuple[int, int, int]:
    splits = -(-chunk // RUN)
    kr = min(k, RUN)
    entries = list_entries(splits, kr, k)
    return 4 * chunk + WORD * (2 * entries + 2 * 2 * k), splits, entries


def fused_plan(bsz: int, n_rows: int, k: int,
               cap: Optional[int] = None) -> FusedPlan:
    """The largest chunk whose workspace for all ``bsz`` rows stays under
    ``cap`` (default :data:`WORKSPACE_CAP`); if even one run's chunk does
    not, fewer rows a slice (at least one: a single row's need above the
    cap, k in the millions, is taken whole)."""
    cap = WORKSPACE_CAP if cap is None else cap
    whole = min(n_rows, MAX_CHUNK)
    chunk = whole if whole <= RUN else -(-whole // RUN) * RUN
    chunk = min(chunk, MAX_CHUNK)
    while True:
        per_row, splits, entries = _fused_row_bytes(chunk, k)
        if bsz * per_row <= cap or chunk <= RUN:
            break
        chunk = max(RUN, (chunk // 2) // RUN * RUN)
    rows = max(1, min(bsz, cap // per_row))
    return FusedPlan(rows, chunk, splits, min(k, RUN), entries,
                     rows * per_row)


def fold_cap(k: int, tiles_per_split: Optional[int] = None) -> int:
    """Candidate slots a (row, split) of K1's deep fold: four times its
    list, on the 32-slot grid (a quarter a lane of the row's quad), and
    twice that for lists up to :data:`FOLD_WIDE_K` over splits of at most
    :data:`FOLD_SHORT_TILES` tiles. A row's own bound rises only at a cut,
    and a cut stalls both consumer groups; over a short split the seeded
    bound leaves few enough candidates that the larger buffer needs no cut.
    Device ms at B = 512, d = 128 (33 splits), 4x / 8x, k' = 128: splits of
    14 tiles (83,886 docs) 0.585 / 0.447, 17 0.620 / 0.476, 20 0.665 /
    0.525, 42 (262,144) 1.099 / 1.080, 64 (400,000) 1.413 / 1.452, 87
    1.719 / 1.746, 116 (734,003) 1.975 / 2.010; k' = 256: 14 tiles 0.581 /
    0.609, 20 0.650 / 0.676, 116 2.455 / 4.202, where the cuts raise the
    bound (H100 80GB HBM3, 700.00 W, ``measure.py``'s
    ``FOLD_SWEEP_TIMER``; lists between 129 and 255 not read)."""
    base = max(k + FOLD_SLACK, -(-4 * k // 32) * 32)
    if (tiles_per_split is not None and k <= FOLD_WIDE_K
            and tiles_per_split <= FOLD_SHORT_TILES):
        return 2 * base
    return base


def fold_sample_tiles(k: int) -> int:
    """Doc tiles of the sample a row's owner scans first in K1's deep fold:
    :data:`FOLD_SAMPLE_PER_K` docs an entry of the list (6 tiles at k =
    128), at most :data:`FOLD_SAMPLE_MAX_TILES`. Its k-th best is about the
    shard's ``(k N / sample)``-th, which leaves a (row, split) of ``t``
    tiles about ``k t / sample tiles`` candidates: no cut in the scan at
    the low-rank world's small shards. None past
    :data:`FOLD_SAMPLE_MAX_K`."""
    if k > FOLD_SAMPLE_MAX_K:
        return 0
    return min(FOLD_SAMPLE_MAX_TILES, -(-FOLD_SAMPLE_PER_K * k // FOLD_TILE))


def fold_bytes(bsz: int, splits: int, k: int,
               tiles_per_split: Optional[int] = None) -> int:
    """Device memory of a deep fold's launch: every (row, split)'s
    candidate words, and every row's sample words and running list of
    ``k`` (a word an entry)."""
    return bsz * WORD * (splits * fold_cap(k, tiles_per_split)
                         + fold_sample_tiles(k) * FOLD_TILE + k)


class PairPlan(NamedTuple):
    """K4's deep launch: pair blocks in chunks of ``blocks``; each chunk's
    scaled and biased gains ``[blocks * 256, S]`` are cut to ``ranks`` a
    tile of ``tds`` slots and the tiles' lists merged to ``kw``."""
    blocks: int
    entries: int            # words a row of ws_a and of ws_b
    workspace_bytes: int    # gains + ws_a + ws_b + dst of one chunk


def pair_plan(n_blocks: int, s: int, tds: int, ranks: int, kw: int,
              rows_per_block: int = 256,
              cap: Optional[int] = None) -> PairPlan:
    cap = WORKSPACE_CAP if cap is None else cap
    n_tiles = -(-s // tds)
    entries = list_entries(n_tiles, ranks, kw)
    per_row = 4 * s + WORD * (2 * entries + kw)
    blocks = max(1, min(n_blocks, cap // (rows_per_block * per_row)))
    return PairPlan(blocks, entries, blocks * rows_per_block * per_row)


STEPS = {1: "arguments", 2: "select shared memory", 3: "select", 4: "merge",
         5: "emit", 6: "gains", 7: "memset", 8: "running merge"}


def describe(code: int) -> str:
    """The step and CUDA error of a failed deep launch's return code
    (``deep::fail`` in ``csrc/deep_topk.cuh``)."""
    step, err = divmod(int(code), 1000)
    return f"{STEPS.get(step, f'step {step}')} step, CUDA error {err}"

