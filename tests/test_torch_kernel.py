"""Card-only tests: the hand-written kernels (csrc/fused_topk.cu with its
wgmma scan over bf16, int8 and int4 docs, its deep fold, its f32 scan and
its small-batch f32 scan, csrc/stream_topk.cu with its select path and its
collect, csrc/grouped_gains.cu with its wgmma and f32 kernels,
csrc/grouped_pair_topk.cu with its wgmma kernel,
csrc/int4_matmul.cu with its prefill and decode kernels,
csrc/decode_attention.cu) against their plain PyTorch versions, at test
size, the host-RAM tiers' engine on the card against the same engine on the
CPU, the int4 decoder's greedy tokens on the card against the CPU's, and
the router trainer's steps on the card against the CPU's.

A CUDA kernel has no CPU mode, so every test here needs a card; the
``cuda`` fixture decides that (never at import) and skips otherwise. On the
card, run them with::

    python -m pytest --noconftest -m gpu tests/test_torch_kernel.py

(``--noconftest``: the suite's conftest imports jax, which the card's
machine does not have; this file imports only torch and the port.)
"""

import pytest
import torch

from ragroute_tpu_torch.ops import kernel_checks as kc
from ragroute_tpu_torch.ops.fused_topk import fused_topk
from ragroute_tpu_torch.ops.grouped_gains import grouped_gains
from ragroute_tpu_torch.ops.stream_topk import (stream_topk,
                                                stream_topk_reference)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from ragroute_tpu_torch.utils.precision import resolve_device

    return resolve_device("cuda")


def test_kernel_exact_cases_equal_plain(cuda):
    """Integer data: indices and scores equal the plain version exactly,
    ties (across tiles, splits and the k boundary) to the lower index."""
    failed = []
    for case in kc.exact_cases(cuda):
        (ks, ki), (ps, pi) = kc.run_pair(case)
        torch.cuda.synchronize()
        if not (torch.equal(ki, pi) and torch.equal(ks, ps)):
            failed.append(case.name)
    assert not failed, failed


def test_mutable_exact_cases_equal_plain(cuda):
    """Live shards (the capacity scanned whole, -inf bias holes anywhere,
    fewer live rows than k): every launch, by name and through the plan,
    equals the plain version exactly."""
    failed = []
    for case, route in kc.mutable_exact_cases(cuda):
        ps, pi = kc.run_plain(case)
        for kernel in (None, route):
            ks, ki = kc.run_kernel(case, kernel)
            torch.cuda.synchronize()
            if not (torch.equal(ki, pi) and torch.equal(ks, ps)):
                failed.append(f"{case.name}:{kernel or 'plan'}")
    assert not failed, failed


@pytest.mark.parametrize("bsz,n,valid", [(64, 20_000, 20_000),
                                         (8, 50_000, 49_990),
                                         (130, 4_160, 4_100)])
def test_kernel_bf16_matches_plain_within_tolerance(cuda, bsz, n, valid):
    """bf16 operands, different summation order: scores within
    1e-3 * max|score|, and only near-ties may swap at the k boundary."""
    case = kc.path_case(cuda, bsz=bsz, n=n, d=128, k=32, seed=bsz)
    case.valid_docs = valid
    kernel, plain = kc.run_pair(case)
    res = kc.compare_tolerant(kernel, plain)
    assert res["ok"], res
    assert res["recall"] >= 0.999, res
    assert int(kernel[1].max()) < valid


def test_kernel_counts_launches_and_raises_on_what_it_does_not_take(cuda):
    q = torch.randn(4, 64, device=cuda)
    docs = torch.randn(300, 64, device=cuda)
    before = fused_topk.launches
    fused_topk(q, docs, 8)
    assert fused_topk.launches == before + 1
    with pytest.raises(ValueError):
        fused_topk(torch.randn(4, 40, device=cuda),
                   torch.randn(300, 40, device=cuda), 8)  # d % 16
    packed = torch.zeros(300, 32, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):                     # groups of 4 dims
        fused_topk(q, packed, 8, packed4=True,
                   scale=torch.ones(300, 16, device=cuda))
    with pytest.raises(ValueError):                     # l2 needs its bias
        fused_topk(q, packed, 8, packed4=True, mode="l2")
    with pytest.raises(TypeError):
        fused_topk(q, docs.half(), 8)                   # fp16 docs
    assert fused_topk.launches == before + 1
    fused_topk(q, packed, 8, packed4=True)              # int4 launches
    fused_topk(q, docs, 160)          # the shallow launch's deepest list
    deep, fold = fused_topk.deep_launches, fused_topk.fold_launches
    fused_topk(q, docs, 161)          # past it, f32: the deep launch
    fused_topk(q, packed, 300, packed4=True)    # int4: the deep fold
    assert fused_topk.launches == before + 5
    assert fused_topk.deep_launches == deep + 1
    assert fused_topk.fold_launches == fold + 1


@pytest.mark.parametrize("kernel", [None, "wgmma"])
def test_wgmma_scan_exact_cases_equal_plain(cuda, kernel):
    """bf16 docs through the wgmma scan (``kernel="wgmma"``: every case,
    k 10 to 64; None: the wrapper's plan, the same launch): a partial
    query block, partial doc
    tiles, contraction chunks past d, a -inf bias tail, valid_docs < N and
    splits of several tiles; indices and scores equal the plain version."""
    failed = []
    for case in kc.wgmma_exact_cases(cuda):
        got = kc.run_kernel(case, kernel)
        want = kc.run_plain(case)
        torch.cuda.synchronize()
        if not (torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])):
            failed.append(case.name)
    assert not failed, failed


@pytest.mark.parametrize("bsz,n,d,k", [(300, 60_000, 768, 32),
                                       (8, 100_003, 768, 64),
                                       (200, 30_000, 768, 64),
                                       (512, 50_000, 128, 32)])
def test_wgmma_scan_matches_plain_within_tolerance(cuda, bsz, n, d, k):
    case = kc.path_case(cuda, bsz=bsz, n=n, d=d, k=k, seed=bsz + k)
    before = fused_topk.launches
    kernel = kc.run_kernel(case, "wgmma")
    assert fused_topk.launches == before + 1
    res = kc.compare_tolerant(kernel, kc.run_plain(case))
    assert res["ok"], res
    assert res["recall"] >= 0.999, res


@pytest.mark.parametrize("bsz,n,d,k", [(200, 30_000, 768, 160),
                                       (512, 50_000, 128, 128),
                                       (8, 100_003, 128, 256),
                                       (512, 83_886, 128, 128),
                                       (512, 104_857, 128, 256),
                                       (512, 125_829, 768, 128)])
def test_deep_fold_matches_plain_within_tolerance(cuda, bsz, n, d, k):
    """The wgmma scan's deep fold on random bf16 data (lists past 64, where
    the scan's own lists stop)."""
    case = kc.path_case(cuda, bsz=bsz, n=n, d=d, k=k, seed=bsz + k)
    before = fused_topk.fold_launches
    kernel = kc.run_kernel(case, "fold")
    assert fused_topk.fold_launches == before + 1
    res = kc.compare_tolerant(kernel, kc.run_plain(case))
    assert res["ok"], res
    assert res["recall"] >= 0.999, res


@pytest.mark.parametrize("kernel", [None, "wgmma"])
def test_quant_scan_exact_cases_equal_plain(cuda, kernel):
    """int8 and int4 docs (no, per-doc and per-group scales) through the
    wgmma scan (``kernel="wgmma"``: every case, k 10 to 64; None: the
    wrapper's plan): partial doc tiles, packed rows shorter than a raw box
    and split across boxes, a -inf bias tail, valid_docs < N and splits of
    several tiles; indices and scores equal the plain version, one launch
    a call."""
    failed, n = [], 0
    before = fused_topk.launches
    for case in kc.quant_exact_cases(cuda):
        got = kc.run_kernel(case, kernel)
        want = kc.run_plain(case)
        torch.cuda.synchronize()
        if not (torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])):
            failed.append(case.name)
        n += 1
    assert not failed, failed
    assert fused_topk.launches == before + n


@pytest.mark.parametrize("grouped", [False, True])
def test_quant_scan_int4_matches_plain_within_tolerance(cuda, grouped):
    """Random packed nibbles through the scan: only the summation order
    differs from the plain version."""
    case = kc.int4_path_case(cuda, grouped=grouped, bsz=200, n=50_000,
                             d=768, k=32)
    case.valid_docs = 49_990
    kernel = kc.run_kernel(case, "wgmma")
    res = kc.compare_tolerant(kernel, kc.run_plain(case))
    assert res["ok"] and res["recall"] >= 0.999, res
    assert int(kernel[1].max()) < 49_990


def test_quant_scan_plan_and_refusals(cuda):
    """The wrapper sends int8 and int4 (d % 32) to the scan, keeps int4
    rows of 40 bytes and f32 on the first design, and the scan refuses
    those when it is named."""
    from ragroute_tpu_torch.ops import fused_topk as ft

    q = torch.randn(4, 80, device=cuda)
    packed = torch.zeros(300, 40, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="does not take"):
        ft._launch(q.to(torch.bfloat16), packed, 8, 300, None, None,
                   packed4=True, kernel="wgmma")
    before = fused_topk.launches
    fused_topk(q, packed, 8, packed4=True)          # the first design
    fused_topk(q, torch.zeros(300, 80, dtype=torch.int8, device=cuda), 8)
    assert fused_topk.launches == before + 2


def test_kernel_deep_exact_cases_equal_plain(cuda):
    """k 161 to 1,100 over 20,000 integer docs (three select runs, ties
    across runs, merges and the k boundary; f32 / bf16 / int8 / int4; k past
    the valid rows; a -inf tail; chunks and row slices forced by a small
    workspace cap): the deep launch's indices and scores equal the plain
    version's, one launch a call."""
    failed = []
    before, n = fused_topk.deep_launches, 0
    for case in kc.deep_exact_cases(cuda):
        ps, pi = kc.run_plain(case)
        ks, ki = kc.run_kernel(case, "deep")
        torch.cuda.synchronize()
        if not (torch.equal(ki, pi) and torch.equal(ks, ps)):
            failed.append(case.name)
        # the plan's launch (the deep fold where it takes the case) too
        ks, ki = kc.run_kernel(case)
        torch.cuda.synchronize()
        if not (torch.equal(ki, pi) and torch.equal(ks, ps)):
            failed.append(f"{case.name} {kc.fused_plan_of(case)}")
        n += 1 + (kc.fused_plan_of(case) == "deep")
    assert not failed, failed
    assert fused_topk.deep_launches == before + n


def test_kernel_deep_fold_exact_cases_equal_plain(cuda):
    """The wgmma scan's deep fold, k 65 to 1,024 over integer docs whose
    gains tie by the thousand (every row's buffer cut many times), bf16,
    int8 and int4 docs, a partial query block, partial doc tiles, splits of
    several tiles, one split under a small cap, lists past the valid rows,
    a -inf tail and ``valid_docs < N``: indices and scores equal the plain
    version's, through the fold named and through the plan, one fold launch
    a call."""
    failed = []
    before, n = fused_topk.fold_launches, 0
    for case in kc.fold_exact_cases(cuda):
        ps, pi = kc.run_plain(case)
        for kernel in ("fold", None):
            ks, ki = kc.run_kernel(case, kernel)
            torch.cuda.synchronize()
            if not (torch.equal(ki, pi) and torch.equal(ks, ps)):
                failed.append(f"{case.name} {kernel}")
            n += kernel == "fold" or kc.fused_plan_of(case) == "fold"
    assert not failed, failed
    assert fused_topk.fold_launches == before + n


def test_small_shard_fold_exact_cases_equal_plain(cuda):
    """The deep fold at the low-rank world's three small coarse shards (B =
    512, rank 128; the deep launch took them before): integer docs whose
    gains tie by the thousand, the k'-th best among them across splits;
    bf16 at k' = 128 and 256, int8 with scales, a -inf tail: the plan takes
    the fold, and its indices and scores equal the plain version's, one
    fold launch a call and no deep launch (twice: the launch leaves its
    rows' shared state as it found it)."""
    failed = []
    before = (fused_topk.fold_launches, fused_topk.deep_launches)
    n = 0
    for case in kc.small_shard_exact_cases(cuda):
        assert kc.fused_plan_of(case) == "fold", case.name
        ps, pi = kc.run_plain(case)
        for _ in range(2):
            ks, ki = kc.run_kernel(case)
            torch.cuda.synchronize()
            if not (torch.equal(ki, pi) and torch.equal(ks, ps)):
                failed.append(case.name)
            n += 1
    assert not failed, failed
    assert (fused_topk.fold_launches, fused_topk.deep_launches) == (
        before[0] + n, before[1])


def test_one_lane_fold_exact_cases_equal_plain(cuda):
    """The deep fold on rows whose candidates all fall to one lane of the
    quad (a -inf bias but at positions 0 and 1 mod 8): a buffer of fewer
    than k' words is packed, never cut, and raises no bound; k' = 128 over
    splits of more than 42 tiles, k' = 256 and 600; indices and scores
    equal the plain version's."""
    failed = []
    for case in kc.one_lane_exact_cases(cuda):
        assert kc.fused_plan_of(case) == "fold", case.name
        ps, pi = kc.run_plain(case)
        ks, ki = kc.run_kernel(case)
        torch.cuda.synchronize()
        if not (torch.equal(ki, pi) and torch.equal(ks, ps)):
            failed.append(case.name)
    assert not failed, failed


@pytest.mark.parametrize("grouped", [False, True])
def test_kernel_int4_matches_plain_within_tolerance(cuda, grouped):
    """Packed nibbles with per-doc and per-group scales: the bf16 dequant
    rounds as the plain version's, so only the summation order differs."""
    case = kc.int4_path_case(cuda, grouped=grouped, bsz=70, n=30_000, d=256,
                             k=32, group_dims=64)
    case.valid_docs = 29_990
    kernel, plain = kc.run_pair(case)
    res = kc.compare_tolerant(kernel, plain)
    assert res["ok"], res
    assert res["recall"] >= 0.999, res


def test_kernel_deep_list_matches_plain_within_tolerance(cuda):
    """k = 128, the low-rank coarse scan's depth."""
    case = kc.path_case(cuda, bsz=40, n=40_000, d=128, k=128, seed=9)
    kernel, plain = kc.run_pair(case)
    res = kc.compare_tolerant(kernel, plain)
    assert res["ok"] and res["recall"] >= 0.999, res


@pytest.mark.parametrize("n,d,k,pad_tail", [(40_960, 128, 128, 104),
                                             (30_208, 768, 32, 0)])
def test_kernel_int8_tier_shapes_match_plain_within_tolerance(cuda, n, d, k,
                                                              pad_tail):
    """The host tiers' launches at a reduced height: the flat coarse scan
    (rank 128, k' = 128, -inf bias on the padding rows) and a stream slab
    (768 dims, k = 32), int8 with per-doc scales; the plain version run 16
    query rows at a time gives the same lists."""
    case = kc.int8_path_case(cuda, n=n, d=d, k=k, bsz=70, pad_tail=pad_tail)
    kernel, plain = kc.run_pair(case, q_chunk=16)
    res = kc.compare_tolerant(kernel, plain)
    assert res["ok"] and res["recall"] >= 0.999, res
    assert int(kernel[1].max()) < n - pad_tail


def test_stream_kernel_equals_plain(cuda):
    """Ties across 32-wide groups, splits and the k boundary, -inf entries
    and rows: positions and gains equal the plain version's; then a random
    matrix wide enough for many splits."""
    failed = []
    for name, gains, k in kc.stream_exact_cases(cuda):
        kg, ki = stream_topk(gains, k)
        pg, pi = stream_topk_reference(gains, k)
        if not (torch.equal(ki, pi) and torch.equal(kg, pg)):
            failed.append(name)
    assert not failed, failed
    gains = kc.stream_path_case(cuda, bsz=9, m=70_001)
    before = stream_topk.launches
    collects = stream_topk.collect_launches
    kg, ki = stream_topk(gains, 32)
    assert stream_topk.launches == before + 1
    assert stream_topk.collect_launches == collects + 1
    pg, pi = stream_topk_reference(gains, 32)
    assert torch.equal(ki, pi) and torch.equal(kg, pg)
    # the collect again: its row counters were left at zero by the first
    # call (rows all -inf and ties across the splits are in the exact cases
    # above)
    for _ in range(2):
        kg, ki = stream_topk(gains, 32)
        assert torch.equal(ki, pi) and torch.equal(kg, pg)
    before = stream_topk.launches
    # past the shallow depth: the deep launch (runs merged), to k = M
    for k in (161, 1100, gains.shape[1]):
        kg, ki = stream_topk(gains, k)
        pg, pi = stream_topk_reference(gains, k)
        assert torch.equal(ki, pi) and torch.equal(kg, pg), k
    assert stream_topk.launches == before + 3
    with pytest.raises(ValueError):
        stream_topk(gains, gains.shape[1] + 1)          # k > M
    assert stream_topk.launches == before + 3


def test_stream_kernel_probed_collect_equals_plain(cuda):
    """The probed collect's rows (sorted runs of 8 with ties within, across
    runs and across k' = 128, a tenth unfilled, -0.0 among them) and random
    rows of the same width: one select launch a call, equal to the plain
    version; both paths of the plan are exercised by the exact cases."""
    from ragroute_tpu_torch.ops import stream_topk as st

    assert st.plan(64, 4096, 128, 132).path == st.SELECT
    for gains in (kc.stream_runs_case(cuda, bsz=64),
                  kc.stream_path_case(cuda, bsz=64, m=4096, pad_share=0.1)):
        before = stream_topk.launches
        kg, ki = stream_topk(gains, 128)
        assert stream_topk.launches == before + 1
        pg, pi = stream_topk_reference(gains, 128)
        assert torch.equal(ki, pi) and torch.equal(kg, pg)
    paths = {st.plan(g.shape[0], g.shape[1], k, 132).path
             for _, g, k in kc.stream_exact_cases(cuda)}
    assert paths == {st.SELECT, st.COLLECT}


def test_grouped_kernel_equals_plain(cuda):
    """Integer data over every slab type, S = 72, with and without the row
    table and the real-block count: equal; then bf16 slabs at a shape with
    ragged column tiles within 1e-3 * max|gain|."""
    failed = []
    for case in kc.grouped_exact_cases(cuda):
        out = kc.run_grouped_kernel(case)
        real = case.real_rows
        if not torch.equal(out[:real],
                           kc.run_grouped_plain(case, real // kc.GROUP_ROWS)):
            failed.append(case.name)
    assert not failed, failed
    case = kc.grouped_path_case(cuda, bsz=33, c=64, d=128, s=200, nprobe=16)
    before = grouped_gains.launches
    out = kc.run_grouped_kernel(case)
    assert grouped_gains.launches == before + 1
    real = case.real_rows
    res = kc.compare_grouped(
        out[:real], kc.run_grouped_plain(case, real // kc.GROUP_ROWS))
    assert res["ok"], res
    with pytest.raises(TypeError):                      # f32 q on bf16 slabs
        grouped_gains(case.q.float(), case.docs, case.bias, None,
                      case.blk_cluster, rows=case.rows)
    with pytest.raises(ValueError):                     # i64 block table
        grouped_gains(case.q, case.docs, case.bias, None,
                      case.blk_cluster.long(), rows=case.rows)
    assert grouped_gains.launches == before + 1


@pytest.mark.parametrize("kernel", [None, "wgmma", "f32", "first"])
def test_grouped_named_kernel_exact_cases_equal_plain(cuda, kernel):
    """Integer data over S = 8 to 328 (one to four column tiles, ragged
    ones, two passes of the wgmma kernel), with and without the row table
    and the real-block count: the plan (the wgmma kernel for bf16, int8 and
    int4 slabs, the f32 kernel for f32 ones) and each kernel by name where
    it takes the slab type, equal to the plain version."""
    failed, launched = [], 0
    for case in kc.grouped_exact_cases(cuda):
        if kernel is not None and not kc.grouped_takes(case, kernel):
            continue
        real = case.real_rows
        before = (grouped_gains.wgmma_launches, grouped_gains.f32_launches)
        out = kc.run_grouped_kernel(case, kernel)
        launched += 1
        if not torch.equal(out[:real],
                           kc.run_grouped_plain(case, real // kc.GROUP_ROWS)):
            failed.append(case.name)
        want = kernel or kc.grouped_plan_of(case)
        after = (grouped_gains.wgmma_launches, grouped_gains.f32_launches)
        assert after[0] - before[0] == (want == "wgmma")
        assert after[1] - before[1] == (want == "f32")
    assert launched and not failed, failed


@pytest.mark.parametrize("slab", ["bf16", "int8", "int4"])
def test_grouped_wgmma_matches_plain_within_tolerance(cuda, slab):
    """Random slabs at a small probed shape (S = 200: four column tiles,
    the last ragged), through the wgmma kernel: within 1e-3 * max|gain|."""
    case = kc.grouped_path_case(cuda, bsz=33, c=64, d=128, s=200, nprobe=16,
                                slab=slab)
    assert kc.grouped_plan_of(case) == "wgmma"
    real = case.real_rows
    res = kc.compare_grouped(kc.run_grouped_kernel(case)[:real],
                             kc.run_grouped_plain(case, real // 64))
    assert res["ok"], res
    with pytest.raises(ValueError, match="f32 kernel does not take"):
        kc.run_grouped_kernel(case, "f32")


@pytest.mark.parametrize("bsz", (200,) + kc.F32_SMALL_BATCHES)
@pytest.mark.parametrize("kernel", [None, "named"])
def test_f32_scan_exact_cases_equal_plain(cuda, kernel, bsz):
    """f32 docs through the f32 scan at B = 200 and the small-batch f32
    scan at B = 1, 8, 32 and 64 (k 1 to 64; the plan takes each there, and
    each is named): a partial query tile, partial doc tiles, chunks past
    d, dot / l2 / cos, a -inf tail, valid_docs < N, per-doc scales, splits
    of several tiles; indices and scores equal the plain version."""
    route = "f32" if bsz > kc.F32_SMALL_BATCHES[-1] else "f32_small"
    counter = f"{route}_launches"
    failed = []
    for case in kc.f32_exact_cases(cuda, bsz=bsz):
        assert kc.fused_plan_of(case) == route
        before = getattr(fused_topk, counter)
        got = kc.run_kernel(case, kernel and route)
        assert getattr(fused_topk, counter) == before + 1
        want = kc.run_plain(case)
        if not (torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])):
            failed.append(case.name)
    assert not failed, failed


@pytest.mark.parametrize("bsz,n,k,route", [
    (300, 60_000, 32, "f32"), (8, 100_003, 64, "f32"), (512, 20_000, 10, "f32"),
    (1, 100_003, 32, "f32_small"), (8, 100_003, 64, "f32_small"),
    (32, 60_000, 32, "f32_small"), (64, 250_001, 10, "f32_small")])
def test_f32_scan_matches_plain_within_tolerance(cuda, bsz, n, k, route):
    """Random f32 rows, different summation order: scores within 1e-5 x
    max|score|, only near-ties swapped at the k boundary; the f32 scan and
    the small-batch scan, each by name."""
    case = kc.path_case(cuda, bsz=bsz, n=n, d=768, k=k, seed=bsz + k,
                        dtype=torch.float32)
    kernel = kc.run_kernel(case, route)
    res = kc.compare_tolerant(kernel, kc.run_plain(case), rel=1e-5)
    assert res["ok"], res
    assert res["recall"] >= 0.999, res
    with pytest.raises(ValueError, match="f32 scan does not take"):
        case.k = 65
        kc.run_kernel(case, route)


@pytest.mark.parametrize("impl,dtype,build", [
    ("ivf", torch.bfloat16, {"ivf_clusters": 64}),
    ("ivf", "int4", {"ivf_clusters": 64}),
    ("lowrank", torch.bfloat16, {"lowrank": -1}),
    ("lowrank", "int4", {"lowrank": -1}),
])
def test_approximate_engine_on_the_card_matches_the_cpu_engine(cuda, impl,
                                                               dtype, build):
    """The approximate modes on the card (kernels) against the same engine
    on the CPU (plain versions) over one layout carried across: same
    masks, scores within 1e-3 * max|score|, winners equal up to near-ties."""
    from ragroute_tpu_torch.engine import FederatedSearchEngine
    from ragroute_tpu_torch.index import ShardSet, make_synthetic_world
    from ragroute_tpu_torch.router import CorpusRouter, RouterBank

    syn = make_synthetic_world("medrag", docs_per_source=6000,
                               num_queries=48, seed=3, with_payloads=False,
                               subclusters=16)
    host = ShardSet.build(syn.world, syn.embeddings, dtype=dtype, **build)

    def engine(dev):
        return FederatedSearchEngine(
            _on(host, dev), CorpusRouter.from_seed(
                syn.world.router_input_dim, 0, dev),
            RouterBank.create(syn.world, syn.centroids, device=dev),
            impl=impl)

    embs = dict(syn.query_embs)
    gpu = engine(cuda).search(embs, strategy="all", fetch_candidates=False)
    cpu = engine("cpu").search(embs, strategy="all", fetch_candidates=False)
    _close_engines(gpu, cpu, 48)


def _on(ss, dev):
    """The same shard set and layouts on another device."""
    import dataclasses

    moved = [dataclasses.replace(
        s, docs=s.docs.to(dev), bias=s.bias.to(dev),
        scale=None if s.scale is None else s.scale.to(dev),
        center=None if s.center is None else s.center.to(dev),
        ivf=None if s.ivf is None else s.ivf.to(dev),
        lr=None if s.lr is None else s.lr.to(dev)) for s in ss.shards]
    return dataclasses.replace(ss, shards=moved)


def _close_engines(gpu, cpu, n_queries):
    """Same valid counts, scores within 1e-3 * max|score|, 99% of the
    winners shared (bf16 near-ties may swap)."""
    import numpy as np

    np.testing.assert_array_equal(gpu.merged_valid, cpu.merged_valid)
    valid = cpu.merged_shard >= 0
    tol = 1e-3 * float(np.abs(cpu.merged_score[valid]).max())
    np.testing.assert_allclose(gpu.merged_score[valid],
                               cpu.merged_score[valid], rtol=0, atol=tol)
    hits = sum(len(set(zip(gpu.merged_shard[r], gpu.merged_local[r]))
                   & set(zip(cpu.merged_shard[r], cpu.merged_local[r])))
               for r in range(n_queries))
    assert hits >= 0.99 * valid.sum()


def test_engine_on_the_card_matches_the_cpu_engine(cuda):
    """The whole engine step on the card (kernel on every shard above 4096
    docs, skip and compaction, one coalesced copy, submit/wait) against
    the same engine on the CPU (plain paths): same masks, and merged
    winners that differ only by bf16 near-ties."""
    import numpy as np

    from ragroute_tpu_torch.engine import FederatedSearchEngine
    from ragroute_tpu_torch.index import ShardSet, make_synthetic_world
    from ragroute_tpu_torch.router import CorpusRouter, RouterBank

    syn = make_synthetic_world("medrag", docs_per_source=5000,
                               num_queries=64, seed=2, with_payloads=False)

    def engine(dev):
        return FederatedSearchEngine(
            ShardSet.build(syn.world, syn.embeddings, device=dev),
            CorpusRouter.from_seed(syn.world.router_input_dim, 0, dev),
            RouterBank.create(syn.world, syn.centroids, device=dev))

    embs = dict(syn.query_embs)
    before = fused_topk.launches
    gpu = engine(cuda).search_submit(embs, fetch_candidates=False).wait()
    assert fused_topk.launches > before
    cpu = engine("cpu").search(embs, fetch_candidates=False)
    np.testing.assert_array_equal(gpu.mask, cpu.mask)
    np.testing.assert_array_equal(gpu.merged_valid, cpu.merged_valid)
    valid = cpu.merged_shard >= 0
    tol = 1e-3 * float(np.abs(cpu.merged_score[valid]).max())
    np.testing.assert_allclose(gpu.merged_score[valid],
                               cpu.merged_score[valid], rtol=0, atol=tol)
    hits = sum(len(set(zip(gpu.merged_shard[r], gpu.merged_local[r]))
                   & set(zip(cpu.merged_shard[r], cpu.merged_local[r])))
               for r in range(64) if valid[r].any())
    assert hits >= 0.99 * valid.sum()


def test_pair_topk_exact_cases_equal_plain(cuda):
    """Integer data: the grouped pair top-k kernel's gains equal the plain
    version's, and its slots where the gain is finite (one tile and
    several, an empty cluster, padding rows, ties across a tile boundary,
    ranks 1 to 64, the row table and the real-block count)."""
    from ragroute_tpu_torch.ops.grouped_topk import grouped_pair_topk

    failed = []
    before = grouped_pair_topk.launches
    n = 0
    for case in kc.pair_exact_cases(cuda):
        out = kc.run_pair_kernel(case)
        real = case.real_rows
        plain = kc.run_pair_plain(case, real // kc.PAIR_ROWS)
        torch.cuda.synchronize()
        res = kc.compare_pair((out[0][:real], out[1][:real]), plain)
        if not res["ok"] or res["max_abs_err"] != 0.0:
            failed.append((case.name, res))
        n += 1
    assert not failed, failed
    assert grouped_pair_topk.launches == before + n


@pytest.mark.parametrize("kernel", ["wgmma", "shallow"])
def test_pair_topk_named_launch_exact_cases_equal_plain(cuda, kernel):
    """The exact cases through the wgmma kernel and through the first
    design, each where it takes the shape (the wgmma kernel: ranks 1 to 8,
    S 72 to 2,056, one tile and three, the row table and the real-block
    count): gains equal, slots equal where finite."""
    failed, n = [], 0
    for case in kc.pair_exact_cases(cuda):
        if not kc.pair_takes(case, kernel):
            continue
        out = kc.run_pair_kernel(case, kernel)
        real = case.real_rows
        plain = kc.run_pair_plain(case, real // kc.PAIR_ROWS)
        torch.cuda.synchronize()
        res = kc.compare_pair((out[0][:real], out[1][:real]), plain)
        if not res["ok"] or res["max_abs_err"] != 0.0:
            failed.append((case.name, res))
        n += 1
    assert not failed, failed
    assert n >= 27


def test_pair_topk_matches_plain_within_tolerance_and_raises(cuda):
    """Random int8 slabs at rank 128 through the search's own dispatch:
    gains within 1e-4 relative, every slot that differs from the plain
    version's carries the gain written for it; what the kernel does not
    take raises."""
    from ragroute_tpu_torch.ops.grouped_topk import grouped_pair_topk

    case = kc.pair_path_case(cuda, bsz=64, c=64, s=1096, nprobe=16, seed=7)
    out = kc.run_pair_kernel(case)
    real = case.real_rows
    plain = kc.run_pair_plain(case, real // kc.PAIR_ROWS)
    torch.cuda.synchronize()
    res = kc.compare_pair((out[0][:real], out[1][:real]), plain, rel=1e-4,
                          case=case)
    assert res["ok"], res
    with pytest.raises(TypeError):                       # f32 rows
        grouped_pair_topk(case.q.float(), case.cc, case.blk_cluster, 8,
                          rows=case.rows)
    # ranks 200 a tile (past the shallow 160): the deep launch
    case.kappa = 400
    deep = grouped_pair_topk.deep_launches
    out = kc.run_pair_kernel(case)
    assert grouped_pair_topk.deep_launches == deep + 1
    res = kc.compare_pair((out[0][:real], out[1][:real]),
                          kc.run_pair_plain(case, real // kc.PAIR_ROWS),
                          rel=1e-4, case=case)
    assert res["ok"], res
    with pytest.raises(ValueError):                      # int64 row table
        grouped_pair_topk(case.q, case.cc, case.blk_cluster, 8,
                          rows=case.rows.long())


def test_pair_topk_deep_ranks_match_plain_at_the_reduced_world(cuda):
    """256 ranks a tile: the probed scan under an open cap (kappa = k' =
    256) over the reduced world's 64 clusters of 568 slots, every query
    probing every cluster; gains within 1e-4 relative, every slot that
    differs from the plain version's carries the gain written for it."""
    from ragroute_tpu_torch.ops.grouped_topk import grouped_pair_topk

    case = kc.pair_path_case(cuda, bsz=64, c=64, s=568, nprobe=64,
                             kappa=256, seed=6)
    assert kc.tiling(568, 256)[2] == 256
    deep = grouped_pair_topk.deep_launches
    out = kc.run_pair_kernel(case)
    assert grouped_pair_topk.deep_launches == deep + 1
    real = case.real_rows
    res = kc.compare_pair((out[0][:real], out[1][:real]),
                          kc.run_pair_plain(case, real // kc.PAIR_ROWS),
                          rel=1e-4, case=case)
    assert res["ok"], res


def test_lowrank_refine_mult_8_on_the_card_matches_the_cpu_engine(cuda):
    """``--impl lowrank --refine-mult 8`` (k' = 256 at medrag's k = 32) on
    a reduced world: the engine on the card, whose coarse scans take the
    fused kernel's deep fold (at every shard size; the deep launch took
    these small ones before), against the same engine on the CPU (plain
    versions) over one layout carried across: same masks, scores within
    1e-3 * max|score|, winners equal up to near-ties."""
    from ragroute_tpu_torch.engine import FederatedSearchEngine
    from ragroute_tpu_torch.index import ShardSet, make_synthetic_world
    from ragroute_tpu_torch.main import parse_args
    from ragroute_tpu_torch.router import CorpusRouter, RouterBank
    from ragroute_tpu_torch.system import ServingSystem

    k_refine = ServingSystem(parse_args([
        "--dataset", "medrag", "--routing", "ragroute", "--disable-llm",
        "--impl", "lowrank", "--refine-mult", "8"])).k_refine
    assert k_refine == 256
    syn = make_synthetic_world("medrag", docs_per_source=6000,
                               num_queries=48, seed=4, with_payloads=False)
    host = ShardSet.build(syn.world, syn.embeddings, dtype=torch.bfloat16,
                          lowrank=-1)
    embs = dict(syn.query_embs)
    outs = []
    deep, fold = fused_topk.deep_launches, fused_topk.fold_launches
    for dev in (cuda, "cpu"):
        eng = FederatedSearchEngine(
            _on(host, dev), CorpusRouter.from_seed(
                syn.world.router_input_dim, 0, dev),
            RouterBank.create(syn.world, syn.centroids, device=dev),
            impl="lowrank", k_refine=k_refine)
        outs.append(eng.search(embs, strategy="all", fetch_candidates=False))
    assert fused_topk.fold_launches >= fold + 4     # one a source
    assert fused_topk.deep_launches == deep
    _close_engines(*outs, 48)


@pytest.mark.parametrize("tier,kw", [
    ("stream", {"slab_bytes": 5120 * 776}), ("hostrefine", {}),
    ("hostrefine", {"cluster_coarse": True})])
def test_streamed_engine_on_the_card_agrees_with_the_cpu_engine(cuda, tier,
                                                                kw):
    """Both tiers on the card (the fused kernel over page-locked slabs
    copied on the side stream; the coarse scans) against the same engine
    on the CPU. The card rounds the queries to bf16 for the int8 scans and
    the CPU path does not, so the winner sets are held to a recall of 0.97
    and the shared winners' scores to 1e-2 relative."""
    from ragroute_tpu_torch.engine.streamed import StreamedSearchEngine
    from ragroute_tpu_torch.index import make_synthetic_world
    from ragroute_tpu_torch.index.streamed import StreamedShardSet
    from ragroute_tpu_torch.ops.grouped_topk import grouped_pair_topk
    from ragroute_tpu_torch.router import CorpusRouter, RouterBank

    syn = make_synthetic_world("medrag", docs_per_source=12_000,
                               num_queries=32, seed=5, with_payloads=False,
                               subclusters=16)
    embs = dict(syn.query_embs)
    outs, cpu_set = [], None
    for dev in ("cpu", cuda):
        router = CorpusRouter.from_seed(syn.world.router_input_dim, 0, dev)
        bank = RouterBank.create(syn.world, syn.centroids, device=dev)
        sset = StreamedShardSet.build(
            syn.world, syn.embeddings, dtype=torch.int8, tier=tier,
            hbm_budget_bytes=4 * 5120 * 776, device=dev, **kw)
        if cpu_set is None:
            cpu_set = sset
        elif kw.get("cluster_coarse"):
            # one layout for both devices: k-means is not bit-equal
            for s, c in zip(sset.sources, cpu_set.sources):
                s.coarse_cl = c.coarse_cl.to(dev)
        before = (fused_topk.launches, grouped_pair_topk.launches)
        outs.append(StreamedSearchEngine(sset, router, bank).search(
            embs, strategy="all", fetch_candidates=False))
    # (the clustered world keeps no exact rows on the card)
    assert (fused_topk.launches > before[0]) != bool(kw.get("cluster_coarse"))
    assert (grouped_pair_topk.launches > before[1]) == bool(
        kw.get("cluster_coarse"))
    cpu, card = outs
    assert (card.merged_valid == syn.world.k).all()
    hits = 0
    for q in range(cpu.merged_shard.shape[0]):
        a = {(int(s), int(l)): float(v) for s, l, v in zip(
            cpu.merged_shard[q], cpu.merged_local[q], cpu.merged_score[q])}
        b = {(int(s), int(l)): float(v) for s, l, v in zip(
            card.merged_shard[q], card.merged_local[q], card.merged_score[q])}
        for key in a.keys() & b.keys():
            hits += 1
            assert abs(a[key] - b[key]) <= 1e-2 * (1.0 + abs(a[key]))
    assert hits >= 0.97 * cpu.merged_shard.size


# ---- the decoder's kernels: K5 (int4 matmul) and K6 (decode attention) -----

def test_int4_matmul_exact_cases_equal_plain(cuda):
    """Small integer activations, random nibbles and power-of-two scales:
    every product and sum is exact, so the kernel equals the plain version
    (bf16 and f32 activations; OUT off the 16-byte grid; groups of 6, 12,
    24; one and several M tiles; a split contraction)."""
    from ragroute_tpu_torch.ops import decoder_checks as dc

    failed = []
    for case in dc.int4_exact_cases(cuda):
        got, want = dc.run_int4(case), dc.run_int4_plain(case)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            failed.append(case.name)
    assert not failed, failed


@pytest.mark.parametrize("m,in_dim,out,group", [(16, 4096, 1024, 128),
                                                (300, 1024, 2048, 128),
                                                (3, 256, 260, 64)])
def test_int4_matmul_matches_plain_within_tolerance(cuda, m, in_dim, out,
                                                    group):
    from ragroute_tpu_torch.ops import decoder_checks as dc
    from ragroute_tpu_torch.ops.int4_matmul import int4_matmul

    gen = torch.Generator(device=cuda).manual_seed(m)
    case = dc._rand_case("t", cuda, m, in_dim, out, group, torch.bfloat16,
                         gen, exact=False)
    before = int4_matmul.launches
    res = dc.matmul_close(dc.run_int4(case), dc.run_int4_plain(case))
    assert int4_matmul.launches == before + 1
    assert res["ok"], res
    with pytest.raises(TypeError):
        int4_matmul(case.x.to(torch.float16), case.w, case.scale,
                    group=group)


def test_int4_prefill_kernel_exact_cases_equal_plain(cuda):
    """The prefill (wgmma) kernel's exact cases: M at the switch and past it
    (a ragged last token block), OUT off the 128-column block, groups of
    one, two and four 64-row stages; each a launch of that kernel."""
    from ragroute_tpu_torch.ops import decoder_checks as dc
    from ragroute_tpu_torch.ops.int4_matmul import M_SWITCH, int4_matmul

    failed = []
    for case in dc.int4_prefill_exact_cases(cuda):
        assert case.x.shape[0] >= M_SWITCH
        before = int4_matmul.launches
        got = dc.run_int4(case, "wgmma")
        assert int4_matmul.launches == before + 1
        if not torch.equal(got, dc.run_int4_plain(case)):
            failed.append(case.name)
    assert not failed, failed


def test_int4_decode_kernel_exact_cases_equal_plain(cuda):
    """The decode kernel's exact cases: M = 1, 16, 40 and 63 (token tiles
    of 8, 16, 32 and 64), a contraction in 16 splits summed in the launch,
    OUT off the 128-column block, groups of one and two 64-row stages; each
    one launch of the kernel the plan names (decode below ``M_SWITCH``, the
    prefill kernel at it), held beside the first kernel on the same case."""
    from ragroute_tpu_torch.ops import decoder_checks as dc
    from ragroute_tpu_torch.ops.int4_matmul import M_SWITCH, _plan, int4_matmul

    failed = []
    for case in dc.int4_decode_exact_cases(cuda):
        m, in_dim = case.x.shape
        plan = _plan(m, in_dim // 2, case.w.shape[1], case.group, True, True,
                     132)
        assert plan.kernel == ("decode" if m < M_SWITCH else "wgmma")
        want = dc.run_int4_plain(case)
        for kernel in (plan.kernel, "mma"):
            before = int4_matmul.launches
            got = dc.run_int4(case, kernel)
            assert int4_matmul.launches == before + 1
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                failed.append(f"{case.name} {kernel}")
    assert not failed, failed


@pytest.mark.parametrize("m,in_dim,out", [(1000, 1024, 2048),
                                          (4096, 4096, 1024)])
def test_int4_prefill_kernel_matches_plain_within_tolerance(cuda, m, in_dim,
                                                            out):
    from ragroute_tpu_torch.ops import decoder_checks as dc

    gen = torch.Generator(device=cuda).manual_seed(m)
    case = dc._rand_case("t", cuda, m, in_dim, out, 128, torch.bfloat16,
                         gen, exact=False)
    res = dc.matmul_close(dc.run_int4(case, "wgmma"),
                          dc.run_int4_plain(case))
    assert res["ok"], res


def test_decode_attention_matches_plain_and_attend(cuda):
    from ragroute_tpu_torch.ops import decoder_checks as dc
    from ragroute_tpu_torch.ops.decode_attention import decode_attention

    before = decode_attention.launches
    n = 0
    for case in dc.attn_small_cases(cuda):
        got = dc.run_attn(case)
        for want in (dc.run_attn_plain(case), dc.run_attend(case)):
            res = dc.attn_close(got, want)
            assert res["ok"], (case.name, res)
        n += 1
    assert decode_attention.launches == before + n


def test_decode_attention_takes_its_mask_as_bool_or_bytes(cuda):
    """The mask as bool, uint8 or float gives the same output; one launch a
    call, and the output does not alias the inputs."""
    from ragroute_tpu_torch.ops import decoder_checks as dc
    from ragroute_tpu_torch.ops.decode_attention import decode_attention

    case = next(c for c in dc.attn_small_cases(cuda)
                if c.name == "int8-S77-G8-dh256")
    k, v = case.planes()
    outs = []
    for ok in (case.ok, case.ok.to(torch.uint8), case.ok.float()):
        before = decode_attention.launches
        outs.append(decode_attention(case.q, k, v, ok, li=case.li,
                                     num_kv_heads=case.hkv, head_dim=case.dh,
                                     k_scale=case.ks, v_scale=case.vs))
        assert decode_attention.launches == before + 1
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    res = dc.attn_close(outs[0], dc.run_attn_plain(case))
    assert res["ok"], res


def test_int4_decoder_on_the_card_matches_the_cpu_decoder(cuda):
    """The demo decoder's int4 weights: greedy tokens through K5 on the
    card equal the plain version's on the CPU (f32 activations)."""
    from ragroute_tpu_torch.llm import model as tm
    from ragroute_tpu_torch.llm.service import DEMO_CFG
    from ragroute_tpu_torch.ops.int4_matmul import int4_matmul

    params = tm.quantize_decoder_params(tm.init_decoder_params(0, DEMO_CFG),
                                        DEMO_CFG, bits=4)
    gen = torch.Generator().manual_seed(1)
    ids = torch.randint(0, 256, (4, 24), generator=gen, dtype=torch.int32)
    mask = torch.ones_like(ids)
    mask[1, :10] = 0
    outs = []
    before = int4_matmul.launches
    for dev in ("cpu", cuda):
        with torch.no_grad():
            toks, _ = tm.generate(params.to(dev), DEMO_CFG, ids.to(dev),
                                  mask.to(dev), 8, eos_id=-1)
        outs.append(toks.cpu())
    assert int4_matmul.launches > before
    assert torch.equal(outs[0], outs[1])


def test_router_trainer_on_the_card_equals_the_cpu_trainer(cuda):
    """Twenty clip + Adam steps of the router trainer, dropout off, from the
    same seeded parameters on the same batches: the card's parameters
    within atol 1e-4 of the CPU's (TF32 off: ``resolve_device``)."""
    from ragroute_tpu_torch.router import CorpusRouter
    from ragroute_tpu_torch.train import train_router as T

    gen = torch.Generator().manual_seed(2)
    batches = [(torch.randn(256, 1540, generator=gen),
                (torch.rand(256, generator=gen) < 0.4).float())
               for _ in range(20)]
    states = []
    for dev in ("cpu", cuda):
        model = CorpusRouter.from_seed(1540, 0, dev)
        opt, sched = T.make_optimizer(model, 95)
        for x, y in batches:
            T.train_step(model, opt, sched, x.to(dev), y.to(dev))
        assert {p.device.type for p in model.parameters()} == {
            torch.device(dev).type}
        states.append({k: v.cpu() for k, v in model.state_dict().items()})
    for key, want in states[0].items():
        torch.testing.assert_close(states[1][key], want, rtol=0, atol=1e-4,
                                   msg=key)


def test_tp_decoder_on_the_card_gives_the_single_cards_tokens(cuda):
    """The tensor-parallel decoder over a 2x4 mesh of the card (its slices
    views of the card's weights): the single card's greedy tokens with an
    f32 and an int8 cache, qk-norm, a left-padded row and an uneven batch
    (3 rows over dp=2)."""
    from ragroute_tpu_torch.llm import model as tm
    from ragroute_tpu_torch.llm.sharding import shard_decoder_params
    from ragroute_tpu_torch.parallel.mesh import make_mesh

    cfg = tm.DecoderConfig(vocab_size=512, hidden_size=256, num_layers=4,
                           num_heads=8, num_kv_heads=4, head_dim=32,
                           intermediate_size=512, qk_norm=True)
    params = tm.init_decoder_params(0, cfg, device=cuda)
    tp = shard_decoder_params(params, cfg, make_mesh(2, 4,
                                                     devices=[cuda] * 8))
    gen = torch.Generator(device=cuda).manual_seed(1)
    for bsz in (6, 3):
        ids = torch.randint(1, cfg.vocab_size, (bsz, 16), generator=gen,
                            device=cuda, dtype=torch.int32)
        mask = torch.ones_like(ids)
        mask[1, :5] = 0
        for cache_dtype in (torch.float32, "int8"):
            with torch.no_grad():
                want, _ = tm.generate(params, cfg, ids, mask, 12, eos_id=-1,
                                      cache_dtype=cache_dtype)
                got, _ = tm.generate(tp, cfg, ids, mask, 12, eos_id=-1,
                                     cache_dtype=cache_dtype)
            assert torch.equal(got, want), (bsz, cache_dtype)
