"""Card-only tests: the hand-written kernels (csrc/fused_topk.cu,
csrc/stream_topk.cu, csrc/grouped_gains.cu) against their plain PyTorch
versions, at test size.

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
        fused_topk(q, docs, 161)                        # k > 160
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
    fused_topk(q, docs, 160)                            # the deepest list
    assert fused_topk.launches == before + 3


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
    kg, ki = stream_topk(gains, 32)
    assert stream_topk.launches == before + 1
    pg, pi = stream_topk_reference(gains, 32)
    assert torch.equal(ki, pi) and torch.equal(kg, pg)
    with pytest.raises(ValueError):
        stream_topk(gains, 161)
    assert stream_topk.launches == before + 1


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
    import numpy as np

    from ragroute_tpu_torch.engine import FederatedSearchEngine
    from ragroute_tpu_torch.index import ShardSet, make_synthetic_world
    from ragroute_tpu_torch.router import CorpusRouter, RouterBank

    syn = make_synthetic_world("medrag", docs_per_source=6000,
                               num_queries=48, seed=3, with_payloads=False,
                               subclusters=16)
    host = ShardSet.build(syn.world, syn.embeddings, dtype=dtype, **build)

    def to(ss, dev):        # the same layouts on another device
        import dataclasses

        moved = [dataclasses.replace(
            s, docs=s.docs.to(dev), bias=s.bias.to(dev),
            scale=None if s.scale is None else s.scale.to(dev),
            center=None if s.center is None else s.center.to(dev),
            ivf=None if s.ivf is None else s.ivf.to(dev),
            lr=None if s.lr is None else s.lr.to(dev)) for s in ss.shards]
        return dataclasses.replace(ss, shards=moved)

    def engine(dev):
        return FederatedSearchEngine(
            to(host, dev), CorpusRouter.from_seed(
                syn.world.router_input_dim, 0, dev),
            RouterBank.create(syn.world, syn.centroids, device=dev),
            impl=impl)

    embs = dict(syn.query_embs)
    gpu = engine(cuda).search(embs, strategy="all", fetch_candidates=False)
    cpu = engine("cpu").search(embs, strategy="all", fetch_candidates=False)
    np.testing.assert_array_equal(gpu.merged_valid, cpu.merged_valid)
    valid = cpu.merged_shard >= 0
    tol = 1e-3 * float(np.abs(cpu.merged_score[valid]).max())
    np.testing.assert_allclose(gpu.merged_score[valid],
                               cpu.merged_score[valid], rtol=0, atol=tol)
    hits = sum(len(set(zip(gpu.merged_shard[r], gpu.merged_local[r]))
                   & set(zip(cpu.merged_shard[r], cpu.merged_local[r])))
               for r in range(48))
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
