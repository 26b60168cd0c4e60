"""The port's decode attention (K6) against the JAX package's, on the CPU.

The CUDA kernel runs only on a card (``tests/test_torch_kernel.py`` holds it
against the plain version there); here the wrapper takes its plain version,
which must agree at f32 within 1e-5 with the JAX package's Pallas kernel (in
interpret mode off the TPU) and with its ``_attend``, the engines' einsum
path the kernel is held to: f32 and int8 caches, MHA and GQA, a row with a
single valid key, a row with none, and the layer chosen from the folded
planes. Inputs are made with numpy from a seed and handed to both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from ragroute_tpu.llm import model as jm
from ragroute_tpu.ops import decode_attention as jx
from ragroute_tpu_torch.llm import model as tm
from ragroute_tpu_torch.ops import decode_attention as tx


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield


def _inputs(seed, *, b=3, s=96, h=4, hkv=2, dh=32, layers=3, single=None,
            empty=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, dh)).astype(np.float32)
    k = rng.normal(size=(layers, b, s, hkv, dh)).astype(np.float32)
    v = rng.normal(size=(layers, b, s, hkv, dh)).astype(np.float32)
    start = rng.integers(0, s // 2, b)
    end = start + rng.integers(1, s // 2, b)
    iota = np.arange(s)
    ok = (iota[None] >= start[:, None]) & (iota[None] <= end[:, None])
    if single is not None:
        ok[single] = iota == s // 3
    if empty is not None:
        ok[empty] = False
    return q, k, v, ok


def _fold(x):
    return x.reshape(*x.shape[:-2], -1)


CASES = [  # (name, h, hkv, int8 cache, layer)
    ("gqa-f32", 4, 2, False, 0), ("gqa-f32-last-layer", 4, 2, False, 2),
    ("mha-f32", 2, 2, False, 1), ("gqa4-int8", 8, 2, True, 1),
    ("mha-int8", 4, 4, True, 2),
]


@pytest.mark.parametrize("name,h,hkv,int8,li", CASES)
def test_plain_version_matches_jax_kernel_and_attend(name, h, hkv, int8, li):
    q, k, v, ok = _inputs(len(name), h=h, hkv=hkv, single=1, empty=2)
    dh = q.shape[-1]
    jk, jv, jks, jvs = jnp.asarray(k), jnp.asarray(v), None, None
    if int8:
        (jk, jks), (jv, jvs) = jm.quant_kv(jk), jm.quant_kv(jv)
    want = np.asarray(jx.decode_attention(
        jnp.asarray(q), _fold(jk), _fold(jv), jnp.asarray(ok), li=li,
        num_kv_heads=hkv, head_dim=dh, k_scale=jks, v_scale=jvs))
    cfg = jm.DecoderConfig(vocab_size=8, hidden_size=h * dh, num_layers=3,
                           num_heads=h, num_kv_heads=hkv, head_dim=dh,
                           intermediate_size=8)
    attend = np.asarray(jm._attend(
        jnp.asarray(q)[:, None], jk[li], jv[li], jnp.asarray(ok)[:, None],
        cfg, k_scale=None if jks is None else jks[li],
        v_scale=None if jvs is None else jvs[li])).reshape(want.shape)

    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    tks = tvs = None
    if int8:
        (tk, tks), (tv, tvs) = tm.quant_kv(tk), tm.quant_kv(tv)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tks.numpy(), np.asarray(jks))
    before = tx.decode_attention.launches
    got = tx.decode_attention(torch.from_numpy(q), _fold(tk), _fold(tv),
                              torch.from_numpy(ok), li=li, num_kv_heads=hkv,
                              head_dim=dh, k_scale=tks, v_scale=tvs)
    assert tx.decode_attention.launches == before     # CPU: no kernel
    assert got.dtype == torch.float32 and got.shape == q.shape
    for ref in (want, attend):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    # the port's own _attend, as the engines call it
    tcfg = tm.DecoderConfig(**{f: getattr(cfg, f) for f in (
        "vocab_size", "hidden_size", "num_layers", "num_heads",
        "num_kv_heads", "head_dim", "intermediate_size")})
    mine = tm._attend(torch.from_numpy(q)[:, None], tk[li], tv[li],
                      torch.from_numpy(ok)[:, None], tcfg,
                      k_scale=None if tks is None else tks[li],
                      v_scale=None if tvs is None else tvs[li])
    np.testing.assert_allclose(mine.reshape(got.shape).numpy(), attend,
                               rtol=1e-5, atol=1e-5)


def test_single_valid_key_returns_that_value_row():
    q, k, v, _ = _inputs(9, b=2, s=64, h=4, hkv=2, dh=16, layers=1)
    ok = np.broadcast_to(np.arange(64)[None] == 7, (2, 64))
    got = tx.decode_attention(torch.from_numpy(q),
                              _fold(torch.from_numpy(k)),
                              _fold(torch.from_numpy(v)),
                              torch.from_numpy(ok.copy()), li=0,
                              num_kv_heads=2, head_dim=16)
    want = np.repeat(v[0, :, 7], 2, axis=-2).reshape(2, 4, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_fused_ok_gates_and_bad_arguments():
    k8 = torch.zeros((2, 2, 64, 2 * 128), dtype=torch.int8)
    assert not tx.fused_ok(4, 2, 128, k8)            # a CPU plane
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAGROUTE_DECODE_ATTN", "fused")
        assert tx.fused_ok(4, 2, 128, k8)
        assert not tx.fused_ok(36, 4, 128, k8)        # 9 query heads a kv head
        assert not tx.fused_ok(4, 2, 512, k8)         # Dh above 256
        big = torch.zeros((1, 1, 65_536, 8 * 128), dtype=torch.int8)
        assert tx.fused_ok(64, 8, 128, big)           # split until it fits
        assert not tx.fused_ok(4, 2, 128, k8.to(torch.float16))
        mp.setenv("RAGROUTE_DECODE_ATTN", "xla")
        assert not tx.fused_ok(4, 2, 128, k8)
    q = torch.zeros((2, 4, 128))
    with pytest.raises(ValueError, match="li"):
        tx.decode_attention(q, k8, k8, torch.ones((2, 64)), li=2,
                            num_kv_heads=2, head_dim=128)


@pytest.mark.parametrize("b,h,hkv,dh,s,item", [
    (16, 32, 8, 128, 2080, 2), (16, 32, 8, 128, 2080, 1),
    (32, 16, 8, 128, 640, 1), (1, 64, 8, 128, 65_536, 2),
    (3, 4, 2, 16, 5, 4), (2, 8, 1, 256, 97, 4)])
def test_split_plan_covers_every_position_and_fits(b, h, hkv, dh, s, item):
    splits, chunk = tx.split_plan(b, h, hkv, dh, s, 132, item)
    assert (splits - 1) * chunk < s <= splits * chunk      # none empty
    assert chunk % tx.TILE == 0
    assert tx.smem_bytes(h, hkv, dh, item) <= tx.SMEM_LIMIT
    assert splits == 1 or chunk >= tx.MIN_CHUNK // 2
    if b * hkv < 132 and s >= 4 * tx.MIN_CHUNK:
        assert splits > 1                   # more blocks than (row, head)s


@pytest.mark.parametrize("dh", [64, 128, 256])
def test_split_plan_over_lengths_groups_and_dtypes(dh):
    """Every S from 1 to 40,960 on a coarse grid and around the tile and
    split edges, G from 1 to 8, f32 / bf16 / int8: the runs cover S, none
    is empty, each is whole tiles, the blocks fill at most one wave, and a
    block's shared memory stays within the card's limit."""
    lengths = sorted(set(range(1, 200)) | set(range(200, 40_961, 97))
                     | {40_960, 4095, 4096, 4097, 2080, 640})
    for item in (4, 2, 1):
        for g in range(1, tx.GMAX + 1):
            smem = tx.smem_bytes(8 * g, 8, dh, item)
            assert smem <= tx.SMEM_LIMIT, (item, g, smem)
            per_sm = tx.SM_SMEM // (smem + tx.BLOCK_SMEM_RESERVED)
            assert per_sm >= 1
            for b in (1, 16):
                for s in lengths:
                    splits, chunk = tx.split_plan(b, 8 * g, 8, dh, s, 132,
                                                  item)
                    assert chunk % tx.TILE == 0 and splits >= 1
                    assert (splits - 1) * chunk < s <= splits * chunk
                    blocks = b * 8 * splits
                    assert splits == 1 or blocks <= min(
                        per_sm, tx.BLOCKS_PER_SM) * 132


def test_split_softmax_merge_equals_one_softmax():
    """The kernel's algebra on the CPU: per split the max m, the sum l of
    exp(score - m) and the context of the unnormalised weights (times
    v_scale), merged as sum e^(m_j - M) o_j / sum e^(m_j - M) l_j, equals
    ``_attend``'s one softmax, also for a row with a single valid key (the
    other splits wholly masked) and a row with none."""
    q, k, v, ok = _inputs(11, b=3, s=200, h=4, hkv=2, dh=16, layers=1,
                          single=1, empty=2)
    tk, tks = tm.quant_kv(torch.from_numpy(k))
    tv, tvs = tm.quant_kv(torch.from_numpy(v))
    want = tx.decode_attention_reference(
        torch.from_numpy(q), _fold(tk), _fold(tv), torch.from_numpy(ok),
        li=0, num_kv_heads=2, head_dim=16, k_scale=tks, v_scale=tvs)
    splits, chunk = tx.split_plan(3, 4, 2, 16, 200, 4, 1)
    assert splits > 1
    neg = torch.finfo(torch.float32).min
    qg = torch.from_numpy(q).reshape(3, 2, 2, 16)
    kk, vv = tk[0].float(), tv[0].float()              # [B, S, Hkv, Dh]
    att = torch.einsum("bhgd,bshd->bhgs", qg, kk)
    att = att * tks[0].transpose(1, 2)[:, :, None] * (1.0 / 4.0)
    att = torch.where(torch.from_numpy(ok)[:, None, None], att, neg)
    ms, ls, os_ = [], [], []
    for j in range(splits):
        a = att[..., j * chunk:(j + 1) * chunk]
        m = a.amax(-1, keepdim=True)
        e = torch.exp(a - m)
        ls.append(e.sum(-1))
        ms.append(m[..., 0])
        w = e * tvs[0].transpose(1, 2)[:, :, None, j * chunk:(j + 1) * chunk]
        os_.append(torch.einsum("bhgs,bshd->bhgd", w,
                                vv[:, j * chunk:(j + 1) * chunk]))
    mx = torch.stack(ms).amax(0)
    wts = [torch.exp(m - mx) for m in ms]
    got = (sum(w[..., None] * o for w, o in zip(wts, os_))
           / sum(w * l for w, l in zip(wts, ls))[..., None])
    np.testing.assert_allclose(got.reshape(3, 4, 16).numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-5)
