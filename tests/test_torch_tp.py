"""The port's tensor-parallel decoder (``ragroute_tpu_torch.llm.sharding``)
against the JAX package's GSPMD layout, on the CPU.

Weights are the JAX package's, carried across with ``params_from_jax``; the
port's meshes name the CPU eight times, the JAX package's are the eight
virtual host devices. Held:

* greedy tokens of the port's TP ``generate`` over a 2x4 mesh equal the JAX
  package's sharded ``generate`` (``tests/test_llm_jax.py``'s TP case: its
  config and left-padded batch) and the port's single-device run, also for
  uneven batches and a batch smaller than dp;
* prefill logits within 1e-5 of the single device's at f32 over every mesh
  shape the config divides;
* a tied head with qk-norm, and an int8 KV cache, give the single device's
  and the JAX decoder's tokens;
* the lockstep service over TP weights, at a micro-batch of three rows
  that dp does not divide, answers as the unsharded one and the JAX
  package's;
* the continuous service over TP weights (with the shared prefix, a
  speculative window and an int8 cache) answers as the unsharded one, at
  ``tests/test_llm_continuous.py``'s TP config with the byte tokenizer's
  vocabulary (260: the JAX decoder clamps out-of-range ids, torch raises);
* the JAX package's divisibility errors, word for word, and the refusal of
  quantized weights;
* each cell holds 1/idx of every split matrix as a view of the unsharded
  weight, and the spec trees equal the JAX package's.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, NamedSharding
from threadpoolctl import threadpool_limits

from ragroute_tpu.llm import continuous as jc
from ragroute_tpu.llm import model as jm
from ragroute_tpu.llm import service as js
from ragroute_tpu.llm import sharding as jsh
from ragroute_tpu_torch.llm import model as tm
from ragroute_tpu_torch.llm import sharding as tsh
from ragroute_tpu_torch.llm.continuous import ContinuousGenerationService
from ragroute_tpu_torch.llm.service import ByteTokenizer
from ragroute_tpu_torch.parallel.mesh import make_mesh

CFG = jm.DecoderConfig(vocab_size=64, hidden_size=32, num_layers=2,
                       num_heads=8, num_kv_heads=4, head_dim=8,
                       intermediate_size=64)
MAX_NEW = 6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield


def _cfg(c) -> tm.DecoderConfig:
    return tm.DecoderConfig(**vars(c))


def _left_padded_batch(vocab, lengths, p, seed=3):
    rng = np.random.default_rng(seed)
    ids = np.zeros((len(lengths), p), np.int32)
    mask = np.zeros((len(lengths), p), np.int32)
    for b, n in enumerate(lengths):
        ids[b, p - n:] = rng.integers(1, vocab, n)
        mask[b, p - n:] = 1
    return ids, mask


def _tmesh(dp=2, idx=4):
    return make_mesh(dp, idx, devices=[torch.device("cpu")] * (dp * idx))


def _jmesh():
    return JMesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("dp", "idx"))


def _port_generate(params, cfg, ids, mask, **kw):
    toks, _ = tm.generate(params, _cfg(cfg), torch.from_numpy(ids),
                          torch.from_numpy(mask), MAX_NEW, eos_id=-1,
                          pad_id=0, **kw)
    return toks.numpy()


@pytest.fixture(scope="module")
def weights():
    jparams = jm.init_decoder_params(jax.random.key(2), CFG)
    return jparams, tm.params_from_jax(jparams)


def test_tp_generate_equals_jax_sharded_and_single_device(weights):
    """tests/test_llm_jax.py's TP case: the JAX sharded generate over its
    (dp=2, idx=4) mesh, the port's TP generate over 2x4 and the port's
    single-device generate give the same greedy tokens."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh")
    jparams, params = weights
    ids, mask = _left_padded_batch(CFG.vocab_size, [8, 3, 6, 8], 8, seed=13)
    mesh = _jmesh()
    sharded = jsh.shard_decoder_params(jparams, CFG, mesh, axis="idx")
    ds = NamedSharding(mesh, jsh.data_spec(mesh))
    want, _ = jax.jit(
        lambda pr, i, m: jm.generate(pr, CFG, i, m, MAX_NEW, eos_id=-1,
                                     pad_id=0),
        in_shardings=(jax.tree.map(lambda s: NamedSharding(mesh, s),
                                   jsh.decoder_param_specs(CFG)), ds, ds))(
        sharded, jnp.asarray(ids), jnp.asarray(mask))
    tp = tsh.shard_decoder_params(params, _cfg(CFG), _tmesh())
    np.testing.assert_array_equal(_port_generate(tp, CFG, ids, mask),
                                  np.asarray(want))
    np.testing.assert_array_equal(_port_generate(params, CFG, ids, mask),
                                  np.asarray(want))


@pytest.mark.parametrize("lengths", [[5, 8, 2], [7]])
def test_tp_generate_uneven_and_small_batches(weights, lengths):
    """Batches that dp does not divide (3 rows over 2; 1 row leaves a dp
    row empty) give the single device's tokens."""
    _, params = weights
    ids, mask = _left_padded_batch(CFG.vocab_size, lengths, 8, seed=4)
    tp = tsh.shard_decoder_params(params, _cfg(CFG), _tmesh())
    np.testing.assert_array_equal(_port_generate(tp, CFG, ids, mask),
                                  _port_generate(params, CFG, ids, mask))


@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (2, 4), (4, 2), (4, 1)])
def test_tp_prefill_logits_within_1e5(weights, shape):
    """Prefill's last-position logits at f32 within 1e-5 of the single
    device's (and of the JAX decoder's) over each mesh shape, the cache
    written head by head."""
    jparams, params = weights
    ids, mask = _left_padded_batch(CFG.vocab_size, [8, 3, 6, 8], 8, seed=13)
    cfg = _cfg(CFG)
    tp = tsh.shard_decoder_params(params, cfg, _tmesh(*shape))
    ti, tmask = torch.from_numpy(ids), torch.from_numpy(mask)
    with torch.no_grad():
        want, cache1 = tm.prefill(params, cfg, ti, tmask,
                                  tm.init_cache(cfg, 4, 8))
        got, cache2 = tm.prefill(tp, cfg, ti, tmask,
                                 tp.init_cache(cfg, 4, 8, torch.float32))
    jl, _ = jm.prefill(jparams, CFG, jnp.asarray(ids), jnp.asarray(mask),
                       jm.init_cache(CFG, 4, 8))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-5)
    # the cells' cache slices are the single cache's heads and rows
    k = cache2["k"]
    assert tuple(k.shape) == tuple(cache1["k"].shape)
    for d, (lo, hi) in enumerate(k.rows):
        heads = torch.cat([p[:, :hi - lo] for p in k.parts[d]], dim=3)
        torch.testing.assert_close(heads, cache1["k"][:, lo:hi], rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_tp_tied_head_qk_norm_and_int8_cache(cache_dtype):
    """A tied head (computed once on each row's first cell) with Qwen3's
    qk-norm, over a float and an int8 KV cache (codes and per-(position,
    head) scales split with the heads): the single device's tokens and the
    JAX decoder's."""
    cfg = jm.DecoderConfig(vocab_size=64, hidden_size=32, num_layers=2,
                           num_heads=8, num_kv_heads=4, head_dim=8,
                           intermediate_size=64, qk_norm=True,
                           tie_embeddings=True)
    jparams = jm.init_decoder_params(jax.random.key(7), cfg)
    params = tm.params_from_jax(jparams)
    ids, mask = _left_padded_batch(cfg.vocab_size, [8, 5, 1, 7], 8, seed=2)
    jdt = jnp.float32 if cache_dtype == "float32" else "int8"
    tdt = torch.float32 if cache_dtype == "float32" else "int8"
    want, _ = jm.generate(jparams, cfg, jnp.asarray(ids), jnp.asarray(mask),
                          MAX_NEW, eos_id=-1, pad_id=0, cache_dtype=jdt)
    tp = tsh.shard_decoder_params(params, _cfg(cfg), _tmesh())
    assert "lm_head" not in dict(tp.cells[1][3].items())
    single = _port_generate(params, cfg, ids, mask, cache_dtype=tdt)
    np.testing.assert_array_equal(
        _port_generate(tp, cfg, ids, mask, cache_dtype=tdt), single)
    np.testing.assert_array_equal(single, np.asarray(want))


CONT_CFG = dict(vocab_size=260, hidden_size=32, num_layers=2, num_heads=8,
                num_kv_heads=4, head_dim=8, intermediate_size=64)
MSGS = ["hello tp", "sharded decode", "a third request for two slots"]
HEAD = "mesh dryrun system head"


async def _serve(svc, msgs):
    try:
        return await asyncio.gather(*[svc.chat(m) for m in msgs])
    finally:
        await svc.stop()


@pytest.fixture(scope="module")
def cont():
    """tests/test_llm_continuous.py's TP config (vocabulary 260) and the JAX
    package's unsharded continuous service's answers."""
    cfg = jm.DecoderConfig(**CONT_CFG)
    jparams = jm.init_decoder_params(jax.random.key(5), cfg)
    tok = js.ByteTokenizer()
    msgs = [[{"role": "user", "content": u}] for u in MSGS]
    want = asyncio.run(_serve(jc.ContinuousGenerationService(
        jparams, cfg, tok, slots=2, cache_len=256, max_new_tokens=10,
        prompt_buckets=(128,), chunk_steps=4, cache_dtype=jnp.float32,
        eos_id=tok.eos_id, pad_id=tok.pad_id), msgs))
    return tm.params_from_jax(jparams), want, jparams


@pytest.mark.parametrize("mode", ["plain", "prefix", "prefix_spec_int8"])
def test_continuous_service_over_tp_equals_unsharded(cont, mode):
    """Slots split over dp (2 slots, 3 requests: one waits for a slot), the
    admission's K/V sent to the dp row of its slot: the TP service answers
    as the unsharded one, and, without a prefix, as the JAX service."""
    from ragroute_tpu_torch.llm.continuous import shared_prefix_ids

    params, want, _ = cont
    cfg = tm.DecoderConfig(**CONT_CFG)
    tok = ByteTokenizer()
    kw = dict(slots=2, cache_len=256, max_new_tokens=10,
              prompt_buckets=(128,), chunk_steps=4,
              cache_dtype=torch.float32, eos_id=tok.eos_id,
              pad_id=tok.pad_id)
    msgs = [[{"role": "user", "content": u}] for u in MSGS]
    if mode != "plain":
        kw["prefix_ids"] = shared_prefix_ids(tok, HEAD)
        msgs = [[{"role": "system", "content": HEAD}] + m for m in msgs]
    if mode == "prefix_spec_int8":
        kw.update(spec_window=4, cache_dtype="int8")
    tp = tsh.shard_decoder_params(params, cfg, _tmesh())
    got = asyncio.run(_serve(ContinuousGenerationService(tp, cfg, tok, **kw),
                             msgs))
    ref = asyncio.run(_serve(ContinuousGenerationService(params, cfg, tok,
                                                         **kw), msgs))
    assert got == ref
    assert all(isinstance(a, str) and a for a in got)
    if mode == "plain":
        assert got == want


def test_lockstep_service_over_tp_equals_unsharded_and_jax(cont):
    """The lockstep ``GenerationService`` over TP weights: three requests in
    one micro-batch of three rows (dp = 2 does not divide it) answer as the
    unsharded service and as the JAX package's service."""
    from ragroute_tpu_torch.llm.service import GenerationService

    params, _, jparams = cont
    cfg = tm.DecoderConfig(**CONT_CFG)
    tok = ByteTokenizer()
    kw = dict(max_new_tokens=10, prompt_buckets=(128,), batch_buckets=(3,),
              flush_interval_s=0.01, eos_id=tok.eos_id, pad_id=tok.pad_id)
    msgs = [[{"role": "user", "content": u}] for u in MSGS]
    svcs = [GenerationService(p, cfg, tok, cache_dtype=torch.float32, **kw)
            for p in (tsh.shard_decoder_params(params, cfg, _tmesh()),
                      params)]
    jsvc = js.GenerationService(jparams, jm.DecoderConfig(**CONT_CFG),
                                js.ByteTokenizer(), cache_dtype=jnp.float32,
                                **kw)
    got, ref, want = [asyncio.run(_serve(svc, msgs))
                      for svc in (*svcs, jsvc)]
    assert [svc.batches for svc in (*svcs, jsvc)] == [1, 1, 1]
    assert got == ref == want
    assert all(isinstance(a, str) and a for a in got)


def test_divisibility_errors_match_jax_and_quantized_weights_are_refused(
        weights):
    jparams, params = weights
    for bad in (dict(num_heads=6, num_kv_heads=3),
                dict(intermediate_size=66)):
        jcfg = jm.DecoderConfig(**{**vars(CFG), **bad})
        with pytest.raises(ValueError) as want:
            jsh.shard_decoder_params(jparams, jcfg, _jmesh())
        with pytest.raises(ValueError) as got:
            tsh.shard_decoder_params(params, _cfg(jcfg), _tmesh())
        assert str(got.value) == str(want.value)
    for bits in (8, 4):
        q = tm.quantize_decoder_params(params, _cfg(CFG), bits=bits)
        with pytest.raises(ValueError, match="float weights"):
            tsh.shard_decoder_params(q, _cfg(CFG), _tmesh())


def test_each_cell_holds_its_slice_as_a_view_and_specs_equal_jax(weights):
    _, params = weights
    cfg = _cfg(CFG)
    mesh = _tmesh()
    tp = tsh.shard_decoder_params(params, cfg, mesh)
    specs = tsh.decoder_param_specs(cfg)
    want = jsh.decoder_param_specs(CFG)
    assert jax.tree.map(tuple, want) == specs
    assert tsh.data_spec(mesh) == tuple(jsh.data_spec(_jmesh()))
    assert tsh.data_spec(_tmesh(1, 4)) == (None, None)

    def inside(part, whole):
        lo = whole.untyped_storage().data_ptr()
        hi = lo + whole.untyped_storage().nbytes()
        return lo <= part.data_ptr() < hi

    for d in range(2):
        for i in range(4):
            cell = tp.cells[d][i]
            for li, (layer, full) in enumerate(zip(cell.layers,
                                                   params.layers)):
                for name, w in layer.items():
                    whole = dict(full.items())[name]
                    spec = specs["layers"][li][name]
                    shape = list(whole.shape)
                    if spec:
                        ax = spec.index("idx")
                        shape[ax] //= 4
                        off = i * shape[ax]
                        ref = whole.narrow(ax, off, shape[ax])
                    else:
                        ref = whole
                    assert list(w.shape) == shape, (name, w.shape)
                    assert torch.equal(w, ref) and inside(w, whole), name
            assert cell.lm_head.shape == (32, 16)
            assert inside(cell.embed, params.embed)
    assert tp.cell_cfg.num_heads == 2 and tp.cell_cfg.num_kv_heads == 1
