"""The port's generation services against the JAX package's, on the CPU.

The JAX package's demo weights are carried across (``params_from_jax``), so
both packages serve the same decoder. Held, greedy:

* the port's lockstep ``GenerationService`` answers the same prompts with
  the same texts as the JAX package's;
* the port's continuous service, with a speculative window, with the
  shared-prefix KV and with both, answers with the lockstep service's texts
  under slot contention (more requests than slots), as
  ``tests/test_llm_continuous.py`` and ``tests/test_llm_speculative.py``
  hold the JAX services;
* slot reuse, per-request budgets, a cache-capacity stop, stop(), a failed
  step and the recovery after it, the stream's deltas;
* the ``ragroute_jax_params.npz`` cache read and written by either package,
  and ``from_checkpoint`` on a tiny local HF checkpoint.
"""

import asyncio
import os

import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from ragroute_tpu.llm import continuous as jc
from ragroute_tpu.llm import model as jm
from ragroute_tpu.llm import service as js
from ragroute_tpu.llm import speculative as jspec
from ragroute_tpu_torch.llm import continuous as tc
from ragroute_tpu_torch.llm import model as tm
from ragroute_tpu_torch.llm import service as ts
from ragroute_tpu_torch.llm import speculative as tspec

MAX_NEW = 12
PROMPTS = ["what is the capital of france?", "2+2=", "a",
           "tell me about the heart and the lungs, in detail please",
           "why?", "zz top", "the quick brown fox"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield


def _msgs(p):
    return [{"role": "user", "content": p}]


async def _ask(svc, prompts, max_new=None):
    try:
        return await asyncio.gather(*[svc.chat(_msgs(p), max_new=max_new)
                                      for p in prompts])
    finally:
        await svc.stop()


@pytest.fixture(scope="module")
def demo():
    """JAX demo weights, the port's copy of them, and the JAX lockstep
    service's answers to PROMPTS (one batch, one compile)."""
    jparams = jm.init_decoder_params(jax.random.key(0), js.DEMO_CFG)
    jsvc = js.GenerationService(jparams, js.DEMO_CFG, js.ByteTokenizer(),
                                max_new_tokens=MAX_NEW,
                                prompt_buckets=(128, 512),
                                batch_buckets=(8,), flush_interval_s=0.01,
                                eos_id=258, pad_id=256,
                                cache_dtype=jax.numpy.float32)
    want = asyncio.run(_ask(jsvc, PROMPTS))
    assert jsvc.batches == 1
    return dict(jparams=jparams, params=tm.params_from_jax(jparams),
                want=want)


def _batch(demo, **kw):
    kw.setdefault("max_new_tokens", MAX_NEW)
    kw.setdefault("cache_dtype", torch.float32)
    return ts.GenerationService(demo["params"], ts.DEMO_CFG,
                                ts.ByteTokenizer(), prompt_buckets=(128, 512),
                                flush_interval_s=0.01, **kw)


def _continuous(demo, **kw):
    kw.setdefault("max_new_tokens", MAX_NEW)
    kw.setdefault("cache_dtype", torch.float32)
    tok = ts.ByteTokenizer()
    return tc.ContinuousGenerationService(
        demo["params"], ts.DEMO_CFG, tok, prompt_buckets=(64, 128),
        cache_len=160, eos_id=tok.eos_id, pad_id=tok.pad_id, **kw)


def test_demo_config_tokenizer_and_helpers_are_the_jax_packages():
    assert ts.DEMO_CFG.__dict__ == js.DEMO_CFG.__dict__
    tt, jt = ts.ByteTokenizer(), js.ByteTokenizer()
    for text in ("hello", "ünïcödé ✓", ""):
        assert tt.encode(text) == jt.encode(text)
        assert tt.decode(tt.encode(text)) == text
    msgs = [{"role": "system", "content": "s"}, {"role": "user", "content": "u"}]
    assert tt.apply_chat_template(msgs) == jt.apply_chat_template(msgs)
    assert ts.encode_prompt(tt, msgs, 5) == js.encode_prompt(jt, msgs, 5)
    assert ts.pick_bucket((4, 16), 5) == js.pick_bucket((4, 16), 5) == 16
    assert ts.clamp_budget(99, 8) == js.clamp_budget(99, 8) == 8
    for system in (None, "You are a medical expert."):
        assert (tc.shared_prefix_ids(tt, system)
                == jc.shared_prefix_ids(jt, system))


def test_batch_service_matches_jax_service(demo):
    svc = _batch(demo, batch_buckets=(1, 4, 16))
    got = asyncio.run(_ask(svc, PROMPTS))
    assert got == demo["want"]
    assert svc.batches < len(PROMPTS)          # concurrent calls shared
    assert svc.generated_tokens > 0


@pytest.mark.parametrize("spec,prefix", [(0, False), (4, False), (0, True),
                                         (3, True)])
def test_continuous_service_matches_lockstep(demo, spec, prefix):
    """Two slots for seven requests: slots are reused, admissions land
    mid-flight, and the answers are the lockstep service's."""
    pre = tc.shared_prefix_ids(ts.ByteTokenizer(), None) if prefix else None
    svc = _continuous(demo, slots=2, chunk_steps=5, spec_window=spec,
                      prefix_ids=pre)
    got = asyncio.run(_ask(svc, PROMPTS))
    assert got == demo["want"]
    assert svc.admissions >= 4 and svc.chunks >= 3
    assert all(r is None for r in svc._slot_req)
    if spec:
        assert svc.spec_steps > 0 and svc.spec_emitted >= svc.spec_steps


def test_int8_kv_cache_continuous_matches_lockstep(demo):
    want = asyncio.run(_ask(_batch(demo, cache_dtype="int8"), PROMPTS[:4]))
    got = asyncio.run(_ask(_continuous(demo, slots=3, cache_dtype="int8"),
                           PROMPTS[:4]))
    assert got == want


def test_per_request_budget_in_both_services(demo):
    """``max_new=3`` cuts each answer to its first three tokens, alike in
    the lockstep service, the continuous one and its speculative mode."""
    outs = [asyncio.run(_ask(svc, PROMPTS[:3], max_new=3)) for svc in (
        _batch(demo), _continuous(demo, slots=2),
        _continuous(demo, slots=2, spec_window=3))]
    assert outs[0] == outs[1] == outs[2]
    for got, full in zip(outs[0], demo["want"]):
        assert full.startswith(got.rstrip("�"))
        assert len(got) <= 3 and len(got) < len(full)


def test_capacity_stop_finishes_the_request(demo):
    tok = ts.ByteTokenizer()
    svc = tc.ContinuousGenerationService(
        demo["params"], ts.DEMO_CFG, tok, slots=1, cache_len=48,
        max_new_tokens=64, prompt_buckets=(32,), chunk_steps=8,
        cache_dtype=torch.float32, eos_id=tok.eos_id, pad_id=tok.pad_id)

    async def run():
        try:
            return await asyncio.wait_for(svc.chat(_msgs("xyz")), 60)
        finally:
            await svc.stop()

    assert isinstance(asyncio.run(run()), str)
    assert all(r is None for r in svc._slot_req)


def test_failed_step_fails_callers_and_the_worker_recovers(demo):
    svc = _continuous(demo, slots=2, chunk_steps=3, max_new_tokens=6)
    real_chunk = svc._run_chunk
    calls = {"n": 0}

    def failing_chunk():
        calls["n"] += 1
        real_chunk()                  # the state is written, then it fails
        raise RuntimeError("synthetic device failure")

    async def run():
        svc._run_chunk = failing_chunk
        with pytest.raises(RuntimeError, match="synthetic device"):
            await asyncio.wait_for(svc.chat(_msgs("a")), 60)
        stale = svc._state
        svc._run_chunk = real_chunk
        out = await asyncio.wait_for(svc.chat(_msgs("a")), 60)
        await svc.stop()
        return stale, out

    stale, out = asyncio.run(run())
    assert calls["n"] == 1 and isinstance(out, str)
    assert stale is not None and all(r is None for r in svc._slot_req)
    want = asyncio.run(_ask(_batch(demo, max_new_tokens=6), ["a"]))
    assert out == want[0]


def test_stop_cancels_waiters_of_both_services(demo):
    async def run(svc, make):
        req = make(svc)
        await svc.stop()
        with pytest.raises(asyncio.CancelledError):
            await req

    async def queued_batch(svc):
        fut = asyncio.get_running_loop().create_future()
        await svc._queue.put(([1, 2], 4, fut))
        return fut

    async def both():
        bsvc = _batch(demo)
        fut = await queued_batch(bsvc)
        await bsvc.stop()
        with pytest.raises(asyncio.CancelledError):
            await fut
        csvc = _continuous(demo, slots=1)
        req = csvc._make_request(_msgs("x"), None)
        await csvc._queue.put(req)
        await csvc.stop()
        with pytest.raises(asyncio.CancelledError):
            await req["future"]

    asyncio.run(both())


def test_chat_stream_deltas_join_to_the_answer(demo):
    svc = _continuous(demo, slots=1, chunk_steps=4)

    async def run():
        deltas, final = [], None
        async for item in svc.chat_stream(_msgs(PROMPTS[0])):
            if isinstance(item, dict):
                final = item
            else:
                deltas.append(item)
        await svc.stop()
        return deltas, final

    deltas, final = asyncio.run(run())
    assert final["final"] == demo["want"][0] and "error" not in final
    assert demo["want"][0].startswith("".join(deltas))
    q = asyncio.Queue()
    req = {"tokens": [ord("h"), 0xC3], "stream": q, "streamed": "",
           "max_new": 8}
    svc._push_stream_delta(req)                 # a trailing partial 'é'
    req["tokens"].append(0xA9)
    svc._push_stream_delta(req)
    assert [q.get_nowait(), q.get_nowait()] == ["h", "é"]


def test_prefix_mismatch_raises(demo):
    tok = ts.ByteTokenizer()
    pre = tc.shared_prefix_ids(tok, "You are a helpful assistant.")
    svc = _continuous(demo, slots=1, prefix_ids=pre)

    async def run():
        try:
            await svc.chat(_msgs("no system head here"))
        finally:
            await svc.stop()

    with pytest.raises(ValueError, match="shared prefix"):
        asyncio.run(run())


def test_draft_from_history_matches_jax():
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 5, (6, 40)).astype(np.int32)
    counts = np.array([0, 1, 5, 20, 38, 39], np.int32)
    for w in (2, 4):
        want = np.asarray(jspec.draft_from_history(
            jax.numpy.asarray(toks), jax.numpy.asarray(counts), w))
        got = tspec.draft_from_history(torch.from_numpy(toks),
                                       torch.from_numpy(counts), w)
        np.testing.assert_array_equal(got.numpy(), want)


# ---- weights from disk --------------------------------------------------------

def test_params_cache_is_read_and_written_by_both_packages(tmp_path):
    cfg = jm.DecoderConfig(vocab_size=64, hidden_size=32, num_layers=2,
                           num_heads=4, num_kv_heads=2, head_dim=8,
                           intermediate_size=64, qk_norm=True)
    jparams = jm.init_decoder_params(jax.random.key(9), cfg,
                                     dtype=jax.numpy.bfloat16)
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    js.save_params_cache(a, jparams, "fp-1")
    got = ts.load_params_cache(a, "fp-1")
    ref = tm.params_from_jax(jparams)
    flat = dict(ref.items())
    for k, v in got.items():
        assert v.dtype == torch.bfloat16 and torch.equal(v, flat[k])
    for gl, rl in zip(got.layers, ref.layers):
        for (k, v), (k2, v2) in zip(sorted(gl.items()), sorted(rl.items())):
            assert k == k2 and torch.equal(v, v2)
    ts.save_params_cache(b, got, "fp-2")
    back = js.load_params_cache(b, "fp-2")
    assert jax.tree.all(jax.tree.map(
        lambda x, y: x.dtype == y.dtype and bool((x == y).all()),
        jparams, back))
    assert ts.load_params_cache(b, "fp-1") is None        # stale
    with open(a, "wb") as f:
        f.write(b"not an npz")
    assert ts.load_params_cache(a, "fp-1") is None        # corrupt


def test_from_checkpoint_converts_caches_and_quantizes(tmp_path,
                                                       monkeypatch):
    import transformers
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(5)
    model = LlamaForCausalLM(LlamaConfig(
        vocab_size=300, hidden_size=48, intermediate_size=80,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, attn_implementation="eager")).eval()
    d = str(tmp_path / "ckpt")
    model.save_pretrained(d)
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        staticmethod(lambda *a, **k: ts.ByteTokenizer()))
    kw = dict(max_new_tokens=4, prompt_buckets=(64,), batch_buckets=(2,),
              flush_interval_s=0.0)
    svc = ts.GenerationService.from_checkpoint(d, **kw)
    assert os.path.exists(os.path.join(d, "ragroute_jax_params.npz"))
    assert svc.params.layers[0].wq.dtype == torch.bfloat16

    def boom(*a, **k):
        raise AssertionError("torch conversion ran despite a valid cache")

    monkeypatch.setattr(transformers.AutoModelForCausalLM, "from_pretrained",
                        staticmethod(boom))
    again = ts.GenerationService.from_checkpoint(d, **kw)
    assert torch.equal(again.params.embed, svc.params.embed)
    # the JAX package serves the port's conversion cache as its own
    jsvc = js.GenerationService.from_checkpoint(d, **kw)
    np.testing.assert_array_equal(
        np.asarray(jsvc.params["embed"]).view(np.uint16),
        svc.params.embed.view(torch.int16).numpy().view(np.uint16))
    q4 = ts.GenerationService.from_checkpoint(d, quantize="int4", **kw)
    assert isinstance(q4.params.layers[0].gate, tm.QuantW4)
    q4.cache_dtype = torch.float32
    out = asyncio.run(_ask(q4, ["hi", "there"]))
    assert all(isinstance(o, str) for o in out)
    with pytest.raises(ValueError, match="quantize"):
        ts.GenerationService.from_checkpoint(d, quantize="int3", **kw)


def test_llm_client_jax_backend_answers(demo):
    from ragroute_tpu_torch.engine.llm import LLMClient

    svc = _batch(demo)
    client = LLMClient("jax", service=svc)

    async def run():
        try:
            return await client.chat("llama3.1-8B-instruct",
                                     _msgs(PROMPTS[1]))
        finally:
            await svc.stop()

    res = asyncio.run(run())
    assert res.ok and res.generate_time >= 0
    assert res.answer == demo["want"][1]
