"""The port's decoder (``ragroute_tpu_torch.llm.model``) against the JAX
package's, on the CPU.

Weights are the JAX package's, carried across with ``params_from_jax``; the
oracles for the HF layouts are tiny ``transformers`` causal LMs built in
process (the strategy of ``tests/test_llm_jax.py``). Held at f32:

* prefill logits within 2e-4 of the JAX decoder's and of HF's, for Llama
  with and without the Llama-3.1 rope rescale and for Qwen3 (qk-norm, a
  decoupled head_dim, tied embeddings);
* ``decode_step`` against a fresh prefill of the extended sequence;
* greedy ``generate`` token for token against JAX's, with f32, int8 and
  int4 weights (the int4 matmul's plain version) and with an int8 KV
  cache, including an EOS that fires mid-answer, padding and budgets;
* ``quantize_decoder_params``' codes and scales bit for bit;
* ``sample_token`` at T > 0 by its properties (jax.random draws cannot be
  reproduced in torch).

The expensive JAX results are module-scoped fixtures, so each JAX function
compiles once a file.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from ragroute_tpu.llm import model as jm
from ragroute_tpu_torch.llm import model as tm


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield


def _tiny_hf(kind):
    from transformers import (LlamaConfig, LlamaForCausalLM, Qwen3Config,
                              Qwen3ForCausalLM)

    if kind == "qwen3":
        torch.manual_seed(1)
        hf_cfg = Qwen3Config(
            vocab_size=83, hidden_size=40, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16, max_position_embeddings=64,
            rope_theta=1e6, rms_norm_eps=1e-6, tie_word_embeddings=True,
            attn_implementation="eager")
        return Qwen3ForCausalLM(hf_cfg).eval(), hf_cfg
    scaling = None if kind == "llama" else {
        "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
        "high_freq_factor": 4.0, "original_max_position_embeddings": 16}
    torch.manual_seed(0)
    hf_cfg = LlamaConfig(
        vocab_size=97, hidden_size=48, intermediate_size=80,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rope_theta=10000.0, rms_norm_eps=1e-6,
        rope_scaling=scaling, attn_implementation="eager")
    return LlamaForCausalLM(hf_cfg).eval(), hf_cfg


def _left_padded(vocab, lengths, p, seed=3):
    rng = np.random.default_rng(seed)
    ids = np.zeros((len(lengths), p), np.int32)
    mask = np.zeros((len(lengths), p), np.int32)
    for b, n in enumerate(lengths):
        ids[b, p - n:] = rng.integers(1, vocab, n)
        mask[b, p - n:] = 1
    return ids, mask


def _tcfg(cfg) -> tm.DecoderConfig:
    import dataclasses

    return tm.DecoderConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("kind", ["llama", "llama-rope-scaling", "qwen3"])
def test_prefill_logits_match_jax_and_hf(kind):
    model, hf_cfg = _tiny_hf(kind)
    cfg = tm.config_from_hf(hf_cfg)
    jcfg = jm.config_from_hf(hf_cfg)
    assert cfg == _tcfg(jcfg)
    assert cfg.qk_norm == cfg.tie_embeddings == (kind == "qwen3")
    assert (cfg.rope_scaling is not None) == (kind == "llama-rope-scaling")
    np.testing.assert_array_equal(tm._inv_freq(cfg), jm._inv_freq(jcfg))
    jparams = jm.params_from_torch_causal_lm(model.state_dict(), jcfg)
    lengths = [9, 4] if kind == "qwen3" else [12, 7, 12]
    ids, mask = _left_padded(cfg.vocab_size, lengths, max(lengths))
    want, jcache = jm.prefill(jparams, jcfg, jnp.asarray(ids),
                              jnp.asarray(mask),
                              jm.init_cache(jcfg, len(lengths),
                                            ids.shape[1] + 1))
    pos = np.maximum(np.cumsum(mask, axis=1) - 1, 0)
    with torch.no_grad():
        hf = model(input_ids=torch.tensor(ids, dtype=torch.long),
                   attention_mask=torch.tensor(mask, dtype=torch.long),
                   position_ids=torch.tensor(pos, dtype=torch.long)
                   ).logits[:, -1].numpy()
        for params in (tm.params_from_jax(jparams),
                       tm.params_from_torch_causal_lm(model.state_dict(),
                                                      cfg)):
            cache = tm.init_cache(cfg, len(lengths), ids.shape[1] + 1)
            got, cache = tm.prefill(params, cfg, torch.from_numpy(ids),
                                    torch.from_numpy(mask), cache)
            assert got.dtype == torch.float32
            for ref in (np.asarray(want), hf):
                np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4,
                                           atol=2e-4)
    # the cache holds the prompt's K/V at the JAX package's slots
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]),
                               rtol=1e-4, atol=1e-4)


def test_decode_step_consistent_with_prefill():
    """Decoding token by token through the KV cache equals a fresh prefill
    of the extended sequence at every step, and JAX's decode_step."""
    model, hf_cfg = _tiny_hf("qwen3")
    cfg = tm.config_from_hf(hf_cfg)
    jcfg = jm.config_from_hf(hf_cfg)
    jparams = jm.params_from_torch_causal_lm(model.state_dict(), jcfg)
    params = tm.params_from_jax(jparams)
    lengths, p, steps = [6, 2], 6, 4
    ids, mask = _left_padded(cfg.vocab_size, lengths, p, seed=7)
    lens = torch.tensor(lengths, dtype=torch.int32)
    with torch.no_grad():
        logits, cache = tm.prefill(params, cfg, torch.from_numpy(ids),
                                   torch.from_numpy(mask),
                                   tm.init_cache(cfg, 2, p + steps))
        jcache = jm.prefill(jparams, jcfg, jnp.asarray(ids),
                            jnp.asarray(mask),
                            jm.init_cache(jcfg, 2, p + steps))[1]
        cur_ids, cur_mask = ids.copy(), mask.copy()
        tok = torch.argmax(logits, -1).to(torch.int32)
        for t in range(steps):
            cur_ids = np.concatenate([cur_ids, tok.numpy()[:, None]], axis=1)
            cur_mask = np.concatenate([cur_mask, np.ones((2, 1), np.int32)],
                                      axis=1)
            oracle, _ = tm.prefill(params, cfg, torch.from_numpy(cur_ids),
                                   torch.from_numpy(cur_mask),
                                   tm.init_cache(cfg, 2, cur_ids.shape[1]))
            step, cache = tm.decode_step(params, cfg, cache, tok, lens, p, t)
            jstep, jcache = jm.decode_step(
                jparams, jcfg, jcache, jnp.asarray(tok.numpy()),
                jnp.asarray(lengths, jnp.int32), p, jnp.int32(t))
            for ref in (oracle.numpy(), np.asarray(jstep)):
                np.testing.assert_allclose(step.numpy(), ref, rtol=2e-4,
                                           atol=2e-4)
            tok = torch.argmax(step, -1).to(torch.int32)


# ---- greedy generation against JAX, with every weight / cache format --------

GEN_CFG = dict(vocab_size=61, hidden_size=48, num_layers=2, num_heads=4,
               num_kv_heads=2, head_dim=16, intermediate_size=96,
               qk_norm=True)
LENGTHS = [9, 3, 7, 1]
MAX_NEW = 10
BUDGETS = [10, 4, 1, 7]


@pytest.fixture(scope="module")
def gen_world():
    """JAX weights (f32, int8, int4), the prompts, an EOS that fires
    mid-answer in the f32 run, and JAX's greedy tokens for each variant."""
    jcfg = jm.DecoderConfig(**GEN_CFG)
    jparams = jm.init_decoder_params(jax.random.key(4), jcfg)
    ids, mask = _left_padded(jcfg.vocab_size, LENGTHS, max(LENGTHS), seed=5)
    budgets = jnp.asarray(BUDGETS, jnp.int32)

    def run(params, cache_dtype, eos):
        fn = jax.jit(lambda pr, i, m, bud: jm.generate(
            pr, jcfg, i, m, MAX_NEW, eos_id=eos, pad_id=0,
            cache_dtype=cache_dtype, budgets=bud))
        toks, done = fn(params, jnp.asarray(ids), jnp.asarray(mask), budgets)
        return np.asarray(toks), np.asarray(done)

    # an EOS: row 0's fourth token where it first appears there
    first, _ = run(jparams, jnp.float32, -1)
    eos = int(next(t for j, t in enumerate(first[0])
                   if j >= 3 and t not in first[0][:j]))
    weights = {"f32": jparams,
               "int8": jm.quantize_decoder_params(jparams, jcfg, bits=8),
               "int4": jm.quantize_decoder_params(jparams, jcfg, bits=4)}
    want = {}
    for wname, params in weights.items():
        want[wname] = run(params, jnp.float32, eos)
    want["int8-kv"] = run(jparams, "int8", eos)
    return dict(jcfg=jcfg, weights=weights, ids=ids, mask=mask, eos=eos,
                want=want)


@pytest.mark.parametrize("variant", ["f32", "int8", "int4", "int8-kv"])
def test_greedy_generate_matches_jax_token_for_token(gen_world, variant):
    w = gen_world
    cfg = _tcfg(w["jcfg"])
    jparams = w["weights"]["f32" if variant == "int8-kv" else variant]
    params = tm.params_from_jax(jparams)
    if variant == "int4":
        assert all(isinstance(l.wq, tm.QuantW4) for l in params.layers)
        assert isinstance(params.embed, tm.QuantW4)
    with torch.no_grad():
        toks, done = tm.generate(
            params, cfg, torch.from_numpy(w["ids"]),
            torch.from_numpy(w["mask"]), MAX_NEW, eos_id=w["eos"], pad_id=0,
            cache_dtype="int8" if variant == "int8-kv" else torch.float32,
            budgets=torch.tensor(BUDGETS, dtype=torch.int32))
    want_toks, want_done = w["want"][variant]
    np.testing.assert_array_equal(toks.numpy(), want_toks)
    np.testing.assert_array_equal(done.numpy(), want_done)
    # the budgets and the EOS did cut rows: pads after them
    for r, bud in enumerate(BUDGETS):
        assert (toks[r, bud:] == 0).all()
    if variant == "f32":
        row = toks[0].tolist()
        j = row.index(w["eos"])
        assert all(t == 0 for t in row[j + 1:]) and bool(done[0])


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_decoder_params_codes_equal(gen_world, bits):
    w = gen_world
    cfg = _tcfg(w["jcfg"])
    jq = w["weights"][f"int{bits}"]
    tq = tm.quantize_decoder_params(tm.params_from_jax(w["weights"]["f32"]),
                                    cfg, bits=bits)
    kind = tm.QuantW4 if bits == 4 else tm.QuantW
    pairs = [(tq.embed, jq["embed"])]
    pairs += [(getattr(tl, name), jl[name])
              for tl, jl in zip(tq.layers, jq["layers"])
              for name in tm.LAYER_MATS]
    for t, j in pairs:
        assert isinstance(t, kind)
        np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
        np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
    if bits == 4:
        assert tq.layers[0].wq.group == 24      # 48 / 2: not a multiple of 16
    ids = torch.tensor([[0, 5, 60], [7, 7, 1]])
    np.testing.assert_array_equal(
        tm._embed_lookup(tq, ids).numpy(),
        np.asarray(jm._embed_lookup(jq, jnp.asarray(ids.numpy()))))
    with pytest.raises(ValueError, match="bits"):
        tm.quantize_decoder_params(tq, cfg, bits=2)


def test_int8_kv_cache_structure_and_quant_kv():
    cfg = tm.DecoderConfig(**GEN_CFG)
    cache = tm.init_cache(cfg, 2, 8, "int8")
    assert cache["k"].dtype == torch.int8 and cache["ks"].shape == (2, 2, 8, 2)
    with pytest.raises(ValueError, match="cache dtype"):
        tm.init_cache(cfg, 2, 8, "int4")
    x = np.random.default_rng(0).normal(size=(3, 5, 2, 16)).astype(
        np.float32)
    q, s = tm.quant_kv(torch.from_numpy(x))
    jq, js = jm.quant_kv(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


# ---- sampling ---------------------------------------------------------------

def test_sample_token_greedy_top_k_top_p_and_determinism():
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.normal(size=(4, 50)).astype(np.float32))
    # greedy: the first maximum, as jnp.argmax
    tied = torch.zeros((2, 6))
    tied[:, 2] = tied[:, 4] = 1.0
    assert tm.sample_token(tied, None, 0.0).tolist() == [2, 2]
    np.testing.assert_array_equal(
        tm.sample_token(logits, None, 0.0).numpy(),
        np.asarray(jm.sample_token(jnp.asarray(logits.numpy()), None, 0.0)))
    topk = set()
    nucleus = set()
    for seed in range(200):
        g = tm.make_generator("cpu", seed)
        t = tm.sample_token(logits, g, 1.0, top_k=3)
        topk.update((r, int(v)) for r, v in enumerate(t))
        g = tm.make_generator("cpu", seed)
        nucleus.update((r, int(v)) for r, v in enumerate(
            tm.sample_token(logits, g, 0.7, top_p=0.5)))
    top3 = torch.topk(logits, 3).indices
    assert all(v in top3[r].tolist() for r, v in topk)
    assert len(topk) > 4 * 1              # more than the argmax was drawn
    # the nucleus: the smallest sorted prefix whose mass reaches 0.5
    for r in range(4):
        srt = torch.sort(logits[r] / 0.7, descending=True)
        probs = torch.softmax(srt.values, -1)
        keep = (torch.cumsum(probs, -1) - probs) < 0.5
        allowed = set(srt.indices[keep].tolist())
        drawn = {v for rr, v in nucleus if rr == r}
        assert drawn <= allowed and drawn
    a = tm.sample_token(logits, tm.make_generator("cpu", 5), 1.0)
    b = tm.sample_token(logits, tm.make_generator("cpu", 5), 1.0)
    assert torch.equal(a, b)


def test_generate_with_sampling_is_deterministic_per_seed(gen_world):
    cfg = _tcfg(gen_world["jcfg"])
    params = tm.params_from_jax(gen_world["weights"]["f32"])
    ids = torch.from_numpy(gen_world["ids"])
    mask = torch.from_numpy(gen_world["mask"])

    def run(seed):
        return tm.generate(params, cfg, ids, mask, 6, eos_id=-1,
                           temperature=1.0, top_k=8, rng_seed=seed)[0]

    with torch.no_grad():
        a, b, c = run(3), run(3), run(4)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_degenerate_sampling_arguments_rejected_at_construction():
    from ragroute_tpu_torch.llm.continuous import ContinuousGenerationService
    from ragroute_tpu_torch.llm.service import (DEMO_CFG, ByteTokenizer,
                                                GenerationService,
                                                validate_sampling)

    params = tm.init_decoder_params(0, DEMO_CFG)
    for kw in ({"top_k": -1}, {"top_p": 0.0}, {"top_p": 1.5}):
        with pytest.raises(ValueError):
            validate_sampling(kw.get("top_k", 0), kw.get("top_p", 1.0))
        with pytest.raises(ValueError):
            GenerationService(params, DEMO_CFG, ByteTokenizer(), **kw)
        with pytest.raises(ValueError):
            ContinuousGenerationService(params, DEMO_CFG, ByteTokenizer(),
                                        cache_len=600, **kw)
    with pytest.raises(ValueError, match="greedy"):
        ContinuousGenerationService(params, DEMO_CFG, ByteTokenizer(),
                                    cache_len=600, spec_window=4,
                                    temperature=0.5)
    with pytest.raises(ValueError, match="spec_window"):
        ContinuousGenerationService(params, DEMO_CFG, ByteTokenizer(),
                                    cache_len=600, spec_window=1)
    with pytest.raises(ValueError, match="cache_len"):
        ContinuousGenerationService(params, DEMO_CFG, ByteTokenizer(),
                                    cache_len=512)


def test_unsupported_rope_scaling_refused():
    from transformers import LlamaConfig

    hf_cfg = LlamaConfig(vocab_size=16, hidden_size=16, intermediate_size=16,
                         num_hidden_layers=1, num_attention_heads=2,
                         rope_scaling={"rope_type": "yarn", "factor": 2.0})
    with pytest.raises(ValueError, match="rope_scaling"):
        tm.config_from_hf(hf_cfg)
