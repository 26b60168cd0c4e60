"""The port's query encoders (``ragroute_tpu_torch.encoders``) against the
JAX package's, on the CPU.

Tiny models (2 layers, hidden 32, vocab <= 128) built in process with
``transformers`` and f32 weights; tolerance ``rtol=1e-3, atol=1e-4`` as in
``tests/test_encoders.py``, on the unmasked positions. Held:

* each family (BERT, MPNet, GPT-J, T5 gated and ReLU) against the JAX
  forward on the same seeded ids and ragged masks, with the weights carried
  from the same HF state dict and through ``params_from_jax``;
* ``pool`` in its five modes; the SGPT and Instructor encoders against
  ``JaxSGPTEncoder`` / ``SGPTEncoder`` and ``JaxInstructorEncoder`` /
  ``InstructorEncoder`` with one local tokenizer;
* R6: the port's XLM-R path against ``transformers.XLMRobertaModel``, and
  the JAX package's ``bert_encode``, which runs that checkpoint as BERT,
  away from it;
* the port's WordPiece against ``BertTokenizer`` / ``MPNetTokenizer`` and
  its byte-level BPE against ``GPT2Tokenizer`` (fixed strings and a
  ``hypothesis`` strategy over short unicode strings);
* the checkpoint reader (safetensors, ``.bin``, sharded, hub-cache layout)
  against ``from_pretrained``, and ``load_encoder`` against the JAX
  package's ``_load_jax_bert`` at f32 and at bf16 (cosine > 0.999), with
  ``transformers`` hidden from the port.
"""

import os
import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from threadpoolctl import threadpool_limits

from ragroute_tpu.encoders import bert as jbert
from ragroute_tpu.encoders import gptj as jgptj
from ragroute_tpu.encoders import mpnet as jmpnet
from ragroute_tpu.encoders import t5 as jt5
from ragroute_tpu_torch.encoders import bert, checkpoint, gptj, mpnet, t5
from ragroute_tpu_torch.encoders import tokenize as tk

TOL = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield


def _inputs(vocab: int, seq: int = 14, pad: int = 1, seed: int = 0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, vocab, (3, seq)).astype(np.int64)
    mask = np.ones((3, seq), np.int64)
    mask[0, 9:] = 0
    mask[2, 4:] = 0
    ids[mask == 0] = pad
    return ids, mask


def _hf_model(kind: str):
    from transformers import (BertConfig, BertModel, GPTJConfig, GPTJModel,
                              MPNetConfig, MPNetModel, T5Config,
                              T5EncoderModel)

    torch.manual_seed(zlib.crc32(kind.encode()))
    if kind == "bert":
        cfg = BertConfig(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                         num_attention_heads=4, intermediate_size=64,
                         max_position_embeddings=64, type_vocab_size=2)
        return BertModel(cfg).eval(), cfg
    if kind == "mpnet":
        cfg = MPNetConfig(vocab_size=120, hidden_size=32,
                          num_hidden_layers=2, num_attention_heads=4,
                          intermediate_size=64, max_position_embeddings=64)
        return MPNetModel(cfg).eval(), cfg
    if kind == "gptj":
        cfg = GPTJConfig(vocab_size=96, n_positions=64, n_embd=32, n_layer=2,
                         n_head=4, rotary_dim=4,
                         activation_function="gelu_new", attn_pdrop=0.0,
                         resid_pdrop=0.0, embd_pdrop=0.0)
        return GPTJModel(cfg).eval(), cfg
    gated = kind == "t5-gated"
    cfg = T5Config(vocab_size=96, d_model=32, d_kv=8, d_ff=64, num_layers=2,
                   num_heads=4, dropout_rate=0.0, is_encoder_decoder=False,
                   feed_forward_proj="gated-gelu" if gated else "relu")
    return T5EncoderModel(cfg).eval(), cfg


# family -> (JAX module, its import, its forward, port module)
FAMILIES = {
    "bert": (jbert, jbert.params_from_torch_bert, jbert.bert_encode, bert),
    "mpnet": (jmpnet, jmpnet.params_from_torch_mpnet, jmpnet.mpnet_encode,
              mpnet),
    "gptj": (jgptj, jgptj.params_from_torch_gptj, jgptj.gptj_encode, gptj),
    "t5-gated": (jt5, jt5.params_from_torch_t5, jt5.t5_encode, t5),
    "t5-relu": (jt5, jt5.params_from_torch_t5, jt5.t5_encode, t5),
}


@pytest.mark.parametrize("route", ["state_dict", "jax"])
@pytest.mark.parametrize("kind", sorted(FAMILIES))
def test_family_matches_jax_forward(kind, route):
    """The port's forward gives the JAX forward's hidden states from the
    same HF state dict, and from the JAX pytree through ``params_from_jax``
    (BERT: the pooler too)."""
    jmod, jimport, jencode, ours = FAMILIES[kind]
    model, hf_cfg = _hf_model(kind)
    jcfg = jmod.config_from_hf(hf_cfg)
    jparams = jimport(model.state_dict(), jcfg)
    cfg = ours.config_from_hf(hf_cfg)
    if route == "jax":
        np_params = __import__("jax").tree.map(np.asarray, jparams)
        state = ours.params_from_jax(np_params, cfg)
    else:
        state = ours.params_from_state_dict(model.state_dict(), cfg)
    port = ours.from_state(cfg, state)
    ids, mask = _inputs(hf_cfg.vocab_size, pad=0 if "t5" in kind else 1)
    want = jencode(jparams, jcfg, jnp.asarray(ids, jnp.int32),
                   jnp.asarray(mask, jnp.int32))
    with torch.no_grad():
        got = port(torch.from_numpy(ids), torch.from_numpy(mask))
    gh, wh = got["last_hidden"].numpy(), np.asarray(want["last_hidden"])
    for b in range(3):
        n = mask[b].sum()
        np.testing.assert_allclose(gh[b, :n], wh[b, :n], **TOL)
    if kind == "bert":
        np.testing.assert_allclose(got["pooler"].numpy(),
                                   np.asarray(want["pooler"]), **TOL)


@pytest.mark.parametrize("mode", ["cls", "pooler", "mean", "weightedmean",
                                  "lasttoken"])
def test_pool_matches_jax(mode):
    rng = np.random.default_rng(3)
    hid = rng.standard_normal((3, 8, 5)).astype(np.float32)
    mask = np.ones((3, 8), np.int32)
    mask[0, 5:] = 0
    mask[2, :] = 0             # a row with no token: every mode guards it
    outs_j = {"last_hidden": jnp.asarray(hid), "cls": jnp.asarray(hid[:, 0])}
    outs_t = {"last_hidden": torch.from_numpy(hid),
              "cls": torch.from_numpy(hid[:, 0])}
    if mode == "pooler":
        pooled = rng.standard_normal((3, 5)).astype(np.float32)
        outs_j["pooler"] = jnp.asarray(pooled)
        outs_t["pooler"] = torch.from_numpy(pooled)
    want = np.asarray(jbert.pool(outs_j, jnp.asarray(mask), mode))
    got = bert.pool(outs_t, torch.from_numpy(mask), mode).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="pooling"):
        bert.pool(outs_t, torch.from_numpy(mask), "max")


def test_relative_position_bucket_matches_jax():
    rel = np.arange(-300, 301).reshape(1, -1)
    want = np.asarray(jmpnet.relative_position_bucket(jnp.asarray(rel), 32,
                                                      128))
    got = mpnet.relative_position_bucket(torch.from_numpy(rel), 32, 128)
    np.testing.assert_array_equal(got.numpy(), want)


# ---- SGPT and Instructor ------------------------------------------------------

def _local_tokenizer(with_eos: bool = False):
    from tests.test_encoders import _make_local_tokenizer

    return _make_local_tokenizer(with_eos=with_eos)


def test_sgpt_encoder_matches_both_jax_classes():
    from transformers import GPTJConfig, GPTJModel

    from ragroute_tpu.encoders.custom import JaxSGPTEncoder
    from ragroute_tpu.encoders.custom import SGPTEncoder as HFSGPT
    from ragroute_tpu.encoders.registry import EncoderSpec
    from ragroute_tpu_torch.encoders.custom import SGPTEncoder

    tok = _local_tokenizer()
    torch.manual_seed(6)
    model = GPTJModel(GPTJConfig(
        vocab_size=tok.vocab_size + 10, n_positions=64, n_embd=32, n_layer=2,
        n_head=4, rotary_dim=4, activation_function="gelu_new",
        attn_pdrop=0.0, resid_pdrop=0.0, embd_pdrop=0.0)).eval()
    spec = EncoderSpec("sgpt-tiny-specb", "gpt", "local", 32,
                       "weightedmean", normalize=False)
    cfg = gptj.config_from_hf(model.config)
    port = SGPTEncoder(spec, gptj.from_state(
        cfg, gptj.params_from_state_dict(model.state_dict(), cfg)), tok)
    jcfg = jgptj.config_from_hf(model.config)
    jenc = JaxSGPTEncoder(spec, jgptj.params_from_torch_gptj(
        model.state_dict(), jcfg), jcfg, tok, pad_to=32)
    henc = HFSGPT(spec, model=model, tokenizer=tok)
    texts = ["what is diabetes", "the [quick] {brown} fox"]
    for is_query in (True, False):
        got = port.encode(texts, is_query=is_query)
        np.testing.assert_allclose(got, jenc.encode(texts, is_query=is_query),
                                   **TOL)
        np.testing.assert_allclose(got, henc.encode(texts, is_query=is_query),
                                   **TOL)
    assert port.encode_corpus(texts).shape == (2, 32)
    assert port.backend == "torch:cpu"


@pytest.mark.parametrize("with_dense", [False, True])
def test_instructor_encoder_matches_both_jax_classes(with_dense):
    from transformers import T5Config, T5EncoderModel

    from ragroute_tpu.encoders.custom import InstructorEncoder as HFInstr
    from ragroute_tpu.encoders.custom import JaxInstructorEncoder
    from ragroute_tpu.encoders.registry import EncoderSpec
    from ragroute_tpu_torch.encoders.custom import InstructorEncoder

    tok = _local_tokenizer(with_eos=True)
    torch.manual_seed(7)
    model = T5EncoderModel(T5Config(
        vocab_size=tok.vocab_size + 10, d_model=32, d_kv=8, d_ff=64,
        num_layers=2, num_heads=4, dropout_rate=0.0,
        feed_forward_proj="gated-gelu", is_encoder_decoder=False)).eval()
    spec = EncoderSpec("instructor-tiny", "t5", "hkunlp/instructor-large",
                       32, "mean", normalize=True)
    dense, lin = None, None
    if with_dense:
        rng = np.random.default_rng(4)
        dense = (rng.standard_normal((32, 16)).astype(np.float32) / 6,
                 rng.standard_normal(16).astype(np.float32) / 10)
        lin = torch.nn.Linear(32, 16)
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(dense[0].T.copy()))
            lin.bias.copy_(torch.from_numpy(dense[1]))
    cfg = t5.config_from_hf(model.config)
    port = InstructorEncoder(spec, t5.from_state(
        cfg, t5.params_from_state_dict(model.state_dict(), cfg)), tok,
        dense=dense)
    jcfg = jt5.config_from_hf(model.config)
    jenc = JaxInstructorEncoder(spec, jt5.params_from_torch_t5(
        model.state_dict(), jcfg), jcfg, tok, pad_to=48, dense=dense)
    henc = HFInstr(spec, model=model, tokenizer=tok, dense=lin)
    texts = ["what is diabetes", "fox"]
    got = port.encode(texts, dataset="nq")
    np.testing.assert_allclose(got, jenc.encode(texts, dataset="nq"), **TOL)
    np.testing.assert_allclose(got, henc.encode(texts, dataset="nq"), **TOL)
    np.testing.assert_allclose(port.encode_corpus(texts, dataset="nq"),
                               jenc.encode_corpus(texts, dataset="nq"), **TOL)


# ---- R6: multilingual-e5-large is XLM-R, not BERT ----------------------------

def test_xlmr_path_matches_transformers_and_jax_does_not():
    """The port runs an ``xlm-roberta`` checkpoint with XLM-R's positions and
    eps and matches ``XLMRobertaModel``; the JAX package's ``bert_encode``
    (``arange`` positions, eps 1e-12) is far from it (R6)."""
    from transformers import XLMRobertaConfig, XLMRobertaModel

    torch.manual_seed(11)
    hf_cfg = XLMRobertaConfig(
        vocab_size=128, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=40, type_vocab_size=1, pad_token_id=1,
        layer_norm_eps=1e-5)
    model = XLMRobertaModel(hf_cfg).eval()
    cfg = bert.config_from_hf(hf_cfg.to_dict())
    assert cfg.padded_positions and cfg.layer_norm_eps == 1e-5
    port = bert.from_state(cfg, bert.params_from_state_dict(
        model.state_dict(), cfg))
    ids, mask = _inputs(128, pad=1)
    with torch.no_grad():
        want = model(input_ids=torch.from_numpy(ids),
                     attention_mask=torch.from_numpy(mask))
        got = port(torch.from_numpy(ids), torch.from_numpy(mask))
    wh, gh = want.last_hidden_state.numpy(), got["last_hidden"].numpy()
    jcfg = jbert.config_from_hf(hf_cfg)
    jh = np.asarray(jbert.bert_encode(
        jbert.params_from_torch_bert(model.state_dict(), jcfg), jcfg,
        jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32))[
        "last_hidden"])
    jax_err = 0.0
    for b in range(3):
        n = mask[b].sum()
        np.testing.assert_allclose(gh[b, :n], wh[b, :n], **TOL)
        jax_err = max(jax_err, float(np.abs(jh[b, :n] - wh[b, :n]).max()))
    assert jax_err > 0.1, jax_err


# ---- tokenizers ---------------------------------------------------------------

WP_WORDS = ["the", "quick", "brown", "fox", "jump", "##s", "##ed", "over",
            "lazy", "dog", "cafe", "naive", "un", "##believ", "##able", "what",
            "is", "diabetes", "中", "国", "résumé", "Apple", "apple", "!", ",",
            "?", "'", "-", "(", ")", "1", "##2", "##3", "a", "##b", "##c"]
WP_TEXTS = ["The quick brown fox jumps over the lazy dog!",
            "Café naïve résumé, unbelievable... what is Diabetes?",
            "中国 apple-Apple (123) don't   stop\tnow\nok",
            "xylophone zzz qq unbelievableness", "",
            "a" * 150, "abc abc abc abc abc abc abc abc abc abc abc abc"]


def _write_vocab(path, kind):
    head = (["<s>", "<pad>", "</s>", "<unk>", "[UNK]", "<mask>"]
            if kind == "mpnet" else ["[PAD]", "[UNK]", "[CLS]", "[SEP]",
                                     "[MASK]"])
    chars = [chr(c) for c in range(97, 123)]
    vocab = head + chars + ["##" + c for c in chars] + WP_WORDS
    seen, out = set(), []
    for t in vocab:
        if t not in seen:
            seen.add(t)
            out.append(t)
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(out) + "\n")


@pytest.fixture(scope="module")
def wp_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("wordpiece")
    _write_vocab(str(d / "vocab.txt"), "bert")
    m = tmp_path_factory.mktemp("mpnet_vocab")
    _write_vocab(str(m / "vocab.txt"), "mpnet")
    return str(d), str(m)


def _same_batch(ours, theirs, texts, **kw):
    a = ours(texts, return_tensors="np", **kw)
    b = theirs(texts, return_tensors="np", **kw)
    assert set(a) == set(b)
    for key in a:
        np.testing.assert_array_equal(a[key], np.asarray(b[key]), err_msg=key)


@pytest.mark.parametrize("lower", [True, False])
def test_wordpiece_matches_bert_tokenizer(wp_dir, lower):
    from transformers import BertTokenizer

    ref = BertTokenizer(os.path.join(wp_dir[0], "vocab.txt"),
                        do_lower_case=lower)
    ours = tk.WordPieceTokenizer.from_dir(wp_dir[0])
    ours.do_lower_case = lower
    for t in WP_TEXTS:
        assert ours.encode(t, add_special_tokens=False) == ref.encode(
            t, add_special_tokens=False), t
        assert ours.encode(t) == ref.encode(t), t
    _same_batch(ours, ref, WP_TEXTS, padding=True, truncation=True,
                max_length=12)
    _same_batch(ours, ref, WP_TEXTS[:3], padding="max_length",
                truncation=True, max_length=40)
    assert ours.encode(WP_TEXTS[0], add_special_tokens=False,
                       truncation=True, max_length=3) == ref.encode(
        WP_TEXTS[0], add_special_tokens=False, truncation=True, max_length=3)
    assert ours.pad_token_id == ref.pad_token_id


def test_wordpiece_matches_mpnet_tokenizer(wp_dir):
    from transformers import MPNetTokenizer

    ref = MPNetTokenizer(os.path.join(wp_dir[1], "vocab.txt"))
    ours = tk.load_tokenizer(wp_dir[1], "mpnet")
    for t in WP_TEXTS:
        assert ours.encode(t) == ref.encode(t), t
    _same_batch(ours, ref, WP_TEXTS, padding=True, truncation=True,
                max_length=16)
    assert ours.pad_token_id == ref.pad_token_id


@settings(max_examples=150, deadline=None, database=None)
@given(st.text(alphabet=st.characters(
    whitelist_categories=("Lu", "Ll", "Lo", "Mn", "Nd", "No", "Po", "Ps",
                          "Pe", "Pd", "Sm", "Sc", "Zs")), max_size=24))
def test_wordpiece_matches_bert_tokenizer_on_unicode(wp_dir, text):
    from transformers import BertTokenizer

    ref = _hyp_cache.setdefault("bert", BertTokenizer(
        os.path.join(wp_dir[0], "vocab.txt")))
    ours = _hyp_cache.setdefault("ours", tk.WordPieceTokenizer.from_dir(
        wp_dir[0]))
    assert ours.encode(text) == ref.encode(text)


_hyp_cache = {}


@pytest.fixture(scope="module")
def bpe_dir(tmp_path_factory):
    """A small byte-level BPE trained offline, saved as vocab.json /
    merges.txt."""
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    trainer = trainers.BpeTrainer(
        vocab_size=400, special_tokens=["<|endoftext|>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    corpus = ["what is diabetes? The quick brown fox's jumps",
              "don't we'll they've I'm you'd it's 1234 56789 ...!!",
              "naïve café résumé 中国 the [quick] {brown} fox",
              "represent the question for retrieving documents"] * 8
    tok.train_from_iterator(corpus, trainer)
    d = tmp_path_factory.mktemp("bpe")
    tok.model.save(str(d))
    return str(d)


BPE_TEXTS = ["what is diabetes?", "The quick brown fox's jumps",
             "don't we'll they've I'm you'd it's 1234 56789 ...!!",
             "naïve café résumé 中国", "  two  spaces\n\nnew lines \t tab ",
             "trailing space ", "[SOS] {SOS} <|endoftext|> end", ""]


def test_bpe_matches_gpt2_tokenizer(bpe_dir):
    from transformers import GPT2Tokenizer

    ref = GPT2Tokenizer(os.path.join(bpe_dir, "vocab.json"),
                        os.path.join(bpe_dir, "merges.txt"))
    ours = tk.load_tokenizer(bpe_dir, "gptj")
    ours.specials = ["<|endoftext|>"]
    for t in BPE_TEXTS:
        assert ours.encode(t, add_special_tokens=False) == ref.encode(
            t, add_special_tokens=False), t
        assert ours.encode(t) == ref.encode(t), t
    assert ours.encode(BPE_TEXTS[1], add_special_tokens=False,
                       truncation=True, max_length=4) == ref.encode(
        BPE_TEXTS[1], add_special_tokens=False, truncation=True,
        max_length=4)
    from ragroute_tpu.encoders.custom import specb_tokenize as jspecb
    from ragroute_tpu_torch.encoders.custom import specb_tokenize

    a = specb_tokenize(ours, BPE_TEXTS[:4], pad_to=16)
    b = jspecb(ref, BPE_TEXTS[:4], pad_to=16)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])


@settings(max_examples=150, deadline=None, database=None)
@given(st.text(alphabet=st.characters(
    whitelist_categories=("Lu", "Ll", "Lo", "Mn", "Nd", "No", "Po", "Ps",
                          "Pe", "Pd", "Sm", "Sc", "Zs"),
    whitelist_characters=" \n'"), max_size=24))
def test_bpe_matches_gpt2_tokenizer_on_unicode(bpe_dir, text):
    from transformers import GPT2Tokenizer

    ref = _hyp_cache.setdefault("gpt2", GPT2Tokenizer(
        os.path.join(bpe_dir, "vocab.json"),
        os.path.join(bpe_dir, "merges.txt")))
    ours = _hyp_cache.setdefault("bpe", tk.load_tokenizer(bpe_dir, "gptj"))
    assert ours.encode(text, add_special_tokens=False) == ref.encode(
        text, add_special_tokens=False)


def test_sentencepiece_checkpoint_without_transformers_raises(tmp_path,
                                                              monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(RuntimeError, match="SentencePiece.*item 8"):
        tk.load_tokenizer(str(tmp_path), "xlm-roberta")


# ---- the checkpoint reader and load_encoder ------------------------------------

def _tiny_bert_dir(root, fmt: str, shard: bool = False):
    from transformers import BertConfig, BertModel, BertTokenizer

    torch.manual_seed(5)
    model = BertModel(BertConfig(
        vocab_size=40, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=64, type_vocab_size=2)).eval()
    d = os.path.join(root, f"tiny_bert_{fmt}_{shard}")
    kw = {"safe_serialization": fmt == "safetensors"}
    if shard:
        kw["max_shard_size"] = "20KB"
    model.save_pretrained(d, **kw)
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [
        chr(ord("a") + i) for i in range(26)]
    with open(os.path.join(d, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab))
    BertTokenizer(os.path.join(d, "vocab.txt")).save_pretrained(d)
    return d, model


@pytest.mark.parametrize("fmt,shard", [("safetensors", False), ("bin", False),
                                       ("safetensors", True), ("bin", True)])
def test_reader_gives_from_pretrained_state(tmp_path, fmt, shard):
    from transformers import AutoModel

    d, _ = _tiny_bert_dir(str(tmp_path), fmt, shard)
    names = os.listdir(d)
    assert any(n.endswith(".index.json") for n in names) == shard
    ours = checkpoint.load_state_dict(d)
    want = AutoModel.from_pretrained(d, local_files_only=True).state_dict()
    for key, t in ours.items():
        torch.testing.assert_close(t, want[key], rtol=0, atol=0)
    assert checkpoint.read_config(d)["model_type"] == "bert"


def test_safetensors_round_trip(tmp_path):
    from safetensors.torch import load_file

    tensors = {"a": torch.randn(3, 5), "b": torch.arange(7, dtype=torch.int64),
               "c": torch.randn(2, 3).to(torch.bfloat16),
               "d": torch.zeros(0, 4)}
    path = str(tmp_path / "x.safetensors")
    checkpoint.write_safetensors(path, tensors)
    ref = load_file(path)
    ours = checkpoint.read_safetensors(path)
    for k, t in tensors.items():
        assert torch.equal(ref[k], t) and torch.equal(ours[k], t), k


def test_hub_cache_resolution(tmp_path, monkeypatch):
    cache = tmp_path / "hub"
    snap = cache / "models--org--enc" / "snapshots" / "abc123"
    snap.mkdir(parents=True)
    (cache / "models--org--enc" / "refs").mkdir()
    (cache / "models--org--enc" / "refs" / "main").write_text("abc123")
    monkeypatch.delenv("HF_HUB_CACHE", raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    assert checkpoint.resolve("org/enc") == str(snap)
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "elsewhere"))
    assert checkpoint.resolve("org/enc") == str(snap)
    assert checkpoint.resolve("org/missing") is None
    assert checkpoint.resolve(str(snap)) == str(snap)


def test_instructor_dense_and_t5_file_match_jax_loader(tmp_path):
    from transformers import T5Config, T5EncoderModel

    from ragroute_tpu.encoders.zoo import _find_instructor_dense

    d = tmp_path / "instructor"
    torch.manual_seed(8)
    model = T5EncoderModel(T5Config(
        vocab_size=64, d_model=32, d_kv=8, d_ff=64, num_layers=2,
        num_heads=4, dropout_rate=0.0, feed_forward_proj="gated-gelu",
        is_encoder_decoder=False)).eval()
    model.save_pretrained(str(d))
    assert checkpoint.find_instructor_dense(str(d)) is None
    (d / "2_Dense").mkdir()
    w, b = torch.randn(16, 32), torch.randn(16)
    torch.save({"linear.weight": w, "linear.bias": b},
               str(d / "2_Dense" / "pytorch_model.bin"))
    ours = checkpoint.find_instructor_dense(str(d))
    want = _find_instructor_dense(str(d))
    np.testing.assert_array_equal(ours[0], want[0])
    np.testing.assert_array_equal(ours[1], want[1])
    # a saved T5 keeps its tied table as shared.weight only: still read
    cfg = t5.config_from_hf(checkpoint.read_config(str(d)))
    port = t5.from_state(cfg, t5.params_from_state_dict(
        checkpoint.load_state_dict(str(d)), cfg))
    ids, mask = _inputs(64, pad=0)
    with torch.no_grad():
        want_h = model(input_ids=torch.from_numpy(ids),
                       attention_mask=torch.from_numpy(mask)
                       ).last_hidden_state.numpy()
        got_h = port(torch.from_numpy(ids),
                     torch.from_numpy(mask))["last_hidden"].numpy()
    for r in range(3):
        n = mask[r].sum()
        np.testing.assert_allclose(got_h[r, :n], want_h[r, :n], **TOL)


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_load_encoder_matches_jax_loader_without_transformers(
        tmp_path, monkeypatch, fmt):
    """``load_encoder`` (hub-cache name, the port's reader, WordPiece and
    forward) gives ``_load_jax_bert``'s embeddings at f32, and within
    cosine 0.999 at bf16, with ``transformers`` hidden from the port."""
    import shutil

    import ragroute_tpu.config as jconf
    import ragroute_tpu_torch.config as tconf
    from ragroute_tpu.encoders.registry import EncoderSpec as JSpec
    from ragroute_tpu.encoders.zoo import _load_jax_bert
    from ragroute_tpu_torch.encoders.registry import EncoderSpec
    from ragroute_tpu_torch.encoders.zoo import load_encoder

    d, _ = _tiny_bert_dir(str(tmp_path), fmt)
    texts = ["a b c", "d e f g", "abc xyz"]
    monkeypatch.setattr(jconf, "ENCODER_COMPUTE_DTYPE", "float32")
    want = _load_jax_bert(JSpec("tiny", "bert", d, 32, "mean", True,
                                max_length=16)).encode(texts)
    cache = tmp_path / "hub"
    snap = cache / "models--org--tiny" / "snapshots" / "r1"
    shutil.copytree(d, snap)
    (cache / "models--org--tiny" / "refs").mkdir()
    (cache / "models--org--tiny" / "refs" / "main").write_text("r1")
    monkeypatch.setenv("HF_HUB_CACHE", str(cache))
    monkeypatch.setitem(sys.modules, "transformers", None)
    spec = EncoderSpec("tiny", "bert", "org/tiny", 32, "mean", True,
                       max_length=16)
    got = {}
    for dtype in ("float32", "bfloat16"):
        monkeypatch.setattr(tconf, "ENCODER_COMPUTE_DTYPE", dtype)
        enc = load_encoder(spec, device="cpu")
        assert enc.backend == "torch:cpu"
        got[dtype] = enc.encode(texts)
    np.testing.assert_allclose(got["float32"], want, **TOL)
    assert enc.model.layers[0].q.weight.dtype == torch.bfloat16
    assert got["bfloat16"].dtype == np.float32
    assert ((got["bfloat16"] * want).sum(-1) > 0.999).all()
