"""The port's tokenizer (a copy of the JAX package's) against
``chatglm_q_tpu.tokenizer``: the same ids and the same decoded text on the
unigram and BPE models tests/test_tokenizer.py builds, with [gMASK]/<sop>,
text pairs, byte fallback and a normalization charsmap; batch encoding with
``return_tensors="pt"`` equals the numpy batch."""
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chatglm_q_tpu.tokenizer import ChatGLM2Tokenizer as JTok  # noqa: E402
from chatglm_q_tpu.tokenizer.sp_core import SpTokenizer as JSp  # noqa: E402
from chatglm_q_tpu_torch.tokenizer import ChatGLM2Tokenizer as TTok  # noqa: E402
from chatglm_q_tpu_torch.tokenizer.build import build_bpe_model, build_unigram_model  # noqa: E402
from chatglm_q_tpu_torch.tokenizer.sp_core import WS, SpTokenizer as TSp  # noqa: E402

TEXTS = ["hello world", "hello hell world", "world  world", "hello é", "中文 hello",
         "ＡＢＣ hello", "", "  ", "hello\nworld", "€ é 日本"]


def _unigram():
    vocab = {WS + "hello": -1.0, WS + "world": -1.5, WS + "hell": -3.0, "o": -4.0,
             "l": -4.5, "he": -5.0, WS: -6.0, "h": -7.0, "e": -7.0, "w": -7.0, "r": -7.0,
             "d": -7.0, "中": -8.0, "文": -8.0}
    return build_unigram_model(vocab, charsmap={"ＡＢＣ": "ABC"})


def _bpe():
    return build_bpe_model([WS + "hel", WS + "hell", WS + "hello", "lo", "ll", "wo", "wor"],
                           alphabet=list("helowrdABC") + [WS])


@pytest.fixture(scope="module", params=["unigram", "bpe"])
def model_bytes(request):
    return _unigram() if request.param == "unigram" else _bpe()


def test_builders_are_the_jax_packages():
    from chatglm_q_tpu.tokenizer import build as JB

    assert _unigram() == JB.build_unigram_model(
        {WS + "hello": -1.0, WS + "world": -1.5, WS + "hell": -3.0, "o": -4.0, "l": -4.5,
         "he": -5.0, WS: -6.0, "h": -7.0, "e": -7.0, "w": -7.0, "r": -7.0, "d": -7.0,
         "中": -8.0, "文": -8.0}, charsmap={"ＡＢＣ": "ABC"})
    assert _bpe() == JB.build_bpe_model(
        [WS + "hel", WS + "hell", WS + "hello", "lo", "ll", "wo", "wor"],
        alphabet=list("helowrdABC") + [WS])


def test_ids_and_text_equal_jax(model_bytes, tmp_path):
    path = tmp_path / "sentencepiece.model"
    path.write_bytes(model_bytes)
    j, t = JTok(path), TTok(path)
    assert (len(t), t.true_vocab_size, t.bos_id, t.eos_id, t.pad_id) == \
        (len(j), j.true_vocab_size, j.bos_id, j.eos_id, j.pad_id)
    for name in ("[MASK]", "[gMASK]", "[sMASK]", "<sop>", "<eop>", "</s>", "<0xC3>"):
        assert t[name] == j[name], name
    rng = random.Random(0)
    words = ["hello", "world", "hell", "é", "中文", "ＡＢＣ", "xyz", "€"]
    texts = TEXTS + [" ".join(rng.choice(words) for _ in range(rng.randint(1, 8)))
                     for _ in range(40)]
    for text in texts:
        ids = t.encode(text)
        assert ids == j.encode(text), repr(text)
        assert ids[:2] == [t["[gMASK]"], t["<sop>"]]
        assert t.decode(ids) == j.decode(ids), repr(text)
        assert t.encode(text, "world") == j.encode(text, "world")
        assert t.encode(text, add_special_tokens=False) == j.encode(text, add_special_tokens=False)
    # byte fallback: é is not a piece, so it goes as its UTF-8 bytes
    ids = t.encode("hello é", add_special_tokens=False)
    assert t["<0xC3>"] in ids and t["<0xA9>"] in ids
    assert t.decode(ids) == "hello é"
    # every id decodes as in JAX (specials dropped)
    all_ids = list(range(len(t)))
    assert t.decode(all_ids) == j.decode(all_ids)


def test_python_core_equals_jax(model_bytes):
    """The pure-Python core (the path without the native library)."""
    t, j = TSp(model_bytes, use_native=False), JSp(model_bytes, use_native=False)
    for text in TEXTS:
        assert t.encode(text) == j.encode(text), repr(text)


def test_batch_encoding_pt_equals_np(model_bytes, tmp_path):
    path = tmp_path / "sentencepiece.model"
    path.write_bytes(model_bytes)
    t, j = TTok(path), JTok(path)
    texts = ["hello", "hello world hello", "中文"]
    for padding in (True, "right"):
        got = t(texts, padding=padding, return_tensors="pt", return_labels=True)
        want = j(texts, padding=padding, return_tensors="np", return_labels=True)
        assert set(got) == set(want)
        for k in want:
            assert isinstance(got[k], torch.Tensor)
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    assert t(texts) == j(texts)  # lists, no padding
