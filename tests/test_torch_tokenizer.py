"""The port's tokenizer (models/tokenizer.py) against ``tokenizers`` and
``transformers`` — present here as the yardstick only: the JAX package's
``load_tokenizer`` is ``PreTrainedTokenizerFast`` on a file and
``AutoTokenizer`` on a directory with ``tokenizer_config.json``.

The ``tokenizer.json`` files are built in the test, nothing is
downloaded: the JAX tests' WordLevel + Whitespace file, a byte-level BPE
trained in process on Llama-3's shape (the Split pattern, ByteLevel,
``ignore_merges``, a TemplateProcessing BOS), a GPT-2-style
``ByteLevel(use_regex=True)`` BPE, and ``chip_smoke.py``'s
Llama-3-shaped writer. Ids and decoded text must be equal, exactly.
"""

import functools
import json
import os
import unicodedata

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tpu_docker_api.models import import_weights as jiw
from tpu_docker_api_torch.models import import_weights as tiw
from tpu_docker_api_torch.models import tokenizer as ttok

CORPUS = [
    "Hello world! It's a test of the tokenizer, isn't it? I'M sure we'll "
    "see. They'VE gone; you'RE here; she'D know.",
    "Numbers: 1234567 and 3.14159; dates 2024-01-02.\n\nNew paragraph   "
    "with   spaces.\r\n",
    "Café naïve résumé — déjà vu. 東京タワー 🚀🔥 emoji, 한국어 텍스트.",
    "def f(x):\n    return x**2  # comment\n\t\ttabs\n",
] * 20

STRINGS = [
    "hello tpu world",
    "it's 'S 'ſ 'Re I've they'll WE'D",
    "12345678901 and 3.14159",
    "a\n\nb\n \n c\r\n\r\nd",
    "   leading and trailing   ",
    "Café naïve résumé — déjà vu à São Paulo",
    "東京タワー 🚀🔥 emoji 한국어",
    "x<|end_of_text|>y <|begin_of_text|>z",
    " ",
    "\xa0nbsp em　ideo sep",
    "ǅungla Ⅻ ½ ⓐ ‍",
]


def _write_wordlevel(path):
    """tests/test_import_weights.py's tokenizer: WordLevel + Whitespace."""
    from tokenizers import Tokenizer as RustTokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace

    words = ["<unk>", "hello", "world", "tpu", "serving", "it", "'", "s",
             "12345678901", "and", "3", ".", "14159"]
    tok = RustTokenizer(WordLevel({w: i for i, w in enumerate(words)},
                                  unk_token="<unk>"))
    tok.pre_tokenizer = Whitespace()
    tok.save(path)
    return path


def _train_bpe(path, pre, post, ignore_merges, vocab_size=600):
    from tokenizers import Tokenizer as RustTokenizer
    from tokenizers import decoders, models, pre_tokenizers, trainers

    tok = RustTokenizer(models.BPE(ignore_merges=ignore_merges))
    tok.pre_tokenizer = pre
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(CORPUS, trainers.BpeTrainer(
        vocab_size=vocab_size, show_progress=False,
        special_tokens=["<|begin_of_text|>", "<|end_of_text|>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    if post is not None:
        tok.post_processor = post
    tok.save(path)
    return path


def write_llama3_style(path, vocab_size=600):
    from tokenizers import Regex, pre_tokenizers, processors

    return _train_bpe(path, pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(ttok.LLAMA3_PATTERN), "isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)]),
        processors.TemplateProcessing(
            single="<|begin_of_text|> $A",
            special_tokens=[("<|begin_of_text|>", 0)]),
        ignore_merges=True, vocab_size=vocab_size)


def _write_gpt2_style(path):
    from tokenizers import pre_tokenizers, processors

    return _train_bpe(path, pre_tokenizers.ByteLevel(add_prefix_space=True,
                                                     use_regex=True),
                      processors.ByteLevel(trim_offsets=False),
                      ignore_merges=False)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("tok")
    return {"wordlevel": _write_wordlevel(str(root / "wordlevel.json")),
            "llama3": write_llama3_style(str(root / "llama3.json")),
            "gpt2": _write_gpt2_style(str(root / "gpt2.json"))}


@functools.lru_cache(maxsize=None)
def _pair(path):
    from transformers import PreTrainedTokenizerFast

    return (PreTrainedTokenizerFast(tokenizer_file=path),
            ttok.load_tokenizer(path))


def _assert_same(hf, mine, text):
    ids = hf.encode(text)
    assert mine.encode(text) == ids, text
    assert mine.decode(ids) == hf.decode(ids, skip_special_tokens=True)


@pytest.mark.parametrize("kind", ["wordlevel", "llama3", "gpt2"])
@pytest.mark.parametrize("text", STRINGS)
def test_ids_and_text_equal_hf(files, kind, text):
    _assert_same(*_pair(files[kind]), text)


@pytest.mark.parametrize("kind", ["llama3", "gpt2"])
def test_byte_level_round_trip_is_lossless(files, kind):
    _, mine = _pair(files[kind])
    for text in STRINGS + CORPUS[:4]:
        ids = mine.encode(text)
        assert mine.decode(ids) == text.replace("<|end_of_text|>", "") \
            .replace("<|begin_of_text|>", "")


def test_jax_wordlevel_case(tmp_path):
    """tests/test_import_weights.py's TestTokenizer, on the port."""
    path = _write_wordlevel(str(tmp_path / "tokenizer.json"))
    for tok in (ttok.load_tokenizer(path), ttok.load_tokenizer(tmp_path)):
        ids = tok.encode("hello tpu world")
        assert ids == jiw.load_tokenizer(path).encode("hello tpu world")
        assert ids == [1, 3, 2] and tok.decode(ids) == "hello tpu world"


def test_llama3_style_file_has_the_parts_it_should(files):
    spec = json.load(open(files["llama3"]))
    assert spec["model"]["ignore_merges"] is True
    assert spec["pre_tokenizer"]["type"] == "Sequence"
    _, mine = _pair(files["llama3"])
    ids = mine.encode("hello")
    assert ids[0] == 0  # the template's <|begin_of_text|>
    # ignore_merges: a pre-token that is in the vocab comes out whole
    word = next(w for w in spec["model"]["vocab"] if len(w) > 4
                and w.isalpha())
    assert mine._tok.model.tokenize(word) == [spec["model"]["vocab"][word]]


def test_decode_skips_ids_outside_the_vocab(files):
    hf, mine = _pair(files["llama3"])
    ids = [282, 99999, 279, 1, 0, -1 % 2**31]
    assert mine.decode(ids) == hf.decode(ids, skip_special_tokens=True)
    assert mine.decode([99999]) == ""


def test_decode_every_id_equals_hf(files):
    for kind in ("llama3", "gpt2", "wordlevel"):
        hf, mine = _pair(files[kind])
        ids = list(range(len(hf) + 3))
        assert mine.decode(ids) == hf.decode(ids, skip_special_tokens=True)


@settings(max_examples=150, deadline=None)
@given(text=st.text(alphabet=st.characters(
    blacklist_categories=("Cs", "Cn")), max_size=40))
def test_random_unicode_equals_hf(files, text):
    """Unassigned code points are left out: Python's unicodedata and the
    regex engine of ``tokenizers`` may know different Unicode versions,
    and a character one of them does not know has no category there."""
    hf, mine = _pair(files["llama3"])
    _assert_same(hf, mine, text)
    # decoding skips special tokens (HF's skip_special_tokens=True), so a
    # drawn text holding one round-trips without it, as above
    assert mine.decode(mine.encode(text)) == text.replace(
        "<|end_of_text|>", "").replace("<|begin_of_text|>", "")


def test_split_scanner_equals_the_regex(files):
    from tokenizers import Regex, pre_tokenizers

    for pattern in (ttok.LLAMA3_PATTERN, ttok.GPT2_PATTERN):
        split = pre_tokenizers.Split(Regex(pattern), "isolated")
        for text in STRINGS + CORPUS[:4]:
            assert ttok.split_isolated(pattern, text) == [
                p for p, _ in split.pre_tokenize_str(text)]


# ------------------------------------------------- eos, bos, directories


def test_bare_file_has_no_eos_or_bos(files):
    hf, mine = _pair(files["llama3"])
    assert hf.eos_token_id is None and hf.bos_token_id is None
    assert mine.eos_id is None and mine.bos_id is None


@pytest.mark.parametrize("clean_up", [False, True])
def test_directory_with_config_matches_autotokenizer(files, tmp_path,
                                                     clean_up):
    from transformers import AutoTokenizer, PreTrainedTokenizerFast

    PreTrainedTokenizerFast(
        tokenizer_file=files["llama3"], bos_token="<|begin_of_text|>",
        eos_token="<|end_of_text|>",
        clean_up_tokenization_spaces=clean_up).save_pretrained(tmp_path)
    hf = AutoTokenizer.from_pretrained(str(tmp_path), local_files_only=True)
    mine = ttok.load_tokenizer(str(tmp_path))
    assert (mine.eos_id, mine.bos_id) == (hf.eos_token_id,
                                         hf.bos_token_id) == (1, 0)
    for text in STRINGS + ["Hello , world . It 's here !"]:
        _assert_same(hf, mine, text)
    want = jiw.load_tokenizer(str(tmp_path))
    assert (want.eos_id, want.bos_id) == (mine.eos_id, mine.bos_id)


def test_directory_without_config_reads_the_file(files, tmp_path):
    os.symlink(files["gpt2"], tmp_path / "tokenizer.json")
    mine = ttok.load_tokenizer(str(tmp_path))
    hf = jiw.load_tokenizer(str(tmp_path))
    assert mine.eos_id is None
    _assert_same(hf._tok, mine, "x<|end_of_text|>y it's")


def test_unknown_tokenizer_class_is_refused_by_name(files, tmp_path):
    os.symlink(files["llama3"], tmp_path / "tokenizer.json")
    (tmp_path / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "LlamaTokenizerFast", "eos_token": "</s>"}))
    with pytest.raises(ValueError, match="LlamaTokenizerFast"):
        ttok.load_tokenizer(str(tmp_path))


def test_eos_token_missing_from_the_file_is_refused(files, tmp_path):
    os.symlink(files["llama3"], tmp_path / "tokenizer.json")
    (tmp_path / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "PreTrainedTokenizerFast", "eos_token": "</s>"}))
    with pytest.raises(ValueError, match="</s>"):
        ttok.load_tokenizer(str(tmp_path))


@pytest.mark.parametrize("where,spec", [
    ("normalizer", {"type": "NFC"}),
    ("decoder", {"type": "WordPiece", "prefix": "##", "cleanup": True}),
    ("pre_tokenizer", {"type": "Metaspace", "replacement": "▁"}),
    ("post_processor", {"type": "RobertaProcessing"}),
])
def test_unread_components_are_refused_by_type(files, tmp_path, where, spec):
    data = json.load(open(files["llama3"]))
    data[where] = spec
    path = tmp_path / "tokenizer.json"
    path.write_text(json.dumps(data))
    with pytest.raises(ValueError, match=spec["type"]):
        ttok.load_tokenizer(str(path))


def test_importable_from_import_weights():
    assert tiw.load_tokenizer is ttok.load_tokenizer
    assert tiw.Tokenizer is ttok.Tokenizer


# ------------------------------------------- chip_smoke's Llama-3 shape


def test_chip_smoke_writer_small_equals_hf(tmp_path):
    import chip_smoke

    path = chip_smoke.write_llama3_shaped_tokenizer(
        str(tmp_path / "tokenizer.json"), vocab_size=3000, n_special=8)
    hf, mine = _pair(path)
    assert len(hf) == 3000
    for text in STRINGS + CORPUS[:4]:
        _assert_same(hf, mine, text)
    assert mine.encode("a")[0] == 3000 - 8  # <|begin_of_text|>


def test_chip_smoke_writer_full_size(tmp_path):
    """The card's file: 128,256 ids, BOS 128000 and EOS 128001, every id
    decodes as ``transformers`` decodes it."""
    import chip_smoke

    path = chip_smoke.write_llama3_shaped_tokenizer(
        str(tmp_path / "tokenizer.json"))
    hf, mine = _pair(path)
    assert len(hf) == chip_smoke.LLAMA3_VOCAB == 128256
    spec = json.load(open(path))
    assert len(spec["model"]["vocab"]) == 128000
    assert [t["id"] for t in spec["added_tokens"][:2]] == [128000, 128001]
    text = "東京タワー 🚀 and 0123456789\n\nCrème brûlée"
    ids = mine.encode(text)
    assert ids == hf.encode(text) and ids[0] == 128000
    assert mine.decode(ids[1:]) == text
    every = list(range(128256))
    assert mine.decode(every) == hf.decode(every, skip_special_tokens=True)


def test_whitespace_class_matches_rust_word_class():
    assert all(ttok._is_word(c) for c in "aZ9_éⅫⓐ‍́")
    assert not any(ttok._is_word(c) for c in " ½-!🚀")
    assert unicodedata.category("½") == "No"
