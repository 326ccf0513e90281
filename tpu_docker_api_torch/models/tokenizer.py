"""Text ↔ token ids from a Hugging Face ``tokenizer.json``, read by the
port itself (counterpart of ``Tokenizer`` and ``load_tokenizer`` in
``tpu_docker_api/models/import_weights.py``, which wrap ``transformers``).

The port's hosts have neither ``tokenizers`` nor ``transformers`` nor
``regex``, so this module implements the parts of the format that
Llama-3's file and the repository's tests use, with the semantics of
``tokenizers`` 0.22 as ``PreTrainedTokenizerFast`` drives it:

- **added tokens** are split out of the text first (leftmost-longest
  match; tokens with ``normalized: false`` in a first pass, the others in
  a second), and encode to their own ids;
- **pre-tokenizers**: ``Sequence``, ``Split`` (``Isolated``) with
  Llama-3's pattern, ``ByteLevel`` (``add_prefix_space``, ``use_regex``
  with GPT-2's pattern) and ``Whitespace``. The patterns use ``\\p{L}`` and
  ``\\p{N}``, which the stdlib ``re`` lacks: each is a hand-written
  scanner over ``unicodedata.category`` that tries the pattern's
  alternatives in order at each position, as a backtracking engine does;
- **models**: ``BPE`` (string or pair merges, ``ignore_merges``, no unk
  token; the merge loop takes the lowest-ranked pair, leftmost on ties,
  exactly as ``tokenizers`` does) with a per-word cache, and
  ``WordLevel`` with its unk token;
- **normalizer** ``null``; **post-processors** ``TemplateProcessing``
  (single sequences: how Llama-3 prepends ``<|begin_of_text|>``),
  ``ByteLevel``, ``Sequence`` and ``null``; **decoders** ``ByteLevel``
  (UTF-8 with replacement) and ``null`` (tokens joined by spaces).

Any other component is refused by its JSON ``type`` name. ``decode``
drops special tokens and skips ids outside the vocabulary, as
``decode(ids, skip_special_tokens=True)`` does.
"""

from __future__ import annotations

import dataclasses
import functools
import heapq
import json
import os
import re
import unicodedata

# ------------------------------------------------------ character classes

_SPACE_CONTROLS = frozenset("\t\n\x0b\x0c\r\x85")


def _is_space(c: str) -> bool:
    """``\\s`` of the regex engine ``tokenizers`` uses (Oniguruma, Unicode):
    tab to carriage return, NEL, and the Zs, Zl and Zp categories."""
    return c in _SPACE_CONTROLS or unicodedata.category(c) in ("Zs", "Zl",
                                                                 "Zp")


def _is_letter(c: str) -> bool:
    return unicodedata.category(c)[0] == "L"


def _is_number(c: str) -> bool:
    return unicodedata.category(c)[0] == "N"


def _is_other(c: str) -> bool:
    """``[^\\s\\p{L}\\p{N}]``."""
    return not (_is_space(c) or _is_letter(c) or _is_number(c))


#: the symbols (So) with the Alphabetic property: circled, parenthesized
#: and squared Latin letters
_ALPHABETIC_SYMBOLS = ((0x24B6, 0x24E9), (0x1F130, 0x1F149),
                       (0x1F150, 0x1F169), (0x1F170, 0x1F189))


def _is_word(c: str) -> bool:
    """``\\w`` of the ``Whitespace`` pre-tokenizer (Rust's ``regex``,
    UTS #18): Alphabetic (the letters, Nl and a few symbols), marks,
    decimal digits, connector punctuation and the two joiners."""
    cat = unicodedata.category(c)
    if cat[0] in "LM" or cat in ("Nd", "Nl", "Pc") or c in "\u200c\u200d":
        return True
    o = ord(c)
    return cat == "So" and any(a <= o <= b for a, b in _ALPHABETIC_SYMBOLS)


# ---------------------------------------------------------- the scanners
# Each alternative takes (text, start) and returns the end of its match
# at ``start``, or None.


def _run(text: str, p: int, pred) -> int:
    while p < len(text) and pred(text[p]):
        p += 1
    return p


def _contraction(ignore_case: bool):
    """``'s|'t|'re|'ve|'m|'ll|'d``, optionally ``(?i:...)``: under
    Unicode case folding ``ſ`` matches ``s`` too."""
    suffixes = ("s", "t", "re", "ve", "m", "ll", "d")

    def alt(text, p):
        if text[p] != "'":
            return None
        for suf in suffixes:
            part = text[p + 1:p + 1 + len(suf)]
            if len(part) == len(suf) and all(
                    a == b or (ignore_case and a.casefold() == b)
                    for a, b in zip(part, suf)):
                return p + 1 + len(suf)
        return None

    return alt


def _opt_then_run(opt, pred):
    """``X?P+``: one optional character of class ``opt`` (tried first),
    then one or more of class ``pred``."""
    def alt(text, p):
        if opt(text[p]) and p + 1 < len(text) and pred(text[p + 1]):
            return _run(text, p + 1, pred)
        if pred(text[p]):
            return _run(text, p, pred)
        return None

    return alt


def _numbers_up_to(k: int):
    """``\\p{N}{1,k}``."""
    def alt(text, p):
        e = p
        while e < len(text) and e - p < k and _is_number(text[e]):
            e += 1
        return e if e > p else None

    return alt


def _other_then_newlines(text, p):
    """`` ?[^\\s\\p{L}\\p{N}]+[\\r\\n]*``."""
    e = _opt_then_run(lambda c: c == " ", _is_other)(text, p)
    return None if e is None else _run(text, e, lambda c: c in "\r\n")


def _space_then_newlines(text, p):
    """``\\s*[\\r\\n]+``: the greedy ``\\s*`` gives back characters until
    the match ends on the last CR or LF of the whitespace run."""
    q = _run(text, p, _is_space)
    for r in range(q - 1, p - 1, -1):
        if text[r] in "\r\n":
            return r + 1
    return None


def _space_not_before_text(text, p):
    """``\\s+(?!\\S)``: a whitespace run to the end of the text, or all of
    a run of two or more but its last character."""
    q = _run(text, p, _is_space)
    if q == p:
        return None
    if q == len(text):
        return q
    return q - 1 if q - p >= 2 else None


def _space_run(text, p):
    """``\\s+``."""
    q = _run(text, p, _is_space)
    return q if q > p else None


def _not_newline_letter_number(c):
    return c not in "\r\n" and not _is_letter(c) and not _is_number(c)


#: the patterns the port reads, each as its list of alternatives
LLAMA3_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|"
                  r"\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|"
                  r"\s+(?!\S)|\s+")
GPT2_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+"
                r"|\s+(?!\S)|\s+")
WHITESPACE_PATTERN = r"\w+|[^\w\s]+"
_SCANNERS = {
    LLAMA3_PATTERN: (
        _contraction(ignore_case=True),
        _opt_then_run(_not_newline_letter_number, _is_letter),
        _numbers_up_to(3),
        _other_then_newlines,
        _space_then_newlines,
        _space_not_before_text,
        _space_run),
    GPT2_PATTERN: (
        _contraction(ignore_case=False),
        _opt_then_run(lambda c: c == " ", _is_letter),
        _opt_then_run(lambda c: c == " ", _is_number),
        _opt_then_run(lambda c: c == " ", _is_other),
        _space_not_before_text,
        _space_run),
    WHITESPACE_PATTERN: (
        lambda text, p: _run(text, p, _is_word) if _is_word(text[p])
        else None,
        lambda text, p: (_run(text, p, lambda c: not (_is_word(c)
                                                      or _is_space(c)))
                         if not (_is_word(text[p]) or _is_space(text[p]))
                         else None)),
}


def find_matches(pattern: str, text: str) -> list[tuple[int, int]]:
    """Non-overlapping leftmost matches of one of the patterns above: at
    each position the first alternative that matches wins; a position no
    alternative matches is skipped."""
    alts = _SCANNERS[pattern]
    out, p = [], 0
    while p < len(text):
        for alt in alts:
            e = alt(text, p)
            if e is not None:
                out.append((p, e))
                p = e
                break
        else:
            p += 1
    return out


def split_isolated(pattern: str, text: str) -> list[str]:
    """``Split(pattern, behavior="isolated")``: every match a piece of its
    own, and the text between matches kept as pieces too."""
    pieces, last = [], 0
    for s, e in find_matches(pattern, text):
        if s > last:
            pieces.append(text[last:s])
        pieces.append(text[s:e])
        last = e
    if last < len(text):
        pieces.append(text[last:])
    return pieces


# ------------------------------------------------------------ byte level


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's map of the 256 bytes to printable characters: the printable
    Latin-1 bytes map to themselves, the rest to U+0100 upward."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = list(bs)
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


@functools.lru_cache(maxsize=1)
def _unicode_to_bytes() -> dict[str, int]:
    return {c: b for b, c in bytes_to_unicode().items()}


def _byte_level(piece: str) -> str:
    table = bytes_to_unicode()
    return "".join(table[b] for b in piece.encode("utf-8"))


def _byte_level_decode(tokens: list[str]) -> str:
    """Each token's characters back to bytes (a token with a character
    outside the map contributes its own UTF-8 bytes), then the whole byte
    string decoded as UTF-8 with U+FFFD for invalid sequences."""
    table = _unicode_to_bytes()
    out = bytearray()
    for t in tokens:
        bs = [table.get(c) for c in t]
        out += t.encode("utf-8") if None in bs else bytes(bs)
    return out.decode("utf-8", errors="replace")


# ------------------------------------------------------------ components


def _refuse(where: str, spec) -> ValueError:
    kind = spec.get("type") if isinstance(spec, dict) else spec
    return ValueError(f"tokenizer.json {where} {kind!r} is not read by the "
                      f"port's tokenizer (models/tokenizer.py)")


def _pre_tokenizer(spec):
    """A function from a piece of text to its list of words."""
    if spec is None:
        return lambda text: [text]
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [_pre_tokenizer(s) for s in spec["pretokenizers"]]

        def seq(text):
            pieces = [text]
            for step in steps:
                pieces = [w for p in pieces for w in step(p)]
            return pieces

        return seq
    if kind == "Split":
        pattern = spec.get("pattern", {})
        if (spec.get("behavior") != "Isolated" or spec.get("invert")
                or pattern.get("Regex") not in _SCANNERS):
            raise ValueError(
                f"tokenizer.json Split {pattern} (behavior "
                f"{spec.get('behavior')}, invert {spec.get('invert')}) is "
                f"not read by the port's tokenizer: it reads the Isolated "
                f"split on Llama-3's and GPT-2's patterns")
        regex = pattern["Regex"]
        return lambda text: split_isolated(regex, text)
    if kind == "ByteLevel":
        prefix = spec.get("add_prefix_space", True)
        use_regex = spec.get("use_regex", True)

        def byte_level(text):
            if prefix and not text.startswith(" "):
                text = " " + text
            parts = (split_isolated(GPT2_PATTERN, text) if use_regex
                     else [text])
            return [_byte_level(p) for p in parts]

        return byte_level
    if kind == "Whitespace":
        return lambda text: [text[s:e] for s, e in
                             find_matches(WHITESPACE_PATTERN, text)]
    raise _refuse("pre_tokenizer", spec)


class _BPE:
    """Byte-pair encoding with ``tokenizers``' merge order: the pair of
    lowest merge rank first, the leftmost on ties, one merge at a time."""

    def __init__(self, spec: dict):
        for key in ("continuing_subword_prefix", "end_of_word_suffix",
                    "byte_fallback", "dropout", "unk_token"):
            if spec.get(key):
                raise ValueError(f"tokenizer.json BPE with {key}="
                                 f"{spec[key]!r} is not read by the port's "
                                 f"tokenizer")
        self.vocab: dict[str, int] = spec["vocab"]
        self.ignore_merges = bool(spec.get("ignore_merges", False))
        self.ranks: dict[tuple[int, int], tuple[int, int]] = {}
        vocab = self.vocab
        for rank, m in enumerate(spec.get("merges", [])):
            a, b = m.split(" ") if isinstance(m, str) else m
            self.ranks[vocab[a], vocab[b]] = (rank, vocab[a + b])
        self._cache: dict[str, list[int]] = {}

    def tokenize(self, word: str) -> list[int]:
        if not word:
            return []
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        hit = self._cache.get(word)
        if hit is None:
            hit = self._merge(word)
            if len(self._cache) < 100_000:
                self._cache[word] = hit
        return list(hit)

    def _merge(self, word: str) -> list[int]:
        # a character outside the vocab is dropped, as without an unk token
        ids = [self.vocab[ch] for ch in word if ch in self.vocab]
        n = len(ids)
        nxt = list(range(1, n)) + [-1]
        prv = list(range(-1, n - 1))
        alive = [True] * n
        ranks = self.ranks
        heap = []
        for i in range(n - 1):
            m = ranks.get((ids[i], ids[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            _, i, new = heapq.heappop(heap)
            if not alive[i] or nxt[i] == -1:
                continue
            j = nxt[i]
            m = ranks.get((ids[i], ids[j]))
            if m is None or m[1] != new:
                continue  # an expired entry
            ids[i] = new
            alive[j] = False
            k = nxt[j]
            nxt[i] = k
            if k != -1:
                prv[k] = i
            if prv[i] != -1:
                m = ranks.get((ids[prv[i]], new))
                if m is not None:
                    heapq.heappush(heap, (m[0], prv[i], m[1]))
            if k != -1:
                m = ranks.get((new, ids[k]))
                if m is not None:
                    heapq.heappush(heap, (m[0], i, m[1]))
        return [t for t, a in zip(ids, alive) if a]


class _WordLevel:
    def __init__(self, spec: dict):
        self.vocab: dict[str, int] = spec["vocab"]
        self.unk = spec.get("unk_token")

    def tokenize(self, word: str) -> list[int]:
        i = self.vocab.get(word)
        if i is None:
            if self.unk not in self.vocab:
                raise ValueError(f"WordLevel: {word!r} is not in the vocab "
                                 f"and the unk token {self.unk!r} is "
                                 f"missing")
            i = self.vocab[self.unk]
        return [i]


_MODELS = {"BPE": _BPE, "WordLevel": _WordLevel}


def _post_processor(spec):
    """A function adding the single-sequence template's special tokens."""
    if spec is None or spec.get("type") == "ByteLevel":
        return lambda ids: ids
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [_post_processor(s) for s in spec["processors"]]

        def seq(ids):
            for step in steps:
                ids = step(ids)
            return ids

        return seq
    if kind == "TemplateProcessing":
        specials = spec.get("special_tokens", {})
        template = []
        for piece in spec["single"]:
            if "SpecialToken" in piece:
                template.append(list(
                    specials[piece["SpecialToken"]["id"]]["ids"]))
            elif "Sequence" in piece:
                template.append(None)
            else:
                raise _refuse("TemplateProcessing piece", str(piece))

        def apply(ids):
            out = []
            for part in template:
                out.extend(ids if part is None else part)
            return out

        return apply
    raise _refuse("post_processor", spec)


def _decoder(spec):
    if spec is None:
        return " ".join
    if spec.get("type") == "ByteLevel":
        return _byte_level_decode
    raise _refuse("decoder", spec)


class TokenizerFile:
    """One ``tokenizer.json``, applied as ``tokenizers`` applies it."""

    def __init__(self, path: str | os.PathLike,
                 add_prefix_space: bool | None = None):
        self.path = os.fspath(path)
        with open(self.path, encoding="utf-8") as f:
            spec = json.load(f)
        pre = spec.get("pre_tokenizer")
        if (add_prefix_space is not None and isinstance(pre, dict)
                and "add_prefix_space" in pre):
            # what PreTrainedTokenizerFast does to a top-level pre-tokenizer
            # with this flag: its own add_prefix_space (default False)
            # replaces the file's
            spec["pre_tokenizer"] = {**pre,
                                     "add_prefix_space": add_prefix_space}
        if spec.get("normalizer") is not None:
            raise _refuse("normalizer", spec["normalizer"])
        model = spec["model"]
        kind = model.get("type") or ("BPE" if "merges" in model
                                     else "WordLevel")
        if kind not in _MODELS:
            raise _refuse("model", model)
        self.model = _MODELS[kind](model)
        self.pre_tokenize = _pre_tokenizer(spec.get("pre_tokenizer"))
        self.post_process = _post_processor(spec.get("post_processor"))
        self.decode_tokens = _decoder(spec.get("decoder"))
        added = spec.get("added_tokens") or []
        for t in added:
            if t.get("single_word") or t.get("lstrip") or t.get("rstrip"):
                raise ValueError(f"{self.path}: added token "
                                 f"{t['content']!r} with single_word, lstrip "
                                 f"or rstrip is not read by the port's "
                                 f"tokenizer")
        self.added = {t["content"]: t["id"] for t in added}
        self.special = {t["content"] for t in added if t.get("special")}
        self._id_to_added = {t["id"]: t["content"] for t in added}
        self._id_to_model = {i: s for s, i in self.model.vocab.items()}
        # tokens of ``normalized: false`` split first, then the others;
        # longest first, so the leftmost match is also the longest
        self._splitters = [self._splitter([t["content"] for t in added
                                           if bool(t.get("normalized")) == n])
                           for n in (False, True)]

    @staticmethod
    def _splitter(tokens: list[str]):
        if not tokens:
            return None
        return re.compile("|".join(re.escape(t) for t in sorted(
            tokens, key=len, reverse=True)))

    def _segments(self, text: str) -> list[tuple[str, int | None]]:
        """(text, None) for text between added tokens, (token, id) for
        each added token, in order; empty segments dropped."""
        segs: list[tuple[str, int | None]] = [(text, None)]
        for splitter in self._splitters:
            if splitter is None:
                continue
            out = []
            for seg, tid in segs:
                if tid is not None:
                    out.append((seg, tid))
                    continue
                last = 0
                for m in splitter.finditer(seg):
                    if m.start() > last:
                        out.append((seg[last:m.start()], None))
                    out.append((m.group(), self.added[m.group()]))
                    last = m.end()
                if last < len(seg):
                    out.append((seg[last:], None))
            segs = out
        return [(s, t) for s, t in segs if s]

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        ids: list[int] = []
        for seg, tid in self._segments(text):
            if tid is not None:
                ids.append(tid)
                continue
            for word in self.pre_tokenize(seg):
                ids.extend(self.model.tokenize(word))
        return self.post_process(ids) if add_special_tokens else ids

    def id_to_token(self, i: int) -> str | None:
        tok = self._id_to_added.get(i)
        return tok if tok is not None else self._id_to_model.get(i)

    def token_to_id(self, token: str) -> int | None:
        i = self.added.get(token)
        return i if i is not None else self.model.vocab.get(token)

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        tokens = []
        for i in ids:
            tok = self.id_to_token(int(i))
            if tok is None or (skip_special_tokens and tok in self.special):
                continue
            tokens.append(tok)
        return self.decode_tokens(tokens)


def clean_up_tokenization(text: str) -> str:
    """``transformers``' ``clean_up_tokenization``: no space before
    punctuation and English contractions."""
    for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","),
                 (" ' ", "'"), (" n't", "n't"), (" 'm", "'m"),
                 (" 's", "'s"), (" 've", "'ve"), (" 're", "'re")):
        text = text.replace(a, b)
    return text


@dataclasses.dataclass
class Tokenizer:
    """Text ↔ ids for the server's ``{"text": ...}`` bodies: ``encode``
    adds the file's special tokens (its TemplateProcessing), ``decode``
    drops special tokens and ids outside the vocabulary. ``eos_id`` and
    ``bos_id`` come from ``tokenizer_config.json`` and are None for a
    bare ``tokenizer.json``, as in the JAX package's tokenizer."""

    _tok: TokenizerFile
    eos_token: str | None = None
    bos_token: str | None = None
    clean_up_tokenization_spaces: bool = False

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text)

    def decode(self, ids) -> str:
        text = self._tok.decode(ids, skip_special_tokens=True)
        if self.clean_up_tokenization_spaces:
            text = clean_up_tokenization(text)
        return text

    def _id(self, token: str | None) -> int | None:
        return None if token is None else self._tok.token_to_id(token)

    @property
    def eos_id(self) -> int | None:
        return self._id(self.eos_token)

    @property
    def bos_id(self) -> int | None:
        return self._id(self.bos_token)


#: the ``tokenizer_class`` whose behaviour is the file's own
_FILE_CLASS = "PreTrainedTokenizerFast"


def _special(cfg: dict, key: str) -> str | None:
    tok = cfg.get(key)
    return tok.get("content") if isinstance(tok, dict) else tok


def load_tokenizer(path: str | os.PathLike) -> Tokenizer:
    """Tokenizer from a ``tokenizer.json`` file or a directory. A file,
    or a directory holding ``tokenizer.json`` without
    ``tokenizer_config.json``, is read alone (no eos or bos id). A
    directory with ``tokenizer_config.json`` takes its eos and bos tokens,
    ``clean_up_tokenization_spaces`` and ``add_prefix_space`` from it
    (``PreTrainedTokenizerFast`` sets a top-level pre-tokenizer's
    ``add_prefix_space`` to its own, False unless the config says
    otherwise, in both branches); its ``tokenizer_class``
    must be ``PreTrainedTokenizerFast`` (the file applied as written) —
    any other class rebuilds the pipeline in ``transformers`` and is
    refused by name."""
    path = os.fspath(path)
    if os.path.isfile(path) and path.endswith(".json"):
        return Tokenizer(TokenizerFile(path, add_prefix_space=False))
    tok_json = os.path.join(path, "tokenizer.json")
    cfg_json = os.path.join(path, "tokenizer_config.json")
    if os.path.isfile(tok_json) and not os.path.exists(cfg_json):
        return Tokenizer(TokenizerFile(tok_json, add_prefix_space=False))
    if not os.path.isfile(cfg_json):
        raise FileNotFoundError(f"{path}: no tokenizer.json or "
                                f"tokenizer_config.json")
    with open(cfg_json, encoding="utf-8") as f:
        cfg = json.load(f)
    cls = cfg.get("tokenizer_class")
    if cls != _FILE_CLASS:
        raise ValueError(f"{cfg_json}: tokenizer_class {cls!r} is not "
                         f"reproduced by the port's tokenizer (it reads "
                         f"{_FILE_CLASS}, which applies tokenizer.json as "
                         f"written)")
    if not os.path.isfile(tok_json):
        raise FileNotFoundError(f"{path}: no tokenizer.json (the port "
                                f"reads no other tokenizer format)")
    tok = Tokenizer(TokenizerFile(tok_json, bool(cfg.get(
                        "add_prefix_space", False))),
                    _special(cfg, "eos_token"),
                    _special(cfg, "bos_token"),
                    bool(cfg.get("clean_up_tokenization_spaces", False)))
    for key, token in (("eos_token", tok.eos_token),
                       ("bos_token", tok.bos_token)):
        if token is not None and tok._id(token) is None:
            raise ValueError(f"{cfg_json}: {key} {token!r} is not in "
                             f"{tok_json}")
    return tok
