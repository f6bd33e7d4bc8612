"""Chinese grapheme-to-phoneme conversion.

Converts mixed hanzi / raw-pinyin / digit text into the framework's phoneme
token sequence (space-split initials and toned finals plus 「，。？！」).

Feature parity with the reference G2P (tacotron/pinyin/parse_text_to_pyin.py:
164-236): raw-pinyin passthrough for mixed input, digit-run verbalization via
``int_to_words``, greedy phrase-dictionary match before per-char lookup, and
optional ``#1``-``#4`` prosody markers.  The dictionaries are the versioned
artifacts built by ``tools/build_lexicon.py``.
"""

from __future__ import annotations

import os
import re
from functools import lru_cache

from .normalize import KEPT_PUNCT, int_to_words, normalize_text
from .pinyin_utils import split_syllable

_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")

_RAW_PINYIN = re.compile(r"[a-z]+[0-4]?")


class Lexicon:
    """Char + phrase pronunciation dictionaries (tone-digit syllables)."""

    def __init__(self, char_tsv: str, phrase_tsv: str, overrides_tsv: str | None = None):
        self.char: dict[str, list[str]] = {}
        with open(char_tsv, encoding="utf-8") as f:
            for line in f:
                ch, _, readings = line.rstrip("\n").partition("\t")
                if ch and readings:
                    self.char[ch] = readings.split(",")
        # phrase -> reading map; overrides (corpus-mined corrections, see
        # tools/mine_lexicon_overrides.py) replace same-key base entries
        phrase_map: dict[str, list[str]] = {}
        paths = [phrase_tsv]  # base dictionary is mandatory (raises if absent)
        if overrides_tsv and os.path.exists(overrides_tsv):
            paths.append(overrides_tsv)
        for path in paths:
            with open(path, encoding="utf-8") as f:
                for line in f:
                    phrase, _, reading = line.rstrip("\n").partition("\t")
                    if phrase and reading:
                        phrase_map[phrase] = reading.split(" ")
        # phrases indexed by first char for greedy longest-match
        self.phrase: dict[str, list[tuple[str, list[str]]]] = {}
        for phrase, reading in phrase_map.items():
            self.phrase.setdefault(phrase[0], []).append((phrase, reading))
        # longest phrases first so greedy match prefers maximal context
        for entries in self.phrase.values():
            entries.sort(key=lambda e: -len(e[0]))

    @classmethod
    def from_dicts(
        cls,
        char: dict[str, list[str]],
        phrases: dict[str, list[str]] | dict[str, tuple[str, ...]],
    ) -> "Lexicon":
        """Build a Lexicon from in-memory dicts (used by tools/build_lexicon
        during iterative mining) with the same indexing as file loading."""
        lex = cls.__new__(cls)
        lex.char = {ch: list(rs) for ch, rs in char.items()}
        lex.phrase = {}
        for p, r in phrases.items():
            lex.phrase.setdefault(p[0], []).append((p, list(r)))
        for entries in lex.phrase.values():
            entries.sort(key=lambda e: -len(e[0]))
        return lex


@lru_cache(maxsize=1)
def default_lexicon() -> Lexicon:
    return Lexicon(
        os.path.join(_DATA_DIR, "char_pinyin.tsv"),
        os.path.join(_DATA_DIR, "phrase_pinyin.tsv"),
        os.path.join(_DATA_DIR, "phrase_overrides.tsv"),
    )


def get_pyin(
    text: str, keep_prosody: bool = False, lexicon: Lexicon | None = None
) -> tuple[str, str]:
    """Text -> (space-joined phoneme string, normalized text).

    >>> get_pyin("你好。")[0]
    'n i3 h ao3 。'
    """
    lex = lexicon or default_lexicon()
    text = normalize_text(text, keep_prosody=keep_prosody)
    tokens: list[str] = []
    i = 0
    n = len(text)
    while i < n:
        ch = text[i]
        # prosody markers (only survive normalization when keep_prosody)
        if ch == "#":
            if i + 1 < n and text[i + 1] in "1234":
                tokens.append(text[i : i + 2])
                i += 2
            else:
                i += 1
            continue
        # raw pinyin run: letters + optional tone digit ("n i3 hao3" input)
        if "a" <= ch <= "z":
            m = _RAW_PINYIN.match(text, i)
            syllable = m.group(0)
            if syllable in ("pi1", "bi1"):
                # the reference emits these two raw tokens unsplit
                # (parse_text_to_pyin.py:170-180) and both are atomic entries
                # in the frozen 191-symbol vocabulary — keep them whole
                tokens.append(syllable)
            else:
                tokens.extend(split_syllable(syllable))
            i = m.end()
            if i < n and text[i] == " ":
                i += 1
            continue
        # digit run -> hanzi words -> recurse
        if ch.isdigit():
            j = i
            while j < n and text[j].isdigit():
                j += 1
            num = text[i:j]
            # decimal number?
            if j < n - 1 and text[j] == "." and text[j + 1].isdigit():
                k = j + 1
                while k < n and text[k].isdigit():
                    k += 1
                from .normalize import float_to_words

                words = float_to_words(text[i:k])
                j = k
            else:
                words = int_to_words(num)
            sub, _ = get_pyin(words, lexicon=lex)
            tokens.extend(t for t in sub.split(" ") if t)
            i = j
            continue
        # greedy phrase-dictionary match (polyphone disambiguation)
        matched = False
        for phrase, reading in lex.phrase.get(ch, ()):
            if text.startswith(phrase, i):
                for syl in reading:
                    tokens.extend(split_syllable(syl))
                i += len(phrase)
                matched = True
                break
        if matched:
            continue
        # per-char default reading
        readings = lex.char.get(ch)
        if readings:
            tokens.extend(split_syllable(readings[0]))
        elif ch in KEPT_PUNCT:
            tokens.append(ch)
        elif ch != " ":
            # unknown char: pass through (tokenizer will drop OOV)
            tokens.append(ch)
        i += 1
    return " ".join(tokens), text
