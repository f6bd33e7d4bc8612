"""Pinyin primitives: diacritic->digit tones, initial/final splitting.

Behavioral contract mirrors the reference tone/split conventions
(reference tacotron/pinyin/parse_text_to_pyin.py:4-7, 142-161): the tone
digit attaches to the *end* of the syllable ("hǎo" -> "hao3"), ``ü`` is
romanized as ``v``, and syllables are split into initial + toned final
("hao3" -> ("h", "ao3")) except for vowel-initial syllables and bare
two-char toned syllables which stay whole.
"""

from __future__ import annotations

import unicodedata

# All pinyin initials; y/w are treated as initials (reference split behavior:
# anything not vowel-initial splits first char off, and zh/ch/sh keep 2).
INITIALS = frozenset(
    "b p m f d t n l g k h j q x r z c s y w".split() + ["zh", "ch", "sh"]
)

# Accented vowel -> (base letter, tone digit).  ``ü`` family maps to ``v``.
_TONE_MARKS: dict[str, tuple[str, str]] = {}
for base, accents in {
    "a": "āáǎà",
    "o": "ōóǒò",
    "e": "ēéěè",
    "i": "īíǐì",
    "u": "ūúǔù",
    "v": "ǖǘǚǜ",
    "n": "ńňǹ",
    "m": "ḿ",
}.items():
    for tone_idx, accented in enumerate(accents, start=1 if base not in ("n", "m") else 2):
        _TONE_MARKS[accented] = (base, str(tone_idx))
_TONE_MARKS["ń"] = ("n", "2")
_TONE_MARKS["ň"] = ("n", "3")
_TONE_MARKS["ǹ"] = ("n", "4")
_TONE_MARKS["ḿ"] = ("m", "2")


def diacritic_to_digit(syllable: str) -> str:
    """'hǎo' -> 'hao3'; 'lüè'-> 'lve4'; unaccented input is returned as-is."""
    syllable = unicodedata.normalize("NFC", syllable)
    out = []
    tone = ""
    plain_v = False
    for ch in syllable:
        if ch in _TONE_MARKS and not tone:
            base, tone = _TONE_MARKS[ch]
            out.append(base)
        elif ch == "ü":
            # tone may sit on another vowel ("lüè"); bare neutral ü -> v0
            out.append("v")
            plain_v = True
        else:
            out.append(ch)
    if not tone and plain_v:
        tone = "0"
    return "".join(out) + tone


def split_syllable(syllable: str) -> tuple[str, ...]:
    """Split a tone-digit syllable into (initial, final) phoneme tokens.

    'hao3' -> ('h','ao3'); 'zhen3' -> ('zh','en3'); 'an1' -> ('an1',);
    'a1' -> ('a1',); 'n2' -> ('n2',).
    """
    if not syllable:
        return ()
    if syllable[:2] in ("zh", "ch", "sh"):
        # bare toneless digraph ('zh') stays whole — never emit an empty final
        return (syllable[:2], syllable[2:]) if syllable[2:] else (syllable,)
    if syllable[0] in "aeo":
        return (syllable,)
    if len(syllable) == 2 and syllable[1].isdigit():
        return (syllable,)
    if not syllable[1:]:
        # bare initial ('n' in pre-split raw input 'n i3 h ao3') passes through
        return (syllable,)
    return (syllable[0], syllable[1:])


def join_split_tokens(tokens: list[str]) -> list[str]:
    """Inverse of split: re-join ('h','ao3') pairs into whole syllables."""
    out = []
    i = 0
    while i < len(tokens):
        t = tokens[i]
        if (
            t in INITIALS
            and i + 1 < len(tokens)
            and tokens[i + 1] not in INITIALS
            and tokens[i + 1][:1].isalpha()
        ):
            out.append(t + tokens[i + 1])
            i += 2
        else:
            out.append(t)
            i += 1
    return out
