"""The text frontend of the lturing recipe (tacotron/pinyin/
parse_text_to_pyin.py), written out plainly to judge what the port's G2P
served: punctuation folded into 「，。？！」, Arabic numbers read out in
hanzi (万/亿 groups, 「十」 for a bare two-digit number, one 零 for a run
of zeros, a pause after each 万/亿 group), the longest phrase of the
dictionary first and each other character's first reading, every
syllable split into its initial and its toned final.

The dictionaries under ``lexicon/`` are frozen copies of the recipe's
pinyin tables (a character's readings, a phrase's reading, and the
corrections that replace a phrase's reading), so a change of a served
pronunciation reads as a difference.
"""

from __future__ import annotations

import os
import re
from functools import lru_cache

LEXICON = os.path.join(os.path.dirname(os.path.abspath(__file__)), "lexicon")
HANZI_DIGITS = "零一二三四五六七八九"

# (pattern, replacement), applied in order: brackets and quotes go, the
# rest of the punctuation folds into the four kept marks
FOLD = [(re.compile(p), r) for p, r in [
    (r"[（）()\[\]【】「」『』《》〈〉'\"‘’]", ""), (r"：“|:“", "，"), (r"[：:]", "，"), (r"”[！!]", "！"),
    (r"”[。.]", "。"), (r"(……”|……|…”|…。|…)", "。"), (r"[”“]", ""), (r"[、\-—·]", "，"), (r"[；;]", "。"),
    (r"\.", "。"), (r",", "，"), (r"!", "！"), (r"\?", "？"),
]]
# then runs of marks collapse, a stronger mark absorbing a weaker one
COLLAPSE = [(re.compile(p), r) for p, r in [
    (r"，[，\s]+", "，"), (r"。[。，\s]+", "。"), (r"，。+", "。"), (r"？[？\s]+", "？"), (r"，？+", "？"),
    (r"！[！\s]+", "！"), (r"，！+", "！"), (r"。+", "。"), (r"，+", "，"), (r"！+", "！"), (r"？+", "？"),
]]


def normalize(text: str) -> str:
    """Prosody marks dropped, lower case, punctuation folded and collapsed
    (a point between two digits kept), white space single."""
    text = re.sub(r"#\d", "", text).lower()
    text = re.sub(r"(\d)\.(\d)", r"\1<dot>\2", text)
    for pat, rep in FOLD + COLLAPSE:
        text = pat.sub(rep, text)
    text = re.sub(r"\s+", " ", text.replace("<dot>", ".")).replace("|", "")
    return text.strip()


def _four(chunk: str, bare_two_digit: bool) -> str:
    """At most four digits with 千/百/十; zeros between digits read as one 零."""
    out, zero = [], False
    for i, d in enumerate(chunk):
        place = len(chunk) - 1 - i
        if d == "0":
            zero = True
            continue
        if zero and out:
            out.append("零")
        zero = False
        if not (d == "1" and place == 1 and bare_two_digit):
            out.append(HANZI_DIGITS[int(d)])
        out.append(("", "十", "百", "千")[place])
    return "".join(out)


def read_integer(digits: str) -> str:
    """A digit string read as a number in hanzi."""
    digits = digits.lstrip("0") or "0"
    if digits == "0":
        return "零"
    if len(digits) > 16:
        return "".join(HANZI_DIGITS[int(d)] for d in digits)
    groups = [digits[max(0, e - 4): e] for e in range(len(digits), 0, -4)][::-1]
    out, last = [], None
    for k, chunk in enumerate(groups):
        level = len(groups) - 1 - k
        if int(chunk) == 0:
            continue
        if out and ((last is not None and last - level > 1) or (len(chunk) == 4 and chunk[0] == "0")):
            out.append("零")
        out.append(_four(chunk, len(digits) == 2))
        if level:
            out.append(("", "万", "亿", "万亿")[level] + "，")
        last = level
    return "".join(out).rstrip("，").replace("，零", "零")


def read_decimal(number: str) -> str:
    whole, _, frac = number.partition(".")
    words = read_integer(whole or "0")
    if frac:
        words += "点" + "".join(HANZI_DIGITS[int(d)] for d in frac if d.isdigit())
    return words


def split(syllable: str) -> list:
    """A toned syllable -> its initial and its final; a syllable that starts
    with a, e or o, or is one letter and a tone, stays whole."""
    if not syllable:
        return []
    if syllable[:2] in ("zh", "ch", "sh"):
        return [syllable[:2], syllable[2:]] if syllable[2:] else [syllable]
    if syllable[0] in "aeo" or (len(syllable) == 2 and syllable[1].isdigit()) or len(syllable) == 1:
        return [syllable]
    return [syllable[0], syllable[1:]]


@lru_cache(maxsize=1)
def lexicon() -> tuple:
    """({char: first reading}, {first char: [(phrase, syllables)], longest first})."""
    first = {}
    with open(os.path.join(LEXICON, "char_pinyin.tsv"), encoding="utf-8") as f:
        for line in f:
            ch, _, readings = line.rstrip("\n").partition("\t")
            if ch and readings:
                first[ch] = readings.split(",")[0]
    phrases: dict = {}
    for name in ("phrase_pinyin.tsv", "phrase_overrides.tsv"):
        with open(os.path.join(LEXICON, name), encoding="utf-8") as f:
            for line in f:
                phrase, _, reading = line.rstrip("\n").partition("\t")
                if phrase and reading:
                    phrases[phrase] = reading.split(" ")
    by_first: dict = {}
    for phrase, reading in phrases.items():
        by_first.setdefault(phrase[0], []).append((phrase, reading))
    for entries in by_first.values():
        entries.sort(key=lambda e: -len(e[0]))
    return first, by_first


RAW = re.compile(r"[a-z]+[0-4]?")


def _digits_end(text: str, i: int) -> int:
    while i < len(text) and text[i].isdigit():
        i += 1
    return i


def phonemes(text: str) -> str:
    """Text -> the space-joined phoneme string the model reads."""
    first, by_first = lexicon()
    text = normalize(text)
    out: list = []
    i = 0
    while i < len(text):
        ch = text[i]
        if "a" <= ch <= "z":  # pinyin typed in: kept, split (pi1 and bi1 are whole symbols)
            m = RAW.match(text, i)
            out += [m.group(0)] if m.group(0) in ("pi1", "bi1") else split(m.group(0))
            i = m.end() + (1 if m.end() < len(text) and text[m.end()] == " " else 0)
            continue
        if ch.isdigit():  # a number, with its decimals where a point and a digit follow
            j = _digits_end(text, i)
            if j < len(text) - 1 and text[j] == "." and text[j + 1].isdigit():
                k = _digits_end(text, j + 1)
                words, j = read_decimal(text[i:k]), k
            else:
                words = read_integer(text[i:j])
            out += [t for t in phonemes(words).split(" ") if t]
            i = j
            continue
        hit = next(((p, r) for p, r in by_first.get(ch, ()) if text.startswith(p, i)), None)
        if hit:
            for syllable in hit[1]:
                out += split(syllable)
            i += len(hit[0])
            continue
        if ch in first:
            out += split(first[ch])
        elif ch != " ":
            out.append(ch)
        i += 1
    return " ".join(out)
