"""Text normalization and Chinese number verbalization.

Behavioral parity targets (reference tacotron/pinyin/parse_text_to_pyin.py):
* ``normalize_text`` keeps exactly four punctuation marks 「，。？！」,
  canonicalizes everything else into them, collapses repeats, lowercases,
  and optionally strips ``#1``-``#4`` prosody markers (:105-140).
* ``int_to_words`` verbalizes integers with 万/亿 grouping and the
  colloquial 「十」 (not 「一十」) rule for two-digit numbers (:46-86).
"""

from __future__ import annotations

import re

_DIGITS = "零一二三四五六七八九"
_SMALL_UNITS = ["", "十", "百", "千"]
_GROUP_UNITS = ["", "万", "亿", "万亿"]

KEPT_PUNCT = "，。？！"


def _chunk_to_words(chunk: str, bare_two_digit: bool) -> str:
    """Verbalize a <=4-digit chunk with 十/百/千 units and zero collapsing."""
    out = []
    pending_zero = False
    n = len(chunk)
    for i, ch in enumerate(chunk):
        pos = n - 1 - i
        if ch == "0":
            pending_zero = True
            continue
        if pending_zero and out:
            out.append("零")
        pending_zero = False
        # "一十X" -> "十X" for bare two-digit numbers only (reference rule)
        if not (ch == "1" and bare_two_digit and pos == 1):
            out.append(_DIGITS[int(ch)])
        out.append(_SMALL_UNITS[pos])
    return "".join(out)


def int_to_words(num_str: str) -> str:
    """Verbalize a decimal integer string into hanzi.

    Groups of four digits carry 万/亿 units; interior zero runs collapse to a
    single 零; a leading 一十 in two-digit numbers reads as 十.  A pause mark
    「，」 follows each 万/亿 group, matching the reference prosody
    (parse_text_to_pyin.py:73-77); trailing pauses are stripped.
    """
    num_str = num_str.lstrip("0") or "0"
    if num_str == "0":
        return "零"
    n = len(num_str)
    if n > 4 * len(_GROUP_UNITS):
        # beyond 万亿 (16 digits) there is no unit name in the table — read
        # digit-wise like an ID number (the reference's amap1 simply crashes
        # past 12 digits, parse_text_to_pyin.py:48)
        return digits_to_words(num_str)
    # split into 4-digit groups from the right
    groups = []
    end = n
    while end > 0:
        groups.append(num_str[max(0, end - 4) : end])
        end -= 4
    groups.reverse()
    out = []
    prev_level = None
    for gi, chunk in enumerate(groups):
        level = len(groups) - 1 - gi
        if int(chunk) == 0:
            continue
        words = _chunk_to_words(chunk, bare_two_digit=(n == 2))
        if out:
            skipped_group = prev_level is not None and prev_level - level > 1
            leading_zero = len(chunk) == 4 and chunk[0] == "0"
            if skipped_group or leading_zero:
                out.append("零")
        out.append(words)
        if level > 0:
            out.append(_GROUP_UNITS[level] + "，")
        prev_level = level
    res = "".join(out).rstrip("，")
    return res.replace("，零", "零")


def digits_to_words(num_str: str) -> str:
    """Read a digit string one digit at a time ('110' -> 幺?? no — 一一零)."""
    table = {str(i): _DIGITS[i] for i in range(10)}
    table["."] = "点"
    return "".join(table[c] for c in num_str if c in table)


def float_to_words(num_str: str) -> str:
    int_part, _, frac_part = num_str.partition(".")
    out = int_to_words(int_part or "0")
    if frac_part:
        out += "点" + digits_to_words(frac_part)
    return out


# Punctuation canonicalization: ordered (pattern, replacement) rules.
_PUNCT_RULES: list[tuple[re.Pattern, str]] = [
    (re.compile(r"[（）()\[\]【】「」『』《》〈〉'\"‘’]"), ""),
    (re.compile(r"：“|:“"), "，"),
    (re.compile(r"[：:]"), "，"),
    (re.compile(r"”[！!]"), "！"),
    (re.compile(r"”[。.]"), "。"),
    (re.compile(r"(……”|……|…”|…。|…)"), "。"),
    (re.compile(r"[”“]"), ""),
    (re.compile(r"[、\-—·]"), "，"),
    (re.compile(r"[；;]"), "。"),
    (re.compile(r"\."), "。"),
    (re.compile(r","), "，"),
    (re.compile(r"!"), "！"),
    (re.compile(r"\?"), "？"),
]

_COLLAPSE_RULES: list[tuple[re.Pattern, str]] = [
    (re.compile(r"，[，\s]+"), "，"),
    (re.compile(r"。[。，\s]+"), "。"),
    (re.compile(r"，。+"), "。"),
    (re.compile(r"？[？\s]+"), "？"),
    (re.compile(r"，？+"), "？"),
    (re.compile(r"！[！\s]+"), "！"),
    (re.compile(r"，！+"), "！"),
    (re.compile(r"。+"), "。"),
    (re.compile(r"，+"), "，"),
    (re.compile(r"！+"), "！"),
    (re.compile(r"？+"), "？"),
]


def normalize_text(text: str, keep_prosody: bool = False) -> str:
    """Lowercase + canonicalize punctuation down to 「，。？！」."""
    if not keep_prosody:
        text = re.sub(r"#\d", "", text)
    text = text.lower()
    # 'X.Y' between digits is a decimal point, protect it before '.'->'。'
    text = re.sub(r"(\d)\.(\d)", r"\1<dot>\2", text)
    for pat, rep in _PUNCT_RULES:
        text = pat.sub(rep, text)
    for pat, rep in _COLLAPSE_RULES:
        text = pat.sub(rep, text)
    text = text.replace("<dot>", ".")
    text = re.sub(r"\s+", " ", text)
    text = text.replace("|", "")
    return text.strip()
