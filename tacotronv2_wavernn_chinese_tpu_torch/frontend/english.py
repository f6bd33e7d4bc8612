"""Legacy English text utilities: cleaners, number verbalization, CMUdict.

The port's own copy of the JAX package's ``frontend/english.py`` (pure
Python, same names and behaviour).  Counterpart of the reference's
keithito-derived English stack (tacotron/utils/cleaners.py:1-91,
numbers.py:1-69, cmudict.py:1-62).  Unused for Chinese synthesis but part
of the frontend surface; dependency-free (no unidecode / inflect):
transliteration falls back to ASCII stripping, and number verbalization
is a small pure-Python reader.
"""

from __future__ import annotations

import re
import unicodedata

# ---------------------------------------------------------------------------
# number verbalization (reference numbers.py)
# ---------------------------------------------------------------------------

_UNITS = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALES = [(10 ** 9, "billion"), (10 ** 6, "million"), (10 ** 3, "thousand"),
           (100, "hundred")]


def number_to_words(n: int) -> str:
    if n < 0:
        return "minus " + number_to_words(-n)
    if n < 20:
        return _UNITS[n]
    if n < 100:
        tens, rem = divmod(n, 10)
        return _TENS[tens] + (" " + _UNITS[rem] if rem else "")
    for scale, word in _SCALES:
        if n >= scale:
            major, rem = divmod(n, scale)
            out = number_to_words(major) + " " + word
            if rem:
                out += " " + number_to_words(rem)
            return out
    return _UNITS[0]


_comma_number_re = re.compile(r"([0-9][0-9,]+[0-9])")
_decimal_re = re.compile(r"([0-9]+\.[0-9]+)")
_pounds_re = re.compile(r"£([0-9,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9.,]*[0-9]+)")
_ordinal_re = re.compile(r"([0-9]+)(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")

_ORDINAL_SPECIAL = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _ordinal_to_words(n: int) -> str:
    words = number_to_words(n)
    head, _, last = words.rpartition(" ")
    if last in _ORDINAL_SPECIAL:
        last = _ORDINAL_SPECIAL[last]
    elif last.endswith("y"):
        last = last[:-1] + "ieth"
    else:
        last = last + "th"
    return (head + " " + last).strip()


def _expand_dollars(m: re.Match) -> str:
    parts = m.group(1).replace(",", "").split(".")
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1][:2].ljust(2, "0")) if len(parts) > 1 and parts[1] else 0
    out = []
    if dollars:
        out.append(f"{number_to_words(dollars)} dollar{'s' if dollars != 1 else ''}")
    if cents:
        out.append(f"{number_to_words(cents)} cent{'s' if cents != 1 else ''}")
    return ", ".join(out) if out else "zero dollars"


def normalize_numbers(text: str) -> str:
    """Expand digits/currency/ordinals to words (reference numbers.py:38-69)."""
    text = _comma_number_re.sub(lambda m: m.group(1).replace(",", ""), text)
    text = _pounds_re.sub(lambda m: f"{number_to_words(int(m.group(1).replace(',', '')))} pounds", text)
    text = _dollars_re.sub(_expand_dollars, text)
    text = _decimal_re.sub(lambda m: m.group(1).replace(".", " point "), text)
    text = _ordinal_re.sub(lambda m: _ordinal_to_words(int(m.group(1))), text)
    text = _number_re.sub(lambda m: number_to_words(int(m.group(0))), text)
    return text


# ---------------------------------------------------------------------------
# cleaners (reference cleaners.py)
# ---------------------------------------------------------------------------

_whitespace_re = re.compile(r"\s+")
_ABBREVIATIONS = [
    (re.compile(rf"\b{abbr}\.", re.IGNORECASE), full)
    for abbr, full in [
        ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"), ("st", "saint"),
        ("co", "company"), ("jr", "junior"), ("maj", "major"), ("gen", "general"),
        ("drs", "doctors"), ("rev", "reverend"), ("lt", "lieutenant"),
        ("hon", "honorable"), ("sgt", "sergeant"), ("capt", "captain"),
        ("esq", "esquire"), ("ltd", "limited"), ("col", "colonel"), ("ft", "fort"),
    ]
]


def expand_abbreviations(text: str) -> str:
    for pattern, full in _ABBREVIATIONS:
        text = pattern.sub(full, text)
    return text


def lowercase(text: str) -> str:
    return text.lower()


def collapse_whitespace(text: str) -> str:
    return _whitespace_re.sub(" ", text).strip()


def convert_to_ascii(text: str) -> str:
    """Transliterate to ASCII (unidecode replacement via NFKD fold).

    Behavioral difference vs the reference (cleaners.py:70, unidecode):
    NFKD only strips combining marks from decomposable characters, so
    non-decomposable scripts (hanzi, kana, Cyrillic, ...) are silently
    DROPPED rather than transliterated ("北" -> "" here vs "Bei " under
    unidecode). Acceptable for this framework: the English cleaner chain
    is legacy/unused for the Chinese pipeline, which routes hanzi through
    frontend.g2p instead.
    """
    return (
        unicodedata.normalize("NFKD", text).encode("ascii", "ignore").decode("ascii")
    )


def basic_cleaners(text: str) -> str:
    """Lowercase + whitespace (reference cleaners.py:46-50)."""
    return collapse_whitespace(lowercase(text))


def transliteration_cleaners(text: str) -> str:
    """ASCII fold + basic (reference cleaners.py:53-58)."""
    return collapse_whitespace(lowercase(convert_to_ascii(text)))


def english_cleaners(text: str) -> str:
    """Full English pipeline (reference cleaners.py:61-69)."""
    text = convert_to_ascii(text)
    text = lowercase(text)
    text = normalize_numbers(text)
    text = expand_abbreviations(text)
    return collapse_whitespace(text)


# ---------------------------------------------------------------------------
# CMUdict (reference cmudict.py)
# ---------------------------------------------------------------------------

VALID_PHONEMES = frozenset(
    "AA AA0 AA1 AA2 AE AE0 AE1 AE2 AH AH0 AH1 AH2 AO AO0 AO1 AO2 AW AW0 AW1 AW2 "
    "AY AY0 AY1 AY2 B CH D DH EH EH0 EH1 EH2 ER ER0 ER1 ER2 EY EY0 EY1 EY2 F G "
    "HH IH IH0 IH1 IH2 IY IY0 IY1 IY2 JH K L M N NG OW OW0 OW1 OW2 OY OY0 OY1 "
    "OY2 P R S SH T TH UH UH0 UH1 UH2 UW UW0 UW1 UW2 V W Y Z ZH".split()
)

_alt_re = re.compile(r"\([0-9]+\)")


class CMUDict:
    """word -> list of ARPAbet pronunciations (reference cmudict.py:11-62)."""

    def __init__(self, file_or_path, keep_ambiguous: bool = True):
        if isinstance(file_or_path, str):
            with open(file_or_path, encoding="latin-1") as f:
                entries = _parse_cmudict(f)
        else:
            entries = _parse_cmudict(file_or_path)
        if not keep_ambiguous:
            entries = {w: p for w, p in entries.items() if len(p) == 1}
        self._entries = entries

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, word: str) -> list[str] | None:
        return self._entries.get(word.upper())


def _parse_cmudict(file) -> dict[str, list[str]]:
    entries: dict[str, list[str]] = {}
    for line in file:
        if len(line) and (line[0] >= "A" and line[0] <= "Z" or line[0] == "'"):
            parts = line.split("  ")
            if len(parts) != 2:
                continue
            word = _alt_re.sub("", parts[0])
            pron = _get_pronunciation(parts[1])
            if pron:
                entries.setdefault(word, []).append(pron)
    return entries


def _get_pronunciation(s: str) -> str | None:
    parts = s.strip().split(" ")
    if any(p not in VALID_PHONEMES for p in parts):
        return None
    return " ".join(parts)
