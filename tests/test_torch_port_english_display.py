"""The port's copies of the English frontend (``frontend/english.py``) and
the console display helpers (``utils/display.py``) against the JAX
package's: every public function gives the same output."""

import io
import time

import pytest

from tacotronv2_wavernn_chinese_tpu.frontend import english as JE
from tacotronv2_wavernn_chinese_tpu.utils import display as JD
from tacotronv2_wavernn_chinese_tpu_torch.frontend import english as TE
from tacotronv2_wavernn_chinese_tpu_torch.utils import display as TD

TEXTS = [
    "I have 3 apples and 1,250 oranges.",
    "It costs $3.50, or $1 for two, £1,000 in total, $0.07 or $.",
    "The 1st, 2nd, 3rd, 4th, 12th, 21st and 100th runners.",
    "Dr. Smith met Mrs. Jones and Mr. Brown at St. Mary's, Capt. Hook too.",
    "Café naïve résumé Ångström  北京  ",
    "Pi is 3.14159; -5 degrees; 1000000 and 2,000,000,001 people.",
    "   Mixed   CASE\twhitespace\n\nlines  ",
    "",
]
PUBLIC = ["normalize_numbers", "expand_abbreviations", "lowercase", "collapse_whitespace", "convert_to_ascii",
          "basic_cleaners", "transliteration_cleaners", "english_cleaners"]
CMU = """;;; a comment
ABANDON  AH0 B AE1 N D AH0 N
ABANDON(1)  AH0 B AE1 N D AH0 N D
READ  R EH1 D
READ(1)  R IY1 D
'TWAS  T W AH1 Z
BADWORD  XX1 YY
lowercase  L OW1
TOO MANY  SPACES  HERE
"""


@pytest.mark.parametrize("name", PUBLIC)
def test_english_functions_match_jax(name):
    for text in TEXTS:
        assert getattr(TE, name)(text) == getattr(JE, name)(text), (name, text)


def test_number_to_words_matches_jax():
    for n in [0, 7, 13, 20, 42, 99, 100, 101, 999, 1000, 1001, 12345, 10 ** 6, 10 ** 9 + 7, 2 * 10 ** 12, -15]:
        assert TE.number_to_words(n) == JE.number_to_words(n), n
    assert TE.VALID_PHONEMES == JE.VALID_PHONEMES


@pytest.mark.parametrize("keep_ambiguous", [True, False])
def test_cmudict_parses_the_same(keep_ambiguous):
    j = JE.CMUDict(io.StringIO(CMU), keep_ambiguous=keep_ambiguous)
    t = TE.CMUDict(io.StringIO(CMU), keep_ambiguous=keep_ambiguous)
    assert len(t) == len(j)
    for word in ["abandon", "READ", "'twas", "badword", "lowercase", "missing"]:
        assert t.lookup(word) == j.lookup(word), word


def test_display_helpers_print_the_same(capsys, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 10_000.0)
    out = {}
    for name, mod in (("jax", JD), ("port", TD)):
        mod.stream("step 1")
        mod.simple_table([("Batch", 32), ("LR", 1e-4), ("Steps", "1k")])
        mod.bar_stream(3, 7, "loss 0.5", size=10)
        print(mod.progbar(5, 0), mod.progbar(16, 16), mod.time_since(10_000.0 - 59), mod.time_since(10_000.0 - 3725))
        out[name] = capsys.readouterr().out
    assert out["port"] == out["jax"] and "1h 02m 05s" in out["port"]
