"""Chinese text frontend: normalization, G2P and the frozen symbol table
(copies of the JAX package's JAX-free frontend, kept byte-for-byte in
behaviour; the dictionaries under ``data/`` are identical copies)."""

from .g2p import Lexicon, default_lexicon, get_pyin
from .normalize import float_to_words, int_to_words, normalize_text
from .pinyin_utils import diacritic_to_digit, join_split_tokens, split_syllable
from .symbols import EOS, PAD, SymbolTable, default_symbols

__all__ = [
    "Lexicon",
    "default_lexicon",
    "get_pyin",
    "normalize_text",
    "int_to_words",
    "float_to_words",
    "diacritic_to_digit",
    "split_syllable",
    "join_split_tokens",
    "SymbolTable",
    "default_symbols",
    "PAD",
    "EOS",
]
