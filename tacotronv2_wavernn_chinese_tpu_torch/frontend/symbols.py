"""Frozen phoneme symbol table and tokenizer.

The reference builds its vocabulary dynamically at import time from the
training metadata (tacotron/utils/symbols.py:12-28), which makes
checkpoint <-> vocab compatibility implicit and fragile; the serving copy
hard-codes the 191 symbols separately (website/app/text.py:1).  Here the
table is one frozen, versioned artifact (frontend/data/symbols.txt) used by
training, inference, and serving alike.
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np

_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")

PAD = "_"
EOS = "~"


class SymbolTable:
    def __init__(self, symbols: list[str]):
        self.symbols = list(symbols)
        self.symbol_to_id = {s: i for i, s in enumerate(self.symbols)}
        self.id_to_symbol = {i: s for i, s in enumerate(self.symbols)}
        self.pad_id = self.symbol_to_id[PAD]
        self.eos_id = self.symbol_to_id[EOS]

    def __len__(self) -> int:
        return len(self.symbols)

    def encode(self, tokens: list[str] | str, append_eos: bool = True) -> list[int]:
        """Phoneme tokens -> ids; silently drops OOV; appends EOS.

        Matches reference tokenizer semantics (tacotron/utils/text.py:18-42).
        """
        if isinstance(tokens, str):
            tokens = [t for t in tokens.split(" ") if t]
        ids = [self.symbol_to_id[t] for t in tokens if t in self.symbol_to_id]
        if append_eos:
            ids.append(self.eos_id)
        return ids

    def decode(self, ids) -> str:
        return " ".join(
            self.id_to_symbol[int(i)] for i in ids if int(i) in self.id_to_symbol
        )

    def encode_padded(self, tokens, max_len: int, append_eos: bool = True) -> np.ndarray:
        ids = self.encode(tokens, append_eos=append_eos)[:max_len]
        out = np.full((max_len,), self.pad_id, dtype=np.int32)
        out[: len(ids)] = ids
        return out


@lru_cache(maxsize=1)
def default_symbols() -> SymbolTable:
    path = os.path.join(_DATA_DIR, "symbols.txt")
    with open(path, encoding="utf-8") as f:
        symbols = [line.rstrip("\n") for line in f if line.rstrip("\n")]
    return SymbolTable(symbols)
