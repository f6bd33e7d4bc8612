"""The one generator of traffic: it reads a mix's parameters and the run's
seed, and nothing else.

Every seed gets the same multiset of sizes (drawn once from the mix's own
``shape_seed``), in an order and with characters that the run's seed
draws, and a serving mix the same arrival times, so runs with different
seeds do the same work at the same moments.
"""

from __future__ import annotations

import math

import numpy as np

from . import core


def _charset(name: str) -> str:
    with open(core.traffic_data_path(name), encoding="utf-8") as f:
        return "".join(line.strip() for line in f)


def text_lengths(spec: dict, n: int, rng) -> np.ndarray:
    """Hanzi counts: lognormal around ``hanzi_median``, clipped to
    [hanzi_min, hanzi_max]."""
    x = rng.lognormal(math.log(spec["hanzi_median"]), spec["sigma"], n)
    return np.clip(np.rint(x), spec["hanzi_min"], spec["hanzi_max"]).astype(int)


def make_text(spec: dict, n_hanzi: int, with_number: bool, chars: str, rng) -> str:
    """``n_hanzi`` characters in clauses of ``clause_min``-``clause_max``
    joined by commas, a final mark from ``finals``, and with
    ``with_number`` an Arabic number inserted at a clause's start."""
    body = [chars[i] for i in rng.integers(0, len(chars), n_hanzi)]
    clauses, i = [], 0
    while i < n_hanzi:
        k = int(rng.integers(spec["clause_min"], spec["clause_max"] + 1))
        clauses.append("".join(body[i: i + k]))
        i += k
    if with_number:
        j = int(rng.integers(0, len(clauses)))
        clauses[j] = str(int(rng.integers(1, spec["number_max"] + 1))) + clauses[j]
    finals = spec["finals"]
    return "，".join(clauses) + finals[int(rng.integers(0, len(finals)))]


def distinct_seeds(rng, n: int) -> list:
    seen, out = set(), []
    while len(out) < n:
        s = int(rng.integers(1, 2**31 - 1))
        if s not in seen:
            seen.add(s)
            out.append(s)
    return out


def serve_schedule(traffic: dict, seed: int, seconds: float, rate: float | None = None) -> list:
    """Open-loop requests due in [0, seconds): [{i, due, text, seed,
    hanzi}].  ``rate`` (requests a second) defaults to the mix's."""
    rate = float(traffic["rate_per_s"] if rate is None else rate)
    n = max(1, int(round(rate * seconds)))
    shape = np.random.default_rng(int(traffic["shape_seed"]))
    spec = traffic["text"]
    if traffic.get("arrivals", "poisson") == "poisson":
        gaps = shape.exponential(1.0, n)
    else:
        raise ValueError(f"unknown arrivals {traffic['arrivals']!r}")
    gaps = gaps / gaps.sum() * seconds
    lengths = text_lengths(spec, n, shape)
    numbers = np.arange(n) < int(round(spec["number_share"] * n))
    run = np.random.default_rng(int(seed))
    lengths, numbers = run.permutation(lengths), run.permutation(numbers)
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    chars = _charset(spec["charset"])
    seeds = distinct_seeds(run, n)
    return [
        {"i": i, "due": float(due[i]), "hanzi": int(lengths[i]),
         "text": make_text(spec, int(lengths[i]), bool(numbers[i]), chars, run), "seed": seeds[i]}
        for i in range(n)
    ]


def check_sample(schedule: list, k: int, seed: int) -> list:
    """The seeds of the requests the check compares: the longest text and
    ``k - 1`` others drawn from the run's seed."""
    longest = max(schedule, key=lambda r: (r["hanzi"], len(r["text"])))
    rest = [r["seed"] for r in schedule if r["seed"] != longest["seed"]]
    rng = np.random.default_rng([int(seed), 7])
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False) if rest and k > 1 else []
    return [longest["seed"]] + [rest[int(j)] for j in pick]


def tacotron_corpus(traffic: dict, seed: int, out_dir: str, symbols: list) -> str:
    """A training corpus: utterances whose (frames, symbols) pairs are the
    mix's fixed multiset in an order the seed draws, random phoneme strings
    (no pad or EOS) and mels uniform in [-4, 4], written as ``mel-<i>.npy``
    beside ``train.txt`` (``audio|mel|samples|frames|text|pyin``).  Returns
    the metadata path."""
    import os

    c = traffic["corpus"]
    n = int(c["utterances"])
    shape = np.random.default_rng(int(c["shape_seed"]))
    frames = np.clip(np.rint(shape.lognormal(math.log(c["frames_median"]), c["frames_sigma"], n)),
                     c["frames_min"], c["frames_max"]).astype(int)
    jitter = shape.uniform(1.0 - c["symbol_jitter"], 1.0 + c["symbol_jitter"], n)
    syms = np.clip(np.rint(frames / c["frames_per_symbol"] * jitter), c["symbols_min"], c["symbols_max"]).astype(int)
    run = np.random.default_rng([int(seed), 11])
    order = run.permutation(n)
    os.makedirs(out_dir, exist_ok=True)
    rows = []
    for i, j in enumerate(order):
        pyin = " ".join(symbols[k] for k in run.integers(0, len(symbols), syms[j]))
        mel = (run.random((frames[j], c["num_mels"]), dtype=np.float32) * 8.0 - 4.0).astype(np.float32)
        np.save(os.path.join(out_dir, f"mel-{i}.npy"), mel, allow_pickle=False)
        rows.append(f"audio-{i}.npy|mel-{i}.npy|{frames[j] * c['hop']}|{frames[j]}|utt{i}|{pyin}")
    path = os.path.join(out_dir, "train.txt")
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(rows) + "\n")
    return path


def vocoder_corpus(traffic: dict, seed: int, out_dir: str) -> str:
    """A vocoder training corpus: utterances of the mix's fixed multiset of
    frame counts in an order the seed draws, each with unit-range mels
    uniform in [0, 1] (a GTA mel's range) and mu-law labels uniform over
    the classes, frames x hop of them, written as ``mel-<i>.npy`` and
    ``labels-<i>.npy`` beside ``train.txt`` (``labels|mel|mel|text``).
    Returns the metadata path."""
    import os

    c = traffic["corpus"]
    n = int(c["utterances"])
    shape = np.random.default_rng(int(c["shape_seed"]))
    frames = np.clip(np.rint(shape.lognormal(math.log(c["frames_median"]), c["frames_sigma"], n)),
                     c["frames_min"], c["frames_max"]).astype(int)
    run = np.random.default_rng([int(seed), 13])
    frames = run.permutation(frames)
    os.makedirs(out_dir, exist_ok=True)
    rows = []
    for i, f in enumerate(frames):
        np.save(os.path.join(out_dir, f"mel-{i}.npy"), run.random((f, c["num_mels"]), dtype=np.float32))
        np.save(os.path.join(out_dir, f"labels-{i}.npy"),
                run.integers(0, 2 ** c["bits"], f * c["hop"]).astype(np.int16))
        rows.append(f"labels-{i}.npy|mel-{i}.npy|mel-{i}.npy|utt{i}")
    path = os.path.join(out_dir, "train.txt")
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("\n".join(rows) + "\n")
    return path
