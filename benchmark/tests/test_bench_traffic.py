"""The traffic generator: the same seed gives the same schedule, texts and
corpus; every seed gets the same multiset of sizes and gaps."""

import numpy as np

from benchmark import core, traffic_gen


def mix():
    return core.load_traffic("serve-poisson-wavernn")


def test_same_seed_same_schedule():
    a = traffic_gen.serve_schedule(mix(), 2**31 + 17, 30.0)
    b = traffic_gen.serve_schedule(mix(), 2**31 + 17, 30.0)
    assert a == b
    c = traffic_gen.serve_schedule(mix(), 2**31 + 18, 30.0)
    assert [r["text"] for r in a] != [r["text"] for r in c]


def test_every_seed_same_sizes_and_arrivals():
    a = traffic_gen.serve_schedule(mix(), 5, 30.0)
    b = traffic_gen.serve_schedule(mix(), 6, 30.0)
    assert sorted(r["hanzi"] for r in a) == sorted(r["hanzi"] for r in b)
    assert [r["hanzi"] for r in a] != [r["hanzi"] for r in b]
    assert [r["due"] for r in a] == [r["due"] for r in b]
    assert len(a) == round(mix()["rate_per_s"] * 30.0)
    gaps = np.diff([r["due"] for r in a] + [30.0])
    assert abs(gaps.sum() - 30.0) < 1e-9 and gaps.min() > 0


def test_texts_follow_the_mix():
    m = mix()
    spec = m["text"]
    sched = traffic_gen.serve_schedule(m, 123, 60.0)
    chars = set(traffic_gen._charset(spec["charset"]))
    numbers = 0
    for r in sched:
        hanzi = [c for c in r["text"] if c in chars]
        assert spec["hanzi_min"] <= len(hanzi) == r["hanzi"] <= spec["hanzi_max"]
        assert r["text"][-1] in spec["finals"]
        numbers += any(c.isdigit() for c in r["text"])
    assert numbers == round(spec["number_share"] * len(sched))
    assert len({r["seed"] for r in sched}) == len(sched)
    assert all(0 <= r["due"] < 60.0 for r in sched)


def test_check_sample_holds_the_longest():
    sched = traffic_gen.serve_schedule(mix(), 77, 30.0)
    keep = traffic_gen.check_sample(sched, 4, 77)
    longest = max(sched, key=lambda r: (r["hanzi"], len(r["text"])))
    assert keep[0] == longest["seed"] and len(set(keep)) == 4
    assert keep == traffic_gen.check_sample(sched, 4, 77)


def test_corpus_is_deterministic(tmp_path):
    tr = core.load_traffic("train-tacotron")
    tr = dict(tr, corpus=dict(tr["corpus"], utterances=12))
    syms = ["a1", "b2", "c3"]
    pa = traffic_gen.tacotron_corpus(tr, 9, str(tmp_path / "a"), syms)
    pb = traffic_gen.tacotron_corpus(tr, 9, str(tmp_path / "b"), syms)
    assert open(pa).read() == open(pb).read()
    rows = [line.split("|") for line in open(pa).read().splitlines()]
    c = tr["corpus"]
    for row in rows:
        frames = int(row[3])
        assert c["frames_min"] <= frames <= c["frames_max"]
        assert c["symbols_min"] <= len(row[5].split(" ")) <= c["symbols_max"]
        mel = np.load(tmp_path / "a" / row[1])
        assert mel.shape == (frames, 80) and mel.min() >= -4.0 and mel.max() <= 4.0
