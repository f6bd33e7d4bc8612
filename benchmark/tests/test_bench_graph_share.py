"""``decoder_graph_share.train``: the program's counters of the eager
route's graphed decode read as a share of its decoder steps."""

import pytest

from benchmark import core

READ = core.metric_reader("decoder_graph_share.train")


def test_the_share_of_eager_steps_replayed():
    rec = {"program_counters": {"decoder_steps": {"kernel": 0, "eager": 1952, "k2": 0},
                                "decoder_graphs": {"captures": 8, "steps_replayed": 1904}}}
    assert READ(rec) == pytest.approx(100.0 * 1904 / 1952)


@pytest.mark.parametrize("rec", [{}, {"program_counters": {}},
                                 {"program_counters": {"launches": {}, "decoder_steps": {"eager": 480}}}],
                         ids=["no_counters", "empty", "no_graph_counter"])
def test_none_without_the_counter(rec):
    assert READ(rec) is None


def test_none_without_eager_steps():
    rec = {"program_counters": {"decoder_steps": {"kernel": 960, "eager": 0, "k2": 0},
                                "decoder_graphs": {"captures": 0, "steps_replayed": 0}}}
    assert READ(rec) is None
