"""``serve.graph_replay_share``: the program's ``mmlrec.serve.replay``
ranges that start inside the traced window, over the window's requests;
no value, never a 0, where the program records no such range (the port
before its serving graphs)."""

from types import SimpleNamespace

import numpy as np
import pytest

from portbench import run, trace

NS = 10**9


def _ctx(names, starts, ends, requests=4):
    host = (names, np.array(starts) * NS // 10, np.array(ends) * NS // 10)
    tr = trace.Trace(([], np.zeros(0, np.int64), np.zeros(0, np.int64)), host, (0, NS))
    return SimpleNamespace(trace=tr, requests=requests)


def _read(ctx):
    return run.metric_module("serve.graph_replay_share").read(ctx)


def test_no_replay_range_reads_nothing():
    names = ["mmlrec.serve.predict", "mmlrec.serve.forward", "aten::mm"]
    assert _read(_ctx(names, [1, 2, 2], [4, 3, 3])) is None
    assert _read(_ctx([], [], [])) is None
    assert _read(SimpleNamespace(requests=4)) is None


def test_the_share_counts_the_replays_that_start_in_the_window():
    names = ["mmlrec.serve.replay"] * 4 + ["mmlrec.serve.capture", "mmlrec.serve.forward"]
    # one replay before the window, three in it; a capture is no replay
    ctx = _ctx(names, [-3, 1, 4, 8, 6, 1], [-2, 2, 5, 9, 7, 2], requests=4)
    assert _read(ctx) == pytest.approx(75.0)
    assert _read(_ctx(names[:2], [2, 3], [3, 4], requests=2)) == pytest.approx(100.0)
