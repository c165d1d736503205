"""The traffic generator's determinism, and the FLOP and byte counts
against hand counts for both configurations."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.arith import ops
from portbench.arith.peaks import least_seconds
from portbench.reference.dims import dims
from portbench.traffic import gen

ROOT = Path(__file__).resolve().parents[2]


def spec(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())


def mix(name):
    return json.loads((ROOT / "portbench" / "mixes" / f"{name}.json").read_text())


@pytest.mark.parametrize("config,traffic", [("recipe40m_mmoe", "recipe_zipf"),
                                            ("ae_sharedbottom", "ae_train"),
                                            ("ae_sharedbottom", "ae_serve")])
def test_rows_are_the_same_for_a_seed_and_differ_between_seeds(config, traffic):
    s, m = spec(config), mix(traffic)
    a = gen.rows(s["experiment"], 5000, m, 2048, 2**31 + 77, "train", "cpu")
    b = gen.rows(s["experiment"], 5000, m, 2048, 2**31 + 77, "train", "cpu")
    c = gen.rows(s["experiment"], 5000, m, 2048, 2**31 + 78, "train", "cpu")
    assert a[0].keys() == b[0].keys()
    for k in a[0]:
        assert np.array_equal(a[0][k], b[0][k])
    assert any(not np.array_equal(a[0][k], c[0][k]) for k in a[0])
    cols, scene = gen.sparse_columns(s["experiment"])
    for col in cols:
        hi = 2 if col == scene else 5000
        assert a[0][col].min() >= 0 and a[0][col].max() < hi
    if a[1] is not None:
        assert np.array_equal(a[1], b[1]) and set(np.unique(a[1])) <= {0.0, 1.0}


def test_zipf_draws_follow_numpys_sampler():
    """numpy's Zipf(1.1) and the generator's agree in distribution: the
    share of ones and of draws past 1000 within a few standard errors."""
    g = torch.Generator().manual_seed(3)
    ours = gen.zipf((200_000,), 1.1, g).numpy()
    theirs = np.random.default_rng(3).zipf(1.1, 200_000)
    for q in (lambda x: x == 1, lambda x: x > 1000):
        p1, p2 = q(ours).mean(), q(theirs).mean()
        assert abs(p1 - p2) < 6 * np.sqrt(p2 * (1 - p2) / 200_000)


def test_every_seed_sends_the_same_request_sizes_in_its_own_order():
    req = mix("ae_serve")["requests"]
    a, b = gen.request_sizes(req, 11), gen.request_sizes(req, 12)
    assert sorted(a) == sorted(b) and not np.array_equal(a, b)
    assert a.min() >= req["min_rows"] and a.max() <= req["max_rows"]
    assert abs(np.median(a) - req["median_rows"]) <= 1


def test_flops_by_hand():
    rec, ae = dims(spec("recipe40m_mmoe")), dims(spec("ae_sharedbottom"))
    # MMoE: input 16 x 32 + 4 = 516; experts 4 x (516x256 + 256x128), gates
    # 2 x (516x64 + 64x4), towers 2 x (128x64 + 64x1), the mix 2 x 4 x 128
    hand = 2 * (4 * (516 * 256 + 256 * 128) + 2 * (516 * 64 + 64 * 4)
                + 2 * (128 * 64 + 64) + 2 * 4 * 128)
    assert rec.input_dim == 516 and ops.forward_matmul_flops(rec) == hand == 1_487_104
    assert ops.train_flops_per_example(rec) == 3 * hand
    # SharedBottom: input 17 x 8 + 63 = 199; bottom 199x256 + 256x128,
    # towers 2 x (128x64 + 64x1)
    hand = 2 * (199 * 256 + 256 * 128 + 2 * (128 * 64 + 64))
    assert ae.input_dim == 199 and ops.forward_matmul_flops(ae) == hand == 200_448


def test_bytes_by_hand():
    rec, ae = dims(spec("recipe40m_mmoe")), dims(spec("ae_sharedbottom"))
    # a row gather or write: the id, then the row of the table (f32) and of
    # its two moments (bf16 in the recipe, f32 in AE), once in, once out
    assert ops.row_op("row_write", 1, rec)[1] == 4 + 2 * (32 * 4 + 2 * 32 * 2) == 516
    assert ops.row_op("row_write", 1, ae)[1] == 4 + 2 * (8 * 4 + 2 * 8 * 4) == 196
    # the multihead score and the expert mix at batch 4096 (PERF.md's B6
    # and B5 rows: 2.13 and 12.71 MB)
    assert ops.multihead_score(4096, 2, 64)[1] == 4 * (4096 * 2 * 64 + 2 * 64 + 2 + 4096 * 2)
    assert ops.expert_mix(4096, 2, 4, 128)[1] == 4 * (4096 * 8 + 4096 * 4 * 128 + 4096 * 2 * 128)
    # embed-concat of 10 AE rows naming 30 distinct table rows
    width = 17 * 8 + 63
    assert ops.embed_concat(10, ae, 30)[1] == 4 * (10 * 17 + 30 * 8 + 10 * 63 + 10 * width)
    step = ops.step_ops(rec, 4096, 1000.0)
    assert [o[0] for o in step] == ["expert_mix", "multihead_score", "row_gather", "row_write"]


def test_the_roofline_share_counts_only_operations_a_kernel_ran():
    op = ops.multihead_score(4096, 2, 64)
    least = least_seconds(op[1], op[2])
    assert ops.roofline_share([op], {"multihead_score": 2 * least}) == pytest.approx(50.0)
    assert ops.roofline_share([op, ops.row_op("row_write", 1e6, dims(spec("ae_sharedbottom")))],
                              {"multihead_score": 2 * least}) == pytest.approx(50.0)
    assert ops.roofline_share([op], {}) is None
