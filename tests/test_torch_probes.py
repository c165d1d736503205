"""The plain versions of the probe kernels (``tools/probe_rows.py``, P1-P5)
held against the probe scripts of ``benchmarks/``, whose own Pallas
functions run here in interpret mode, on the same numpy inputs.

Tolerance: none.  P1-P4 are pure data movement; P5 does one f32 add per
element, which has no order to differ in.  Sizes: K = 64 rows, blocks of
16 (``chunk``), 1024 rows a table: the scripts' grids unroll one DMA a row
per block, so their full K = 65,536 would take minutes to interpret.  The
scripts read K from the environment when they are imported and the
builders read the module's K when called: it is set on the module.  The
ids are drawn as the tool draws them, the scripts' way: runs and pairs
distinct, gathers with repeats.
"""

import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlrec_tpu_torch.ops import cuda_build
from mmlrec_tpu_torch.tools import probe_rows as P

ROOT = Path(__file__).resolve().parent.parent
V, K, CHUNK = 1024, 64, 16


def _script(name):
    """A script of benchmarks/ (no package there), loaded by path."""
    spec = importlib.util.spec_from_file_location(f"_probe_{name}",
                                                  ROOT / "benchmarks" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def floor():
    return _script("probe_dma_issue_floor")


@pytest.fixture(scope="module")
def scan():
    return _script("probe_row_gather_scan")


@pytest.fixture(scope="module")
def windows():
    return _script("probe_pallas_row_windows")


def _bits(a):
    return np.asarray(a).view(np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("run", P.RUNS)
def test_rows_write_matches_the_script(floor, monkeypatch, run):
    """P1: two scan steps of fresh run starts, as the script's scan gives
    its kernel, into a random table (untouched rows compared too)."""
    monkeypatch.setattr(floor, "K", K)
    rng = np.random.default_rng(run)
    table = rng.random((V, 128), dtype=np.float32)
    values = rng.random((K, 128)).astype(np.float32)
    ids_all = np.stack([P.draw_run_starts(rng, V, K, run) for _ in range(2)])
    assert all(np.unique(s).size == K // run and not (s % (2 * run)).any() for s in ids_all)
    stepper, _ = floor.build_rows_writer(run, 2, chunk=CHUNK, interpret=True)
    want = stepper(jnp.asarray(table), jnp.asarray(ids_all), jnp.asarray(values))
    got = _t(table.copy())
    for ids in ids_all:
        assert P.rows_write(got, _t(ids), _t(values), run) is got  # in place
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_pairs_write_matches_the_script(floor, monkeypatch):
    """P2: two scan steps of distinct ids into a random [2, V, 128]."""
    monkeypatch.setattr(floor, "K", K)
    rng = np.random.default_rng(2)
    stacked = rng.random((2, V, 128), dtype=np.float32)
    values = rng.random((2, K, 128)).astype(np.float32)
    ids_all = np.stack([P.draw_distinct(rng, V, K) for _ in range(2)])
    stepper = floor.build_dual_writer(chunk=CHUNK, interpret=True)
    want = stepper(jnp.asarray(stacked), jnp.asarray(ids_all), jnp.asarray(values))
    got = _t(stacked.copy())
    for ids in ids_all:
        assert P.pairs_write(got, _t(ids), _t(values)) is got
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_rows_gather_matches_the_script(scan, monkeypatch):
    """P3 on sorted ids with repeats."""
    monkeypatch.setattr(scan, "K", K)
    rng = np.random.default_rng(3)
    table = rng.random((V, 128), dtype=np.float32)
    ids = P.draw_sorted(rng, V // 8, K)  # a narrow range: repeats certain
    assert np.unique(ids).size < K
    want = scan.build_hbm_gather(chunk=CHUNK, interpret=True)(jnp.asarray(table), jnp.asarray(ids))
    got = P.rows_gather(_t(table), _t(ids))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_pairs_gather_matches_the_script(scan, monkeypatch):
    """P4 on sorted ids with repeats."""
    monkeypatch.setattr(scan, "K", K)
    rng = np.random.default_rng(4)
    stacked = rng.random((2, V, 128), dtype=np.float32)
    ids = P.draw_sorted(rng, V // 8, K)
    want = scan.build_dual_gather(chunk=CHUNK, interpret=True)(jnp.asarray(stacked),
                                                               jnp.asarray(ids))
    got = P.pairs_gather(_t(stacked), _t(ids))
    assert got.shape == (2, K, 128)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("k", P.WINDOWS)
def test_window_add_matches_the_script(windows, k):
    """P5: distinct windows of k rows, the script's rand / randn draws."""
    rng = np.random.RandomState(k)
    ids = P.draw_windows(rng, V, K)
    arr = rng.rand(k * V, 128).astype(np.float32)
    deltas = rng.randn(K * k, 128).astype(np.float32)
    want = windows.rows_window_add(jnp.asarray(arr), jnp.asarray(ids), jnp.asarray(deltas), k,
                                   chunk=CHUNK, interpret=True)
    got = _t(arr.copy())
    assert P.window_add(got, _t(ids), _t(deltas), k) is got
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_the_tool_needs_a_card_or_runs_its_plain_versions_on_the_cpu(monkeypatch, capsys):
    """No card: the tool raises; ``--device cpu`` runs every sub-command's
    plain versions and checks, with no times, and launches no kernel."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for command in P.COMMANDS:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            P.main([command])
    cuda_build.reset_launch_counts()
    small = ["--device", "cpu", "--rows", "2048", "--dual-rows", "512", "--window-rows", "256",
             "--k", "64"]
    metrics = {}
    for command in P.COMMANDS:
        assert P.main([command, *small]) == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        metrics[line["metric"]] = {v: e["ns_per_row"] for v, e in line["variants"].items()}
        assert line["K"] == 64 and line["device"] == "cpu"
    assert metrics == {
        "dma_issue_floor_ns_per_row": dict.fromkeys(("R1", "R2", "R4", "R8", "R16", "dual")),
        "row_gather_scan_ns_per_row": dict.fromkeys(("xla", "vmem", "hbm", "base", "dual")),
        "row_windows_ns_per_id": dict.fromkeys(("k2", "k3"))}
    assert not any(cuda_build.launch_counts.values())


def test_wrappers_refuse_what_the_kernels_do_not_take():
    table, ids = torch.zeros(64, 128), torch.arange(8, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        P.rows_gather(table, ids.long())
    with pytest.raises(TypeError, match="float32"):
        P.rows_gather(table.double(), ids)
    with pytest.raises(ValueError, match="runs of 2"):
        P.rows_write(table, ids, torch.zeros(8, 128), run=2)  # values for 8 runs of 1
    with pytest.raises(ValueError, match="windows of 3"):
        P.window_add(torch.zeros(64, 128), ids, torch.zeros(24, 128), 3)  # 64 rows: not k x V
    with pytest.raises(ValueError, match="inputs on"):
        P.rows_gather(table, ids.to("meta"))  # neither all on the CPU nor on one card


_OUTSIDE_CASES = {  # array shape, a call of the wrapper, ids up to the last row, ids past it
    "rows_write": ((64, 128), lambda a, i: P.rows_write(a, i, torch.ones(2 * 4, 128), 4),
                   (8, 60), (61, 0)),
    "pairs_write": ((2, 64, 128), lambda a, i: P.pairs_write(a, i, torch.ones(2, 2, 128)),
                    (3, 63), (3, 64)),
    "rows_gather": ((64, 128), P.rows_gather, (3, 63), (3, 64)),
    "pairs_gather": ((2, 64, 128), P.pairs_gather, (3, 63), (3, 64)),
    "window_add": ((3 * 64, 128), lambda a, i: P.window_add(a, i, torch.ones(6, 128), 3),
                   (5, 63), (64, 5)),
}


@pytest.mark.parametrize("name", _OUTSIDE_CASES)
def test_ids_past_the_end_raise(name):
    """The contract the kernels keep (they stop where the plain versions
    raise): on CPU tensors ids up to the last row (run, window) are taken,
    and one past it raises IndexError."""
    shape, call, inside, outside = _OUTSIDE_CASES[name]
    base = torch.rand(shape, generator=torch.Generator().manual_seed(0))
    assert call(base.clone(), torch.tensor(inside, dtype=torch.int32)).isfinite().all()
    with pytest.raises(IndexError):
        call(base.clone(), torch.tensor(outside, dtype=torch.int32))
