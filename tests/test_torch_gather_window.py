"""B1's window contract: no caller consumes a slot outside the window.

``rows_gather_dual`` with ``n_real`` or ``bounds`` stores nothing outside
the window on the card, as the TPU kernel under Mosaic leaves those slots
uninitialised (``mmlrec_tpu/ops/pallas_gather.py:186-192``); the plain
version fills them with the poison (NaN), as JAX's reference path does.  So
every caller must give the same bits whatever those slots hold.  Here the
plain version is made to leave seeded random bits, infinities of both signs
or large finite values there instead, and the slot-space two-phase step
(``update_space="slot"``: the update alone, a whole fit, and a fit under
``debug=True``) and the row-sharded slot-space update over 4 shards are
held bitwise against the runs with the poison: tables, moments, dense
weights and losses.  Also the grid rule of the kernel's launch
(``gather_grid``) and its mirror of the CUDA source's constants.
"""

import re

import numpy as np
import pytest
import torch

from mmlrec_tpu_torch import synthetic as tsyn
from mmlrec_tpu_torch.models import get_model
from mmlrec_tpu_torch.ops import row_gather as G
from mmlrec_tpu_torch.parallel import shard_embedding as TS
from mmlrec_tpu_torch.train import Trainer
from mmlrec_tpu_torch.train import sparse_embedding as TE

FILLS = ["random_bits", "infinities", "finite"]
# the slot-space tests' fit (test_torch_slot_space.py: vocab 80, heavy
# duplicates, every route list in use)
KW = dict(task_name="mtl", model_name="mmoe", n_sparse=4, n_dense=2, hidden=(16, 8),
          tower=(8,), gate=(8,), batch_size=64, lr=3e-3, two_phase_embedding=True,
          table_update="pallas", table_opt_dtype="bfloat16", table_container="stacked",
          update_space="slot")
DIM, VP, K = 8, 64, 48  # test_torch_shard_embedding.py's sizes


def _fill(kind: str, shape, seed: int) -> torch.Tensor:
    """int32 bits of the stand-in for what an uninitialised slot may hold."""
    g = torch.Generator().manual_seed(seed)
    if kind == "random_bits":
        return torch.randint(-2 ** 31, 2 ** 31, shape, generator=g, dtype=torch.int64).to(
            torch.int32)
    if kind == "infinities":
        sign = torch.randint(0, 2, shape, generator=g) * 2.0 - 1.0
        return (sign * float("inf")).to(torch.float32).view(torch.int32)
    return (torch.randn(shape, generator=g) * 1e30).to(torch.float32).view(torch.int32)


class _Garbage:
    """``rows_gather_dual_plain`` with ``kind`` outside the window; counts
    its windowed calls and the slots it filled."""

    def __init__(self, kind: str):
        self.kind, self.calls, self.filled = kind, 0, 0
        self.real = G.rows_gather_dual_plain

    def __call__(self, stacked, ids, *, n_real=None, bounds=None):
        got = self.real(stacked, ids, n_real=n_real, bounds=bounds)
        if n_real is None and bounds is None:
            return got
        k = ids.shape[0]
        lo, hi = G.window(k, n_real, bounds, device=ids.device)
        slots = torch.arange(k)
        outside = ~((slots >= lo) & (slots < hi))
        fill = _fill(self.kind, tuple(got.shape), seed=1000 + self.calls)
        self.calls += 1
        self.filled += int(outside.sum())
        return torch.where(outside[None, :, None], fill, got.view(torch.int32)).view(got.dtype)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().contiguous().view(torch.int32).numpy()


def _assert_same(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            np.testing.assert_array_equal(_bits(a[k]), _bits(b[k]), err_msg=k)
        else:
            assert a[k] == b[k], k


def _run(fn, kind, monkeypatch):
    """``fn()`` with the poison (``kind`` None) or with ``kind`` outside
    the window."""
    if kind is None:
        return fn()
    garbage = _Garbage(kind)
    with monkeypatch.context() as m:
        m.setattr(G, "rows_gather_dual_plain", garbage)
        out = fn()
    assert garbage.calls > 0 and garbage.filled > 0, "no windowed gather left a slot"
    return out


def _slot_update():
    """The slot-space update alone (test_torch_slot_space.py's case at P =
    16): the stacked container after one step."""
    D, k, vp, P = 8, 512, 1024, 16
    rng = np.random.default_rng(5)
    fat = rng.normal(size=(2 * vp, P * D)).astype(np.float32)
    fat[vp:] = TE.pack_monu_rounded(
        torch.from_numpy(rng.normal(0, 1e-2, (vp, P * D)).astype(np.float32)),
        torch.from_numpy(np.abs(rng.normal(0, 1e-3, (vp, P * D))).astype(np.float32))).numpy()
    flat = ((rng.zipf(1.1, k) - 1) % (vp * P)).astype(np.int32)
    g = rng.normal(size=(k, D)).astype(np.float32)
    meta = TE.batch_step_metadata(flat[None].astype(np.int64), P, vp, want_route=True,
                                  use_native=False)
    m = [torch.from_numpy(a[0]) for a in meta]
    assert int(m[4][0]) < m[2].shape[0]  # pad slots exist
    t = torch.from_numpy(fat)
    pair = G.rows_gather_dual(t.view(2, vp, P * D), m[2], n_real=m[4])
    t, st = TE.two_phase_sparse_adam_slot(
        t, torch.from_numpy(g), torch.from_numpy(flat), m[1], m[2], m[4], pair[0], pair[1],
        TE.SparseAdamFoldedState(count=torch.tensor(2, dtype=torch.int32)), 0.05, *m[6:],
        pack_factor=P)
    return {"container": t, "count": int(st.count)}


def _slot_fit(debug=False):
    """A fit of two epochs in slot space: the container (table and packed
    moments), the dense weights and the Adam state, the losses."""
    cfg = tsyn.make_config(vocab=80, **KW)
    layout, x, y, _ = tsyn.make_data(cfg, n=320, seed=0, vocab=80)
    tr = Trainer(get_model("mmoe", layout, cfg, device="cpu"), device="cpu",
                 debug=debug).compile()
    tr.fit(x, y, batch_size=64, epochs=2, verbose=0)
    assert tr.update_space == "slot" and tr.table_container == "stacked"
    out = {"container": tr.table, "losses": [h["loss"] for h in tr.history]}
    out.update({f"param/{k}": p for k, p in tr.rest_params().items()})
    for field, value in tr.opt_state._asdict().items():
        for k, t in (value.items() if isinstance(value, dict) else [("", value)]):
            out[f"opt/{field}/{k}"] = t
    return out


def _sharded_slot_update():
    """The row-sharded slot-space update over 4 shards in turn
    (``sharded_two_phase_sparse_adam_folded``: B1 with each shard's
    ``bounds``), the shard-major container after it."""
    n, P = 4, 4
    rng = np.random.default_rng(3)
    table = rng.normal(size=(VP, DIM * P)).astype(np.float32) * 0.1
    flat = rng.integers(0, VP * P, (1, K))
    route = ("accperm", "resid_pos", "resid_slot", "gdup_pos", "gdup_tgt")
    meta = TE.batch_step_metadata(flat, P, VP, chunk=8, want_route=True)
    m = dict(zip(("inv", "rep", "pids", "pinv", "nuniq", "prep") + route,
                 (torch.from_numpy(np.array(a[0])) for a in meta)))
    g = torch.from_numpy(rng.normal(size=(K, DIM)).astype(np.float32))
    monu = TE.pack_monu(torch.from_numpy(rng.normal(size=(VP, DIM * P)).astype(np.float32)
                                         * 0.01),
                        torch.from_numpy(rng.random((VP, DIM * P)).astype(np.float32) * 1e-3))
    fatn = TE.fold_stacked_planes(torch.from_numpy(table), monu, n)
    r2 = 2 * (VP // n)
    for i in range(n):
        TS.sharded_two_phase_sparse_adam_folded(
            fatn[i * r2:(i + 1) * r2], g, torch.from_numpy(flat[0].astype(np.int32)),
            *(m[k] for k in ("inv", "rep", "pids", "pinv", "nuniq", "prep")),
            TE.SparseAdamFoldedState(torch.tensor(2, dtype=torch.int32)), 1e-2, i,
            pack_factor=P, update_space="slot", **{k: m[k] for k in route})
    return {"container": fatn}


CASES = {"slot update": _slot_update, "slot-space fit": _slot_fit,
         "row-sharded slot update": _sharded_slot_update}


@pytest.mark.parametrize("kind", FILLS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_no_caller_consumes_a_slot_outside_the_window(case, kind, monkeypatch):
    want = _run(CASES[case], None, monkeypatch)
    got = _run(CASES[case], kind, monkeypatch)
    _assert_same(got, want)


def test_debug_slot_fit_ignores_the_slots_outside_the_window(monkeypatch):
    """``Trainer(debug=True)`` checks the step's loss and probabilities
    (trainer.py:1036-1039), never the gathered pairs: random bits outside
    the window raise nothing and change nothing."""
    want = _run(lambda: _slot_fit(debug=True), None, monkeypatch)
    got = _run(lambda: _slot_fit(debug=True), "random_bits", monkeypatch)
    _assert_same(got, want)


@pytest.mark.parametrize("n_slots,row_units,sms,want", [  # at 8 groups a pass, 4 blocks an SM
    (65536, 32, 132, 132 * 4),  # the step: capped by the card
    (64, 32, 132, 1),  # one pass of each warp of one block
    (1, 32, 132, 1),
    (0, 32, 132, 1),  # no slot: still a valid launch
    (8 * 8 * 3 + 1, 32, 132, 4),  # the ragged last block
    (4096, 16, 132, 32),  # 256-byte rows: 2 rows a group, 8 groups, 16 slots a pass
    (4096, 8, 132, 16),  # 128-byte rows: 4 rows a group, 8 groups, 32 slots a pass
    (4096, 1, 132, 16),  # 16-byte rows: one group of 32 rows a pass
    (4096, 128, 132, 64),  # 2 KB rows: one row a group, the warp loops over it
])
def test_gather_grid(n_slots, row_units, sms, want, monkeypatch):
    monkeypatch.setattr(G, "_GATHER_SLOTS_PER_PASS", 8)
    monkeypatch.setattr(G, "_GATHER_BLOCKS_PER_SM", 4)
    assert G.gather_grid(n_slots, row_units, sms) == want
    monkeypatch.setattr(G, "_GATHER_SLOTS_PER_PASS", 2)  # fewer slots a pass: more blocks
    assert G.gather_grid(n_slots, row_units, sms) >= want
    monkeypatch.setattr(G, "_GATHER_BLOCKS_PER_SM", 1)
    assert G.gather_grid(n_slots, row_units, sms) <= sms


def test_gather_grid_at_the_source_constants():
    """The step's launch at the tuned constants: K = 65,536 slots of 512-byte
    rows need more warps than the card holds, so the grid is the cap."""
    per_block = G._GATHER_WARPS * G._GATHER_SLOTS_PER_PASS
    assert G.gather_grid(65536, 32, 132) == min(65536 // per_block, 132 * G._GATHER_BLOCKS_PER_SM)
    assert G.gather_grid(per_block, 32, 132) == 1
    assert G.gather_grid(per_block + 1, 32, 132) == 2


def test_gather_constants_match_the_cuda_source():
    source = G.LIBRARY.source.read_text()
    (default,) = re.findall(r"#define MMLREC_GATHER_SLOTS_PER_PASS (\d+)", source)
    assert int(default) == G._GATHER_SLOTS_PER_PASS
    assert "kGatherPass = MMLREC_GATHER_SLOTS_PER_PASS" in source
    (threads,) = re.findall(r"constexpr int kThreads = (\d+);", source)
    assert int(threads) // 32 == G._GATHER_WARPS
    assert re.search(r"#define MMLREC_GATHER_STREAMING_STORES [01]\n", source)


def test_gather_refuses_an_output_over_its_source():
    """The kernel reads the source on the read-only path: an output that
    overlaps it is refused before any launch."""
    src = torch.zeros(2, 8, 4)
    assert G._overlap(src, src[1]) and G._overlap(src[0, 3:], src)
    assert not G._overlap(src, torch.zeros(2, 8, 4))
    with pytest.raises(ValueError, match="overlap"):
        G._gather_launch("rows_gather_dual", src, torch.zeros(2, dtype=torch.int32), src[1], 2)
