"""The serving bundle's row buckets (``serving.py``): on the card each
forward is the replay of a CUDA graph captured for its row bucket, fed from
pinned staging; on the CPU the bundle runs eagerly, as before.

The CPU tests hold the ladder, the chunking and the staging fill, and drive
the bucket path itself through a stand-in for the pinned buffers
(``_PlainBucket``), against the eager bundle.  The tests that take the
``card`` fixture need a CUDA card and skip without one; they hold every
family's replay bitwise against its eager forward at the bucket's size, and
the card's answers against the CPU bundle's.  No JAX here."""

import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mmlrec_tpu_torch import serving
from mmlrec_tpu_torch import synthetic as tsyn
from mmlrec_tpu_torch.models import get_model
from mmlrec_tpu_torch.ops import cuda_build
from mmlrec_tpu_torch.serving import ServingBundle, save_serving_bundle
from mmlrec_tpu_torch.train.graphs import StepGraphs
from mmlrec_tpu_torch.utils.seeding import make_generator

SMALL = dict(emb=4, n_sparse=3, n_dense=2, hidden=(16, 8), tower=(8,), gate=(8,),
             batch_size=64, vocab=100)
N = 5000
#: family -> (regime, config options), every family of the registry
FAMILIES = {
    "mmoe": ("mtl", {}), "pcg": ("msl", {}), "mlp": ("msl", {}),
    "sharedbottom": ("msl", dict(masked_loss=True)), "esmm": ("mtl", {}),
    "escm": ("mtl", {}), "escm_dr": ("mtl", {}), "hmoe": ("msl", {}),
    "cross_stitch": ("msl", {}), "aitm": ("mtl", {}), "ple": ("mtmsl", dict(num_tasks=4)),
    "snr_trans": ("msl", {}), "mssm": ("mtl", {}), "star": ("msl", dict(masked_loss=True)),
    "apg": ("msl", {}), "pepnet": ("msl", {}),
}
CARD_SIZES = (1, 15, 16, 17, 64, 65, 4096, 5000)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the bucket path captures CUDA graphs")
    return torch.cuda.get_device_name(0)


def _bundle(tmp_path, name="mmoe", device="cpu"):
    """A bundle of ``name`` with weights of std 0.3 (probabilities spread
    over (0, 1)) on ``device``, and N rows of requests."""
    task, extra = FAMILIES[name]
    cfg = tsyn.make_config(task_name=task, model_name=name, **SMALL, **extra)
    layout, x, _, _ = tsyn.make_data(cfg, n=N, seed=0, vocab=SMALL["vocab"])
    model = get_model(name, layout, cfg, 0.3, generator=make_generator(0), device="cpu")
    path = str(tmp_path / name)
    save_serving_bundle(model, path)
    return ServingBundle.load(path, device=device), x


def _rows(x, lo, hi):
    return {k: v[lo:hi] for k, v in x.items()}


# ----------------------------------------------------------------------
# the ladder, the chunks, the staging
# ----------------------------------------------------------------------
def test_the_ladder_is_monotone_and_pads_little():
    ladder = serving.row_buckets(4096)
    assert ladder[0] == 16 and ladder[-1] == 4096
    assert all(a < b for a, b in zip(ladder, ladder[1:]))
    assert all(b % 8 == 0 for b in ladder)
    octaves = [ladder.index(2 ** k) for k in range(4, 13)]  # every power of two is one
    assert all(0 < b - a <= 4 for a, b in zip(octaves, octaves[1:]))  # four an octave
    assert octaves[-1] - octaves[2] == 4 * 6  # from 64 rows on, exactly four
    for n in range(1, 4097):
        bucket = ladder[np.searchsorted(ladder, n)]
        assert n <= bucket <= max(16, 1.19 * n + 8), (n, bucket)
    assert serving.row_buckets(5000)[-3:] == [4096, 4872, 5000]  # a batch size above 4096


@pytest.mark.parametrize("n,step,want", [
    (5000, 4096, [(0, 4096), (4096, 904)]), (8192, 4096, [(0, 4096), (4096, 4096)]),
    (200, 64, [(0, 64), (64, 64), (128, 64), (192, 8)]), (17, 4096, [(0, 17)]), (0, 16, [])])
def test_a_call_above_the_step_runs_in_chunks(n, step, want):
    assert serving.row_chunks(n, step) == want


def test_the_staging_fill_pads_with_the_last_row():
    widths = [3, 2, 2]
    flat = np.full(serving.staging_size(24, widths), -1, np.int32)
    blocks = serving.staging_blocks(flat, 24, widths, (np.int32, np.float32, np.float32))
    starts = [b.__array_interface__["data"][0] - flat.__array_interface__["data"][0]
              for b in blocks]
    assert all(s % 64 == 0 for s in starts) and starts == sorted(starts)
    assert all(np.shares_memory(b, flat) for b in blocks)
    rng = np.random.default_rng(0)
    packed = (rng.integers(0, 9, (40, 3)).astype(np.int32),
              rng.random((40, 2), dtype=np.float32), rng.random((40, 2), dtype=np.float32))
    serving.fill_staging(blocks, 17, packed, lo=20)
    for block, src in zip(blocks, packed):
        np.testing.assert_array_equal(block[:17], src[20:37])
        np.testing.assert_array_equal(block[17:], np.repeat(src[36:37], 7, 0))
    blocks[0][:5] = np.arange(15).reshape(5, 3)  # filled in place: pads only
    serving.fill_staging(blocks[:1], 5)
    np.testing.assert_array_equal(blocks[0][5:], np.repeat([[12, 13, 14]], 19, 0))


# ----------------------------------------------------------------------
# the bucket path on the CPU, through a stand-in for the pinned buffers
# ----------------------------------------------------------------------
class _PlainBucket(serving._Bucket):
    """A bucket whose buffers are ordinary CPU tensors and whose event
    waits for nothing: the bucket path runs on the CPU through it."""

    def __init__(self, rows, widths, heads, device):
        self.rows = rows
        size = serving.staging_size(rows, widths)
        self.host, self.dev = (torch.empty(size, dtype=torch.int32) for _ in range(2))
        self.staging = serving.staging_blocks(self.host.numpy(), rows, widths,
                                              (np.int32, np.float32, np.float32))
        self.inputs = serving.staging_blocks(self.dev, rows, widths,
                                             (torch.int32, torch.float32, torch.float32))
        self.out_host = torch.empty((rows, heads))
        self.done = SimpleNamespace(record=lambda: None, synchronize=lambda: None)


def _on_buckets(bundle, monkeypatch, largest):
    """``bundle`` (a CPU one) serving through the bucket path, the largest
    bucket ``largest`` rows."""
    monkeypatch.setattr(serving, "_Bucket", _PlainBucket)
    monkeypatch.setattr(bundle, "_rng_states", lambda: [])
    bundle._start_buckets(StepGraphs("cpu"))
    bundle._ladder = serving.row_buckets(largest)
    return bundle


@pytest.mark.parametrize("name", ["mmoe", "sharedbottom", "escm"])
def test_the_bucket_path_agrees_with_the_eager_bundle(name, tmp_path, monkeypatch):
    """Padded to its bucket, chunked above 64 rows, with the domain mask
    (sharedbottom) and ESCM's two columns, and no rows at all: the eager
    bundle's answers."""
    eager, x = _bundle(tmp_path, name)
    buckets = _on_buckets(ServingBundle(eager.model, eager.meta), monkeypatch, 64)
    assert buckets._widths == [3, 2] + ([2] if name == "sharedbottom" else [])
    for n in (0, 1, 15, 16, 17, 50, 64, 65, 200):
        got, want = buckets.predict(_rows(x, 7, 7 + n)), eager.predict(_rows(x, 7, 7 + n))
        assert got.dtype == np.float64 and got.shape == want.shape == (n, 2)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert sorted(buckets._buckets) == [16, 24, 56, 64]
    assert buckets.eager_forwards == 0 and eager.eager_forwards == 9
    packed = serving._pack_from_schema(eager.meta["packing"], _rows(x, 0, 40))
    if eager.meta["needs_mask"]:  # the packed form has no mask column: both refuse it
        for b in (buckets, eager):
            with pytest.raises(TypeError):
                b.predict(packed)
    else:
        np.testing.assert_allclose(buckets.predict(packed), eager.predict(packed),
                                   rtol=0, atol=1e-6)


def test_the_bucket_path_takes_the_fixed_batch(tmp_path, monkeypatch):
    eager, x = _bundle(tmp_path, "sharedbottom")
    eager.meta["batch_mode"], eager.meta["batch_size"] = "fixed", 48
    buckets = _on_buckets(ServingBundle(eager.model, eager.meta), monkeypatch, 4096)
    got = buckets.predict(_rows(x, 0, 100))
    np.testing.assert_allclose(got, eager.predict(_rows(x, 0, 100)), rtol=0, atol=1e-6)
    assert sorted(buckets._buckets) == [16, 48]  # forwards of 48, 48 and 4 rows
    assert eager.eager_forwards == 3  # the eager bundle pads 100 rows to three batches


def test_an_answer_is_a_copy_the_next_request_leaves_alone(tmp_path, monkeypatch):
    eager, x = _bundle(tmp_path)
    buckets = _on_buckets(ServingBundle(eager.model, eager.meta), monkeypatch, 4096)
    first = buckets.predict(_rows(x, 0, 30))
    kept = first.copy()
    buckets.predict(_rows(x, 100, 130))  # the same bucket
    np.testing.assert_array_equal(first, kept)
    assert not any(np.shares_memory(first, b.out_host.numpy()) for b in buckets._buckets.values())


def _named(events, name):
    return [e for e in events if e.name == name]


def _inside(e, outer):
    return (outer.time_range.start <= e.time_range.start
            and e.time_range.end <= outer.time_range.end)


def test_the_bucket_path_keeps_the_serving_spans(tmp_path, monkeypatch):
    """One ``predict`` span a call, packing once inside it, and the copies
    and the forward once a forward (200 rows: four forwards of at most 64)."""
    eager, x = _bundle(tmp_path)
    buckets = _on_buckets(ServingBundle(eager.model, eager.meta), monkeypatch, 64)
    with torch.autograd.profiler.profile(use_kineto=True) as prof:
        buckets.predict(_rows(x, 0, 200))
        buckets.predict(_rows(x, 0, 20))
    events = list(prof.function_events)
    calls = _named(events, "mmlrec.serve.predict")
    assert len(calls) == 2
    for call, forwards in zip(sorted(calls, key=lambda e: e.time_range.start), (4, 1)):
        for name, count in (("mmlrec.serve.pack", 1), ("mmlrec.serve.copy_in", forwards),
                            ("mmlrec.serve.forward", forwards),
                            ("mmlrec.serve.copy_out", forwards)):
            assert len([e for e in _named(events, name) if _inside(e, call)]) == count, name
    assert not _named(events, "mmlrec.serve.replay")  # the CPU captures nothing


def test_the_cpu_bundle_stays_eager(tmp_path):
    bundle, x = _bundle(tmp_path)
    assert bundle._graphs is None and (bundle.captures, bundle.replays) == (0, 0)
    bundle.predict(_rows(x, 0, 100), batch_size=32)
    assert bundle.eager_forwards == 4


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
def _eager_probs(bundle, x, rows):
    """The model's forward run eagerly on ``x`` padded to ``rows`` with its
    last row, as the bucket path pads it."""
    ids, dense = serving._pack_from_schema(bundle.meta["packing"], x)
    mask = serving._domain_mask_from_meta(bundle.meta, x)
    parts = [a if a is None else np.concatenate([a, np.repeat(a[-1:], rows - len(a), 0)])
             for a in (ids, dense, mask)]
    dev = bundle.device
    with torch.inference_mode():
        p = bundle.model(*(None if a is None else torch.from_numpy(a).to(dev) for a in parts))
        if bundle.meta["model_name"] in ("escm", "escm_dr"):
            p = p[:, [0, 2]]
        return p.cpu().numpy()


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_a_replay_is_bitwise_the_eager_forward_at_its_bucket(card, name, tmp_path):
    bundle, x = _bundle(tmp_path, name, device="cuda")
    for n, rows in ((64, 64), (50, 56)):
        r = _rows(x, 3, 3 + n)
        want = _eager_probs(bundle, r, rows)[:n].astype(np.float64)
        captured, replayed = bundle.predict(r), bundle.predict(r)
        np.testing.assert_array_equal(captured, want)
        np.testing.assert_array_equal(replayed, want)
    assert (bundle.captures, bundle.replays, bundle.eager_forwards) == (2, 2, 0)


@pytest.mark.parametrize("fixed", [False, True], ids=["symbolic", "fixed"])
def test_the_card_agrees_with_the_cpu_bundle(card, fixed, tmp_path):
    gpu, x = _bundle(tmp_path, "sharedbottom", device="cuda")
    cpu = ServingBundle.load(str(tmp_path / "sharedbottom"), device="cpu")
    if fixed:
        for b in (gpu, cpu):
            b.meta["batch_mode"], b.meta["batch_size"] = "fixed", 64
    for n in CARD_SIZES:
        got, want = gpu.predict(_rows(x, 0, n)), cpu.predict(_rows(x, 0, n))
        assert got.shape == want.shape == (n, 2)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert float(gpu.predict(_rows(x, 0, 4096)).std()) > 0.02
    # no rows: no forward (the eager fixed-batch path has no batch to run then, and raises)
    assert gpu.predict(_rows(x, 0, 0)).shape == (0, 2)
    assert gpu.eager_forwards == 0


def test_captures_count_the_buckets_and_replays_the_rest(card, tmp_path):
    bundle, x = _bundle(tmp_path, device="cuda")
    for n in (16, 17, 20, 16, 5000, 904, 4096):  # buckets 16, 24, 24, 16, 4096 + 1024, ...
        bundle.predict(_rows(x, 0, n))
    assert sorted(bundle._buckets) == [16, 24, 1024, 4096]
    assert (bundle.captures, bundle.replays, bundle.eager_forwards) == (4, 4, 0)


def test_a_replay_launches_what_the_eager_forward_launches(card, tmp_path):
    bundle, x = _bundle(tmp_path, "ple", device="cuda")
    eager = ServingBundle(bundle.model, bundle.meta)
    eager._graphs = None
    sizes = (100, 100, 700, 700, 4096)
    counts = []
    for b in (bundle, eager):
        cuda_build.reset_launch_counts()
        for n in sizes:
            b.predict(_rows(x, 0, n))
        counts.append({k: v for k, v in cuda_build.launch_counts.items() if v})
    assert counts[0] == counts[1]
    assert counts[0]["embed_concat"] == 5
    assert eager.eager_forwards == 5 and (bundle.captures, bundle.replays) == (3, 2)


def test_a_replay_does_not_synchronise_the_card_but_on_its_event(card, tmp_path):
    bundle, x = _bundle(tmp_path, device="cuda")
    r = _rows(x, 0, 300)
    want = bundle.predict(r)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = bundle.predict(r)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    np.testing.assert_array_equal(got, want)
    assert bundle.replays == 1


def test_an_answer_on_the_card_is_not_overwritten(card, tmp_path):
    bundle, x = _bundle(tmp_path, device="cuda")
    first = bundle.predict(_rows(x, 0, 30))
    kept = first.copy()
    bundle.predict(_rows(x, 100, 130))
    bundle.predict(_rows(x, 200, 230))
    np.testing.assert_array_equal(first, kept)
    assert bundle.replays == 2


def test_a_forward_that_draws_runs_eagerly(card, tmp_path):
    """A model whose forward draws (here a zero-weighted uniform draw) is
    noticed at its first capture; that graph is dropped and every later
    forward runs eagerly."""
    bundle, x = _bundle(tmp_path, device="cuda")
    cpu = ServingBundle.load(str(tmp_path / "mmoe"), device="cpu")
    plain = bundle.model.forward
    bundle.model.forward = lambda *a: plain(*a) + 0.0 * torch.rand((), device=bundle.device)
    for n in (40, 40, 300):
        np.testing.assert_allclose(bundle.predict(_rows(x, 0, n)), cpu.predict(_rows(x, 0, n)),
                                   rtol=0, atol=1e-5)
    assert (bundle.captures, bundle.replays, bundle.eager_forwards) == (1, 0, 2)


def test_threads_never_share_a_bucket(card, tmp_path):
    """Eight threads serving requests of one bucket at once: each answer is
    its own request's."""
    bundle, x = _bundle(tmp_path, device="cuda")
    want = [bundle.predict(_rows(x, 40 * i, 40 * i + 40)) for i in range(8)]
    bad = []

    def serve(i):
        for _ in range(20):
            if not np.array_equal(bundle.predict(_rows(x, 40 * i, 40 * i + 40)), want[i]):
                bad.append(i)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=serve, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not bad
    assert bundle.replays == 7 + 160
