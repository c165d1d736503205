"""Time the variants of the tuning constants of the hand-written kernels.

``embed_concat`` (``csrc/recsys_kernels.cu``) works on tiles of
``MMLREC_EMBED_TILE_ROWS`` batch rows, and the wide path of ``rows_update``
(``csrc/row_kernels.cu``) gives a lane ``MMLREC_UPDATE_LANE_ELEMS``
consecutive elements where a bfloat16 operand takes part; the vector body of
``multihead_score`` gives a row a group of at least
``MMLREC_SCORE_MIN_LANES`` lanes, a group ``MMLREC_SCORE_ROWS_PER_GROUP``
rows of one head (0: one row, two once a row takes a whole warp), in blocks
of ``MMLREC_SCORE_THREADS`` threads.  All are
constants of the sources (``-D`` overrides them), mirrored in
``ops/kernels.py`` and ``ops/row_scatter.py``.  This tool builds one library
per candidate value (one nvcc each, all started together), holds each
variant bitwise against the plain version, and times the variants in turns
inside one process, on one card (CUDA-graph replay, median device time):

* ``embed_concat`` at the flagship serving batch (table ``[1664, 8]``, ids
  ``[4096, 16]``, dense ``[4096, 61]``) and on the lane-packed ``[65536,
  128]`` table seen as ``[2^20, 8]``, beside an empty kernel on the same
  grid (what a launch alone costs); then, with the constant the source
  has, at batch sizes from 256 to 32,768: the time against the bytes
  moved separates what a launch and its chain of loads cost from what the
  transfer costs;
* ``multihead_score`` at the flagship shape ``[4096, 2, 64]`` and at H =
  128, at batch 1000 and at one task, within atol 1e-6 / rtol 1e-5 of the
  plain version (the sum runs in another order): as many lanes a row as it
  needs (16 at H = 64) or a whole warp, with 1, 2 or 4 rows a group or the
  source's rule, in blocks of 128, 256 or 512 threads, and the scalar body
  (a warp per row, 4-byte loads), each beside an empty kernel on its own
  grid;
* ``rows_update`` on a ``[10,000,000, 128]`` array with K = 65,536 ids, 222
  of them tail pads: f32 and bf16 deltas into a bf16 array, bf16 deltas into
  an f32 array, and the bf16 "set"; each lane run with as many lanes per
  slot as the row needs, and 8 elements a lane also with a whole warp per
  slot (half of its lanes idle at this width);
* ``rows_gather_kernel`` (B1, B4) with ``MMLREC_GATHER_SLOTS_PER_PASS`` row
  groups a pass of a warp (2, 4, 8, 16), default or streaming stores
  (``MMLREC_GATHER_STREAMING_STORES``) and 2, 4 or 8 blocks an SM (the
  wrapper's ``_GATHER_BLOCKS_PER_SM``), at the step's shapes: B1 on the
  ``[2, 10,000,000, 128]`` container with K = 65,536 uniform ids, B1 in
  window mode on shard 1 of 4 (``[2, 2,500,000, 128]``, the sorted unique
  rows' local ids and the shard's ``bounds``: ~16,300 of 65,536 slots) and
  B4 on one plane, each held against the plain version (B1's window on its
  slots, and no byte outside it stored) and beside an empty kernel on its
  own grid; P3 and P4 (``tools/probe_rows.py``) on the same arrays and ids
  as the yardstick that moves the same bytes.

    python -m mmlrec_tpu_torch.tools.tune_kernels [--only embed|score|update|gather]

Prints one line per variant and one JSON line last; the constants in the
sources are the values this tool found fastest.  Needs one CUDA device;
exits 1 without one.
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys

import torch

from ..ops import cuda_build
from ..ops import kernels as K
from ..ops import row_gather as G
from ..ops import row_scatter as S
from . import probe_rows
from .timing import device_ms

EMBED_TILE_ROWS = (4, 8, 16)
UPDATE_VARIANTS = (  # name, elements a lane, a whole warp per slot whatever the row needs
    ("4 elements a lane, a warp per slot", 4, False),
    ("8 elements a lane, a warp per slot", 8, True),
    ("8 elements a lane, half a warp per slot", 8, False),
    ("16 elements a lane, a quarter of a warp per slot", 16, False),
)
BATCH_SWEEP = (256, 1024, 4096, 16384, 32768)
SCORE_VARIANTS = (  # name, least lanes a row, rows a group (0: the rule), threads, vector body
    ("the row's lanes, rows a group by the rule", 1, 0, 256, True),
    ("the row's lanes, 1 row a group", 1, 1, 256, True),
    ("the row's lanes, 2 rows a group", 1, 2, 256, True),
    ("the row's lanes, 4 rows a group", 1, 4, 256, True),
    ("a warp per row, 1 row a group", 32, 1, 256, True),
    ("the rule, blocks of 128 threads", 1, 0, 128, True),
    ("the rule, blocks of 512 threads", 1, 0, 512, True),
    ("scalar body (a warp per row, 4-byte loads)", 1, 0, 256, False),
)
SCORE_SHAPES = ((4096, 2, 64), (4096, 2, 128), (1000, 2, 64), (8192, 1, 64))
GATHER_PASSES = (2, 4, 8, 16)  # MMLREC_GATHER_SLOTS_PER_PASS
GATHER_STORES = (0, 1)  # MMLREC_GATHER_STREAMING_STORES
GATHER_BLOCKS_PER_SM = (2, 4, 8)
GATHER_SENTINEL = -0x21524111  # 0xDEADBEEF: the output before a windowed launch
UPDATE_FORMS = (  # name, array dtype, delta dtype, mode
    ("f32_into_bf16", torch.bfloat16, torch.float32, "add"),
    ("bf16_into_bf16", torch.bfloat16, torch.bfloat16, "add"),
    ("bf16_into_f32", torch.float32, torch.bfloat16, "add"),
    ("bf16_set", torch.bfloat16, torch.bfloat16, "set"),
)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    as_int = torch.int16 if a.element_size() == 2 else torch.int32
    return torch.equal(a.contiguous().view(as_int), b.contiguous().view(as_int))


def _in_turns(variants):
    """The variants there and back again (a, b, c, c, b, a): each is timed
    twice, and a drift of the card shows as a difference of the two."""
    return list(variants) + list(reversed(variants))


def tune_embed_concat(libraries, g):
    dev = torch.device("cuda")
    B, F, Nd = 4096, 16, 61
    tables = {"flagship [1664, 8]": torch.randn(1664, 8, generator=g, device=dev),
              "lane-packed [2^20, 8]": torch.randn(1 << 16, 128, generator=g,
                                                   device=dev).view(-1, 8)}
    dense = torch.rand(B, Nd, generator=g, device=dev)
    default = (K.LIBRARY, K._EMBED_ROWS_PER_BLOCK)
    out = {}
    for rows in _in_turns(EMBED_TILE_ROWS):
        K.LIBRARY, K._EMBED_ROWS_PER_BLOCK = libraries[rows], rows
        entry = out.setdefault(rows, {"embed_concat_us": {}, "empty_kernel_us": []})
        for what, table in tables.items():
            ids = torch.randint(0, table.shape[0], (B, F), generator=g, device=dev,
                                dtype=torch.int32)
            ids[0, 0], ids[1, 1] = table.shape[0] + 5, -1  # a NaN row, a wrapped id
            with torch.inference_mode():
                for n in (B, B - 6):  # whole tiles, and a last tile of 2 rows
                    got = K.embed_concat(table, ids[:n], dense[:n])
                    if not _same_bits(got, K.embed_concat_plain(table, ids[:n], dense[:n])):
                        raise AssertionError(f"embed_concat, {rows} rows a tile, {what}, batch "
                                             f"{n}: differs from the plain version")
                ms = device_ms(lambda: K.embed_concat(table, ids, dense))
            entry["embed_concat_us"].setdefault(what, []).append(ms * 1e3)
        grid = K.embed_concat_grid(B)
        entry["empty_kernel_us"].append(device_ms(lambda: K.empty_launch(*grid)) * 1e3)
    K.LIBRARY, K._EMBED_ROWS_PER_BLOCK = default
    return out


def sweep_embed_concat(g):
    """The kernel as the source has it, at growing batch sizes."""
    dev = torch.device("cuda")
    F, Nd = 16, 61
    table = torch.randn(1664, 8, generator=g, device=dev)
    out = {}
    for B in BATCH_SWEEP:
        ids = torch.randint(0, 1664, (B, F), generator=g, device=dev, dtype=torch.int32)
        dense = torch.rand(B, Nd, generator=g, device=dev)
        grid = K.embed_concat_grid(B)
        with torch.inference_mode():
            out[B] = {"bytes": 4 * (B * F + 1664 * 8 + B * Nd + B * (F * 8 + Nd)),
                      "embed_concat_us": device_ms(lambda: K.embed_concat(table, ids, dense)) * 1e3,
                      "empty_kernel_us": device_ms(lambda: K.empty_launch(*grid)) * 1e3}
    return out


def tune_multihead_score(libraries, g):
    dev = torch.device("cuda")
    default = (K.LIBRARY, K._SCORE_MIN_LANES, K._SCORE_ROWS_PER_GROUP, K._SCORE_THREADS,
               K.multihead_score_vector_body)
    out = {}
    for B, T, H in SCORE_SHAPES:
        tower = torch.randn(B, T, H, generator=g, device=dev)
        w = 0.2 * torch.randn(T, H, generator=g, device=dev)
        b = 0.5 * torch.randn(T, generator=g, device=dev)
        binary = torch.tensor([1.0, 0.0], device=dev)[:T].contiguous()
        for name, lanes, rows, threads, vector in _in_turns(SCORE_VARIANTS):
            K.LIBRARY, K._SCORE_MIN_LANES, K._SCORE_ROWS_PER_GROUP, K._SCORE_THREADS = (
                libraries[lanes, rows, threads], lanes, rows, threads)
            K.multihead_score_vector_body = default[4] if vector else (lambda *a: False)
            with torch.inference_mode():
                for n in (B, B - 3, 3):  # whole groups, a ragged last group, fewer rows than one
                    torch.testing.assert_close(
                        K.multihead_score(tower[:n], w, b, binary),
                        K.multihead_score_plain(tower[:n], w, b, binary), atol=1e-6, rtol=1e-5)
                ms = device_ms(lambda: K.multihead_score(tower, w, b, binary))
            grid = K.multihead_score_grid(B, T, H, vector)
            entry = out.setdefault(f"[{B}, {T}, {H}]", {}).setdefault(
                name, {"us": [], "empty_kernel_us": [], "grid": grid})
            entry["us"].append(ms * 1e3)
            entry["empty_kernel_us"].append(device_ms(lambda: K.empty_launch(*grid)) * 1e3)
    (K.LIBRARY, K._SCORE_MIN_LANES, K._SCORE_ROWS_PER_GROUP, K._SCORE_THREADS,
     K.multihead_score_vector_body) = default
    return out


def tune_rows_update(libraries, g):
    dev = torch.device("cuda")
    V, W, n_ids, n = 10_000_000, 128, 65_536, 65_536 - 222
    ids = torch.randperm(V - 1, generator=g, device=dev)[:n_ids].to(torch.int32)
    ids[n:] = V  # tail pads one past the last row
    n_real = torch.tensor([n], dtype=torch.int32, device=dev)
    default = (S.LIBRARY, S._LANE_ELEMS, S.update_lanes_per_slot)
    out = {}
    for form, a_dtype, d_dtype, mode in UPDATE_FORMS:
        array = torch.empty((V, W), dtype=a_dtype, device=dev).normal_(generator=g)
        delta = torch.empty((n_ids, W), dtype=d_dtype, device=dev).normal_(generator=g)
        masks = None
        if mode == "set":
            masks = ((torch.rand((n_ids, W), generator=g, device=dev) > 0.5).to(a_dtype),)
        es, des = array.element_size(), delta.element_size()
        nbytes = 4 + 4 * n + n * W * (2 * es + des + (es if masks else 0))

        def run(target=array):
            return S.rows_update((target,), ids, (delta,), modes=(mode,), masks=masks,
                                 n_real=n_real)

        for name, elems, whole_warp in _in_turns(UPDATE_VARIANTS):
            S.LIBRARY, S._LANE_ELEMS = libraries[elems], elems
            S.update_lanes_per_slot = (lambda widths, runs: 32) if whole_warp else default[2]
            plain = array.clone()
            run()
            S.rows_update_plain((plain,), ids, (delta,), modes=(mode,), masks=masks,
                                n_real=n_real)
            if not _same_bits(array, plain):
                raise AssertionError(f"rows_update, {form}, {name}: differs from the plain "
                                     "version")
            del plain
            entry = out.setdefault(name, {}).setdefault(form, {"us": [], "bytes": nbytes})
            entry["us"].append(device_ms(run) * 1e3)
        del array, delta, masks
    S.LIBRARY, S._LANE_ELEMS, S.update_lanes_per_slot = default
    return out


def check_gather_window(stacked, ids, what, **window):
    """B1 in window mode on the card: the window's slots bitwise the plain
    version's, and, through the kernel's launch into an output filled with
    ``GATHER_SENTINEL``, no byte outside the window stored (the TPU
    kernel's contract: pallas_gather.py:186-192).  Returns (lo, hi)."""
    k, w = ids.shape[0], stacked.shape[2]
    lo, hi = (int(v) for v in G.window(k, device=ids.device, **window))
    plain = G.rows_gather_dual_plain(stacked, ids, **window)[:, lo:hi].contiguous()
    got = G.rows_gather_dual(stacked, ids, **window)[:, lo:hi].contiguous()
    marked = torch.full((2, k, w), GATHER_SENTINEL, dtype=torch.int32, device=ids.device)
    G._gather_launch("rows_gather_dual", stacked, ids, marked.view(stacked.dtype), 2, **window)
    torch.cuda.synchronize()
    if not (_same_bits(got, plain) and torch.equal(marked[:, lo:hi], plain.view(torch.int32))):
        raise AssertionError(f"{what}: the window [{lo}, {hi}) differs from the plain version")
    outside = torch.cat([marked[:, :lo], marked[:, hi:]], dim=1)
    if not (outside == GATHER_SENTINEL).all():
        raise AssertionError(f"{what}: a byte outside the window [{lo}, {hi}) was stored")
    return lo, hi


def tune_rows_gather(libraries, g):
    from ..parallel.shard_embedding import owned_bounds
    from ..train.sparse_embedding import device_step_metadata

    dev = torch.device("cuda")
    n_feat, vocab, pack, batch, W, shards = 16, 2_500_000, 4, 4096, 128, 4
    V, k = n_feat * vocab // pack, batch * n_feat
    r = V // shards
    stacked = torch.empty((2, V, W), device=dev).normal_(generator=g)
    local = torch.randint(0, vocab, (batch, n_feat), generator=g, device=dev, dtype=torch.int32)
    flat = (local + torch.arange(n_feat, device=dev, dtype=torch.int32)[None] * vocab).reshape(-1)
    phys = torch.div(flat, pack, rounding_mode="floor")
    shard = stacked.view(-1, W)[:2 * r].view(2, r, W)
    windows = []  # shard 1's (local ids, bounds) of four batches
    for _ in range(4):
        _, _, pids, _, nuniq, _ = device_step_metadata(flat, pack, k, V)
        # shard 1: its local ids run negative before its window
        windows.append(((pids - r).clamp(0, r - 1).to(torch.int32),
                        owned_bounds(pids, nuniq, 1, r)))
        local = torch.randint(0, vocab, (batch, n_feat), generator=g, device=dev,
                              dtype=torch.int32)
        flat = (local + torch.arange(n_feat, device=dev, dtype=torch.int32)[None]
                * vocab).reshape(-1)
    lpids, bounds = windows[0]
    lo, hi = bounds.tolist()
    u = int(torch.unique(phys).numel())
    turn = itertools.cycle(windows)

    def window_cold():  # four batches' rows in turn: 134 MB, beyond the 50 MB L2
        ids, b = next(turn)
        return G.rows_gather_dual(shard, ids, bounds=b)

    uses = {  # name: (run, plain, bytes)
        "b1_full": (lambda: G.rows_gather_dual(stacked, phys),
                    lambda: G.rows_gather_dual_plain(stacked, phys), 4 * k + 2 * 4 * W * (u + k)),
        "b1_window": (lambda: G.rows_gather_dual(shard, lpids, bounds=bounds), None,
                      8 + 4 * (hi - lo) + 2 * 2 * 4 * W * (hi - lo)),
        "b1_window_cold": (window_cold, None, 8 + 4 * (hi - lo) + 2 * 2 * 4 * W * (hi - lo)),
        "b4": (lambda: G.rows_gather_hbm(stacked[1], phys),
               lambda: G.rows_gather_hbm_plain(stacked[1], phys), 4 * k + 4 * W * (u + k)),
    }
    default = (G.LIBRARY, G._GATHER_SLOTS_PER_PASS, G._GATHER_BLOCKS_PER_SM)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    variants = [(p, st, b) for p in GATHER_PASSES for st in GATHER_STORES
                for b in GATHER_BLOCKS_PER_SM]
    out = {"shapes": f"stacked [2, {V}, {W}], K = {k} ({u} distinct rows); window "
                     f"[{lo}, {hi}) of shard 1 of {shards} [2, {r}, {W}]",
           "bytes": {name: use[2] for name, use in uses.items()}, "variants": {}}
    for passes, streaming, blocks in _in_turns(variants):
        G.LIBRARY = libraries[passes, streaming]
        G._GATHER_SLOTS_PER_PASS, G._GATHER_BLOCKS_PER_SM = passes, blocks
        name = (f"{passes} groups a pass, {'streaming' if streaming else 'default'} stores, "
                f"{blocks} blocks an SM")
        entry = out["variants"].setdefault(name, {"grid": G.gather_grid(k, W // 4, sms), "us": {},
                                                  "empty_kernel_us": []})
        for use, (run, plain, _) in uses.items():
            if use == "b1_window_cold":
                pass  # the same launches as b1_window, on the batches checked below
            elif plain is None:
                for ids, b in windows:
                    check_gather_window(shard, ids, f"{name}: {use}", bounds=b)
            elif not _same_bits(run(), plain()):
                raise AssertionError(f"rows_gather, {name}, {use}: differs from the plain version")
            entry["us"].setdefault(use, []).append(device_ms(run) * 1e3)
        entry["empty_kernel_us"].append(device_ms(lambda: K.empty_launch(entry["grid"], 256)) * 1e3)
    G.LIBRARY, G._GATHER_SLOTS_PER_PASS, G._GATHER_BLOCKS_PER_SM = default
    rows = [ids[b[0]:b[1]].long() for ids, b in ((i, b.tolist()) for i, b in windows)]
    cold_rows = itertools.cycle(rows)
    yardsticks = {"p4_pairs_gather": lambda: probe_rows.pairs_gather(stacked, phys),
                  "p3_rows_gather": lambda: probe_rows.rows_gather(stacked[1], phys),
                  "index_select_window": lambda: shard.index_select(1, rows[0]),
                  "index_select_window_cold": lambda: shard.index_select(1, next(cold_rows))}
    out["yardsticks_us"] = {name: device_ms(run) * 1e3 for name, run in yardsticks.items()}
    del stacked, shard
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("embed", "score", "update", "gather"), default=None)
    only = ap.parse_args(argv).only
    if not torch.cuda.is_available():
        print("tune_kernels: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    embed, score, update, gather = {}, {}, {}, {}
    if only in (None, "embed"):
        embed = {r: cuda_build.CudaLibrary("recsys_kernels.cu", K.LIBRARY.signatures,
                                           defines=(f"-DMMLREC_EMBED_TILE_ROWS={r}",))
                 for r in EMBED_TILE_ROWS}
    if only in (None, "score"):
        score = {(lanes, rows, threads): cuda_build.CudaLibrary(
            "recsys_kernels.cu", K.LIBRARY.signatures,
            defines=(f"-DMMLREC_SCORE_MIN_LANES={lanes}", f"-DMMLREC_SCORE_ROWS_PER_GROUP={rows}",
                     f"-DMMLREC_SCORE_THREADS={threads}"))
            for lanes, rows, threads in sorted({v[1:4] for v in SCORE_VARIANTS})}
    if only in (None, "update"):
        update = {n: cuda_build.CudaLibrary("row_kernels.cu", G.LIBRARY.signatures,
                                            defines=(f"-DMMLREC_UPDATE_LANE_ELEMS={n}",))
                  for n in sorted({elems for _, elems, _ in UPDATE_VARIANTS})}
    if only in (None, "gather"):
        gather = {(p, st): cuda_build.CudaLibrary(
            "row_kernels.cu", G.LIBRARY.signatures,
            defines=(f"-DMMLREC_GATHER_SLOTS_PER_PASS={p}",
                     f"-DMMLREC_GATHER_STREAMING_STORES={st}"))
            for p in GATHER_PASSES for st in GATHER_STORES}
    libraries = [*embed.values(), *score.values(), *update.values(), *gather.values()]
    paths = cuda_build.build_all(libraries)
    kernels = ("embed_concat_kernel", "multihead_score_vector_kernel",
               "multihead_score_scalar_kernel", "rows_update_kernel", "rows_gather_kernel")
    for lib, path in zip(libraries, paths):
        entry = ""  # ptxas names the entry function, then its registers and spills
        for line in path.with_suffix(".log").read_text().splitlines():
            if "Compiling entry function" in line:
                entry = line
            elif "registers" in line:
                for kernel in kernels:
                    if kernel in entry:
                        print(f"{' '.join(lib.defines)}: {kernel}: {line.strip()}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    result = {"card": card}
    if embed:
        result["embed_concat"] = tune_embed_concat(embed, g)
        result["embed_concat_by_batch"] = sweep_embed_concat(g)
    if score:
        result["multihead_score"] = tune_multihead_score(score, g)
    if update:
        result["rows_update"] = tune_rows_update(update, g)
    if gather:
        result["rows_gather"] = tune_rows_gather(gather, g)
    for rows, entry in result.get("embed_concat", {}).items():
        print(f"embed_concat, {rows} rows a tile: {entry} [{card}]", flush=True)
    for batch, entry in result.get("embed_concat_by_batch", {}).items():
        print(f"embed_concat, batch {batch}: {entry} [{card}]", flush=True)
    for shape, variants in result.get("multihead_score", {}).items():
        for name, entry in variants.items():
            print(f"multihead_score {shape}, {name}: {entry} [{card}]", flush=True)
    for name, entry in result.get("rows_update", {}).items():
        print(f"rows_update, {name}: {entry} [{card}]", flush=True)
    if gather:
        rg = result["rows_gather"]
        print(f"rows_gather: {rg['shapes']}; bytes {rg['bytes']}; P3 / P4 and index_select on "
              f"the same arrays {rg['yardsticks_us']} us [{card}]", flush=True)
        for name, entry in rg["variants"].items():
            print(f"rows_gather, {name}: {entry} [{card}]", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
