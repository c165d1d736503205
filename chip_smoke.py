#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (mmlrec_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with an H100 and nvcc:

    python3 chip_smoke.py

Phases (any mismatch or exception exits non-zero; no phase catches a
failure and carries on):

1. the card's name and power limit (nvidia-smi);
2. build csrc/recsys_kernels.cu and csrc/row_kernels.cu for sm_90a, one
   nvcc each, started together, with the build seconds;
3. each forward kernel (B5-B7) against its plain PyTorch version on the
   card at the flagship serving shapes: embed_concat bitwise, the mix and
   the score within atol 1e-6 / rtol 1e-5 (their sums run in another
   order); kernel and plain times (median of CUDA-event timings after
   warm-up), bytes moved and the bound;
4. serve the flagship MMoE (AliExpress-MSL widths, vocab 100) from a
   bundle loaded on the card: 4 requests of 4096 rows and one of 1000,
   held against the same bundle on the CPU (plain path) within atol 1e-5,
   with every kernel's launch count read around the requests;
5. the same at production vocabulary (16 features x 65,536 ids = 2^20
   fused rows, a lane-packed [65536, 128] table of 32 MB);
6. the row kernels B1-B4 of the two-phase step against their plain
   versions at the step shapes of phase 8 (a [2, 10,000,000, 128] f32
   container, K = 65,536 ids, the unique-row window with tail pads one past
   the last row): bitwise on every slot, every row a write leaves alone
   untouched, and a guard region after the container intact; kernel,
   plain and library-call times;
7. the two-phase training step of the flagship AE widths at 2^20 fused
   rows (P = 16, stacked [131072, 128]), batch 4000 (the largest round
   batch whose 16 ids per row stay below the 65,536 physical rows, as the
   JAX trainer requires), 3 steps per container
   (the last batch partial), from one numpy init and one batch stream on
   the card and on the CPU: losses within rtol 1e-5, dense weights within
   atol 1e-6, the table within 3 x lr x 2^-7 and the moments within 2^-7
   relative + 1e-4 of the largest (see step_card_vs_cpu), with the
   launches of B1-B6 per step;
8. the JAX package's production-vocabulary step at full width (MMoE mtl,
   16 sparse x 2,500,000 ids x emb 32 = 40 M logical rows, P = 4, 4 dense,
   experts (256, 128), gate (64,), tower (64,), batch 4096, bf16 packed
   moments, in-step metadata), on the card only: 20 steps through
   Trainer.fit and 20 timed steps with each container from one init drawn
   on the card; the stacked container's halves must equal the split
   table and moments bitwise; median step time, examples/s, device-busy
   share and launches per step (B1 and B2 once each for stacked, B3 and
   B4 once each for split);
9. one JSON line with every kernel's numbers; the last line is the device
   line.

TF32 is switched off for matrix products and cuDNN, so the card computes
in full f32 like the CPU reference.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
FLAGSHIP_BATCH = 4096
REQUESTS = (4096, 4096, 4096, 4096, 1000)
ROUNDS = 21
SOURCES = {
    "embed_concat": "mmlrec_tpu_torch/csrc/recsys_kernels.cu",
    "gated_expert_mix": "mmlrec_tpu_torch/csrc/recsys_kernels.cu",
    "multihead_score": "mmlrec_tpu_torch/csrc/recsys_kernels.cu",
    "rows_gather_dual": "mmlrec_tpu_torch/csrc/row_kernels.cu",
    "rows_write_dual": "mmlrec_tpu_torch/csrc/row_kernels.cu",
    "rows_write": "mmlrec_tpu_torch/csrc/row_kernels.cu",
    "rows_gather_hbm": "mmlrec_tpu_torch/csrc/row_kernels.cu",
}
REPLACES = {
    "embed_concat": "mmlrec_tpu/ops/pallas_kernels.py:43",
    "gated_expert_mix": "mmlrec_tpu/ops/pallas_kernels.py:123",
    "multihead_score": "mmlrec_tpu/ops/pallas_kernels.py:164",
    "rows_gather_dual": "mmlrec_tpu/ops/pallas_gather.py:171",
    "rows_write_dual": "mmlrec_tpu/ops/pallas_scatter.py:532",
    "rows_write": "mmlrec_tpu/ops/pallas_scatter.py:194",
    "rows_gather_hbm": "mmlrec_tpu/ops/pallas_gather.py:90",
}
ROW_KERNELS = ("rows_gather_dual", "rows_write_dual", "rows_write", "rows_gather_hbm")
# phase 8: the production-vocabulary step (benchmarks/bench_40m_table_update.py)
FULL_VOCAB, FULL_FEATURES, FULL_EMB, FULL_DENSE = 2_500_000, 16, 32, 4
FULL_STEPS = 20
DEV = "cuda"  # the card every phase runs on
TWO_PHASE = dict(two_phase_embedding=True, table_update="pallas",
                 table_opt_dtype="bfloat16", device_metadata=True)


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def _event_ms(torch, run, reps: int, inner: int) -> float:
    """Median over ``reps`` CUDA-event windows of ``run()``, per call of the
    ``inner`` calls that one ``run()`` makes."""
    per_call = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / inner)
    return statistics.median(per_call)


def eager_ms(torch, fn, reps: int = 31, inner: int = 20) -> float:
    """Time per call of ``fn`` issued eagerly from Python, back to back
    after a warm-up: at these sizes this is the host's issue rate."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(inner):
            fn()

    return _event_ms(torch, run, reps, inner)


def device_ms(torch, fn, reps: int = 31, inner: int = 20) -> float:
    """Device time per call of ``fn``: ``inner`` calls captured in one CUDA
    graph and replayed, so the host's issue rate is out of the way."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as capture needs
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    return _event_ms(torch, graph.replay, reps, inner)


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_kernels(torch, K, card):
    """Phase 3: each kernel against its plain version at flagship shapes."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    B, F, D, Nd, V = FLAGSHIP_BATCH, 16, 8, 61, 1664  # 16 x 100 ids, padded to 128
    T, E, Dx, H = 2, 4, 128, 64
    table = torch.randn(V, D, generator=g, device=dev)
    ids = torch.randint(0, V, (B, F), generator=g, device=dev, dtype=torch.int32)
    ids[0, 0], ids[1, 1], ids[2, 2] = V + 5, -1, -2**31 + 1  # fill-mode rows
    dense = torch.rand(B, Nd, generator=g, device=dev)
    logits = 2 * torch.randn(B, T, E, generator=g, device=dev)
    experts = torch.randn(B, E, Dx, generator=g, device=dev)
    tower = torch.randn(B, T, H, generator=g, device=dev)
    w = 0.2 * torch.randn(T, H, generator=g, device=dev)
    b = 0.5 * torch.randn(T, generator=g, device=dev)
    binary = torch.ones(T, device=dev)
    eye = torch.eye(E, device=dev).expand(B, 1, E, E)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            logits[:, None], eye, experts[:, None], scale=1.0)[:, 0]

    n_rows = int(torch.unique(ids[(ids >= 0) & (ids < V)]).numel())
    cases = {
        "embed_concat": dict(
            run=lambda: K.embed_concat(table, ids, dense),
            plain=lambda: K.embed_concat_plain(table, ids, dense),
            library=None, exact=True,
            bytes=4 * (B * F + n_rows * D + B * Nd + B * (F * D + Nd)), flops=0,
            shapes=f"table[{V},{D}] ids[{B},{F}] dense[{B},{Nd}]"),
        "gated_expert_mix": dict(
            run=lambda: K.gated_expert_mix(logits, experts),
            plain=lambda: K.gated_expert_mix_plain(logits, experts),
            library=sdpa, exact=False,
            bytes=4 * (B * T * E + B * E * Dx + B * T * Dx),
            flops=B * T * (2 * E * Dx + 4 * E),
            shapes=f"logits[{B},{T},{E}] experts[{B},{E},{Dx}]"),
        "multihead_score": dict(
            run=lambda: K.multihead_score(tower, w, b, binary),
            plain=lambda: K.multihead_score_plain(tower, w, b, binary),
            library=None, exact=False,
            bytes=4 * (B * T * H + T * H + 2 * T + B * T), flops=B * T * (2 * H + 4),
            shapes=f"tower[{B},{T},{H}] w[{T},{H}]"),
    }
    results = {}
    for name, c in cases.items():
        with torch.inference_mode():
            got, want = c["run"](), c["plain"]()
            torch.cuda.synchronize()
            if c["exact"]:
                if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                    raise AssertionError(f"{name}: kernel differs from the plain version")
                if not torch.isnan(got[:3]).any() or torch.isnan(got[3:]).any():
                    raise AssertionError(f"{name}: fill-mode rows are wrong")
                fin = torch.isfinite(want)
                err = float((got[fin] - want[fin]).abs().max())
            else:
                torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)
                err = float((got - want).abs().max())
            lib_ms = None
            if c["library"] is not None:
                torch.testing.assert_close(c["library"](), want, atol=1e-5, rtol=1e-5)
                lib_ms = device_ms(torch, c["library"])
            ms, plain_ms = device_ms(torch, c["run"]), device_ms(torch, c["plain"])
            host_ms = eager_ms(torch, c["run"])
        bound_ms, bound_by = bound(c["bytes"], c["flops"])
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
                             eager_ms=host_ms, bytes=c["bytes"], shapes=c["shapes"])
        log(f"[3] {name}: {c['shapes']}: max_abs_err {err:.3g}; device time: kernel "
            f"{ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, library "
            f"{'-' if lib_ms is None else f'{lib_ms * 1e3:.2f} us'}; kernel issued eagerly "
            f"{host_ms * 1e3:.2f} us; {c['bytes'] / 1e6:.2f} MB, bound "
            f"{bound_ms * 1e3:.2f} us ({bound_by}) [{card}]")
    return results


def numpy_variables(model, seed: int):
    """A flax-style {"params": ...} tree of numpy weights for ``model``:
    He-scaled kernels, table std 0.3, biases std 0.1."""
    rng = np.random.default_rng(seed)
    tree = {}
    for key, p in model.named_parameters():
        shape, leaf = tuple(p.shape), key.split(".")[-1]
        if leaf == "kernel":
            std = np.sqrt(2.0 / shape[-2])
        else:
            std = 0.3 if leaf == "table" else 0.1
        node = tree
        for part in key.split(".")[:-1]:
            node = node.setdefault(part, {})
        node[leaf] = rng.normal(0.0, std, shape).astype(np.float32)
    return {"params": tree}


def serve(torch, K, card, vocab: int, tag: str, workdir: str):
    """Phases 4 and 5: a bundle served on the card, held against the CPU."""
    from mmlrec_tpu_torch.convert import load_jax_variables
    from mmlrec_tpu_torch.models import get_model
    from mmlrec_tpu_torch.serving import ServingBundle, _pack_from_schema, save_serving_bundle
    from mmlrec_tpu_torch.synthetic import aliexpress_like_config, make_data

    cfg = aliexpress_like_config("mmoe")
    layout, x, _, _ = make_data(cfg, n=sum(REQUESTS), vocab=vocab, seed=0)
    model = get_model("mmoe", layout, cfg, device="cpu")
    load_jax_variables(model, numpy_variables(model, seed=1))
    path = os.path.join(workdir, f"bundle_{vocab}")
    save_serving_bundle(model, path)
    gpu = ServingBundle.load(path, device="cuda")
    cpu = ServingBundle.load(path, device="cpu")
    table = gpu.model.embeddings.fused.table
    log(f"[{tag}] vocab {vocab}: fused table {list(table.shape)} "
        f"({table.numel() * 4 / 2**20:.1f} MiB), pack factor "
        f"{gpu.model.embeddings.fused.pack_factor}")
    edges = np.cumsum((0,) + REQUESTS)
    requests = [{k: v[a:b] for k, v in x.items()} for a, b in zip(edges[:-1], edges[1:])]
    gpu.predict(requests[0])  # warm-up: cuBLAS handles, first launches
    torch.cuda.synchronize()

    K.reset_launch_counts()
    outs, request_s = [], []
    for r in requests:
        t0 = time.perf_counter()
        outs.append(gpu.predict(r))
        request_s.append(time.perf_counter() - t0)
    launches = dict(K.launch_counts)

    for name in ("embed_concat", "gated_expert_mix", "multihead_score"):
        n = launches[name]
        if n != len(requests):
            raise AssertionError(f"{name} launched {n} times for {len(requests)} forwards")
    worst = 0.0
    for r, got in zip(requests, outs):
        want = cpu.predict(r)
        if got.shape != want.shape or got.shape[1] != gpu.meta["num_heads"]:
            raise AssertionError(f"shape {got.shape} vs {want.shape}")
        if not np.isfinite(got).all() or got.min() < 0 or got.max() > 1:
            raise AssertionError("probabilities are not finite values in [0, 1]")
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        worst = max(worst, float(np.abs(got - want).max()))
    spread = float(np.concatenate(outs).std())
    if spread < 0.02:
        raise AssertionError(f"probabilities barely vary (std {spread}): weights too small")

    # one forward on inputs already on the card, per request size: its
    # device time (CUDA graph) and its time issued eagerly from Python
    forward = {}
    for r in (requests[0], requests[-1]):
        ids, dense = _pack_from_schema(gpu.meta["packing"], r)
        ids_d, dense_d = torch.from_numpy(ids).cuda(), torch.from_numpy(dense).cuda()
        with torch.inference_mode():
            fn = lambda: gpu.model(ids_d, dense_d)  # noqa: E731
            forward[len(ids)] = dict(device_ms=device_ms(torch, fn, reps=15, inner=10),
                                     eager_ms=eager_ms(torch, fn, reps=15, inner=10))
    # steady state: the host clock shares its cores with other machines'
    # work, so the same five requests are served ROUNDS more times and the
    # median round is kept; host packing is timed on its own
    rounds = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        for r in requests:
            gpu.predict(r)
        rounds.append(time.perf_counter() - t0)
    packs = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        _pack_from_schema(gpu.meta["packing"], requests[0])
        packs.append(time.perf_counter() - t0)
    pack_s = statistics.median(packs)
    seconds = statistics.median(rounds)
    busy_s = sum(forward[n]["device_ms"] for n in REQUESTS) / 1e3
    rows = int(sum(REQUESTS))
    f = forward[FLAGSHIP_BATCH]
    log(f"[{tag}] {len(requests)} requests, {rows} rows: first pass "
        f"{', '.join(f'{t * 1e3:.2f}' for t in request_s)} ms per request; median of "
        f"{ROUNDS} rounds {seconds * 1e3:.2f} ms = {rows / seconds:.0f} examples/s end to "
        f"end through ServingBundle.predict; host packing of {FLAGSHIP_BATCH} rows "
        f"{pack_s * 1e3:.2f} ms; forward at batch {FLAGSHIP_BATCH}: device "
        f"{f['device_ms'] * 1e3:.1f} us, eager {f['eager_ms'] * 1e3:.1f} us; device busy "
        f"{busy_s / seconds:.1%} of the round; max |gpu - cpu| {worst:.3g}; "
        f"launches {launches} [{card}]")
    return dict(examples_per_s=rows / seconds, round_ms=seconds * 1e3,
                first_request_ms=[t * 1e3 for t in request_s], pack_ms=pack_s * 1e3,
                forward=forward, device_busy_share=busy_s / seconds, max_abs_err=worst,
                launches=launches, rows=rows)


def _ids_like_the_step(torch, g, batch, n_feat, vocab, pack):
    """Uniform per-feature ids of one batch as the trainer flattens them:
    logical rows (feature offset + id) and their physical rows."""
    dev = torch.device(DEV)
    local = torch.randint(0, vocab, (batch, n_feat), generator=g, device=dev, dtype=torch.int32)
    offsets = torch.arange(n_feat, device=dev, dtype=torch.int32) * vocab
    flat = (local + offsets[None]).reshape(-1)
    return flat, torch.div(flat, pack, rounding_mode="floor")


def _time(torch, fn, capturable: bool) -> float:
    """Device time per call (CUDA graph replay) where the call can be
    captured; otherwise CUDA-event time of eager back-to-back calls."""
    return device_ms(torch, fn) if capturable else eager_ms(torch, fn, reps=11, inner=5)


def check_row_kernels(torch, card):
    """Phase 6: B1-B4 against their plain versions at the step shapes."""
    from mmlrec_tpu_torch.ops import row_gather as G
    from mmlrec_tpu_torch.ops import row_scatter as S
    from mmlrec_tpu_torch.train.sparse_embedding import device_step_metadata

    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(6)
    P = 128 // FULL_EMB
    V = FULL_FEATURES * FULL_VOCAB // P  # 10,000,000 physical rows
    W, B = 128, FLAGSHIP_BATCH
    K = B * FULL_FEATURES
    guard_rows = 64
    buf = torch.empty((2 * V + guard_rows, W), dtype=torch.float32, device=dev)
    buf.normal_(generator=g)
    base = buf[: 2 * V].view(2, V, W)
    guard = buf[2 * V:].clone()
    flat, phys = _ids_like_the_step(torch, g, B, FULL_FEATURES, FULL_VOCAB, P)
    inv, rep, pids, pinv, nuniq, prep = device_step_metadata(flat, P, K, V)
    n = int(nuniq[0])
    if not (pids[n:] == V).all():
        raise AssertionError("the unique-row list must end in pads one past the last row")
    u_phys = int(torch.unique(phys).numel())
    values = torch.randn((2, K, W), generator=g, device=dev)
    plain_out = torch.empty_like(base)

    def same_bits(a, b):
        return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))

    results = {}

    # ---- B1: dual gather, the stacked step's phase 1 (no window) and the
    # slot-space form (unique rows, n_real window, poison on the pads)
    got = G.rows_gather_dual(base, phys)
    if not same_bits(got, G.rows_gather_dual_plain(base, phys)):
        raise AssertionError("rows_gather_dual differs from its plain version")
    win = G.rows_gather_dual(base, pids, n_real=nuniq)
    if not same_bits(win, G.rows_gather_dual_plain(base, pids, n_real=nuniq)):
        raise AssertionError("rows_gather_dual (windowed) differs from its plain version")
    if not torch.isnan(win[:, n:]).all():
        raise AssertionError("rows_gather_dual: pad slots are not poisoned")
    results["rows_gather_dual"] = dict(
        run=lambda: G.rows_gather_dual(base, phys),
        plain=lambda: G.rows_gather_dual_plain(base, phys), plain_capturable=True,
        library=lambda: base.index_select(1, phys),
        bytes=4 * K + 2 * 4 * W * (u_phys + K),
        shapes=f"stacked[2,{V},{W}] ids[{K}] ({u_phys} distinct rows)")

    # ---- B4: single-array gather (the split step's moment gather)
    table = base[1]
    got = G.rows_gather_hbm(table, phys)
    if not same_bits(got, G.rows_gather_hbm_plain(table, phys)):
        raise AssertionError("rows_gather_hbm differs from its plain version")
    results["rows_gather_hbm"] = dict(
        run=lambda: G.rows_gather_hbm(table, phys),
        plain=lambda: G.rows_gather_hbm_plain(table, phys), plain_capturable=True,
        library=lambda: table.index_select(0, phys),
        bytes=4 * K + 4 * W * (u_phys + K), shapes=f"table[{V},{W}] ids[{K}]")

    # ---- B2: dual write of the unique rows, pads at the tail
    kernel_out = base  # written in place; the guard rows follow plane 1
    plain_out.copy_(base)
    S.rows_write_dual(kernel_out, pids, values, n_real=nuniq)
    S.rows_write_dual_plain(plain_out, pids, values, n_real=nuniq)
    torch.cuda.synchronize()
    if not same_bits(kernel_out, plain_out) or not same_bits(buf[2 * V:], guard):
        raise AssertionError("rows_write_dual differs from its plain version or wrote past the container")
    pids_n, vals_n = pids[:n].long(), values[:, :n]
    results["rows_write_dual"] = dict(
        run=lambda: S.rows_write_dual(kernel_out, pids, values, n_real=nuniq),
        plain=lambda: S.rows_write_dual_plain(plain_out, pids, values, n_real=nuniq),
        plain_capturable=False,
        library=lambda: kernel_out.index_copy_(1, pids_n, vals_n),
        bytes=8 + 4 * n + 2 * 2 * 4 * W * n,
        shapes=f"stacked[2,{V},{W}] ids[{K}] window [0, {n})")

    # ---- B3: write of (table, monu) rows, two arrays in one launch
    vt, vm = values[0], values[1]
    S.rows_write((kernel_out[0], kernel_out[1]), pids, (vt, vm), n_real=nuniq)
    S.rows_write_plain((plain_out[0], plain_out[1]), pids, (vt, vm), n_real=nuniq)
    torch.cuda.synchronize()
    if not same_bits(kernel_out, plain_out) or not same_bits(buf[2 * V:], guard):
        raise AssertionError("rows_write differs from its plain version or wrote past the arrays")

    def index_copy_each():
        kernel_out[0].index_copy_(0, pids_n, vt[:n])
        kernel_out[1].index_copy_(0, pids_n, vm[:n])

    results["rows_write"] = dict(
        run=lambda: S.rows_write((kernel_out[0], kernel_out[1]), pids, (vt, vm), n_real=nuniq),
        plain=lambda: S.rows_write_plain((plain_out[0], plain_out[1]), pids, (vt, vm),
                                         n_real=nuniq),
        plain_capturable=False, library=index_copy_each,
        bytes=8 + 4 * n + 2 * 2 * 4 * W * n,
        shapes=f"(table, monu) 2 x [{V},{W}] ids[{K}] window [0, {n})")

    out = {}
    for name, c in results.items():
        ms = device_ms(torch, c["run"])
        plain_ms = _time(torch, c["plain"], c["plain_capturable"])
        lib_ms = device_ms(torch, c["library"])
        bound_ms, bound_by = bound(c["bytes"], 0)
        out[name] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=lib_ms, bytes=c["bytes"],
                         shapes=c["shapes"])
        log(f"[6] {name}: {c['shapes']}: bitwise equal to the plain version; kernel "
            f"{ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us"
            f"{'' if c['plain_capturable'] else ' (eager: it synchronises)'}, library "
            f"{lib_ms * 1e3:.2f} us; {c['bytes'] / 1e6:.2f} MB, bound {bound_ms * 1e3:.2f} us "
            f"({bound_by}) [{card}]")
    del buf, base, plain_out, kernel_out, values
    torch.cuda.empty_cache()
    return out


def _numpy_train_state(model, seed: int):
    """numpy weights for a two-phase model: He-scaled kernels, biases std
    0.1, the table std 0.3; a stacked container's moment half zero."""
    rng = np.random.default_rng(seed)
    tree = {}
    for key, p in model.named_parameters():
        shape, leaf = tuple(p.shape), key.split(".")[-1]
        if leaf == "table":
            fat = model.embeddings.fused.dual_container
            half = (shape[0] // 2, shape[1]) if fat else shape
            a = rng.normal(0.0, 0.3, half).astype(np.float32)
            if fat:
                a = np.concatenate([a, np.zeros(half, np.float32)])
        else:
            std = np.sqrt(2.0 / shape[-2]) if leaf == "kernel" else 0.1
            a = rng.normal(0.0, std, shape).astype(np.float32)
        node = tree
        for part in key.split(".")[:-1]:
            node = node.setdefault(part, {})
        node[leaf] = a
    return {"params": tree}


def _container_views(tr):
    """(table, packed moments) of a trainer, as views."""
    from mmlrec_tpu_torch.train.sparse_embedding import split_stacked_planes

    if tr.table_container == "stacked":
        return split_stacked_planes(tr.table.detach())
    return tr.table.detach(), tr.table_opt.monu


def _per_step(K, steps):
    return {k: v / steps for k, v in K.launch_counts.items() if v}


def step_card_vs_cpu(torch, K, card):
    """Phase 7: the two-phase step at the flagship AE widths, 2^20 rows,
    card against CPU, for both containers."""
    from mmlrec_tpu_torch.convert import load_jax_variables
    from mmlrec_tpu_torch.models import get_model
    from mmlrec_tpu_torch.synthetic import aliexpress_like_config, make_data
    from mmlrec_tpu_torch.train import Trainer
    from mmlrec_tpu_torch.train.sparse_embedding import unpack_monu_f32

    # 2^20 fused rows give 65,536 physical rows, and the JAX trainer's
    # headroom rule (staging.py:132-186) needs them above the padded
    # per-batch id count: batch 4000 x 16 features = 64,000 ids
    vocab, batch = 1 << 16, 4000
    n = 3 * batch - 1000  # 3 steps, the last partial
    out = {}
    for container, monu_gather in (("stacked", "xla"), ("split", "pallas")):
        cfg = aliexpress_like_config("mmoe", table_container=container,
                                     monu_gather=monu_gather, **TWO_PHASE)
        layout, x, y, _ = make_data(cfg, n=n, vocab=vocab, seed=7)
        trainers = {}
        for dev in (DEV, "cpu"):
            model = get_model("mmoe", layout, cfg, device="cpu")
            load_jax_variables(model, _numpy_train_state(model, seed=8))
            trainers[dev] = Trainer(model, seed=0, device=dev).compile()
        gpu, cpu = trainers[DEV], trainers["cpu"]
        K.reset_launch_counts()
        gpu.fit(x, y, batch_size=batch, epochs=1, verbose=0)
        torch.cuda.synchronize()
        launches = _per_step(K, 3)
        cpu.fit(x, y, batch_size=batch, epochs=1, verbose=0)
        lg, lc = gpu.history[-1]["loss"], cpu.history[-1]["loss"]
        dense = max(float((p.detach().cpu() - q.detach()).abs().max())
                    for p, q in zip(gpu.rest_params().values(), cpu.rest_params().values()))
        (tg, mg), (tc, mc) = _container_views(gpu), _container_views(cpu)
        table_err = float((tg.cpu() - tc).abs().max())
        # tolerances: the card's f32 sums run in another order than the
        # CPU's.  A table lane moves by at most lr per step, and one bf16
        # flip of its moments moves that step by 2^-7 of it; a moment lane
        # may flip once per step (2^-7 relative), and a lane whose moment
        # is 1e-4 below the largest holds a gradient sum that cancelled,
        # which the order of the sum alone moves by ~1e-2 of itself.
        table_tol = 3 * cfg.optim_config.lr * 2.0 ** -7
        moments = {}
        for which, a, b in zip(("mu", "nu"), unpack_monu_f32(mg), unpack_monu_f32(mc)):
            a, b = a.cpu(), b
            diff = (a - b).abs()
            scale = float(b.abs().max())
            over = int((diff > 2.0 ** -7 * b.abs() + 1e-4 * scale).sum())
            moments[which] = dict(max_abs_err=float(diff.max()), max_abs=scale,
                                  lanes_over_tolerance=over,
                                  lanes_over_rtol_only=int((diff > 2.0 ** -7 * b.abs()).sum()))
        fused = gpu.model.embeddings.fused
        log(f"[7] {container} (monu_gather={monu_gather}): table {list(fused.table.shape)}, "
            f"P={fused.pack_factor}, 3 steps of {batch} ({n} rows); epoch loss "
            f"card {lg:.9g} cpu {lc:.9g}; max |card - cpu|: dense {dense:.3g} (tol 1e-6), "
            f"table {table_err:.3g} (tol {table_tol:.3g}); moments {moments} (tol 2^-7 "
            f"relative + 1e-4 of the largest); launches per step {launches} [{card}]")
        np.testing.assert_allclose(lg, lc, rtol=1e-5)
        if (dense > 1e-6 or table_err > table_tol
                or any(m["lanes_over_tolerance"] for m in moments.values())):
            raise AssertionError(f"{container}: the card's step left the CPU's tolerance")
        want = {"stacked": ("rows_gather_dual", "rows_write_dual"),
                "split": ("rows_write", "rows_gather_hbm")}[container]
        for name in want + ("gated_expert_mix", "multihead_score"):
            if launches.get(name) != 1:
                raise AssertionError(f"{container}: {name} launched {launches.get(name)} per step")
        out[container] = dict(loss_card=lg, loss_cpu=lc, dense_max_abs_err=dense,
                              table_max_abs_err=table_err, table_tolerance=table_tol,
                              moments=moments, launches_per_step=launches)
    return out


def _full_width_trainer(torch, container):
    from mmlrec_tpu_torch.features import DenseFeat, FeatureLayout, SparseFeat
    from mmlrec_tpu_torch.models import get_model
    from mmlrec_tpu_torch.synthetic import make_config
    from mmlrec_tpu_torch.train import Trainer
    from mmlrec_tpu_torch.utils.seeding import make_generator

    cfg = make_config(task_name="mtl", model_name="mmoe", emb=FULL_EMB, n_sparse=FULL_FEATURES,
                      n_dense=FULL_DENSE, hidden=(256, 128), tower=(64,), gate=(64,),
                      batch_size=FLAGSHIP_BATCH, table_container=container,
                      monu_gather="pallas" if container == "split" else "xla", **TWO_PHASE)
    layout = FeatureLayout(
        [SparseFeat(f"s{i}", FULL_VOCAB, FULL_EMB) for i in range(FULL_FEATURES)]
        + [DenseFeat(f"d{i}", 1) for i in range(FULL_DENSE)])
    model = get_model("mmoe", layout, cfg, generator=make_generator(0, DEV), device=DEV)
    return Trainer(model, seed=0, device=DEV).compile()


def _step_device_ms(torch, step, reps: int = 5):
    """Device time of one step: the card first spins for ~100 ms
    (torch.cuda._sleep) while the host queues the whole step behind it, so
    the events from the end of the spin to the end of the step time the
    step's kernels back to back.  None if queueing took longer than the
    spin (the step would then include idle time)."""
    probe = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
    probe[0].record()
    torch.cuda._sleep(10_000_000)
    probe[1].record()
    probe[1].synchronize()
    cycles = int(10_000_000 * 100.0 / probe[0].elapsed_time(probe[1]))
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        e0.record()
        t0 = time.perf_counter()
        step()
        queued_ms = (time.perf_counter() - t0) * 1e3
        e1.record()
        e1.synchronize()
        if queued_ms > 80.0:
            return None
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def full_width(torch, K, card):
    """Phase 8: the production-vocabulary step at full width on the card."""
    rng = np.random.default_rng(40)
    n = FULL_STEPS * FLAGSHIP_BATCH
    x = {f"s{i}": rng.integers(0, FULL_VOCAB, n) for i in range(FULL_FEATURES)}
    x.update({f"d{i}": rng.random(n).astype(np.float32) for i in range(FULL_DENSE)})
    y = (rng.random((n, 2)) < 0.3).astype(np.float32)
    kept, out = {}, {}
    for container in ("split", "stacked"):
        t0 = time.perf_counter()
        tr = _full_width_trainer(torch, container)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        tr.fit(x, y, batch_size=FLAGSHIP_BATCH, epochs=1, shuffle=False, verbose=0)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = dict(K.launch_counts)
        per_step = _per_step(K, FULL_STEPS)
        # timed steps on batches already on the card: CUDA events around each
        batches = []
        ids, dense = tr.pack_inputs(x)
        for s in range(FULL_STEPS):
            sl = slice(s * FLAGSHIP_BATCH, (s + 1) * FLAGSHIP_BATCH)
            batches.append([torch.from_numpy(a[sl]).to(DEV) for a in (ids, dense, y)]
                           + [None, torch.ones(FLAGSHIP_BATCH, device=DEV)])
        step_ms = []
        for b in batches:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            tr.train_step(*b)
            e1.record()
            e1.synchronize()
            step_ms.append(e0.elapsed_time(e1))
        it = iter(batches)
        dev_ms = _step_device_ms(torch, lambda: tr.train_step(*next(it)))
        med = statistics.median(step_ms)
        busy = None if dev_ms is None else dev_ms / med
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        fused = tr.model.embeddings.fused
        log(f"[8] {container}: table {list(fused.table.shape)} "
            f"({fused.table.numel() * 4 / 1e9:.2f} GB), P={fused.pack_factor}; init "
            f"{init_s:.1f} s; fit of {FULL_STEPS} steps {fit_s:.2f} s, loss "
            f"{tr.history[-1]['loss']:.6f}; launches in fit {launches}; median step "
            f"{med:.3f} ms (CUDA events, min {min(step_ms):.3f}) = "
            f"{FLAGSHIP_BATCH / med * 1e3:.0f} examples/s; step device time "
            f"{'not measured' if dev_ms is None else f'{dev_ms:.3f} ms'}, device busy "
            f"{'not measured' if busy is None else f'{busy:.1%}'}; peak memory "
            f"{peak_gb:.2f} GB [{card}]")
        want = {"stacked": ("rows_gather_dual", "rows_write_dual"),
                "split": ("rows_write", "rows_gather_hbm")}[container]
        for name in ROW_KERNELS:
            expect = FULL_STEPS if name in want else 0
            if launches[name] != expect:
                raise AssertionError(f"{container}: {name} launched {launches[name]} times "
                                     f"in {FULL_STEPS} steps, expected {expect}")
        for name in ("gated_expert_mix", "multihead_score"):
            if launches[name] != FULL_STEPS:
                raise AssertionError(f"{container}: {name} launched {launches[name]} times")
        t, m = _container_views(tr)
        kept[container] = (t, m, {k: p.detach() for k, p in tr.rest_params().items()},
                           int(tr.table_opt.count))
        out[container] = dict(step_ms_median=med, step_ms=step_ms,
                              examples_per_s=FLAGSHIP_BATCH / med * 1e3,
                              step_device_ms=dev_ms, device_busy_share=busy, launches=launches,
                              launches_per_step=per_step, init_s=init_s, fit_s=fit_s,
                              loss=tr.history[-1]["loss"], peak_memory_gb=peak_gb)
        del tr
    (ts, ms_, ds, n_steps), (tk, mk, dk, n_stacked) = kept["split"], kept["stacked"]
    if not (torch.equal(ts.view(torch.int32), tk.view(torch.int32))
            and torch.equal(ms_.view(torch.int32), mk.view(torch.int32))):
        raise AssertionError("stacked container halves differ from the split table/moments")
    dense_equal = all(torch.equal(ds[k], dk[k]) for k in ds)
    touched = int((ms_.view(torch.int32) != 0).any(dim=1).sum())
    log(f"[8] stacked top/bottom halves == split table/monu bitwise after "
        f"{n_steps} steps ({touched} rows with moments); dense params "
        f"{'bitwise equal' if dense_equal else 'NOT bitwise equal'} [{card}]")
    if touched == 0 or n_steps != n_stacked or out["stacked"]["loss"] != out["split"]["loss"]:
        raise AssertionError("phase 8: no rows trained, or the two containers' losses differ")
    # the cost of the deterministic gradient dedup at this shape
    from mmlrec_tpu_torch.train.sparse_embedding import _segment_sum

    g_rows = torch.randn(FLAGSHIP_BATCH * FULL_FEATURES, FULL_EMB, device=DEV)
    inv = torch.randint(0, g_rows.shape[0], (g_rows.shape[0],), device=DEV, dtype=torch.int32)
    det_ms = eager_ms(torch, lambda: _segment_sum(g_rows, inv))
    atomic_ms = eager_ms(torch, lambda: torch.zeros_like(g_rows).index_add_(0, inv, g_rows))
    log(f"[8] gradient dedup [{g_rows.shape[0]}, {FULL_EMB}] (issued eagerly): deterministic "
        f"index_put_ (sorted) {det_ms * 1e3:.1f} us vs float-atomic index_add_ "
        f"{atomic_ms * 1e3:.1f} us [{card}]")
    out["dense_bitwise_equal"] = dense_equal
    out["segment_sum_ms"] = dict(deterministic=det_ms, atomic=atomic_ms)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from mmlrec_tpu_torch.ops import kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    card = card_line()
    log(f"[1] {card}")
    log(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    from mmlrec_tpu_torch.ops import cuda_build, row_gather

    libraries = (K.LIBRARY, row_gather.LIBRARY)
    t0 = time.perf_counter()
    built = [lib.path().exists() for lib in libraries]
    paths = cuda_build.build_all(libraries)
    for lib in libraries:
        lib.load()
    log(f"[2] {'found' if all(built) else 'built'} "
        f"{', '.join(p.name for p in paths)} in {time.perf_counter() - t0:.1f} s "
        "(one nvcc per source, in parallel)")
    for path in paths:
        ptxas = path.with_suffix(".log")
        if ptxas.exists():
            for line in ptxas.read_text().splitlines():
                if "registers" in line or "Compiling entry" in line:
                    log(f"[2] {line.strip()}")

    kernels = check_kernels(torch, K, card)
    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
    flagship = serve(torch, K, card, vocab=100, tag="4", workdir=workdir)
    production = serve(torch, K, card, vocab=1 << 16, tag="5", workdir=workdir)
    kernels.update(check_row_kernels(torch, card))
    step = step_card_vs_cpu(torch, K, card)
    full = full_width(torch, K, card)

    launches = {name: flagship["launches"][name] for name in REPLACES if name not in ROW_KERNELS}
    launches.update(rows_gather_dual=full["stacked"]["launches"]["rows_gather_dual"],
                    rows_write_dual=full["stacked"]["launches"]["rows_write_dual"],
                    rows_write=full["split"]["launches"]["rows_write"],
                    rows_gather_hbm=full["split"]["launches"]["rows_gather_hbm"])
    line = {"kernels": [
        dict(name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
             launches=launches[name], status="ok", **kernels[name])
        for name in REPLACES
    ], "serving": {"flagship_vocab_100": flagship, "production_vocab_65536": production},
        "two_phase_step_2p20_rows": step, "two_phase_step_40m_rows": full,
        "launches_counted_in": {"serving": "phase 4 (5 forwards)",
                                "rows_gather_dual, rows_write_dual": f"phase 8 stacked fit ({FULL_STEPS} steps)",
                                "rows_write, rows_gather_hbm": f"phase 8 split fit ({FULL_STEPS} steps)"},
        "card": card}
    print(json.dumps(line), flush=True)
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
