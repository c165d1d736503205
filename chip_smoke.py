#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (mmlrec_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with an H100 and nvcc:

    python3 chip_smoke.py

Phases (any mismatch or exception exits non-zero; no phase catches a
failure and carries on):

1. the card's name and power limit (nvidia-smi);
2. build csrc/recsys_kernels.cu for sm_90a, with the build seconds;
3. each kernel against its plain PyTorch version on the card at the
   flagship serving shapes: embed_concat bitwise, the mix and the score
   within atol 1e-6 / rtol 1e-5 (their sums run in another order); kernel
   and plain times (median of CUDA-event timings after warm-up), bytes
   moved and the bound;
4. serve the flagship MMoE (AliExpress-MSL widths, vocab 100) from a
   bundle loaded on the card: 4 requests of 4096 rows and one of 1000,
   held against the same bundle on the CPU (plain path) within atol 1e-5,
   with every kernel's launch count read around the requests;
5. the same at production vocabulary (16 features x 65,536 ids = 2^20
   fused rows, a lane-packed [65536, 128] table of 32 MB);
6. one JSON line with every kernel's numbers; the last line is the device
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
SOURCE = "mmlrec_tpu_torch/csrc/recsys_kernels.cu"
REPLACES = {
    "embed_concat": "mmlrec_tpu/ops/pallas_kernels.py:43",
    "gated_expert_mix": "mmlrec_tpu/ops/pallas_kernels.py:123",
    "multihead_score": "mmlrec_tpu/ops/pallas_kernels.py:164",
}


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

    for name, n in launches.items():
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

    t0 = time.perf_counter()
    built = K.library_path().exists()
    lib_path = K.build_kernels()
    K._lib()
    log(f"[2] {'found' if built else 'built'} {lib_path.name} in "
        f"{time.perf_counter() - t0:.1f} s")
    ptxas = lib_path.with_suffix(".log")
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "Compiling entry" in line:
                log(f"[2] {line.strip()}")

    kernels = check_kernels(torch, K, card)
    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
    flagship = serve(torch, K, card, vocab=100, tag="4", workdir=workdir)
    production = serve(torch, K, card, vocab=1 << 16, tag="5", workdir=workdir)

    line = {"kernels": [
        dict(name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
             launches=flagship["launches"][name], status="ok", **r)
        for name, r in kernels.items()
    ], "serving": {"flagship_vocab_100": flagship, "production_vocab_65536": production},
        "card": card}
    print(json.dumps(line), flush=True)
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
