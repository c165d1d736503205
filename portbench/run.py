"""Run one cell of the port's benchmark once:

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration file, its
traffic mix and its metrics are found by name from ``BENCHMARK.json``; the
mix names the driver (``portbench/drivers/<driver>.py``) that builds the
system under test, warms it, runs the window and checks its outputs
against the plain reference.  With ``--trace 0`` the result carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, each
read by its own module ``portbench/metrics/<metric>.py`` from the
profile of the window.

The last line of standard output is the result as one JSON object; the
last lines of standard error give each number compared beside its limit.
The run exits with 3 and prints no result when the card or the count of
cards the cell asks for is missing, and with 4 when a module of JAX or of
the JAX package was loaded.
"""

import time

T0 = time.perf_counter()  # set-up is timed from here

import os  # noqa: E402

# one process with few threads: the host's work in a run (packing, host
# metadata, copies) is single-threaded, and idle pools of threads spinning
# beside it on the machine's 8 cores made the host-bound cells' runs spread
# more.  Set before numpy and torch are imported.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import copy  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Dict, List, Optional, Tuple  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level modules no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "mmlrec_tpu")


def forbidden_modules() -> List[str]:
    """The forbidden top-level names in ``sys.modules``, each compared whole
    (the part before the first dot), so ``mmlrec_tpu_torch`` passes."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> Dict:
    return _json(root / "BENCHMARK.json")


def cell_files(bench: Dict, workload: str) -> Tuple[Dict, Dict, Dict, Dict, Dict]:
    """(cell, configuration file, mix, limits, configuration entry) of a
    workload, each found by its name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json ({sorted(cells)})")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    spec = _json(ROOT / entry["file"])
    mix = _json(HERE / "mixes" / f"{cell['traffic']}.json")
    limits = _json(HERE / "limits" / f"{workload}.json")
    return cell, spec, mix, limits, entry


def applies(metric: Dict, cell: str, reported: List[str]) -> bool:
    """Whether ``metric`` is reported in ``cell``: it lists the cell, or it
    lists none and the cell reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def metric_module(name: str):
    """``portbench/metrics/<name>.py`` (a name may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{len(sys.modules)}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def scaled(spec: Dict, mix: Dict, scale: Optional[Dict]) -> Tuple[Dict, Dict]:
    """Copies of a configuration file and a mix with a test's smaller sizes
    (``vocab``, each slot's vocabulary capped at it, ``batch``,
    ``train_batches``, ``val_rows``, ``pool_rows``, ``requests``)."""
    spec, mix = copy.deepcopy(spec), copy.deepcopy(mix)
    for key, value in (scale or {}).items():
        if key == "vocab":
            assumed = spec["assumed"]
            if "vocabulary_sizes" in assumed:
                assumed["vocabulary_sizes"] = {c: min(int(v), value)
                                               for c, v in assumed["vocabulary_sizes"].items()}
            else:
                assumed["vocabulary_size"] = value
        elif key == "batch":
            spec["experiment"]["training_config"]["train_batch_size"] = value
        elif key == "requests":
            mix["requests"].update(value)
        else:
            mix[key] = value
    return spec, mix


def note(message: str) -> None:
    """A line on standard error with the seconds since the process began:
    where a run's set-up time goes."""
    print(f"[{time.perf_counter() - T0:8.2f} s] {message}", file=sys.stderr, flush=True)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             scale: Optional[Dict] = None, bench: Optional[Dict] = None) -> Dict:
    """One run of a cell; returns the result object (``checks`` last)."""
    from .reference.dims import dims

    bench = bench or benchmark()
    cell, spec, mix, limits, _ = cell_files(bench, workload)
    spec, mix = scaled(spec, mix, scale)
    driver = importlib.import_module(f"portbench.drivers.{mix['driver']}")
    ctx = SimpleNamespace(seed=int(seed), seconds=float(seconds), trace=bool(trace),
                          device=device, chips=int(cell["chips"]), spec=spec, mix=mix,
                          dims=dims(spec), t0=T0, note=note)
    out = driver.run(ctx)

    checks = {}
    for name, value in out["numbers"].items():
        if name not in limits["limits"]:
            raise KeyError(f"{workload}: no limit for {name!r} in limits/{workload}.json")
        checks[name] = {"value": value, "limit": limits["limits"][name]}
    correct = all(c["value"] <= c["limit"] for c in checks.values()) and not out["failed"]

    e2e = [m for m in bench["end_to_end"] if applies(m, workload, [])]
    reported = [m["name"] for m in e2e]
    metrics = {}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"]}
    if not trace:
        for m in e2e:
            value = out["e2e"].get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
        result["device"] = out["device"]
    else:
        layer_ctx = out["layer_ctx"]
        for m in bench["per_layer"]:
            if applies(m, workload, reported):
                value = metric_module(m["name"]).read(layer_ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        tr = out["trace"]
        result["metrics"] = metrics
        result["device"] = dict(out["device"], busy_s=tr.busy_s(), window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
    result["checks"] = checks
    return result


def _cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's own kernels build into ``build/torch_kernels/`` and
    ``build/native/`` already)."""
    base = ROOT / "build" / "portbench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(base / sub)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _cache_dirs()
    bench = benchmark()
    cell = {w["name"]: w for w in bench["workloads"]}[args.workload]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); {found} found",
              file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), bench=bench)
    bad = forbidden_modules()
    if bad:
        print(f"loaded modules of JAX or the JAX package: {bad}", file=sys.stderr)
        return 4
    print(f"correct: {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
