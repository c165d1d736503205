"""The readings the limits of ``correct`` are set from, for one cell, in
one process on the card:

    python3 -m portbench.calibrate --workload <name> --seeds 12 --controls 3 \
        [--seconds 2] [--first-seed <n>]

For each of ``--seeds`` seeds the program's numbers against the reference
(the lower readings); for the first ``--controls`` of them the control's
(the reference in TF32, the precision just below the configuration's
float32, in the program's place) and, for a training cell, the fault of
half of each batch left out with the mean taken over the rest (the
reference so broken, in the program's place).  A training cell's
readings need no window; a serving cell's come from a short one
(``--seconds``) at the cell's own load.  One JSON line a reading, then a
summary line: per number the largest program reading and the smallest
control and fault readings.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

import torch

from .drivers import common
from .reference.compare import later_loss_gap, training_numbers, worst_leaves
from .reference.dims import dims
from .run import benchmark, cell_files, note, scaled


def _ctx(workload: str, seed: int, seconds: float, device: str, scale: Optional[Dict]):
    cell, spec, mix, _, _ = cell_files(benchmark(), workload)
    spec, mix = scaled(spec, mix, scale)
    return mix["driver"], SimpleNamespace(
        seed=seed, seconds=seconds, trace=False, device=device, chips=int(cell["chips"]),
        spec=spec, mix=mix, dims=dims(spec), t0=time.perf_counter(), note=note)


def readings(workload: str, seeds: List[int], controls: int, seconds: float = 2.0,
             device: str = "cuda", scale: Optional[Dict] = None) -> List[Dict]:
    out = []
    for i, seed in enumerate(seeds):
        kind, ctx = _ctx(workload, seed, seconds, device, scale)
        if kind == "train":
            from .drivers import train

            p = train.prelude(ctx)
            p.tr = None
            common.free(device)
            prog, ref = train.program(ctx, p), train.reference(ctx, p)
            numbers = training_numbers(*train._pairs(prog, ref))
            numbers["untouched_changed"] = float(p.untouched)
            rows = [{"seed": seed, "side": "program", **numbers,
                     "later_loss_gap": later_loss_gap(prog[0], ref[0]),
                     "leaves": worst_leaves(prog[1], ref[1], prog[2], ref[2])}]
            if i < controls:
                for side, kw in (("control", dict(tf32=True)), ("half_batch", dict(fault="half"))):
                    got = train.reference(ctx, p, **kw)
                    rows.append({"seed": seed, "side": side,
                                 **training_numbers(*train._pairs(got, ref)),
                                 "later_loss_gap": later_loss_gap(got[0], ref[0]),
                                 "leaves": worst_leaves(got[1], ref[1], got[2], ref[2])})
        else:
            from .drivers import serve

            r = serve.run(ctx)
            rows = [{"seed": seed, "side": "program", **r["numbers"]}]
            if i < controls:
                rows.append({"seed": seed, "side": "control",
                             **serve.check(ctx, *r["judged"], control=True)})
        for row in rows:
            print(json.dumps(row), flush=True)
        out += rows
        common.free(device)
    return out


def summary(rows: List[Dict]) -> Dict[str, Dict[str, float]]:
    """Per number: the largest program reading, the smallest of each other
    side's."""
    out: Dict[str, Dict[str, float]] = {}
    for row in rows:
        for k, v in row.items():
            if k in ("seed", "side", "leaves"):
                continue
            entry = out.setdefault(k, {})
            pick = max if row["side"] == "program" else min
            entry[row["side"]] = pick(entry.get(row["side"], v), v)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--first-seed", type=int, default=3_000_000_017)
    args = p.parse_args(argv)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    rows = readings(args.workload, seeds, args.controls, args.seconds)
    print(json.dumps({"summary": summary(rows), "workload": args.workload,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
