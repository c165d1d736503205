"""Where a training step's time goes on the card.

Builds one of the port's two steps with its weights drawn on the card,
warms it up, and traces ``--steps`` steps with torch.profiler:

* ``--fit two-phase`` (the default): the production-vocabulary step (MMoE
  mtl, 16 sparse x 2,500,000 ids x emb 32 = 40 M logical rows, P = 4, 4
  dense, experts (256, 128), gate (64,), tower (64,), batch 4096, bf16
  packed moments, in-step metadata), with ``--container`` stacked or split;
* ``--fit dense``: the dense-table step of the flagship (MMoE on the
  AliExpress-MSL shapes: 16 sparse x 100 ids x emb 8, 61 dense, 2 domains,
  the same towers, batch 4096, the masked loss, Adam over every parameter);
* ``--family <name>``: the dense-table step of another family at the same
  widths (mlp, sharedbottom, esmm, escm, escm_dr, hmoe, cross_stitch, aitm,
  ple, pcg; msl with 2 domains, or mtl with two tasks for esmm, escm,
  escm_dr and aitm), with BatchNorm when ``--bn`` is given; ``--family
  pcg`` trains with PCGrad;
* ``--knob KEY=VALUE`` (repeatable) sets a model_config key of a dense
  step, the value read as JSON (``--knob use_gradnorm=true``,
  ``--knob use_cagrad=true``, ``--knob use_cka_loss=true``);
* ``--varlen`` adds to a dense step a behaviour sequence of 50 ids from a
  [100000, 8] table, mean-pooled, id 0 past a length drawn in 1..50.

The steps run eagerly (``Trainer.train_step``: the path of ``scan_steps``
0), with the flat optimizer unless ``--per-tensor-optimizer`` asks for
``flat_optimizer: false``.  Prints, per step: the device time by kernel
(the largest first), the number of kernel launches, the device time in all,
the wall time and the host's largest self CPU times, and the device numbers
as one JSON line last.

    python -m mmlrec_tpu_torch.tools.profile_step [--fit two-phase|dense]
        [--family NAME [--bn]] [--knob KEY=VALUE] [--varlen]
        [--container stacked|split] [--steps 10]
        [--per-tensor-optimizer] [--trace step_trace.json]

Needs one CUDA device; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict

import numpy as np
import torch

VOCAB, FEATURES, EMB, DENSE, BATCH = 2_500_000, 16, 32, 4, 4096
HIST_VOCAB, HIST_MAXLEN = 100_000, 50  # --varlen's behaviour sequence
MTL_FAMILIES = ("esmm", "escm", "escm_dr", "aitm")  # two tasks, no domains


def build_trainer(container: str, flat: bool = True):
    from ..features import DenseFeat, FeatureLayout, SparseFeat
    from ..models import get_model
    from ..synthetic import make_config
    from ..train import Trainer
    from ..utils.seeding import make_generator

    cfg = make_config(task_name="mtl", model_name="mmoe", emb=EMB, n_sparse=FEATURES,
                      n_dense=DENSE, hidden=(256, 128), tower=(64,), gate=(64,),
                      batch_size=BATCH, two_phase_embedding=True, table_update="pallas",
                      table_opt_dtype="bfloat16", device_metadata=True,
                      table_container=container, flat_optimizer=flat,
                      monu_gather="pallas" if container == "split" else "xla")
    layout = FeatureLayout([SparseFeat(f"s{i}", VOCAB, EMB) for i in range(FEATURES)]
                           + [DenseFeat(f"d{i}", 1) for i in range(DENSE)])
    model = get_model("mmoe", layout, cfg, generator=make_generator(0, "cuda"), device="cuda")
    return Trainer(model, seed=0, device="cuda").compile()


def build_dense_trainer(family: str = "mmoe", use_bn: bool = False, flat: bool = True,
                        knobs=None, varlen: bool = False):
    from ..features import FeatureLayout, SparseFeat, VarLenSparseFeat
    from ..models import get_model
    from ..synthetic import aliexpress_like_config, make_data
    from ..train import Trainer
    from ..utils.seeding import make_generator

    task = "mtl" if family in MTL_FAMILIES else "msl"
    cfg = aliexpress_like_config(family, task_name=task, masked_loss=True, dnn_use_bn=use_bn,
                                 flat_optimizer=flat, **(knobs or {}))
    layout, *_ = make_data(cfg, n=8, vocab=100)
    if varlen:
        layout = FeatureLayout(list(layout.feature_columns) + [VarLenSparseFeat(
            SparseFeat("hist", HIST_VOCAB, 8), maxlen=HIST_MAXLEN, combiner="mean")])
    # the reference's init (std 1e-4) leaves every relu dead-flat; a wider
    # draw gives the backward its usual work
    model = get_model(family, layout, cfg, init_std=0.05, generator=make_generator(0, "cuda"),
                      device="cuda")
    return Trainer(model, seed=0, device="cuda").compile(metrics=[])


def _batches(n: int, dense_fit: bool, domains: bool = True, varlen: bool = False):
    """``n`` random batches on the card, as ``Trainer.train_step`` takes them."""
    rng = np.random.default_rng(40)
    vocab, n_dense = (100, 61) if dense_fit else (VOCAB, DENSE)
    out = []
    for _ in range(n):
        ids = rng.integers(0, vocab, (BATCH, FEATURES)).astype(np.int32)
        if varlen:
            lens = rng.integers(1, HIST_MAXLEN + 1, BATCH)
            hist = rng.integers(1, HIST_VOCAB, (BATCH, HIST_MAXLEN))
            hist = np.where(np.arange(HIST_MAXLEN)[None] < lens[:, None], hist, 0)
            ids = np.concatenate([ids, hist.astype(np.int32)], axis=1)
        dense = rng.random((BATCH, n_dense)).astype(np.float32)
        y = (rng.random((BATCH, 2)) < 0.3).astype(np.float32)
        dmask = (np.eye(2, dtype=np.float32)[rng.integers(0, 2, BATCH)]
                 if dense_fit and domains else None)
        out.append([None if a is None else torch.from_numpy(a).cuda()
                    for a in (ids, dense, y, dmask)] + [torch.ones(BATCH, device="cuda")])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fit", default="two-phase", choices=("two-phase", "dense"))
    ap.add_argument("--family", default=None, help="a family's dense step at the AE widths")
    ap.add_argument("--bn", action="store_true", help="with --family: dnn_use_bn on")
    ap.add_argument("--knob", action="append", default=[],
                    help="KEY=VALUE: a model_config key of the dense step (VALUE as JSON)")
    ap.add_argument("--varlen", action="store_true",
                    help="the dense step with a 50-long behaviour sequence")
    ap.add_argument("--container", default="stacked", choices=("stacked", "split"))
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--per-tensor-optimizer", action="store_true",
                    help="flat_optimizer: false (one optimizer chain per tensor)")
    ap.add_argument("--trace", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device is available", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    knobs = {k: json.loads(v) for k, v in (kv.split("=", 1) for kv in args.knob)}
    dense_fit = args.fit == "dense" or args.family is not None or bool(knobs) or args.varlen
    family = args.family or "mmoe"
    flat = not args.per_tensor_optimizer
    tr = (build_dense_trainer(family, args.bn, flat, knobs, args.varlen) if dense_fit
          else build_trainer(args.container, flat))
    what = (f"dense {family}{'+bn' if args.bn else ''}" if dense_fit else args.container) + (
        "" if flat else ", per-tensor optimizer") + "".join(
        f", {k}={v}" for k, v in knobs.items()) + (", varlen" if args.varlen else "")
    batches = _batches(args.steps + 5, dense_fit, domains=family not in MTL_FAMILIES,
                       varlen=args.varlen)
    for b in batches[:5]:
        tr.train_step(*b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[5:]:
            tr.train_step(*b)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    if args.trace:
        prof.export_chrome_trace(args.trace)
    by_kernel = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.name][0] += e.time_range.elapsed_us()
            by_kernel[e.name][1] += 1
    steps = args.steps
    busy_us = sum(v[0] for v in by_kernel.values()) / steps
    launches = sum(v[1] for v in by_kernel.values()) / steps
    card = torch.cuda.get_device_name(0)
    print(f"{what}: {steps} steps, wall {wall_s / steps * 1e3:.3f} ms per step, "
          f"device {busy_us / 1e3:.3f} ms per step ({busy_us / 1e3 / (wall_s / steps * 1e3):.1%} "
          f"busy), {launches:.0f} device launches per step [{card}]")
    rows = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])
    for name, (us, n) in rows[:30]:
        print(f"  {us / steps:9.1f} us  {n / steps:5.1f}x  {name[:110]}")
    host = sorted((e for e in prof.key_averages() if e.self_cpu_time_total > 0),
                  key=lambda e: -e.self_cpu_time_total)
    print(f"  host: {sum(e.count for e in host if e.key.startswith('aten::')) / steps:.0f} "
          f"aten calls per step; the largest self CPU times per step:")
    for e in host[:15]:
        print(f"  {e.self_cpu_time_total / steps:9.1f} us  {e.count / steps:5.1f}x  {e.key[:110]}")
    print(json.dumps({
        "fit": "dense" if dense_fit else args.fit, "family": family, "bn": args.bn,
        "knobs": knobs, "varlen": args.varlen,
        "flat_optimizer": flat,
        "container": None if dense_fit else args.container,
        "steps": steps, "wall_ms_per_step": wall_s / steps * 1e3,
        "device_ms_per_step": busy_us / 1e3, "launches_per_step": launches,
        "kernels": [{"name": name, "us_per_step": us / steps, "per_step": n / steps}
                    for name, (us, n) in rows],
        "device": card,
    }))
    return 0 if busy_us > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
