"""The experiment driver of the port: the sequential seed loop of the JAX
package's ``main.py`` (reference main.py:71-181) on PyTorch, on the card.

    python -m mmlrec_tpu_torch.main --config configs/msl/config_AE.json \
        [--synthetic] [--seed S | --seeds 0,2,4,8] [--vmap_seeds | --sweep_lrs 0.01,0.001]
        [--device cuda|cpu] [--data_parallel N [--model_parallel M]]

For each seed: read the config's train and test CSV files
(``data.ctrdataset``; with ``--synthetic``, synthetic data of the config's
schema instead), build the config's model, fit it with the config's batch
and epochs while validating on the
test split (on the device where ``training_config.device_eval`` asks for
it), save the best variables where ``save_config.save`` is set, dump the
named layer outputs as pickled float64 numpy arrays where
``save_config.save_layer_output`` is set, and append the row
``{"type", log_loss_i, auc_i, [total_auc], "examples_per_s"}`` to the
config's ``test_result_path``, every path relative to the working
directory as the config gives it.  ``--device`` (the reference's flag)
defaults to the card and raises without one; ``--device cpu`` runs the
plain versions of the kernels.

``--vmap_seeds`` with more than one seed trains the seeds as one suite
(``train/multi_seed.py``; one seed runs the plain loop, as main.py:109-113
decides), ``--sweep_lrs`` the (seed x lr) grid (``train/sweep.py``); each
member appends its row with the suite's wall seconds (``run_vmapped_suite``).

``--data_parallel N --model_parallel M`` trains each seed on an N x M mesh
(``parallel/``, main.py:95-113): data parallel over N, the fused table
row-sharded over M.  Outside a process group the command starts the N x M
processes itself (one card each with NCCL; ``--device cpu`` takes gloo),
under ``torchrun`` it joins the group there is.  Rank 0 alone prints and
writes the rows, checkpoints and pickles; ``--vmap_seeds`` and
``--sweep_lrs`` run the plain seed loop.
"""

from __future__ import annotations

import argparse
import os
import pickle
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .config import ExperimentConfig
from .data import CTRDataset, ctrdataset, get_test_mask
from .models import get_model
from .parallel import create_mesh
from .parallel.multihost import initialize_distributed, spawn_ranks
from .train import Trainer, resolve_table_container
from .train.metrics import masked_test_metrics
from .utils import append_result_row, set_seed


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m mmlrec_tpu_torch.main")
    p.add_argument("--seed", type=int, default=None,
                   help="single seed; default runs the reference seed suite")
    p.add_argument("--seeds", type=str, default="0,2,4,8",
                   help="comma-separated seed list (reference main.py:85)")
    p.add_argument("--run", type=bool, default=False)
    p.add_argument("--model_name", type=str, default="")
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--data_parallel", type=int, default=0,
                   help="data mesh axis size: N ranks (0 = no mesh)")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="model mesh axis size: the fused table row-sharded over M ranks")
    p.add_argument("--synthetic", action="store_true",
                   help="use synthetic data with the config's schema")
    p.add_argument("--synthetic_rows", type=int, default=20000)
    p.add_argument("--synthetic_vocab", type=int, default=100,
                   help="per-feature vocabulary for --synthetic data")
    p.add_argument("--vmap_seeds", action="store_true",
                   help="train the seeds as one suite (train/multi_seed.py)")
    p.add_argument("--sweep_lrs", type=str, default="",
                   help="comma-separated lrs: the (seed x lr) grid as one suite "
                        "(train/sweep.py)")
    p.add_argument("--device_eval", action="store_true",
                   help="validation and the final test metrics on the device "
                        "(train/device_metrics.py): only scalars reach the host")
    p.add_argument("--export_bundle", type=str, default="",
                   help="after training, export a serving bundle to "
                        "<dir>/<data>_<task>_<model>_<seed>/")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default: the card, raises without one) or cpu")
    return p.parse_args(argv)


def load_dataset(cfg: ExperimentConfig, args) -> CTRDataset:
    """The config's CSV files through ``ctrdataset`` (main.py:94-96), or with
    ``--synthetic`` synthetic train and test splits of the config's schema
    (main.py:77-93): ``--synthetic_rows`` training rows and a quarter as many
    test rows (at least 1000), from seeds 0 and 1."""
    if not args.synthetic:
        return ctrdataset(cfg)
    from .synthetic import make_data

    n_train, n_test = args.synthetic_rows, max(args.synthetic_rows // 4, 1000)
    v = args.synthetic_vocab
    layout, x_tr, y_tr, _ = make_data(cfg, n=n_train, seed=0, vocab=v)
    _, x_te, y_te, _ = make_data(cfg, n=n_test, seed=1, vocab=v)
    dc = cfg.data_config
    test_mask = None
    if cfg.model_config.task_name in ("msl", "mtmsl") and dc.mask_column:
        test_mask = get_test_mask(x_te[dc.mask_column], dc.mask_values, dc.num_domains)
    return CTRDataset(train_input=x_tr, test_input=x_te, y_train=y_tr, y_test=y_te,
                      test_mask=test_mask, feature_columns=layout.feature_columns,
                      layout=layout)


def _refuse_unported(args) -> None:
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to run the "
                           "plain versions of the kernels on the CPU")


def _rank_run(arg_values: Dict, rank: int, world: int) -> Optional[List[Dict]]:
    """One rank of a ``--data_parallel`` run the CLI started: rank 0's
    rows, None on the other ranks."""
    rows = [row for row, _ in run(argparse.Namespace(**arg_values))]
    return rows if rank == 0 else None


def _spawn_ranks(args) -> List[Tuple[Dict, None]]:
    """Start ``--data_parallel`` processes, one per rank, and wait for them;
    rank 0's rows, or RuntimeError with the first failure a rank reports."""
    n = args.data_parallel * args.model_parallel
    cuda = torch.device(args.device).type == "cuda"
    if cuda and n > torch.cuda.device_count():
        raise ValueError(f"mesh {n}x{args.model_parallel} on the card needs {n} cards (NCCL "
                         f"takes one rank a card), {torch.cuda.device_count()} are visible")
    rows = spawn_ranks(_rank_run, vars(args), n, cuda, f"--data_parallel {n}")
    return [(row, None) for row in rows]


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    """Run the CLI; returns the result rows it appended, one per seed."""
    return [row for row, _ in run(parse_args(argv))]


def run(args: argparse.Namespace) -> List[Tuple[Dict, object]]:
    """``main`` on parsed arguments: (row, trained Trainer) per seed of the
    loop, or (row, the suite) per member of a suite (main.py:109-113); for
    the ranks this command started, (row, None)."""
    _refuse_unported(args)
    seeds = [args.seed] if args.seed is not None else [int(s) for s in args.seeds.split(",")]
    if not args.data_parallel:
        if args.sweep_lrs:
            return run_vmapped_suite(args, seeds,
                                     lrs=[float(v) for v in args.sweep_lrs.split(",")])
        if args.vmap_seeds and len(seeds) > 1:
            return run_vmapped_suite(args, seeds)
        return run_seeds(args, seeds, None)
    cuda = torch.device(args.device).type == "cuda"
    initialize_distributed(backend="nccl" if cuda else "gloo")  # under torchrun: its group
    if not dist.is_initialized() and args.data_parallel * args.model_parallel > 1:
        return _spawn_ranks(args)
    created = not dist.is_initialized()
    if cuda and not created:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", dist.get_rank())))
    try:
        mesh = create_mesh(data=args.data_parallel, model=args.model_parallel,
                           device=args.device)
        return run_seeds(args, seeds, mesh)
    finally:
        if created:  # the group of one this command made
            dist.destroy_process_group()


def run_seeds(args, seeds: List[int], mesh) -> List[Tuple[Dict, object]]:
    """The sequential seed loop (main.py:115-181), data parallel over
    ``mesh`` when one is given (rank 0 prints and writes)."""
    lead = mesh is None or dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    out = []
    for seed in seeds:
        say("seed:", seed)
        generator = set_seed(seed, args.device)
        cfg = ExperimentConfig.from_file(args.config)
        if args.run and args.model_name:
            cfg.model_config.model_name = args.model_name
        if args.device_eval:
            cfg.training_config.extra["device_eval"] = True
        mc, dc, oc, tc, sc = (cfg.model_config, cfg.data_config, cfg.optim_config,
                              cfg.training_config, cfg.save_config)
        say(cfg.to_dict())

        ds = load_dataset(cfg, args)
        resolve_table_container(cfg, ds.layout, device=args.device, mesh=mesh)
        if mc.extra.get("table_container") == "stacked":
            say("table_container: stacked (auto: the packed-moment write path)")
        model = get_model(mc.model_name, ds.layout, cfg, generator=generator,
                          device=args.device)
        trainer = Trainer(model, seed=seed, mesh=mesh, device=args.device).compile(
            optimizer=oc.optimizer, loss=oc.loss, metrics=oc.metrics)
        shuffle = tc.extra.get("shuffle_mode", "full")
        trainer.fit(ds.train_input, ds.y_train, batch_size=tc.train_batch_size,
                    epochs=tc.epochs, validation_data=(ds.test_input, ds.y_test),
                    shuffle="block" if shuffle == "block" else True, verbose=int(lead))

        if sc.save_layer_output:
            trainer.update_save()
            pred_ans, layer_output_dict = trainer.predict(ds.test_input, tc.test_batch_size)
            for key, value in (layer_output_dict.items() if lead else ()):
                file_name = dc.layer_output_path + f"{mc.model_name}_l2{mc.l2_reg_dnn}_{key}.pkl"
                os.makedirs(os.path.dirname(os.path.abspath(file_name)), exist_ok=True)
                with open(file_name, "wb") as f:
                    pickle.dump(value, f)
        elif args.device_eval:
            pred_ans = None  # the final metrics on the device, no download
        else:
            pred_ans = trainer.predict(ds.test_input, tc.test_batch_size)

        if pred_ans is None:
            results = trainer.masked_test_metrics_device(
                ds.test_input, ds.y_test, ds.test_mask, tc.test_batch_size)
        else:
            results = masked_test_metrics(
                trainer._prepare_y(ds.y_test), pred_ans, mc.task_name, dc.num_domains,
                ds.test_mask, trainer.model.task_types)
        model_type = f"{dc.data_name}_{mc.task_name}_{mc.model_name}_{seed}"
        row = {"type": model_type, **results}
        if trainer.throughput_examples_per_s:
            row["examples_per_s"] = round(trainer.throughput_examples_per_s, 1)
        say(row)
        if lead:
            append_result_row(dc.test_result_path, row)
        out.append((row, trainer))

        if args.export_bundle and (lead or trainer._table_sharded()):
            from .serving import save_serving_bundle

            bundle_dir = os.path.join(args.export_bundle, model_type)
            meta = save_serving_bundle(trainer, bundle_dir)  # gathers a row-sharded table
            say(f"serving bundle -> {bundle_dir} (batch_mode={meta['batch_mode']})")
    return out


def run_vmapped_suite(args, seeds: List[int], lrs: Optional[List[float]] = None
                      ) -> List[Tuple[Dict, object]]:
    """Every seed (x every lr) as one suite (main.py:191-254): one fit, then
    one row per member, ``type`` ``{data}_{task}_{model}_{row label}`` (the
    seed, or ``{seed}_lr{lr}``) with the suite's wall seconds
    (``suite_wall_s``) in place of ``examples_per_s``; the final metrics on
    the device with ``--device_eval``."""
    from .train.multi_seed import SeedSuiteTrainer
    from .train.sweep import GridSweepTrainer

    cfg = ExperimentConfig.from_file(args.config)
    if args.run and args.model_name:
        cfg.model_config.model_name = args.model_name
    if args.device_eval:
        cfg.training_config.extra["device_eval"] = True
    mc, dc, oc, tc = cfg.model_config, cfg.data_config, cfg.optim_config, cfg.training_config
    print(cfg.to_dict())

    ds = load_dataset(cfg, args)
    # the container the sequential loop would take, so a sequential-shared
    # member equals that loop's run of its seed
    resolve_table_container(cfg, ds.layout, device=args.device)
    model = get_model(mc.model_name, ds.layout, cfg, generator=set_seed(seeds[0], args.device),
                      device=args.device)
    if lrs:
        print(f"(seed x lr) grid: seeds={seeds} lrs={lrs}")
        suite = GridSweepTrainer(model, seeds=seeds, lrs=lrs, device=args.device)
    else:
        print(f"seed suite: {seeds}")
        suite = SeedSuiteTrainer(model, seeds=seeds, device=args.device)
    suite.compile(optimizer=oc.optimizer, loss=oc.loss, metrics=oc.metrics)
    print(f"mode: {'sequential-shared' if suite.sequential else 'stacked'}")
    t0 = time.time()
    suite.fit(ds.train_input, ds.y_train, batch_size=tc.train_batch_size, epochs=tc.epochs,
              validation_data=(ds.test_input, ds.y_test))
    wall = time.time() - t0
    if args.device_eval:
        per_member = suite.masked_test_metrics_device(ds.test_input, ds.y_test, ds.test_mask,
                                                      tc.test_batch_size)
    else:
        preds = suite.predict(ds.test_input, tc.test_batch_size)
        y_test = suite.tr._prepare_y(ds.y_test)
        per_member = [masked_test_metrics(y_test, preds[si], mc.task_name, dc.num_domains,
                                          ds.test_mask, suite.tr.model.task_types)
                      for si in range(len(suite.row_labels))]
    out = []
    for si, label in enumerate(suite.row_labels):
        row = {"type": f"{dc.data_name}_{mc.task_name}_{mc.model_name}_{label}",
               **per_member[si], "suite_wall_s": round(wall, 1)}
        print(row)
        append_result_row(dc.test_result_path, row)
        out.append((row, suite))
    return out


if __name__ == "__main__":
    main()
