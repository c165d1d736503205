#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (mmlrec_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with an H100 and nvcc:

    python3 chip_smoke.py [--seed N]

``--seed`` draws phase 17's CSV files (default 17); the other phases use
fixed seeds of their own.

Phases (any mismatch or exception exits non-zero; no phase catches a
failure and carries on):

1. the card's name and power limit (nvidia-smi);
2. build csrc/recsys_kernels.cu, csrc/row_kernels.cu and
   csrc/probe_kernels.cu for sm_90a, one nvcc each, started together, with
   the build seconds;
3. the launch floor (an empty kernel replayed from a CUDA graph, as one
   warp, on embed_concat's grid and on multihead_score's); each forward
   kernel (B5-B7) against
   its plain PyTorch version on the card at the flagship serving shapes:
   embed_concat bitwise, the mix and the score within atol 1e-6 / rtol
   1e-5 (their sums run in another order); kernel and plain times (median
   of CUDA-event timings after warm-up), bytes moved and the bound;
   embed_concat bitwise on its vector body (the flagship and the
   lane-packed table, batches of 1000 and of 4090 rows, no dense block;
   out-of-range and negative ids in each) and on its scalar body (D = 6, a
   table view and a dense view off by 4 bytes, a batch of 3);
   multihead_score within atol 1e-6 / rtol 1e-5 on its vector body (the
   flagship, H = 128, H = 16, one task, six tasks, batches of 1000 and of
   3, a regression head) and on its scalar body (H = 62, a tower view off
   by 4 bytes), with its time beside the launch floor on its own grid;
   gated_expert_mix at the two shapes PLE gives it (batch B x T with one
   task over spec + shared experts; one task over all experts); then the
   backward of embed_concat (kernel forward, plain backward) against
   autograd of the plain version in both modes of the table cotangent:
   d_dense bitwise, d_table within 2e-6 of its largest entry (each row
   sums ~41 f32 cotangents of order 1, in another order: a few ulps of the
   sum), two runs bitwise equal, with the backward's device time;
4. serve the flagship MMoE (AliExpress-MSL widths, vocab 100) from a
   bundle loaded on the card: 4 requests of 4096 rows and one of 1000,
   held against the same bundle on the CPU (plain path) within atol 1e-5,
   with every kernel's launch count read around the requests;
5. the same at production vocabulary (16 features x 65,536 ids = 2^20
   fused rows, a lane-packed [65536, 128] table of 32 MB);
6. the row kernels B1-B4 of the two-phase step and the library functions
   B8-B10 against their plain versions at the step shapes of phase 8 (a
   [2, 10,000,000, 128] f32 container, K = 65,536 ids, the unique-row
   window with tail pads one past the last row): bitwise on every slot
   (B1 with ``n_real``: on the window's slots, and through its launch into
   a sentinel-filled output no byte outside the window stored, as under
   Mosaic), every row a write leaves alone untouched, and a guard region
   after each array intact; B10 also against B3's kernel, with n_real and
   with a [lo, hi) window; B8 as (add, set) on (table, monu), as all-add on
   three arrays, and one array at a time in every pair of element types (f32 or
   bf16 deltas into a bf16 or an f32 array, "set" on bf16 and on f32) with
   NaN, infinities, denormals and ties among rows and deltas and n_real
   short of K: on the wide path at the step shape (timed on replay, and
   on four sets of ids and deltas in turn so that the L2 is cold) and at
   32-wide rows, and on the path of one element a lane at 126-wide rows and
   on arrays that start 2 or 4 bytes off; kernel, plain and library-call
   times; then a few row updates
   driven through the public B8-B10 functions (gather + add + pipelined
   write == fused read-modify-write, bitwise), whose launches are the ones
   reported for those three;
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
9. the dense-table fit of the flagship at full width (MMoE on the
   AliExpress-MSL shapes: 16 sparse x emb 8, 61 dense, 2 domains, experts
   (256, 128), gate (64,), tower (64,), batch 4096, vocab 100, the masked
   loss, so that the summed heads stay probabilities and logloss is
   defined): (a) 3 steps, the last batch partial, on the card and on the
   CPU from one numpy init, with sigmoid DNNs (a relu pre-activation within
   rounding of zero makes the comparison one of rounding:
   ``_card_vs_cpu_state``): loss rtol 1e-5, at most 1e-4 of the dense
   weights over 1e-6 and none over 3 x lr, the table atol 5e-6, Adam's
   moments relative to each tensor's largest; (b) Trainer.fit on the card
   (relu) over 64 batches x 2 epochs with validation data and the metrics
   auc and logloss, then evaluate: one launch of embed_concat, its
   backward, the mix and the score per step and one of each forward per
   validation batch; evaluate reads the best epoch's snapshot; 20 timed
   steps as in phase 8;
10. the family sweep at full width: for each registry name of the port
   besides the flagship's (mlp, sharedbottom, esmm, escm, escm_dr, hmoe,
   cross_stitch, aitm, ple, pcg, snr_trans, mssm, star, apg, pepnet), for
   sharedbottom with BatchNorm, for star with BatchNorm and the masked loss
   (its DomainBatchNorm then runs), and for snr_trans with the wide logit,
   the AliExpress widths of phase 4 (msl with 2 domains, or mtl with two
   tasks where the family asks for it) with random numpy weights: a bundle
   saved, loaded on the card, two requests of 4096 rows and one of 1000
   held against the same bundle on the CPU within atol 1e-5, with the
   launches per forward asserted per family (embed_concat 1;
   multihead_score 1, or 0 for the families whose heads are no per-task
   product and with the wide logit; gated_expert_mix 1 for hmoe and pcg, 2
   per level for ple, else 0).  Then, for ple, sharedbottom with
   BatchNorm, star with BatchNorm (DomainBatchNorm, the masked loss) and
   mssm with BatchNorm: three dense steps, the last batch partial, card
   against CPU at phase 9's tolerances with sigmoid DNNs (running and
   population statistics atol 1e-6; a bias that feeds a BatchNorm and that
   layer's running mean are left out: ``_noise_driven``), and a fit of 16
   batches x 2 epochs on the card with the launches asserted, step time,
   device time, busy share and examples/s; the same fit for snr_trans with
   stochastic gates and one warmup epoch (the second epoch draws u on the
   card: the gates switched on, the alphas moved);
11. the shipped configurations as shipped, through the CLI
   (``mmlrec_tpu_torch.main``): (1) each of the 13 ``configs/**/*.json``,
   cut to 2 epochs of 512-row batches over 4096 synthetic rows, each in a
   temporary working directory, at the CLI's default vocabulary 100 (the
   two-phase configs take the scatter update, its (inv, rep) from numpy)
   and at 65,536 (they take the write kernel, B3 on (table, mu, nu), with
   host metadata from the native pass of ``native/step_metadata.cpp``,
   which must load); each run's row in the JAX schema, its CSV, its
   checkpoint where ``save`` is set and the layer-output pickles of
   ``msl/config_movielens.json``; (2) ``configs/msl/config_AE.json`` at
   vocab 131,072 (139,264 physical rows > Kp = 69,632: split container, f32
   moments, host metadata), batch 4096: 3 steps card vs CPU with sigmoid
   DNNs (phase 9's rule for the dense weights and the table, the table's
   moments within 1e-5 of each tensor's largest), B3's three-array f32
   write bitwise against its plain version at this shape with its times,
   and 16 steps as shipped timed with their host metadata; (3) checkpoints
   on the card: save and restore predict bitwise, a resumed fit equals the
   uninterrupted one bitwise, a stacked bf16 state restores into a split
   trainer bitwise; (4) validation metrics on the device against the host
   on the same predictions within 1e-5;
12. the JAX fit's default path (the staged dataset, ``scan_steps`` as
   CUDA-graph replay, the flat optimizer, host metadata built an epoch
   ahead on a worker): phase 9's flagship dense fit with dropout 0.2,
   ``snr_trans`` with stochastic gates (the second epoch drawing), phase
   8's 40 M-row stacked fit and ``configs/msl/config_AE.json`` at vocab
   131,072 with host metadata, each fitted twice from one init for 2
   epochs, staged with graph replay (``scan_steps`` 16) and staged eager
   (0), and held bitwise (parameters, buffers, optimizer states, losses);
   the dense and the AE fit also on the streaming path (the dataset over
   a cap of 0 bytes: pinned uploads on a side stream, host metadata on
   the prefetch worker) at ``prefetch_batches`` 2 and 1, each held bitwise
   against the staged eager fit; one eager step of each kind under
   ``torch.cuda.set_sync_debug_mode("error")`` (no step may synchronise:
   a graph cannot capture one); wall ms a step of the last epoch, the
   device time of a replayed step (a further graph fit whose last epoch's
   replays queue behind a spin, timed by the fit's events around them)
   and of an eager step (queued behind a spin), each fit's busy share
   from its own kind's device time, examples/s, graph replays, the host's
   ms by epoch and kernel launches per step; the eval program over 1-32
   batches with a fresh capture against eager (bitwise; what a capture
   costs ``predict``);
13. the production recipe of BASELINE.md:159-167 at phase 8's full width
   (the stacked [2, 10M, 128] container, bf16 packed moments,
   ``table_update: "pallas"``, host metadata from the native pass, which
   must run while numpy must not, ``shuffle="block"``, the staged path with
   graph replay, 16 batches x 2 epochs) on a uniform and a Zipf-1.1 id
   stream: auto resolves the gather route, in position space on the
   uniform stream and in slot space on the Zipf one (each batch's physical
   duplication printed); B1 and B2 launch once a step; on the uniform
   stream the scatter route (host metadata) from the same init must end
   bitwise equal to auto's gather route, and on the Zipf stream four arms
   from one init (gather + slot, gather + position, scatter +
   position, device metadata) and the slot arm once more with eager steps
   must end bitwise equal (both planes of the container, the dense
   parameters, the optimizer states, the losses), with at most two
   containers alive; an eager gather-route and slot step under
   ``set_sync_debug_mode("error")``; wall ms a step, a replayed step's
   device time and busy share (also of the other arms), examples/s,
   host metadata ms, the route lists' widths and the gradient sums' device
   time by either route; the card's f32 sqrt correctly rounded and how its
   ``index_put_`` accumulates; the recipe through the CLI
   (``config_AE.json`` with bf16 moments and block mode, as shipped
   otherwise: the stacked container, the write kernel and the gather route
   by auto); then card against CPU at phase 7's shapes and tolerances,
   3 steps each, for the gather route on both containers, slot space,
   split bf16 and f16 moments under the scatter and the unique update (f16:
   the moments and the loss, the dense weights by phase 9's loose rule, the
   update bitwise on identical inputs: its nu underflows, see
   ``_two_phase_card_vs_cpu``), and ``sparse_embedding_update`` on the
   dense fit (phase 9's rule for the dense weights; the table apart, at
   most ``SEU_TABLE_SHARE`` of its entries over 1e-6 and none over
   lr / 4), and the card's ValueError for f16 moments under the write
   kernel;
14. the per-task gradient methods, the CKA loss and a behaviour sequence at
   the flagship's full width (phase 9's MMoE, the masked loss): (a) as
   ``pcg``, with ``use_gradnorm``, with ``use_cagrad`` and with
   ``use_cka_loss``: three steps card against CPU with sigmoid DNNs
   (phase 9's rule, GradNorm's weights atol 1e-6), the forward kernels
   launched once a step and their plain backwards once per task (twice;
   once for CKA); a staged fit of 16 batches x 2 epochs (phase 12's config,
   dropout 0.2) replayed against eager bitwise, GradNorm's state included,
   GradNorm's fit resumed from its epoch-1 training state bitwise equal to
   the uninterrupted one, an eager step under
   ``set_sync_debug_mode("error")``, and a replayed
   step's device time beside phase 12's flagship; (b) the flagship's
   columns plus ``VarLenSparseFeat(SparseFeat("hist", 100000, 8),
   maxlen=50, combiner="mean")`` (id 0 as padding, lengths in 1..50):
   three requests served from a bundle on the card against the CPU within
   atol 1e-5 with each forward kernel launched once a forward, the
   embed-concat bitwise against its plain version at its dense width of
   69 (pooled + dense), the sequence table's cotangent
   (``segment_sum_rows``) against the card's ``index_put_`` with
   accumulate within 1e-5 of the largest entry with both device times,
   three steps card against CPU (phase 9's rule) and a staged fit replayed
   against eager bitwise;
15. one JSON line with every kernel's numbers (B5-B7 with their launches
   a suite step and their folded calls, phase 16), one with the dense fit,
   one with the families, one with the shipped configurations, one with
   the staged fits, one with the production recipe, one with phase 14, one
   with phase 16, one with phase 17, one with phase 18, one with phase 19;
   the card's name and power limit; the last line is the device line.
16. (run after phase 14, printed with phase 15's lines) the seed suite and
   the lr sweep (``train/multi_seed.py``, ``train/sweep.py``): (a) the
   flagship as a stacked suite of 4 seeds: 3 steps (sigmoid DNNs, dropout
   0.2, each member's masks its own) with each member held against its
   solo fit on the card by phase 9's rule, the table held as a dense
   weight (``_suite_vs_solo``); each folded forward kernel at the suite
   step's shapes against 4 separate plain calls (B7 bitwise, B5 / B6 atol
   1e-6 / rtol 1e-5), one launch a folded call, its device time beside 4
   separate kernel calls'; a staged suite fit (phase 12's config, 16
   batches x 2 epochs) with graph replay and eagerly, held bitwise, B5-B7
   and their plain backwards once a suite step; one eager suite step under
   ``set_sync_debug_mode("error")``; a replayed suite step's device time
   (its replays queued behind a spin) against 4 x phase 12's solo step,
   the busy share; the staged members against their solo fits; (b) a
   sequential-shared suite of the two-phase stacked step at phase 7's
   2^20 rows, 2 seeds, each member's best snapshot, losses and predictions
   bitwise equal to its solo fit, each seed's capture seconds, and
   ``reset_for_seed`` bitwise equal to the model the CLI draws; (c) a
   stacked 2 seeds x 2 lrs sweep on the flagship (dropout 0, 3 steps),
   each combination held against its solo fit at that lr by phase 9's
   rule scaled to the lr, the lrs' predictions apart; (d) the CLI:
   ``configs/example_synthetic_msl.json`` cut as in phase 11 with
   ``--seeds 0,2 --vmap_seeds`` against the loop's rows (the schema, a
   metric gap under 0.02), ``--sweep_lrs 0.01,0.001`` with the JAX
   labels, and ``configs/msl/config_AE.json`` with ``--vmap_seeds``
   (sequential-shared) whose rows equal the loop's.
17. (run after phase 16, printed with phase 15's lines) the CSV pipeline
   (``data.ctrdataset``): (a) the loader built from ``native/fast_csv.cpp``
   with g++ into ``build/native/`` at first use, its build seconds; (b) a
   CSV pair of ``configs/msl/config_AE.json``'s 81 columns at 500,000 +
   125,000 rows (~0.46 GB; 9-digit categorical values from pools of
   300,000, 10,000 and 100 distinct values, dense values as %.6g, one
   column as %.17g) read by the native loader (host seconds, rows/s,
   MB/s); its head of 50,000 + 12,500 rows read by both backends and held
   equal (codes, vocabs, labels, mask, the %.6g columns bitwise; the %.17g
   column parsed within rtol 1e-12, scaled within 1e-12 in f64 and bitwise
   in f32); the pair fitted through
   the CLI's functions, 1 epoch at the config's batch of 4096: the write
   kernel's route with native host metadata, the table's logical rows the
   summed vocabs, B3 and B6 once a step (B6 and B7 once more per evaluated
   batch); (c) each shipped config that names CSV files on a pair of its
   schema (4,096 + 1,024 rows; string columns for kuairec, iaac and
   amazon_new, whose paths send ``auto`` to the pandas-equivalent reader,
   checked by the codes' dtype) through the CLI, cut as in phase 11; (d)
   ``config_AE.json``'s pair card against CPU, 3 steps from one numpy init
   at phase 11's rule, and the CLI's row on the CPU in the card's schema;
   neither pandas nor scikit-learn imported.
18. (run after phase 17, printed with phase 15's lines) the probe kernels
   of ``benchmarks/`` (P1-P5, ``csrc/probe_kernels.cu``) at the scripts'
   full shapes: (a) the probe tool's three sub-commands
   (``python -m mmlrec_tpu_torch.tools.probe_rows``) run through its
   ``run`` with the launch counts reset just before: every variant's µs a
   launch (16 launches of fresh ids replayed from one CUDA graph), ns a
   row, byte bound, plain µs and library µs; the tool's own checks, which
   hold each kernel bitwise against its plain version over the whole
   output or array (a [10,000,000, 128] f32 table, K = 65,536 rows: P1 at
   every run length R = 1, 2, 4, 8, 16, two sets of fresh run starts each,
   written into a copy; P3 on sorted ids with repeats; a [2, 6,000,000,
   128] container for P2 on two sets of distinct ids and P4; a [k x
   2,500,000, 128] array for P5 at k = 2, 3 on two sets of distinct
   windows; a write's check after its sub-command's times); and each
   kernel's launches exactly the tool's (B9's too, the ``vmem`` variant);
   (b) each kernel in child processes of its own, on ids inside its array
   (bitwise equal to the plain version) and then on a negative id or on
   one past the end, either of which must stop the kernel and fail the
   process.
19. (run after phase 18, printed with phase 15's lines) data parallel
   (``mmlrec_tpu_torch/parallel``, ``Trainer(mesh=)``): (a) phase 12's
   flagship staged fit (dropout 0.2, graph replay with the collectives
   captured, 16 batches x 2 epochs) on a 1 x 1 mesh over NCCL held bitwise
   against the same fit without a mesh (parameters, buffers, optimizer
   states, losses, predictions), B5-B7 once a step, one eager
   data-parallel step under ``set_sync_debug_mode("error")``, a replayed
   step's device time with and without the mesh beside phase 12's, and the
   step's two collectives timed alone at their sizes; (b) two ranks on the
   one card over gloo (NCCL takes one rank a card; gloo's collectives on
   CUDA tensors pass through the host, so its steps run eagerly): MMoE
   with BatchNorm and STAR with DomainBatchNorm, dropout 0.2, 3 steps of
   4096 (the last partial) through the staged path (``distributed_take``),
   rank 0's training state restored on the CPU and held against the
   single-process fit of the same global batches by phase 9's rule in the
   form ``DP_RULE`` says, the ranks' losses equal, B5-B7 once a step a
   rank; and MMoE with BatchNorm without dropout, whose verdict by phase
   9's own form is reported, not held.
20. (run after phase 19, printed with phase 15's lines) the row-sharded
   table (``parallel/shard_embedding.py``, ``parallel/explicit_step.py``):
   (a) the production recipe's 40 M-row table (16 x 2.5 M ids x emb 32,
   P = 4, K = 65,536 ids a step) folded shard-major over four model shards
   in one process; each shard's update runs in turn with its own window
   (the stacked container in position space, uniform ids, and in slot
   space, Zipf-1.1 ids, both by the gather route; the split container's
   write-kernel update of packed bf16 and of f32 moments) and the
   assembled shards are held against the single-chip update of the same
   inputs (untouched rows bitwise, touched rows within 2 ulp), with each
   shard's µs and launches; then B1, B2 and B3 in window mode on one
   shard, its local ids negative before its window and past its rows
   after, bitwise against their plain versions (B1 on the window's slots,
   and no byte outside the window stored), with µs (B1 and its library
   call also cold: four batches' windows in turn) and byte bounds;
   (b) two ranks on the one card over gloo as a (data 1, model 2) mesh:
   the explicit two-phase fit of the flagship MMoE (vocab 2^16 a feature,
   the stacked pallas container shard-major) and the dense fit with the
   table row-sharded, 3 steps of 1024 each, rank 0's gathered training
   state and the predictions against the same fits in one process on the
   card; (c) one eager step of the explicit two-phase step (stacked pallas
   container, metadata in the step) on a 1 x 1 NCCL mesh under
   ``set_sync_debug_mode("error")``; (d) two ranks on the one card over
   gloo as a (data 1, model 2) mesh at the flagship's msl widths (vocab
   2^16 a feature, sigmoid DNNs, 3 steps of 4096): ``pcg``, MMoE with
   GradNorm, with CAGrad, with ``sparse_embedding_update``, and the CKA
   fit, rank 0's training state restored and held against the same fit in
   one process on the card (``sparse_embedding_update`` bitwise, the others
   by phase 9's rule with the table held as a dense weight, GradNorm's
   weights atol 1e-6), B5-B7 once a step a rank, and one eager step a
   rank under ``set_sync_debug_mode("error")`` with gloo's own collectives
   exempted.

Launches of a replayed CUDA graph are counted once per replay (the
wrappers count at capture, ``cuda_build.captured_launches``), so every
phase's launches per step read as they did eagerly.

TF32 is switched off for matrix products and cuDNN, so the card computes
in full f32 like the CPU reference.
"""

from __future__ import annotations

import csv
import itertools
import json
import os
import statistics
import subprocess
import sys
import tempfile
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
    "rows_update": "mmlrec_tpu_torch/csrc/row_kernels.cu",
    "row_gather": "mmlrec_tpu_torch/csrc/row_kernels.cu",
    "rows_write_pipelined": "mmlrec_tpu_torch/csrc/row_kernels.cu",
    "probe_rows_write": "mmlrec_tpu_torch/csrc/probe_kernels.cu",
    "probe_pairs_write": "mmlrec_tpu_torch/csrc/probe_kernels.cu",
    "probe_rows_gather": "mmlrec_tpu_torch/csrc/probe_kernels.cu",
    "probe_pairs_gather": "mmlrec_tpu_torch/csrc/probe_kernels.cu",
    "probe_window_add": "mmlrec_tpu_torch/csrc/probe_kernels.cu",
}
REPLACES = {
    "embed_concat": "mmlrec_tpu/ops/pallas_kernels.py:43",
    "gated_expert_mix": "mmlrec_tpu/ops/pallas_kernels.py:123",
    "multihead_score": "mmlrec_tpu/ops/pallas_kernels.py:164",
    "rows_gather_dual": "mmlrec_tpu/ops/pallas_gather.py:171",
    "rows_write_dual": "mmlrec_tpu/ops/pallas_scatter.py:532",
    "rows_write": "mmlrec_tpu/ops/pallas_scatter.py:194",
    "rows_gather_hbm": "mmlrec_tpu/ops/pallas_gather.py:90",
    "rows_update": "mmlrec_tpu/ops/pallas_scatter.py:397",
    "row_gather": "mmlrec_tpu/ops/pallas_gather.py:39",
    "rows_write_pipelined": "mmlrec_tpu/ops/pallas_scatter.py:349",
    "probe_rows_write": "benchmarks/probe_dma_issue_floor.py:88",
    "probe_pairs_write": "benchmarks/probe_dma_issue_floor.py:144",
    "probe_rows_gather": "benchmarks/probe_row_gather_scan.py:77",
    "probe_pairs_gather": "benchmarks/probe_row_gather_scan.py:122",
    "probe_window_add": "benchmarks/probe_pallas_row_windows.py:66",
}
ROW_KERNELS = ("rows_gather_dual", "rows_write_dual", "rows_write", "rows_gather_hbm")
# phase 18: each probe kernel -> the probe tool's sub-command and the
# variants that launch it (the first one's numbers stand in the kernels line)
PROBE_KERNELS = {  # ... and whether it writes (its check: CHECK_SETS launches, else 1)
    "probe_rows_write": ("dma-issue-floor", ("R1", "R2", "R4", "R8", "R16"), True),
    "probe_pairs_write": ("dma-issue-floor", ("dual",), True),
    "probe_rows_gather": ("row-gather-scan", ("hbm",), False),
    "probe_pairs_gather": ("row-gather-scan", ("dual",), False),
    "probe_window_add": ("row-windows", ("k3", "k2"), True),
}
LIBRARY_KERNELS = ("rows_update", "row_gather", "rows_write_pipelined")
# phase 8: the production-vocabulary step (benchmarks/bench_40m_table_update.py)
FULL_VOCAB, FULL_FEATURES, FULL_EMB, FULL_DENSE = 2_500_000, 16, 32, 4
FULL_STEPS = 20
LIBRARY_STEPS = 3  # phase 6: row updates driven through the public B8-B10 functions
DENSE_BATCHES, DENSE_EPOCHS, DENSE_VAL_BATCHES = 64, 2, 4  # phase 9 (b)
# phase 10: family -> (regime, gated_expert_mix launches per forward, multihead_score launches)
FAMILIES = {
    "mlp": ("msl", 0, 0), "sharedbottom": ("msl", 0, 1), "esmm": ("mtl", 0, 0),
    "escm": ("mtl", 0, 0), "escm_dr": ("mtl", 0, 0), "hmoe": ("msl", 1, 1),
    "cross_stitch": ("msl", 0, 1), "aitm": ("mtl", 0, 1), "ple": ("msl", 4, 1),
    "pcg": ("msl", 1, 1), "snr_trans": ("msl", 0, 1), "mssm": ("mtl", 0, 1),
    "star": ("msl", 0, 1), "apg": ("msl", 0, 1), "pepnet": ("msl", 0, 1),
}
FAMILY_REQUESTS = (4096, 4096, 1000)
FAMILY_ROUNDS = 7
FAMILY_BATCHES, FAMILY_EPOCHS = 16, 2
DEV = "cuda"  # the card every phase runs on
SCAN_GRAPH, STAGED_EPOCHS = 16, 2  # phase 12: the JAX default chunk, 2 epochs a fit
STEADY_EPOCHS = 6  # phase 12 (c): the AE graph fit once more, to its steady state
REPLAY_SPIN_MS = 300.0  # phase 12: the spin the timed epoch's replays queue behind
TWO_PHASE = dict(two_phase_embedding=True, table_update="pallas",
                 table_opt_dtype="bfloat16", device_metadata=True)


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_kernels(torch, K, card):
    """Phase 3: each kernel against its plain version at flagship shapes."""
    from mmlrec_tpu_torch.tools.timing import device_ms, eager_ms

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
    # what a launch alone costs here: an empty kernel through the same ctypes
    # route, replayed from the same kind of graph, as one warp and on
    # embed_concat's grid
    score_grid = K.multihead_score_grid(B, T, H, True)
    floor_ms = {f"{b}x{t}": device_ms(lambda b=b, t=t: K.empty_launch(b, t))
                for b, t in ((1, 32), K.embed_concat_grid(B))}
    score_floor = device_ms(lambda: K.empty_launch(*score_grid))
    log(f"[3] launch floor: an empty kernel replayed from a CUDA graph takes "
        f"{', '.join(f'{v * 1e3:.2f} us as {k}' for k, v in floor_ms.items())} per launch "
        f"[{card}]")
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
                lib_ms = device_ms(c["library"])
            ms, plain_ms = device_ms(c["run"]), device_ms(c["plain"])
            host_ms = eager_ms(c["run"])
        bound_ms, bound_by = bound(c["bytes"], c["flops"])
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
                             eager_ms=host_ms, bytes=c["bytes"], shapes=c["shapes"])
        log(f"[3] {name}: {c['shapes']}: max_abs_err {err:.3g}; device time: kernel "
            f"{ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, library "
            f"{'-' if lib_ms is None else f'{lib_ms * 1e3:.2f} us'}; kernel issued eagerly "
            f"{host_ms * 1e3:.2f} us; {c['bytes'] / 1e6:.2f} MB, bound "
            f"{bound_ms * 1e3:.2f} us ({bound_by}) [{card}]")
    ec, floor = results["embed_concat"], max(floor_ms.values())
    ec["launch_floor_ms"] = floor_ms
    log(f"[3] embed_concat: {ec['ms'] * 1e3:.2f} us = launch floor {floor * 1e3:.2f} us + "
        f"{(ec['ms'] - floor) * 1e3:.2f} us (bar: floor + 1.5 us and 4.0 us; byte bound "
        f"{ec['bound_ms'] * 1e3:.2f} us, below the floor) [{card}]")
    ec["paths"] = check_embed_paths(torch, K, card)
    sc = results["multihead_score"]
    sc["launch_floor_ms"], sc["grid"] = score_floor, list(score_grid)
    log(f"[3] multihead_score: {sc['ms'] * 1e3:.2f} us = launch floor {score_floor * 1e3:.2f} us on "
        f"its own grid {score_grid[0]}x{score_grid[1]} + {(sc['ms'] - score_floor) * 1e3:.2f} us "
        f"(bar: 2.5 us; byte bound {sc['bound_ms'] * 1e3:.2f} us, below the floor) [{card}]")
    sc["paths"] = check_score_paths(torch, K, card)
    results["gated_expert_mix"]["ple_shapes"] = check_mix_ple_shapes(torch, K, card)
    return results


def check_score_paths(torch, K, card):
    """Phase 3: multihead_score against its plain version on the kernel's
    vector body and on its scalar body, atol 1e-6 / rtol 1e-5 (the sum runs
    in another order), with the time of each timed shape."""
    from mmlrec_tpu_torch.tools.timing import device_ms

    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(17)
    cases = (  # what, B, T, H, binary mask, tower view off by 4 bytes, vector body, timed
        ("flagship [4096, 2, 64]", 4096, 2, 64, (1, 1), False, True, False),
        ("H = 128 (a family without a tower MLP)", 4096, 2, 128, (1, 1), False, True, True),
        ("H = 16", 4096, 2, 16, (1, 1), False, True, False),
        ("T = 1", 4096, 1, 64, (1,), False, True, False),
        ("T = 6", 4096, 6, 64, (1,) * 6, False, True, False),
        ("batch 1000", 1000, 2, 64, (1, 1), False, True, True),
        ("batch 3", 3, 2, 64, (1, 1), False, True, False),
        ("a regression head", 4096, 2, 64, (1, 0), False, True, False),
        ("H = 62", 4096, 2, 62, (1, 1), False, False, False),
        ("tower view off by 4 bytes", 4096, 2, 64, (1, 0), True, False, True),
    )
    out = {}
    for what, B, T, H, mask, shift, expect_vector, timed in cases:
        flat = torch.randn(B * T * H + 1, generator=g, device=dev)
        tower = (flat[1:] if shift else flat[:-1]).view(B, T, H)
        w = 0.2 * torch.randn(T, H, generator=g, device=dev)
        b = 0.5 * torch.randn(T, generator=g, device=dev)
        binary = torch.tensor(mask, dtype=torch.float32, device=dev)
        vector = K.multihead_score_vector_body(B * T, H, tower.data_ptr(), w.data_ptr())
        if vector != expect_vector:
            raise AssertionError(f"multihead_score ({what}): vector body {vector}, expected "
                                 f"{expect_vector}")
        with torch.inference_mode():
            got, want = K.multihead_score(tower, w, b, binary), K.multihead_score_plain(
                tower, w, b, binary)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)
            ms = device_ms(lambda: K.multihead_score(tower, w, b, binary)) if timed else None
        if 0 in mask and not (got[:, mask.index(0)].abs() > 1).any():
            raise AssertionError(f"multihead_score ({what}): the regression head looks squashed")
        err = float((got - want).abs().max())
        out[what] = dict(vector_body=vector, max_abs_err=err, ms=ms,
                         lanes=K.multihead_score_lanes(H) if vector else 32,
                         grid=list(K.multihead_score_grid(B, T, H, vector)))
        log(f"[3] multihead_score, {what}: {'vector' if vector else 'scalar'} body, "
            f"{out[what]['lanes']} lanes a row, grid {out[what]['grid']}; max_abs_err {err:.3g} "
            f"(atol 1e-6 / rtol 1e-5){'' if ms is None else f'; {ms * 1e3:.2f} us'} [{card}]")
    return out


def check_mix_ple_shapes(torch, K, card):
    """Phase 3: gated_expert_mix at the two shapes PLE gives it at the AE
    widths (T = 2, 3 specific and 2 shared experts of width 128, batch
    4096), against its plain version."""
    from mmlrec_tpu_torch.tools.timing import device_ms

    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(19)
    out = {}
    for what, B, E in (("per-task gates: batch B x T, one task, spec + shared experts",
                        FLAGSHIP_BATCH * 2, 3 + 2),
                       ("shared gate: one task over T x spec + shared experts",
                        FLAGSHIP_BATCH, 2 * 3 + 2)):
        logits = 2 * torch.randn(B, 1, E, generator=g, device=dev)
        experts = torch.randn(B, E, 128, generator=g, device=dev)
        with torch.inference_mode():
            got, want = K.gated_expert_mix(logits, experts), K.gated_expert_mix_plain(
                logits, experts)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)
            ms = device_ms(lambda: K.gated_expert_mix(logits, experts))
            plain_ms = device_ms(lambda: K.gated_expert_mix_plain(logits, experts))
        nbytes = 4 * (B * E + B * E * 128 + B * 128)
        bound_ms, _ = bound(nbytes, B * (2 * E * 128 + 4 * E))
        err = float((got - want).abs().max())
        out[f"[{B}, 1, {E}] x [{B}, {E}, 128]"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bytes=nbytes)
        log(f"[3] gated_expert_mix, PLE's {what}: logits[{B},1,{E}] experts[{B},{E},128]: "
            f"max_abs_err {err:.3g}; kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us; "
            f"{nbytes / 1e6:.2f} MB, bound {bound_ms * 1e3:.2f} us [{card}]")
    return out


def check_embed_paths(torch, K, card):
    """Phase 3: embed_concat against its plain version, bitwise, on the
    kernel's vector body and on its scalar body."""
    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(13)
    F, V = 16, 1664
    flagship = torch.randn(V, 8, generator=g, device=dev)
    packed = torch.randn(1 << 16, 128, generator=g, device=dev)  # [2^20, 8] in memory
    shifted = torch.randn(V * 8 + 1, generator=g, device=dev)[1:].view(V, 8)
    cases = (  # what, table, batch, dense columns, dense view off by 4 bytes, vector body
        ("flagship table, batch 4096", flagship, 4096, 61, False, "all"),
        ("lane-packed [65536, 128] table seen as [2^20, 8]", packed.view(-1, 8), 4096, 61,
         False, "all"),
        ("batch 1000", flagship, 1000, 61, False, "all"),
        ("batch 4090, B % 4 != 0", flagship, 4090, 61, False, "but the last tile"),
        ("batch 3", flagship, 3, 61, False, "none"),
        ("no dense block", flagship, 4096, 0, False, "all"),
        ("D = 6", torch.randn(V, 6, generator=g, device=dev), 4096, 61, False, "none"),
        ("table view off by 4 bytes", shifted, 4096, 61, False, "none"),
        ("dense view off by 4 bytes", flagship, 4096, 61, True, "none"),
    )
    out = {}
    for what, table, B, Nd, shift_dense, expect in cases:
        rows, D = table.shape
        ids = torch.randint(0, rows, (B, F), generator=g, device=dev, dtype=torch.int32)
        ids[0, 0], ids[1, 1], ids[2, 2] = rows + 5, -1, -2**31 + 1  # fill-mode rows
        dense = torch.rand(B * Nd + 1, generator=g, device=dev)
        dense = (dense[1:] if shift_dense else dense[:-1]).view(B, Nd)
        with torch.inference_mode():
            got, want = K.embed_concat(table, ids, dense), K.embed_concat_plain(table, ids, dense)
        torch.cuda.synchronize()
        vector_rows = K.embed_concat_vector_rows(
            B, D, F * D + Nd, table.data_ptr(), dense.data_ptr() if Nd else 0, got.data_ptr())
        if expect != {B: "all", 0: "none"}.get(vector_rows, "but the last tile"):
            raise AssertionError(f"embed_concat ({what}): {vector_rows} of {B} rows on the "
                                 f"vector body, expected {expect}")
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"embed_concat ({what}): kernel differs from the plain version")
        nan = torch.isnan(got)
        if not (nan[0, :D].all() and nan[2, 2 * D:3 * D].all() and int(nan.sum()) == 2 * D):
            raise AssertionError(f"embed_concat ({what}): fill-mode rows are wrong")
        out[what] = vector_rows
        log(f"[3] embed_concat, {what}: {vector_rows} of {B} rows on the vector body, the rest "
            f"on the scalar body; bitwise equal to the plain version, out-of-range and "
            f"negative ids included [{card}]")
    return out


def check_embed_backward(torch, K, card):
    """Phase 3, second half: embed_concat differentiated on the card."""
    from mmlrec_tpu_torch.tools.timing import device_ms, eager_ms

    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(3)
    B, F, D, Nd, vocab = FLAGSHIP_BATCH, 16, 8, 61, 100
    V = 1664  # 16 x 100 ids, padded to 128
    vocab_sizes = (vocab,) * F
    offsets = torch.arange(F, device=dev, dtype=torch.int32) * vocab
    table = torch.randn(V, D, generator=g, device=dev)
    ids = torch.randint(0, vocab, (B, F), generator=g, device=dev, dtype=torch.int32) + offsets
    dense = torch.rand(B, Nd, generator=g, device=dev)
    cot = torch.randn(B, F * D + Nd, generator=g, device=dev)
    stray = ids.clone()  # the scatter-add must drop the forward's NaN rows
    stray[0, 0], stray[1, 1], stray[2, 2] = V + 5, -1, -2**31 + 1

    def grads(fn, ids_, **kw):
        t, d = table.clone().requires_grad_(True), dense.clone().requires_grad_(True)
        return torch.autograd.grad(fn(t, ids_, d, **kw), (t, d), cot)

    out = {}
    for mode, ids_, kw in (("scatter", stray, {}),
                           ("matmul", ids, dict(matmul_grad=(vocab_sizes, offsets)))):
        K.reset_launch_counts()
        g_t, g_d = grads(K.embed_concat, ids_, **kw)
        if K.launch_counts["embed_concat"] != 1 or K.backward_counts["embed_concat"] != 1:
            raise AssertionError("embed_concat: the gradient did not go through the kernel "
                                 "forward and the plain backward once each")
        want_t, want_d = grads(K.embed_concat_plain, ids_)
        again_t, _ = grads(K.embed_concat, ids_, **kw)
        torch.cuda.synchronize()
        if not torch.equal(g_d.view(torch.int32), want_d.view(torch.int32)):
            raise AssertionError(f"embed_concat backward ({mode}): d_dense differs")
        if not torch.equal(g_t.view(torch.int32), again_t.view(torch.int32)):
            raise AssertionError(f"embed_concat backward ({mode}): two runs differ")
        err, largest = float((g_t - want_t).abs().max()), float(want_t.abs().max())
        if not err <= 2e-6 * largest:
            raise AssertionError(f"embed_concat backward ({mode}): d_table off by {err} of "
                                 f"{largest}")
        def backward():
            return K.embed_concat_backward(cot, ids_, V, D, kw.get("matmul_grad"))

        ms = eager_ms(backward, reps=11, inner=10)
        dev_ms = device_ms(backward, reps=11, inner=10)
        out[mode] = dict(d_table_max_abs_err=err, d_table_max_abs=largest, backward_eager_ms=ms,
                         backward_device_ms=dev_ms)
        log(f"[3] embed_concat backward ({mode}): kernel forward, plain backward vs autograd of "
            f"the plain version: d_dense bitwise, d_table max_abs_err {err:.3g} of "
            f"{largest:.3g} (tol 2e-6 of it), two runs bitwise equal; backward device time "
            f"{dev_ms * 1e3:.1f} us (CUDA-graph replay), launched eagerly {ms * 1e3:.1f} us "
            f"[{card}]")
    return out


def dense_fit(torch, K, card):
    """Phase 9: the dense-table fit of the flagship at full width."""
    from mmlrec_tpu_torch.convert import load_jax_variables
    from mmlrec_tpu_torch.models import get_model
    from mmlrec_tpu_torch.synthetic import aliexpress_like_config, make_data
    from mmlrec_tpu_torch.train import Trainer
    from mmlrec_tpu_torch.train.metrics import regime_eval

    cfg = aliexpress_like_config("mmoe", masked_loss=True)
    batch = cfg.training_config.train_batch_size
    forwards = ("embed_concat", "gated_expert_mix", "multihead_score")

    def trainer(layout, dev, cfg=cfg):
        model = get_model("mmoe", layout, cfg, device="cpu")
        load_jax_variables(model, _numpy_train_state(model, seed=10))
        return Trainer(model, seed=0, device=dev).compile(metrics=["auc", "logloss"])

    # ---- (a) 3 steps, the last partial, card against CPU, sigmoid DNNs
    # (see _card_vs_cpu_state for why not relu)
    smooth = aliexpress_like_config("mmoe", masked_loss=True, dnn_activation="sigmoid")
    n = 3 * batch - 1000
    layout, x, y, _ = make_data(cfg, n=n, vocab=100, seed=9)
    gpu, cpu = trainer(layout, DEV, smooth), trainer(layout, "cpu", smooth)
    K.reset_launch_counts()
    gpu.fit(x, y, batch_size=batch, epochs=1, verbose=0)
    torch.cuda.synchronize()
    launches = {**_per_step(K, 3), "embed_concat_backward": K.backward_counts["embed_concat"] / 3}
    cpu.fit(x, y, batch_size=batch, epochs=1, verbose=0)
    lg, lc = gpu.history[-1]["loss"], cpu.history[-1]["loss"]
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    worst, verdict = _card_vs_cpu_state(gpu, cpu, set(), cfg.optim_config.lr)
    log(f"[9] dense fit, card vs CPU, 3 steps of {batch} ({n} rows), sigmoid DNNs, table "
        f"{list(gpu.table.shape)}, cotangent by {gpu.model.embeddings.fused.table_grad_mode(batch * 16)}: "
        f"epoch loss card {lg:.9g} cpu {lc:.9g}; {verdict}; launches per step {launches} [{card}]")
    if worst["failed"] or int(gpu.opt_state.count) != 3:
        raise AssertionError("phase 9: the card's dense steps left the CPU's tolerance")
    for name in forwards + ("embed_concat_backward",):
        if launches.get(name) != 1:
            raise AssertionError(f"phase 9: {name} ran {launches.get(name)} times per step")
    del gpu, cpu

    # ---- (b) the fit on the card: 64 batches x 2 epochs, validation, evaluate
    n_val = DENSE_VAL_BATCHES * batch
    layout, x, y, _ = make_data(cfg, n=DENSE_BATCHES * batch + n_val, vocab=100, seed=11)
    cut = DENSE_BATCHES * batch
    x_tr, y_tr = {k: v[:cut] for k, v in x.items()}, y[:cut]
    val = ({k: v[cut:] for k, v in x.items()}, y[cut:])
    tr = trainer(layout, DEV)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    tr.fit(x_tr, y_tr, batch_size=batch, epochs=DENSE_EPOCHS, validation_data=val, verbose=0)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    steps = DENSE_BATCHES * DENSE_EPOCHS
    fit_launches = dict(K.launch_counts)
    backwards = K.backward_counts["embed_concat"]
    for name in forwards:  # once per step, once per validation batch
        if fit_launches[name] != steps + DENSE_EPOCHS * DENSE_VAL_BATCHES:
            raise AssertionError(f"phase 9: {name} launched {fit_launches[name]} times in the fit")
    if backwards != steps or any(fit_launches[k] for k in ROW_KERNELS + LIBRARY_KERNELS):
        raise AssertionError(f"phase 9: {backwards} backwards in {steps} steps, or a row kernel ran")
    K.reset_launch_counts()
    ev = tr.evaluate(*val, batch_size=batch)
    eval_launches = {k: K.launch_counts[k] for k in forwards}
    if set(eval_launches.values()) != {DENSE_VAL_BATCHES}:
        raise AssertionError(f"phase 9: evaluate launched {eval_launches}")
    preds = tr.predict(val[0], batch)
    if preds.shape != (n_val, 2) or not np.isfinite(preds).all() or preds.min() < 0 or preds.max() > 1:
        raise AssertionError("phase 9: predictions are not finite probabilities [N, 2]")
    again = regime_eval(tr.metric_fns, tr._prepare_y(val[1]), preds, "msl", 2)
    history = tr.history
    aucs = [h["val_auc"] for h in history]
    best = int(np.argmax(aucs))  # the first epoch at the maximum: strict '>'
    if ev != again or ev["auc"] != aucs[best] or set(ev) != {"auc", "logloss"}:
        raise AssertionError(f"phase 9: evaluate {ev} vs recomputed {again}, val_auc {aucs}")
    if (tr.best_variables is None) or not all(np.isfinite(list(h.values())).all() for h in history):
        raise AssertionError("phase 9: no best snapshot, or a log that is not finite")
    last_is_best = all(torch.equal(v, dict(tr.model.named_parameters())[k])
                       for k, v in tr.best_variables.items())
    if last_is_best != (best == len(aucs) - 1):
        raise AssertionError("phase 9: best_variables is not the epoch with the best val_auc")
    # the card's predictions against the plain path on the CPU, same weights
    cpu_model = get_model("mmoe", layout, cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in tr.best_variables.items()})
    cpu_preds = Trainer(cpu_model, device="cpu").compile(metrics=["auc", "logloss"]).predict(
        val[0], batch)
    np.testing.assert_allclose(preds, cpu_preds, atol=1e-5, rtol=0)
    cpu_ev = regime_eval(tr.metric_fns, tr._prepare_y(val[1]), cpu_preds, "msl", 2)
    np.testing.assert_allclose([ev["auc"], ev["logloss"]], [cpu_ev["auc"], cpu_ev["logloss"]],
                               atol=1e-4, rtol=0)

    ids, dense = tr.pack_inputs(x_tr)
    dmask, yy = tr._domain_mask_from(x_tr), tr._prepare_y(y_tr)
    batches = []
    for s in range(FULL_STEPS):
        sl = slice(s * batch, (s + 1) * batch)
        batches.append([torch.from_numpy(a[sl]).to(DEV) for a in (ids, dense, yy, dmask)]
                       + [torch.ones(batch, device=DEV)])
    step_ms, dev_ms = _timed_steps(torch, tr, batches)
    med = statistics.median(step_ms)
    busy = None if dev_ms is None else dev_ms / med
    log(f"[9] dense fit on the card: {DENSE_BATCHES} batches x {DENSE_EPOCHS} epochs of {batch} "
        f"+ {DENSE_VAL_BATCHES} validation batches per epoch in {fit_s:.2f} s "
        f"({tr.throughput_examples_per_s:.0f} examples/s through Trainer.fit, first epoch left "
        f"out); history {[{k: round(v, 5) for k, v in h.items()} for h in history]}; best epoch "
        f"{best + 1}; evaluate {ev} == the metrics of predict(); max |card - cpu| of the "
        f"predictions {float(np.abs(preds - cpu_preds).max()):.3g}; launches in the fit "
        f"{ {k: v for k, v in fit_launches.items() if v} }, embed_concat backwards {backwards}, "
        f"in evaluate {eval_launches}; median step {med:.3f} ms (CUDA events, min "
        f"{min(step_ms):.3f}) = {batch / med * 1e3:.0f} examples/s; step device time "
        f"{'not measured' if dev_ms is None else f'{dev_ms:.3f} ms'}, device busy "
        f"{'not measured' if busy is None else f'{busy:.1%}'} [{card}]")
    return dict(card_vs_cpu=dict(loss_card=lg, loss_cpu=lc, **worst, launches_per_step=launches),
                fit_s=fit_s, fit_examples_per_s=tr.throughput_examples_per_s, history=history,
                best_epoch=best + 1, evaluate=ev, launches_in_fit=fit_launches,
                embed_concat_backwards=backwards, launches_in_evaluate=eval_launches,
                step_ms_median=med, step_ms=step_ms, examples_per_s=batch / med * 1e3,
                step_device_ms=dev_ms, device_busy_share=busy,
                predictions_max_abs_err_vs_cpu=float(np.abs(preds - cpu_preds).max()))


def _set_leaf(tree, key, value):
    node = tree
    for part in key.split(".")[:-1]:
        node = node.setdefault(part, {})
    node[key.split(".")[-1]] = value


def _numpy_batch_stats(model, seed: int):
    """A flax-style ``batch_stats`` tree for ``model``'s BatchNorm buffers
    (empty without BatchNorm): running and population means std 0.1,
    variances in [0.5, 2]."""
    rng = np.random.default_rng(seed)
    params = {k for k, _ in model.named_parameters()}
    tree = {}
    for key, buf in model.state_dict().items():
        if key not in params:
            shape = tuple(buf.shape)
            value = (rng.uniform(0.5, 2.0, shape) if key.endswith("var")
                     else rng.normal(0.0, 0.1, shape))
            _set_leaf(tree, key, value.astype(np.float32))
    return tree


def _leaf_draw(rng, key: str, shape):
    """One numpy leaf of a model's weights: He-scaled kernels, mixing
    matrices and gate transforms; STAR's two factors of a weight each the
    square root of that scale; gate locations in (0.3, 2) and u in (0.05,
    0.95), inside their clip bounds; activation slopes in (0.05, 0.5);
    BatchNorm scales and DomainBatchNorm gammas around 1; the rest std 0.1."""
    parts = key.split(".")
    leaf = parts[-1]
    if leaf == "alpha":
        if parts[-2].startswith(("prelu", "dice")):
            return rng.uniform(0.05, 0.5, shape)
        return rng.uniform(0.3, 2.0, shape)
    if leaf == "u":
        return rng.uniform(0.05, 0.95, shape)
    if leaf in ("kernel", "cross_stitch_weight", "trans") or leaf.startswith("w_"):
        std = np.sqrt(2.0 / shape[-2])
    elif leaf in ("specific_kernel", "shared_kernel"):
        std = (2.0 / shape[-2]) ** 0.25
    else:
        std = 0.1
    return rng.normal(1.0 if leaf in ("scale", "gamma") else 0.0, std, shape)


def numpy_variables(model, seed: int):
    """A flax-style {"params": ..., "batch_stats": ...} tree of numpy weights
    for ``model`` (``_leaf_draw``), the table std 0.3."""
    rng = np.random.default_rng(seed)
    tree = {}
    for key, p in model.named_parameters():
        shape = tuple(p.shape)
        value = (rng.normal(0.0, 0.3, shape) if key.endswith("table")
                 else _leaf_draw(rng, key, shape))
        _set_leaf(tree, key, value.astype(np.float32))
    return {"params": tree, "batch_stats": _numpy_batch_stats(model, seed + 1000)}


def serve(torch, K, card, vocab: int, tag: str, workdir: str):
    """Phases 4 and 5: a bundle served on the card, held against the CPU."""
    from mmlrec_tpu_torch.convert import load_jax_variables
    from mmlrec_tpu_torch.models import get_model
    from mmlrec_tpu_torch.serving import ServingBundle, _pack_from_schema, save_serving_bundle
    from mmlrec_tpu_torch.synthetic import aliexpress_like_config, make_data
    from mmlrec_tpu_torch.tools.timing import device_ms, eager_ms

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
            forward[len(ids)] = dict(device_ms=device_ms(fn, reps=15, inner=10),
                                     eager_ms=eager_ms(fn, reps=15, inner=10))
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
    from mmlrec_tpu_torch.tools.timing import device_ms, eager_ms

    return device_ms(fn) if capturable else eager_ms(fn, reps=11, inner=5)


UPDATE_FORMS = (  # name, array dtype, delta dtype, mode
    ("f32_into_bf16", "bfloat16", "float32", "add"),
    ("bf16_into_bf16", "bfloat16", "bfloat16", "add"),
    ("bf16_into_f32", "float32", "bfloat16", "add"),
    ("bf16_set", "bfloat16", "bfloat16", "set"),
    ("f32_into_f32", "float32", "float32", "add"),
    ("f32_set", "float32", "float32", "set"),
)
# f32 values whose sums and roundings have a corner each: zeros, infinities,
# NaNs (quiet, signalling, negative), denormals, bf16 ties, the largest
SPECIAL_F32 = (
    0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00001, 0x7F800001,
    0x00000001, 0x80000001, 0x007FFFFF, 0x00010000, 0x00018000, 0x3F808000, 0x3F818000,
    0x3F807FFF, 0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F8000)
# bf16 pairs (old, delta): a tie to even downwards and one upwards, a negative
# sum, an overflow to infinity, a denormal sum, and inf - inf
SPECIAL_BF16_PAIRS = ((0x3F80, 0x3B80), (0x3F81, 0x3B80), (0xBF80, 0x3B80), (0x7F7F, 0x7F7F),
                      (0x0001, 0x0001), (0x7F80, 0xFF80))


def _check_update_pairs(torch, S, g, card, V, W, ids, n_real, n, *, offset, expect_wide, timed):
    """Phase 6, B8: every form of UPDATE_FORMS on fresh ``[V, W]`` arrays
    that start ``offset`` elements into their buffer, against the plain
    version: bitwise on every row, guard rows after the array intact, slots
    at or past ``n_real`` skipped.  The first four slots carry the special
    values as old rows against zero deltas, as deltas against zero rows, and
    against each other.  Returns ``{form: numbers}``; when ``timed``, with
    the device time of the replayed call (``ms``: the same ids and deltas
    every time, as every kernel here is timed) and of calls that take four
    disjoint sets of ids and deltas in turn (``cold_ms``)."""
    from mmlrec_tpu_torch.tools.timing import device_ms

    dev = torch.device(DEV)
    K, guard_rows = ids.shape[0], 64
    f32_bits = torch.tensor(SPECIAL_F32, dtype=torch.int64, device=dev).to(torch.int32)
    pairs = torch.tensor(SPECIAL_BF16_PAIRS, dtype=torch.int32, device=dev)

    def from_bits(bits32, dtype):  # f32 bit patterns as `dtype` (bf16: their high halves)
        if dtype == torch.bfloat16:
            return S.bits_as_bf16((bits32 >> 16) & 0xFFFF)
        return bits32.view(torch.float32)

    def fresh(rows, dtype, start):
        flat = torch.empty(start + rows * W, dtype=dtype, device=dev)
        return flat.normal_(generator=g)[start:].view(rows, W)

    rows4 = ids[:4].long()
    if timed:
        cold_ids = torch.randperm(V - 1, generator=g, device=dev)[:4 * K].to(torch.int32).view(4, K)
        cold_ids[:, n:] = V
    out = {}
    for form, a_name, d_name, mode in UPDATE_FORMS:
        a_dtype, d_dtype = getattr(torch, a_name), getattr(torch, d_name)
        whole = fresh(V + guard_rows, a_dtype, offset)
        array, guard = whole[:V], whole[V:].clone()
        delta = fresh(K, d_dtype, 0)
        sa, sd = from_bits(f32_bits, a_dtype), from_bits(f32_bits, d_dtype)
        ns, npair = sa.numel(), pairs.shape[0]
        if W < ns:
            raise AssertionError(f"rows of {W} elements cannot hold the {ns} special values")
        array[rows4[0], :ns], delta[0, :ns] = sa, 0.0
        array[rows4[1], :ns], delta[1, :ns] = 0.0, sd
        array[rows4[2], :ns], delta[2, :ns] = sa, sd.flip(0)
        array[rows4[3], :npair] = from_bits(pairs[:, 0] << 16, a_dtype)
        delta[3, :npair] = from_bits(pairs[:, 1] << 16, d_dtype)
        masks = None
        if mode == "set":  # the deltas are the values: any bits; the mask a value
            mask = (torch.rand((K, W), generator=g, device=dev) > 0.5).to(a_dtype)
            mask[:, 0], mask[:, 1] = -0.0, float("nan")  # a zero, and not a zero
            masks = (mask,)
        plain = array.clone()

        def run(target=array):
            return S.rows_update((target,), ids, (delta,), modes=(mode,), masks=masks,
                                 n_real=n_real)

        run()
        S.rows_update_plain((plain,), ids, (delta,), modes=(mode,), masks=masks, n_real=n_real)
        torch.cuda.synchronize()
        es, des = array.element_size(), delta.element_size()
        wide = S.update_lane_run(
            W, es, des, array.data_ptr(), delta.data_ptr(), delta.stride(0) * des,
            masks[0].data_ptr() if masks else 0, masks[0].stride(0) * es if masks else 0) > 1
        if wide != expect_wide:
            raise AssertionError(f"rows_update ({form}, width {W}, offset {offset}): "
                                 f"wide path {wide}, expected {expect_wide}")
        as_int = torch.int16 if es == 2 else torch.int32
        if not (torch.equal(array.view(as_int), plain.view(as_int))
                and torch.equal(whole[V:].view(as_int), guard.view(as_int))):
            raise AssertionError(f"rows_update ({form}, width {W}, offset {offset}) differs "
                                 "from its plain version or wrote past the array")
        nbytes = 4 + 4 * n + n * W * (2 * es + des + (es if masks else 0))
        out[form] = dict(wide=wide, bytes=nbytes, bound_ms=bound(nbytes, 0)[0])
        if timed:
            out[form]["ms"] = device_ms(run)
            # the replay above updates the same rows with the same deltas, so
            # whatever of them fits the 50 MB L2 stays there; four disjoint
            # sets of ids, deltas and masks taken in turn find the cache cold
            turn = itertools.cycle([
                (c_ids, fresh(K, d_dtype, 0), masks and (masks[0].roll(i + 1, 0),))
                for i, c_ids in enumerate(cold_ids)])

            def run_cold():
                c_ids, c_delta, c_masks = next(turn)
                return S.rows_update((array,), c_ids, (c_delta,), modes=(mode,), masks=c_masks,
                                     n_real=n_real)

            out[form]["cold_ms"] = device_ms(run_cold)
        del whole, array, plain, delta, masks
    path = "a lane's run of elements per access" if expect_wide else "one element a lane"
    times = "".join(f"; {k} {v['ms'] * 1e3:.2f} us, cold {v['cold_ms'] * 1e3:.2f} us (bound "
                    f"{v['bound_ms'] * 1e3:.2f})" for k, v in out.items() if "ms" in v)
    if times:
        times += "; cold: four disjoint sets of ids, deltas and masks in turn, beyond the L2"
    log(f"[6] rows_update on [{V},{W}] arrays {offset} elements into their buffers, ids[{K}] "
        f"window [0, {n}): {', '.join(out)} all on the path of {path}, bitwise equal to the "
        f"plain version with NaN, infinities, denormals and ties, guard rows intact{times} "
        f"[{card}]")
    return out


def check_row_kernels(torch, card):
    """Phase 6: B1-B4 against their plain versions at the step shapes."""
    from mmlrec_tpu_torch.ops import cuda_build
    from mmlrec_tpu_torch.ops import row_gather as G
    from mmlrec_tpu_torch.ops import row_scatter as S
    from mmlrec_tpu_torch.tools.timing import device_ms
    from mmlrec_tpu_torch.tools.tune_kernels import check_gather_window
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

    # ---- B1: dual gather, the stacked step's phase 1 (no window: the whole
    # output) and the slot-space form (unique rows, n_real window: nothing
    # stored on the pads)
    got = G.rows_gather_dual(base, phys)
    if not same_bits(got, G.rows_gather_dual_plain(base, phys)):
        raise AssertionError("rows_gather_dual differs from its plain version")
    check_gather_window(base, pids, "rows_gather_dual with n_real", n_real=nuniq)
    log(f"[6] rows_gather_dual with n_real: the window [0, {n}) of {K} slots bitwise equal to "
        f"the plain version; no byte of the {K - n} slots outside it stored (a sentinel-filled "
        f"output) [{card}]")
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

    def equal_and_guarded(what):
        torch.cuda.synchronize()
        if not same_bits(kernel_out, plain_out) or not same_bits(buf[2 * V:], guard):
            raise AssertionError(f"{what}: differs from its counterpart, touched a row outside "
                                 "the window, or wrote past the arrays")

    # ---- B9: the staged single-array gather; also against B4's kernel
    got = G.row_gather(table, phys)
    if not (same_bits(got, G.row_gather_plain(table, phys))
            and same_bits(got, G.rows_gather_hbm(table, phys))):
        raise AssertionError("row_gather differs from its plain version or from rows_gather_hbm")
    results["row_gather"] = dict(
        run=lambda: G.row_gather(table, phys),
        plain=lambda: G.row_gather_plain(table, phys), plain_capturable=True,
        library=lambda: table.index_select(0, phys),
        bytes=4 * K + 4 * W * (u_phys + K), shapes=f"table[{V},{W}] ids[{K}]")

    # ---- B10: the pipelined write against its plain version and against
    # B3's kernel, with n_real and with a [lo, hi) window
    arrays_k, arrays_p = (kernel_out[0], kernel_out[1]), (plain_out[0], plain_out[1])
    lohi = torch.tensor([n // 3, 2 * n // 3], dtype=torch.int32, device=dev)
    for window, other, what in (
            (dict(n_real=nuniq), S.rows_write_pipelined_plain, "plain version, n_real"),
            (dict(bounds=lohi), S.rows_write_pipelined_plain, "plain version, [lo, hi)"),
            (dict(n_real=nuniq), S.rows_write, "rows_write's kernel, n_real"),
            (dict(bounds=lohi), S.rows_write, "rows_write's kernel, [lo, hi)")):
        fresh = torch.randn((2, K, W), generator=g, device=dev)
        S.rows_write_pipelined(arrays_k, pids, (fresh[0], fresh[1]), **window)
        other(arrays_p, pids, (fresh[0], fresh[1]), **window)
        equal_and_guarded(f"rows_write_pipelined vs {what}")
    results["rows_write_pipelined"] = dict(
        run=lambda: S.rows_write_pipelined(arrays_k, pids, (vt, vm), n_real=nuniq),
        plain=lambda: S.rows_write_pipelined_plain(arrays_p, pids, (vt, vm), n_real=nuniq),
        plain_capturable=False, library=index_copy_each,
        bytes=8 + 4 * n + 2 * 2 * 4 * W * n,
        shapes=f"(table, monu) 2 x [{V},{W}] ids[{K}] window [0, {n})")

    # ---- B8: the fused read-modify-write, three forms
    # (a) table "add", monu "set" (opaque lanes) with the n_real window
    d_t = torch.randn((K, W), generator=g, device=dev)
    d_m = torch.randint(-2**31, 2**31 - 1, (K, W), generator=g, device=dev,
                        dtype=torch.int64).to(torch.int32).view(torch.float32)
    mask = (torch.rand((K, W), generator=g, device=dev) > 0.5).float()
    mask[:, 0], mask[:, 1] = -0.0, float("nan")  # a zero, and not a zero
    S.rows_update(arrays_k, pids, (d_t, d_m), modes=("add", "set"), masks=(None, mask),
                  n_real=nuniq)
    S.rows_update_plain(arrays_p, pids, (d_t, d_m), modes=("add", "set"), masks=(None, mask),
                        n_real=nuniq)
    equal_and_guarded("rows_update (add, set)")
    add_set_bytes = 4 + 4 * n + (3 + 4) * 4 * W * n
    add_set_ms = device_ms(lambda: S.rows_update(
        arrays_k, pids, (d_t, d_m), modes=("add", "set"), masks=(None, mask), n_real=nuniq))
    plain_out.copy_(kernel_out)  # the timing replayed the update on one side only
    # (b) all-"add" on three arrays (the JAX package's rows-add benchmark form)
    third = torch.empty((V + guard_rows, W), dtype=torch.float32, device=dev)
    third.normal_(generator=g)
    third_guard = third[V:].clone()
    third_plain = third[:V].clone()
    d_3 = torch.randn((K, W), generator=g, device=dev)
    d_n = torch.randn((K, W), generator=g, device=dev)
    S.rows_add((*arrays_k, third[:V]), pids, (d_t, d_3, d_n), n_real=nuniq)
    S.rows_update_plain((*arrays_p, third_plain), pids, (d_t, d_3, d_n), n_real=nuniq)
    equal_and_guarded("rows_add (three arrays)")
    if not (same_bits(third[:V], third_plain) and same_bits(third[V:], third_guard)):
        raise AssertionError("rows_add: the third array differs or its guard was written")
    pids_n64 = pids[:n].long()

    def index_add_each():
        kernel_out[0].index_add_(0, pids_n64, d_t[:n])
        kernel_out[1].index_add_(0, pids_n64, d_3[:n])
        third[:V].index_add_(0, pids_n64, d_n[:n])

    results["rows_update"] = dict(
        run=lambda: S.rows_add((*arrays_k, third[:V]), pids, (d_t, d_3, d_n), n_real=nuniq),
        plain=lambda: S.rows_update_plain((*arrays_p, third_plain), pids, (d_t, d_3, d_n),
                                          n_real=nuniq),
        plain_capturable=False, library=index_add_each,
        bytes=4 + 4 * n + 3 * 3 * 4 * W * n,
        shapes=f"all-add, 3 x [{V},{W}] ids[{K}] window [0, {n})")
    # (c) every pair of element types, on the wide path at the step shape
    # (the same unique-row window), on the path of one element a lane at a
    # width and at an address that allow no wide access, and on the wide path
    # of narrow rows (4 or 8 lanes a slot, several slots a warp)
    forms = _check_update_pairs(torch, S, g, card, V, W, pids, nuniq, n, offset=0,
                                expect_wide=True, timed=True)
    small_v, small_k, small_n = 50_000, 4096, 4000
    small_ids = torch.randperm(small_v - 1, generator=g, device=dev)[:small_k].to(torch.int32)
    small_ids[small_n:] = small_v  # tail pads one past the last row
    small_real = torch.tensor([small_n], dtype=torch.int32, device=dev)
    for width, offset, wide in ((126, 0, False), (W, 1, False), (32, 0, True)):
        _check_update_pairs(torch, S, g, card, small_v, width, small_ids, small_real, small_n,
                            offset=offset, expect_wide=wide, timed=False)
    bf16 = forms["f32_into_bf16"]
    log(f"[6] rows_update forms, all bitwise equal to the plain version: (add, set) on "
        f"(table, monu) {add_set_ms * 1e3:.2f} us for {add_set_bytes / 1e6:.2f} MB (bound "
        f"{bound(add_set_bytes, 0)[0] * 1e3:.2f} us); f32 deltas into a bf16 [{V},{W}] array, "
        f"special values included, {bf16['ms'] * 1e3:.2f} us for {bf16['bytes'] / 1e6:.2f} MB "
        f"(bound {bf16['bound_ms'] * 1e3:.2f} us) [{card}]")

    out = {}
    for name, c in results.items():
        ms = device_ms(c["run"])
        plain_ms = _time(torch, c["plain"], c["plain_capturable"])
        lib_ms = device_ms(c["library"])
        bound_ms, bound_by = bound(c["bytes"], 0)
        out[name] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=lib_ms, bytes=c["bytes"],
                         shapes=c["shapes"])
        log(f"[6] {name}: {c['shapes']}: bitwise equal to the plain version; kernel "
            f"{ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us"
            f"{'' if c['plain_capturable'] else ' (eager: it synchronises)'}, library "
            f"{lib_ms * 1e3:.2f} us; {c['bytes'] / 1e6:.2f} MB, bound {bound_ms * 1e3:.2f} us "
            f"({bound_by}) [{card}]")
    out["rows_update"]["forms"] = {
        "add_set": dict(ms=add_set_ms, bytes=add_set_bytes, bound_ms=bound(add_set_bytes, 0)[0]),
        **forms}

    # ---- the library functions as a caller uses them: a row update of the
    # table built from the public ops, two ways.  Gather the touched rows
    # (row_gather), add the deltas, write them back (rows_write_pipelined);
    # and the fused read-modify-write (rows_add) on a copy.  One f32 add per
    # element either way, so the two tables must end bitwise equal.  The
    # launch counts of this drive are the ones reported for B8-B10.
    plain_out.copy_(kernel_out)
    cuda_build.reset_launch_counts()
    for _ in range(LIBRARY_STEPS):
        delta = torch.randn((K, W), generator=g, device=dev)
        rows = G.row_gather(kernel_out[0], pids)  # pad slots: poison rows, never written
        S.rows_write_pipelined((kernel_out[0],), pids, (rows + delta,), n_real=nuniq)
        S.rows_add((plain_out[0],), pids, (delta,), n_real=nuniq)
    equal_and_guarded("gather + add + pipelined write vs rows_add")
    launches = {k: v for k, v in cuda_build.launch_counts.items() if v}
    want = dict(row_gather=LIBRARY_STEPS, rows_write_pipelined=LIBRARY_STEPS,
                rows_update=LIBRARY_STEPS)
    if launches != want:
        raise AssertionError(f"library drive launched {launches}, expected {want}")
    log(f"[6] {LIBRARY_STEPS} row updates of table[{V},{W}] through the public ops: row_gather "
        f"+ add + rows_write_pipelined == rows_add bitwise; launches {launches} [{card}]")
    for name, count in launches.items():
        out[name]["launches"] = count
    del buf, base, plain_out, kernel_out, values, third, third_plain
    torch.cuda.empty_cache()
    return out


def _numpy_train_state(model, seed: int):
    """numpy weights for a trainer's model (``_leaf_draw``), the table std
    0.3; a stacked container's moment half zero."""
    rng = np.random.default_rng(seed)
    tree = {}
    for key, p in model.named_parameters():
        shape = tuple(p.shape)
        if key == "embeddings.fused.table":
            fat = model.embeddings.fused.dual_container
            half = (shape[0] // 2, shape[1]) if fat else shape
            a = rng.normal(0.0, 0.3, half).astype(np.float32)
            if fat:
                a = np.concatenate([a, np.zeros(half, np.float32)])
        else:
            a = _leaf_draw(rng, key, shape).astype(np.float32)
        _set_leaf(tree, key, a)
    return {"params": tree, "batch_stats": _numpy_batch_stats(model, seed + 1000)}


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
    card against CPU, for both containers (device metadata)."""
    # 2^20 fused rows give 65,536 physical rows, and the JAX trainer's
    # headroom rule (staging.py:132-186) needs them above the padded
    # per-batch id count: batch 4000 x 16 features = 64,000 ids
    return {container: _two_phase_card_vs_cpu(
        torch, K, card, "7", f"{container} (monu_gather={monu_gather})",
        dict(TWO_PHASE, table_container=container, monu_gather=monu_gather), kernels)
        for container, monu_gather, kernels in (
            ("stacked", "xla", ("rows_gather_dual", "rows_write_dual")),
            ("split", "pallas", ("rows_write", "rows_gather_hbm")))}


# f16 moments: the share of the dense entries that may pass 1e-6 (LOOSE's)
F16_DENSE_SHARE = 1e-3


def _two_phase_card_vs_cpu(torch, K, card, tag, name, extra, row_kernels):
    """The two-phase step of ``aliexpress_like_config("mmoe", **extra)`` at
    2^20 fused rows (P = 16), batch 4000, 3 steps (the last partial), from
    one numpy init and one batch stream on the card and on the CPU: losses
    within rtol 1e-5, dense weights within atol 1e-6, the table within 3 x
    lr x 2^-7 and the moments within 2^-7 relative + 1e-4 of the largest;
    ``row_kernels`` and the forward kernels once a step, no other row
    kernel.

    Tolerances: the card's f32 sums run in another order than the CPU's. A
    table lane moves by at most lr per step, and one bf16 flip of its
    moments moves that step by 2^-7 of it; a moment lane may flip once per
    step (2^-7 relative), and a lane whose moment is 1e-4 below the largest
    holds a gradient sum that cancelled, which the order of the sum alone
    moves by ~1e-2 of itself.  f16 moments: nu underflows to 0 below 6e-8
    (g below ~8e-3 at 1 - b2 = 1e-3), and Adam then divides mu by eps =
    1e-8, so such a lane's step is its gradient's rounding magnified ~1e4
    times: the table and the weights downstream of it cannot be held at
    these tolerances; the update itself is held bitwise on identical
    inputs instead (``_update_card_equals_cpu``), and the dense weights by
    the loose form of phase 9's rule (``LOOSE``: at most 1e-3 of the
    entries over 1e-6, none over the three steps' reach of 3 x lr): the
    few table lanes that the underflow moves feed every example that reads
    them, so more dense gradients move than the order of the sums alone
    moves (194 of 367,618 entries past 1e-6 on the H100, the worst by
    4.3e-6; a broken dense path moves most of them)."""
    from mmlrec_tpu_torch.convert import load_jax_variables
    from mmlrec_tpu_torch.models import get_model
    from mmlrec_tpu_torch.synthetic import aliexpress_like_config, make_data
    from mmlrec_tpu_torch.train import Trainer

    vocab, batch = 1 << 16, 4000
    n = 3 * batch - 1000  # 3 steps, the last partial
    cfg = aliexpress_like_config("mmoe", **extra)
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
    diffs = [(p.detach().cpu() - q.detach()).abs()
             for p, q in zip(gpu.rest_params().values(), cpu.rest_params().values())]
    dense = max(float(d.max()) for d in diffs)
    dense_over = sum(int((d > 1e-6).sum()) for d in diffs)
    n_dense = sum(d.numel() for d in diffs)
    lr = cfg.optim_config.lr
    (tg, *mg), (tc, *mc) = _table_and_moments(gpu), _table_and_moments(cpu)
    table_err = float((tg.cpu() - tc).abs().max())
    table_tol = 3 * lr * 2.0 ** -7
    moments = {}
    for which, a, b in zip(("mu", "nu"), mg, mc):
        diff = (a.cpu() - b).abs()
        scale = float(b.abs().max())
        moments[which] = dict(max_abs_err=float(diff.max()), max_abs=scale,
                              lanes_over_tolerance=int((diff > 2.0 ** -7 * b.abs()
                                                        + 1e-4 * scale).sum()),
                              lanes_over_rtol_only=int((diff > 2.0 ** -7 * b.abs()).sum()))
    moment_dtype = (str(gpu.table_opt.mu.dtype) if hasattr(gpu.table_opt, "mu")
                    else "packed bf16")
    resolved = (gpu.table_update, gpu.dedup_route, gpu.update_space, gpu.table_container,
                moment_dtype)
    fused = gpu.model.embeddings.fused
    log(f"[{tag}] {name}, card vs CPU: {resolved}, table {list(fused.table.shape)}, "
        f"P={fused.pack_factor}, 3 steps of {batch} ({n} rows); epoch loss card {lg:.9g} cpu "
        f"{lc:.9g}; max |card - cpu|: dense {dense:.3g} (tol 1e-6), table {table_err:.3g} (tol "
        f"{table_tol:.3g}); moments {moments} (tol 2^-7 relative + 1e-4 of the largest); "
        f"launches per step {launches} [{card}]")
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    if any(m["lanes_over_tolerance"] for m in moments.values()):
        raise AssertionError(f"phase {tag}, {name}: the card's moments left the CPU's tolerance")
    out = dict(resolved=resolved, loss_card=lg, loss_cpu=lc, dense_max_abs_err=dense,
               dense_entries_over_1e_6=dense_over, dense_entries=n_dense,
               table_max_abs_err=table_err, table_tolerance=table_tol, moments=moments,
               launches_per_step=launches)
    if moment_dtype == "torch.float16":
        touched = mc[0] != 0
        out.update(nu_zero_lanes=int((touched & (mc[1] == 0)).sum()),
                   moment_lanes=int(touched.sum()),
                   table_lanes_over_tolerance=int(((tg.cpu() - tc).abs() > table_tol).sum()),
                   update_bitwise_on_identical_inputs=_update_card_equals_cpu(
                       torch, cpu, x, extra))
        log(f"[{tag}] {name}: nu is 0 in {out['nu_zero_lanes']} of the {out['moment_lanes']} "
            f"lanes with a moment on the CPU; table lanes over the tolerance "
            f"{out['table_lanes_over_tolerance']}; the update on identical inputs, card against "
            f"CPU: {'bitwise equal' if out['update_bitwise_on_identical_inputs'] else 'DIFFERENT'}"
            f"; dense {dense:.3g} with {dense_over} of {n_dense} entries over 1e-6 (tol: at most "
            f"{int(F16_DENSE_SHARE * n_dense)} over 1e-6, none over {3 * lr:.3g}) [{card}]")
        if not out["update_bitwise_on_identical_inputs"]:
            raise AssertionError(f"phase {tag}, {name}: the card's update differs on identical "
                                 "inputs")
        if dense > 3 * lr or dense_over > F16_DENSE_SHARE * n_dense:
            raise AssertionError(f"phase {tag}, {name}: the card's dense weights left the loose "
                                 "form of phase 9's rule")
    elif dense > 1e-6 or table_err > table_tol:
        raise AssertionError(f"phase {tag}, {name}: the card's steps left the CPU's tolerance")
    for kernel in ROW_KERNELS + ("gated_expert_mix", "multihead_score"):
        want = 1 if kernel in row_kernels or kernel not in ROW_KERNELS else None
        if launches.get(kernel) != want:
            raise AssertionError(f"phase {tag}, {name}: {kernel} launched "
                                 f"{launches.get(kernel)} a step, expected {want}")
    return out


def _full_width_trainer(torch, container, **extra):
    """Phase 8's MMoE at full width with ``TWO_PHASE`` and ``extra`` on
    top, its init drawn on the card from one seed (every call starts from
    the same bits)."""
    from mmlrec_tpu_torch.features import DenseFeat, FeatureLayout, SparseFeat
    from mmlrec_tpu_torch.models import get_model
    from mmlrec_tpu_torch.synthetic import make_config
    from mmlrec_tpu_torch.train import Trainer
    from mmlrec_tpu_torch.utils.seeding import make_generator

    cfg = make_config(task_name="mtl", model_name="mmoe", emb=FULL_EMB, n_sparse=FULL_FEATURES,
                      n_dense=FULL_DENSE, hidden=(256, 128), tower=(64,), gate=(64,),
                      batch_size=FLAGSHIP_BATCH, table_container=container,
                      monu_gather="pallas" if container == "split" else "xla",
                      **{**TWO_PHASE, **extra})
    layout = FeatureLayout(
        [SparseFeat(f"s{i}", FULL_VOCAB, FULL_EMB) for i in range(FULL_FEATURES)]
        + [DenseFeat(f"d{i}", 1) for i in range(FULL_DENSE)])
    model = get_model("mmoe", layout, cfg, generator=make_generator(0, DEV), device=DEV)
    return Trainer(model, seed=0, device=DEV).compile()


def _timed_steps(torch, tr, batches):
    """(CUDA-event ms of each step on batches already on the card, device
    ms of one step queued behind a spin or None)."""
    from mmlrec_tpu_torch.tools.timing import queued_ms

    step_ms = []
    for b in batches:
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        tr.train_step(*b)
        e1.record()
        e1.synchronize()
        step_ms.append(e0.elapsed_time(e1))
    it = iter(batches)
    return step_ms, queued_ms(lambda: tr.train_step(*next(it)))


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
        step_ms, dev_ms = _timed_steps(torch, tr, batches)
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
    from mmlrec_tpu_torch.tools.timing import eager_ms
    from mmlrec_tpu_torch.train.sparse_embedding import _segment_sum

    g_rows = torch.randn(FLAGSHIP_BATCH * FULL_FEATURES, FULL_EMB, device=DEV)
    inv = torch.randint(0, g_rows.shape[0], (g_rows.shape[0],), device=DEV, dtype=torch.int32)
    det_ms = eager_ms(lambda: _segment_sum(g_rows, inv))
    atomic_ms = eager_ms(lambda: torch.zeros_like(g_rows).index_add_(0, inv, g_rows))
    log(f"[8] gradient dedup [{g_rows.shape[0]}, {FULL_EMB}] (issued eagerly): deterministic "
        f"index_put_ (sorted) {det_ms * 1e3:.1f} us vs float-atomic index_add_ "
        f"{atomic_ms * 1e3:.1f} us [{card}]")
    out["dense_bitwise_equal"] = dense_equal
    out["segment_sum_ms"] = dict(deterministic=det_ms, atomic=atomic_ms)
    return out


def _family_config(name, **kw):
    from mmlrec_tpu_torch.synthetic import aliexpress_like_config

    return aliexpress_like_config(name, task_name=FAMILIES[name][0], **kw)


def _tag(name, use_bn=False, **kw):
    return name + ("+bn" if use_bn else "") + "".join(f"+{k}" for k in sorted(kw))


def _expected_launches(name, per, wide=False):
    """Launches of the three forward kernels in ``per`` forwards of a family
    (the wide logit takes the heads off the score kernel)."""
    _, mixes, scores = FAMILIES[name]
    return dict(embed_concat=per, gated_expert_mix=per * mixes,
                multihead_score=0 if wide else per * scores)


def _noise_driven(model):
    """The biases that feed a BatchNorm with nothing between (each DNN's
    ``dense_i.bias`` before its ``bn_i``) and that BatchNorm's running
    mean: their gradient is zero in exact arithmetic, so Adam's steps for
    them follow rounding noise.  STAR's layer-0 biases reach its
    DomainBatchNorm through the activation alone: the normalisation over
    the batch cancels a shift to first order, and what the activation's
    curvature leaves is a near-cancelling sum, rounding again.  A Dice's
    BatchNorm sees the activation's input again after it: not
    noise-driven."""
    keys = set()
    for prefix, m in model.named_modules():
        if getattr(m, "use_bn", False):
            for i in range(m.depth):
                keys |= {f"{prefix}.bn_{i}.mean", f"{prefix}.dense_{i}.bias"}
    if getattr(model, "domain_bn", None) is not None:
        keys |= {k for k, _ in model.linear_0.named_parameters(prefix="linear_0")
                 if k.endswith("_bias")}
    return keys


# phase 10: the card-vs-CPU tolerances of the families with more weights
# whose gradient is a near-cancelling sum (see _card_vs_cpu_state)
LOOSE = {"star": dict(share=1e-3, mu=1e-3, nu=1e-3),
         "mssm": dict(share=1e-3, mu=1e-3, nu=1e-3, stats=5e-6)}


def _card_vs_cpu_state(gpu, cpu, noise, lr, share=1e-4, mu=2e-5, nu=1e-4, stats=1e-6,
                       table_atol=5e-6, table_share=None, over=1e-6):
    """Phases 9 and 10: the card's trainer against the CPU's after the same
    steps, ``noise`` (``_noise_driven``) left out.  Returns (the worst
    differences and whether they failed, a line saying so).

    Tolerances: an Adam step moves a weight by at most lr whatever the
    gradient's size, and sums of 4096 f32 terms in another order move the
    step by ~1e-6 of it.  Where a gradient is below Adam's eps (1e-8) the
    step is lr x g / (|g| + eps), which keeps the gradient's absolute
    rounding noise: an entry of PLE's first expert layer had g = -1.6e-9
    on the card and -1.4e-9 on the CPU at step 1 and moved by 0.14 x lr
    against 0.12 x lr; of 1.26 M entries 19 did so.  So at most 1e-4 of the
    dense entries may pass 1e-6 and none the three steps' reach of 3 x lr.
    The table's cotangent is a one-hot product over the batch: 5e-6
    (``table_atol``).  Under ``sparse_embedding_update`` a touched row
    takes Adam steps of its own, and a lane touched with a gradient near
    eps keeps its rounding as a dense weight does: the table is then held
    apart from the dense entries, at most ``table_share`` of its entries
    over 1e-6 and none over ``table_atol``.
    Running and population statistics (BatchNorm, Dice, DomainBatchNorm)
    1e-6.  Adam's moments carry the gradient's own scale, so they are held
    relative to each tensor's largest: mu 2e-5, nu 1e-4.

    STAR with its DomainBatchNorm and MSSM take ``LOOSE[name]``: more of
    their weights have a gradient that is a near-cancelling sum (MSSM's
    scalar gate locations and gate transforms sum over every example and
    connection; STAR's layer 0 feeds a normalisation over the whole batch).
    The card moved 349 of MSSM's 1.53 M entries (263 in the gate
    transforms) and 125 of STAR's 245,640 (119 in layer 0's kernels) past
    1e-6, every one within 2 x lr, with losses equal to 1.2e-7, and MSSM's
    running variances (~1.5) by 3.2e-6, some 16 ulps (PERF.md, section 6).

    ``over`` is the 1e-6 of that count, set for phase 9's lr of 1e-3: the
    rule at another lr scales it with the lr (phase 16's sweep).

    The steps run ``dnn_activation: sigmoid``: relu has a kink, and a
    pre-activation within rounding of zero is kept on one side and dropped
    on the other, which moves every gradient upstream of it by one
    example's share and Adam turns that into steps that differ by a
    visible part of lr (one of three data seeds of PLE)."""
    state_g, state_c = gpu.model.state_dict(), cpu.model.state_dict()
    params = dict(cpu.model.named_parameters())
    worst = dict(dense=0.0, table=0.0, stats=0.0, mu=0.0, nu=0.0)
    n_over = n_dense = table_over = n_table = 0
    over_by_tensor, worst_at = {}, {}
    for k, q in state_c.items():
        if k in noise:
            continue
        diff = (state_g[k].detach().cpu() - q.detach()).abs()
        which = ("table" if k == "embeddings.fused.table"
                 else "stats" if k not in params else "dense")
        if which == "table":
            table_over, n_table = int((diff > over).sum()), diff.numel()
        elif which == "dense":
            n = int((diff > over).sum())
            n_over, n_dense = n_over + n, n_dense + diff.numel()
            if n:
                over_by_tensor[k] = n
        if float(diff.max()) > worst[which]:
            worst[which], worst_at[which] = float(diff.max()), k
        if k in params and k in gpu.opt_state.mu:  # sparse_embedding_update: not the table
            for m in ("mu", "nu"):
                a, b = getattr(gpu.opt_state, m)[k].cpu(), getattr(cpu.opt_state, m)[k]
                scale = float(b.abs().max())
                if scale and float((a - b).abs().max()) / scale > worst[m]:
                    worst[m], worst_at[m] = float((a - b).abs().max()) / scale, k
    worst.update(dense_entries_over_1e_6=n_over, dense_entries=n_dense,
                 table_entries_over_1e_6=table_over, table_entries=n_table, worst_at=worst_at,
                 over_1e_6_by_tensor=over_by_tensor, over=over)
    worst["failed"] = bool(
        worst["dense"] > 3 * lr or n_over > share * n_dense
        or worst["table"] > table_atol
        or (table_share is not None and table_over > table_share * n_table)
        or worst["stats"] > stats or worst["mu"] > mu or worst["nu"] > nu)
    line = (f"max |card - cpu|: dense {worst['dense']:.3g} with {n_over} of {n_dense} entries "
            f"over {over:g} (tol: at most {int(share * n_dense)} over {over:g}, none over "
            f"{3 * lr:.3g}), table {worst['table']:.3g} with {table_over} of {n_table} entries "
            f"over {over:g} (tol: "
            f"{'' if table_share is None else f'at most {int(table_share * n_table)} over {over:g}, '}"
            f"none over {table_atol:.3g}), running "
            f"statistics {worst['stats']:.3g} "
            f"(tol {stats:g}), Adam mu {worst['mu']:.3g} (tol {mu:g}) and nu {worst['nu']:.3g} (tol "
            f"{nu:g}) of each tensor's largest; {len(noise)} noise-driven tensors left out; worst "
            f"in {worst_at}; entries over 1e-6 by tensor {over_by_tensor}")
    return worst, line


def family_serve(torch, K, card, name, use_bn, workdir, **kw):
    """Phase 10: one family's bundle served on the card, held against the
    CPU.  ``kw`` goes to the config (``masked_loss`` sends the domain mask
    to the model, ``use_wide_linear`` adds the wide logit)."""
    from mmlrec_tpu_torch.convert import load_jax_variables
    from mmlrec_tpu_torch.models import get_model
    from mmlrec_tpu_torch.serving import (
        ServingBundle,
        _domain_mask_from_meta,
        _pack_from_schema,
        save_serving_bundle,
    )
    from mmlrec_tpu_torch.synthetic import make_data
    from mmlrec_tpu_torch.tools.timing import device_ms, eager_ms

    tag = _tag(name, use_bn, **kw)
    wide = bool(kw.get("use_wide_linear"))
    cfg = _family_config(name, dnn_use_bn=use_bn, **kw)
    layout, x, _, _ = make_data(cfg, n=sum(FAMILY_REQUESTS), vocab=100, seed=20)
    model = get_model(name, layout, cfg, device="cpu")
    load_jax_variables(model, numpy_variables(model, seed=21))
    path = os.path.join(workdir, f"family_{tag}")
    save_serving_bundle(model, path)
    gpu = ServingBundle.load(path, device="cuda")
    cpu = ServingBundle.load(path, device="cpu")
    n_buffers = len(gpu.model.state_dict()) - len(list(gpu.model.parameters()))
    if bool(n_buffers) != (use_bn and name not in ("mlp", "apg", "pepnet")):
        raise AssertionError(f"{tag}: {n_buffers} BatchNorm buffers in the bundle")
    for k, v in gpu.model.state_dict().items():
        if not torch.equal(v.cpu(), cpu.model.state_dict()[k]):
            raise AssertionError(f"{tag}: {k} differs between the card's bundle and the CPU's")
    edges = np.cumsum((0,) + FAMILY_REQUESTS)
    requests = [{k: v[a:b] for k, v in x.items()} for a, b in zip(edges[:-1], edges[1:])]
    gpu.predict(requests[0])  # warm-up
    torch.cuda.synchronize()
    K.reset_launch_counts()
    outs = [gpu.predict(r) for r in requests]
    launches = {k: K.launch_counts[k] for k in ("embed_concat", "gated_expert_mix",
                                                "multihead_score")}
    want_launches = _expected_launches(name, len(requests), wide)
    if launches != want_launches or sum(K.launch_counts.values()) != sum(launches.values()):
        raise AssertionError(f"{tag}: launched {dict(K.launch_counts)} in {len(requests)} "
                             f"forwards, expected {want_launches}")
    worst = 0.0
    for r, got in zip(requests, outs):
        want = cpu.predict(r)
        if got.shape != want.shape or got.shape != (len(r["s0"]), gpu.meta["num_heads"]):
            raise AssertionError(f"{tag}: shape {got.shape} vs {want.shape}")
        if not np.isfinite(got).all() or got.min() < 0 or got.max() > 1:
            raise AssertionError(f"{tag}: probabilities are not finite values in [0, 1]")
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        worst = max(worst, float(np.abs(got - want).max()))
    spread = float(np.concatenate(outs).std())
    if spread < 0.02:
        raise AssertionError(f"{tag}: probabilities barely vary (std {spread})")
    ids, dense = _pack_from_schema(gpu.meta["packing"], requests[0])
    dmask = None
    if gpu.meta["needs_mask"]:
        dmask = torch.from_numpy(_domain_mask_from_meta(gpu.meta, requests[0])).cuda()
    ids_d, dense_d = torch.from_numpy(ids).cuda(), torch.from_numpy(dense).cuda()
    with torch.inference_mode():
        fn = lambda: gpu.model(ids_d, dense_d, dmask)  # noqa: E731
        fwd_device = device_ms(fn, reps=11, inner=10)
        fwd_eager = eager_ms(fn, reps=11, inner=10)
    rounds = []
    for _ in range(FAMILY_ROUNDS):
        t0 = time.perf_counter()
        for r in requests:
            gpu.predict(r)
        rounds.append(time.perf_counter() - t0)
    seconds, rows = statistics.median(rounds), int(sum(FAMILY_REQUESTS))
    per_forward = {k: v // len(requests) for k, v in launches.items()}
    log(f"[10] {tag} ({cfg.model_config.task_name}, {gpu.meta['num_heads']} heads, "
        f"{sum(p.numel() for p in gpu.model.parameters())} parameters): {len(requests)} requests, "
        f"{rows} rows; max |gpu - cpu| {worst:.3g}; launches per forward {per_forward}; forward at "
        f"batch {FLAGSHIP_BATCH}: device {fwd_device * 1e3:.1f} us, eager {fwd_eager * 1e3:.1f} us; "
        f"median of {FAMILY_ROUNDS} rounds {seconds * 1e3:.2f} ms = {rows / seconds:.0f} "
        f"examples/s through ServingBundle.predict [{card}]")
    return dict(task_name=cfg.model_config.task_name, max_abs_err=worst,
                launches_per_forward=per_forward, forward_device_ms=fwd_device,
                forward_eager_ms=fwd_eager, examples_per_s=rows / seconds,
                round_ms=seconds * 1e3)


def _family_trainer(name, layout, dev, cfg):
    from mmlrec_tpu_torch.convert import load_jax_variables
    from mmlrec_tpu_torch.models import get_model
    from mmlrec_tpu_torch.train import Trainer

    model = get_model(name, layout, cfg, device="cpu")
    load_jax_variables(model, _numpy_train_state(model, seed=22))
    return Trainer(model, seed=0, device=dev).compile(metrics=["auc"])


def family_card_vs_cpu(torch, K, card, name, use_bn, **kw):
    """Phase 10: three dense steps of one family, the last batch partial,
    card against CPU with sigmoid DNNs (``_card_vs_cpu_state``), the masked
    loss on, with the launches per step."""
    from mmlrec_tpu_torch.synthetic import make_data

    tag = _tag(name, use_bn, **kw)
    cfg = _family_config(name, dnn_use_bn=use_bn, masked_loss=True, dnn_activation="sigmoid",
                         **kw)
    batch = cfg.training_config.train_batch_size
    n = 3 * batch - 1000
    layout, x, y, _ = make_data(cfg, n=n, vocab=100, seed=23)
    gpu, cpu = _family_trainer(name, layout, DEV, cfg), _family_trainer(name, layout, "cpu", cfg)
    K.reset_launch_counts()
    gpu.fit(x, y, batch_size=batch, epochs=1, verbose=0)
    torch.cuda.synchronize()
    launches = {**_per_step(K, 3), "embed_concat_backward": K.backward_counts["embed_concat"] / 3}
    want_launches = {k: float(v) for k, v in _expected_launches(name, 1).items() if v}
    want_launches["embed_concat_backward"] = 1.0
    if launches != want_launches:
        raise AssertionError(f"phase 10, {tag}: launches per step {launches}, expected "
                             f"{want_launches}")
    cpu.fit(x, y, batch_size=batch, epochs=1, verbose=0)
    lg, lc = gpu.history[-1]["loss"], cpu.history[-1]["loss"]
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    noise = _noise_driven(cpu.model)
    worst, verdict = _card_vs_cpu_state(gpu, cpu, noise, cfg.optim_config.lr,
                                        **LOOSE.get(name, {}))
    stats = sorted(k for k in cpu.model.state_dict() if k.endswith(("mean", "var")))
    log(f"[10] {tag} dense fit, card vs CPU, 3 steps of {batch} ({n} rows), sigmoid DNNs: epoch "
        f"loss card {lg:.9g} cpu {lc:.9g}; {verdict}; statistics held {len(stats)} "
        f"({', '.join(k for k in stats if k not in noise)}); launches per step {launches} [{card}]")
    if worst["failed"] or int(gpu.opt_state.count) != 3 or bool(noise) != use_bn:
        raise AssertionError(f"phase 10, {tag}: the card's dense steps left the CPU's tolerance")
    return dict(loss_card=lg, loss_cpu=lc, **worst, launches_per_step=launches,
                noise_driven_tensors=sorted(noise), statistics=stats)


def family_fit_on_card(torch, K, card, name, use_bn, **kw):
    """Phase 10: one family's fit on the card, 16 batches x 2 epochs with
    validation (relu DNNs), the launches in the fit asserted, then 20 timed
    steps.  With ``snr_stochastic_gates`` and one warmup epoch the first
    epoch runs the midpoint gates and the second draws u on the card: the
    gates must be switched on at the end, the alphas must have moved, and
    two training forwards of one batch must differ."""
    from mmlrec_tpu_torch.synthetic import make_data

    tag = _tag(name, use_bn, **kw)
    cfg = _family_config(name, dnn_use_bn=use_bn, masked_loss=True, **kw)
    batch = cfg.training_config.train_batch_size
    n_val = 2 * batch
    cut = FAMILY_BATCHES * batch
    layout, x, y, _ = make_data(cfg, n=cut + n_val, vocab=100, seed=24)
    x_tr, y_tr = {k: v[:cut] for k, v in x.items()}, y[:cut]
    val = ({k: v[cut:] for k, v in x.items()}, y[cut:])
    tr = _family_trainer(name, layout, DEV, cfg)
    alphas = {k: v.detach().clone() for k, v in tr.model.named_parameters() if k.endswith("alpha")}
    K.reset_launch_counts()
    t0 = time.perf_counter()
    tr.fit(x_tr, y_tr, batch_size=batch, epochs=FAMILY_EPOCHS, validation_data=val, verbose=0)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    steps, forwards = FAMILY_BATCHES * FAMILY_EPOCHS, FAMILY_BATCHES * FAMILY_EPOCHS + 2 * FAMILY_EPOCHS
    fit_launches = {k: v for k, v in K.launch_counts.items() if v}
    if (fit_launches != {k: v for k, v in _expected_launches(name, forwards).items() if v}
            or K.backward_counts["embed_concat"] != steps):
        raise AssertionError(f"phase 10, {tag}: launches in the fit {fit_launches}, "
                             f"{K.backward_counts['embed_concat']} backwards in {steps} steps")
    history = tr.history
    if not all(np.isfinite(list(h.values())).all() for h in history) or tr.best_variables is None:
        raise AssertionError(f"phase 10, {tag}: a log that is not finite, or no best snapshot")
    if use_bn:
        moved = max(float((v - 1.0).abs().max()) for k, v in tr.model.state_dict().items()
                    if k.endswith("var"))
        if not moved > 1e-3 or set(tr.best_variables) != set(tr.model.state_dict()):
            raise AssertionError(f"phase 10, {tag}: the running statistics did not move, or the "
                                 "snapshot lacks them")
    preds = tr.predict(val[0], batch)
    if preds.shape != (n_val, 2) or not np.isfinite(preds).all():
        raise AssertionError(f"phase 10, {tag}: predictions are not finite [N, 2]")
    ids, dense = tr.pack_inputs(x_tr)
    dmask, yy = tr._domain_mask_from(x_tr), tr._prepare_y(y_tr)
    batches = []
    for s_ in range(FAMILY_BATCHES):
        sl = slice(s_ * batch, (s_ + 1) * batch)
        batches.append([None if a is None else torch.from_numpy(a[sl]).to(DEV)
                        for a in (ids, dense, yy, dmask)] + [torch.ones(batch, device=DEV)])
    gates = ""
    if kw.get("snr_stochastic_gates"):
        moved = {k: float((tr.model.state_dict()[k] - a).abs().max()) for k, a in alphas.items()}
        switches = [m.noise_off for m in tr.model.modules() if hasattr(m, "noise_off")]
        tr.model.train()
        with torch.no_grad():
            a, b = (tr.model(*batches[0][:2]) for _ in range(2))
        tr.model.eval()
        drawn = float((a - b).abs().max())
        if not (switches and not any(switches) and min(moved.values()) > 0 and drawn > 0):
            raise AssertionError(f"phase 10, {tag}: gates {switches}, alphas moved {moved}, two "
                                 f"training forwards differ by {drawn}")
        gates = (f"gates drawing after the warmup epoch {not any(switches)}, alphas moved by "
                 f"{ {k: round(v, 6) for k, v in moved.items()} }, two training forwards of "
                 f"one batch differ by {drawn:.3g}; ")
    step_ms, dev_ms = _timed_steps(torch, tr, batches)
    med = statistics.median(step_ms)
    busy = None if dev_ms is None else dev_ms / med
    log(f"[10] {tag} dense fit on the card: {FAMILY_BATCHES} batches x {FAMILY_EPOCHS} epochs of "
        f"{batch} + 2 validation batches per epoch in {fit_s:.2f} s; history "
        f"{[{k: round(v, 5) for k, v in h.items()} for h in history]}; {gates}launches in the fit "
        f"{fit_launches}, embed_concat backwards {steps}; median step {med:.3f} ms (CUDA events, "
        f"min {min(step_ms):.3f}) = {batch / med * 1e3:.0f} examples/s; step device time "
        f"{'not measured' if dev_ms is None else f'{dev_ms:.3f} ms'}, device busy "
        f"{'not measured' if busy is None else f'{busy:.1%}'} [{card}]")
    return dict(fit_s=fit_s, history=history, launches_in_fit=fit_launches,
                step_ms_median=med, step_ms=step_ms, examples_per_s=batch / med * 1e3,
                step_device_ms=dev_ms, device_busy_share=busy)


def family_sweep(torch, K, card, workdir):
    """Phase 10: every family of the port besides the flagship's."""
    out = {}
    serving = ([(n, False, {}) for n in FAMILIES]
               + [("sharedbottom", True, {}), ("star", True, dict(masked_loss=True)),
                  ("snr_trans", False, dict(use_wide_linear=True))])
    for name, use_bn, kw in serving:
        out[_tag(name, use_bn, **kw)] = dict(
            serving=family_serve(torch, K, card, name, use_bn, workdir, **kw))
    for name, use_bn in (("ple", False), ("sharedbottom", True), ("star", True), ("mssm", True)):
        entry = out.setdefault(_tag(name, use_bn), {})
        entry["dense_fit"] = dict(card_vs_cpu=family_card_vs_cpu(torch, K, card, name, use_bn))
        entry["dense_fit"].update(family_fit_on_card(torch, K, card, name, use_bn))
    gates = dict(snr_stochastic_gates=True, snr_gate_noise_warmup_epochs=1)
    out[_tag("snr_trans", **gates)] = dict(
        dense_fit=family_fit_on_card(torch, K, card, "snr_trans", False, **gates))
    return out


# ----------------------------------------------------------------------
# phase 11: the shipped configurations through the CLI
# ----------------------------------------------------------------------
ROOT = os.path.dirname(os.path.abspath(__file__))
# the CLI's default vocabulary (the scatter update) and one that takes the
# write kernel at a batch of 512 (lane-packed, physical rows > Kp)
CLI_VOCABS = (100, 1 << 16)
CLI_ROWS, CLI_BATCH, CLI_EPOCHS = 4096, 512, 2
AE_CONFIG = os.path.join("configs", "msl", "config_AE.json")
AE_VOCAB = 1 << 17  # 17 features x 2^17 ids: 139,264 physical rows > Kp = 69,632
AE_STEPS, AE_TIMED = 3, 16


def _shipped_configs():
    found = []
    for base, _, files in os.walk(os.path.join(ROOT, "configs")):
        found += [os.path.relpath(os.path.join(base, f), ROOT) for f in files if f.endswith(".json")]
    return sorted(found)


def _cut_config(rel, out_dir, epochs, batch=None):
    """A copy of a shipped config with its epochs and batches cut (the
    batches as shipped where ``batch`` is None), all else (paths included)
    as shipped."""
    with open(os.path.join(ROOT, rel)) as f:
        raw = json.load(f)
    tc = raw["training_config"]
    tc["epochs"] = epochs
    for k in ("train_batch_size", "val_batch_size", "test_batch_size"):
        if k in tc and batch is not None:
            tc[k] = batch
    path = os.path.join(out_dir, "config.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return raw, path


def _check_outputs(rel, raw, row, work):
    """The row in the JAX schema, the CSV, the checkpoint where ``save`` is
    set and the layer-output pickles where asked for; returns what was
    written."""
    dc, mc, sc = raw["data_config"], raw["model_config"], raw.get("save_config", {})
    n_heads = len(dc["label_columns"])
    want = ["type"] + [f"{m}_{i}" for i in range(n_heads) for m in ("log_loss", "auc")]
    want += ["total_auc"] if mc["task_name"] in ("msl", "mtmsl") else []
    want += ["examples_per_s"]
    if list(row) != want or not all(np.isfinite(row[k]) for k in want[1:]):
        raise AssertionError(f"phase 11, {rel}: row {row}, expected the keys {want}")
    written = []
    if dc.get("test_result_path"):
        with open(os.path.join(work, dc["test_result_path"])) as f:
            header = f.readline().strip().split(",")
        if header != want:
            raise AssertionError(f"phase 11, {rel}: CSV header {header}")
        written.append(dc["test_result_path"])
    ckpt = os.path.join(work, sc.get("save_path", "./checkpoint/"),
                        f"{mc['model_name']}_{mc['task_name']}_seed0", "variables.pt")
    if os.path.exists(ckpt) != bool(sc.get("save")):
        raise AssertionError(f"phase 11, {rel}: checkpoint {'missing' if sc.get('save') else 'written'}")
    if sc.get("save"):
        written.append(os.path.relpath(ckpt, work))
    if sc.get("save_layer_output"):
        prefix = os.path.join(work, dc["layer_output_path"])
        pkls = sorted(p for p in (os.path.join(os.path.dirname(prefix), f)
                                  for f in os.listdir(os.path.dirname(prefix)))
                      if p.startswith(prefix) and p.endswith(".pkl"))
        if not pkls:
            raise AssertionError(f"phase 11, {rel}: no layer-output pickles")
        written += [os.path.relpath(p, work) for p in pkls]
    return written


def shipped_cli(torch, K, card):
    """Phase 11 (1): every shipped config through the CLI on the card, at the
    CLI's default vocabulary and at one that takes the write kernel."""
    from mmlrec_tpu_torch.main import parse_args, run
    from mmlrec_tpu_torch.train import sparse_embedding as SE

    out, cwd, total = {}, os.getcwd(), {}
    steps_per_epoch = CLI_ROWS // CLI_BATCH
    for rel in _shipped_configs():
        for vocab in CLI_VOCABS:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as work:
                raw, cfg = _cut_config(rel, work, CLI_EPOCHS, CLI_BATCH)
                os.chdir(work)
                try:
                    K.reset_launch_counts()
                    SE.reset_metadata_calls()
                    t0 = time.perf_counter()
                    (row, tr), = run(parse_args([
                        "--config", cfg, "--seed", "0", "--synthetic", "--synthetic_rows",
                        str(CLI_ROWS), "--synthetic_vocab", str(vocab)]))
                    torch.cuda.synchronize()
                    wall_s = time.perf_counter() - t0
                    written = _check_outputs(rel, raw, row, work)
                finally:
                    os.chdir(cwd)
            launches = {k: v for k, v in K.launch_counts.items() if v}
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            calls = dict(SE.metadata_calls)
            steps = steps_per_epoch * len(tr.history)
            epochs_run = len(tr.history)
            if not tr.two_phase_embedding:
                route, source = "dense", "none"
            else:
                route = "pallas-unique" if tr.table_update == "pallas" else "scatter"
                source = "device" if tr.device_metadata else (
                    "native" if calls["native"] else "numpy")
                # the JAX rule: the write-kernel update's metadata comes from
                # the native pass when it loads; the scatter update's (inv,
                # rep) always from numpy.  Here the native pass must load.
                # One call builds an epoch's batches (staging.fs_host_prep).
                want = ("pallas-unique", "native", {"native": epochs_run, "numpy": 0}) \
                    if vocab > 100 else ("scatter", "numpy", {"native": 0, "numpy": epochs_run})
                if (route, source, calls) != want:
                    raise AssertionError(f"phase 11, {rel} vocab {vocab}: route {route}, metadata "
                                         f"{calls}, expected {want}")
                if launches.get("rows_write", 0) != (steps if route == "pallas-unique" else 0):
                    raise AssertionError(f"phase 11, {rel}: rows_write launched "
                                         f"{launches.get('rows_write')} times in {steps} steps")
            # the dense step runs B7 every step; the two-phase step injects
            # the gathered rows (as in JAX), and B7 runs in validation
            if launches.get("embed_concat", 0) < (steps if route == "dense" else 1):
                raise AssertionError(f"phase 11, {rel}: embed_concat launched {launches}")
            step_ms = tr.history[-1]["epoch_s"] * 1e3 / steps_per_epoch
            key = f"{rel} vocab {vocab}"
            out[key] = dict(model=tr.model_name, task=tr.task_name, route=route, metadata=source,
                            metadata_calls=calls, steps=steps, step_ms_last_epoch=step_ms,
                            wall_s=wall_s, row=row, files=written, launches=launches,
                            val_auc=[h.get("val_auc") for h in tr.history],
                            table=list(tr.table.shape) if tr.two_phase_embedding else None)
            log(f"[11] {key}: {tr.model_name} {tr.task_name}, route {route}, metadata {source}, "
                f"{steps} steps of {CLI_BATCH}, {step_ms:.2f} ms a step (host clock, last epoch), "
                f"{wall_s:.1f} s in all; val_auc {out[key]['val_auc']}; row {row}; wrote "
                f"{written}; launches {launches} [{card}]")
            del tr
    return out, total


def _held_card_vs_cpu(gpu, cpu, lr):
    """Phase 11 (2)'s rule: dense weights and the table at phase 9's count
    (at most 1e-4 of the entries over 1e-6, none over 3 x lr), the table's
    f32 moments within 1e-5 of each tensor's largest."""
    worst = dict(dense_over=0, dense_n=0, dense_max=0.0, table_over=0, table_n=0,
                 table_max=0.0, mu=0.0, nu=0.0)
    state_c = dict(cpu.model.named_parameters())
    for k, p in gpu.model.named_parameters():
        diff = (p.detach().cpu() - state_c[k].detach()).abs()
        which = "table" if k == "embeddings.fused.table" else "dense"
        worst[f"{which}_over"] += int((diff > 1e-6).sum())
        worst[f"{which}_n"] += diff.numel()
        worst[f"{which}_max"] = max(worst[f"{which}_max"], float(diff.max()))
    for m in ("mu", "nu"):
        a, b = getattr(gpu.table_opt, m).cpu(), getattr(cpu.table_opt, m)
        worst[m] = float((a - b).abs().max()) / float(b.abs().max())
    worst["failed"] = bool(
        any(worst[f"{w}_over"] > 1e-4 * worst[f"{w}_n"] or worst[f"{w}_max"] > 3 * lr
            for w in ("dense", "table")) or worst["mu"] > 1e-5 or worst["nu"] > 1e-5)
    return worst


def _same_state(torch, a, b):
    """Every tensor of two trainers' states bitwise equal."""
    def bits(t):
        return t.detach().contiguous().view(torch.int32) if t.dtype == torch.float32 else t

    sa, sb = a.model.state_dict(), b.model.state_dict()
    pairs = [(sa[k], sb[k]) for k in sa]
    pairs += list(zip(a.table_opt, b.table_opt)) if a.table_opt is not None else []
    for field in a.opt_state._fields:
        x, y = getattr(a.opt_state, field), getattr(b.opt_state, field)
        pairs += [(x[k], y[k]) for k in x] if isinstance(x, dict) else [(x, y)]
    return all(torch.equal(bits(x), bits(y)) for x, y in pairs)


def _shipped_config(path, **model_fields):
    """A shipped config as the CLI reads it, without saving, with
    ``model_fields`` set on its model section (``dnn_activation`` is a field
    there: one put into ``extra`` would change nothing)."""
    from mmlrec_tpu_torch.config import ExperimentConfig

    cfg = ExperimentConfig.from_file(path)
    cfg.save_config.save = False
    for k, v in model_fields.items():
        if not hasattr(cfg.model_config, k):
            raise AttributeError(f"the model section has no field {k!r}")
        setattr(cfg.model_config, k, v)
    return cfg


def _config_trainer(cfg, ds, dev, seed=None, numpy_seed=None):
    """The trainer the CLI builds for ``cfg`` on ``ds``, its weights drawn
    from ``set_seed(seed, dev)`` as the CLI draws them, or from numpy
    (``_numpy_train_state``) so that the card and the CPU start equal."""
    from mmlrec_tpu_torch.convert import load_jax_variables
    from mmlrec_tpu_torch.models import get_model
    from mmlrec_tpu_torch.train import Trainer, resolve_table_container
    from mmlrec_tpu_torch.utils import set_seed

    resolve_table_container(cfg, ds.layout, device=dev)
    mc, oc = cfg.model_config, cfg.optim_config
    if numpy_seed is None:
        model = get_model(mc.model_name, ds.layout, cfg, generator=set_seed(seed, dev),
                          device=dev)
    else:
        model = get_model(mc.model_name, ds.layout, cfg, device="cpu")
        load_jax_variables(model, _numpy_train_state(model, seed=numpy_seed))
    return Trainer(model, seed=0, device=dev).compile(
        optimizer=oc.optimizer, loss=oc.loss, metrics=oc.metrics)


def shipped_full_width(torch, K, card, workdir):
    """Phase 11 (2)-(4): configs/msl/config_AE.json at production vocabulary
    on the card: B3 on (table, mu, nu), 3 steps against the CPU, 16 timed
    steps, checkpoints and validation on the device."""
    from mmlrec_tpu_torch.main import load_dataset, parse_args
    from mmlrec_tpu_torch.models import get_model
    from mmlrec_tpu_torch.ops import row_scatter as S
    from mmlrec_tpu_torch.tools.timing import device_ms, eager_ms, queued_ms
    from mmlrec_tpu_torch.train import Trainer
    from mmlrec_tpu_torch.train import device_metrics as DM
    from mmlrec_tpu_torch.train import sparse_embedding as SE
    from mmlrec_tpu_torch.train import staging
    from mmlrec_tpu_torch.train.metrics import regime_eval
    from mmlrec_tpu_torch.utils import set_seed

    path = os.path.join(ROOT, AE_CONFIG)
    out = {}

    def config(**model_fields):
        return _shipped_config(path, **model_fields)

    def data(cfg, rows):
        return load_dataset(cfg, parse_args(["--config", path, "--synthetic", "--synthetic_rows",
                                             str(rows), "--synthetic_vocab", str(AE_VOCAB)]))

    trainer = _config_trainer
    batch = config().training_config.train_batch_size
    # ---- (2) 3 steps, the last partial, card against CPU, sigmoid DNNs
    # (phase 9's rule is stated for them: _card_vs_cpu_state)
    n = AE_STEPS * batch - 1000
    cfg = config(dnn_activation="sigmoid")
    ds = data(cfg, n)
    gpu, cpu = trainer(cfg, ds, DEV, numpy_seed=12), trainer(config(dnn_activation="sigmoid"),
                                                             ds, "cpu", numpy_seed=12)
    K.reset_launch_counts()
    SE.reset_metadata_calls()
    gpu.fit(ds.train_input, ds.y_train, batch_size=batch, epochs=1, shuffle=False, verbose=0)
    torch.cuda.synchronize()
    launches = _per_step(K, AE_STEPS)
    calls = dict(SE.metadata_calls)
    cpu.fit(ds.train_input, ds.y_train, batch_size=batch, epochs=1, shuffle=False, verbose=0)
    lg, lc = gpu.history[-1]["loss"], cpu.history[-1]["loss"]
    worst = _held_card_vs_cpu(gpu, cpu, cfg.optim_config.lr)
    fused = gpu.model.embeddings.fused
    route = (gpu.table_update, type(gpu.table_opt).__name__, gpu.table_container)
    log(f"[11] {AE_CONFIG} at vocab {AE_VOCAB}: table {list(fused.table.shape)} (P="
        f"{fused.pack_factor}), route {route}, host metadata {calls}; 3 steps of {batch} ({n} "
        f"rows), sigmoid DNNs: epoch loss card {lg:.9g} cpu {lc:.9g}; {worst} (tol: at most 1e-4 "
        f"of the dense and of the table entries over 1e-6, none over 3 x lr; mu, nu 1e-5 of the "
        f"largest); launches per step {launches} [{card}]")
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    # one call builds the epoch's batches (staging.fs_host_prep)
    if route != ("pallas", "SparseAdamState", "split") or calls != {"native": 1, "numpy": 0}:
        raise AssertionError(f"phase 11: AE took {route} with metadata {calls}")
    # the step runs B3 and B6 once each; B7 not (the gathered rows are
    # injected, as in the JAX step)
    if worst["failed"] or launches != {"rows_write": 1.0, "multihead_score": 1.0}:
        raise AssertionError("phase 11: the card's AE steps left the CPU's tolerance, or B3 "
                             "and B6 did not run once a step")
    out["card_vs_cpu"] = dict(loss_card=lg, loss_cpu=lc, **worst, launches_per_step=launches,
                              route=list(route), table=list(fused.table.shape),
                              metadata_calls=calls)

    # ---- B3 on three f32 arrays at this shape, bitwise against its plain version
    ids_np, _ = gpu.pack_inputs(ds.train_input)
    flat = (ids_np[:batch].astype(np.int64) + gpu._host_offsets[None, :]).reshape(1, -1)
    meta = SE.batch_step_metadata(flat, gpu._emb_pack_factor, gpu._emb_phys_rows)
    pids, nuniq = (torch.from_numpy(meta[i][0]).to(DEV) for i in (2, 4))
    u = int(meta[4][0, 0])
    Kp, W = pids.shape[0], gpu.table.shape[1]
    g = torch.Generator(device=DEV).manual_seed(13)
    acc3 = torch.randn((Kp, 3 * W), generator=g, device=DEV)
    vals = (acc3[:, :W], acc3[:, W:2 * W], acc3[:, 2 * W:])
    arrays = [t.detach().clone() for t in (gpu.table, gpu.table_opt.mu, gpu.table_opt.nu)]
    plain = [t.clone() for t in arrays]
    S.rows_write(arrays, pids, vals, n_real=nuniq)
    S.rows_write_plain(plain, pids, vals, n_real=nuniq)
    torch.cuda.synchronize()
    if not all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(arrays, plain)):
        raise AssertionError("phase 11: rows_write on (table, mu, nu) differs from its plain version")
    rows_n = pids[:u].long()

    def index_copy_each():
        for a, v in zip(arrays, vals):
            a.index_copy_(0, rows_n, v[:u])

    ms = device_ms(lambda: S.rows_write(arrays, pids, vals, n_real=nuniq))
    plain_ms = eager_ms(lambda: S.rows_write_plain(plain, pids, vals, n_real=nuniq), reps=11,
                        inner=5)
    lib_ms = device_ms(index_copy_each)
    nbytes = 8 + 4 * u + 3 * 2 * 4 * W * u
    bound_ms, bound_by = bound(nbytes, 0)
    shapes = f"(table, mu, nu) 3 x [{arrays[0].shape[0]},{W}] f32, ids[{Kp}] window [0, {u})"
    out["rows_write_f32_three_arrays"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
        bound_by=bound_by, bytes=nbytes, shapes=shapes, launches_per_step=launches["rows_write"])
    log(f"[11] rows_write, {shapes}: bitwise equal to the plain version; kernel "
        f"{ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us (eager: it synchronises), index_copy_ "
        f"x 3 {lib_ms * 1e3:.2f} us; {nbytes / 1e6:.2f} MB, bound {bound_ms * 1e3:.2f} us "
        f"({bound_by}) [{card}]")
    del gpu, cpu, arrays, plain, acc3, vals

    # ---- 16 timed steps as shipped (relu), host metadata built before each
    cfg = config()
    ds = data(cfg, AE_TIMED * batch)
    tr = trainer(cfg, ds, DEV, seed=0)
    ids_np, dense_np = tr.pack_inputs(ds.train_input)
    y_np, dmask_np = tr._prepare_y(ds.y_train), tr._domain_mask_from(ds.train_input)
    batches, host_ids = [], []
    for s in range(AE_TIMED):
        sl = slice(s * batch, (s + 1) * batch)
        host_ids.append(ids_np[sl])
        batches.append([torch.from_numpy(np.ascontiguousarray(a[sl])).to(DEV)
                        for a in (ids_np, dense_np, y_np, dmask_np)]
                       + [torch.ones(batch, device=DEV)])
    tr.train_step(*batches[0], meta=tr.host_metadata(host_ids[0]))  # warm-up
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    for b, h in zip(batches, host_ids):
        tr.train_step(*b, meta=tr.host_metadata(h))
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / AE_TIMED
    timed_launches = _per_step(K, AE_TIMED)
    if timed_launches != {"rows_write": 1.0, "multihead_score": 1.0}:
        raise AssertionError(f"phase 11: timed steps launched {timed_launches} per step")
    metas = [tr.host_metadata(h) for h in host_ids]
    it = iter(zip(batches, metas))
    dev_ms = queued_ms(lambda: (lambda b, m: tr.train_step(*b, meta=m))(*next(it)))
    busy = None if dev_ms is None else dev_ms / wall_ms
    meta_ms = {}
    for source, use_native in (("native", True), ("numpy", False)):
        times = []
        for h in host_ids:
            fl = (h.astype(np.int64) + tr._host_offsets[None, :]).reshape(1, -1)
            t1 = time.perf_counter()
            SE.batch_step_metadata(fl, tr._emb_pack_factor, tr._emb_phys_rows,
                                   use_native=use_native)
            times.append((time.perf_counter() - t1) * 1e3)
        meta_ms[source] = statistics.median(times)
    log(f"[11] {AE_CONFIG} as shipped, {AE_TIMED} steps of {batch} on batches on the card, host "
        f"metadata built before each step: {wall_ms:.3f} ms a step (host clock) = "
        f"{batch / wall_ms * 1e3:.0f} examples/s; step device time "
        f"{'not measured' if dev_ms is None else f'{dev_ms:.3f} ms'}, device busy "
        f"{'not measured' if busy is None else f'{busy:.1%}'}; launches per step {timed_launches}; "
        f"host metadata per batch of {batch * len(tr.layout.sparse_slots)} ids: native "
        f"{meta_ms['native']:.2f} ms, numpy {meta_ms['numpy']:.2f} ms [{card}]")
    out["timed"] = dict(step_ms_wall=wall_ms, examples_per_s=batch / wall_ms * 1e3,
                        step_device_ms=dev_ms, device_busy_share=busy,
                        launches_per_step=timed_launches, host_metadata_ms=meta_ms)

    # ---- (4) validation on the device against the host, same predictions
    val = staging.prepare_eval_tensors(tr, *tr.pack_inputs(ds.test_input),
                                       tr._domain_mask_from(ds.test_input), batch)
    n_val = len(ds.y_test)
    probs = tr._scanned_probs(val, use_best=False)
    y_val = tr._prepare_y(ds.y_test)
    y_dev, w_dev = staging.prepare_metric_tensors(tr, y_val, val.ids.shape[0] * batch)
    dev_metrics = {k: float(v) for k, v in DM.regime_metrics(
        tr.metric_fns, y_dev, probs, w_dev, tr.task_name, tr.num_domains).items()}
    host_metrics = regime_eval(tr.metric_fns, y_val,
                               probs.cpu().numpy()[:n_val].astype(np.float64), tr.task_name,
                               tr.num_domains)
    gap = max(abs(dev_metrics[k] - host_metrics[k]) for k in host_metrics)
    log(f"[11] validation of {n_val} rows: device {dev_metrics} vs host {host_metrics}: max "
        f"|device - host| {gap:.3g} (tol 1e-5) [{card}]")
    if set(dev_metrics) != set(host_metrics) or gap > 1e-5:
        raise AssertionError("phase 11: device validation metrics differ from the host's")
    out["validation"] = dict(device=dev_metrics, host=host_metrics, max_abs_diff=gap)

    # ---- (3) checkpoints on the card
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_", dir=workdir) as ck:
        x_test = ds.test_input
        want = tr.predict(x_test, batch)
        saved = tr.save_checkpoint(ck)
        fresh = trainer(config(), ds, DEV, seed=1)
        fresh.restore_checkpoint(saved)
        restore_ok = np.array_equal(fresh.predict(x_test, batch), want)
        del fresh, tr
        # resume after epoch 1 == an uninterrupted 2-epoch fit
        ds2 = data(config(), 2 * batch)
        runs = {}
        for name in ("full", "first", "resumed"):
            runs[name] = trainer(config(), ds2, DEV, seed=2)
        fit = dict(batch_size=batch, shuffle=False, verbose=0)
        runs["full"].fit(ds2.train_input, ds2.y_train, epochs=2, **fit)
        runs["first"].fit(ds2.train_input, ds2.y_train, epochs=1, **fit)
        state = runs["first"].save_training_state(ck)
        runs["resumed"].fit(ds2.train_input, ds2.y_train, epochs=2, resume_from=state, **fit)
        resume_ok = _same_state(torch, runs["full"], runs["resumed"])
        del runs
        # a stacked bf16 state restored into a split trainer: bitwise after unpack
        from mmlrec_tpu_torch.synthetic import aliexpress_like_config, make_data

        st_ok = []
        for container in ("stacked", "split"):
            c = aliexpress_like_config("mmoe", table_container=container, **TWO_PHASE)
            layout, x, y, _ = make_data(c, n=2 * 4000, vocab=1 << 16, seed=14)
            m = get_model("mmoe", layout, c, generator=set_seed(3, DEV), device=DEV)
            t = Trainer(m, seed=0, device=DEV).compile()
            if container == "stacked":
                t.fit(x, y, batch_size=4000, epochs=1, verbose=0)
                stacked_state = t.save_training_state(os.path.join(ck, "stacked"))
                top, bottom = _container_views(t)
            else:
                t.fit(x, y, batch_size=4000, epochs=1, verbose=0, resume_from=stacked_state)
                table, monu = _container_views(t)
                st_ok = [torch.equal(top.view(torch.int32), table.view(torch.int32)),
                         torch.equal(bottom.view(torch.int32), monu.view(torch.int32))]
            del t, m
    log(f"[11] checkpoints on the card: save -> restore into a fresh trainer predicts "
        f"{'bitwise equal' if restore_ok else 'DIFFERENTLY'}; resume after epoch 1 == the "
        f"uninterrupted 2-epoch fit {'bitwise' if resume_ok else 'NOT bitwise'}; a stacked bf16 "
        f"state restored into a split trainer: table {st_ok[0]}, packed moments {st_ok[1]} "
        f"bitwise [{card}]")
    if not (restore_ok and resume_ok and all(st_ok)):
        raise AssertionError("phase 11: a checkpoint did not round-trip bitwise on the card")
    out["checkpoints"] = dict(restore_predicts_bitwise=restore_ok, resume_bitwise=resume_ok,
                              stacked_to_split_bitwise=all(st_ok))
    torch.cuda.empty_cache()
    return out


def _sync_free_step(torch, tr, batch, meta=None) -> None:
    """One eager step under torch.cuda.set_sync_debug_mode("error"): the
    trainer's claim that no step reads a device value on the host, which a
    captured step needs."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tr.train_step(*batch, meta=meta)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def _held_bitwise(torch, a, b) -> list:
    """Names of the parameters, buffers and optimizer tensors where two
    trainers differ in any bit."""
    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    other = b.model.state_dict()
    bad = [k for k, v in a.model.state_dict().items() if not torch.equal(bits(v), bits(other[k]))]
    for field in a.opt_state._fields:
        x, y = getattr(a.opt_state, field), getattr(b.opt_state, field)
        pairs = x.items() if isinstance(x, dict) else [(field, x)]
        for k, t in pairs:
            u = y[k] if isinstance(y, dict) else y
            if not torch.equal(bits(t), bits(u)):
                bad.append(f"opt_state/{field}/{k}")
    if a.table_opt is not None:
        for field, t in a.table_opt._asdict().items():
            if not torch.equal(bits(t), bits(getattr(b.table_opt, field))):
                bad.append(f"table_opt/{field}")
    for k, t in (a.gn_state or {}).items():
        if not torch.equal(bits(t), bits(b.gn_state[k])):
            bad.append(f"gradnorm/{k}")
    if [h["loss"] for h in a.history] != [h["loss"] for h in b.history]:
        bad.append("history")
    return bad


def _fit_once(torch, K, tr, x, y, batch, epochs, **fit_kw) -> dict:
    """One timed fit on the card: its wall time, its last epoch's wall ms a
    step (host clock, the epoch's sync included), examples/s, graph
    replays, kernel launches a step and the host's ms by epoch."""
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    tr.fit(x, y, batch_size=batch, epochs=epochs, verbose=0, **fit_kw)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    per_epoch = (len(next(iter(x.values()))) - 1) // batch + 1
    steps = epochs * per_epoch
    return dict(fit_s=fit_s, step_ms_wall_last_epoch=tr.history[-1]["epoch_s"] * 1e3 / per_epoch,
                fit_examples_per_s=tr.throughput_examples_per_s,
                graph_replays=tr.graph_replays,
                launches_per_step={k: v / steps for k, v in K.launch_counts.items() if v},
                losses=[h["loss"] for h in tr.history],
                host_ms_by_epoch=[{k: t[k] * 1e3 for k in ("prep_s", "issue_s", "sync_s",
                                                            "steps_device_s") if k in t}
                                  for t in tr.fit_timing])


def _replayed_step_device_ms(torch, tr, x, y, batch, **fit_kw):
    """The device time of a replayed step: a further 3-epoch graph fit of
    ``tr`` whose epoch callback spins the card after epoch 2 (its graphs
    captured by then), so the host queues the last epoch's replays behind
    the spin and the fit's events around them (``fit_timing``'s
    ``steps_device_s``) time them back to back.  None if the host took
    longer than 80% of the spin to queue them."""
    from mmlrec_tpu_torch.tools.timing import spin_cycles

    cycles = spin_cycles(REPLAY_SPIN_MS)
    tr.fit(x, y, batch_size=batch, epochs=3, verbose=0,
           epoch_callback=lambda e, _: e == 1 and torch.cuda._sleep(cycles), **fit_kw)
    last = tr.fit_timing[-1]
    queued_ms = (last["prep_s"] + last["issue_s"]) * 1e3
    per_epoch = (len(next(iter(x.values()))) - 1) // batch + 1
    if queued_ms > 0.8 * REPLAY_SPIN_MS:
        return None, queued_ms
    return last["steps_device_s"] * 1e3 / per_epoch, queued_ms


def _staged_pair(torch, K, card, tag, make, x, y, batch, epochs, timed_batches, meta_fn=None,
                 streaming=False, phase=12, **fit_kw):
    """Fit ``make(scan_steps)`` twice, staged with graph replay (scan_steps
    16) and staged eager (0), each on a fresh trainer from one init, and
    with ``streaming`` also on the streaming path (the dataset over a cap
    of 0 bytes) at ``prefetch_batches`` 2 and 1; hold each bitwise against
    the staged eager fit.  Then time a replayed step on the card (a further
    graph fit, ``_replayed_step_device_ms``) and an eager step (queued
    behind a spin), and set each fit's busy share from its own kind's
    device time."""
    from mmlrec_tpu_torch.tools.timing import queued_ms

    out, kept = {}, {}
    for scan in (SCAN_GRAPH, 0):
        kept[scan] = make(scan)
        out[scan] = _fit_once(torch, K, kept[scan], x, y, batch, epochs, **fit_kw)
    graph, eager = kept[SCAN_GRAPH], kept[0]
    bad = {"graph replay": _held_bitwise(torch, graph, eager)}
    streamed = {}
    for depth in (2, 1) if streaming else ():
        tr = make(0)
        tr._device_data_bytes_cap = 0  # the dataset over the cap: the streaming loop
        tr._prefetch_batches = depth
        name = f"streaming, prefetch_batches {depth}"
        streamed[name] = _fit_once(torch, K, tr, x, y, batch, epochs, **fit_kw)
        bad[name] = _held_bitwise(torch, tr, eager)
        del tr
    # the step's device time on batches already on the card
    ids, dense = graph.pack_inputs(x)
    yy, dmask = graph._prepare_y(y), graph._domain_mask_from(x)
    batches, metas = [], []
    for s in range(timed_batches):
        sl = slice(s * batch, (s + 1) * batch)
        batches.append([torch.from_numpy(np.ascontiguousarray(a[sl])).to(DEV) if a is not None
                        else None for a in (ids, dense, yy, dmask)]
                       + [torch.ones(batch, device=DEV)])
        metas.append(meta_fn(graph, ids[sl]) if meta_fn else None)
    del eager, kept
    _sync_free_step(torch, graph, batches[0], metas[0])
    it = iter(zip(batches, metas))
    eager_dev_ms = queued_ms(lambda: (lambda b, m: graph.train_step(*b, meta=m))(*next(it)),
                             reps=min(5, timed_batches))
    replay_dev_ms, replay_queued_ms = _replayed_step_device_ms(torch, graph, x, y, batch,
                                                              **fit_kw)
    differs = {k: v[:8] for k, v in bad.items() if v}
    res = dict(graph=out[SCAN_GRAPH], eager=out[0], **streamed, bitwise_equal=not differs,
               differs=differs, replayed_step_device_ms=replay_dev_ms,
               replayed_epoch_queued_host_ms=replay_queued_ms, replay_spin_ms=REPLAY_SPIN_MS,
               eager_step_device_ms=eager_dev_ms, sync_free_eager_step=True)
    rows = [("graph", out[SCAN_GRAPH], replay_dev_ms, f"scan_steps {SCAN_GRAPH}"),
            ("eager", out[0], eager_dev_ms, "scan_steps 0")]
    rows += [(name, r, eager_dev_ms, "eager steps") for name, r in streamed.items()]
    for name, r, dev_ms, how in rows:
        busy = None if dev_ms is None else dev_ms / r["step_ms_wall_last_epoch"]
        r["device_busy_share"] = busy
        log(f"[{phase}] {tag}, {'staged ' if name in ('graph', 'eager') else ''}{name} ({how}): "
            f"fit {r['fit_s']:.2f} s, {r['fit_examples_per_s']:.0f} examples/s (first epoch "
            f"left out); last epoch {r['step_ms_wall_last_epoch']:.3f} ms a step (host clock, "
            f"the epoch's sync included); step device time "
            f"{'not measured' if dev_ms is None else f'{dev_ms:.3f} ms'} "
            f"({'replayed, a spun epoch' if name == 'graph' else 'eager, queued behind a spin'}), "
            f"busy {'not measured' if busy is None else f'{busy:.1%}'}; graph replays "
            f"{r['graph_replays']}; host ms by epoch (prep, issue, sync, steps' device span) "
            f"{[tuple(round(v, 2) for v in t.values()) for t in r['host_ms_by_epoch']]}; "
            f"launches per step "
            f"{ {k: round(v, 3) for k, v in r['launches_per_step'].items()} } [{card}]")
    log(f"[{phase}] {tag}: a replayed step's device time from {REPLAY_SPIN_MS:.0f} ms spun epoch "
        f"(its replays queued in {replay_queued_ms:.1f} ms): "
        f"{'not measured' if replay_dev_ms is None else f'{replay_dev_ms:.3f} ms'} [{card}]")
    for name in bad:
        log(f"[{phase}] {tag}: {name} vs staged eager "
            f"{'bitwise equal' if not bad[name] else 'DIFFER in ' + str(bad[name][:8])} "
            f"(parameters, buffers, optimizer states, losses) [{card}]")
    log(f"[{phase}] {tag}: one eager step ran under set_sync_debug_mode('error') [{card}]")
    if differs:
        raise AssertionError(f"phase {phase}, {tag}: fits differ from staged eager: {differs}")
    if not out[SCAN_GRAPH]["graph_replays"]["train"] or out[0]["graph_replays"]["train"] or any(
            r["graph_replays"]["train"] for r in streamed.values()):
        raise AssertionError(f"phase {phase}, {tag}: the graph fit replayed nothing, or an eager one did")
    del graph
    torch.cuda.empty_cache()
    return res


def staged_fits(torch, K, card):
    """Phase 12: the JAX fit's default path on the card (the staged dataset,
    scan_steps as CUDA-graph replay, the flat optimizer, thread-ahead host
    metadata): three fits, each staged with graph replay and staged eager,
    held bitwise, plus stochastic gates."""
    from mmlrec_tpu_torch.config import ExperimentConfig
    from mmlrec_tpu_torch.main import load_dataset, parse_args
    from mmlrec_tpu_torch.models import get_model
    from mmlrec_tpu_torch.synthetic import aliexpress_like_config, make_data
    from mmlrec_tpu_torch.train import Trainer, resolve_table_container
    from mmlrec_tpu_torch.utils import set_seed
    from mmlrec_tpu_torch.utils.seeding import make_generator

    out = {}
    # ---- (a) the flagship dense fit of phase 9, dropout 0.2
    batch = FLAGSHIP_BATCH
    layout, x, y, _ = make_data(aliexpress_like_config("mmoe", masked_loss=True),
                                n=DENSE_BATCHES * batch, vocab=100, seed=11)

    def dense(scan):
        cfg = aliexpress_like_config("mmoe", masked_loss=True, dnn_dropout=0.2, scan_steps=scan)
        model = get_model("mmoe", layout, cfg, generator=make_generator(5, DEV), device=DEV)
        return Trainer(model, seed=0, device=DEV).compile(metrics=["auc", "logloss"])

    out["dense_flagship"] = _staged_pair(torch, K, card, "flagship dense fit (phase 9's config, "
                                         "dnn_dropout 0.2)", dense, x, y, batch, STAGED_EPOCHS,
                                         timed_batches=8, streaming=True)
    # ---- stochastic gates: snr_trans, one warmup epoch, the second drawing
    layout, x, y, _ = make_data(aliexpress_like_config("snr_trans"), n=FAMILY_BATCHES * batch,
                                vocab=100, seed=15)

    def gates(scan):
        cfg = aliexpress_like_config("snr_trans", snr_stochastic_gates=True,
                                     snr_gate_noise_warmup_epochs=1, scan_steps=scan)
        model = get_model("snr_trans", layout, cfg, generator=make_generator(6, DEV), device=DEV)
        return Trainer(model, seed=0, device=DEV).compile(metrics=["auc"])

    out["snr_trans_stochastic_gates"] = _staged_pair(
        torch, K, card, "snr_trans with stochastic gates (epoch 2 draws)", gates, x, y, batch,
        STAGED_EPOCHS, timed_batches=4)
    # ---- (b) phase 8's 40 M-row stacked fit
    rng = np.random.default_rng(40)
    n = FULL_STEPS * FLAGSHIP_BATCH
    x = {f"s{i}": rng.integers(0, FULL_VOCAB, n) for i in range(FULL_FEATURES)}
    x.update({f"d{i}": rng.random(n).astype(np.float32) for i in range(FULL_DENSE)})
    y = (rng.random((n, 2)) < 0.3).astype(np.float32)

    def stacked(scan):
        tr = _full_width_trainer(torch, "stacked")
        tr._scan_steps = scan  # the config's scan_steps, as the trainer resolves it
        return tr

    out["stacked_40m"] = _staged_pair(torch, K, card, "40 M-row stacked two-phase fit "
                                      "(phase 8's, device metadata)", stacked, x, y,
                                      FLAGSHIP_BATCH, STAGED_EPOCHS, timed_batches=5)
    # ---- (c) the shipped config_AE.json at 139,264 physical rows, host metadata
    path = os.path.join(ROOT, AE_CONFIG)
    cfg0 = ExperimentConfig.from_file(path)
    batch = cfg0.training_config.train_batch_size
    ds = load_dataset(cfg0, parse_args(["--config", path, "--synthetic", "--synthetic_rows",
                                        str(AE_TIMED * batch), "--synthetic_vocab",
                                        str(AE_VOCAB)]))

    def shipped(scan):
        cfg = ExperimentConfig.from_file(path)
        cfg.save_config.save = False
        cfg.model_config.extra["scan_steps"] = scan
        resolve_table_container(cfg, ds.layout, device=DEV)
        mc, oc = cfg.model_config, cfg.optim_config
        model = get_model(mc.model_name, ds.layout, cfg, generator=set_seed(0, DEV), device=DEV)
        return Trainer(model, seed=0, device=DEV).compile(
            optimizer=oc.optimizer, loss=oc.loss, metrics=oc.metrics)

    out["shipped_ae"] = _staged_pair(
        torch, K, card, f"{AE_CONFIG} at vocab {AE_VOCAB} (host metadata, thread-ahead)",
        shipped, ds.train_input, ds.y_train, batch, STAGED_EPOCHS, timed_batches=5,
        meta_fn=lambda tr, h: tr.host_metadata(h), streaming=True)
    # what the worker does for one epoch of AE_TIMED batches, the card idle
    from mmlrec_tpu_torch.train import staging

    # the same graph fit over STEADY_EPOCHS epochs: from the third on, the
    # worker's metadata of epoch e+1 has a whole epoch to be ready
    tr = shipped(SCAN_GRAPH)
    tr.fit(ds.train_input, ds.y_train, batch_size=batch, epochs=STEADY_EPOCHS, verbose=0)
    torch.cuda.synchronize()
    per_step = (len(ds.y_train) - 1) // batch + 1
    later = tr.history[2:]
    steady_ms = statistics.median(h["epoch_s"] * 1e3 / per_step for h in later)
    steady_wait = statistics.median(t["prep_s"] * 1e3 for t in tr.fit_timing[2:])
    log(f"[12] {AE_CONFIG}, staged graph over {STEADY_EPOCHS} epochs: epochs 3-"
        f"{STEADY_EPOCHS} {steady_ms:.3f} ms a step (median, host clock), waiting "
        f"{steady_wait:.2f} ms an epoch for the worker's metadata; "
        f"{tr.throughput_examples_per_s:.0f} examples/s (first epoch left out) [{card}]")
    out["shipped_ae"]["steady"] = dict(epochs=STEADY_EPOCHS, step_ms_wall=steady_ms,
                                       prep_wait_ms=steady_wait,
                                       fit_examples_per_s=tr.throughput_examples_per_s)
    tr._meta_codec = "unset"
    ids = tr.pack_inputs(ds.train_input)[0]
    n = len(ids)
    steps = (n - 1) // batch + 1
    flat = staging.flat_ids(tr, ids[np.arange(steps * batch) % n], steps)
    order = np.random.default_rng(0).permutation(n)
    prep_ms = {}
    for name, fn in (("metadata", lambda: staging.step_metadata(tr, flat)),
                     ("fs_host_prep (+ encode, pinned upload)",
                      lambda: staging.claim(staging.fs_host_prep(
                          tr, ids, n, batch, order, steps)[2]))):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        prep_ms[name] = statistics.median(times)
    log(f"[12] {AE_CONFIG}: one epoch's host prep of {steps} batches x "
        f"{flat.shape[1]} ids, the card idle (median of 3, ms): "
        f"{ {k: round(v, 2) for k, v in prep_ms.items()} } [{card}]")
    out["shipped_ae"]["epoch_host_prep_ms"] = prep_ms
    del tr
    out["eval_capture"] = eval_capture_cost(torch, card)
    return out


def eval_capture_cost(torch, card):
    """What a capture costs ``predict`` and ``evaluate``: the eval program
    over 1-32 batches of 4096 rows (the shipped ``test_batch_size``) with
    a fresh capture and eagerly, host clock to the result on the card
    (median of 3), the two held bitwise; sets where the trainer's
    ``EVAL_GRAPH_MIN_BATCHES`` should lie."""
    from mmlrec_tpu_torch.models import get_model
    from mmlrec_tpu_torch.synthetic import aliexpress_like_config, make_data
    from mmlrec_tpu_torch.train import Trainer, staging
    from mmlrec_tpu_torch.train.graphs import StepGraphs
    from mmlrec_tpu_torch.train.trainer import EVAL_GRAPH_MIN_BATCHES, _EvalProgram
    from mmlrec_tpu_torch.utils.seeding import make_generator

    batch, most = FLAGSHIP_BATCH, 32
    cfg = aliexpress_like_config("mmoe", masked_loss=True)
    layout, x, _, _ = make_data(cfg, n=most * batch, vocab=100, seed=17)
    model = get_model("mmoe", layout, cfg, generator=make_generator(7, DEV), device=DEV)
    tr = Trainer(model, seed=0, device=DEV).compile(metrics=["auc"])
    ids, dense = tr.pack_inputs(x)
    dmask = tr._domain_mask_from(x)
    out = {}
    for nb in (1, 2, 4, 8, 16, 32):
        rows = nb * batch
        ev = staging.prepare_eval_tensors(tr, ids[:rows], dense[:rows],
                                          None if dmask is None else dmask[:rows], batch)
        ms, probs = {}, {}
        for name in ("graph", "eager"):
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                graphs = StepGraphs(DEV) if name == "graph" else None
                probs[name] = _EvalProgram(tr, ev, None, graphs).run().clone()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            ms[name] = statistics.median(times)
        if not torch.equal(probs["graph"], probs["eager"]):
            raise AssertionError(f"phase 12: the captured eval forward differs from the eager "
                                 f"one at {nb} batches")
        out[nb] = ms
    log(f"[12] eval program, flagship MMoE, batches of {batch}: ms to the result (median of 3; "
        f"a fresh capture, eager): { {nb: (round(m['graph'], 2), round(m['eager'], 2)) for nb, m in out.items()} }; "
        f"captured and eager bitwise equal; the trainer captures from "
        f"{EVAL_GRAPH_MIN_BATCHES} batches on [{card}]")
    del tr
    return dict(ms_by_batches=out, batch=batch, graph_min_batches=EVAL_GRAPH_MIN_BATCHES)


# ----------------------------------------------------------------------
# phase 13: the production recipe (BASELINE.md:159-167) at 40 M rows
# ----------------------------------------------------------------------

RECIPE_BATCHES, RECIPE_EPOCHS = 16, 2
RECIPE = dict(two_phase_embedding=True, table_update="pallas", table_opt_dtype="bfloat16",
              table_container="stacked")


def _recipe_trainer(torch, scan=SCAN_GRAPH, **extra):
    """Phase 8's stacked trainer under the recipe: host metadata, the
    gather route and the space left to resolve themselves."""
    return _full_width_trainer(torch, "stacked", **{"device_metadata": False,
                                                      "scan_steps": scan, **extra})


def _recipe_data(stream: str):
    """RECIPE_BATCHES x 4096 rows of 16 ids each, from one seed: uniform over
    the 2,500,000 ids of a feature, or Zipf-1.1 per feature as
    benchmarks/probe_zipf_contention.py:60 draws them."""
    rng = np.random.default_rng(41)
    n = RECIPE_BATCHES * FLAGSHIP_BATCH
    if stream == "uniform":
        ids = rng.integers(0, FULL_VOCAB, (n, FULL_FEATURES))
    else:
        ids = (rng.zipf(1.1, (n, FULL_FEATURES)) - 1) % FULL_VOCAB
    x = {f"s{i}": ids[:, i] for i in range(FULL_FEATURES)}
    x.update({f"d{i}": rng.random(n).astype(np.float32) for i in range(FULL_DENSE)})
    return x, (rng.random((n, 2)) < 0.3).astype(np.float32)


def _recipe_fit(torch, K, tr, x, y, epochs=RECIPE_EPOCHS):
    """A block-mode fit of ``tr`` with the launch and metadata counts of
    its steps."""
    from mmlrec_tpu_torch.train import sparse_embedding as SE

    SE.reset_metadata_calls()
    res = _fit_once(torch, K, tr, x, y, FLAGSHIP_BATCH, epochs, shuffle="block")
    res["metadata_calls"] = dict(SE.metadata_calls)
    return res


def production_recipe(torch, K, card):
    """Phase 13: BASELINE.md's recipe for tables of 10M rows and more at
    phase 8's full width (40 M logical rows, the stacked [2, 10M, 128]
    container): host metadata from the native pass, shuffle="block", the
    staged path with graph replay; a uniform and a Zipf-1.1 stream; on the
    uniform stream the scatter route beside auto's gather route, on the
    Zipf stream four arms, each from one init held bitwise and timed, and
    replay against eager; then the new routes card against CPU at phase 7's
    shapes."""
    from mmlrec_tpu_torch.train import sparse_embedding as SE
    from mmlrec_tpu_torch.train import staging

    out = {"card_arithmetic": _card_arithmetic(torch, card)}
    kept = None
    for stream in ("uniform", "zipf"):
        x, y = _recipe_data(stream)
        tr = _recipe_trainer(torch)
        flat0 = staging.flat_ids(tr, tr.pack_inputs(x)[0][:FLAGSHIP_BATCH], 1)
        dup = 1.0 - len(np.unique(flat0[0] // tr._emb_pack_factor)) / flat0.shape[1]
        res = _recipe_fit(torch, K, tr, x, y)
        want_space = "slot" if stream == "zipf" else "position"
        route = (tr.table_update, tr.dedup_route, tr.update_space, tr.table_container)
        calls = res["metadata_calls"]
        per_step = res["launches_per_step"]
        log(f"[13] {stream} ids: the first batch's physical duplication {dup:.1%}; resolved "
            f"{route}; metadata calls {calls} (block mode: once per fit); launches per step "
            f"{ {k: round(v, 3) for k, v in per_step.items()} } [{card}]")
        if route != ("pallas", "gather", want_space, "stacked"):
            raise AssertionError(f"phase 13, {stream}: resolved {route}, expected gather/"
                                 f"{want_space}")
        if calls["native"] < 1 or calls["numpy"]:
            raise AssertionError(f"phase 13, {stream}: host metadata {calls}: the native pass "
                                 "must run and numpy must not")
        for name in ("rows_gather_dual", "rows_write_dual"):
            if per_step.get(name) != 1.0:
                raise AssertionError(f"phase 13, {stream}: {name} {per_step.get(name)} a step")
        # the host metadata of the fit's batches as the fit built it (one
        # call, no floor yet), the card idle (median of 3), with its widths
        flat = staging.flat_ids(tr, tr.pack_inputs(x)[0], RECIPE_BATCHES)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            meta = SE.batch_step_metadata(flat, tr._emb_pack_factor, tr._emb_phys_rows,
                                          want_route=True)
            times.append((time.perf_counter() - t0) * 1e3)
        widths = dict(R_cap=meta[7].shape[1], G_cap=meta[9].shape[1])
        log(f"[13] {stream} ids: the fit's route lists {widths}, physical rows a batch "
            f"{int(meta[4].min())}-{int(meta[4].max())} of {flat.shape[1]} ids [{card}]")
        res.update(stream=stream, first_batch_phys_dup=dup, resolved=route, route_widths=widths,
                   host_metadata_ms=statistics.median(times))
        res["gradient_dedup_us"] = _dedup_sum_us(torch, tr, flat[:1])
        log(f"[13] {stream} ids, the gradient sums of one batch [{flat.shape[1]}, {FULL_EMB}] "
            f"(device us, graph replay): {res['gradient_dedup_us']} [{card}]")
        if stream == "zipf":
            kept = (tr, x, y, res)
        else:
            # auto's gather route against the scatter route on these ids,
            # before the timing's further fit moves the trainer on
            arm = _recipe_arm(torch, K, card, stream, tr, x, y, res,
                              "(c) scatter + position, host metadata", dict(dedup_route="scatter"))
            del arm
            torch.cuda.empty_cache()
            _recipe_timing(torch, card, tr, x, y, res, stream)
            del tr
            torch.cuda.empty_cache()
        out[stream] = res
    # ---- the Zipf stream: four arms from one init, and replay against eager
    slot, x, y, res = kept
    arms = {"(b) gather + position": dict(update_space="position"),
            "(c) scatter + position, host metadata": dict(dedup_route="scatter"),
            "(d) device_metadata": dict(device_metadata=True),
            "(a) once more, eager (scan_steps 0)": dict(scan=0)}
    for name, extra in arms.items():
        arm = _recipe_arm(torch, K, card, "zipf", slot, x, y, res, name, extra)
        if name.startswith("(b)"):
            ids, dense = arm.pack_inputs(x)
            batch = [torch.from_numpy(np.ascontiguousarray(a[:FLAGSHIP_BATCH])).to(DEV)
                     for a in (ids, dense, y)] + [None, torch.ones(FLAGSHIP_BATCH, device=DEV)]
            _sync_free_step(torch, arm, batch, arm.host_metadata(ids[:FLAGSHIP_BATCH]))
            log(f"[13] an eager gather-route step (position space) ran under "
                f"set_sync_debug_mode('error') [{card}]")
        del arm
        torch.cuda.empty_cache()
    ids, dense = slot.pack_inputs(x)
    batch = [torch.from_numpy(np.ascontiguousarray(a[:FLAGSHIP_BATCH])).to(DEV)
             for a in (ids, dense, y)] + [None, torch.ones(FLAGSHIP_BATCH, device=DEV)]
    _sync_free_step(torch, slot, batch, slot.host_metadata(ids[:FLAGSHIP_BATCH]))
    log(f"[13] an eager slot-space step ran under set_sync_debug_mode('error') [{card}]")
    _recipe_timing(torch, card, slot, x, y, res, "zipf")
    del slot, kept
    torch.cuda.empty_cache()
    out["cli"] = _recipe_cli(torch, K, card)
    out["card_vs_cpu"] = recipe_card_vs_cpu(torch, K, card)
    return out


def _recipe_arm(torch, K, card, stream, ref, x, y, res, name, extra):
    """One more fit of the recipe on ``stream``'s ids with ``extra`` from the
    same init, held bitwise against ``ref`` (table and moment planes, dense
    parameters, optimizer states, losses), and its replayed step's device
    time as ``_recipe_timing`` takes it; both go into ``res``.  Returns the
    arm's trainer."""
    extra = dict(extra)
    scan = extra.pop("scan", SCAN_GRAPH)
    arm = _recipe_trainer(torch, scan=scan, **extra)
    r = _recipe_fit(torch, K, arm, x, y)
    bad = _held_bitwise(torch, ref, arm)
    res.setdefault("arms_bitwise", {})[name] = bad[:8]
    log(f"[13] {stream}, {name}: {(arm.dedup_route, arm.update_space)}, graph replays "
        f"{r['graph_replays']}; against {(ref.dedup_route, ref.update_space)}: "
        f"{'bitwise equal' if not bad else 'DIFFER in ' + str(bad[:8])} (table and moment "
        f"planes, dense parameters, optimizer states, losses) [{card}]")
    if bad:
        raise AssertionError(f"phase 13, {stream}: {name} differs from "
                             f"{(ref.dedup_route, ref.update_space)} in {bad[:8]}")
    if scan:
        dev_ms, _ = _replayed_step_device_ms(torch, arm, x, y, FLAGSHIP_BATCH, shuffle="block")
        res.setdefault("arms_replayed_step_device_ms", {})[name] = dev_ms
        log(f"[13] {stream}, {name}: a replayed step's device time "
            f"{'not measured' if dev_ms is None else f'{dev_ms:.3f} ms'} [{card}]")
    return arm


def _recipe_cli(torch, K, card):
    """The recipe through the CLI on the card: ``config_AE.json`` with
    ``table_opt_dtype: "bfloat16"`` and ``shuffle_mode: "block"``, all else
    as shipped (``table_update: "auto"``, no ``device_metadata``), at phase
    11's cut (2 epochs of 512-row batches) and vocab 65,536: the CLI opts
    into the stacked container, auto takes the write kernel and the gather
    route, the native pass builds the metadata."""
    from mmlrec_tpu_torch.main import parse_args, run
    from mmlrec_tpu_torch.train import sparse_embedding as SE

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_recipe_") as work:
        raw, path = _cut_config(AE_CONFIG, work, CLI_EPOCHS, CLI_BATCH)
        raw["model_config"]["table_opt_dtype"] = "bfloat16"
        raw["training_config"]["shuffle_mode"] = "block"
        with open(path, "w") as f:
            json.dump(raw, f)
        os.chdir(work)
        try:
            K.reset_launch_counts()
            SE.reset_metadata_calls()
            (row, tr), = run(parse_args(["--config", path, "--seed", "0", "--synthetic",
                                         "--synthetic_rows", str(CLI_ROWS),
                                         "--synthetic_vocab", "65536"]))
            torch.cuda.synchronize()
        finally:
            os.chdir(cwd)
    steps = len(tr.history) * (CLI_ROWS // CLI_BATCH)
    launches = {k: v for k, v in K.launch_counts.items() if v}
    resolved = (tr.table_update, tr.table_container, tr.dedup_route, tr.update_space,
                tr.device_metadata)
    calls = dict(SE.metadata_calls)
    log(f"[13] {AE_CONFIG} with table_opt_dtype bfloat16 and shuffle_mode block through the "
        f"CLI, vocab 65536: resolved {resolved}; metadata calls {calls}; {steps} steps; "
        f"launches {launches}; row {row} [{card}]")
    if resolved[:3] != ("pallas", "stacked", "gather") or resolved[4] or calls["numpy"] \
            or not calls["native"]:
        raise AssertionError(f"phase 13: the CLI resolved {resolved} with metadata {calls}")
    for name in ("rows_gather_dual", "rows_write_dual"):
        if launches.get(name) != steps:
            raise AssertionError(f"phase 13: the CLI's {name} ran {launches.get(name)} times in "
                                 f"{steps} steps")
    if not all(np.isfinite(v) for k, v in row.items() if k != "type"):
        raise AssertionError(f"phase 13: the CLI's row {row}")
    return dict(resolved=resolved, metadata_calls=calls, steps=steps, launches=launches, row=row)


def _dedup_sum_us(torch, tr, flat):
    """Device us of the step's gradient sums on one batch's metadata: the
    scatter route's inv-scatter against the gather route's duplicate lists
    (``index_put_`` with accumulate, a run of equal targets summed by one
    thread: a heavy hitter's run is serial)."""
    from mmlrec_tpu_torch.tools.timing import device_ms
    from mmlrec_tpu_torch.train import sparse_embedding as SE
    from mmlrec_tpu_torch.train import staging

    meta = [torch.from_numpy(a[0]).to(DEV) for a in staging.step_metadata(tr, flat)]
    g = torch.randn(flat.shape[1], FULL_EMB, device=DEV)
    return {"inv-scatter (scatter route)": device_ms(lambda: SE._segment_sum(g, meta[0])) * 1e3,
            "duplicate lists (gather route)": device_ms(
                lambda: SE._gdup_sum(g, meta[9], meta[10])) * 1e3}


def _card_arithmetic(torch, card):
    """Two facts of the card's arithmetic that the routes' bitwise pins rest
    on: ``torch.sqrt`` in f32 is correctly rounded (the f64 root rounded,
    on 2^22 inputs; the CPU build's vectorised one is not, so the port
    takes the f64 root there), and ``index_put_`` with accumulate adds a
    target's values first and then the sum to the old value (old 1.0 plus
    [1e8, -1e8] gives 1.0; in order from the old value it would give 0.0),
    which is why the gather route's gradient sums run their first
    occurrences in the run, from zeros."""
    x = torch.rand(1 << 22, device=DEV, generator=torch.Generator(DEV).manual_seed(0)) * 4
    sqrt_exact = bool(torch.equal(torch.sqrt(x), torch.sqrt(x.double()).float()))
    vals = torch.tensor([1e8, -1e8], device=DEV)[:, None].expand(2, FULL_EMB).contiguous()
    old = torch.ones(1, FULL_EMB, device=DEV)
    got = float(old.index_put_((torch.zeros(2, dtype=torch.long, device=DEV),), vals,
                               accumulate=True)[0, 0])
    log(f"[13] the card's f32 sqrt correctly rounded on 2^22 inputs: {sqrt_exact}; "
        f"index_put_ accumulate, old 1.0 + [1e8, -1e8] -> {got} (1.0: old + the values' sum) "
        f"[{card}]")
    if not sqrt_exact:
        raise AssertionError("phase 13: the card's f32 sqrt is not correctly rounded")
    return dict(sqrt_correctly_rounded=sqrt_exact, index_put_accumulate_old_plus_sum=got == 1.0)


def _recipe_timing(torch, card, tr, x, y, res, stream):
    """A replayed step's device time (a further graph fit whose last epoch
    queues behind a spin, as phase 12 times it) and the busy share of the
    fit's last epoch."""
    dev_ms, queued = _replayed_step_device_ms(torch, tr, x, y, FLAGSHIP_BATCH, shuffle="block")
    wall = res["step_ms_wall_last_epoch"]
    busy = None if dev_ms is None else dev_ms / wall
    res.update(replayed_step_device_ms=dev_ms, replayed_epoch_queued_host_ms=queued,
               device_busy_share=busy)
    log(f"[13] {stream} ids, the recipe's fit ({RECIPE_BATCHES} batches x {RECIPE_EPOCHS} "
        f"epochs, block mode, graph replay): fit {res['fit_s']:.2f} s, "
        f"{res['fit_examples_per_s']:.0f} examples/s (first epoch left out); last epoch "
        f"{wall:.3f} ms a step (host clock, its sync included); a replayed step's device time "
        f"{'not measured' if dev_ms is None else f'{dev_ms:.3f} ms'} (its replays queued in "
        f"{queued:.1f} ms), busy {'not measured' if busy is None else f'{busy:.1%}'}; host "
        f"metadata of the fit's {RECIPE_BATCHES} batches {res['host_metadata_ms']:.1f} ms "
        f"(native, the card idle); host ms by epoch (prep, issue, sync, steps' device span) "
        f"{[tuple(round(v, 2) for v in t.values()) for t in res['host_ms_by_epoch']]} [{card}]")


# the new routes at phase 7's shapes, card against CPU: name -> (model_config,
# the row kernels the route launches once a step on the card)
RECIPE_CARD_VS_CPU = {
    "gather route, stacked": (dict(RECIPE, update_space="position"),
                              ("rows_gather_dual", "rows_write_dual")),
    "gather route, split": (dict(RECIPE, table_container="split", monu_gather="xla"),
                            ("rows_write",)),
    "slot space": (dict(RECIPE, update_space="slot"), ("rows_gather_dual", "rows_write_dual")),
    **{f"split {short}, {update}": (dict(two_phase_embedding=True, table_update=update,
                                         table_opt_dtype=mdt), ())
       for short, mdt in (("bf16", "bfloat16"), ("f16", "float16"))
       for update in ("scatter", "unique")},
}


# sparse_embedding_update's table, card against CPU after 3 steps: at most
# this share of its entries over 1e-6 and none over lr / 4.  A development
# run on the card read 72 of 8.39 M entries over 1e-6 and 7.5e-5 (lr / 13)
# at worst (PERF.md, section 6, PR 9)
SEU_TABLE_SHARE = 2e-5


def recipe_card_vs_cpu(torch, K, card):
    """Phase 13 (2): each new route of the two-phase step at phase 7's
    shapes and tolerances (``_two_phase_card_vs_cpu``, host metadata);
    ``sparse_embedding_update`` on the dense fit at phase 9's rule (sigmoid
    DNNs); and the card's refusal of f16 moments under the write kernel."""
    from mmlrec_tpu_torch.convert import load_jax_variables
    from mmlrec_tpu_torch.models import get_model
    from mmlrec_tpu_torch.synthetic import aliexpress_like_config, make_data
    from mmlrec_tpu_torch.train import Trainer

    out = {name: _two_phase_card_vs_cpu(torch, K, card, "13", name, extra, kernels)
           for name, (extra, kernels) in RECIPE_CARD_VS_CPU.items()}
    vocab, batch = 1 << 16, 4000
    n = 3 * batch - 1000
    # sparse_embedding_update on the dense fit: phase 9's rule, sigmoid DNNs
    cfg = aliexpress_like_config("mmoe", sparse_embedding_update=True, dnn_activation="sigmoid")
    layout, x, y, _ = make_data(cfg, n=n, vocab=vocab, seed=7)
    trainers = {}
    for dev in (DEV, "cpu"):
        model = get_model("mmoe", layout, cfg, device="cpu")
        load_jax_variables(model, _numpy_train_state(model, seed=8))
        trainers[dev] = Trainer(model, seed=0, device=dev).compile()
    gpu, cpu = trainers[DEV], trainers["cpu"]
    gpu.fit(x, y, batch_size=batch, epochs=1, verbose=0)
    cpu.fit(x, y, batch_size=batch, epochs=1, verbose=0)
    lr = cfg.optim_config.lr
    worst, line = _card_vs_cpu_state(gpu, cpu, set(), lr, table_atol=lr / 4,
                                     table_share=SEU_TABLE_SHARE)
    row_moments = {}
    for m in ("mu", "nu"):
        a, b = getattr(gpu.table_opt, m).cpu(), getattr(cpu.table_opt, m)
        row_moments[m] = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
    log(f"[13] sparse_embedding_update (dense fit), card vs CPU, 3 steps: losses "
        f"{gpu.history[-1]['loss']:.9g} / {cpu.history[-1]['loss']:.9g}; {line}; the table's "
        f"row moments, of their largest: {row_moments} (tol mu 2e-5, nu 1e-4) [{card}]")
    np.testing.assert_allclose(gpu.history[-1]["loss"], cpu.history[-1]["loss"], rtol=1e-5)
    if worst["failed"] or row_moments["mu"] > 2e-5 or row_moments["nu"] > 1e-4:
        raise AssertionError("phase 13: sparse_embedding_update left the CPU's tolerance")
    if "embeddings.fused.table" in gpu.opt_state.mu or int(gpu.table_opt.count) != 3:
        raise AssertionError("phase 13: the table reached the dense optimizer")
    out["sparse_embedding_update"] = dict(worst, row_moments=row_moments)
    del gpu, cpu, trainers
    # f16 moments under the write kernel: the card refuses, as JAX does on an accelerator
    cfg = aliexpress_like_config("mmoe", two_phase_embedding=True, table_update="pallas",
                                 table_opt_dtype="float16")
    model = get_model("mmoe", make_data(cfg, n=8, vocab=vocab, seed=7)[0], cfg, device="cpu")
    try:
        Trainer(model, device=DEV)
    except ValueError as e:
        log(f"[13] table_update='pallas' with float16 moments on the card: ValueError ({e}) "
            f"[{card}]")
    else:
        raise AssertionError("phase 13: the card took float16 moments under the write kernel")
    return out


def _update_card_equals_cpu(torch, cpu, x, extra):
    """The table update of ``extra``'s route (the scatter or the unique
    update of split moments) on identical inputs (the CPU trainer's table
    and moments, its first batch's ids with their duplicates, a fixed
    gradient), once on the card and once on the CPU: True when every
    array comes out with the same bits."""
    from mmlrec_tpu_torch.train import sparse_embedding as SE
    from mmlrec_tpu_torch.train import staging

    ids = cpu.pack_inputs(x)[0][:4000]
    flat = staging.flat_ids(cpu, ids, 1)
    g = np.random.default_rng(3).normal(0, 1e-3, (flat.shape[1], cpu._emb_dim)).astype(np.float32)
    P = cpu._emb_pack_factor
    outs = []
    for dev in (DEV, "cpu"):
        st = SE.SparseAdamState(*(a.clone().to(dev) for a in cpu.table_opt))
        table = cpu.table.detach().clone().to(dev)
        gt, ft = torch.from_numpy(g).to(dev), torch.from_numpy(flat[0].astype(np.int32)).to(dev)
        if extra["table_update"] == "scatter":
            inv, rep = (torch.from_numpy(a[0]).to(dev) for a in SE.batch_step_metadata(flat))
            SE.two_phase_sparse_adam(table, gt, ft, inv, rep, st, lr=1e-3, pack_factor=P)
        else:
            meta = [torch.from_numpy(a[0]).to(dev) for a in SE.batch_step_metadata(
                flat, P, cpu._emb_phys_rows)]
            SE.two_phase_sparse_adam_unique(table, gt, ft, *meta[:4], st, lr=1e-3,
                                            pack_factor=P, use_pallas=False)
        outs.append([table.cpu(), st.mu.cpu(), st.nu.cpu()])
    return all(torch.equal(a.view(torch.int16) if a.element_size() == 2 else a.view(torch.int32),
                           b.view(torch.int16) if b.element_size() == 2 else b.view(torch.int32))
               for a, b in zip(*outs))


# ----------------------------------------------------------------------
# phase 14: the per-task gradient methods, the CKA loss, a behaviour sequence
# ----------------------------------------------------------------------
# arm -> (registry name, model_config on top of the flagship's)
PER_TASK_ARMS = {"pcg": ("pcg", {}), "gradnorm": ("mmoe", dict(use_gradnorm=True)),
                 "cagrad": ("mmoe", dict(use_cagrad=True)),
                 "cka": ("mmoe", dict(use_cka_loss=True))}
TASK_BATCHES = 16  # phase 14's staged fits: 16 batches x STAGED_EPOCHS
HIST_VOCAB, HIST_DIM, HIST_MAXLEN = 100_000, 8, 50  # phase 14 (b)'s behaviour sequence
FORWARD_KERNELS = ("embed_concat", "gated_expert_mix", "multihead_score")


def _varlen_inputs(n, seed):
    """The flagship's layout and columns (``aliexpress_like_config``, vocab
    100) plus one behaviour sequence ``hist``: ids in [1, 100,000), id 0
    past a length drawn in 1..50, mean-pooled (dense operand of the
    embed-concat: 8 pooled + 61 dense = 69 columns)."""
    from mmlrec_tpu_torch.features import FeatureLayout, SparseFeat, VarLenSparseFeat
    from mmlrec_tpu_torch.synthetic import aliexpress_like_config, make_data

    base, x, y, _ = make_data(aliexpress_like_config("mmoe"), n=n, vocab=100, seed=seed)
    hist = VarLenSparseFeat(SparseFeat("hist", HIST_VOCAB, HIST_DIM), maxlen=HIST_MAXLEN,
                            combiner="mean")
    layout = FeatureLayout(list(base.feature_columns) + [hist])
    rng = np.random.default_rng(seed + 100)
    lens = rng.integers(1, HIST_MAXLEN + 1, n)
    ids = rng.integers(1, HIST_VOCAB, (n, HIST_MAXLEN))
    x["hist"] = np.where(np.arange(HIST_MAXLEN)[None] < lens[:, None], ids, 0).astype(np.int32)
    return layout, x, y


def _phase14_card_vs_cpu(torch, K, card, tag, name, cfg, layout, x, y, backwards_per_step):
    """Three steps, the last batch partial, card against CPU from one numpy
    init with sigmoid DNNs, phase 9's rule (``_card_vs_cpu_state``);
    GradNorm's state atol 1e-6; the launches and plain backwards a step."""
    from mmlrec_tpu_torch.convert import load_jax_variables
    from mmlrec_tpu_torch.models import get_model
    from mmlrec_tpu_torch.train import Trainer

    def trainer(dev):
        model = get_model(name, layout, cfg, device="cpu")
        load_jax_variables(model, _numpy_train_state(model, seed=10))
        return Trainer(model, seed=0, device=dev).compile(metrics=["auc", "logloss"])

    batch = cfg.training_config.train_batch_size
    gpu, cpu = trainer(DEV), trainer("cpu")
    K.reset_launch_counts()
    gpu.fit(x, y, batch_size=batch, epochs=1, verbose=0)
    torch.cuda.synchronize()
    launches = _per_step(K, 3)
    backwards = {k: v / 3 for k, v in K.backward_counts.items() if v}
    want = {k: 1.0 for k in FORWARD_KERNELS}
    if launches != want or backwards != {k: float(backwards_per_step) for k in FORWARD_KERNELS}:
        raise AssertionError(f"phase 14, {tag}: launches per step {launches}, plain backwards "
                             f"{backwards}, expected 1 each and {backwards_per_step} each")
    cpu.fit(x, y, batch_size=batch, epochs=1, verbose=0)
    lg, lc = gpu.history[-1]["loss"], cpu.history[-1]["loss"]
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    worst, verdict = _card_vs_cpu_state(gpu, cpu, set(), cfg.optim_config.lr)
    gn = None
    if gpu.gn_state is not None:
        gn = {k: (gpu.gn_state[k].cpu().tolist(), cpu.gn_state[k].tolist())
              for k in gpu.gn_state}
        np.testing.assert_allclose(gpu.gn_state["task_weights"].cpu().numpy(),
                                   cpu.gn_state["task_weights"].numpy(), atol=1e-6, rtol=0)
        if int(gpu.gn_state["gn_step"]) != 3 or int(cpu.gn_state["gn_step"]) != 3:
            raise AssertionError(f"phase 14, {tag}: GradNorm took {gn['gn_step']} steps")
    log(f"[14] {tag}, card vs CPU, 3 steps of {batch}, sigmoid DNNs: epoch loss card {lg:.9g} "
        f"cpu {lc:.9g}; {verdict}; GradNorm (card, cpu) {gn}; launches per step {launches}, "
        f"plain backwards per step {backwards} [{card}]")
    if worst["failed"]:
        raise AssertionError(f"phase 14, {tag}: the card's steps left the CPU's tolerance")
    return dict(loss_card=lg, loss_cpu=lc, **worst, gradnorm=gn, launches_per_step=launches,
                backwards_per_step=backwards)


def _resume_bitwise(torch, card, tag, make, x, y, batch):
    """A graph fit of 2 unshuffled epochs against one of 1 epoch, saved with
    ``save_training_state`` and resumed for the second: bitwise equal
    (parameters, buffers, optimizer states, GradNorm's state, the second
    epoch's loss)."""
    full, first, resumed = make(SCAN_GRAPH), make(SCAN_GRAPH), make(SCAN_GRAPH)
    full.fit(x, y, batch_size=batch, epochs=2, shuffle=False, verbose=0)
    first.fit(x, y, batch_size=batch, epochs=1, shuffle=False, verbose=0)
    with tempfile.TemporaryDirectory() as tmp:
        path = first.save_training_state(tmp)
        resumed.fit(x, y, batch_size=batch, epochs=2, shuffle=False, verbose=0,
                    resume_from=path)
    full.history = full.history[1:]
    bad = _held_bitwise(torch, full, resumed)
    log(f"[14] {tag}: a fit resumed from its epoch-1 training state vs the uninterrupted "
        f"2-epoch fit (graph replay): {'bitwise equal' if not bad else 'DIFFER in ' + str(bad)}"
        f"; GradNorm step {int(resumed.gn_state['gn_step'])} [{card}]")
    if bad or int(resumed.gn_state["gn_step"]) != 2 * TASK_BATCHES:
        raise AssertionError(f"phase 14, {tag}: the resumed fit differs: {bad}")
    return dict(bitwise_equal=True, gn_step=int(resumed.gn_state["gn_step"]))


def _varlen_cotangent(torch, card, hist):
    """The varlen table's cotangent at one batch's ids ([4096, 50], id 0 at
    about half the positions, their rows zero as the mean gives them):
    ``segment_sum_rows`` (the step's) against the card's ``index_put_`` with
    accumulate (``scatter_add_rows``), within 1e-5 of the largest entry,
    two runs bitwise equal, with both device times."""
    from mmlrec_tpu_torch.ops.embedding import segment_sum_rows
    from mmlrec_tpu_torch.ops.kernels import scatter_add_rows
    from mmlrec_tpu_torch.tools.timing import device_ms

    idx = torch.from_numpy(np.ascontiguousarray(hist).reshape(-1)).to(DEV).long()
    g = torch.randn((idx.shape[0], HIST_DIM), generator=torch.Generator(DEV).manual_seed(3),
                    device=DEV) * (idx != 0)[:, None]
    scan, again = (segment_sum_rows(g, idx, HIST_VOCAB) for _ in range(2))
    serial = scatter_add_rows(g, idx, HIST_VOCAB)
    err = float((scan - serial).abs().max()) / float(serial.abs().max())
    same = torch.equal(scan.view(torch.int32), again.view(torch.int32))
    scan_us = device_ms(lambda: segment_sum_rows(g, idx, HIST_VOCAB), reps=5, inner=3) * 1e3
    serial_us = device_ms(lambda: scatter_add_rows(g, idx, HIST_VOCAB), reps=5, inner=3) * 1e3
    log(f"[14] varlen table cotangent, {idx.shape[0]} ids into [{HIST_VOCAB}, {HIST_DIM}] "
        f"({int((idx == 0).sum())} padding): segment_sum_rows {scan_us:.1f} us, index_put_ "
        f"accumulate {serial_us:.1f} us; max difference {err:.3g} of the largest entry; two "
        f"runs {'bitwise equal' if same else 'DIFFER'} [{card}]")
    if err > 1e-5 or not same:
        raise AssertionError("phase 14, varlen: segment_sum_rows disagrees or is not deterministic")
    return dict(segment_sum_us=scan_us, index_put_accumulate_us=serial_us,
                max_rel_difference=err, deterministic=same)


def per_task_and_varlen(torch, K, card, flagship_staged):
    """Phase 14: (a) the flagship as ``pcg``, with GradNorm, with CAGrad and
    with the CKA loss: card against CPU, a staged fit replayed against
    eager, a sync-free eager step, the step's device time beside phase
    12's flagship; (b) the flagship with a behaviour sequence: serving
    from a bundle card against CPU, the embed-concat bitwise at its dense
    width, three steps card against CPU and a staged fit replayed against
    eager."""
    from mmlrec_tpu_torch.convert import load_jax_variables
    from mmlrec_tpu_torch.models import get_model
    from mmlrec_tpu_torch.serving import ServingBundle, _pack_from_schema, save_serving_bundle
    from mmlrec_tpu_torch.synthetic import aliexpress_like_config, make_data
    from mmlrec_tpu_torch.tools.timing import device_ms
    from mmlrec_tpu_torch.train import Trainer
    from mmlrec_tpu_torch.utils.seeding import make_generator

    batch = FLAGSHIP_BATCH
    base_ms = flagship_staged["replayed_step_device_ms"]
    out = {"phase12_flagship_replayed_step_device_ms": base_ms}
    # ---- (a) the per-task methods and the CKA loss at the flagship's widths
    layout3, x3, y3, _ = make_data(aliexpress_like_config("mmoe"), n=3 * batch - 1000,
                                   vocab=100, seed=9)
    layout, x, y, _ = make_data(aliexpress_like_config("mmoe"), n=TASK_BATCHES * batch,
                                vocab=100, seed=11)
    for arm, (name, extra) in PER_TASK_ARMS.items():
        cfg = aliexpress_like_config(name, masked_loss=True, dnn_activation="sigmoid", **extra)
        T = 1 if arm == "cka" else cfg.num_tasks
        res = {"card_vs_cpu": _phase14_card_vs_cpu(torch, K, card, arm, name, cfg, layout3, x3,
                                                   y3, T)}

        def make(scan, name=name, extra=extra):
            cfg = aliexpress_like_config(name, masked_loss=True, dnn_dropout=0.2,
                                         scan_steps=scan, **extra)
            model = get_model(name, layout, cfg, generator=make_generator(5, DEV), device=DEV)
            return Trainer(model, seed=0, device=DEV).compile(metrics=["auc", "logloss"])

        res["staged"] = _staged_pair(torch, K, card, f"{arm} (phase 12's flagship config)",
                                     make, x, y, batch, STAGED_EPOCHS, timed_batches=5,
                                     phase=14)
        if arm == "gradnorm":
            res["resume"] = _resume_bitwise(torch, card, arm, make, x, y, batch)
        ms = res["staged"]["replayed_step_device_ms"]
        ratio = None if ms is None or base_ms is None else ms / base_ms
        res["replayed_device_vs_phase12"] = ratio
        log(f"[14] {arm}: a replayed step {'not measured' if ms is None else f'{ms:.3f} ms'} "
            f"of device time against phase 12's flagship "
            f"{'not measured' if base_ms is None else f'{base_ms:.3f} ms'}"
            f"{'' if ratio is None else f' ({ratio:.2f}x)'}; "
            f"{res['staged']['graph']['fit_examples_per_s']:.0f} examples/s [{card}]")
        out[arm] = res
    # ---- (b) a behaviour sequence beside the flagship's columns
    cfg = aliexpress_like_config("mmoe")
    vl, vx, _ = _varlen_inputs(sum(FAMILY_REQUESTS), seed=30)
    model = get_model("mmoe", vl, cfg, device="cpu")
    load_jax_variables(model, numpy_variables(model, seed=31))
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke",
                        "varlen_mmoe")
    save_serving_bundle(model, path)
    gpu, cpu = ServingBundle.load(path, device=DEV), ServingBundle.load(path, device="cpu")
    edges = np.cumsum((0,) + FAMILY_REQUESTS)
    requests = [{k: v[a:b] for k, v in vx.items()} for a, b in zip(edges[:-1], edges[1:])]
    gpu.predict(requests[0])  # warm-up
    torch.cuda.synchronize()
    K.reset_launch_counts()
    outs = [gpu.predict(r) for r in requests]
    serve_launches = {k: v for k, v in K.launch_counts.items() if v}
    if serve_launches != {k: len(requests) for k in FORWARD_KERNELS}:
        raise AssertionError(f"phase 14, varlen: {serve_launches} in {len(requests)} forwards")
    worst = 0.0
    for r, got in zip(requests, outs):
        want = cpu.predict(r)
        if got.shape != (len(r["s0"]), 2) or not np.isfinite(got).all():
            raise AssertionError(f"phase 14, varlen: predictions of shape {got.shape}")
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        worst = max(worst, float(np.abs(got - want).max()))
    # the embed-concat at this dense width, against its plain version
    ids, dense = _pack_from_schema(gpu.meta["packing"], requests[0])
    ids_d, dense_d = torch.from_numpy(ids).to(DEV), torch.from_numpy(dense).to(DEV)
    fused = gpu.model.embeddings.fused
    with torch.no_grad():
        side = torch.cat([*gpu.model.pooled_varlen(ids_d), dense_d], dim=1)
        flat = ids_d[:, :fused.offsets.shape[0]] + fused.offsets[None]
        table = fused.table.view(-1, fused.dim)
        got, want = K.embed_concat(table, flat, side), K.embed_concat_plain(table, flat, side)
        bitwise = torch.equal(got.view(torch.int32), want.view(torch.int32))
        vec_rows = K.embed_concat_vector_rows(ids.shape[0], fused.dim, got.shape[1],
                                              table.data_ptr(), side.data_ptr(), got.data_ptr())
        b7_us = device_ms(lambda: K.embed_concat(table, flat, side), reps=11, inner=10) * 1e3
    log(f"[14] varlen (mmoe, 16 sparse + hist [{HIST_VOCAB}, {HIST_DIM}] maxlen {HIST_MAXLEN} "
        f"mean + 61 dense): {len(requests)} requests from a bundle, max |gpu - cpu| {worst:.3g}; "
        f"launches {serve_launches}; embed_concat at dense width {side.shape[1]} (output "
        f"{got.shape[1]} wide): {vec_rows} of {ids.shape[0]} rows on the vector body, "
        f"{'bitwise equal' if bitwise else 'DIFFERS'} to its plain version, {b7_us:.2f} us "
        f"[{card}]")
    if not bitwise:
        raise AssertionError("phase 14, varlen: embed_concat differs from its plain version")
    varlen = dict(serving_max_abs_err=worst, launches_in_serving=serve_launches,
                  embed_concat_dense_width=int(side.shape[1]), embed_concat_vector_rows=vec_rows,
                  embed_concat_bitwise=bitwise, embed_concat_us=b7_us,
                  table_cotangent=_varlen_cotangent(torch, card, requests[0]["hist"]))
    del gpu, cpu
    vl3, vx3, vy3 = _varlen_inputs(3 * batch - 1000, seed=32)
    smooth = aliexpress_like_config("mmoe", masked_loss=True, dnn_activation="sigmoid")
    varlen["card_vs_cpu"] = _phase14_card_vs_cpu(torch, K, card, "varlen", "mmoe", smooth, vl3,
                                                 vx3, vy3, 1)
    vl, vx, vy = _varlen_inputs(TASK_BATCHES * batch, seed=33)

    def make_varlen(scan):
        cfg = aliexpress_like_config("mmoe", masked_loss=True, dnn_dropout=0.2, scan_steps=scan)
        model = get_model("mmoe", vl, cfg, generator=make_generator(5, DEV), device=DEV)
        return Trainer(model, seed=0, device=DEV).compile(metrics=["auc", "logloss"])

    varlen["staged"] = _staged_pair(torch, K, card, "varlen (phase 12's flagship config + hist)",
                                    make_varlen, vx, vy, batch, STAGED_EPOCHS, timed_batches=5,
                                    phase=14)
    out["varlen"] = varlen
    torch.cuda.empty_cache()
    return out


def _table_and_moments(tr):
    """(table [Vp, W], mu, nu) of a two-phase trainer, the moments as f32."""
    from mmlrec_tpu_torch.train.sparse_embedding import unpack_monu_f32

    if tr.table_container == "stacked" or tr._packed_moments:
        t, monu = _container_views(tr)
        return (t, *unpack_monu_f32(monu))
    return tr.table.detach(), tr.table_opt.mu.float(), tr.table_opt.nu.float()


# ----------------------------------------------------------------------
# phase 16: the seed suite and the lr sweep (train/multi_seed.py, sweep.py)
# ----------------------------------------------------------------------
SUITE_SEEDS = (0, 2, 4, 8)
SUITE_BATCHES = 16  # phase 16 (a)'s staged suite: 16 batches x STAGED_EPOCHS
SEQ_SEEDS, SEQ_BATCHES, SEQ_BATCH = (0, 2), 4, 4000  # (b): phase 7's 2^20 rows
SWEEP_SEEDS, SWEEP_LRS = (0, 2), (1e-3, 1e-2)  # (c)


def _member_view(suite, si):
    """Member ``si`` of a stacked suite after its fit, as the trainer-like
    object ``_card_vs_cpu_state`` reads: its model with the member's state
    and its Adam moments."""
    from types import SimpleNamespace

    model = suite._draw(suite.seeds[si])
    model.load_state_dict(suite.member_variables(si))
    st = suite._opt_state
    return SimpleNamespace(model=model, opt_state=SimpleNamespace(
        mu={k: v[si] for k, v in st.mu.items()}, nu={k: v[si] for k, v in st.nu.items()}))


class _OnHost:
    """A trainer's state copied to the host, as ``_card_vs_cpu_state`` reads
    its CPU side: ``model.state_dict()``, ``model.named_parameters()`` and
    ``opt_state.mu`` / ``.nu`` by name."""

    def __init__(self, tr):
        from types import SimpleNamespace

        sd = {k: v.detach().cpu() for k, v in tr.model.state_dict().items()}
        params = [(k, sd[k]) for k, _ in tr.model.named_parameters()]
        self.model = SimpleNamespace(state_dict=lambda: sd, named_parameters=lambda: params)
        self.opt_state = SimpleNamespace(**{m: {k: v.detach().cpu() for k, v in
                                                getattr(tr.opt_state, m).items()}
                                            for m in ("mu", "nu")})


def _suite_bitwise(torch, a, b) -> list:
    """Names of the stacked variables, flat optimizer buffers, GradNorm state
    and per-member losses where two suites differ in any bit."""
    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    bad = [k for k, v in a.variables.items() if not torch.equal(bits(v), bits(b.variables[k]))]
    for field in a._opt_state._fields:
        x, y = getattr(a._opt_state, field), getattr(b._opt_state, field)
        x, y = (x.flat, y.flat) if hasattr(x, "flat") else (x, y)
        if not torch.equal(bits(x), bits(y)):
            bad.append(f"opt_state/{field}")
    for k, t in (a.gn_state or {}).items():
        if not torch.equal(bits(t), bits(b.gn_state[k])):
            bad.append(f"gradnorm/{k}")
    if [[h["loss"] for h in hs] for hs in a.histories] != \
            [[h["loss"] for h in hs] for hs in b.histories]:
        bad.append("histories")
    return bad


def _fold_checks(torch, K, card, S, cfg):
    """Each forward kernel's folded call at the suite step's shapes (S
    members of batch 4096) against S separate plain calls: B7 bitwise, B5
    and B6 atol 1e-6 / rtol 1e-5; one launch a folded call; the folded
    call's device time beside S separate kernel calls'."""
    from torch.func import vmap

    from mmlrec_tpu_torch.tools.timing import device_ms

    g = torch.Generator(device=DEV).manual_seed(160)
    B, mc = FLAGSHIP_BATCH, cfg.model_config
    F, D, Nd, V = 16, 8, 61, 16 * 100 + 64
    T, E, H, Ht = cfg.num_tasks, mc.num_experts, mc.expert_dnn_hidden_units[-1], \
        mc.tower_dnn_hidden_units[-1]
    table = torch.randn(S, V, D, device=DEV, generator=g)
    ids = torch.randint(0, V, (S, B, F), device=DEV, generator=g, dtype=torch.int32)
    dense = torch.randn(S, B, Nd, device=DEV, generator=g)
    logits = torch.randn(S, B, T, E, device=DEV, generator=g)
    experts = torch.randn(S, B, E, H, device=DEV, generator=g)
    tower = torch.randn(S, B, T, Ht, device=DEV, generator=g)
    weights = torch.randn(S, T, Ht, device=DEV, generator=g)
    bias = torch.randn(S, T, device=DEV, generator=g)
    binary = torch.ones(T, device=DEV)
    cases = {
        "embed_concat": (vmap(K.embed_concat), (table, ids, dense), K.embed_concat,
                         K.embed_concat_plain, 0.0, 0.0),
        "gated_expert_mix": (vmap(K.gated_expert_mix), (logits, experts), K.gated_expert_mix,
                             K.gated_expert_mix_plain, 1e-6, 1e-5),
        "multihead_score": (vmap(K.multihead_score, in_dims=(0, 0, 0, None)),
                            (tower, weights, bias, binary), K.multihead_score,
                            K.multihead_score_plain, 1e-6, 1e-5),
    }
    out = {}
    for name, (folded, args, one, plain, atol, rtol) in cases.items():
        member_args = [tuple(a if a is binary else a[s] for a in args) for s in range(S)]
        with torch.no_grad():
            K.reset_launch_counts()
            got = folded(*args)
            torch.cuda.synchronize()
            launches = K.launch_counts[name]
            want = torch.stack([plain(*m) for m in member_args])
            err = float((got - want).abs().max())
            if atol == 0.0:
                ok = torch.equal(got.view(torch.int32), want.view(torch.int32))
            else:
                ok = bool(torch.allclose(got, want, atol=atol, rtol=rtol))
            fold_us = device_ms(lambda: folded(*args)) * 1e3
            separate_us = device_ms(lambda: [one(*m) for m in member_args]) * 1e3
        out[name] = dict(members=S, launches_per_folded_call=launches, max_abs_err=err,
                         held=("bitwise" if atol == 0.0 else f"atol {atol:g} rtol {rtol:g}"),
                         ok=ok, folded_us=fold_us, separate_us=separate_us,
                         shapes=[list(a.shape) for a in args])
        log(f"[16] {name} folded over {S} members {[list(a.shape) for a in args]}: "
            f"{launches} launch, max |folded - {S} plain calls| {err:.3g} "
            f"({out[name]['held']}: {'ok' if ok else 'FAILED'}); {fold_us:.2f} us against "
            f"{separate_us:.2f} us for {S} separate kernel calls [{card}]")
        if launches != 1 or not ok:
            raise AssertionError(f"phase 16: {name}'s folded call launched {launches} times or "
                                 f"left its plain version (max err {err:.3g})")
    return out


def _suite_vs_solo(torch, K, card, tag, make_suite, make_solo, lrs, x, y, batch):
    """3 steps (the last batch partial), each member of ``make_suite()``
    against ``make_solo(i)`` on the card, both from one numpy init: losses
    rtol 1e-5 and phase 9's rule (``_card_vs_cpu_state``) with the table
    held as one more dense weight (the dense fit steps it with the same
    Adam): at most 1e-4 of all entries over 1e-6 x lr / 1e-3 (phase 9's
    1e-6 at its lr) and none over 3 x lr.
    Phase 9's own table atol (5e-6) was set for one trainer card vs CPU;
    a member's batched products round otherwise than its solo run's, and
    a table lane whose gradient cancels keeps that rounding as a dense
    weight does (a CPU rehearsal moved 1 of 13,312 lanes by 7.6e-6).
    Returns the verdicts and the launches a suite step."""
    from mmlrec_tpu_torch.convert import load_jax_variables

    suite = make_suite()
    inits = [_numpy_train_state(m, seed=10 + i) for i, m in enumerate(suite.members)]
    for m, v in zip(suite.members, inits):
        load_jax_variables(m, v)
    K.reset_launch_counts()
    suite.fit(x, y, batch_size=batch, epochs=1, verbose=0)
    torch.cuda.synchronize()
    launches = _per_step(K, 3)
    backwards = {k: v / 3 for k, v in K.backward_counts.items() if v}
    out = {"launches_per_suite_step": launches, "plain_backwards_per_suite_step": backwards,
           "members": []}
    for i in range(len(suite.seeds)):
        solo = make_solo(i)
        load_jax_variables(solo.model, inits[i])
        solo.fit(x, y, batch_size=batch, epochs=1, verbose=0)
        ls, lo = suite.histories[i][-1]["loss"], solo.history[-1]["loss"]
        worst, verdict = _card_vs_cpu_state(_member_view(suite, i), _OnHost(solo), set(),
                                            lrs[i], table_atol=3 * lrs[i],
                                            over=1e-6 * lrs[i] / 1e-3)
        over = worst["dense_entries_over_1e_6"] + worst["table_entries_over_1e_6"]
        entries = worst["dense_entries"] + worst["table_entries"]
        log(f"[16] {tag}, member {suite.labels[i]} vs its solo fit on the card, 3 steps of "
            f"{batch}: epoch loss {ls:.9g} / {lo:.9g}; {verdict}; dense and table together "
            f"{over} of {entries} entries over {worst['over']:g} (tol {int(1e-4 * entries)}) "
            f"[{card}]")
        if worst["failed"] or over > 1e-4 * entries or abs(ls - lo) > 1e-5 * abs(lo):
            raise AssertionError(f"phase 16, {tag}: member {i} left its solo fit's tolerance")
        out["members"].append(dict(label=suite.labels[i], loss=ls, solo_loss=lo,
                                   worst={k: v for k, v in worst.items()
                                          if k not in ("over_1e_6_by_tensor",)}))
    want = {k: 1.0 for k in FORWARD_KERNELS}
    if launches != want or backwards != want:
        raise AssertionError(f"phase 16, {tag}: launches per suite step {launches}, plain "
                             f"backwards {backwards}, expected 1 each")
    return out, suite


def seed_suite(torch, K, card, flagship_staged):
    """Phase 16: (a) the stacked flagship suite: members against solo fits
    (3 steps, phase 9's rule, dropout 0.2), the folded kernels against
    plain calls, a staged suite fit replayed against eager bitwise with one
    launch of B5-B7 a suite step, a sync-free eager suite step and the
    replayed suite step's device time against 4 x the solo step; (b)
    sequential-shared two-phase members bitwise equal to solo fits, and
    reset_for_seed bitwise equal to the CLI's model; (c) the (seed x lr)
    sweep against solo fits at each lr; (d) the CLI's --vmap_seeds and
    --sweep_lrs."""
    from mmlrec_tpu_torch.main import parse_args, run
    from mmlrec_tpu_torch.models import get_model
    from mmlrec_tpu_torch.synthetic import aliexpress_like_config, make_data
    from mmlrec_tpu_torch.tools.timing import spin_cycles
    from mmlrec_tpu_torch.train import Trainer
    from mmlrec_tpu_torch.train.multi_seed import SeedSuiteTrainer
    from mmlrec_tpu_torch.train.optimizers import get_optimizer
    from mmlrec_tpu_torch.train.sweep import GridSweepTrainer
    from mmlrec_tpu_torch.utils import set_seed
    from mmlrec_tpu_torch.utils.seeding import make_generator

    batch, S = FLAGSHIP_BATCH, len(SUITE_SEEDS)
    out = {}
    # ---- (a) the stacked flagship suite
    layout3, x3, y3, _ = make_data(aliexpress_like_config("mmoe"), n=3 * batch - 1000,
                                   vocab=100, seed=9)
    smooth = aliexpress_like_config("mmoe", masked_loss=True, dnn_activation="sigmoid",
                                    dnn_dropout=0.2)

    def solo3(seed, cfg=smooth, optimizer=None):
        model = get_model("mmoe", layout3, cfg, generator=make_generator(seed, DEV), device=DEV)
        return Trainer(model, seed=seed, device=DEV).compile(optimizer=optimizer,
                                                             metrics=["auc"])

    out["card_vs_solo"], _ = _suite_vs_solo(
        torch, K, card, "stacked flagship suite (sigmoid DNNs, dropout 0.2, masks per member)",
        lambda: SeedSuiteTrainer(get_model("mmoe", layout3, smooth, device=DEV),
                                 seeds=SUITE_SEEDS, device=DEV).compile(metrics=["auc"]),
        lambda i: solo3(SUITE_SEEDS[i]), [smooth.optim_config.lr] * S, x3, y3, batch)
    out["fold"] = _fold_checks(torch, K, card, S, smooth)

    layout, x, y, _ = make_data(aliexpress_like_config("mmoe"), n=SUITE_BATCHES * batch,
                                vocab=100, seed=11)

    def make(scan):
        cfg = aliexpress_like_config("mmoe", masked_loss=True, dnn_dropout=0.2, scan_steps=scan)
        model = get_model("mmoe", layout, cfg, generator=make_generator(5, DEV), device=DEV)
        return SeedSuiteTrainer(model, seeds=SUITE_SEEDS, device=DEV).compile(
            metrics=["auc", "logloss"])

    fits, launches = {}, {}
    for scan in (SCAN_GRAPH, 0):
        fits[scan] = make(scan)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        fits[scan].fit(x, y, batch_size=batch, epochs=STAGED_EPOCHS, verbose=0)
        torch.cuda.synchronize()
        launches[scan] = dict(fit_s=time.perf_counter() - t0,
                              launches=_per_step(K, SUITE_BATCHES * STAGED_EPOCHS),
                              backwards={k: v / (SUITE_BATCHES * STAGED_EPOCHS)
                                         for k, v in K.backward_counts.items() if v},
                              graph_replays=fits[scan].graph_replays)
    graph, eager = fits[SCAN_GRAPH], fits[0]
    differs = _suite_bitwise(torch, graph, eager)
    want = {k: 1.0 for k in FORWARD_KERNELS}
    g_l = launches[SCAN_GRAPH]
    log(f"[16] stacked flagship suite, {S} members x batch {batch}, dropout 0.2, "
        f"{SUITE_BATCHES} batches x {STAGED_EPOCHS} epochs: graph replay (scan_steps "
        f"{SCAN_GRAPH}) vs eager {'bitwise equal' if not differs else 'DIFFER in ' + str(differs)}"
        f" (stacked variables, flat optimizer buffers, losses); launches per suite step "
        f"{g_l['launches']}, plain backwards {g_l['backwards']}, graph replays "
        f"{g_l['graph_replays']}; fits {g_l['fit_s']:.2f} / {launches[0]['fit_s']:.2f} s [{card}]")
    if differs or g_l["launches"] != want or g_l["backwards"] != want \
            or launches[0]["launches"] != want or not g_l["graph_replays"]["train"]:
        raise AssertionError(f"phase 16: the staged suite differs ({differs}) or launched "
                             f"{g_l['launches']} a suite step")
    # one eager suite step without a synchronising call
    ids, dense = eager.tr.pack_inputs(x)
    stacked = [torch.from_numpy(np.ascontiguousarray(a[:batch])).to(DEV)[None].repeat(
        S, *([1] * a.ndim)) if a is not None else None
        for a in (ids, dense, eager.tr._prepare_y(y), eager.tr._domain_mask_from(x))]
    w = torch.ones(batch, device=DEV)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager._reseed()
        eager._stacked_step(*stacked, w)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"[16] one eager suite step ran under set_sync_debug_mode('error') [{card}]")
    del eager, fits
    # the replayed suite step's device time: a further graph fit whose last
    # epoch's replays queue behind a spin (as _replayed_step_device_ms)
    cycles = spin_cycles(REPLAY_SPIN_MS)
    graph.fit(x, y, batch_size=batch, epochs=3, verbose=0,
              epoch_callback=lambda e, _: e == 1 and torch.cuda._sleep(cycles))
    last = graph.fit_timing[-1]
    queued = (last["prep_s"] + last["issue_s"]) * 1e3
    suite_ms = (None if queued > 0.8 * REPLAY_SPIN_MS
                else last["steps_device_s"] * 1e3 / SUITE_BATCHES)
    wall_ms = graph.fit_timing[1]["issue_s"] * 1e3 / SUITE_BATCHES  # the 2nd epoch, unspun
    sync_ms = graph.fit_timing[1]["sync_s"] * 1e3 / SUITE_BATCHES
    step_wall = wall_ms + sync_ms
    solo_ms = flagship_staged["replayed_step_device_ms"]
    ratio = None if suite_ms is None or solo_ms is None else suite_ms / (S * solo_ms)
    busy = None if suite_ms is None else suite_ms / step_wall
    log(f"[16] a replayed suite step ({S} members x {batch}): "
        f"{'not measured' if suite_ms is None else f'{suite_ms:.3f} ms'} of device time (its "
        f"replays queued in {queued:.1f} ms behind a {REPLAY_SPIN_MS:.0f} ms spin) against "
        f"{S} x the solo flagship's {solo_ms} ms (phase 12, this run): "
        f"{'not measured' if ratio is None else f'{ratio:.2f}x'}; wall {step_wall:.3f} ms a "
        f"step (issue + sync of an unspun epoch, host clock), busy "
        f"{'not measured' if busy is None else f'{busy:.1%}'}; "
        f"{S * batch / (step_wall / 1e3):.0f} member examples/s [{card}]")
    # the members of the staged fit against their solo fits (relu: loose)
    preds = graph.predict(x3, batch)
    member_diffs = []
    for i, seed in enumerate(SUITE_SEEDS):
        cfg = aliexpress_like_config("mmoe", masked_loss=True, dnn_dropout=0.2)
        solo = Trainer(get_model("mmoe", layout, cfg, generator=make_generator(seed, DEV),
                                 device=DEV), seed=seed, device=DEV).compile(metrics=["auc"])
        solo.fit(x, y, batch_size=batch, epochs=3, verbose=0)
        losses = [(a["loss"], b["loss"]) for a, b in zip(graph.histories[i], solo.history)]
        member_diffs.append(dict(
            seed=seed, max_loss_rel=max(abs(a - b) / abs(b) for a, b in losses),
            max_pred_abs=float(np.abs(preds[i] - solo.predict(x3, batch)).max())))
        del solo
    log(f"[16] the staged suite's members (relu, 3 epochs) vs their solo fits on the card: "
        f"{member_diffs} [{card}]")
    if any(d["max_loss_rel"] > 1e-3 or d["max_pred_abs"] > 1e-2 for d in member_diffs):
        raise AssertionError(f"phase 16: a staged member left its solo fit: {member_diffs}")
    out["staged"] = dict(members=S, batch=batch, bitwise_equal=not differs,
                         launches_per_suite_step=g_l["launches"],
                         plain_backwards_per_suite_step=g_l["backwards"],
                         graph_replays=g_l["graph_replays"], fit_s=g_l["fit_s"],
                         eager_fit_s=launches[0]["fit_s"], sync_free_eager_step=True,
                         replayed_suite_step_device_ms=suite_ms, replays_queued_host_ms=queued,
                         solo_replayed_step_device_ms_phase12=solo_ms,
                         suite_over_members_x_solo=ratio, step_wall_ms=step_wall,
                         device_busy_share=busy, member_vs_solo=member_diffs)
    del graph
    torch.cuda.empty_cache()

    # ---- (b) sequential-shared: the two-phase stacked step at 2^20 rows
    tp = aliexpress_like_config("mmoe", **TWO_PHASE, table_container="stacked")
    n = SEQ_BATCHES * SEQ_BATCH
    layout_b, xb, yb, _ = make_data(tp, n=n + SEQ_BATCH, vocab=1 << 16, seed=12)
    x_tr, y_tr = {k: v[:n] for k, v in xb.items()}, yb[:n]
    x_val, y_val = {k: v[n:] for k, v in xb.items()}, yb[n:]
    suite = SeedSuiteTrainer(get_model("mmoe", layout_b, tp, generator=make_generator(0, DEV),
                                       device=DEV), seeds=SEQ_SEEDS, device=DEV).compile(
        metrics=["auc"])
    if not suite.sequential:
        raise AssertionError("phase 16 (b): the two-phase suite is not sequential-shared")
    K.reset_launch_counts()
    suite.fit(x_tr, y_tr, batch_size=SEQ_BATCH, epochs=2, validation_data=(x_val, y_val),
              verbose=0)
    torch.cuda.synchronize()
    seq_launches = _per_step(K, len(SEQ_SEEDS) * 2 * SEQ_BATCHES)
    seq_preds = suite.predict(x_val, SEQ_BATCH)
    seq = dict(seeds=list(SEQ_SEEDS), capture_s=suite.capture_s, members=[])
    for i, seed in enumerate(SEQ_SEEDS):
        solo = Trainer(get_model("mmoe", layout_b, tp, generator=make_generator(seed, DEV),
                                 device=DEV), seed=seed, device=DEV).compile(metrics=["auc"])
        solo.fit(x_tr, y_tr, batch_size=SEQ_BATCH, epochs=2, validation_data=(x_val, y_val),
                 verbose=0)
        best = suite._seq_best[i]
        bad = [k for k, v in solo.best_variables.items() if not torch.equal(v, best[k])]
        if [h["loss"] for h in solo.history] != [h["loss"] for h in suite.histories[i]]:
            bad.append("history")
        if not np.array_equal(solo.predict(x_val, SEQ_BATCH), seq_preds[i]):
            bad.append("predictions")
        seq["members"].append(dict(seed=seed, bitwise_equal=not bad, differs=bad[:8]))
        del solo
    cli_model = get_model("mmoe", layout_b, tp, generator=set_seed(SEQ_SEEDS[1], DEV),
                          device=DEV)
    suite.tr.reset_for_seed(SEQ_SEEDS[1])
    reset_bad = [k for k, v in cli_model.state_dict().items()
                 if not torch.equal(v, suite.tr.model.state_dict()[k])]
    seq.update(reset_for_seed_bitwise=not reset_bad, launches_per_step=seq_launches)
    log(f"[16] sequential-shared two-phase suite (phase 7's 2^20 rows, stacked container, "
        f"seeds {list(SEQ_SEEDS)}, {SEQ_BATCHES} batches of {SEQ_BATCH} x 2 epochs): members "
        f"vs solo fits {[(m['seed'], 'bitwise equal' if m['bitwise_equal'] else m['differs']) for m in seq['members']]}"
        f" (best snapshots, losses, predictions); its graphs captured in "
        f"{[round(c, 3) for c in suite.capture_s]} s per seed; reset_for_seed({SEQ_SEEDS[1]}) vs "
        f"the CLI's model {'bitwise equal' if not reset_bad else 'DIFFER in ' + str(reset_bad[:4])}"
        f"; launches per step {seq_launches} [{card}]")
    if reset_bad or not all(m["bitwise_equal"] for m in seq["members"]):
        raise AssertionError("phase 16 (b): a sequential member or reset_for_seed differs")
    out["sequential"] = seq
    del suite, cli_model
    torch.cuda.empty_cache()

    # ---- (c) the (seed x lr) sweep on the flagship, dropout 0
    plain_cfg = aliexpress_like_config("mmoe", masked_loss=True, dnn_activation="sigmoid")
    grid = [(s, lr) for s in SWEEP_SEEDS for lr in SWEEP_LRS]
    sweep_out, sweep = _suite_vs_solo(
        torch, K, card, "stacked (seed x lr) sweep (sigmoid DNNs, dropout 0)",
        lambda: GridSweepTrainer(get_model("mmoe", layout3, plain_cfg, device=DEV),
                                 seeds=SWEEP_SEEDS, lrs=SWEEP_LRS, device=DEV).compile(
            metrics=["auc"]),
        lambda i: solo3(grid[i][0], plain_cfg, get_optimizer("adam", grid[i][1])),
        [lr for _, lr in grid], x3, y3, batch)
    p = sweep.predict(x3, batch)
    lr_gap = float(np.abs(p[0] - p[1]).max())
    sweep_out.update(grid=[dict(seed=s, lr=lr) for s, lr in grid], lrs_differ_max_abs=lr_gap,
                     row_labels=sweep.row_labels)
    log(f"[16] sweep {sweep.labels}: seed {SWEEP_SEEDS[0]}'s predictions at lr "
        f"{SWEEP_LRS[0]} and {SWEEP_LRS[1]} part by {lr_gap:.3g} [{card}]")
    if lr_gap <= 1e-4:
        raise AssertionError("phase 16 (c): the lrs did not differ")
    out["sweep"] = sweep_out
    del sweep

    # ---- (d) the CLI
    cwd, cli = os.getcwd(), {}

    def cli_rows(rel, *flags):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_suite_") as work:
            _, cfg_path = _cut_config(rel, work, CLI_EPOCHS, CLI_BATCH)
            os.chdir(work)
            try:
                return [row for row, _ in run(parse_args([
                    "--config", cfg_path, "--synthetic", "--synthetic_rows", str(CLI_ROWS),
                    "--device", DEV, *flags]))]
            finally:
                os.chdir(cwd)

    metrics_of = (lambda r: {k: v for k, v in r.items()
                             if k not in ("type", "suite_wall_s", "examples_per_s")})
    rel = os.path.join("configs", "example_synthetic_msl.json")
    suite_rows = cli_rows(rel, "--seeds", "0,2", "--vmap_seeds")
    loop_rows = cli_rows(rel, "--seeds", "0,2")
    gaps = [max(abs(metrics_of(a)[k] - metrics_of(b)[k]) for k in metrics_of(b))
            for a, b in zip(suite_rows, loop_rows)]
    same_keys = all(list(metrics_of(a)) == list(metrics_of(b)) and a["type"] == b["type"]
                    and "suite_wall_s" in a for a, b in zip(suite_rows, loop_rows))
    sweep_rows = cli_rows(rel, "--seed", "0", "--sweep_lrs", "0.01,0.001")
    labels = [r["type"] for r in sweep_rows]
    tp_rel = AE_CONFIG
    tp_suite = cli_rows(tp_rel, "--seeds", "0,2", "--vmap_seeds")
    tp_loop = cli_rows(tp_rel, "--seeds", "0,2")
    tp_equal = [metrics_of(a) == metrics_of(b) for a, b in zip(tp_suite, tp_loop)]
    cli = dict(suite_rows=suite_rows, loop_rows=loop_rows, max_metric_gap=gaps,
               sweep_labels=labels, two_phase_suite_rows=tp_suite, two_phase_loop_rows=tp_loop,
               two_phase_rows_bitwise_equal=tp_equal)
    log(f"[16] CLI {rel} --seeds 0,2 --vmap_seeds (stacked): rows {suite_rows}; the loop's "
        f"{loop_rows}; largest metric gap per seed {gaps} [{card}]")
    log(f"[16] CLI --sweep_lrs 0.01,0.001: labels {labels}; {tp_rel} --vmap_seeds "
        f"(sequential-shared) rows equal to the loop's {tp_equal} [{card}]")
    want_labels = [f"synthetic_ae_like_msl_mmoe_0_lr{v}" for v in ("0.01", "0.001")]
    if not same_keys or max(gaps) > 2e-2 or labels != want_labels or not all(tp_equal) \
            or not all(np.isfinite(v) for r in suite_rows + sweep_rows
                       for v in metrics_of(r).values()):
        raise AssertionError(f"phase 16 (d): the CLI's suite rows are off: {cli}")
    out["cli"] = cli
    return out



# ----------------------------------------------------------------------
# phase 17: the CSV pipeline (data.ctrdataset, native/fast_csv.cpp)
# ----------------------------------------------------------------------
CSV_TRAIN, CSV_TEST = 500_000, 125_000  # (b): the AE schema at a realistic size
CSV_HEAD_TRAIN, CSV_HEAD_TEST = 50_000, 12_500  # (b): both backends on the head
# (b): distinct raw values per feature; with the scene's 2, 1,240,802 fused
# rows, 77,568 physical rows (P = 16) above Kp = 69,632 at batch 4096, so the
# shipped AE config takes the write kernel (B3)
CSV_POOLS = (300_000,) * 4 + (10_000,) * 4 + (100,) * 8
CSV_SMALL_TRAIN, CSV_SMALL_TEST = 4096, 1024  # (c): each shipped config
# (c): the columns the fixup datasets hold as strings
CSV_STRING_COLUMNS = {"kuairec": ("user_active_degree",),
                      "iaac": ("item_category_list", "item_property_list",
                               "predict_category_property"),
                      "amazon_new": ("reviewer_id", "asin_id", "style_new")}


def _ascii_digits(values, width):
    """[n, width] uint8: the ASCII digits of each value, zero-padded."""
    powers = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    return ((values[:, None] // powers) % 10 + ord("0")).astype(np.uint8)


def write_ae_csv(out_dir, seed, n_train, n_test, head):
    """A CSV pair at configs/msl/config_AE.json's 81 columns,
    ``ae_train.csv`` / ``ae_test.csv`` in ``out_dir`` and the first rows of
    each under ``head/``: the 16 features as random 9-digit integers drawn
    from pools of ``CSV_POOLS`` distinct values (every value of a pool
    appears), the scene and the label 0 / 1, 62 dense columns written as
    %.6g (values in [0.1, 1) of six significant digits, the last nonzero)
    and the last dense column as %.17g.  The fixed-width part of the rows is
    laid out as bytes by numpy; Python formats the %.17g column only.
    Returns (the files, the header, the %.17g column)."""
    with open(os.path.join(ROOT, AE_CONFIG)) as f:
        dc = json.load(f)["data_config"]
    feats, dense = dc["feature_columns"], dc["dense_columns"]
    labels = list(dict.fromkeys(dc["label_columns"]))
    header = feats + [dc["scene_feature"]] + labels + dense
    n = n_train + n_test
    rng = np.random.default_rng(seed)
    comma = np.full((n, 1), ord(","), np.uint8)
    parts = []
    for k in CSV_POOLS:
        pool = rng.choice(np.unique(rng.integers(10 ** 8, 10 ** 9, 2 * k)), k, replace=False)
        idx = rng.integers(0, k, n)
        idx[rng.choice(n, k, replace=False)] = np.arange(k)  # every pool value appears
        parts += [_ascii_digits(pool[idx], 9), comma]
    for _ in range(1 + len(labels)):  # the scene, the label
        parts += [rng.integers(ord("0"), ord("2"), (n, 1), dtype=np.uint8), comma]
    for _ in dense[:-1]:
        d = rng.integers(ord("0"), ord("9") + 1, (n, 8), dtype=np.uint8)
        d[:, 0], d[:, 1] = ord("0"), ord(".")
        d[:, 2] = rng.integers(ord("1"), ord("9") + 1, n, dtype=np.uint8)
        d[:, 7] = rng.integers(ord("1"), ord("9") + 1, n, dtype=np.uint8)
        parts += [d, comma]
    fixed = np.concatenate(parts, axis=1)
    width = fixed.shape[1]
    flat = fixed.tobytes()
    del fixed, parts
    lines = [flat[i * width:(i + 1) * width] + b"%.17g\n" % v
             for i, v in enumerate(0.1 + 0.9 * rng.random(n))]
    files = {}
    for name, rows in (("ae_train.csv", slice(0, n_train)), ("ae_test.csv", slice(n_train, n)),
                       ("head/ae_train.csv", slice(0, head[0])),
                       ("head/ae_test.csv", slice(n_train, n_train + head[1]))):
        path = os.path.join(out_dir, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write((",".join(header) + "\n").encode())
            f.write(b"".join(lines[rows]))
        files[name] = path
    return files, header, dense[-1]


def write_config_csv(raw, work, seed, n_train, n_test):
    """A CSV pair at a shipped config's schema, at the config's own paths
    under ``work``: labels 0 / 1, dense columns as %.6g, the mask column's
    domains, integer features, and for the fixup datasets string columns
    (kuairec's ``user_active_degree`` with its "0" rows, a float onehot
    column with empty cells)."""
    dc = raw["data_config"]
    path = dc["train_dataset_path"]
    dataset = next((k for k in CSV_STRING_COLUMNS if k in path), "")
    rng = np.random.default_rng(seed)

    def column(name, n):
        if name in dc["label_columns"]:
            return rng.integers(0, 2, n).astype(str)
        if name in dc["dense_columns"]:
            return ["%.6g" % v for v in rng.random(n)]
        if name == "user_active_degree" and dataset == "kuairec":
            return rng.choice(["0", "full_active", "high_active", "middle_active"], n)
        if name == dc.get("mask_column"):
            return rng.integers(0, dc.get("num_domains", 1), n).astype(str)
        if name in CSV_STRING_COLUMNS.get(dataset, ()):
            return [f"{a}:{b};{a + b}" for a, b in rng.integers(0, 30, (n, 2))]
        if name == "onehot_feat0":
            return rng.choice(["0.0", "1.0", ""], n)
        return rng.integers(0, 50, n).astype(str)

    header = list(dc["all_columns"])
    for part, n in ((path, n_train), (dc["test_dataset_path"], n_test)):
        cols = [column(c, n) for c in header]
        os.makedirs(os.path.dirname(os.path.join(work, part)), exist_ok=True)
        with open(os.path.join(work, part), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(header)
            w.writerows(zip(*cols))
    return dataset


def _codes_backend(ds):
    """The backend that built a dataset: the native loader's codes are
    int32, the pandas-equivalent reader's int64."""
    dtypes = {ds.train_input[s.feature.name].dtype for s in ds.layout.sparse_slots}
    if dtypes == {np.dtype(np.int32)}:
        return "native"
    if dtypes == {np.dtype(np.int64)}:
        return "pandas"
    raise AssertionError(f"phase 17: codes of dtypes {dtypes}")


def _backends_equal(nat, pdx, long_col):
    """Phase 17 (b): the two backends on the same head: codes (int32 against
    int64), vocabs, labels and mask equal; dense bitwise, the %.17g column
    (the reader follows pandas' parser, the loader strtod: a few ulps apart,
    held at rtol 1e-12 before the scaling, ``_raw_long_column``) within 1e-12
    of the column's [0, 1] range in f64 (the min-max shift makes the parse's
    relative error an absolute one near 0) and bitwise in f32.  Returns the
    entries of that column whose f64 values differ."""
    sparse = {s.feature.name for s in nat.layout.sparse_slots}
    if ({s.feature.name: s.feature.vocabulary_size for s in nat.layout.sparse_slots}
            != {s.feature.name: s.feature.vocabulary_size for s in pdx.layout.sparse_slots}):
        raise AssertionError("phase 17: the two backends' vocabs differ")
    differ = 0
    for split in ("train_input", "test_input"):
        a_all, b_all = getattr(nat, split), getattr(pdx, split)
        if list(a_all) != list(b_all):
            raise AssertionError(f"phase 17: {split} columns {list(a_all)} vs {list(b_all)}")
        for name in a_all:
            a, b = a_all[name], b_all[name]
            if name in sparse:
                ok = np.array_equal(a, b)
            elif name == long_col:
                ok = (np.allclose(a, b, rtol=0, atol=1e-12) and np.array_equal(
                    a.astype(np.float32).view(np.int32), b.astype(np.float32).view(np.int32)))
                differ += int((a != b).sum())
            else:
                ok = a.dtype == b.dtype and a.tobytes() == b.tobytes()
            if not ok:
                raise AssertionError(f"phase 17: {split} {name} differs between the backends")
    for a, b in ((nat.y_train, pdx.y_train), (nat.y_test, pdx.y_test),
                 (nat.test_mask, pdx.test_mask)):
        if a.tobytes() != b.tobytes():
            raise AssertionError("phase 17: labels or the test mask differ between the backends")
    return differ


def _raw_long_column(paths, long_col):
    """Phase 17 (b): the %.17g column as each backend parses it, before the
    scaling: the loader's strtod against the reader's copy of pandas'
    parser, held at rtol 1e-12; returns the largest relative gap and the
    count of values apart."""
    from mmlrec_tpu_torch import native
    from mmlrec_tpu_torch.data import _read_csv

    loaded = native.load_csv_columns(*paths, [long_col], [0])[0][long_col]
    read = np.concatenate([_read_csv(p, [long_col])[long_col] for p in paths])
    if not np.allclose(loaded, read, rtol=1e-12, atol=0):
        raise AssertionError(f"phase 17: {long_col} parses apart by more than rtol 1e-12")
    return float(np.max(np.abs(loaded - read) / np.abs(read))), int((loaded != read).sum())


def csv_pipeline(torch, K, card, workdir, seed):
    """Phase 17: the CSV pipeline on the H100 machine: (a) the loader built
    from native/fast_csv.cpp at first use; (b) a CSV pair at config_AE.json's
    schema at 500,000 + 125,000 rows loaded by the native loader, its head by
    both backends held equal, the pair fitted through the CLI's functions (1
    epoch at the config's batch of 4096, the write kernel's path); (c) every
    shipped config that names CSV files on a small pair of its schema through
    the CLI, the backend ``auto`` took checked against the path rule; (d)
    config_AE.json's pair card against CPU: 3 steps from one numpy init at
    phase 11's rule, and the CLI's row on the CPU in the card's schema."""
    from mmlrec_tpu_torch import main as cli
    from mmlrec_tpu_torch import native
    from mmlrec_tpu_torch.data import FIXUP_DATASETS, ctrdataset
    from mmlrec_tpu_torch.main import parse_args, run
    from mmlrec_tpu_torch.train import sparse_embedding as SE

    out = {}
    # ---- (a) the loader, built into build/native/ at first use
    lib_path = native.library_path(native.CSV_SOURCE)
    found = lib_path.exists()
    t0 = time.perf_counter()
    native.get_csv_lib()
    out["loader"] = dict(library=os.path.relpath(lib_path, ROOT), built=not found,
                         build_s=time.perf_counter() - t0, flags=" ".join(native.CXX_FLAGS))
    log(f"[17] {'found' if found else 'built'} {out['loader']['library']} from "
        f"native/fast_csv.cpp in {out['loader']['build_s']:.2f} s (g++ {out['loader']['flags']})")

    os.makedirs(workdir, exist_ok=True)
    cwd = os.getcwd()
    # ---- (b) the AE schema at 500,000 + 125,000 rows
    with tempfile.TemporaryDirectory(prefix="chip_smoke_csv_", dir=workdir) as work:
        t0 = time.perf_counter()
        files, header, long_col = write_ae_csv(os.path.join(work, "data"), seed, CSV_TRAIN,
                                               CSV_TEST, (CSV_HEAD_TRAIN, CSV_HEAD_TEST))
        write_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(files[f]) for f in ("ae_train.csv", "ae_test.csv"))
        raw, cfg_path = _cut_config(AE_CONFIG, work, 1)
        os.chdir(work)
        try:
            head_cfg = _shipped_config(cfg_path)
            head_cfg.data_config.train_dataset_path = os.path.join("data", "head", "ae_train.csv")
            head_cfg.data_config.test_dataset_path = os.path.join("data", "head", "ae_test.csv")
            head_rows = CSV_HEAD_TRAIN + CSV_HEAD_TEST
            head_bytes = sum(os.path.getsize(files[f])
                             for f in ("head/ae_train.csv", "head/ae_test.csv"))
            t0 = time.perf_counter()
            nat = ctrdataset(head_cfg, backend="native")
            head_native_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            pdx = ctrdataset(head_cfg, backend="pandas")
            head_pandas_s = time.perf_counter() - t0
            differ = _backends_equal(nat, pdx, long_col)
            raw_gap, raw_differ = _raw_long_column(
                (head_cfg.data_config.train_dataset_path, head_cfg.data_config.test_dataset_path),
                long_col)
            del nat, pdx
            log(f"[17] wrote {nbytes / 1e6:.1f} MB ({len(header)} columns, {CSV_TRAIN} + "
                f"{CSV_TEST} rows) in {write_s:.1f} s; its head ({CSV_HEAD_TRAIN} + "
                f"{CSV_HEAD_TEST} rows, {head_bytes / 1e6:.1f} MB): native {head_native_s:.2f} s "
                f"({head_rows / head_native_s:.0f} rows/s), pandas-equivalent "
                f"{head_pandas_s:.2f} s ({head_rows / head_pandas_s:.0f} rows/s); codes, vocabs, "
                f"labels, mask and the %.6g columns equal bitwise; {long_col} (%.17g) parsed "
                f"{raw_differ} of {head_rows} values apart, by at most {raw_gap:.2e} relative "
                f"(rtol 1e-12), scaled {differ} apart within 1e-12, bitwise in f32 [{card}]")
            # the CLI's own load of the pair, asked for the native loader
            # explicitly (what auto takes on this path) and timed
            loads = []

            def native_load(cfg):
                t1 = time.perf_counter()
                loaded = ctrdataset(cfg, backend="native")
                loads.append((time.perf_counter() - t1, loaded))
                return loaded

            K.reset_launch_counts()
            SE.reset_metadata_calls()
            auto_load, cli.ctrdataset = cli.ctrdataset, native_load
            t0 = time.perf_counter()
            try:
                (row, tr), = run(parse_args(["--config", cfg_path, "--seed", "0"]))
                torch.cuda.synchronize()
            finally:
                cli.ctrdataset = auto_load
            run_s = time.perf_counter() - t0
            written = _check_outputs(AE_CONFIG, raw, row, work)
        finally:
            os.chdir(cwd)
    (load_s, ds), = loads
    batch = tr.cfg.training_config.train_batch_size
    rows_all = CSV_TRAIN + CSV_TEST
    vocabs = [s.feature.vocabulary_size for s in ds.layout.sparse_slots]
    log(f"[17] the native loader read the pair in {load_s:.2f} s of host time: "
        f"{rows_all / load_s:.0f} rows/s, {nbytes / 1e6 / load_s:.1f} MB/s; vocabs {vocabs} "
        f"[{card}]")
    if (vocabs != list(CSV_POOLS) + [2] or len(ds.y_train) != CSV_TRAIN
            or len(ds.y_test) != CSV_TEST or _codes_backend(ds) != "native"):
        raise AssertionError(f"phase 17: the native load gave vocabs {vocabs}, "
                             f"{len(ds.y_train)} + {len(ds.y_test)} rows")
    del ds
    launches = {k: v for k, v in K.launch_counts.items() if v}
    calls = dict(SE.metadata_calls)
    steps = -(-CSV_TRAIN // batch) * len(tr.history)
    fused = tr.model.embeddings.fused
    Kp = -(-batch * len(vocabs) // 256) * 256
    route = (tr.table_update, type(tr.table_opt).__name__, tr.table_container)
    per_step = {"rows_write": launches.get("rows_write", 0) / steps,
                "multihead_score": (launches.get("multihead_score", 0)
                                    - launches.get("embed_concat", 0)) / steps}
    epoch_s = tr.history[-1]["epoch_s"]
    out["ae_full"] = dict(
        rows=[CSV_TRAIN, CSV_TEST], columns=len(header), bytes=nbytes, write_s=write_s,
        native_load_s=load_s, native_rows_per_s=rows_all / load_s,
        native_mb_per_s=nbytes / 1e6 / load_s, head_rows=head_rows, head_bytes=head_bytes,
        head_native_s=head_native_s, head_pandas_s=head_pandas_s,
        head_native_rows_per_s=head_rows / head_native_s,
        head_pandas_rows_per_s=head_rows / head_pandas_s, long_column_parse_differ=raw_differ,
        long_column_parse_max_rel=raw_gap, long_column_scaled_differ=differ,
        vocab_sum=sum(vocabs), table=list(fused.table.shape), pack_factor=fused.pack_factor,
        Kp=Kp, route=list(route), metadata_calls=calls, steps=steps, launches=launches,
        launches_per_step=per_step, epoch_s=epoch_s, cli_s=run_s, row=row, files=written,
        val_auc=[h.get("val_auc") for h in tr.history])
    log(f"[17] {AE_CONFIG} through the CLI on the pair: table {list(fused.table.shape)} (P = "
        f"{fused.pack_factor}, {sum(fused.vocab_sizes)} logical rows = the summed vocabs, "
        f"{fused.phys_rows} physical > Kp = {Kp}), route {route}, host metadata {calls}; "
        f"{steps} steps of {batch}; launches {launches}: B3 {per_step['rows_write']} a step, "
        f"B6 {per_step['multihead_score']} a step beside one B6 and one B7 per evaluated "
        f"batch; load {load_s:.2f} s, the epoch {epoch_s:.2f} s, the whole CLI run "
        f"{run_s:.1f} s (its load included); row {row} [{card}]")
    _check_ae_csv_fit(out["ae_full"], sum(fused.vocab_sizes), fused.phys_rows)
    del tr

    # ---- (c) every shipped config that names CSV files, through the CLI
    out["shipped"] = {}
    for rel in _shipped_configs():
        with open(os.path.join(ROOT, rel)) as f:
            names_files = json.load(f)["data_config"]["train_dataset_path"]
        if not names_files:
            continue  # the example config names no files
        with tempfile.TemporaryDirectory(prefix="chip_smoke_csv_", dir=workdir) as work:
            raw, cfg_path = _cut_config(rel, work, CLI_EPOCHS, CLI_BATCH)
            dataset = write_config_csv(raw, work, seed + 1 + len(out["shipped"]),
                                       CSV_SMALL_TRAIN, CSV_SMALL_TEST)
            want = "pandas" if any(k in raw["data_config"]["train_dataset_path"]
                                   for k in FIXUP_DATASETS) else "native"
            os.chdir(work)
            try:
                ds = ctrdataset(_shipped_config(cfg_path))
                took = _codes_backend(ds)
                if took != want:
                    raise AssertionError(f"phase 17, {rel}: auto took {took}, the path rule "
                                         f"says {want}")
                K.reset_launch_counts()
                SE.reset_metadata_calls()
                t0 = time.perf_counter()
                (row, tr), = run(parse_args(["--config", cfg_path, "--seed", "0"]))
                torch.cuda.synchronize()
                wall_s = time.perf_counter() - t0
                written = _check_outputs(rel, raw, row, work)
                launches = {k: v for k, v in K.launch_counts.items() if v}
                entry = dict(backend=took, strings=dataset or None, rows=[len(ds.y_train),
                             len(ds.y_test)], model=tr.model_name, task=tr.task_name,
                             two_phase=tr.two_phase_embedding,
                             route=tr.table_update if tr.two_phase_embedding else "dense",
                             launches=launches, wall_s=wall_s, row=row, files=written)
                if rel == AE_CONFIG:
                    entry["card_vs_cpu"] = _csv_card_vs_cpu(torch, K, cfg_path, ds, row, card)
            finally:
                os.chdir(cwd)
        _check_launched(f"phase 17, {rel}", launches, "embed_concat")
        out["shipped"][rel] = entry
        log(f"[17] {rel} from CSV ({entry['rows'][0]} + {entry['rows'][1]} rows"
            f"{', string columns of ' + dataset if dataset else ''}): auto took {took}; "
            f"{tr.model_name} {tr.task_name}, route {entry['route']}, {wall_s:.1f} s; launches "
            f"{launches}; row {row} [{card}]")
        del tr, ds

    # ---- (a) the pipeline ran without pandas and scikit-learn
    loaded = [m for m in ("pandas", "sklearn") if m in sys.modules]
    if loaded:
        raise AssertionError(f"phase 17: {loaded} imported")
    return out


def _check_ae_csv_fit(entry, logical_rows, phys_rows):
    """Phase 17 (b)'s fit: the table holds the summed vocabs above Kp, the
    write kernel's route with native host metadata, B3 and B6 once a step
    and B7 in the validation."""
    per_step, launches = entry["launches_per_step"], entry["launches"]
    if (logical_rows != entry["vocab_sum"] or phys_rows <= entry["Kp"]
            or entry["route"] != ["pallas", "SparseAdamState", "split"]
            or entry["metadata_calls"].get("numpy") or not entry["metadata_calls"].get("native")
            or per_step != {"rows_write": 1.0, "multihead_score": 1.0}):
        raise AssertionError(f"phase 17: the AE fit on the CSV pair: {entry}")
    _check_launched("phase 17, the AE fit", launches, "embed_concat")


def _check_launched(what, launches, name):
    if not launches.get(name):
        raise AssertionError(f"{what}: {name} never launched: {launches}")


def _csv_card_vs_cpu(torch, K, cfg_path, ds, card_row, card):
    """Phase 17 (d): config_AE.json on its small CSV pair, card against CPU:
    3 steps of the cut batch from one numpy init, sigmoid DNNs, at phase 11's
    rule (``_held_card_vs_cpu``); then the CLI's row on the CPU, in the
    card's schema (the two draw their weights from different generators)."""
    from mmlrec_tpu_torch.main import parse_args, run

    n = 3 * CLI_BATCH - 100
    x = {k: v[:n] for k, v in ds.train_input.items()}
    y = ds.y_train[:n]
    cfg = _shipped_config(cfg_path, dnn_activation="sigmoid")
    gpu = _config_trainer(cfg, ds, DEV, numpy_seed=12)
    cpu = _config_trainer(_shipped_config(cfg_path, dnn_activation="sigmoid"), ds, "cpu",
                          numpy_seed=12)
    K.reset_launch_counts()
    gpu.fit(x, y, batch_size=CLI_BATCH, epochs=1, shuffle=False, verbose=0)
    torch.cuda.synchronize()
    launches = _per_step(K, 3)
    cpu.fit(x, y, batch_size=CLI_BATCH, epochs=1, shuffle=False, verbose=0)
    lg, lc = gpu.history[-1]["loss"], cpu.history[-1]["loss"]
    worst = _held_card_vs_cpu(gpu, cpu, cfg.optim_config.lr)
    route = (gpu.table_update, type(gpu.table_opt).__name__, gpu.table_container)
    (cpu_row, _), = run(parse_args(["--config", cfg_path, "--seed", "0", "--device", "cpu"]))
    gaps = {k: abs(card_row[k] - cpu_row[k]) for k in card_row
            if k.startswith(("auc", "total_auc", "log_loss"))}
    log(f"[17] (d) {AE_CONFIG} on its CSV pair, 3 steps of {CLI_BATCH} ({n} rows) card vs CPU "
        f"from one numpy init, sigmoid DNNs: route {route}, epoch loss card {lg:.9g} cpu "
        f"{lc:.9g}; {worst}; launches per step {launches}; the CLI's row on the CPU {cpu_row} "
        f"(metric gaps {gaps}: the weights differ) [{card}]")
    if (not np.isclose(lg, lc, rtol=1e-5, atol=0) or worst["failed"]
            or list(cpu_row) != list(card_row) or cpu_row["type"] != card_row["type"]
            or not all(np.isfinite(v) for k, v in cpu_row.items() if k != "type")):
        raise AssertionError("phase 17 (d): the card left the CPU's tolerance, or the CPU's "
                             "row differs in schema")
    return dict(loss_card=lg, loss_cpu=lc, **worst, route=list(route),
                launches_per_step=launches, cpu_row=cpu_row, metric_gaps=gaps)


# ----------------------------------------------------------------------
# phase 18: the probe kernels of benchmarks/
# ----------------------------------------------------------------------
# a child process a probe kernel and a side: ids up to the last row held
# against the plain version, then one id outside the array (negative, or
# past its end), which must stop the kernel; the child exits 0 only if
# nothing stopped it
_OUTSIDE = r"""
import sys, torch
from mmlrec_tpu_torch.tools import probe_rows as P
name, side, rows, dev = sys.argv[1], sys.argv[2], 1024, torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(18)
def ids(*a):
    return torch.tensor(a, dtype=torch.int32, device=dev)
def rand(*shape):
    return torch.rand(shape, generator=g, device=dev)
if name == "probe_rows_write":  # runs of 4
    array, good, vals = rand(rows, 128), ids(8, rows - 4), rand(8, 128)
    bad = ids(8, -4) if side == "negative" else ids(rows - 3, 0)
    kernel = lambda a, i: P.rows_write(a, i, vals, 4)
    plain = lambda a, i: P.rows_write_plain(a, i, vals, 4)
elif name == "probe_window_add":  # windows of 3
    array, good, vals = rand(3 * rows, 128), ids(5, rows - 1), rand(6, 128)
    bad = ids(5, -1) if side == "negative" else ids(rows, 5)
    kernel = lambda a, i: P.window_add(a, i, vals, 3)
    plain = lambda a, i: P.window_add_plain(a, i, vals, 3)
else:  # P2, P3 and P4 on a pair of planes or a table
    array = rand(rows, 128) if name == "probe_rows_gather" else rand(2, rows, 128)
    good, bad = ids(3, rows - 1), ids(3, -1) if side == "negative" else ids(3, rows)
    vals = rand(2, 2, 128)
    kernel, plain = {
        "probe_pairs_write": (lambda a, i: P.pairs_write(a, i, vals),
                              lambda a, i: P.pairs_write_plain(a, i, vals)),
        "probe_rows_gather": (P.rows_gather, P.rows_gather_plain),
        "probe_pairs_gather": (P.pairs_gather, P.pairs_gather_plain)}[name]
got = kernel(array.clone(), good)  # a write's copy, or the gathered rows
want = plain(array, good)
assert torch.equal(got.view(torch.int32), want.view(torch.int32)), name
torch.cuda.synchronize()
print("ids inside: bitwise equal to the plain version", flush=True)
kernel(array, bad)
torch.cuda.synchronize()
print("an id outside the array: NOT stopped", flush=True)
"""
OUTSIDE_SIDES = ("negative", "past the end")


def _probes_outside(card):
    """Phase 18 (b): each probe kernel on ids inside its array, against its
    plain version, then on a negative id and, in another child, on an id
    past its end, each of which must stop it: one child process a kernel
    and a side (a stopped kernel ends its process's CUDA context), all
    started together."""
    here = os.path.dirname(os.path.abspath(__file__))
    children = {(name, side): subprocess.Popen(
        [sys.executable, "-c", _OUTSIDE, name, side], cwd=here, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name in PROBE_KERNELS for side in OUTSIDE_SIDES}
    seen = {name: {} for name in PROBE_KERNELS}
    for (name, side), child in children.items():
        out, err = child.communicate(timeout=300)
        errors = [line for line in err.splitlines()
                  if "CUDA error" in line or "kernel launch failed" in line]
        if child.returncode == 0 or "bitwise equal" not in out or not errors:
            raise AssertionError(f"phase 18 (b): {name}, {side}: exited {child.returncode}: "
                                 f"{out}{err}")
        seen[name][side] = errors[-1].strip()
        log(f"[18] {name}: ids inside bitwise equal to the plain version; an id {side} "
            f"stopped it: {seen[name][side]} [{card}]")
    return seen


def probe_kernels(torch, card):
    """Phase 18: the probe tool's sub-commands with the launch counts reset
    just before (each kernel timed, and held bitwise against its plain
    version by the tool's own checks), then each kernel on ids outside
    its array in child processes."""
    from mmlrec_tpu_torch.ops import cuda_build
    from mmlrec_tpu_torch.tools import probe_rows as P

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cuda_build.reset_launch_counts()
    runs = {cmd: P.run([cmd]) for cmd in P.COMMANDS}
    launches = dict(cuda_build.launch_counts)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    # per timed variant: 3 warm-ups, then 3 + REPS replays of a graph of
    # LAUNCHES launches; per checked variant: CHECK_SETS launches into a
    # write's copy, one gather (B9, the vmem variant: not checked)
    per_variant = 3 + (3 + P.REPS) * P.LAUNCHES
    want = {name: len(variants) * (per_variant + (P.CHECK_SETS if writes else 1))
            for name, (_, variants, writes) in PROBE_KERNELS.items()}
    want["row_gather"] = per_variant
    got = {name: launches.get(name, 0) for name in want}
    others = {n: v for n, v in launches.items() if v and n not in want}
    if got != want or others:
        raise AssertionError(f"phase 18: the tool launched {got} (expected {want}), others {others}")
    outside = _probes_outside(card)
    t2 = time.perf_counter()
    kernels = {}
    for name, (cmd, variants, _) in PROBE_KERNELS.items():
        entries = runs[cmd]["variants"]
        e = entries[variants[0]]
        kernels[name] = dict(
            max_abs_err=0.0, ms=e["us"] / 1e3, plain_ms=e["plain_us"] / 1e3,
            bound_ms=e["bound_us"] / 1e3, bound_by=e["bound_by"],
            library_ms=e["library_us"] / 1e3, library_call=e["library"], launches=got[name],
            variant=f"{cmd} {variants[0]}", variants={v: entries[v] for v in variants},
            outside_the_array=outside[name])
        for v in variants:
            log(f"[18] {name} ({cmd} {v}): {entries[v]['us']:.2f} us a launch, "
                f"{entries[v]['ns_per_row']:.4f} ns/row; bound {entries[v]['bound_us']:.2f} us; "
                f"plain {entries[v]['plain_us']:.2f} us; {entries[v]['library']} "
                f"{entries[v]['library_us']:.2f} us [{card}]")
    log(f"[18] launches in the tool's run {got}; the tool {t1 - t0:.1f} s, the ids outside "
        f"{t2 - t1:.1f} s [{card}]")
    return dict(kernels=kernels, runs=runs, row_gather_launches=got["row_gather"],
                tool_s=t1 - t0, outside_s=t2 - t1)


# ----------------------------------------------------------------------
# phase 19: data parallel (mmlrec_tpu_torch/parallel, the trainer's mesh)
# ----------------------------------------------------------------------

DP_BATCHES = 16  # (a): phase 12's flagship config, 16 batches x STAGED_EPOCHS
# (b): the world-2 arms, BatchNorm on, 3 steps (the last partial), phase
# 10's sigmoid DNNs so that phase 9's rule applies: arm -> (family, dropout,
# held).  The two held arms run dropout 0.2; the third, MMoE without
# dropout, is a control that is reported and not held (see DP_RULE).
DP_ARMS = {"mmoe+bn": ("mmoe", 0.2, True), "star+bn": ("star", 0.2, True),
           "mmoe+bn, dropout 0 (control)": ("mmoe", 0.0, False)}
DP_WORLD = 2
# (b)'s form of phase 9's rule: LOOSE's, as for STAR and MSSM (every layer
# of both arms feeds a normalisation over the whole batch, whose backward is
# a near-cancelling sum), and the table held as a dense weight, as phase 16
# holds it (the ranks' split sums round otherwise than one sum, and a table
# lane whose gradient cancels keeps that rounding as a dense weight does).
# A development run (PERF.md, section 6) found the MMoE arm's worst Adam mu at
# 3.0e-5 of its tensor's largest (gate_dnn.dense_0.kernel) and one table
# lane 2.6e-4 apart, with phase 9's own form: mu 2e-5, table 5e-6; with
# dropout off both were inside it (the control arm prints that form's
# verdict every run), as the card against the CPU was.
DP_RULE = dict(share=1e-3, mu=1e-3, nu=1e-3, table_share=1e-3)


def _dp_config(name, dropout):
    from mmlrec_tpu_torch.synthetic import aliexpress_like_config

    return aliexpress_like_config(name, dnn_use_bn=True, masked_loss=True,
                                  dnn_activation="sigmoid", dnn_dropout=dropout)


def _dp_trainer(name, layout, dev, cfg, mesh=None):
    from mmlrec_tpu_torch.convert import load_jax_variables
    from mmlrec_tpu_torch.models import get_model
    from mmlrec_tpu_torch.train import Trainer

    model = get_model(name, layout, cfg, device="cpu")
    load_jax_variables(model, _numpy_train_state(model, seed=22))
    return Trainer(model, seed=0, mesh=mesh, device=dev).compile(metrics=["auc"])


def _dp_arm_data(name, dropout):
    from mmlrec_tpu_torch.synthetic import make_data

    cfg = _dp_config(name, dropout)
    batch = cfg.training_config.train_batch_size
    layout, x, y, _ = make_data(cfg, n=3 * batch - 1000, vocab=100, seed=23)
    return cfg, batch, layout, x, y


def _dp_rank(rank, port, workdir, reports):
    """Phase 19 (b): one of two ranks on the one card, over gloo."""
    import torch
    import torch.distributed as dist

    from mmlrec_tpu_torch.ops import kernels as K
    from mmlrec_tpu_torch.parallel import create_mesh
    from mmlrec_tpu_torch.train import staging

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=DP_WORLD)
        mesh = create_mesh(data=DP_WORLD, device="cpu")  # gloo, the tensors on the card
        takes = []
        fetch = staging.fetch_staged_rows
        staging.fetch_staged_rows = lambda tr, st, idx: (
            takes.append(type(st).__name__) or fetch(tr, st, idx))
        for arm, (name, dropout, _) in DP_ARMS.items():
            cfg, batch, layout, x, y = _dp_arm_data(name, dropout)
            tr = _dp_trainer(name, layout, DEV, cfg, mesh)
            del takes[:]
            K.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.fit(x, y, batch_size=batch, epochs=1, verbose=0)
            torch.cuda.synchronize()
            fit_ms = (time.perf_counter() - t0) * 1e3
            state = tr.save_training_state(os.path.join(workdir, arm))
            reports.put((rank, arm, dict(
                losses=[h["loss"] for h in tr.history], fit_ms=fit_ms,
                launches_per_step=_per_step(K, 3), staged_fetches=len(takes),
                staged_kind=sorted(set(takes)), state=state,
                graph_replays=tr.graph_replays["train"]), None))
        dist.destroy_process_group()
    except Exception as e:
        reports.put((rank, None, None, f"{type(e).__name__}: {e}"))
        raise


def _run_ranks(target, workdir, n_reports, tag, world=2):
    """Start ``world`` spawned ranks of ``target`` (phases 19 and 20: two
    ranks on the one card over gloo) and collect their ``n_reports``
    reports {(rank, arm): result}; stops every rank."""
    import multiprocessing as mp
    import queue

    from mmlrec_tpu_torch.parallel.multihost import free_port

    ctx = mp.get_context("spawn")
    reports = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=target, args=(r, port, workdir, reports))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    try:
        while len(got) < n_reports:
            try:
                rank, arm, res, error = reports.get(timeout=5.0)
            except queue.Empty:
                if any(p.exitcode is not None and p.exitcode != 0 for p in procs):
                    raise AssertionError(f"phase {tag}: a rank died without a report")
                continue
            if error is not None:
                raise AssertionError(f"phase {tag}: rank {rank} failed: {error}")
            got[(rank, arm)] = res
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join()
    return got


def _replayed_kernels(torch, tr, x, y, batch):
    """(device µs, kernels and copies) a replayed step: ``torch.profiler``
    over the second epoch of a 2-epoch graph fit (the first one captures)."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])

    def second_epoch(epoch, _):
        if epoch == 0:
            torch.cuda.synchronize()
            prof.start()

    tr.fit(x, y, batch_size=batch, epochs=2, verbose=0, epoch_callback=second_epoch)
    torch.cuda.synchronize()
    prof.stop()
    steps = (len(next(iter(x.values()))) - 1) // batch + 1
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    return sum(e.device_time_total for e in events) / steps, len(events) / steps


def _dp_world1(torch, K, card, flagship_staged):
    """Phase 19 (a): the flagship staged fit on a (data = 1, model = 1) mesh
    over NCCL against the same fit without a mesh, bitwise."""
    import torch.distributed as dist

    from mmlrec_tpu_torch.models import get_model
    from mmlrec_tpu_torch.parallel import create_mesh
    from mmlrec_tpu_torch.parallel.mesh import reduce_scatter
    from mmlrec_tpu_torch.synthetic import aliexpress_like_config, make_data
    from mmlrec_tpu_torch.tools.timing import device_ms
    from mmlrec_tpu_torch.train import Trainer
    from mmlrec_tpu_torch.utils.seeding import make_generator

    batch = FLAGSHIP_BATCH
    layout, x, y, _ = make_data(aliexpress_like_config("mmoe"), n=DP_BATCHES * batch,
                                vocab=100, seed=11)
    mesh = create_mesh(data=1)  # NCCL, a process group of one
    try:
        def make(mesh):
            cfg = aliexpress_like_config("mmoe", masked_loss=True, dnn_dropout=0.2,
                                         scan_steps=SCAN_GRAPH)
            model = get_model("mmoe", layout, cfg, generator=make_generator(5, DEV), device=DEV)
            return Trainer(model, seed=0, mesh=mesh, device=DEV).compile(
                metrics=["auc", "logloss"])

        plain, meshed = make(None), make(mesh)
        runs = {"no mesh": _fit_once(torch, K, plain, x, y, batch, STAGED_EPOCHS),
                "mesh 1x1": _fit_once(torch, K, meshed, x, y, batch, STAGED_EPOCHS)}
        differs = _held_bitwise(torch, meshed, plain)
        preds = [tr.predict(x, batch) for tr in (plain, meshed)]
        if not np.array_equal(preds[0].view(np.int64), preds[1].view(np.int64)):
            differs.append("predictions")
        launches = runs["mesh 1x1"]["launches_per_step"]
        log(f"[19] (a) flagship staged fit on a 1x1 NCCL mesh (scan_steps {SCAN_GRAPH}, "
            f"{DP_BATCHES} batches x {STAGED_EPOCHS} epochs, dropout 0.2) vs the same fit "
            f"without a mesh: {'bitwise equal' if not differs else 'DIFFER in ' + str(differs[:8])}"
            f" (parameters, buffers, optimizer states, losses, predictions); graph replays "
            f"{runs['mesh 1x1']['graph_replays']}; launches per step "
            f"{ {k: round(v, 3) for k, v in launches.items()} } [{card}]")
        if differs:
            raise AssertionError(f"phase 19 (a): the 1x1 mesh fit differs from the plain one: "
                                 f"{differs[:8]}")
        if not runs["mesh 1x1"]["graph_replays"]["train"] or any(
                launches.get(k) != 1.0 for k in FORWARD_KERNELS):
            raise AssertionError(f"phase 19 (a): no replays, or B5-B7 not once a step: "
                                 f"{launches}")
        ids, dense = meshed.pack_inputs(x)
        yy, dmask = meshed._prepare_y(y), meshed._domain_mask_from(x)
        first = [torch.from_numpy(np.ascontiguousarray(a[:batch])).to(DEV) for a in
                 (ids, dense, yy, dmask)] + [torch.ones(batch, device=DEV)]
        _sync_free_step(torch, meshed, first)
        log(f"[19] (a) one eager data-parallel step (the all-reduce and the staged fetch's "
            f"reduce-scatter inside) ran under set_sync_debug_mode('error') [{card}]")
        readings = {"no mesh": [], "mesh 1x1": []}
        for name, tr in (("no mesh", plain), ("mesh 1x1", meshed), ("mesh 1x1", meshed),
                         ("no mesh", plain)):  # in turns
            readings[name].append(_replayed_step_device_ms(torch, tr, x, y, batch)[0])
        replay = {k: None if None in v else statistics.median(v) for k, v in readings.items()}
        kernels_us = {name: _replayed_kernels(torch, tr, x, y, batch)
                      for name, tr in (("no mesh", plain), ("mesh 1x1", meshed))}
        # the step's two collectives at their sizes: the gradients and the
        # loss (one all-reduce) and the staged fetch (one reduce-scatter)
        n_grad = sum(p.numel() for p in meshed.model.parameters()) + 1
        flat = torch.zeros(n_grad, device=DEV)
        width = sum(a.shape[1] for a in (ids, dense, yy, dmask))
        contrib = torch.zeros(batch, width, dtype=torch.int32, device=DEV)
        rows = torch.empty_like(contrib)
        coll_us = {"all_reduce (gradients + loss)": device_ms(lambda: dist.all_reduce(flat)) * 1e3,
                   "reduce_scatter (staged fetch)": device_ms(
                       lambda: reduce_scatter(rows, contrib, None)) * 1e3}
        base = flagship_staged["replayed_step_device_ms"]
        fmt = lambda v: "not measured" if v is None else f"{v:.3f} ms"  # noqa: E731
        log(f"[19] (a) a replayed step's device time, two readings each in turns (no mesh, "
            f"mesh, mesh, no mesh): mesh 1x1 {readings['mesh 1x1']}, no mesh "
            f"{readings['no mesh']}; medians mesh 1x1 {fmt(replay['mesh 1x1'])}, no "
            f"mesh {fmt(replay['no mesh'])} ({DP_BATCHES} batches, this phase), phase 12's "
            f"flagship {fmt(base)} ({DENSE_BATCHES} batches); the step's collectives at world "
            f"1 ({n_grad} f32 all-reduced, [{batch}, {width}] int32 reduce-scattered): "
            f"{ {k: round(v, 2) for k, v in coll_us.items()} } us; a replayed step under "
            f"torch.profiler (us of kernels and copies, their count): "
            f"{ {k: (round(v[0], 1), round(v[1], 1)) for k, v in kernels_us.items()} } [{card}]")
        return dict(bitwise_equal=True, fits=runs, sync_free_eager_step=True,
                    replayed_step_device_ms=replay, replayed_step_device_ms_readings=readings,
                    phase12_replayed_step_device_ms=base,
                    collectives_us_per_step=coll_us, gradient_elements=n_grad,
                    replayed_step_kernels_us_and_count=kernels_us,
                    staged_row_width=width, launches_per_step=launches)
    finally:
        dist.destroy_process_group()


def _dp_world2(torch, K, card, workdir):
    """Phase 19 (b): two ranks on the one card over gloo (NCCL takes one rank
    a card), the flagship-width MMoE with BatchNorm and STAR with
    DomainBatchNorm, 3 steps each (``DP_ARMS``): every rank against the
    single-process fit of the same global batches by phase 9's rule."""
    from mmlrec_tpu_torch.train import checkpointing

    got = _run_ranks(_dp_rank, workdir, DP_WORLD * len(DP_ARMS), "19 (b)", DP_WORLD)
    out = {}
    for arm, (name, dropout, held) in DP_ARMS.items():
        cfg, batch, layout, x, y = _dp_arm_data(name, dropout)
        single = _dp_trainer(name, layout, DEV, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        single.fit(x, y, batch_size=batch, epochs=1, verbose=0)
        torch.cuda.synchronize()
        single_ms = (time.perf_counter() - t0) * 1e3
        ranks = [got[(r, arm)] for r in range(DP_WORLD)]
        restored = _dp_trainer(name, layout, "cpu", cfg)
        restored.init_state()
        checkpointing.restore_training_state(restored, ranks[0]["state"])
        noise = _noise_driven(restored.model)
        lr = cfg.optim_config.lr
        # the held arms by DP_RULE, the control by phase 9's own form
        rule = dict(table_atol=3 * lr, **DP_RULE) if held else {}
        worst, verdict = _card_vs_cpu_state(single, restored, noise, lr, **rule)
        losses = [r["losses"][0] for r in ranks]
        launches = ranks[0]["launches_per_step"]
        log(f"[19] (b) {arm}, world 2 on one card over gloo (BatchNorm, dropout {dropout}, "
            f"3 steps of "
            f"{batch}, the last partial): staged fetches {ranks[0]['staged_fetches']} "
            f"({ranks[0]['staged_kind']}: distributed_take), graph replays "
            f"{ranks[0]['graph_replays']} (gloo steps run eagerly); epoch loss ranks {losses}, "
            f"single process {single.history[-1]['loss']:.9g}; rank 0's state vs the single "
            f"process, {'held by DP_RULE' if held else 'phase 9 own form, reported'}: "
            f"{verdict}; launches per step per rank "
            f"{ {k: round(v, 3) for k, v in launches.items()} }; fit host ms {ranks[0]['fit_ms']:.1f} "
            f"(world 2, gloo) vs {single_ms:.1f} (one process) [{card}]")
        if ((held and worst["failed"]) or len(set(losses)) != 1
                or abs(losses[0] - single.history[-1]["loss"]) > 1e-5 * abs(losses[0])
                or ranks[0]["staged_fetches"] != 3 or ranks[0]["staged_kind"] != ["RankStaged"]
                or launches != {k: 1.0 for k in FORWARD_KERNELS
                                if k != "gated_expert_mix" or name == "mmoe"}):
            raise AssertionError(f"phase 19 (b), {arm}: the world-2 fit left phase 9's rule, "
                                 f"the ranks' losses differ, or the path was not the staged one")
        out[arm] = dict(**worst, held=held, losses_by_rank=losses,
                        loss_single=single.history[-1]["loss"],
                        launches_per_step_per_rank=launches, fit_host_ms_world2=ranks[0]["fit_ms"],
                        fit_host_ms_single=single_ms, staged_fetches=ranks[0]["staged_fetches"])
    return out


def data_parallel(torch, K, card, flagship_staged, workdir):
    """Phase 19: (a) world 1 over NCCL, (b) world 2 over gloo on the card."""
    return {"world1_nccl": _dp_world1(torch, K, card, flagship_staged),
            "world2_gloo": _dp_world2(torch, K, card, os.path.join(workdir, "dp"))}


# phase 20: the row-sharded table
SHARD_MODEL = 4  # (a): the 40 M-row container over four model shards
MP_WORLD = 2  # (b): (data 1, model 2) over gloo on the one card
MP_VOCAB, MP_BATCH, MP_STEPS = 1 << 16, 1024, 3
MP_ARMS = {  # arm -> the model config's extra fields
    "explicit, stacked pallas": dict(
        two_phase_embedding=True, explicit_collective_embedding=True, table_update="pallas",
        table_opt_dtype="bfloat16", table_container="stacked", dedup_route="gather",
        update_space="position"),
    "dense fit, model 2": {},
}


def _bits_equal(torch, a, b) -> bool:
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _max_ulp(torch, a, b) -> int:
    """The largest distance in f32 ulps between two arrays of one sign
    pattern (the int32 of their bits)."""
    d = (a.contiguous().view(torch.int32).long() - b.contiguous().view(torch.int32).long()).abs()
    return int(d.max()) if d.numel() else 0


def _shard_views(sm, i, r):
    """(table, monu) of shard i of a shard-major [2R, W] container."""
    return sm[i * 2 * r:i * 2 * r + r], sm[i * 2 * r + r:(i + 1) * 2 * r]


def _zipf_ids(torch, seed, batch, n_feat, vocab, pack):
    rng = np.random.default_rng(seed)
    local = (rng.zipf(1.1, (batch, n_feat)) - 1) % vocab
    flat = (local + np.arange(n_feat) * vocab).reshape(-1).astype(np.int32)
    flat = torch.from_numpy(flat).to(DEV)
    return flat, torch.div(flat, pack, rounding_mode="floor")


def _event_us(torch, fn) -> float:
    """Device µs of one eager call, between two CUDA events."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) * 1e3


def row_sharded_updates(torch, K, card):
    """Phase 20 (a): the production recipe's 40 M-row table (16 x 2.5 M ids x
    emb 32, P = 4) row-sharded over ``SHARD_MODEL`` model shards in one
    process, each shard's update run in turn with its own window, held
    against the single-chip update of the same inputs; then the windowed
    B1 / B2 / B3 launches of one shard alone against their plain versions."""
    from mmlrec_tpu_torch.ops import cuda_build
    from mmlrec_tpu_torch.ops import row_gather as G
    from mmlrec_tpu_torch.ops import row_scatter as S
    from mmlrec_tpu_torch.parallel import shard_embedding as SH
    from mmlrec_tpu_torch.tools.timing import device_ms
    from mmlrec_tpu_torch.tools.tune_kernels import check_gather_window
    from mmlrec_tpu_torch.train import sparse_embedding as SE

    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(20)
    P, n = 128 // FULL_EMB, SHARD_MODEL
    V, W, B = FULL_FEATURES * FULL_VOCAB // P, 128, FLAGSHIP_BATCH
    Kn, r = B * FULL_FEATURES, FULL_FEATURES * FULL_VOCAB // P // SHARD_MODEL
    lr = 1e-3
    ref = torch.empty((2 * V, W), dtype=torch.float32, device=dev)
    ref[:V].normal_(0.0, 0.1, generator=g)
    ref[V:] = SE.pack_monu(torch.randn((V, W), generator=g, device=dev) * 1e-2,
                           torch.rand((V, W), generator=g, device=dev) * 1e-3)
    sm = SE.fold_stacked_planes(ref[:V], ref[V:], n)  # the shard-major copy
    mu_ref = torch.randn((V, W), generator=g, device=dev) * 1e-2
    nu_ref = torch.rand((V, W), generator=g, device=dev) * 1e-3
    mu_sm, nu_sm = mu_ref.clone(), nu_ref.clone()
    torch.cuda.synchronize()
    gib = torch.cuda.max_memory_allocated() / 2**30

    def metadata(flat):
        meta = SE.batch_step_metadata(flat.cpu().numpy()[None].astype(np.int64), P, V,
                                      want_route=True)
        return [torch.from_numpy(a[0]).to(dev) for a in meta]

    def count(c):
        return torch.tensor(c, dtype=torch.int32, device=dev)

    arms, out = {}, {}
    for arm in ("stacked, position space", "stacked, slot space", "split, packed bf16",
                "split, f32"):
        if arm.endswith("slot space"):
            flat, phys = _zipf_ids(torch, 20, B, FULL_FEATURES, FULL_VOCAB, P)
        else:
            flat, phys = _ids_like_the_step(torch, g, B, FULL_FEATURES, FULL_VOCAB, P)
        inv, rep, pids, pinv, nuniq, prep, *route = metadata(flat)
        rkw = dict(zip(("accperm", "resid_pos", "resid_slot", "gdup_pos", "gdup_tgt"), route))
        g_rows = torch.randn((Kn, FULL_EMB), generator=g, device=dev)
        # the single-chip update
        if arm == "stacked, position space":
            pair = G.rows_gather_dual(ref.view(2, V, W), phys)
            SE.two_phase_sparse_adam_unique(
                ref, g_rows, flat, inv, rep, pids, pinv, SE.SparseAdamFoldedState(count(3)), lr,
                pack_factor=P, n_real=nuniq, sup=pair[0], sup_c=pair[1], prep=prep, **rkw)
        elif arm == "stacked, slot space":
            pair = G.rows_gather_dual(ref.view(2, V, W), pids, n_real=nuniq)
            SE.two_phase_sparse_adam_slot(ref, g_rows, flat, rep, pids, nuniq, pair[0], pair[1],
                                          SE.SparseAdamFoldedState(count(3)), lr, *route,
                                          pack_factor=P)
        elif arm == "split, packed bf16":
            SE.two_phase_sparse_adam_unique(
                ref[:V], g_rows, flat, inv, rep, pids, pinv,
                SE.SparseAdamPackedState(ref[V:], count(3)), lr, pack_factor=P, n_real=nuniq,
                sup=ref[:V].index_select(0, phys.long()), prep=prep, **rkw)
        else:
            SE.two_phase_sparse_adam_unique(
                ref[:V], g_rows, flat, inv, rep, pids, pinv,
                SE.SparseAdamState(mu_ref, nu_ref, count(3)), lr, pack_factor=P, n_real=nuniq,
                sup=ref[:V].index_select(0, phys.long()), prep=prep)
        # each shard in turn, counted and timed
        shard_us, launches, windows = [], [], []
        for i in range(n):
            t_i, m_i = _shard_views(sm, i, r)
            if arm.startswith("stacked"):
                space = arm.split(", ")[1].split()[0]

                def update():
                    SH.sharded_two_phase_sparse_adam_folded(
                        sm[i * 2 * r:(i + 1) * 2 * r], g_rows, flat, inv, rep, pids, pinv,
                        nuniq, prep, SE.SparseAdamFoldedState(count(3)), lr, i, pack_factor=P,
                        update_space=space, **rkw)
            elif arm == "split, packed bf16":
                def update():
                    SH.sharded_two_phase_sparse_adam_pallas(
                        t_i, g_rows, flat, inv, rep, pids, pinv, nuniq, prep,
                        SE.SparseAdamPackedState(m_i, count(3)), lr, i, pack_factor=P, **rkw)
            else:
                def update():
                    SH.sharded_two_phase_sparse_adam_pallas(
                        t_i, g_rows, flat, inv, rep, pids, pinv, nuniq, prep,
                        SE.SparseAdamState(mu_sm[i * r:(i + 1) * r], nu_sm[i * r:(i + 1) * r],
                                           count(3)), lr, i, pack_factor=P)
            cuda_build.reset_launch_counts()
            shard_us.append(_event_us(torch, update))
            launches.append({k: v for k, v in cuda_build.launch_counts.items() if v})
            windows.append(SH.owned_bounds(pids, nuniq, i, r).tolist())
        # the shards against the single-chip arrays: both started equal, so a
        # row that differs must be one the step touched, by at most 2 ulp
        untouched, max_ulp = True, 0
        touched = pids[:int(nuniq[0])].long()
        for i in range(n):
            t_i, m_i = _shard_views(sm, i, r)
            pairs = [(t_i, ref[i * r:(i + 1) * r])]
            if arm == "split, f32":
                pairs += [(mu_sm[i * r:(i + 1) * r], mu_ref[i * r:(i + 1) * r]),
                          (nu_sm[i * r:(i + 1) * r], nu_ref[i * r:(i + 1) * r])]
            else:
                pairs.append((m_i, ref[V + i * r:V + (i + 1) * r]))
            for a, b in pairs:
                if not _bits_equal(torch, a, b):
                    rows = (a.view(torch.int32) != b.view(torch.int32)).any(1).nonzero()[:, 0]
                    untouched = untouched and bool(torch.isin(rows + i * r, touched).all())
                    max_ulp = max(max_ulp, _max_ulp(torch, a, b))
        bitwise = max_ulp == 0
        want = ({"rows_gather_dual": 1, "rows_write_dual": 1} if arm.startswith("stacked")
                else {"rows_write": 1})
        if not untouched or max_ulp > 2 or any(x != want for x in launches):
            raise AssertionError(f"phase 20 (a), {arm}: the shards left the pin (max {max_ulp} "
                                 f"ulp) or launched {launches}, expected {want} a shard")
        log(f"[20] (a) {arm}, table [{V},{W}] over {n} model shards of {r} rows, K = {Kn} ids "
            f"({int(nuniq[0])} distinct rows; windows {windows}): the assembled shards "
            f"{'bitwise equal to' if bitwise else f'within {max_ulp} ulp of'} the single-chip "
            f"update, untouched rows bitwise; launches a step a shard {launches[0]}; each "
            f"shard's update {[round(u, 1) for u in shard_us]} us (one eager call, device "
            f"events); peak {gib:.1f} GiB [{card}]")
        arms[arm] = dict(bitwise=bitwise, max_ulp=max_ulp, shard_us=shard_us,
                         launches_per_step_per_shard=launches[0], windows=windows,
                         distinct_rows=int(nuniq[0]))
    # the windowed kernels alone: shard 1 (its window starts past slot 0, its
    # local ids run negative before it and past r after it), uniform ids
    i = 1
    flat, phys = _ids_like_the_step(torch, g, B, FULL_FEATURES, FULL_VOCAB, P)
    _, _, pids, _, nuniq, _ = metadata(flat)[:6]
    bounds = SH.owned_bounds(pids, nuniq, i, r)
    lo, hi = bounds.tolist()
    lpids = (pids - i * r).to(torch.int32)
    outside = dict(negative=int((lpids < 0).sum()), past_the_shard=int((lpids >= r).sum()))
    stacked = sm[i * 2 * r:(i + 1) * 2 * r].view(2, r, W)
    clipped = lpids.clamp(0, r - 1)
    check_gather_window(stacked, clipped, "phase 20: windowed rows_gather_dual", bounds=bounds)
    cnt, Kp = hi - lo, pids.shape[0]
    win_ids = clipped[lo:hi].long()
    values = torch.randn((2, Kp, W), generator=g, device=dev)
    k_out, p_out = stacked.clone(), stacked.clone()
    S.rows_write_dual(k_out, lpids, values, bounds=bounds)
    S.rows_write_dual_plain(p_out, lpids, values, bounds=bounds)
    torch.cuda.synchronize()
    if not _bits_equal(torch, k_out, p_out):
        raise AssertionError("phase 20: windowed rows_write_dual differs from its plain version")
    ka, pa = (k_out[0], k_out[1]), (p_out[0], p_out[1])
    S.rows_write(ka, lpids, (values[1], values[0]), bounds=bounds)
    S.rows_write_plain(pa, lpids, (values[1], values[0]), bounds=bounds)
    torch.cuda.synchronize()
    if not _bits_equal(torch, k_out, p_out):
        raise AssertionError("phase 20: windowed rows_write differs from its plain version")

    def index_copy_each():
        k_out[0].index_copy_(0, win_ids, values[0, lo:hi])
        k_out[1].index_copy_(0, win_ids, values[1, lo:hi])

    # B1 with its source rows cold: shard 1's windows of four batches in
    # turn (134 MB of rows and outputs, beyond the 50 MB L2), as a step
    # finds them; the library call on the same windows' rows
    cold = [(clipped, bounds)]
    for _ in range(3):
        _, _, c_pids, _, c_nuniq, _ = metadata(
            _ids_like_the_step(torch, g, B, FULL_FEATURES, FULL_VOCAB, P)[0])[:6]
        c_bounds = SH.owned_bounds(c_pids, c_nuniq, i, r)
        cold.append(((c_pids - i * r).clamp(0, r - 1).to(torch.int32), c_bounds))
        check_gather_window(stacked, cold[-1][0], "phase 20: windowed rows_gather_dual",
                            bounds=c_bounds)
    cold_rows = [ids[b[0]:b[1]].long() for ids, b in ((ids, b.tolist()) for ids, b in cold)]
    turns = itertools.cycle(range(len(cold)))

    def cold_run():
        ids, b = cold[next(turns)]
        return G.rows_gather_dual(stacked, ids, bounds=b)

    def cold_library():
        return stacked.index_select(1, cold_rows[next(turns)])

    cold_ms, cold_lib_ms = device_ms(cold_run), device_ms(cold_library)
    cases = {
        "rows_gather_dual": dict(
            run=lambda: G.rows_gather_dual(stacked, clipped, bounds=bounds),
            plain=lambda: G.rows_gather_dual_plain(stacked, clipped, bounds=bounds),
            plain_capturable=True, library=lambda: stacked.index_select(1, win_ids),
            bytes=8 + 4 * cnt + 2 * 2 * 4 * W * cnt),
        "rows_write_dual": dict(
            run=lambda: S.rows_write_dual(k_out, lpids, values, bounds=bounds),
            plain=lambda: S.rows_write_dual_plain(p_out, lpids, values, bounds=bounds),
            plain_capturable=False, library=lambda: k_out.index_copy_(1, win_ids, values[:, lo:hi]),
            bytes=8 + 4 * cnt + 2 * 2 * 4 * W * cnt),
        "rows_write": dict(
            run=lambda: S.rows_write(ka, lpids, (values[1], values[0]), bounds=bounds),
            plain=lambda: S.rows_write_plain(pa, lpids, (values[1], values[0]), bounds=bounds),
            plain_capturable=False, library=index_copy_each,
            bytes=8 + 4 * cnt + 2 * 2 * 4 * W * cnt),
    }
    for name, c in cases.items():
        ms = device_ms(c["run"])
        plain_ms = _time(torch, c["plain"], c["plain_capturable"])
        lib_ms = device_ms(c["library"])
        bound_ms, bound_by = bound(c["bytes"], 0)
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                         bound_by=bound_by, bytes=c["bytes"], bitwise=True, window=[lo, hi],
                         local_ids_outside=outside, launches_per_step_per_shard=1,
                         shapes=f"shard {i} of {n}: [2, {r}, {W}], {Kp} slots")
        held, cold_note = "", ""
        if name == "rows_gather_dual":
            held = " in the window, nothing stored outside it"
            out[name].update(cold_ms=cold_ms, library_cold_ms=cold_lib_ms,
                             cold_windows=[b.tolist() for _, b in cold])
            cold_note = (f"; cold (four batches' windows in turn, beyond the L2): kernel "
                         f"{cold_ms * 1e3:.2f} us, library {cold_lib_ms * 1e3:.2f} us")
        log(f"[20] (a) {name} in window mode, shard {i} of {n} ([2, {r}, {W}], window "
            f"[{lo}, {hi}) of {Kp} slots, local ids outside the shard {outside}): bitwise equal "
            f"to the plain version{held}; kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, "
            f"library {lib_ms * 1e3:.2f} us{cold_note}; {c['bytes'] / 1e6:.2f} MB, bound "
            f"{bound_ms * 1e3:.2f} us ({bound_by}); 1 launch a step a shard [{card}]")
    del ref, sm, mu_ref, nu_ref, mu_sm, nu_sm, k_out, p_out, stacked
    torch.cuda.empty_cache()
    return dict(arms=arms, windowed_kernels=out, peak_gib=gib)


def _mp_model(name, layout, cfg, shards):
    """The flagship's model on the CPU from ``_numpy_train_state``, a
    stacked container refolded shard-major over ``shards``."""
    from mmlrec_tpu_torch.convert import load_jax_variables
    from mmlrec_tpu_torch.models import get_model
    from mmlrec_tpu_torch.train.sparse_embedding import fold_stacked_planes

    import torch

    model = get_model(name, layout, cfg, device="cpu")
    load_jax_variables(model, _numpy_train_state(model, seed=24))
    fused = model.embeddings.fused
    if fused.dual_container and shards > 1:
        with torch.no_grad():
            plane = fused.table[: fused.table.shape[0] // 2].clone()
            fused.table.copy_(fold_stacked_planes(plane, torch.zeros_like(plane), shards))
    return model


def _mp_arm(arm, shards):
    from mmlrec_tpu_torch.synthetic import aliexpress_like_config, make_data

    extra = dict(MP_ARMS[arm])
    if extra.get("table_container") == "stacked":
        extra["stacked_shards"] = shards
    cfg = aliexpress_like_config("mmoe", batch_size=MP_BATCH, **extra)
    vocab = MP_VOCAB if extra else 100
    layout, x, y, _ = make_data(cfg, n=MP_STEPS * MP_BATCH - 100, vocab=vocab, seed=25)
    return cfg, layout, x, y


def _mp_rank(rank, port, workdir, reports):
    """Phase 20 (b): one of two ranks on the one card, over gloo."""
    import torch
    import torch.distributed as dist

    from mmlrec_tpu_torch.ops import kernels as K
    from mmlrec_tpu_torch.parallel import create_mesh
    from mmlrec_tpu_torch.train import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=MP_WORLD)
        mesh = create_mesh(data=1, model=MP_WORLD, device="cpu")  # gloo, the tensors on the card
        for arm in MP_ARMS:
            cfg, layout, x, y = _mp_arm(arm, MP_WORLD)
            tr = Trainer(_mp_model("mmoe", layout, cfg, MP_WORLD), seed=0, mesh=mesh,
                         device=DEV).compile()
            K.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.fit(x, y, batch_size=MP_BATCH, epochs=1, verbose=0, shuffle=False)
            torch.cuda.synchronize()
            fit_ms = (time.perf_counter() - t0) * 1e3
            launches = _per_step(K, MP_STEPS)
            pred = tr.predict(x, MP_BATCH)
            state = tr.save_training_state(os.path.join(workdir, arm.replace(" ", "_")))
            reports.put((rank, arm, dict(
                losses=[h["loss"] for h in tr.history], fit_ms=fit_ms, launches_per_step=launches,
                pred=pred, state=state, table_rows=int(tr.table.shape[0])), None))
        dist.destroy_process_group()
    except Exception as e:
        reports.put((rank, None, None, f"{type(e).__name__}: {e}"))
        raise


def row_sharded_world2(torch, K, card, workdir):
    """Phase 20 (b): (data 1, model 2) over gloo on the one card: the
    explicit two-phase fit of the flagship MMoE (stacked pallas container,
    shard-major) and the dense fit with the table row-sharded, 3 steps each,
    against the same fits in one process on the card."""
    from mmlrec_tpu_torch.train import Trainer, checkpointing
    from mmlrec_tpu_torch.train.sparse_embedding import split_stacked_planes, unpack_monu_f32

    got = _run_ranks(_mp_rank, workdir, MP_WORLD * len(MP_ARMS), "20 (b)")
    out = {}
    for arm in MP_ARMS:
        cfg, layout, x, y = _mp_arm(arm, 1)
        single = Trainer(_mp_model("mmoe", layout, cfg, 1), seed=0, device=DEV).compile()
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        single.fit(x, y, batch_size=MP_BATCH, epochs=1, verbose=0, shuffle=False)
        torch.cuda.synchronize()
        single_ms = (time.perf_counter() - t0) * 1e3
        single_launches = _per_step(K, MP_STEPS)
        pred = single.predict(x, MP_BATCH)
        ranks = [got[(r, arm)] for r in range(MP_WORLD)]
        saved = checkpointing.load_tensors(ranks[0]["state"], checkpointing.STATE_FILE, DEV)
        table = single.table.detach()
        diffs = {}
        if single.two_phase_embedding:
            plane, monu = split_stacked_planes(table, 1)
            diffs["table"] = float((saved["params/embeddings.fused.table"] - plane).abs().max())
            mu, nu = unpack_monu_f32(monu)
            diffs["mu"] = float((saved["table_opt/mu"].float() - mu).abs().max())
            diffs["nu"] = float((saved["table_opt/nu"].float() - nu).abs().max())
        else:
            diffs["table"] = float((saved["params/embeddings.fused.table"] - table).abs().max())
            diffs["table_adam_mu"] = float((saved["opt_state/mu/embeddings.fused.table"]
                                            - single.opt_state.mu["embeddings.fused.table"])
                                           .abs().max())
        diffs["dense"] = max(float((saved[f"params/{k}"] - v.detach()).abs().max())
                             for k, v in single.model.named_parameters()
                             if k != "embeddings.fused.table")
        diffs["pred"] = float(np.abs(ranks[0]["pred"] - pred).max())
        losses = [r["losses"][0] for r in ranks]
        launches = ranks[0]["launches_per_step"]
        ok = (len(set(losses)) == 1 and abs(losses[0] - single.history[-1]["loss"])
              <= 1e-5 * abs(losses[0]) and np.array_equal(ranks[0]["pred"], ranks[1]["pred"])
              and max(diffs.values()) <= 1e-5)
        log(f"[20] (b) {arm}, (data 1, model 2) on one card over gloo, {MP_STEPS} steps of "
            f"{MP_BATCH}: each rank holds {ranks[0]['table_rows']} table rows of "
            f"{table.shape[0]}; epoch loss ranks {losses}, one process "
            f"{single.history[-1]['loss']:.9g}; rank 0's gathered state and predictions vs the "
            f"one process: max |diff| { {k: float(f'{v:.3g}') for k, v in diffs.items()} } "
            f"(tol 1e-5); launches per step per rank { {k: round(v, 3) for k, v in launches.items()} } "
            f"(one process {single_launches}); fit host ms {ranks[0]['fit_ms']:.1f} (world 2, "
            f"gloo) vs {single_ms:.1f} (one process) [{card}]")
        if not ok:
            raise AssertionError(f"phase 20 (b), {arm}: the (data 1, model 2) fit differs from "
                                 "the one process's, or the ranks differ")
        out[arm] = dict(losses_by_rank=losses, loss_single=single.history[-1]["loss"],
                        max_abs_diff=diffs, launches_per_step_per_rank=launches,
                        launches_per_step_single=single_launches,
                        fit_host_ms_world2=ranks[0]["fit_ms"], fit_host_ms_single=single_ms,
                        table_rows_per_rank=ranks[0]["table_rows"])
    return out


# (d): the per-task methods, sparse_embedding_update and the CKA loss with the
# table row-sharded, (data 1, model 2) over gloo: arm -> (registry name, the
# model config's extra fields); the flagship's msl widths, sigmoid DNNs (phase
# 9's rule), MP_STEPS steps of FLAGSHIP_BATCH (the last partial)
MP_TASK_ARMS = {"pcg": ("pcg", {}), "gradnorm": ("mmoe", dict(use_gradnorm=True)),
                "cagrad": ("mmoe", dict(use_cagrad=True)),
                "sparse_embedding_update": ("mmoe", dict(sparse_embedding_update=True)),
                "cka": ("mmoe", dict(use_cka_loss=True))}
# the arms held bitwise against the one process: their sums keep its order.
# The others are held by phase 9's rule with the table counted with the
# dense weights (phase 16's form: dense and table entries together at most
# 1e-4 over 1e-6) and no table entry over MP_TASK_TABLE_ATOL: the merges sum
# each dot product as a replicated part plus the shards' part, and a table
# lane whose merged gradient nearly cancels turns that rounding into a
# visible part of its Adam step, as a dense weight does.  The H100 read 10
# (CAGrad) of 8,388,608 table entries up to 7.1e-6 apart after 3 steps, and
# 2 of pcg's up to 9.5e-6 while one process projected by direct dots; the
# dense ones under 2e-7: the bound is some 5x the worst reading, 1/60 of
# 3 x lr.
MP_TASK_BITWISE = ("sparse_embedding_update",)
MP_TASK_TABLE_ATOL = 5e-5
# the collectives a step calls, as torch.distributed names them
COLLECTIVES = ("all_reduce", "all_gather_into_tensor", "all_gather_single",
               "reduce_scatter_tensor", "reduce_scatter_single", "broadcast")


def _mp_task_arm(arm):
    from mmlrec_tpu_torch.synthetic import aliexpress_like_config, make_data

    name, extra = MP_TASK_ARMS[arm]
    cfg = aliexpress_like_config(name, masked_loss=True, dnn_activation="sigmoid", **extra)
    layout, x, y, _ = make_data(cfg, n=MP_STEPS * FLAGSHIP_BATCH - FLAGSHIP_BATCH // 4,
                                vocab=MP_VOCAB, seed=26)
    return name, cfg, layout, x, y


def _first_batch(torch, tr, x, y, batch):
    ids, dense = tr.pack_inputs(x)
    parts = [torch.from_numpy(np.ascontiguousarray(a[:batch])).to(DEV)
             for a in (ids, dense, tr._prepare_y(y), tr._domain_mask_from(x))]
    return parts + [torch.ones(batch, device=DEV)]


def _sync_free_gloo_step(torch, tr, batch) -> None:
    """One eager step under ``set_sync_debug_mode("error")`` on a gloo mesh:
    gloo moves a CUDA tensor through the host, so each collective call runs
    with the mode off (its own copies exempted, NCCL's would need none);
    anything else in the step that reads a device value on the host
    raises."""
    import torch.distributed as dist

    saved = {n: getattr(dist, n) for n in COLLECTIVES if hasattr(dist, n)}

    def exempt(fn):
        def call(*a, **k):
            torch.cuda.set_sync_debug_mode(0)
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("error")
        return call

    for n, fn in saved.items():
        setattr(dist, n, exempt(fn))
    try:
        _sync_free_step(torch, tr, batch)
    finally:
        for n, fn in saved.items():
            setattr(dist, n, fn)


def _mp_task_rank(rank, port, workdir, reports):
    """Phase 20 (d): one of two ranks on the one card, over gloo."""
    import torch
    import torch.distributed as dist

    from mmlrec_tpu_torch.ops import kernels as K
    from mmlrec_tpu_torch.parallel import create_mesh
    from mmlrec_tpu_torch.train import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=MP_WORLD)
        mesh = create_mesh(data=1, model=MP_WORLD, device="cpu")  # gloo, the tensors on the card
        for arm in MP_TASK_ARMS:
            name, cfg, layout, x, y = _mp_task_arm(arm)
            tr = Trainer(_mp_model(name, layout, cfg, MP_WORLD), seed=0, mesh=mesh,
                         device=DEV).compile()
            K.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.fit(x, y, batch_size=FLAGSHIP_BATCH, epochs=1, verbose=0, shuffle=False)
            torch.cuda.synchronize()
            fit_ms = (time.perf_counter() - t0) * 1e3
            launches = _per_step(K, MP_STEPS)
            backwards = {k: v / MP_STEPS for k, v in K.backward_counts.items() if v}
            pred = tr.predict(x, FLAGSHIP_BATCH)
            state = tr.save_training_state(os.path.join(workdir, arm))
            _sync_free_gloo_step(torch, tr, _first_batch(torch, tr, x, y, FLAGSHIP_BATCH))
            reports.put((rank, arm, dict(
                losses=[h["loss"] for h in tr.history], fit_ms=fit_ms, launches_per_step=launches,
                backwards_per_step=backwards, pred=pred, state=state,
                table_rows=int(tr.table.shape[0])), None))
        dist.destroy_process_group()
    except Exception as e:
        reports.put((rank, None, None, f"{type(e).__name__}: {e}"))
        raise


def row_sharded_tasks(torch, K, card, workdir):
    """Phase 20 (d): the per-task methods, sparse_embedding_update and the
    msl CKA fit at (data 1, model 2) over gloo on the one card, each arm
    against the same fit in one process on the card: bitwise where the
    sums keep the one process's order (``MP_TASK_BITWISE``), else by phase
    9's rule with the table counted with the dense weights and none of its
    entries over ``MP_TASK_TABLE_ATOL``; B5-B7 launches a step a rank; one
    eager step of each rank sync-free (its collectives exempted,
    ``_sync_free_gloo_step``)."""
    from mmlrec_tpu_torch.train import Trainer, checkpointing

    t0 = time.perf_counter()
    got = _run_ranks(_mp_task_rank, workdir, MP_WORLD * len(MP_TASK_ARMS), "20 (d)")
    ranks_s = time.perf_counter() - t0
    out = {}
    for arm in MP_TASK_ARMS:
        name, cfg, layout, x, y = _mp_task_arm(arm)
        single = Trainer(_mp_model(name, layout, cfg, 1), seed=0, device=DEV).compile()
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        single.fit(x, y, batch_size=FLAGSHIP_BATCH, epochs=1, verbose=0, shuffle=False)
        torch.cuda.synchronize()
        single_ms = (time.perf_counter() - t1) * 1e3
        single_launches = _per_step(K, MP_STEPS)
        pred = single.predict(x, FLAGSHIP_BATCH)
        ranks = [got[(r, arm)] for r in range(MP_WORLD)]

        def restored_on(dev):  # rank 0's training state in a one-process trainer
            tr = Trainer(_mp_model(name, layout, cfg, 1), seed=0, device=dev).compile()
            tr.init_state()
            checkpointing.restore_training_state(tr, ranks[0]["state"])
            return tr

        on_card = restored_on(DEV)
        differs = [k for k in _held_bitwise(torch, on_card, single) if k != "history"]
        pred_bitwise = np.array_equal(ranks[0]["pred"].view(np.int32), pred.view(np.int32))
        lr = cfg.optim_config.lr
        worst, verdict = _card_vs_cpu_state(single, restored_on("cpu"), set(), lr,
                                            table_atol=MP_TASK_TABLE_ATOL)
        over = worst["dense_entries_over_1e_6"] + worst["table_entries_over_1e_6"]
        entries = worst["dense_entries"] + worst["table_entries"]
        gn = None
        if single.gn_state is not None:
            gn = float((on_card.gn_state["task_weights"]
                        - single.gn_state["task_weights"]).abs().max())
        losses = [r["losses"][0] for r in ranks]
        launches = ranks[0]["launches_per_step"]
        held_bitwise = arm in MP_TASK_BITWISE
        bitwise = not differs and pred_bitwise and losses[0] == single.history[-1]["loss"]
        log(f"[20] (d) {arm}, (data 1, model 2) on one card over gloo, {MP_STEPS} steps of "
            f"{FLAGSHIP_BATCH} (msl, sigmoid DNNs), each rank {ranks[0]['table_rows']} table "
            f"rows of {single.table.shape[0]}: epoch loss ranks {losses}, one process "
            f"{single.history[-1]['loss']:.9g}; rank 0's restored state and predictions vs the "
            f"one process: {'bitwise equal' if bitwise else 'not bitwise (' + str(differs[:6]) + (', predictions' if not pred_bitwise else '') + ')'}"
            f"{' (held bitwise)' if held_bitwise else ''}; phase 9's rule, the table "
            f"counted with the dense weights: {verdict}; dense and table together {over} of {entries} entries over "
            f"1e-6 (tol {int(1e-4 * entries)}); GradNorm "
            f"weights max |diff| {gn}; launches per step per rank "
            f"{ {k: round(v, 3) for k, v in launches.items()} } (one process "
            f"{ {k: round(v, 3) for k, v in single_launches.items()} }), plain backwards "
            f"{ranks[0]['backwards_per_step']}; one eager step a rank ran under "
            f"set_sync_debug_mode('error') (gloo's collectives exempted); fit host ms "
            f"{ranks[0]['fit_ms']:.1f} (world 2, gloo) vs {single_ms:.1f} (one process) [{card}]")
        if (len(set(losses)) != 1 or not np.array_equal(ranks[0]["pred"], ranks[1]["pred"])
                or (held_bitwise and not bitwise) or worst["failed"] or over > 1e-4 * entries
                or (gn is not None and gn > 1e-6)
                or any(launches.get(k) != 1.0 for k in FORWARD_KERNELS)):
            raise AssertionError(f"phase 20 (d), {arm}: the (data 1, model 2) fit left the one "
                                 "process's bits or phase 9's rule, the ranks differ, or B5-B7 "
                                 "did not run once a step")
        out[arm] = dict(**worst, bitwise_equal=bitwise, held_bitwise=held_bitwise,
                        not_bitwise=differs[:20], losses_by_rank=losses,
                        loss_single=single.history[-1]["loss"], gradnorm_weights_max_diff=gn,
                        launches_per_step_per_rank=launches,
                        launches_per_step_single=single_launches,
                        backwards_per_step_per_rank=ranks[0]["backwards_per_step"],
                        fit_host_ms_world2=ranks[0]["fit_ms"], fit_host_ms_single=single_ms,
                        table_rows_per_rank=ranks[0]["table_rows"], sync_free_eager_step=True)
    log(f"[20] (d) took {time.perf_counter() - t0:.1f} s, the two ranks {ranks_s:.1f} s [{card}]")
    return out


def _sync_free_mesh_step(torch, card) -> dict:
    """Phase 20 (c): one eager step of the explicit two-phase step (the
    stacked pallas container, metadata in the step) on a 1 x 1 NCCL mesh
    under ``set_sync_debug_mode("error")``."""
    import torch.distributed as dist

    from mmlrec_tpu_torch.parallel import create_mesh

    cfg, layout, x, y = _mp_arm("explicit, stacked pallas", 1)
    cfg.model_config.extra.update(device_metadata=True, dedup_route="auto")
    mesh = create_mesh(data=1)  # NCCL, a process group of one
    try:
        from mmlrec_tpu_torch.train import Trainer

        tr = Trainer(_mp_model("mmoe", layout, cfg, 1), seed=0, mesh=mesh, device=DEV).compile()
        ids, dense = tr.pack_inputs(x)
        batch = [torch.from_numpy(np.ascontiguousarray(a[:MP_BATCH])).to(DEV)
                 for a in (ids, dense, tr._prepare_y(y))]
        batch += [None, torch.ones(MP_BATCH, device=DEV)]
        tr.train_step(*batch)  # the first step builds what it caches
        _sync_free_step(torch, tr, batch)
    finally:
        dist.destroy_process_group()
    log(f"[20] (c) one eager explicit two-phase step (stacked pallas, device metadata) on a "
        f"1 x 1 NCCL mesh ran under set_sync_debug_mode('error') [{card}]")
    return {"sync_free_eager_explicit_step": True}


def row_sharded(torch, K, card, workdir):
    """Phase 20: (a) the 40 M-row shards in one process, (b) world 2 over
    gloo on the card, (c) the explicit step free of synchronising calls,
    (d) the per-task methods, sparse_embedding_update and CKA at world 2
    over gloo."""
    t0 = time.perf_counter()
    a = row_sharded_updates(torch, K, card)
    b = row_sharded_world2(torch, K, card, os.path.join(workdir, "mp"))
    c = _sync_free_mesh_step(torch, card)
    d = row_sharded_tasks(torch, K, card, os.path.join(workdir, "mp_tasks"))
    log(f"[20] phase 20 took {time.perf_counter() - t0:.1f} s [{card}]")
    return {"shards_40m": a, "world2_gloo": b, **c, "tasks_world2_gloo": d,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description="Smoke test of mmlrec_tpu_torch on one GPU")
    parser.add_argument("--seed", type=int, default=17,
                        help="the seed of phase 17's CSV files (default 17)")
    args = parser.parse_args(argv)
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
    from mmlrec_tpu_torch.tools import probe_rows

    libraries = (K.LIBRARY, row_gather.LIBRARY, probe_rows.LIBRARY)
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
    embed_backward = check_embed_backward(torch, K, card)
    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
    flagship = serve(torch, K, card, vocab=100, tag="4", workdir=workdir)
    production = serve(torch, K, card, vocab=1 << 16, tag="5", workdir=workdir)
    kernels.update(check_row_kernels(torch, card))
    step = step_card_vs_cpu(torch, K, card)
    full = full_width(torch, K, card)
    dense = dense_fit(torch, K, card)
    families = family_sweep(torch, K, card, workdir)
    shipped, shipped_launches = shipped_cli(torch, K, card)
    K.reset_launch_counts()
    shipped_ae = shipped_full_width(torch, K, card, workdir)
    staged = staged_fits(torch, K, card)
    recipe = production_recipe(torch, K, card)
    task = per_task_and_varlen(torch, K, card, staged["dense_flagship"])
    suite = seed_suite(torch, K, card, staged["dense_flagship"])
    csv_path = csv_pipeline(torch, K, card, workdir, args.seed)
    probes = probe_kernels(torch, card)
    dp = data_parallel(torch, K, card, staged["dense_flagship"], workdir)
    sharded = row_sharded(torch, K, card, workdir)

    launches = {name: flagship["launches"][name] for name in REPLACES
                if name not in ROW_KERNELS + LIBRARY_KERNELS + tuple(PROBE_KERNELS)}
    kernels.update(probes.pop("kernels"))
    launches.update({name: kernels[name].pop("launches") for name in PROBE_KERNELS})
    kernels["row_gather"]["launches_phase18_vmem_variant"] = probes.pop("row_gather_launches")
    launches.update({name: kernels[name].pop("launches") for name in LIBRARY_KERNELS})
    launches.update(rows_gather_dual=full["stacked"]["launches"]["rows_gather_dual"],
                    rows_write_dual=full["stacked"]["launches"]["rows_write_dual"],
                    rows_write=full["split"]["launches"]["rows_write"],
                    rows_gather_hbm=full["split"]["launches"]["rows_gather_hbm"])
    for name in ("embed_concat", "gated_expert_mix", "multihead_score"):
        kernels[name]["launches_per_forward_by_family"] = {
            tag: f["serving"]["launches_per_forward"][name] for tag, f in families.items()
            if "serving" in f}
    kernels["rows_write"]["f32_three_arrays"] = shipped_ae["rows_write_f32_three_arrays"]
    # phase 13: launches a step of the recipe's fits and of its split gather route
    for name in ("rows_gather_dual", "rows_write_dual"):
        kernels[name]["launches_per_step_phase13"] = {
            stream: recipe[stream]["launches_per_step"].get(name) for stream in ("uniform", "zipf")}
    kernels["rows_write"]["launches_per_step_phase13"] = {
        "gather route, split": recipe["card_vs_cpu"]["gather route, split"]["launches_per_step"]
        .get("rows_write")}
    # phase 14: launches a step of the per-task arms and of the varlen fit
    for name in FORWARD_KERNELS:
        kernels[name]["launches_per_step_phase14"] = {
            arm: task[arm]["card_vs_cpu"]["launches_per_step"].get(name)
            for arm in (*PER_TASK_ARMS, "varlen")}
        kernels[name]["plain_backwards_per_step_phase14"] = {
            arm: task[arm]["card_vs_cpu"]["backwards_per_step"].get(name)
            for arm in (*PER_TASK_ARMS, "varlen")}
    # phase 16: launches a suite step (4 members), and each folded call
    for name in FORWARD_KERNELS:
        kernels[name]["launches_per_suite_step_phase16"] = {
            "stacked flagship suite, 4 members": suite["staged"]["launches_per_suite_step"][name],
            "sweep, 4 combinations": suite["sweep"]["launches_per_suite_step"][name]}
        kernels[name]["fold_phase16"] = suite["fold"][name]
    # phase 17: launches in the CLI's fit of the AE pair from CSV (one epoch
    # and its validation: B3 a step, B6 a step and a validation batch, B7 a
    # validation batch; the two-phase step injects its gathered rows)
    for name in ("embed_concat", "multihead_score", "rows_write"):
        kernels[name]["launches_phase17_ae_csv_fit"] = csv_path["ae_full"]["launches"].get(name, 0)
    # phase 19: launches a step of the data-parallel fits, each rank on its rows
    for name in FORWARD_KERNELS:
        kernels[name]["launches_per_step_phase19"] = {
            "world 1 (NCCL), flagship": dp["world1_nccl"]["launches_per_step"].get(name, 0.0),
            **{f"world 2 (gloo), {arm}, per rank": res["launches_per_step_per_rank"].get(name, 0.0)
               for arm, res in dp["world2_gloo"].items()}}
    # phase 20: the row-sharded table: B1-B3 in window mode at 4 model shards,
    # and launches a step a rank of the (data 1, model 2) fits
    for name, res in sharded["shards_40m"]["windowed_kernels"].items():
        kernels[name]["window_mode_phase20"] = res
    for name in ("rows_gather_dual", "rows_write_dual", "rows_write"):
        kernels[name]["launches_per_step_per_shard_phase20"] = {
            arm: r["launches_per_step_per_shard"].get(name, 0)
            for arm, r in sharded["shards_40m"]["arms"].items()}
    for name in (*FORWARD_KERNELS, "rows_gather_dual", "rows_write_dual"):
        kernels[name]["launches_per_step_per_rank_phase20"] = {
            arm: r["launches_per_step_per_rank"].get(name, 0.0)
            for arm, r in sharded["world2_gloo"].items()}
    for name in FORWARD_KERNELS:
        kernels[name]["launches_per_step_per_rank_phase20_d"] = {
            arm: r["launches_per_step_per_rank"].get(name, 0.0)
            for arm, r in sharded["tasks_world2_gloo"].items()}
    kernels["embed_concat"]["phase14_dense_width_69"] = {
        k: task["varlen"][k] for k in ("embed_concat_dense_width", "embed_concat_vector_rows",
                                       "embed_concat_bitwise", "embed_concat_us")}
    line = {"kernels": [
        dict(name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
             launches=launches[name], launches_phase11_cli=shipped_launches.get(name, 0),
             status="ok", **kernels[name])
        for name in REPLACES
    ], "serving": {"flagship_vocab_100": flagship, "production_vocab_65536": production},
        "embed_concat_backward": embed_backward,
        "two_phase_step_2p20_rows": step, "two_phase_step_40m_rows": full,
        "launches_counted_in": {"serving": "phase 4 (5 forwards)",
                                "rows_update, row_gather, rows_write_pipelined":
                                    f"phase 6 ({LIBRARY_STEPS} row updates through the public ops)",
                                "rows_gather_dual, rows_write_dual": f"phase 8 stacked fit ({FULL_STEPS} steps)",
                                "rows_write, rows_gather_hbm": f"phase 8 split fit ({FULL_STEPS} steps)",
                                "probe_*": "phase 18 (the probe tool's three sub-commands)"},
        "card": card}
    print(json.dumps(line), flush=True)
    print(json.dumps({"dense_fit": dense, "card": card}), flush=True)
    print(json.dumps({"families": families, "card": card}), flush=True)
    print(json.dumps({"shipped": {"cli": shipped, "launches_in_cli": shipped_launches,
                                  "config_AE_full_width": shipped_ae}, "card": card}), flush=True)
    print(json.dumps({"staged_fit": staged, "card": card}), flush=True)
    print(json.dumps({"production_recipe": recipe, "card": card}), flush=True)
    print(json.dumps({"per_task_and_varlen": task, "card": card}), flush=True)
    print(json.dumps({"seed_suite": suite, "card": card}), flush=True)
    print(json.dumps({"csv_pipeline": csv_path, "card": card}), flush=True)
    print(json.dumps({"probes": probes, "card": card}), flush=True)
    print(json.dumps({"data_parallel": dp, "card": card}), flush=True)
    print(json.dumps({"row_sharded": sharded, "card": card}), flush=True)
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
