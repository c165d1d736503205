"""The port's data-parallel fit at world 2 (two gloo processes on the CPU)
against the JAX Trainer's ``(data = 2, model = 1)`` mesh fit and the port's
own single-process fit.

The two workers are spawned once for the file (``_torch_parallel_common``)
and run every case; the JAX mesh fits run in this process on the
conftest's virtual CPU devices meanwhile.  Every side starts from one numpy
init (``numpy_params``) on the same synthetic rows.

Tolerances: those of tests/test_torch_dense_fit.py for the single-device
fit against JAX, from f32 sums that run in another order (here also split
over the ranks and summed by the all-reduce): per-epoch losses rtol 1e-5,
every parameter and BatchNorm statistic atol 1e-6, predictions atol 1e-6,
AUC of equal-to-1e-6 predictions atol 1e-5.  The staged and the streaming
data-parallel fits run the same operations on the same rows: bitwise.
The BatchNorm cases run SGD (a bias that feeds a BatchNorm follows rounding
noise under Adam: tests/test_torch_family_fit.py).
"""

import numpy as np
import pytest
import torch

from mmlrec_tpu_torch.ops.layers import batch_shard, dropout
from mmlrec_tpu_torch.parallel.mesh import DataGroup
from tests._torch_parallel_common import SGD_LR, Group, port_setup, state_arrays
from tests._torch_parallel_jax import check_take, close, jax_mesh_fit, ranks_equal, single_fit

WORLD = 2
CASES = ("mmoe_fit", "mmoe_stream", "bn_mmoe", "bn_star", "dropout_fit", "eval", "escm",
         "sparse_update", "local_step", "take")


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp2")
    group = Group(WORLD, CASES, out, env=dict(DP_CKPT=str(out / "ckpt")))
    try:  # the JAX mesh fits while the workers run
        jax_runs = {"mmoe_fit": jax_mesh_fit(WORLD),
                    "bn_mmoe": jax_mesh_fit(WORLD, optimizer="sgd", n=192, dnn_use_bn=True,
                                            lr=SGD_LR),
                    "bn_star": jax_mesh_fit(WORLD, "star", "msl", optimizer="sgd", n=192,
                                            dnn_use_bn=True, masked_loss=True, lr=SGD_LR),
                    "escm": jax_mesh_fit(WORLD, "escm")}
    finally:
        runs = group.wait()
    return runs, jax_runs, out


@pytest.mark.parametrize("case", ["mmoe_fit", "bn_mmoe", "bn_star", "escm"])
def test_dp_fit_matches_jax_mesh_fit(dp, case):
    """MMoE, MMoE with BatchNorm and STAR with DomainBatchNorm (3 steps of
    SGD; tests/test_explicit_collectives.py::test_explicit_step_batch_stats_
    models pins JAX's synced statistics), and ESCM's entire-space loss: the
    world-2 fit against JAX's mesh fit; every rank's state the same bits."""
    runs, jax_runs, _ = dp
    ranks_equal(runs[case])
    close(runs[case][0], jax_runs[case], case)


@pytest.mark.parametrize("case", ["mmoe_fit", "bn_mmoe", "bn_star", "dropout_fit", "escm",
                                  "sparse_update"])
def test_dp_fit_matches_single_process_fit(dp, case):
    """The same fits, MMoE with dropout 0.3 (whose masks are the global
    batch's) and with sparse_embedding_update (whose table rows are the
    global batch's) against the port's single-process fit of the global
    batches."""
    runs, _, _ = dp
    ranks_equal(runs[case])
    close(runs[case][0], single_fit(case), case)


def test_staged_dp_fit_equals_streaming_dp_fit_bitwise(dp):
    """The staged dataset fetched by distributed_take against per-batch
    uploads split by shard_batch (tests/test_sharding.py::
    test_mesh_device_staged_fit_matches_streaming)."""
    runs, _, _ = dp
    for staged, streamed in zip(runs["mmoe_fit"], runs["mmoe_stream"]):
        assert set(staged) == set(streamed)
        for k in staged:
            np.testing.assert_array_equal(staged[k], streamed[k], err_msg=k)


def test_distributed_take_is_index_select_bitwise(dp):
    runs, _, _ = dp
    check_take(runs["take"], WORLD)


def test_global_batch_dropout_mask_is_the_single_process_rows():
    """Under a batch shard, rank r's mask is bitwise rows [r B/n, (r+1) B/n)
    of the one process's mask from the same generator state, and the draws
    after it stay in step (JAX: tests/test_explicit_collectives.py::
    test_explicit_step_dropout_matches_single_device)."""
    x = torch.rand(12, 3, 5, generator=torch.Generator().manual_seed(0)) + 0.5
    whole_gen = torch.Generator().manual_seed(9)
    whole = dropout(x, 0.3, whole_gen)
    after = torch.rand(4, generator=whole_gen)
    for world in (2, 4):
        b = 12 // world
        for r in range(world):
            gen = torch.Generator().manual_seed(9)
            with batch_shard(DataGroup(None, r, world)):
                part = dropout(x[r * b:(r + 1) * b], 0.3, gen)
            assert torch.equal(part, whole[r * b:(r + 1) * b])
            assert torch.equal(torch.rand(4, generator=gen), after)


def test_dp_eval_matches_single_process_and_host(dp):
    """predict and evaluate gather the ranks' rows in order (at batch 32 and
    64: every batch split); device-eval AUC equals the host's within 1e-6
    (tests/test_sharding.py::test_mesh_device_eval_matches_host_eval); rank
    0's checkpoint and training state restore into a single-process trainer
    bitwise."""
    from mmlrec_tpu_torch.train import checkpointing

    runs, _, out = dp
    got = runs["eval"][0]
    for other in runs["eval"][1:]:
        for k in ("pred", "pred_32", "val_auc_host", "val_auc_device", "evaluate_auc"):
            np.testing.assert_array_equal(other[k], got[k])
        assert str(other["ckpt_dir"]) == str(got["ckpt_dir"])
    np.testing.assert_allclose(got["val_auc_device"], got["val_auc_host"], rtol=0, atol=1e-6)
    tr, x, y, _ = port_setup(task="msl", metrics=["auc"])
    tr.cfg.training_config.extra["device_eval"] = True
    tr.fit(x, y, batch_size=64, epochs=2, validation_data=(x, y), verbose=0, shuffle=False)
    np.testing.assert_allclose(got["val_auc_device"], [h["val_auc"] for h in tr.history],
                               rtol=0, atol=1e-6)
    for k in ("pred", "pred_32"):
        np.testing.assert_allclose(got[k], tr.predict(x, 64), rtol=0, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got["evaluate_auc"], tr.evaluate(x, y, 64)["auc"], atol=1e-5)
    assert bool(got["ckpt_exists"]) and str(got["ckpt_dir"]).startswith(str(out / "ckpt"))
    fresh, *_ = port_setup(task="msl", metrics=["auc"])
    fresh.restore_checkpoint(str(got["ckpt_dir"]))
    np.testing.assert_allclose(fresh.predict(x, 64), got["pred"], rtol=0, atol=1e-6)
    resumed, *_ = port_setup(task="msl", metrics=["auc"])
    resumed.init_state()
    epoch, *_ = checkpointing.restore_training_state(resumed, str(got["state_dir"]))
    assert epoch == 2
    for k, a in state_arrays(resumed, "state/").items():
        np.testing.assert_array_equal(a, got[k], err_msg=k)


def test_two_process_step_matches_single_process(dp):
    """Part 3's helpers: each process's local 32 rows through
    host_local_batch_to_global, one step, equal to the single-process step
    on the 64 rows (tests/test_multihost.py::
    test_two_process_step_matches_single_process); shards of unequal rows
    raise."""
    runs, _, _ = dp
    tr, x, y, _ = port_setup()
    ids, dense = tr.pack_inputs(x)
    total, _, probs = tr.train_step(*(torch.from_numpy(a[:64]) for a in
                                      (ids, dense, tr._prepare_y(y))), None, torch.ones(64))
    want = state_arrays(tr, "state/")
    for r, got in enumerate(runs["local_step"]):
        np.testing.assert_allclose(got["loss"], total.numpy(), rtol=1e-6)
        np.testing.assert_allclose(got["probs"], probs.numpy()[r * 32:(r + 1) * 32], atol=1e-6)
        for k, a in want.items():
            np.testing.assert_allclose(got[k], a, rtol=0, atol=1e-6, err_msg=k)
        assert "differ in rows" in str(got["unequal_error"])
