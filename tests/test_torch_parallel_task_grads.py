"""The per-task gradient methods (PCGrad, GradNorm, CAGrad) and the CKA loss
under a data-parallel mesh, on two gloo processes on the CPU: each task's
gradient is all-reduced as a ``[T, N]`` stack before the merge (GradNorm's
losses with it), CKA's Gram terms before its normalisation, and each
world-2 fit is held against JAX's ``(data = 2, model = 1)`` mesh fit (the
JAX package computes these globally under GSPMD: trainer.py:1005-1066,
1292-1316) and the port's single-process fit; at world 1 every value is the
fit without a mesh, bitwise.

Tolerances: those of tests/test_torch_parallel_fit.py (tests/
test_torch_dense_fit.py's): per-epoch losses rtol 1e-5, every parameter
atol 1e-6, predictions atol 1e-6; GradNorm's task weights atol 1e-6.
"""

import numpy as np
import pytest
import torch

from tests._torch_parallel_common import Group, fit_arrays, port_setup
from tests._torch_parallel_jax import close, jax_mesh_fit, ranks_equal

WORLD = 2
KW = {"task_pcg": dict(model_name="pcg", l2_reg_embedding=1e-3, l2_reg_dnn=1e-3),
      "task_gradnorm": dict(use_gradnorm=True),
      "task_cagrad": dict(use_cagrad=True), "task_cka": dict(task="msl", use_cka_loss=True)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("tasks")
    group = Group(WORLD, tuple(KW), out, env=dict(DP_CKPT=str(out / "ckpt")))
    try:  # the JAX mesh fits while the workers run
        jax_runs = {case: jax_mesh_fit(WORLD, **kw) for case, kw in KW.items()}
    finally:
        got = group.wait()
    return got, jax_runs


def _state(got):
    return {k: v for k, v in got.items() if not k.startswith(("gn/", "state_dir"))}


@pytest.mark.parametrize("case", list(KW))
def test_task_fit_matches_jax_mesh_fit(runs, case):
    got, jax_runs = runs
    ranks_equal([_state(g) for g in got[case]])
    close({k: v for k, v in got[case][0].items() if k != "state_dir"}, jax_runs[case], case)


@pytest.mark.parametrize("case", list(KW))
def test_task_fit_matches_single_process_fit(runs, case):
    got, _ = runs
    tr, x, y, _ = port_setup(**KW[case])
    close(_state(got[case][0]), fit_arrays(tr, x, y), case)
    if case == "task_gradnorm":  # the weights moved identically on every rank
        for k, v in tr.gn_state.items():
            for g in got[case]:
                np.testing.assert_allclose(g[f"gn/{k}"], v.numpy(), rtol=0, atol=1e-6)


def test_gradnorm_state_is_written_by_rank_0(runs):
    """The training state (GradNorm's weights, first losses and step
    included) is rank 0's file, and it restores into a single-process
    trainer."""
    from mmlrec_tpu_torch.train import checkpointing

    got, _ = runs
    runs_g = got["task_gradnorm"]
    assert str(runs_g[0]["state_dir"]) == str(runs_g[1]["state_dir"])
    tr, *_ = port_setup(use_gradnorm=True)
    tr.init_state()
    checkpointing.restore_training_state(tr, str(runs_g[0]["state_dir"]))
    for k, v in tr.gn_state.items():
        np.testing.assert_array_equal(v.numpy(), runs_g[0][f"gn/{k}"], err_msg=k)


@pytest.mark.parametrize("case", list(KW))
def test_world_1_is_the_fit_without_a_mesh_bitwise(case):
    """A mesh of one process: every value the unsharded fit's."""
    from mmlrec_tpu_torch.parallel import create_mesh

    mesh = create_mesh(device="cpu")  # a process group of one
    try:
        tr, x, y, _ = port_setup(mesh=mesh, **KW[case])
        got = fit_arrays(tr, x, y)
    finally:
        torch.distributed.destroy_process_group()
    tr, x, y, _ = port_setup(**KW[case])
    want = fit_arrays(tr, x, y)
    for k, a in want.items():
        np.testing.assert_array_equal(got[k], a, err_msg=k)
