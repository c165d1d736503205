"""The row-sharded table (model > 1) on gloo processes on the CPU: the
two-phase step on a ``(data 2, model 2)`` mesh (the explicit exchange, and
the path JAX leaves to GSPMD), the dense-table fit with the table
row-sharded, the write-kernel updates of the split and the stacked
container, the per-task methods (PCGrad, GradNorm, CAGrad), the msl CKA
fit and ``sparse_embedding_update`` of the dense fit, against JAX's mesh
fits and the port's single-process fit; and on ``(data 1, model 2)`` the
pipelined exchange, the dense fit, ``sparse_embedding_update``, the three
merges over a split gradient, and the checkpoints of a stacked mesh fit and
of a ``sparse_embedding_update`` + GradNorm fit restored into a
single-process trainer.

Two worker groups (4 and 2 processes) are spawned once for the file and
run their cases while the JAX mesh fits run in this process on the
conftest's virtual CPU devices.  Every side starts from one numpy init.

Tolerances: against JAX's mesh fits, those of tests/test_torch_dense_fit.py
(per-epoch losses rtol 1e-5, every parameter atol 1e-6, predictions atol
1e-6), inside JAX's own pin for these fits (tests/test_explicit_collectives.py:
145-171: predictions rtol 2e-3, atol 2e-4); against the port's single-
process fit the same, GradNorm's weights atol 1e-6.  The merges over a
split gradient sum their dot products as a replicated part plus the
shards' part: against the merges of the whole gradient rtol 1e-5, atol
1e-6 (a few f32 ulps of each sum).  At data 1 the mesh's sums run in the one process's
order: bitwise.  Paths that run the same operations in the same order are
held bitwise: the gather against the scatter dedup route, the staged
against the streaming fit, the pipelined exchange against the single
all-gather at data 1.  At data 2 the pipelined exchange adds the ranks'
tiles as they land, an order of f32 sums that differs from the single
all-gather's (JAX's own pin is allclose for the same reason), so it is held
at atol 1e-6.
"""

import numpy as np
import pytest
import torch

from tests._torch_parallel_common import (
    EXPLICIT,
    L2,
    PACKED,
    SEU_GRADNORM,
    STACKED,
    TASKS,
    TWO_PHASE,
    Group,
    merge_inputs,
    merge_outputs,
    sharded_fit,
    sharded_setup,
)
from tests._torch_parallel_jax import close, jax_mesh_fit, ranks_equal

CASES4 = ("sh_explicit", "sh_gspmd", "sh_dense", "sh_chunked", "sh_stream", "sh_packed_gather",
          "sh_packed_scatter", "sh_split_f32", "sh_devmeta", "sh_stacked", "sh_stacked_slot",
          "sh_explicit_l2", "sh_dense_l2", *TASKS)
CASES2 = ("sh_explicit", "sh_chunked", "sh_dense", "sh_stacked_ckpt", "sh_seu",
          "sh_seu_gradnorm_ckpt", "sh_merges", "sh_task_refusals")
KW = {"sh_explicit": EXPLICIT, "sh_gspmd": TWO_PHASE, "sh_dense": {},
      "sh_explicit_l2": dict(EXPLICIT, **L2), "sh_dense_l2": L2,
      "sh_packed_gather": dict(PACKED, dedup_route="gather"),
      "sh_split_f32": dict(PACKED, table_opt_dtype="float32"),
      "sh_devmeta": dict(PACKED, device_metadata=True),
      "sh_stacked": dict(STACKED, update_space="position"),
      "sh_stacked_slot": dict(STACKED, update_space="slot"),
      "sh_seu_gradnorm_ckpt": SEU_GRADNORM, **TASKS}
JAX_CASES = ("sh_explicit", "sh_gspmd", "sh_dense", "sh_explicit_l2", "sh_dense_l2", *TASKS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded")
    (out / "w4").mkdir()
    (out / "w2").mkdir()
    groups = (Group(4, CASES4, out / "w4"),
              Group(2, CASES2, out / "w2", env=dict(DP_CKPT=str(out / "ckpt"))))
    try:  # JAX's (data 2, model 2) mesh fits while the workers run
        jax_runs = {case: jax_mesh_fit(4, model=2, **KW[case]) for case in JAX_CASES}
    finally:
        w4, w2 = (g.wait() for g in groups)
    return w4, w2, jax_runs


def single(case):
    tr, x, y, _ = sharded_setup(**KW[case])
    return sharded_fit(tr, x, y)


@pytest.mark.parametrize("case", JAX_CASES)
def test_sharded_fit_matches_jax_mesh_fit(runs, case):
    """The explicit step, the GSPMD-equivalent step and the dense fit of a
    row-sharded table at (data 2, model 2), the first and the last also
    with both L2 penalties (counted once, not once a model rank: JAX
    scales the dense one by 1 / n_data and partitions the rows' one by
    each data shard's ``rep``, explicit_step.py:126-145), against JAX's fits on
    ``create_mesh(data=2, model=2)`` (tests/test_explicit_collectives.py::
    test_explicit_step_matches_single_device, test_explicit_step_matches_
    gspmd_mesh; tests/test_sharding.py::test_sharded_training_matches_
    single_device); so are PCGrad with both penalties, GradNorm, CAGrad,
    ``sparse_embedding_update`` and the msl CKA fit, which JAX computes
    under GSPMD (trainer.py:1005-1086), GradNorm's task weights and first
    losses held at atol 1e-6; every rank ends with the same whole state."""
    w4, _, jax_runs = runs
    ranks_equal(w4[case])
    got, want = w4[case][0], jax_runs[case]
    np.testing.assert_allclose(got["pred"], want["pred"], rtol=2e-3, atol=2e-4)
    close(got, want, case)


@pytest.mark.parametrize("case", ["sh_explicit", "sh_gspmd", "sh_dense", "sh_packed_gather",
                                  "sh_split_f32", "sh_devmeta", "sh_stacked",
                                  "sh_stacked_slot", "sh_explicit_l2", "sh_dense_l2", *TASKS])
def test_sharded_fit_matches_single_process_fit(runs, case):
    """Every update of the row-sharded table (the scatter route; the write
    kernel of packed moments with the gather route, of split f32 moments,
    with the metadata built in the step; the stacked container shard-major
    in position and slot space; ``sparse_embedding_update``), the per-task
    methods (GradNorm's state included) and CKA at (data 2, model 2)
    against the port's single-process fit of the same config."""
    w4, _, _ = runs
    ranks_equal(w4[case])
    close(w4[case][0], single(case), case)


def test_gather_route_equals_scatter_route_bitwise(runs):
    """The packed update's slot sums by the gather route and by one scatter
    are int32 adds: the same bits on the mesh as in one process."""
    w4, _, _ = runs
    for a, b in zip(w4["sh_packed_gather"], w4["sh_packed_scatter"]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_staged_equals_streaming_bitwise(runs):
    """The staged dataset fetched by distributed_take against the streaming
    batches split by shard_batch, under the explicit step."""
    w4, _, _ = runs
    for a, b in zip(w4["sh_explicit"], w4["sh_stream"]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_chunked_exchange_equals_single_all_gather(runs):
    """``grad_exchange_chunks=4``: bitwise the single all-gather at data 1
    (the tiles land in position order), atol 1e-6 at data 2
    (tests/test_explicit_collectives.py::test_chunked_grad_exchange_
    matches_unchunked)."""
    w4, w2, _ = runs
    for a, b in zip(w2["sh_chunked"], w2["sh_explicit"]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    close(w4["sh_chunked"][0], w4["sh_explicit"][0], "chunked at data 2")


@pytest.mark.parametrize("case", ["sh_explicit", "sh_dense", "sh_seu"])
def test_data_1_model_2_is_the_single_process_fit_bitwise(runs, case):
    """At (data 1, model 2) the forward fetch is each row's bits and the
    updates run the one process's sums in its order: the explicit step, the
    dense fit and ``sparse_embedding_update`` (each shard setting its owned
    rows, ``sharded_sparse_adam_row_update``) equal the single-process fits
    bitwise."""
    _, w2, _ = runs
    ranks_equal(w2[case])
    want = single(case)
    for k, a in want.items():
        np.testing.assert_array_equal(w2[case][0][k], a, err_msg=k)


def test_stacked_mesh_checkpoint_restores_into_split_single_process(runs):
    """The stacked fit at (data 1, model 2): rank 0's training state and
    checkpoint hold the whole table, split layout, and restore into a
    single-process trainer of the split container, whose predictions and
    table are the mesh's (tests/test_mesh_stacked.py::test_mesh_stacked_
    checkpoint_restores_into_split_single_device)."""
    from mmlrec_tpu_torch.train import checkpointing

    _, w2, _ = runs
    got = w2["sh_stacked_ckpt"]
    ranks_equal([{k: v for k, v in g.items() if not k.endswith("_dir")} for g in got])
    got = got[0]
    split = dict(PACKED, dedup_route="gather")
    tr, x, _, _ = sharded_setup(**split)
    tr.init_state()
    epoch, *_ = checkpointing.restore_training_state(tr, str(got["state_dir"]))
    assert epoch == 1 and tr.table_container == "split"
    np.testing.assert_array_equal(tr.table.detach().numpy(),
                                  got["state/embeddings.fused.table"])
    np.testing.assert_array_equal(tr.predict(x, 64), got["pred"])
    fresh, *_ = sharded_setup(**split)
    fresh.restore_checkpoint(str(got["ckpt_dir"]))
    np.testing.assert_array_equal(fresh.predict(x, 64), got["pred"])
    assert int(tr.table_opt.count) == 8 and torch.any(tr.table_opt.monu != 0)


def test_seu_gradnorm_state_restores_into_a_single_process_trainer(runs):
    """``sparse_embedding_update`` with GradNorm at (data 1, model 2): within
    the tolerances of the single-process fit (GradNorm's norms sum the
    shards' parts), and rank 0's training state (the table and its
    SparseAdam moment shards gathered, GradNorm's state) restores into a
    single-process trainer bitwise, whose predictions are the mesh's."""
    from mmlrec_tpu_torch.train import checkpointing

    _, w2, _ = runs
    got = w2["sh_seu_gradnorm_ckpt"]
    ranks_equal([{k: v for k, v in g.items() if k != "state_dir"} for g in got])
    got = got[0]
    mesh = {k: v for k, v in got.items() if not k.startswith(("table_opt/", "state_dir"))}
    close(mesh, single("sh_seu_gradnorm_ckpt"), "sh_seu_gradnorm_ckpt")
    tr, x, _, _ = sharded_setup(**SEU_GRADNORM)
    tr.init_state()
    epoch, *_ = checkpointing.restore_training_state(tr, str(got["state_dir"]))
    assert epoch == 1 and int(tr.table_opt.count) == 8 and int(tr.gn_state["gn_step"]) == 8
    restored = {f"state/{k}": v.numpy() for k, v in tr.model.state_dict().items()}
    restored.update({f"table_opt/{m}": getattr(tr.table_opt, m).numpy() for m in ("mu", "nu")})
    restored.update({f"gn/{k}": v.numpy() for k, v in tr.gn_state.items()})
    for k, a in restored.items():
        np.testing.assert_array_equal(a, got[k], err_msg=k)
    np.testing.assert_array_equal(tr.predict(x, 64), got["pred"])


def test_merges_over_a_split_gradient(runs):
    """PCGrad, CAGrad and GradNorm with ``table`` row-split over the model
    group, one shard of it seeing only zeros of task 0 (``merge_inputs``),
    against the same merges of the whole gradients: the "shared" test of a
    sharded tensor is an any over the group, each dot product and norm the
    replicated part plus the shards' summed part."""
    _, w2, _ = runs
    ranks = w2["sh_merges"]
    want = merge_outputs(merge_inputs())
    for k, v in want.items():
        if k.endswith("/table"):
            got = np.concatenate([r[k] for r in ranks])
        else:
            ranks_equal([{k: r[k]} for r in ranks])
            got = ranks[0][k]
        np.testing.assert_allclose(got, v, rtol=1e-5, atol=1e-6, err_msg=k)


def test_per_task_refusals_stay_with_a_row_sharded_table(runs):
    """ESCM with a per-task method, and a per-task method with the two-phase
    step, raise the JAX trainer's ValueErrors at (data 1, model 2)."""
    _, w2, _ = runs
    got = w2["sh_task_refusals"][0]
    assert str(got["escm"]).startswith(
        "ValueError: per-task gradient methods (pcg/gradnorm/cagrad) are not defined for ESCM")
    assert str(got["two_phase"]).startswith(
        "ValueError: two_phase_embedding is incompatible with per-task gradient methods")
