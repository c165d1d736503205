"""The port's mesh at world 4 (four gloo processes on the CPU): the shapes
``create_mesh`` builds and refuses, what a mesh trainer refuses, the
distributed row fetch, the data-parallel fit against the JAX Trainer's
``(data = 4, model = 1)`` mesh fit, and a batch that does not divide by the
ranks.  Tolerances as in tests/test_torch_parallel_fit.py (those of
tests/test_torch_dense_fit.py)."""

import pytest
import torch

from mmlrec_tpu_torch.parallel import create_mesh
from tests._torch_parallel_common import Group, fit_arrays, port_setup
from tests._torch_parallel_jax import check_take, close, jax_mesh_fit, ranks_equal

WORLD = 4
CASES = ("refusals", "take", "mmoe_fit", "indivisible")


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    group = Group(WORLD, CASES, tmp_path_factory.mktemp("dp4"))
    try:
        jax_run = jax_mesh_fit(WORLD)
    finally:
        runs = group.wait()
    return runs, jax_run


def test_mesh_shapes_and_refusals(dp):
    """create_mesh(data=2, model=2) over 4 ranks, data defaulting to world //
    model, ValueError for 3 x 2 (tests/test_sharding.py::test_mesh_shapes);
    a mesh trainer raises the JAX trainer's ValueErrors (trainer.py:282-291,
    384-411): the write-kernel or unique update without the explicit
    exchange (model 2: "model_2"; unique on the explicit path: "two_phase"),
    the stacked container without it ("cka") or built with another
    ``stacked_shards`` than the mesh's ``model`` ("gradnorm"), and a
    per-task method on ESCM ("pcg")."""
    runs, _ = dp
    got = runs["refusals"][0]
    assert tuple(got["shape"]) == (2, 2) and tuple(got["default_shape"]) == (2, 2)
    assert tuple(got["names"]) == ("data", "model")
    assert str(got["bad_product"]) == "ValueError: mesh 5x2 != 4 processes"
    want = {"model_2": "table_update unique/pallas with a mesh requires the "
                       "explicit_collective_embedding path",
            "two_phase": "table_update unique/pallas with a mesh requires",
            "cka": "table_update unique/pallas with a mesh requires",
            "gradnorm": "model was built with stacked_shards=1 but the mesh 'model' axis is 2",
            "pcg": "per-task gradient methods (pcg/gradnorm/cagrad) are not defined for ESCM"}
    for name, text in want.items():
        assert str(got[name]).startswith("ValueError: " + text), str(got[name])


def test_create_mesh_and_mesh_trainer_default_to_the_card(monkeypatch):
    """Without a card both raise unless asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_mesh(data=1)
    tr, *_ = port_setup()
    from mmlrec_tpu_torch.train import Trainer

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(tr.model, mesh=object())


def test_distributed_take_at_world_4(dp):
    """distributed_take bitwise index_select at world 4 (37 rows staged 10 a
    rank, three pad rows); shard_batch at world 4."""
    runs, _ = dp
    check_take(runs["take"], WORLD)


def test_dp_fit_matches_jax_mesh_fit_at_world_4(dp):
    runs, jax_run = dp
    ranks_equal(runs["mmoe_fit"])
    close(runs["mmoe_fit"][0], jax_run, "world 4 vs JAX")
    tr, x, y, _ = port_setup()
    close(runs["mmoe_fit"][0], fit_arrays(tr, x, y), "world 4 vs single process")


def test_indivisible_batch_streams_and_matches_single_process(dp):
    """Batch 62 at world 4 takes the streaming path, every rank computing
    the whole batch (tests/test_sharding.py::
    test_mesh_indivisible_batch_falls_back_to_streaming), and equals the
    single-process fit."""
    runs, _ = dp
    got = runs["indivisible"]
    assert all(int(g.pop("streamed_epochs")) == 1 for g in got)
    ranks_equal(got)
    tr, x, y, _ = port_setup()
    close(got[0], fit_arrays(tr, x, y, batch=62), "batch 62")
