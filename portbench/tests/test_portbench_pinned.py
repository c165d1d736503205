"""What the existing cells read, pinned at the values the benchmark gave
before configurations could state a vocabulary per slot and hand their
whole model config to the families: each cell's shapes, offsets,
parameter shapes, FLOP and byte counts, drawn rows and table at its CPU
scale, equal bit for bit (a digest is the first 16 hex digits of the
SHA-256 of the values' dtypes and bytes)."""

import hashlib
import json

import numpy as np
import pytest

from portbench import run
from portbench.arith import ops
from portbench.drivers import common, train
from portbench.reference.dims import dims
from portbench.reference.model import family
from portbench.tests.tiny import SCALES
from portbench.traffic import gen

SEED = 2**31 + 5
#: the benchmark's values, per cell at its CPU scale
PINNED = {
    "recipe40m.zipf": dict(
        fields=dict(task_name="mtl", model_name="mmoe", scene=None, vocab=16384, emb=32,
                    heads=2, lr=0.001, moment_dtype="bfloat16", num_experts=4,
                    widths={"bottom_dnn_hidden_units": [],
                            "expert_dnn_hidden_units": [256, 128],
                            "gate_dnn_hidden_units": [64], "tower_dnn_hidden_units": [64]}),
        columns="380b51ebcb2dad99", offsets=[16384 * i for i in range(16)],
        logical_rows=262144, param_shapes="f1c27efcdd6eb7d1", forward_matmul_flops=1487104.0,
        step_ops=[["expert_mix", 794624, 532480.0], ["multihead_score", 133640, 67584.0],
                  ["row_gather", 516000.0, 0.0], ["row_write", 516000.0, 0.0]],
        forward_ops=[["embed_concat", 676864.0, 0.0], ["expert_mix", 794624, 532480.0],
                     ["multihead_score", 133640, 67584.0]],
        rows="ddf1414cdcb08233", mean_distinct=3017.75, table="b22ecbf29bc29cf0"),
    "ae.train": dict(
        fields=dict(task_name="msl", model_name="sharedbottom", scene="scene", vocab=16384,
                    emb=8, heads=2, lr=0.005, moment_dtype="float32", num_experts=4,
                    widths={"bottom_dnn_hidden_units": [256, 128],
                            "expert_dnn_hidden_units": [256, 128],
                            "gate_dnn_hidden_units": [64], "tower_dnn_hidden_units": [64]}),
        columns="5f0a9ca4577b4a74", offsets=[16384 * i for i in range(17)],
        logical_rows=278528, param_shapes="5f481833ecf9b727", forward_matmul_flops=200448.0,
        step_ops=[["multihead_score", 133640, 67584.0], ["row_gather", 196000.0, 0.0],
                  ["row_write", 196000.0, 0.0]],
        forward_ops=[["embed_concat", 317696.0, 0.0], ["multihead_score", 133640, 67584.0]],
        rows="7e87d568087adeb0", mean_distinct=3019.75, table="004ef02e8800797e"),
}
PINNED["ae.serve"] = dict(
    PINNED["ae.train"],
    step_ops=[["multihead_score", 2130440, 1081344.0], ["row_gather", 196000.0, 0.0],
              ["row_write", 196000.0, 0.0]],
    forward_ops=[["embed_concat", 4603136.0, 0.0], ["multihead_score", 2130440, 1081344.0]],
    rows="0b949b5b58fb0447", mean_distinct=35433.5)
#: (sparse slots, ids a slot) of each configuration at its own size
FULL = {"recipe40m_mmoe": (16, 2_500_000), "ae_sharedbottom": (17, 131_072)}


def digest(arrays) -> str:
    m = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        m.update(str(a.dtype).encode())
        m.update(a.tobytes())
    return m.hexdigest()[:16]


def readings(workload):
    """Everything ``PINNED`` holds, as the benchmark reads it now."""
    bench = run.benchmark()
    _, spec, mix, _, _ = run.cell_files(bench, workload)
    spec, mix = run.scaled(spec, mix, SCALES[workload])
    d = dims(spec)
    shapes = family(d.model_name).param_shapes(d)
    batch = int(spec["experiment"]["training_config"]["train_batch_size"])
    if mix["driver"] == "train":
        n, stream = int(mix["train_batches"]) * batch, "train"
    else:
        n, stream = int(mix["pool_rows"]), "pool"
    x, y = gen.rows(spec["experiment"], d.vocabs, mix, n, SEED, stream, "cpu")
    ids = common.fused_ids(x, d, 0, n).numpy()
    rng = np.random.default_rng(gen.stream_seed(SEED, "order"))
    return dict(
        fields={k: getattr(d, k) for k in PINNED[workload]["fields"]},
        columns=digest([np.array(json.dumps([d.sparse, d.dense]).encode())]),
        offsets=d.offsets, logical_rows=d.logical_rows,
        param_shapes=digest([np.array(json.dumps(
            sorted((k, list(v)) for k, v in shapes.items())).encode())]),
        forward_matmul_flops=ops.forward_matmul_flops(d),
        step_ops=[list(o) for o in ops.step_ops(d, batch, 1000.0)],
        forward_ops=[list(o) for o in ops.forward_ops(d, batch, 1000.0)],
        rows=digest([x[c] for c in sorted(x)] + ([y] if y is not None else [])),
        mean_distinct=train._mean_distinct(ids, batch, rng),
        table=digest([c.numpy() for _, c in common.table_chunks(d, SEED, "cpu")]))


@pytest.mark.parametrize("workload", sorted(PINNED))
def test_a_cell_reads_what_it_read_with_one_vocabulary(workload):
    got = readings(workload)
    for key, want in PINNED[workload].items():
        assert got[key] == want, key


@pytest.mark.parametrize("config", sorted(FULL))
def test_a_configuration_at_its_own_size_lays_its_slots_out_as_before(config):
    slots, vocab = FULL[config]
    spec = json.loads((run.ROOT / "portbench" / "configs" / f"{config}.json").read_text())
    d = dims(spec)
    assert d.vocab == vocab and d.vocabs == [vocab] * slots
    assert d.offsets == [vocab * i for i in range(slots)]
    assert d.logical_rows == vocab * slots
