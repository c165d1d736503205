"""Device ms a training step in NCCL's kernels on rank 0 (the gradient
all-reduce, ``distributed_take``'s and the evaluation's all-gathers), over
the window's steps; nothing where no NCCL kernel ran."""

UNIT, MOVES, SOURCE = "ms", "host_bound.train_examples_per_s", "device_trace"
LAYER = "data parallel: parallel/mesh.py, parallel/multihost.py, train/trainer.py"
KERNEL = "nccl"


def read(c):
    if getattr(c, "steps", None) is None:
        return None
    found = [s for name, s in c.trace.seconds.items() if KERNEL in name.lower()]
    if not found:
        return None
    return 1e3 * sum(found) / c.steps
