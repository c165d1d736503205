"""The port's layers as PERF.md lists them; a per-layer metric names its
layer with one of these strings, letter for letter."""

FIT = "fit loop: train/trainer.py, train/staging.py"
STEP = "training step: train/graphs.py, train/trainer.py, models/, train/optimizers.py"
TABLE = "two-phase table update: train/sparse_embedding.py, ops/row_gather.py, ops/row_scatter.py"
SERVE = "serving entry: serving.py"
FORWARD = "serving forward: models/, ops/layers.py, ops/embedding.py"
KERNELS = "kernels: ops/kernels.py, ops/row_gather.py, ops/row_scatter.py, csrc/*.cu"
DEVICE = "device: NVIDIA H100 (CUDA streams, HBM)"
