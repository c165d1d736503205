"""Each cell at a size the CPU tests can hold: the same configurations,
mixes and code paths, fewer ids, rows and requests."""

SCALES = {
    "recipe40m.zipf": {"vocab": 16384, "batch": 256, "train_batches": 4},
    "ae.train": {"vocab": 16384, "batch": 256, "train_batches": 4, "val_rows": 512},
    "ae.serve": {"vocab": 16384, "pool_rows": 8192,
                 "requests": {"sizes": 64, "max_rows": 1024}},
}
SECONDS = 1.0
