"""mmlrec_tpu_torch — the PyTorch / CUDA port of mmlrec_tpu for NVIDIA Hopper.

The port stands beside the JAX package and imports none of it: the host
layer (features, config, synthetic data), all sixteen model families, the
Trainer (dense fit and two-phase SparseAdam step, validation on the host
or the device, checkpoints), the serving bundle and the CLI, with the ten
Pallas kernels of ``mmlrec_tpu/ops`` written by hand in CUDA
(``csrc/recsys_kernels.cu``, ``csrc/row_kernels.cu``).  Entry points run on
the card unless the caller passes ``device="cpu"`` (``--device cpu``):

    python -m mmlrec_tpu_torch.main --config configs/msl/config_AE.json --synthetic
    from mmlrec_tpu_torch.models import get_model
    from mmlrec_tpu_torch.train import Trainer
    from mmlrec_tpu_torch.serving import ServingBundle, save_serving_bundle
"""
