"""mmlrec_tpu_torch — the PyTorch / CUDA port of mmlrec_tpu for NVIDIA Hopper.

The port stands beside the JAX package and imports none of it.  So far it
covers the host layer (features, config, synthetic data), the MMoE forward
and the serving bundle, with the three forward kernels of
``mmlrec_tpu/ops/pallas_kernels.py`` written by hand in CUDA
(``csrc/recsys_kernels.cu``).  Entry points run on the card unless the
caller passes ``device="cpu"``:

    from mmlrec_tpu_torch.models import get_model
    from mmlrec_tpu_torch.serving import ServingBundle, save_serving_bundle
"""
