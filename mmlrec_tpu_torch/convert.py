"""Load the JAX package's flax variables into a port module.

The port names its parameters as the flax modules do, so the flax path
``embeddings/fused/table`` is the state-dict key ``embeddings.fused.table``
and every leaf keeps its layout (``[K, in, out]`` kernels, the lane-packed
``[rows/P, 128]`` table).  The tree is given as numpy arrays (or anything
``np.asarray`` takes); this module imports no JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, object]:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(_flatten(v, key))
        else:
            flat[key] = v
    return flat


def load_jax_variables(model: nn.Module, variables: Mapping) -> nn.Module:
    """Copy a flax ``{"params": ...}`` tree into ``model`` in place.

    Raises ValueError on any other collection, any missing or extra leaf,
    and any leaf whose shape or dtype differs from the module's parameter.
    """
    others = sorted(set(variables) - {"params"})
    if others:
        raise ValueError(f"unsupported variable collections {others}")
    leaves = {k.replace("/", "."): v for k, v in _flatten(variables["params"]).items()}
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(leaves))
    extra = sorted(set(leaves) - set(params))
    if missing or extra:
        raise ValueError(f"parameter mismatch: missing {missing}, extra {extra}")
    arrays = {}
    for key, p in params.items():
        a = np.asarray(leaves[key])
        if a.shape != tuple(p.shape) or a.dtype != np.float32:
            raise ValueError(
                f"{key}: got {a.dtype}{list(a.shape)}, expected "
                f"float32{list(p.shape)}")
        arrays[key] = a
    with torch.no_grad():
        for key, p in params.items():
            p.copy_(torch.from_numpy(np.ascontiguousarray(arrays[key])))
    return model
