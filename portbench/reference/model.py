"""The plain forward pass of the benchmark's model families: float32
``torch`` operations (matmuls, relu, softmax, sigmoid), no kernel of the
program, no graphs.  A family is one module ``reference/families/<model
name>.py`` with ``param_shapes(dims)`` and ``forward(params, x)``, where
``x`` is the DNN input ``cat(embedding rows flattened, dense)``; it is
found by the configuration's ``model_name``.

What a family reads from ``dims`` (``reference/dims.py::Dims``): the
input's shapes (``input_dim``, ``heads``, ``emb``), ``widths`` (the four
``*_dnn_hidden_units`` of the older families), ``num_experts``, and any
key of the configuration's own ``experiment.model_config`` from
``model_config`` (PLE's ``specific_expert_num``, ``shared_expert_num``
and ``num_levels``, the ``dnn_hidden_units`` of STAR, PEPNet, APG, MLP
and Cross-Stitch, HMoE's ``task_weight_hidden_units``).  The module
``arith/families/<model name>.py`` reads the same.

The parameter names are those of the program's state dict (its
checkpoint format): the benchmark draws the values under those names and
hands the same values to both sides."""

from __future__ import annotations

import importlib
from typing import Dict

import torch

TABLE = "embeddings.fused.table"


def family(model_name: str):
    return importlib.import_module(f"portbench.reference.families.{model_name}")


def mlp(x: torch.Tensor, p: Dict[str, torch.Tensor], prefix: str, depth: int) -> torch.Tensor:
    """relu(x @ kernel + bias) per layer; a kernel [in, out] takes x [B, in],
    a stacked kernel [K, in, out] takes x [B, in] (the same input for every
    member) or [B, K, in]."""
    for i in range(depth):
        k, b = p[f"{prefix}.dense_{i}.kernel"], p[f"{prefix}.dense_{i}.bias"]
        if k.dim() == 2:
            x = x @ k + b
        elif x.dim() == 2:
            x = torch.einsum("bi,kio->bko", x, k) + b
        else:
            x = torch.einsum("bki,kio->bko", x, k) + b
        x = torch.relu(x)
    return x


def dense_shapes(prefix: str, fan_in: int, units, stack: int = 0) -> Dict[str, tuple]:
    out = {}
    for i, u in enumerate(units):
        lead = (stack,) if stack else ()
        out[f"{prefix}.dense_{i}.kernel"] = lead + (fan_in, u)
        out[f"{prefix}.dense_{i}.bias"] = lead + (u,)
        fan_in = u
    return out


def heads(tower: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The towers' [B, T, H] through the final 1-unit layers (no bias), the
    heads' bias and the sigmoid -> [B, T]."""
    logits = torch.einsum("bth,th->bt", tower, p["tower_final.kernel"][..., 0])
    return torch.sigmoid(logits + p["out.bias"])
