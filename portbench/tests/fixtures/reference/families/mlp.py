"""MLP (the reference MMLRec's model/mlp.py): one MLP over the DNN input,
a module a layer at the widths of the model config's
``dnn_hidden_units``, then one 1-unit final layer (no bias) whose logit
every head shares, the heads' bias and the sigmoid."""

import torch

from ..model import dense_shapes, mlp


def _units(d):
    return [int(u) for u in d.model_config["dnn_hidden_units"]]


def param_shapes(d):
    shapes, fan_in = {}, d.input_dim
    for i, u in enumerate(_units(d)):
        shapes.update(dense_shapes(f"mlp_layer_{i}", fan_in, [u]))
        fan_in = u
    shapes["final_layer.kernel"] = (fan_in, 1)
    shapes["out.bias"] = (d.heads,)
    return shapes


def forward(p, x, d):
    for i in range(len(_units(d))):
        x = mlp(x, p, f"mlp_layer_{i}", 1)
    return torch.sigmoid(x @ p["final_layer.kernel"] + p["out.bias"])
