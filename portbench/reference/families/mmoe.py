"""MMoE (Ma et al., KDD 2018; the reference MMLRec's model/mmoe.py): E
expert MLPs over the DNN input, per task a gate MLP and a final gate layer
(no bias) whose softmax over the experts mixes their outputs, then per task
a tower MLP, a 1-unit final layer, the heads' bias and the sigmoid."""

import torch

from ..model import dense_shapes, heads, mlp


def param_shapes(d):
    e = d.widths["expert_dnn_hidden_units"]
    g = d.widths["gate_dnn_hidden_units"]
    t = d.widths["tower_dnn_hidden_units"]
    shapes = dense_shapes("expert_dnn", d.input_dim, e, stack=d.num_experts)
    shapes.update(dense_shapes("gate_dnn", d.input_dim, g, stack=d.heads))
    shapes["gate_final.kernel"] = (d.heads, g[-1], d.num_experts)
    shapes.update(dense_shapes("tower_dnn", e[-1], t, stack=d.heads))
    shapes["tower_final.kernel"] = (d.heads, t[-1], 1)
    shapes["out.bias"] = (d.heads,)
    return shapes


def forward(p, x, d):
    experts = mlp(x, p, "expert_dnn", len(d.widths["expert_dnn_hidden_units"]))  # [B, E, H]
    gate = mlp(x, p, "gate_dnn", len(d.widths["gate_dnn_hidden_units"]))  # [B, T, G]
    weights = torch.softmax(torch.einsum("btg,tge->bte", gate, p["gate_final.kernel"]), -1)
    mixed = torch.einsum("bte,beh->bth", weights, experts)
    tower = mlp(mixed, p, "tower_dnn", len(d.widths["tower_dnn_hidden_units"]))
    return heads(tower, p)
