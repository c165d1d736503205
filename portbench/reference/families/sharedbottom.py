"""SharedBottom (Caruana 1997; the reference MMLRec's model/sharedbottom.py):
one bottom MLP shared by every head, a tower MLP and a 1-unit final layer
per head, then the heads' bias and the sigmoid."""

from ..model import dense_shapes, heads, mlp


def param_shapes(d):
    bottom, tower = d.widths["bottom_dnn_hidden_units"], d.widths["tower_dnn_hidden_units"]
    shapes = dense_shapes("bottom_dnn", d.input_dim, bottom)
    shapes.update(dense_shapes("tower_dnn", bottom[-1], tower, stack=d.heads))
    shapes["tower_final.kernel"] = (d.heads, tower[-1], 1)
    shapes["out.bias"] = (d.heads,)
    return shapes


def forward(p, x, d):
    shared = mlp(x, p, "bottom_dnn", len(d.widths["bottom_dnn_hidden_units"]))
    tower = mlp(shared, p, "tower_dnn", len(d.widths["tower_dnn_hidden_units"]))
    return heads(tower, p)
