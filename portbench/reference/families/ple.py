"""PLE, progressive layered extraction (Tang et al., RecSys 2020; the
reference MMLRec's model/ple.py): ``num_levels`` CGC levels over T task
lanes and one shared lane, all equal to the DNN input at level 0.  A level
has ``specific_expert_num`` expert MLPs per task, fed by that task's lane,
and ``shared_expert_num`` shared expert MLPs, fed by the shared lane.
Task t's gate (a gate MLP, then a final layer without bias) takes task t's
lane, and its softmax mixes the task's own experts and the shared ones
into task t's next lane; the shared gate takes the shared lane, and its
softmax mixes all experts into the next shared lane.  The last level's
task lanes feed the towers, a 1-unit final layer each, the heads' bias
and the sigmoid.

Where it departs from the reference MMLRec, as the port does (and its
JAX package):

- exactly ``shared_expert_num`` shared experts are built (the reference
  builds more and uses only those);
- the last level's shared gate is computed and feeds nothing, so its
  leaves (``shared_gate_dnn_{L-1}.*``, ``shared_gate_final_{L-1}``) get no
  gradient on either side and stay where they were drawn (here the last
  shared lane joins the towers' input times 0, which changes no value and
  gives those leaves the zero gradient that ``reference/train.py``, asking
  for every leaf's, needs): the comparison
  leaves them out of the change (``compare.STILL_LEAF``), and a program
  that gives them a gradient fails ``grad_norm_gap``.

The specific experts are task-major: expert k serves task k // spec, and
the mixes list a task's own experts before the shared ones, all specific
experts before the shared ones in the shared gate."""

import torch

from ..model import dense_shapes, heads, mlp


def _sizes(d):
    mc = d.model_config
    return (int(mc["specific_expert_num"]), int(mc["shared_expert_num"]),
            int(mc["num_levels"]))


def param_shapes(d):
    spec, shared, levels = _sizes(d)
    e = d.widths["expert_dnn_hidden_units"]
    g = d.widths["gate_dnn_hidden_units"]
    t = d.widths["tower_dnn_hidden_units"]
    T = d.heads
    shapes = {}
    fan_in = d.input_dim
    for level in range(levels):
        shapes.update(dense_shapes(f"specific_experts_{level}", fan_in, e, stack=T * spec))
        shapes.update(dense_shapes(f"shared_experts_{level}", fan_in, e, stack=shared))
        shapes.update(dense_shapes(f"specific_gate_dnn_{level}", fan_in, g, stack=T))
        shapes[f"specific_gate_final_{level}.kernel"] = (T, g[-1], spec + shared)
        shapes.update(dense_shapes(f"shared_gate_dnn_{level}", fan_in, g))
        shapes[f"shared_gate_final_{level}.kernel"] = (g[-1], T * spec + shared)
        fan_in = e[-1]
    shapes.update(dense_shapes("tower_dnn", e[-1], t, stack=T))
    shapes["tower_final.kernel"] = (T, t[-1], 1)
    shapes["out.bias"] = (T,)
    return shapes


def forward(p, x, d):
    spec, shared, levels = _sizes(d)
    e_depth = len(d.widths["expert_dnn_hidden_units"])
    g_depth = len(d.widths["gate_dnn_hidden_units"])
    T, B = d.heads, x.shape[0]
    tasks = [x] * T  # each task's lane
    common = x  # the shared lane
    for level in range(levels):
        lanes = torch.stack(tasks, dim=1)  # [B, T, d]
        own = mlp(lanes.repeat_interleave(spec, dim=1), p, f"specific_experts_{level}",
                  e_depth)  # [B, T * spec, h]
        pooled = mlp(common, p, f"shared_experts_{level}", e_depth)  # [B, shared, h]
        h = own.shape[-1]

        gate = mlp(lanes, p, f"specific_gate_dnn_{level}", g_depth)  # [B, T, g]
        weights = torch.softmax(
            torch.einsum("btg,tge->bte", gate, p[f"specific_gate_final_{level}.kernel"]), -1)
        candidates = torch.cat([own.reshape(B, T, spec, h),
                                pooled[:, None].expand(B, T, shared, h)], dim=2)
        mixed = torch.einsum("bte,bteh->bth", weights, candidates)

        sgate = mlp(common, p, f"shared_gate_dnn_{level}", g_depth)  # [B, g]
        sweights = torch.softmax(sgate @ p[f"shared_gate_final_{level}.kernel"], -1)
        common = torch.einsum("be,beh->bh", sweights, torch.cat([own, pooled], dim=1))
        tasks = list(mixed.unbind(1))
    tower = mlp(torch.stack(tasks, dim=1) + 0.0 * common[:, None], p, "tower_dnn",
                len(d.widths["tower_dnn_hidden_units"]))
    return heads(tower, p)
