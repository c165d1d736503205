"""PEPNet (reference model/pepnet.py; the port of
``mmlrec_tpu/models/pepnet.py``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.layers import GateNN, StackedDense, dropout
from .base import RecModel


class _StackedGateNN(nn.Module):
    """T parallel PEPNet gates as stacked products (reference GateNN,
    model/pepnet.py:8-32, one per task per layer :64-68): ``StackedDense``
    -> relu -> ``StackedDense`` -> 2 * sigmoid, both with torch's default
    init.  [B, G] -> [B, T, output_dim]."""

    def __init__(self, stack: int, in_dim: int, output_dim: int, hidden_dim: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.dense_0 = StackedDense(stack, in_dim, hidden_dim, generator=generator)
        self.dense_1 = StackedDense(stack, hidden_dim, output_dim, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return 2.0 * torch.sigmoid(self.dense_1(torch.relu(self.dense_0(x))))


class PepNet(RecModel):
    """EPNet's feature gate rescales the DNN input; PPNet's per-task MLP has
    every layer's input gated element-wise by a ``_StackedGateNN`` of the
    gated input and the scene (and user and item) embeddings (reference
    model/pepnet.py:81-157).  What the gates read is detached: the DNN input
    and scene embedding of the feature gate, the gated input of the
    per-task gates, and every side embedding.  The layers are relu
    whatever ``dnn_activation`` says, as in the reference.

    The last layer, ``mlp_final`` ([T, H] with a bias [T, 1]), is the
    heads' product: one multihead-score launch with ``mlp_final.bias`` added
    to the heads' bias (the JAX package adds the two to the logit one after
    the other, which rounds in another order: equal within 1e-6).  Two
    kernels a forward: the embed-concat and the fused head."""

    # reference pepnet.py has NO add_regularization_weight call: only the
    # embeddings (basemodel.py:129) are L2-penalized
    REG_DNN_PREFIXES = ()

    def __init__(self, layout, cfg, *, generator: torch.Generator, init_std: float = 1e-4):
        super().__init__(layout, cfg, generator=generator, init_std=init_std)
        mc, dc, T = self.mc, self.dc, self.num_tasks
        self.embeddings = self._make_embeddings(generator)
        side = [dc.scene_feature] + ([dc.user_sf, dc.item_sf] if dc.user_sf and dc.item_sf else [])
        # the side features' slots, on the model's device (no host copy in a CUDA graph)
        self.register_buffer("side_index", torch.tensor(
            [layout.sparse_feature_index(f) for f in side], dtype=torch.long), persistent=False)
        emb, d_in = mc.emb, self.input_dim
        self.feature_gate = GateNN(d_in + emb, d_in, 128, generator=generator)
        gate_in = d_in + emb * len(side)
        units = [d_in] + list(mc.dnn_hidden_units)
        self.depth = len(units) - 1
        for i in range(self.depth):
            self.add_module(f"gate_{i}", _StackedGateNN(T, gate_in, units[i], units[i],
                                                        generator=generator))
            self.add_module(f"mlp_{i}", StackedDense(T, units[i], units[i + 1],
                                                     generator=generator))
        self.add_module(f"gate_{self.depth}", _StackedGateNN(T, gate_in, units[-1], units[-1],
                                                             generator=generator))
        self.mlp_final = StackedDense(T, units[-1], 1, generator=generator)
        self.out = self.make_heads()
        self.dropout_rate = float(mc.dnn_dropout or 0.0)
        self.dropout_generator: Optional[torch.Generator] = None

    def forward(self, ids, dense, domain_mask=None, *, rows=None,
                return_intermediates: bool = False):
        dnn_input, sparse_emb = self.embed_inputs(ids, dense, rows)
        side = sparse_emb.index_select(1, self.side_index).detach()  # [B, 1 or 3, emb]
        scene_emb = side[:, 0]
        gate = self.feature_gate(torch.cat([dnn_input.detach(), scene_emb], dim=-1))
        gated_input = gate * dnn_input
        gate_input = torch.cat([gated_input.detach(), side.flatten(1)], dim=-1)
        hidden = gated_input[:, None, :]  # [B, 1, in] -> [B, T, h] after the first layer
        drop = self.training and self.dropout_rate > 0
        for i in range(self.depth):
            gated = hidden * getattr(self, f"gate_{i}")(gate_input)
            hidden = torch.relu(getattr(self, f"mlp_{i}")(gated))
            if drop:
                hidden = dropout(hidden, self.dropout_rate, self.dropout_generator)
        gated = hidden * getattr(self, f"gate_{self.depth}")(gate_input)
        probs = self.head_scores(gated, self.mlp_final.kernel[..., 0],
                                 self.wide_logit(ids, dense), self.mlp_final.bias[:, 0])
        probs = self.apply_domain_mask(probs, domain_mask)
        return (probs, {"dnn_input": dnn_input}) if return_intermediates else probs
