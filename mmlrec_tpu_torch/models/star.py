"""STAR (reference model/star.py; the port of ``mmlrec_tpu/models/star.py``)."""

from __future__ import annotations

import torch

from ..ops.domain_norm import DomainBatchNorm
from ..ops.layers import SharedSpecificDense, activation_fn
from .base import RecModel


class STAR(RecModel):
    """Star-topology FCN: every layer's weight is a domain-specific tensor
    times a shared one (reference model/star.py:26-80), all T pathways at
    once as [B, T, ...] (``num_tasks`` is the pathway count).

    With ``dnn_use_bn`` and a domain mask of width T, the pathways after
    layer 0 go through ONE ``DomainBatchNorm`` in turn (reference
    star.py:50-51), so a training forward moves its statistics T times.
    The module exists where the JAX trainer's init creates it: BatchNorm on,
    a hidden layer, an msl or mtmsl regime with ``num_domains == T``.  The
    mask reaches the model only under ``masked_loss``.

    Task i's logit reads pathway i through row i of ``final_i``:
    ``x_i . (specific_kernel[i] * shared_kernel) + specific_bias[i] +
    shared_bias``.  The T effective rows are stacked to [T, H] and the
    biases added to the heads' bias, so the heads are one multihead-score
    launch; the JAX package adds the two biases to the logit one after the
    other, which rounds in another order (equal within 1e-6).  Two kernels
    a forward: the embed-concat and the fused head."""

    # reference star.py has NO add_regularization_weight call: only the
    # embeddings (basemodel.py:129) are L2-penalized
    REG_DNN_PREFIXES = ()

    def __init__(self, layout, cfg, *, generator: torch.Generator, init_std: float = 1e-4):
        super().__init__(layout, cfg, generator=generator, init_std=init_std)
        mc, T = self.mc, self.num_tasks
        units = list(mc.dnn_hidden_units)
        if not units:
            raise ValueError("STAR needs dnn_hidden_units")
        self.act = activation_fn(mc.dnn_activation)
        self.embeddings = self._make_embeddings(generator)
        layer = dict(generator=generator, use_shared=mc.use_shared,
                     freeze_ref_faithful=mc.ref_faithful_frozen_params)
        d_in = self.input_dim
        for j, u in enumerate(units):
            self.add_module(f"linear_{j}", SharedSpecificDense(T, d_in, u, **layer))
            d_in = u
        self.domain_bn = None
        if (mc.dnn_use_bn and self.task_name in ("msl", "mtmsl")
                and self.num_domains == T):
            self.domain_bn = DomainBatchNorm(units[0], T, mode=mc.domain_bn_mode)
        for i in range(T):
            self.add_module(f"final_{i}", SharedSpecificDense(T, d_in, 1, **layer))
        self.depth = len(units)
        self.out = self.make_heads()

    def final_weights(self):
        """(weights [T, H], biases [T] or None): row i of ``final_i``."""
        ws, bs = [], []
        for i in range(self.num_tasks):
            w, b = getattr(self, f"final_{i}").weight_and_bias()
            ws.append(w[i, :, 0])
            if b is not None:
                bs.append(b[i, 0])
        return torch.stack(ws), (torch.stack(bs) if bs else None)

    def forward(self, ids, dense, domain_mask=None, *, rows=None,
                return_intermediates: bool = False):
        T = self.num_tasks
        dnn_input, _ = self.embed_inputs(ids, dense, rows)
        inter = {"dnn_input": dnn_input}
        use_dbn = (self.domain_bn is not None and domain_mask is not None
                   and domain_mask.shape[-1] == T)
        x = dnn_input  # rank 2: the first layer broadcasts it to the T pathways
        for j in range(self.depth):
            x = self.act(getattr(self, f"linear_{j}")(x))  # [B, T, units]
            if j == 0 and use_dbn:
                x = torch.stack([self.domain_bn(x[:, d], domain_mask) for d in range(T)], dim=1)
            inter[f"star_output_{j}"] = x
        inter["last_layer"] = x[:, -1]
        weights, bias = self.final_weights()
        probs = self.head_scores(x, weights, self.wide_logit(ids, dense), bias)
        probs = self.apply_domain_mask(probs, domain_mask)
        return (probs, inter) if return_intermediates else probs
