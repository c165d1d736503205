"""ESMM and ESCM (reference model/esmm.py, model/escm.py; the port of
``mmlrec_tpu/models/esmm.py``)."""

from __future__ import annotations

import torch
from torch import nn

from ..ops.layers import MLP, Dense
from .base import RecModel


class _EntireSpace(RecModel):
    """Parallel towers over one DNN input, each an MLP and a 1-unit final
    layer without a bias; every head shares ONE scalar output bias (the
    reference uses the base class's single ``self.out``).  ``domain_mask``
    is ignored, as in the reference.  The heads are no ``[B, T, H] . [T, H]``
    product with a bias per task, so they stay plain tensor ops as in the
    JAX package; the forward's one kernel is the embed-concat."""

    # reference esmm.py:38-43, escm.py:66-71: ctr/cvr DNNs + their final
    # layers (the escm_dr imp tower is NOT registered in the reference either)
    REG_DNN_PREFIXES = ("ctr_dnn", "cvr_dnn", "ctr_final", "cvr_final")

    def tower_names(self):
        return ("ctr", "cvr")

    def __init__(self, layout, cfg, *, generator: torch.Generator, init_std: float = 1e-4):
        super().__init__(layout, cfg, generator=generator, init_std=init_std)
        units = self.mc.expert_dnn_hidden_units
        self.embeddings = self._make_embeddings(generator)
        self.towers = self.tower_names()
        for name in self.towers:
            self.add_module(f"{name}_dnn", MLP(self.input_dim, units,
                                               **self.mlp_kwargs(generator)))
            self.add_module(f"{name}_final", Dense(units[-1], 1, generator=generator,
                                                   use_bias=False))
        self.out_bias = nn.Parameter(torch.zeros(1))

    def _tower(self, name: str, dnn_input: torch.Tensor, wide=None):
        """(hidden [B, H], probability [B]) of one tower; ``wide`` [B, 1] is
        the opt-in wide logit."""
        h = getattr(self, f"{name}_dnn")(dnn_input)
        z = getattr(self, f"{name}_final")(h)[:, 0] + self.out_bias[0]
        return h, torch.sigmoid(z if wide is None else z + wide[:, 0])


class ESMM(_EntireSpace):
    """Entire-space multi-task model: parallel CTR and CVR towers; outputs
    [pCTR, pCTR * pCVR] (reference model/esmm.py:46-70)."""

    def forward(self, ids, dense, domain_mask=None, *, rows=None,
                return_intermediates: bool = False):
        dnn_input, _ = self.embed_inputs(ids, dense, rows)
        wide = self.wide_logit(ids, dense)
        ctr_h, ctr = self._tower("ctr", dnn_input, wide)
        cvr_h, cvr = self._tower("cvr", dnn_input, wide)
        probs = torch.stack([ctr, ctr * cvr], dim=-1)
        if not return_intermediates:
            return probs
        return probs, {"dnn_input": dnn_input, "target0_output": ctr_h,
                       "target1_output": cvr_h}


class ESCM(_EntireSpace):
    """ESCM^2: ESMM's towers with outputs [pCTR, pCVR, pCTCVR] (+ pIMP for
    ``escm_dr``); the IPW counterfactual CVR loss lives in train/losses.py
    (reference model/escm.py:74-111)."""

    def tower_names(self):
        return ("ctr", "cvr") + (("imp",) if self.mc.model_name == "escm_dr" else ())

    def forward(self, ids, dense, domain_mask=None, *, rows=None,
                return_intermediates: bool = False):
        dnn_input, _ = self.embed_inputs(ids, dense, rows)
        wide = self.wide_logit(ids, dense)
        preds = {name: self._tower(name, dnn_input, wide)[1] for name in self.towers}
        outs = [preds["ctr"], preds["cvr"], preds["ctr"] * preds["cvr"]]
        if "imp" in preds:
            outs.append(preds["imp"])
        probs = torch.stack(outs, dim=-1)
        return (probs, {"dnn_input": dnn_input}) if return_intermediates else probs
