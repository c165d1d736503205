"""SNR and MSSM (reference model/snr_trans.py, model/mssm.py; the port of
``mmlrec_tpu/models/snr.py``)."""

from __future__ import annotations

import torch

from ..ops.layers import SNRGate, StackedMLP
from .base import RecModel


class _SNRBase(RecModel):
    """Expert layers alternating with learned routing layers: level i is a
    stack of E one-layer experts (``trans_{i+1}``) and an ``SNRGate``
    (``gate_{i+1}``) from the E experts to the E of the next level, or to
    the T tasks at the last; then the towers and the heads.  SNR's gate
    scales each connection by a scalar, MSSM's each output feature.

    Two kernels a forward: the embed-concat and the fused head (the
    ``tower_final`` product, one multihead-score launch).  With
    ``ref_faithful_frozen_params`` the gates' ``trans`` (and MSSM's ``u``)
    take no gradient, as the reference leaves them unregistered."""

    elementwise = False
    freeze_u = False

    def __init__(self, layout, cfg, *, generator: torch.Generator, init_std: float = 1e-4):
        super().__init__(layout, cfg, generator=generator, init_std=init_std)
        mc, T, E = self.mc, self.num_tasks, self.mc.num_experts
        if T <= 1:
            raise ValueError("num_tasks must be greater than 1")
        if E <= 1:
            raise ValueError("num_experts must be greater than 1")
        mlp = self.mlp_kwargs(generator)
        extra, freeze = mc.extra, mc.ref_faithful_frozen_params
        self.embeddings = self._make_embeddings(generator)
        units = list(mc.expert_dnn_hidden_units)
        self.n_levels = len(units)
        d_in = self.input_dim
        for i, u in enumerate(units):
            self.add_module(f"trans_{i + 1}", StackedMLP(E, d_in, [u], **mlp))
            self.add_module(f"gate_{i + 1}", SNRGate(
                E, T if i == self.n_levels - 1 else E, u, generator=generator,
                elementwise=self.elementwise, freeze_trans_ref_faithful=freeze,
                freeze_u_ref_faithful=freeze and self.freeze_u,
                stochastic=bool(extra.get("snr_stochastic_gates")),
                per_connection_alpha=extra.get("snr_gate_alpha", "scalar") == "per_connection",
                open_init_alpha=extra.get("snr_gate_open_init")))
            d_in = u
        self.make_towers(d_in, generator)

    def forward(self, ids, dense, domain_mask=None, *, rows=None,
                return_intermediates: bool = False):
        dnn_input, _ = self.embed_inputs(ids, dense, rows)
        x = dnn_input  # rank 2 at level 0: broadcast to the experts
        for i in range(1, self.n_levels + 1):
            x = getattr(self, f"gate_{i}")(getattr(self, f"trans_{i}")(x))
        probs = self.tower_scores(x, domain_mask, wide=self.wide_logit(ids, dense))
        return (probs, {"dnn_input": dnn_input}) if return_intermediates else probs


class SNRTrans(_SNRBase):
    """SNR with transform routing (reference model/snr_trans.py:52-157)."""

    # reference snr_trans.py:108-110: ONLY the tower DNN gets l2_reg_dnn
    REG_DNN_PREFIXES = ("tower_dnn",)


class MSSM(_SNRBase):
    """MSSM, field-level sparse sharing (reference model/mssm.py:62-180)."""

    # reference mssm.py:129-131: ONLY the tower DNN gets l2_reg_dnn
    REG_DNN_PREFIXES = ("tower_dnn",)

    elementwise = True
    freeze_u = True  # the reference registers neither u nor trans
