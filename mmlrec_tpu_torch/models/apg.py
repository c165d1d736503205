"""APG, adaptive parameter generation (reference model/apg.py; the port of
``mmlrec_tpu/models/apg.py``)."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops.initializers import normal_init, torch_linear_bias_init, xavier_uniform_init
from ..ops.layers import Dense, StackedDense, activation_fn
from .base import RecModel


class APGLayer(nn.Module):
    """An MLP layer whose middle ``k x k`` block and its bias are generated
    per example from the (detached) scene embedding (reference APGLayer,
    model/apg.py:9-124; mmlrec_tpu/models/apg.py:17-106), in its three
    forms: ``use_uv_shared`` with the ``use_mf_p`` low-rank sandwich or
    without it (what ``APG`` builds: ``x @ w_nk -> [B, k, k] -> @ w_km``),
    and every matrix generated (``use_uv_shared`` off).  The generators are
    one-layer ``Dense``s with a normal(init_std) kernel and torch's default
    bias; the shared matrices are Xavier-uniform, their biases zero."""

    def __init__(self, input_dim: int, output_dim: int, scene_emb_dim: int, *,
                 generator: torch.Generator, activation: Optional[str] = "relu",
                 generate_activation: Optional[str] = None,
                 inner_activation: Optional[str] = None, use_uv_shared: bool = True,
                 mf_k: int = 16, use_mf_p: bool = True, mf_p: int = 4,
                 init_std: float = 1e-4):
        super().__init__()
        min_dim = min(input_dim, output_dim)
        p, k = math.ceil(min_dim / mf_p), math.ceil(min_dim / mf_k)
        self.k, self.output_dim = k, output_dim
        self.use_uv_shared, self.use_mf_p = bool(use_uv_shared), bool(use_mf_p)
        self.gen_act = activation_fn(generate_activation)  # None: the identity
        self.inner = activation_fn(inner_activation)
        self.act = activation_fn(activation)

        def gen(name, out):
            self.add_module(name, Dense(scene_emb_dim, out, generator=generator,
                                        kernel_init=normal_init(init_std),
                                        bias_init=torch_linear_bias_init(scene_emb_dim)))

        def shared(name, shape):
            setattr(self, name, nn.Parameter(xavier_uniform_init()(generator, shape)))
            setattr(self, "b" + name[1:], nn.Parameter(torch.zeros(shape[-1])))

        gen("specific_weight_kk", k * k)
        gen("specific_bias_kk", k)
        if not self.use_uv_shared:
            gen("specific_weight_nk", input_dim * k)
            gen("specific_bias_nk", k)
            gen("specific_weight_km", k * output_dim)
            gen("specific_bias_km", output_dim)
        elif self.use_mf_p:
            for name, shape in (("w_np", (input_dim, p)), ("w_pk", (p, k)), ("w_kp", (k, p)),
                                ("w_pm", (p, output_dim))):
                shared(name, shape)
        else:
            shared("w_nk", (input_dim, k))
            shared("w_km", (k, output_dim))

    def _generated(self, name, scene_emb):
        return self.gen_act(getattr(self, name)(scene_emb))

    def forward(self, x: torch.Tensor, scene_emb: torch.Tensor) -> torch.Tensor:
        k, inner = self.k, self.inner
        w_kk = self._generated("specific_weight_kk", scene_emb).reshape(-1, k, k)
        b_kk = self._generated("specific_bias_kk", scene_emb)
        if self.use_uv_shared:
            if self.use_mf_p:
                out = inner(x @ self.w_np + self.b_np)
                out = inner(out @ self.w_pk + self.b_pk)
                out = inner(torch.einsum("bk,bkj->bj", out, w_kk) + b_kk)
                out = inner(out @ self.w_kp + self.b_kp)
                out = out @ self.w_pm + self.b_pm
            else:
                out = inner(x @ self.w_nk + self.b_nk)
                out = inner(torch.einsum("bk,bkj->bj", out, w_kk) + b_kk)
                out = out @ self.w_km + self.b_km
        else:
            w_nk = self._generated("specific_weight_nk", scene_emb).reshape(-1, x.shape[-1], k)
            b_nk = self._generated("specific_bias_nk", scene_emb)
            w_km = self._generated("specific_weight_km", scene_emb).reshape(-1, k, self.output_dim)
            b_km = self._generated("specific_bias_km", scene_emb)
            out = inner(torch.einsum("bi,bik->bk", x, w_nk) + b_nk)
            out = inner(torch.einsum("bk,bkj->bj", out, w_kk) + b_kk)
            out = torch.einsum("bk,bko->bo", out, w_km) + b_km
        return self.act(out)


class APG(RecModel):
    """APG (reference model/apg.py:128-193): a stack of ``APGLayer``s fed by
    the detached embedding of ``data_config.scene_feature``, in the form
    the reference instantiates (``use_uv_shared``, no ``use_mf_p``,
    ``mf_k`` 4), then the T tasks' ``final_layer`` ([T, H], no bias) on the
    last layer's output.  Two kernels a forward: the embed-concat and the
    fused head."""

    # reference apg.py has NO add_regularization_weight call: only the
    # embeddings (basemodel.py:129) are L2-penalized
    REG_DNN_PREFIXES = ()

    def __init__(self, layout, cfg, *, generator: torch.Generator, init_std: float = 1e-4):
        super().__init__(layout, cfg, generator=generator, init_std=init_std)
        mc, T = self.mc, self.num_tasks
        self.embeddings = self._make_embeddings(generator)
        self.scene_index = layout.sparse_feature_index(self.dc.scene_feature)
        units = [self.input_dim] + list(mc.dnn_hidden_units)
        self.depth = len(units) - 1
        for i in range(self.depth):
            self.add_module(f"apg_layer_{i}", APGLayer(
                units[i], units[i + 1], mc.emb, generator=generator,
                activation=mc.dnn_activation, use_uv_shared=True, use_mf_p=False, mf_k=4,
                mf_p=4, init_std=init_std))
        self.final_layer = StackedDense(T, units[-1], 1, generator=generator, use_bias=False)
        self.out = self.make_heads()

    def forward(self, ids, dense, domain_mask=None, *, rows=None,
                return_intermediates: bool = False):
        x, sparse_emb = self.embed_inputs(ids, dense, rows)
        inter = {"dnn_input": x}
        scene_emb = sparse_emb[:, self.scene_index].detach()  # [B, emb]
        for i in range(self.depth):
            x = getattr(self, f"apg_layer_{i}")(x, scene_emb)
            inter[f"apg_output_{i}"] = x
        inter["last_layer"] = x
        probs = self.head_scores(x, self.final_layer.kernel[..., 0], self.wide_logit(ids, dense))
        probs = self.apply_domain_mask(probs, domain_mask)
        return (probs, inter) if return_intermediates else probs
