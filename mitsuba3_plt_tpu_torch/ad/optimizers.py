"""SGD (with momentum) and Adam with per-parameter learning rates and
masked updates.

The JAX package's `ad/optimizers.py` (after the reference's
ad/optimizers.py): pure (params, grads, state) -> (params, state) steps
over dicts of tensors. A parameter without a gradient keeps its value and
state; a mask (bool, broadcast against the parameter) keeps the masked-off
entries.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch


@dataclasses.dataclass
class SGD:
    lr: float = 0.1
    momentum: float = 0.0
    lr_per_param: Dict[str, float] = dataclasses.field(default_factory=dict)

    def init(self, params: Dict[str, Any]):
        if self.momentum == 0.0:
            return {}
        return {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params, grads, state, masks: Optional[dict] = None):
        new_params, new_state = {}, {}
        for k, p in params.items():
            g = grads.get(k)
            if g is None:
                new_params[k] = p
                if k in state:
                    new_state[k] = state[k]
                continue
            lr = self.lr_per_param.get(k, self.lr)
            if self.momentum != 0.0:
                v = self.momentum * state[k] + g
                new_state[k] = v
                upd = lr * v
            else:
                upd = lr * g
            if masks and k in masks:
                upd = torch.where(masks[k], upd, 0.0)
            new_params[k] = p - upd
        return new_params, new_state


@dataclasses.dataclass
class Adam:
    lr: float = 0.02
    beta_1: float = 0.9
    beta_2: float = 0.999
    epsilon: float = 1e-8
    lr_per_param: Dict[str, float] = dataclasses.field(default_factory=dict)
    # the reference's `uniform` flag: one second moment a parameter, its
    # largest entry (UniformAdam)
    uniform: bool = False

    def init(self, params: Dict[str, Any]):
        return {
            "t": 0,
            "m": {k: torch.zeros_like(v) for k, v in params.items()},
            "v": {k: torch.zeros_like(v) for k, v in params.items()},
        }

    @torch.no_grad()
    def step(self, params, grads, state, masks: Optional[dict] = None):
        t = state["t"] + 1
        # the bias corrections in float32, as the JAX package forms them
        c1 = 1 - torch.tensor(self.beta_1, dtype=torch.float32) ** t
        c2 = 1 - torch.tensor(self.beta_2, dtype=torch.float32) ** t
        new_m, new_v, new_params = {}, {}, {}
        for k, p in params.items():
            g = grads.get(k)
            if g is None:
                new_params[k] = p
                new_m[k] = state["m"][k]
                new_v[k] = state["v"][k]
                continue
            lr = self.lr_per_param.get(k, self.lr)
            m = self.beta_1 * state["m"][k] + (1 - self.beta_1) * g
            v = self.beta_2 * state["v"][k] + (1 - self.beta_2) * g * g
            if self.uniform:
                v = torch.amax(v).expand(v.shape)
            m_hat = m / c1.to(m.device)
            v_hat = v / c2.to(v.device)
            upd = lr * m_hat / (torch.sqrt(v_hat) + self.epsilon)
            if masks and k in masks:
                upd = torch.where(masks[k], upd, 0.0)
            new_params[k] = p - upd
            new_m[k] = m
            new_v[k] = v
        return new_params, {"t": t, "m": new_m, "v": new_v}
