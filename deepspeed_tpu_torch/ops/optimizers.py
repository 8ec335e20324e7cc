"""Optimizers (the port of ``deepspeed_tpu/ops/optimizers.py``: the base
``Optimizer`` interface, ``AdamState`` and ``Adam``).

Same interface as the JAX package: an Optimizer holds static
hyperparameters, ``init`` builds a state shaped like the params, and
``update(grads, state, params, lr)`` returns ``(params, state)``. Unlike
JAX, the port updates the fp32 params and moments IN PLACE (the returned
trees are the same tensors), which saves a params-sized copy per leaf;
the update runs as ``torch._foreach_*`` passes over all leaves at once.
Stochastic rounding, Adam8bit, SGD and Lamb are not ported yet.
"""

from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_map

__all__ = ["Optimizer", "Adam", "AdamState", "build_optimizer"]

Params = Any


class AdamState(NamedTuple):
    step: int          # updates taken
    exp_avg: Params    # first moment, fp32
    exp_avg_sq: Params  # second moment, fp32


class Optimizer:
    """Base: subclasses implement init/update."""

    def init(self, params: Params):
        raise NotImplementedError

    def update(self, grads, state, params: Params,
               lr: Optional[float] = None) -> Tuple[Params, Any]:
        raise NotImplementedError


class Adam(Optimizer):
    """Adam/AdamW. ``adamw_mode`` selects decoupled weight decay. The
    update is the JAX package's, term for term:
    ``(m / bc1) / (sqrt(v / bc2) + eps)``, bias corrections computed in
    fp32 (both 1 with ``bias_correction=False``)."""

    def __init__(self, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 adamw_mode: bool = True, bias_correction: bool = True):
        self.lr = lr
        self.b1, self.b2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.adamw_mode = adamw_mode
        self.bias_correction = bias_correction

    def init(self, params):
        def zeros(t):
            return torch.zeros_like(t, dtype=torch.float32)
        return AdamState(step=0, exp_avg=tree_map(zeros, params),
                         exp_avg_sq=tree_map(zeros, params))

    def _corrections(self, step: int):
        if not self.bias_correction:
            return 1.0, 1.0
        one, s = np.float32(1.0), np.float32(step)
        return (float(one - np.float32(self.b1) ** s),
                float(one - np.float32(self.b2) ** s))

    @torch.no_grad()
    def update(self, grads, state: AdamState, params, lr=None):
        """One Adam step over every leaf, in place. ``params`` and the
        moments are fp32; ``grads`` are cast to fp32."""
        lr = self.lr if lr is None else lr
        step = state.step + 1
        bc1, bc2 = self._corrections(step)
        b1, b2, eps, wd = self.b1, self.b2, self.eps, self.weight_decay
        ps = list(tree_leaves(params))
        gs = [g.float() for g in tree_leaves(grads)]
        ms = list(tree_leaves(state.exp_avg))
        vs = list(tree_leaves(state.exp_avg_sq))
        if wd != 0.0 and not self.adamw_mode:
            gs = torch._foreach_add(gs, ps, alpha=wd)    # L2-style
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, gs, alpha=1.0 - b1)
        torch._foreach_mul_(vs, b2)
        torch._foreach_addcmul_(vs, gs, gs, value=1.0 - b2)
        denom = torch._foreach_div(vs, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_div(ms, bc1)
        torch._foreach_div_(upd, denom)
        if wd != 0.0 and self.adamw_mode:
            torch._foreach_add_(upd, ps, alpha=wd)      # decoupled (AdamW)
        torch._foreach_add_(ps, upd, alpha=-lr)
        return params, AdamState(step=step, exp_avg=state.exp_avg,
                                 exp_avg_sq=state.exp_avg_sq)


def build_optimizer(name: Optional[str],
                    params_dict: Optional[dict]) -> Optimizer:
    """From the JSON config's ``optimizer`` section, as the JAX package
    builds it; optimizers not ported yet raise."""
    p = dict(params_dict or {})
    name = (name or "adam").lower()
    if name in ("adam", "deepspeed_adam"):
        return Adam(lr=p.get("lr", 1e-3),
                    betas=tuple(p.get("betas", (0.9, 0.999))),
                    eps=p.get("eps", 1e-8),
                    weight_decay=p.get("weight_decay", 0.0),
                    adamw_mode=p.get("adam_w_mode", True),
                    bias_correction=p.get("bias_correction", True))
    if name == "adamw":
        return Adam(lr=p.get("lr", 1e-3),
                    betas=tuple(p.get("betas", (0.9, 0.999))),
                    eps=p.get("eps", 1e-8),
                    weight_decay=p.get("weight_decay", 0.01),
                    adamw_mode=True,
                    bias_correction=p.get("bias_correction", True))
    raise NotImplementedError(
        f"optimizer {name!r} is not ported yet (the port has Adam and "
        "AdamW; Adam8bit, SGD, Lamb and OnebitAdam wait)")
