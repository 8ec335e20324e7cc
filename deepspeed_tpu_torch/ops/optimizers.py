"""Optimizers (the port of ``deepspeed_tpu/ops/optimizers.py``: the base
``Optimizer`` interface, ``AdamState``/``Adam``, ``LambState``/``Lamb``,
the ``FusedAdam``/``FusedLamb`` aliases and ``build_optimizer``).

Same interface as the JAX package: an Optimizer holds static
hyperparameters, ``init`` builds a state shaped like the params, and
``update(grads, state, params, lr, momentum)`` returns ``(params,
state)``; ``momentum`` overrides beta1 (OneCycle's momentum cycling).
Unlike JAX, the port updates the fp32 params and moments IN PLACE (the
returned trees are the same tensors), which saves a params-sized copy
per leaf; the update runs as ``torch._foreach_*`` passes over all leaves
at once. Stochastic rounding, Adam8bit and SGD are not ported yet.
"""

from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_map

__all__ = ["Optimizer", "Adam", "AdamState", "Lamb", "LambState",
           "FusedAdam", "FusedLamb", "build_optimizer"]

Params = Any


class AdamState(NamedTuple):
    step: int          # updates taken
    exp_avg: Params    # first moment, fp32
    exp_avg_sq: Params  # second moment, fp32


class LambState(NamedTuple):
    step: int
    exp_avg: Params
    exp_avg_sq: Params


class Optimizer:
    """Base: subclasses implement init/update."""

    def init(self, params: Params):
        raise NotImplementedError

    def update(self, grads, state, params: Params,
               lr: Optional[float] = None,
               momentum: Optional[float] = None) -> Tuple[Params, Any]:
        raise NotImplementedError


def _zero_moments(params):
    def zeros(t):
        return torch.zeros_like(t, dtype=torch.float32)
    return tree_map(zeros, params), tree_map(zeros, params)


def _corrections(b1: float, b2: float, step: int, on: bool):
    """Adam's bias corrections ``1 - beta**step``, computed in fp32 as
    the JAX package computes them (both 1 when ``on`` is False)."""
    if not on:
        return 1.0, 1.0
    one, s = np.float32(1.0), np.float32(step)
    return (float(one - np.float32(b1) ** s),
            float(one - np.float32(b2) ** s))


def _adam_direction(gs, ms, vs, b1, b2, bc1, bc2, eps):
    """Update the moments in place and return the per-leaf Adam step
    ``(m / bc1) / (sqrt(v / bc2) + eps)``."""
    torch._foreach_mul_(ms, b1)
    torch._foreach_add_(ms, gs, alpha=1.0 - b1)
    torch._foreach_mul_(vs, b2)
    torch._foreach_addcmul_(vs, gs, gs, value=1.0 - b2)
    denom = torch._foreach_div(vs, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    upd = torch._foreach_div(ms, bc1)
    torch._foreach_div_(upd, denom)
    return upd


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
        return AdamState(0, *_zero_moments(params))

    @torch.no_grad()
    def update(self, grads, state: AdamState, params, lr=None,
               momentum=None):
        """One Adam step over every leaf, in place. ``params`` and the
        moments are fp32; ``grads`` are cast to fp32. ``momentum``
        overrides beta1 (bias correction included)."""
        lr = self.lr if lr is None else lr
        b1 = self.b1 if momentum is None else momentum
        step = state.step + 1
        bc1, bc2 = _corrections(b1, self.b2, step, self.bias_correction)
        b2, eps, wd = self.b2, self.eps, self.weight_decay
        ps = list(tree_leaves(params))
        gs = [g.float() for g in tree_leaves(grads)]
        ms = list(tree_leaves(state.exp_avg))
        vs = list(tree_leaves(state.exp_avg_sq))
        if wd != 0.0 and not self.adamw_mode:
            gs = torch._foreach_add(gs, ps, alpha=wd)    # L2-style
        upd = _adam_direction(gs, ms, vs, b1, b2, bc1, bc2, eps)
        if wd != 0.0 and self.adamw_mode:
            torch._foreach_add_(upd, ps, alpha=wd)      # decoupled (AdamW)
        torch._foreach_add_(ps, upd, alpha=-lr)
        return params, AdamState(step=step, exp_avg=state.exp_avg,
                                 exp_avg_sq=state.exp_avg_sq)


class Lamb(Optimizer):
    """LAMB: layer-wise adaptive Adam for large batches. Each leaf's Adam
    step (weight decay added) is scaled by its trust ratio
    ``||w|| / ||update||`` over the fp32 master, clamped to
    ``[min_coeff, max_coeff]``, and 1.0 when either norm is 0; the
    ratios come in leaf order (sorted dict keys, JAX's order), and
    ``last_trust`` holds the last update's as a device tensor, beside
    ``last_zero_norm``, which of its leaves had a weight or update norm
    of 0. Over ZeRO shards the engine sets ``leaf_norms``, which turns the
    norms of the blocks this rank holds into the whole leaves' norms."""

    def __init__(self, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 max_coeff: float = 10.0, min_coeff: float = 0.01,
                 bias_correction: bool = True):
        self.lr = lr
        self.b1, self.b2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.max_coeff = max_coeff
        self.min_coeff = min_coeff
        self.bias_correction = bias_correction
        self.last_trust = None
        self.last_zero_norm = None
        self.leaf_norms = None

    def init(self, params):
        return LambState(0, *_zero_moments(params))

    def _trust(self, ps, upd):
        """(the trust ratios, whether each leaf's ratio is 1 for a norm
        of 0)."""
        w = torch.stack(torch._foreach_norm(ps))
        u = torch.stack(torch._foreach_norm(upd))
        if self.leaf_norms is not None:
            w, u = self.leaf_norms(w), self.leaf_norms(u)
        nonzero = (w > 0) & (u > 0)
        return torch.where(nonzero,
                           torch.clamp(w / u, self.min_coeff,
                                       self.max_coeff),
                           torch.ones_like(w)), ~nonzero

    def _direction(self, grads, state: LambState, params, momentum,
                   in_place: bool):
        b1 = self.b1 if momentum is None else momentum
        step = state.step + 1
        bc1, bc2 = _corrections(b1, self.b2, step, self.bias_correction)
        ps = list(tree_leaves(params))
        gs = [g.float() for g in tree_leaves(grads)]
        ms = list(tree_leaves(state.exp_avg))
        vs = list(tree_leaves(state.exp_avg_sq))
        if not in_place:
            ms = [m.clone() for m in ms]
            vs = [v.clone() for v in vs]
        upd = _adam_direction(gs, ms, vs, b1, self.b2, bc1, bc2, self.eps)
        if self.weight_decay != 0.0:
            torch._foreach_add_(upd, ps, alpha=self.weight_decay)
        return step, ps, upd

    @torch.no_grad()
    def update(self, grads, state: LambState, params, lr=None,
               momentum=None):
        """One LAMB step over every leaf, in place; the trust ratios stay
        on the device (``last_trust``) until :meth:`get_lamb_coeffs` reads
        them."""
        lr = self.lr if lr is None else lr
        step, ps, upd = self._direction(grads, state, params, momentum,
                                        in_place=True)
        trust, self.last_zero_norm = self._trust(ps, upd)
        torch._foreach_mul_(upd, list((trust * -lr).unbind()))
        torch._foreach_add_(ps, upd)
        self.last_trust = trust
        return params, LambState(step=step, exp_avg=state.exp_avg,
                                 exp_avg_sq=state.exp_avg_sq)

    def get_lamb_coeffs(self):
        """The last update's trust ratios as floats, in leaf order (empty
        before the first update)."""
        if self.last_trust is None:
            return []
        return [float(c) for c in self.last_trust.cpu()]

    @torch.no_grad()
    def lamb_coeffs(self, grads, state: LambState, params):
        """The trust ratios the next update would use for these grads,
        state and params, changing none of them."""
        _, ps, upd = self._direction(grads, state, params, None,
                                     in_place=False)
        return [float(c) for c in self._trust(ps, upd)[0].cpu()]


# the reference's public names
FusedAdam = Adam
FusedLamb = Lamb


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
    if name == "lamb":
        return Lamb(lr=p.get("lr", 1e-3),
                    betas=tuple(p.get("betas", (0.9, 0.999))),
                    eps=p.get("eps", 1e-8),
                    weight_decay=p.get("weight_decay", 0.0),
                    max_coeff=p.get("max_coeff", 10.0),
                    min_coeff=p.get("min_coeff", 0.01),
                    bias_correction=p.get("bias_correction", True))
    raise NotImplementedError(
        f"optimizer {name!r} is not ported yet (the port has Adam, AdamW "
        "and Lamb; Adam8bit, SGD and OnebitAdam wait)")
