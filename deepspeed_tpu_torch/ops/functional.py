"""Elementwise building blocks of the serving slice (the port of
``deepspeed_tpu/ops/functional.py``'s ``layer_norm``).

GELU is ``torch.nn.functional.gelu(x, approximate="tanh")`` at its call
site, as ``jax.nn.gelu(approximate=True)`` is in the JAX model.
"""

import torch
import torch.nn.functional as F


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-12) -> torch.Tensor:
    """LayerNorm with fp32 statistics whatever the input dtype (biased
    variance, as the JAX version), output in the input dtype."""
    out = F.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(),
                       eps)
    return out.to(x.dtype)
