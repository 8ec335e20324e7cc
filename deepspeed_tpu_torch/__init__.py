"""deepspeed_tpu_torch: the PyTorch/CUDA port of deepspeed_tpu for NVIDIA
Hopper GPUs.

This package imports torch and numpy, never jax and nothing of
``deepspeed_tpu``. What is ported so far is paged GPT-2 serving:
``InferenceEngine`` over the paged KV pool, with decode attention in a
hand-written CUDA kernel (``ops/attention/paged.py``). Entry points run
on CUDA unless the caller passes ``device="cpu"``.
"""

from deepspeed_tpu_torch.inference import (FinishedRequest, InferenceEngine,
                                           Request)
from deepspeed_tpu_torch.models.gpt2 import (GPT2_LARGE, GPT2_MEDIUM,
                                             GPT2_SMALL, GPT2_XL, GPT2Config,
                                             init_gpt2_params,
                                             params_from_jax)

__all__ = ["InferenceEngine", "Request", "FinishedRequest", "GPT2Config",
           "GPT2_SMALL", "GPT2_MEDIUM", "GPT2_LARGE", "GPT2_XL",
           "init_gpt2_params", "params_from_jax"]
