"""deepspeed_tpu_torch: the PyTorch/CUDA port of deepspeed_tpu for NVIDIA
Hopper GPUs.

This package imports torch and numpy, never jax and nothing of
``deepspeed_tpu``. Ported so far:

- training: :func:`initialize` builds a :class:`DeepSpeedEngine` (ZeRO
  stages 0-2 over the launcher's process group, one process per device,
  and ZeRO-Offload to the host's C++ Adam; bf16 over fp32 masters; Adam
  or Lamb; the lr schedules of ``runtime/lr_schedules.py``)
  that trains a loss function such as ``models.gpt2.gpt2_loss_fn`` or
  ``models.bert.bert_mlm_loss_fn`` (BERT MLM pretraining on the
  DeepSpeed transformer layer, :class:`DeepSpeedTransformerLayer`), whose
  attention runs the masked-flash kernels K1-K3 written in CUDA
  (``ops/attention/masked_flash.py``), BERT's padding mask in their
  key-mask arity; with a ``sparsity_config`` (``ops/sparse_attention``,
  from a config's ``sparse_attention`` section) BERT's attention is
  block-sparse, banded layouts in the kernels' KIND_BAND arity;
- paged serving of GPT-2 and Llama (GQA) models: ``InferenceEngine``
  over the paged KV pool, bf16 or int8, with decode attention in
  hand-written CUDA kernels (``ops/attention/paged.py``);
- checkpoints in the JAX package's tag layout, so tags pass between the
  packages: ``DeepSpeedEngine.save_checkpoint`` / ``load_checkpoint``
  (atomic commit, verification, fallback; ``runtime/checkpoint.py``),
  ``InferenceEngine.from_checkpoint`` / ``swap_params``, and ``python -m
  deepspeed_tpu_torch.tools.verify_checkpoint``; the training trace
  window (``observability.trace``) records a ``torch.profiler`` trace.

Entry points run on CUDA unless the caller passes ``device="cpu"``.
``python -m deepspeed_tpu_torch.launcher.runner`` launches a script on
every local GPU (gloo children with ``device="cpu"``), and
:func:`init_distributed` joins its process group.
"""

from deepspeed_tpu_torch.distributed import init_distributed
from deepspeed_tpu_torch.inference import (FinishedRequest, InferenceEngine,
                                           Request)
from deepspeed_tpu_torch.models.bert import BERT_BASE, BERT_LARGE, BertConfig
from deepspeed_tpu_torch.models.gpt2 import (GPT2_LARGE, GPT2_MEDIUM,
                                             GPT2_SMALL, GPT2_XL, GPT2Config,
                                             init_gpt2_params,
                                             params_from_jax)
from deepspeed_tpu_torch.models.llama import LlamaConfig
from deepspeed_tpu_torch.ops.optimizers import Adam, Lamb
from deepspeed_tpu_torch.ops.transformer.transformer import (
    DeepSpeedTransformerConfig, DeepSpeedTransformerLayer)
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.dataloader import (DeepSpeedDataLoader,
                                                    RepeatingLoader)
from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine

__all__ = ["initialize", "DeepSpeedEngine", "DeepSpeedConfig", "Adam",
           "Lamb", "DeepSpeedDataLoader", "RepeatingLoader",
           "InferenceEngine", "Request", "FinishedRequest", "GPT2Config",
           "GPT2_SMALL", "GPT2_MEDIUM", "GPT2_LARGE", "GPT2_XL",
           "LlamaConfig", "BertConfig", "BERT_BASE", "BERT_LARGE",
           "DeepSpeedTransformerConfig", "DeepSpeedTransformerLayer",
           "init_gpt2_params", "params_from_jax", "init_distributed"]


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, collate_fn=None,
               config=None, config_params=None, seed: int = 0, device=None):
    """Initialize the training engine (the JAX package's ``initialize``).

    Returns ``(engine, optimizer, training_dataloader, lr_scheduler)``;
    the schedule is the caller's ``lr_scheduler`` or the one the config's
    ``scheduler`` section builds (None without either).
    ``model`` is a loss function ``loss_fn(params, batch[, seed])`` and
    ``model_parameters`` its initial parameter tree. ``device`` defaults
    to the current CUDA device; without a card pass ``device="cpu"``."""
    engine = DeepSpeedEngine(args=args, model=model, optimizer=optimizer,
                             model_parameters=model_parameters,
                             training_data=training_data,
                             lr_scheduler=lr_scheduler,
                             collate_fn=collate_fn, config=config,
                             config_params=config_params, seed=seed,
                             device=device)
    return (engine, engine.optimizer, engine.training_dataloader,
            engine.lr_scheduler)
