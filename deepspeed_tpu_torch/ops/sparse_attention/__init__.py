"""Block-sparse attention (the port of
``deepspeed_tpu/ops/sparse_attention``): sparsity layout configs, the
block-sparse front end over the masked flash kernels K1-K3 and, with a
user attention mask, the row-run kernels K8-K10, its legacy dispatch
(the banded kernels K11-K13, the hybrid, K8-K10 without a mask), the v1
kernels K14-K16 (``USE_SPLASH_V2 = False``), the attention modules, and
the composable ``MatMul`` / ``Softmax`` ops."""

from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (  # noqa
    SparsityConfig, DenseSparsityConfig, FixedSparsityConfig,
    VariableSparsityConfig, BigBirdSparsityConfig,
    BSLongformerSparsityConfig, sparsity_config_from_dict)
from deepspeed_tpu_torch.ops.sparse_attention.blocksparse import (  # noqa
    block_sparse_attention, block_sparse_attention_reference,
    build_row_luts, build_col_luts, build_triples, layout_additive_mask,
    TriplePlan, triple_attention, bs_fwd, bs_dq, bs_dkv)
from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import (  # noqa
    SparseSelfAttention, BertSparseSelfAttention,
    init_bert_sparse_self_attention_params, SparseAttentionUtils)
from deepspeed_tpu_torch.ops.sparse_attention.ops import (  # noqa
    MatMul, Softmax)
