from deepspeed_tpu_torch.ops.attention.flash import (attention_reference,
                                                     flash_attention,
                                                     get_attention_options,
                                                     set_attention_options)

__all__ = ["attention_reference", "flash_attention", "get_attention_options",
           "set_attention_options"]
