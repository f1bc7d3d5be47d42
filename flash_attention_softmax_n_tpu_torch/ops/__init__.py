from flash_attention_softmax_n_tpu_torch.ops.flash_attention import flash_attention_n
from flash_attention_softmax_n_tpu_torch.ops.functional import slow_attention_n, softmax_n
from flash_attention_softmax_n_tpu_torch.ops.sampling import sample_tokens

__all__ = ["flash_attention_n", "slow_attention_n", "softmax_n", "sample_tokens"]
