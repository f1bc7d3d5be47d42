from flash_attention_softmax_n_tpu_torch.surgery.attention_softmax_n import (
    AttentionSoftmaxN,
    apply_attention_softmax_n,
    from_pretrained_hf,
)
from flash_attention_softmax_n_tpu_torch.surgery.registry import (
    PolicyRegistry,
    policy_registry,
)

__all__ = [
    "apply_attention_softmax_n",
    "AttentionSoftmaxN",
    "from_pretrained_hf",
    "PolicyRegistry",
    "policy_registry",
]
