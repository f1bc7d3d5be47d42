"""Checkpoints (``checkpoint``, in the JAX package's format), profiling
helpers (``profiling``) and the prefill-phase profile
(``python -m flash_attention_softmax_n_tpu_torch.utils.profile_prefill_phases``)."""
from flash_attention_softmax_n_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    load_train_checkpoint,
    save_checkpoint,
    save_train_checkpoint,
)
from flash_attention_softmax_n_tpu_torch.utils.profiling import (
    H100,
    ChipSpec,
    attention_roofline,
    measure,
    trace,
)

__all__ = ["save_checkpoint", "load_checkpoint", "save_train_checkpoint",
           "load_train_checkpoint", "trace", "measure", "attention_roofline",
           "ChipSpec", "H100"]
