from flash_attention_softmax_n_tpu_torch.parallel.train import (
    TrainState,
    causal_lm_loss,
    make_train_step,
)

__all__ = ["TrainState", "causal_lm_loss", "make_train_step"]
