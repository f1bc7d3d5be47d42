from flash_attention_softmax_n_tpu_torch.parallel.mesh import (
    initialize_distributed,
    local_mesh,
    make_mesh,
)
from flash_attention_softmax_n_tpu_torch.parallel.ring_attention import (
    ring_attention_n,
)
from flash_attention_softmax_n_tpu_torch.parallel.sharding import (
    batch_spec,
    decoder_param_specs,
    kv_cache_specs,
    shard_pytree,
)
from flash_attention_softmax_n_tpu_torch.parallel.serving import (
    make_sharded_decode,
    shard_engine_state,
)
from flash_attention_softmax_n_tpu_torch.parallel.train import (
    TrainState,
    causal_lm_loss,
    make_train_step,
)

__all__ = [
    "make_mesh",
    "local_mesh",
    "initialize_distributed",
    "decoder_param_specs",
    "kv_cache_specs",
    "batch_spec",
    "shard_pytree",
    "ring_attention_n",
    "causal_lm_loss",
    "make_train_step",
    "TrainState",
    "shard_engine_state",
    "make_sharded_decode",
]
