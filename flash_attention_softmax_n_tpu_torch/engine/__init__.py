from flash_attention_softmax_n_tpu_torch.engine.engine import (
    InferenceEngine,
    Request,
    engine_decode,
    engine_decode_loop,
    engine_prefill,
    engine_prefill_batch,
    engine_prefill_chunk,
)

__all__ = ["InferenceEngine", "Request", "engine_prefill",
           "engine_prefill_batch", "engine_prefill_chunk", "engine_decode",
           "engine_decode_loop"]
