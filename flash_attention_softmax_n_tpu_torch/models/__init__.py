from flash_attention_softmax_n_tpu_torch.models.decoder import (
    DecoderConfig,
    decode_step,
    decoder_forward,
    greedy_generate,
    init_decoder_params,
    init_kv_cache,
    prefill,
)

__all__ = ["DecoderConfig", "decode_step", "decoder_forward", "greedy_generate",
           "init_decoder_params", "init_kv_cache", "prefill"]
