from flash_attention_softmax_n_tpu_torch.models.bert import (
    BertConfig,
    bert_forward,
    init_bert_kv_cache,
    init_bert_params,
)
from flash_attention_softmax_n_tpu_torch.models.decoder import (
    DecoderConfig,
    decode_step,
    decoder_forward,
    greedy_generate,
    init_decoder_params,
    init_kv_cache,
    prefill,
)

__all__ = [
    "BertConfig",
    "bert_forward",
    "init_bert_kv_cache",
    "init_bert_params",
    "DecoderConfig",
    "decoder_forward",
    "init_decoder_params",
    "init_kv_cache",
    "prefill",
    "decode_step",
    "greedy_generate",
]
