from flash_attention_softmax_n_tpu_torch.quant.gates import (
    KURTOSIS_THRESHOLDS,
    gate_report,
    outlier_gate,
)
from flash_attention_softmax_n_tpu_torch.quant.kv_cache import (
    cached_attention_quantized,
    init_quantized_kv_cache,
    quantize_kv,
    update_quantized_cache,
)
from flash_attention_softmax_n_tpu_torch.quant.qtensor import (
    QTensor,
    dequantize,
    pack_int4,
    quantize,
    unpack_int4,
)
from flash_attention_softmax_n_tpu_torch.quant.weights import (
    fuse_decoder_projections,
    quantize_bert_weights,
    quantize_decoder_weights,
)

__all__ = ["QTensor", "dequantize", "quantize", "pack_int4", "unpack_int4",
           "fuse_decoder_projections", "quantize_decoder_weights",
           "quantize_bert_weights", "KURTOSIS_THRESHOLDS", "outlier_gate",
           "gate_report",
           "init_quantized_kv_cache", "quantize_kv", "update_quantized_cache",
           "cached_attention_quantized"]
