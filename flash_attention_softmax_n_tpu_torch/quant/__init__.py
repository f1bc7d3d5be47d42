from flash_attention_softmax_n_tpu_torch.quant.kv_cache import (
    init_quantized_kv_cache,
    quantize_kv,
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
    quantize_decoder_weights,
)

__all__ = ["QTensor", "dequantize", "quantize", "pack_int4", "unpack_int4",
           "fuse_decoder_projections", "quantize_decoder_weights",
           "init_quantized_kv_cache", "quantize_kv"]
