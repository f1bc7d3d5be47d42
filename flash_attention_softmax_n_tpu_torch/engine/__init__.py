from flash_attention_softmax_n_tpu_torch.engine.engine import InferenceEngine, Request

__all__ = ["InferenceEngine", "Request"]
