"""Profiling helpers (``profiling``) and the prefill-phase profile
(``python -m flash_attention_softmax_n_tpu_torch.utils.profile_prefill_phases``)."""
