from flash_attention_softmax_n_tpu_torch.analysis.evaluate import (
    delta_perplexity,
    perplexity,
    token_nll,
)
from flash_attention_softmax_n_tpu_torch.analysis.hooks import (
    activation_stats_to_dict,
    compute_weight_statistics,
    init_activation_stats,
    register_activation_hooks,
    update_activation_stats,
)
from flash_attention_softmax_n_tpu_torch.analysis.io import load_results, save_results
from flash_attention_softmax_n_tpu_torch.analysis.statistics import (
    attention_entropy,
    central_moment,
    kurtosis,
    kurtosis_batch_mean,
    mean_batch_mean,
    null_attention_mass,
    skewness,
    skewness_batch_mean,
    standardized_moment,
    std,
    summarize_attention,
    variance,
    variance_batch_mean,
)

__all__ = [
    "token_nll",
    "perplexity",
    "delta_perplexity",
    "register_activation_hooks",
    "init_activation_stats",
    "update_activation_stats",
    "activation_stats_to_dict",
    "compute_weight_statistics",
    "save_results",
    "load_results",
    "central_moment",
    "variance",
    "std",
    "standardized_moment",
    "skewness",
    "kurtosis",
    "mean_batch_mean",
    "variance_batch_mean",
    "skewness_batch_mean",
    "kurtosis_batch_mean",
    "null_attention_mass",
    "attention_entropy",
    "summarize_attention",
]
