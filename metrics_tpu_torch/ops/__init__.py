"""Hand-written CUDA kernels for hot metric ops, each beside its plain PyTorch version."""

from metrics_tpu_torch.ops.stat_scores import (
    fused_stat_scores,
    fused_stat_scores_logits,
    fused_stat_scores_logits_plain,
    fused_stat_scores_plain,
    fused_stream_stat_scores,
    fused_stream_stat_scores_logits,
    fused_stream_stat_scores_logits_plain,
    fused_stream_stat_scores_plain,
)

__all__ = [
    "fused_stat_scores",
    "fused_stat_scores_logits",
    "fused_stat_scores_logits_plain",
    "fused_stat_scores_plain",
    "fused_stream_stat_scores",
    "fused_stream_stat_scores_logits",
    "fused_stream_stat_scores_logits_plain",
    "fused_stream_stat_scores_plain",
]
