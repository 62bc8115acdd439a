from legion_tpu_torch.ops.segment import (
    masked_segment_sum,
    masked_segment_mean,
    masked_segment_max,
    segment_softmax,
    gather_rows,
)

__all__ = [
    "masked_segment_sum",
    "masked_segment_mean",
    "masked_segment_max",
    "segment_softmax",
    "gather_rows",
]
