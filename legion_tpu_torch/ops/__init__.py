from legion_tpu_torch.ops.segment import gather_rows, masked_segment_sum

__all__ = ["gather_rows", "masked_segment_sum"]
