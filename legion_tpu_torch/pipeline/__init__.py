from legion_tpu_torch.pipeline.schedule import Mode, Schedule

__all__ = ["Schedule", "Mode"]
