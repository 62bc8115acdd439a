from legion_tpu_torch.utils.checkpoint import (latest_step,
                                               restore_checkpoint,
                                               save_checkpoint)
from legion_tpu_torch.utils.metrics import StepMetrics

__all__ = ["StepMetrics", "save_checkpoint", "restore_checkpoint",
           "latest_step"]
