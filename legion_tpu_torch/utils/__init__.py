from legion_tpu_torch.utils.metrics import StepMetrics

__all__ = ["StepMetrics"]
