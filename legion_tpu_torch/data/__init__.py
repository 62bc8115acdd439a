from legion_tpu_torch.data.device_synthetic import (DeviceDataset,
                                                    synthesize_device_dataset)

__all__ = ["DeviceDataset", "synthesize_device_dataset"]
