from legion_tpu_torch.data.device_synthetic import (DeviceDataset,
                                                    synthesize_device_dataset)
from legion_tpu_torch.data.format import (LegionDataset, infer_meta,
                                          write_legion_dataset)
from legion_tpu_torch.data.homophilous import homophilous_dataset
from legion_tpu_torch.data.synthetic import synthesize_dataset

__all__ = ["DeviceDataset", "synthesize_device_dataset", "LegionDataset",
           "infer_meta", "write_legion_dataset", "synthesize_dataset",
           "homophilous_dataset"]
