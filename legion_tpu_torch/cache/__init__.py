from legion_tpu_torch.cache.hotness import presample_hotness
from legion_tpu_torch.cache.unified_cache import DeviceFeatureSource

__all__ = ["presample_hotness", "DeviceFeatureSource"]
