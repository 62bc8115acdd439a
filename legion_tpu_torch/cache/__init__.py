from legion_tpu_torch.cache.cost_model import CostModelResult, plan_cache
from legion_tpu_torch.cache.hotness import presample_hotness
from legion_tpu_torch.cache.unified_cache import (CachedFeatureSource,
                                                  DeviceFeatureSource,
                                                  UnifiedCache)

__all__ = ["presample_hotness", "CostModelResult", "plan_cache",
           "DeviceFeatureSource", "CachedFeatureSource", "UnifiedCache"]
