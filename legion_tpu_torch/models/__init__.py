from legion_tpu_torch.models.common import make_model
from legion_tpu_torch.models.graphsage import GraphSAGE

__all__ = ["GraphSAGE", "make_model"]
