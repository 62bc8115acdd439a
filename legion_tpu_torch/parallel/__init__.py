from legion_tpu_torch.parallel.mesh import (DP_AXES, Mesh, dp_axes, dp_size,
                                            make_mesh)

__all__ = ["make_mesh", "Mesh", "DP_AXES", "dp_axes", "dp_size"]
