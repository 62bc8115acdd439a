"""legion_tpu_torch — the PyTorch/CUDA port of ``legion_tpu``.

The same mini-batch GNN trainer, in PyTorch, for one NVIDIA Hopper card.
The module layout mirrors ``legion_tpu`` so that each module's counterpart
is easy to find. This package imports ``torch`` and never ``jax``, neither
directly nor through ``legion_tpu`` (whose ``__init__`` imports jax).

Hand-written CUDA kernels live in ``csrc/`` and are built with nvcc into
``_build/`` on first use (``ops/kernels.py``). Every kernel wrapper runs
its plain PyTorch version for CPU tensors only; for CUDA tensors it
launches the kernel or raises.
"""

from legion_tpu_torch.config import (
    CacheConfig,
    DatasetMeta,
    LegionConfig,
    MeshConfig,
    SamplerConfig,
    TrainConfig,
)
from legion_tpu_torch.graph import DeviceCSR

__all__ = [
    "DatasetMeta",
    "SamplerConfig",
    "CacheConfig",
    "TrainConfig",
    "MeshConfig",
    "LegionConfig",
    "DeviceCSR",
]
