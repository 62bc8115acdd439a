from legion_tpu_torch.sampling.sampler import NeighborSampler, SampleBatch

__all__ = ["NeighborSampler", "SampleBatch"]
