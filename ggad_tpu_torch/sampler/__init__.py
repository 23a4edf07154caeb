from ggad_tpu_torch.sampler.neighbor import (
    NeighborTable,
    sample_neighbors,
    sample_two_hop,
)

__all__ = ["NeighborTable", "sample_neighbors", "sample_two_hop"]
