from .halo import lateral_diffusion_forcing, neighbor_shift
from .sharding import (cell_mesh, initialize_distributed, replicate,
                       shard_sources, shard_state, state_shardings)
