"""Parallelism: the ring of ranks that ring attention runs over (in one
process, or across processes), the gang (dist.py) and the model-parallel
mesh over it (mesh.py)."""
from univtg_tpu_torch.parallel.ring import (  # noqa: F401
    ProcessRing,
    RingGroup,
    active_ring,
    use_ring,
)
