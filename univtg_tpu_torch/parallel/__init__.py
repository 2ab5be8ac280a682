"""Context parallelism: the ring of ranks that ring attention runs over."""
from univtg_tpu_torch.parallel.ring import RingGroup, active_ring, use_ring  # noqa: F401
