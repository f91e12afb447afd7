"""Data-parallel reduction over ``torch.distributed`` process groups and
the reference attention. Counterpart of ``byteps_tpu.parallel`` (the
hierarchical all-reduce and ``full_attention``; the rest is not ported
yet)."""

from byteps_tpu_torch.parallel.hierarchical import (  # noqa: F401
    hierarchical_all_reduce,
    hierarchical_broadcast,
    tree_all_reduce,
    tree_broadcast,
)
from byteps_tpu_torch.parallel.ring_attention import (  # noqa: F401
    full_attention,
)
