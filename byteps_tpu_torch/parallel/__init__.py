"""Process-group parallelism: the mesh, the hierarchical data-parallel
reduction (exact and int8-quantized), and sequence parallelism (ring
attention and Ulysses). Counterpart of ``byteps_tpu.parallel``; tensor,
pipeline and expert parallelism and ZeRO are not ported yet."""

from byteps_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    MeshSpec,
    build_mesh,
    global_mesh,
    set_global_mesh,
)
from byteps_tpu_torch.parallel.hierarchical import (  # noqa: F401
    hierarchical_all_reduce,
    hierarchical_broadcast,
    quantized_all_reduce,
    tree_all_reduce,
    tree_broadcast,
    tree_quantized_all_reduce,
)
from byteps_tpu_torch.parallel.ring_attention import (  # noqa: F401
    full_attention,
    ring_attention,
    ring_attention_sharded,
)
from byteps_tpu_torch.parallel.ulysses import (  # noqa: F401
    ulysses_attention,
    ulysses_attention_sharded,
)
