"""Process-group parallelism: the mesh, the hierarchical data-parallel
reduction (exact and int8-quantized), sequence parallelism (ring
attention and Ulysses), tensor parallelism, pipeline parallelism (GPipe
and 1F1B), expert parallelism (the MoE FFN) and ZeRO-sharded optimizer
state. Counterpart of ``byteps_tpu.parallel``: each JAX mesh axis is a
process group here, and each function is per-process code over it."""

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
from byteps_tpu_torch.parallel.moe import (  # noqa: F401
    moe_dispatch,
    moe_dispatch_top2,
    moe_ffn,
)
from byteps_tpu_torch.parallel.pipeline import (  # noqa: F401
    gpipe,
    pipeline_1f1b,
    stage_params,
)
from byteps_tpu_torch.parallel.zero import (  # noqa: F401
    make_zero_train_step,
    zero_apply,
    zero_init,
    zero_init_sharded,
)
from byteps_tpu_torch.parallel.tensor_parallel import (  # noqa: F401
    column_parallel,
    row_parallel,
    shard_columns,
    shard_rows,
    tp_attention,
    tp_mlp,
)
