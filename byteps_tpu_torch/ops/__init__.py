"""Hand-written Hopper kernels for the hot ops (``csrc/*.cu``), each with
its plain PyTorch version beside it."""

from byteps_tpu_torch.ops.flash_attention import flash_attention  # noqa: F401
