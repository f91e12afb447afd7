"""Auxiliary subsystems: checkpoint/resume, trace timeline."""

from byteps_tpu_torch.utils.checkpoint import (  # noqa: F401
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from byteps_tpu_torch.utils.timeline import Timeline  # noqa: F401
