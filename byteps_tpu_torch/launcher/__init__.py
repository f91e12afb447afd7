"""byteps_tpu_torch.launcher — bpslaunch multi-role launcher.

Reference analogue: launcher/launch.py (`bpslaunch` entry point),
SURVEY.md §2.6.
"""

from byteps_tpu_torch.launcher.launch import main  # noqa: F401
