"""byteps_tpu_torch stands alone: importing every one of its modules in a
fresh interpreter loads no JAX and nothing of byteps_tpu."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import byteps_tpu_torch
mods = ["byteps_tpu_torch"]
for m in pkgutil.walk_packages(byteps_tpu_torch.__path__, "byteps_tpu_torch."):
    importlib.import_module(m.name)
    mods.append(m.name)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax")
             or n == "byteps_tpu" or n.startswith("byteps_tpu."))
print(json.dumps({"imported": mods, "bad": bad}))
"""


def test_port_imports_no_jax_and_nothing_of_byteps_tpu():
    import json

    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["bad"] == [], got["bad"]
    for mod in ("byteps_tpu_torch.ops.flash_attention", "byteps_tpu_torch.ps",
                "byteps_tpu_torch.training", "byteps_tpu_torch.overlap",
                "byteps_tpu_torch.bucketed", "byteps_tpu_torch.core.ffi",
                "byteps_tpu_torch.server.__main__",
                "byteps_tpu_torch.models.transformer",
                "byteps_tpu_torch.models.llama",
                "byteps_tpu_torch.models.resnet", "byteps_tpu_torch.models.vgg",
                "byteps_tpu_torch.models.mlp", "byteps_tpu_torch.stateful",
                "byteps_tpu_torch.parallel.hierarchical",
                "byteps_tpu_torch.parallel.mesh",
                "byteps_tpu_torch.parallel.ulysses",
                "byteps_tpu_torch.parallel.ring_attention",
                "byteps_tpu_torch.parallel._collectives",
                "byteps_tpu_torch.compression",
                "byteps_tpu_torch.monitor.http",
                "byteps_tpu_torch.monitor.timeline",
                "byteps_tpu_torch.monitor.insight",
                "byteps_tpu_torch.monitor.incident",
                "byteps_tpu_torch.monitor.top", "byteps_tpu_torch.client",
                "byteps_tpu_torch.launcher.launch",
                "byteps_tpu_torch.launcher.__main__",
                "byteps_tpu_torch.utils.checkpoint",
                "byteps_tpu_torch.utils.timeline",
                "byteps_tpu_torch.callbacks"):
        assert mod in got["imported"], mod
