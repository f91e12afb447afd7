"""The PS fleet of a run: a scheduler and the servers as child processes
(``python -m byteps_tpu_torch.server``), this process their worker 0.

Adapted from ``chip_smoke.py``'s ``_fleet``: the ports come from the
port's ``utils.ports.free_port``, the logs go under ``TMPDIR``, and the
children see no card, so that one process uses the chip.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_EXIT_S = 60


@contextlib.contextmanager
def fleet(settings: dict, log=print):
    """Start a scheduler and ``DMLC_NUM_SERVER`` servers with the
    traffic's fleet ``settings`` (environment variables) added to every
    role's environment, and set this process's environment for worker 0.
    On leaving, each child must exit 0 within CHILD_EXIT_S of the worker's
    ``shutdown()``; the environment is restored and no child is left
    running."""
    from byteps_tpu_torch.utils.ports import free_port

    env = dict(os.environ)
    env.update({
        "DMLC_PS_ROOT_URI": "127.0.0.1",
        "DMLC_PS_ROOT_PORT": str(free_port()),
        "BYTEPS_PS_MODE": "ps",
        "PYTHONPATH": ROOT + os.pathsep + env.get("PYTHONPATH", ""),
        **{k: str(v) for k, v in settings.items()},
    })
    roles = ["scheduler"] + ["server"] * int(env["DMLC_NUM_SERVER"])
    logdir = tempfile.mkdtemp(prefix="portbench_fleet_")
    children, saved = [], dict(os.environ)
    try:
        for i, role in enumerate(roles):
            out = open(os.path.join(logdir, f"{role}{i}.log"), "w")
            children.append((role, out, subprocess.Popen(
                [sys.executable, "-m", "byteps_tpu_torch.server"],
                env=dict(env, DMLC_ROLE=role, CUDA_VISIBLE_DEVICES=""),
                cwd=ROOT, stdout=out, stderr=subprocess.STDOUT)))
        os.environ.update(env)
        os.environ.update({"DMLC_ROLE": "worker", "DMLC_WORKER_ID": "0"})
        yield
        for role, _, p in children:
            p.wait(timeout=CHILD_EXIT_S)
            if p.returncode != 0:
                raise RuntimeError(f"the fleet's {role} exited "
                                   f"{p.returncode}")
    finally:
        os.environ.clear()
        os.environ.update(saved)
        for role, out, p in children:
            if p.poll() is None:
                p.kill()
                p.wait()
            out.close()
            if p.returncode != 0:
                with open(out.name) as f:
                    log(f"--- {role} log ---\n{f.read()[-2000:]}")
