"""The port's launcher (``byteps_tpu_torch.launcher``, a copy of
``byteps_tpu.launcher``) against the JAX package's, case for case, as
``tests/test_launcher.py`` drives the latter: the worker spawn's
environment, a failing worker's exit code taking its siblings down, the
argument errors, the checkpoint flags, and ``--local`` bringing up the
port's own server roles and re-running a failed fleet (``--restarts``).
The fast cases run ``main`` in-process with ``python -c`` workers or a
stand-in for ``subprocess.Popen``.

The ``ps`` fleet test runs ``chip_smoke.py`` phase 8's scenario on the
CPU at a tiny width: two workers of a launched fleet, rank 0 ends its
process after checkpointing step 2, the launcher restarts the fleet and
the second life resumes; the final parameters and AdamW moments must
equal an uninterrupted fleet's to the bit. Its worker is this file run
as a script (``--worker DIR``).
"""

import hashlib
import json
import os
import subprocess
import sys
import time

import pytest

import byteps_tpu.launcher.launch as jlaunch
import byteps_tpu_torch.launcher.launch as launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCHERS = pytest.mark.parametrize("mod", [launch, jlaunch],
                                    ids=["port", "jax"])


@pytest.fixture(autouse=True)
def _worker_env(monkeypatch):
    monkeypatch.setenv("DMLC_ROLE", "worker")
    monkeypatch.delenv("BYTEPS_LOCAL_SIZE", raising=False)
    # main() writes these into os.environ: restored after each test
    for key in ("BYTEPS_CKPT_DIR", "BYTEPS_CKPT_EVERY", "BYTEPS_CKPT_RESTORE"):
        monkeypatch.delenv(key, raising=False)


def _py(code):
    return [sys.executable, "-S", "-c", code]


@LAUNCHERS
def test_worker_spawn_sets_local_rank_env(mod):
    code = ("import os; "
            "assert os.environ['BYTEPS_LOCAL_RANK'] in ('0', '1'); "
            "assert os.environ['BYTEPS_LOCAL_SIZE'] == '2'; "
            "assert os.environ['DMLC_ROLE'] == 'worker'")
    assert mod.main(["--workers-per-host", "2", "--", *_py(code)]) == 0


@LAUNCHERS
def test_worker_failure_propagates_exit_code(mod):
    assert mod.main(["--", *_py("raise SystemExit(3)")]) == 3


@LAUNCHERS
def test_failed_worker_takes_down_siblings(mod):
    # one worker fails at once, the other would sleep for an hour: the
    # launcher must end it and return the failure's code
    code = ("import os, time; "
            "rank = int(os.environ['BYTEPS_LOCAL_RANK']); "
            "time.sleep(3600) if rank else (_ for _ in ()).throw("
            "SystemExit(7))")
    assert mod.main(["--workers-per-host", "2", "--", *_py(code)]) == 7


@LAUNCHERS
def test_missing_command_errors(mod):
    with pytest.raises(SystemExit) as e:
        mod.main([])
    assert e.value.code != 0


@LAUNCHERS
def test_restore_flag_requires_ckpt_dir(mod, capsys):
    with pytest.raises(SystemExit) as e:
        mod.main(["--restore", "--", *_py("pass")])
    assert e.value.code != 0
    assert "requires --ckpt-dir" in capsys.readouterr().err


@LAUNCHERS
def test_ckpt_flags_project_env(mod):
    code = ("import os; "
            "assert os.environ['BYTEPS_CKPT_DIR'] == '/tmp/bps_spool'; "
            "assert os.environ['BYTEPS_CKPT_EVERY'] == '3'")
    assert mod.main(["--ckpt-dir", "/tmp/bps_spool", "--ckpt-every", "3",
                     "--", *_py(code)]) == 0


class _Proc:
    """Stands in for a child process: records its command and
    environment and exits with ``code`` at once."""

    pid = 1

    def __init__(self, cmd, env, code):
        self.cmd, self.env, self.returncode = list(cmd), env, code

    def poll(self):
        return self.returncode

    def wait(self, timeout=None):
        return self.returncode

    def terminate(self):
        pass

    kill = terminate


@LAUNCHERS
def test_local_fleet_roles_and_restarts(mod, monkeypatch, capsys):
    """``--local 2``: the scheduler and the server run the package's own
    server module, the workers the user command as ranks 0 and 1 of
    hosts of one process; a failed fleet is launched once more."""
    spawned = []

    def popen(cmd, env=None, **kw):
        # the first fleet's worker 1 fails; everything else exits 0
        fails = (env["DMLC_ROLE"] == "worker"
                 and env["DMLC_WORKER_ID"] == "1"
                 and not any(p.returncode for p in spawned))
        spawned.append(_Proc(cmd, env, 5 if fails else 0))
        return spawned[-1]

    monkeypatch.setattr(mod.subprocess, "Popen", popen)
    monkeypatch.setattr(time, "sleep", lambda s: None)
    assert mod.main(["--local", "2", "--num-servers", "1", "--restarts",
                     "1", "--restart-backoff", "0", "--", "train"]) == 0
    assert "restart 1/1" in capsys.readouterr().err
    package = mod.__name__.split(".")[0]
    roles = [(p.env["DMLC_ROLE"], p.cmd) for p in spawned]
    fleet = [("scheduler", [sys.executable, "-m", f"{package}.server"]),
             ("server", [sys.executable, "-m", f"{package}.server"]),
             ("worker", ["train"]), ("worker", ["train"])]
    assert roles == fleet * 2
    for p in spawned[2:4]:
        assert p.env["BYTEPS_LOCAL_RANK"] == "0"
        assert p.env["DMLC_NUM_WORKER"] == "2"
    assert [p.env["DMLC_WORKER_ID"] for p in spawned[2:4]] == ["0", "1"]


# --- a launched fleet, preempted and resumed ---------------------------------

STEPS, PREEMPT_AFTER = 4, 2


def _worker(out_dir, preempt_after):
    """One worker: a tiny LM on its rows of a seeded batch,
    DistributedOptimizer(AdamW) through the servers, rank 0 checkpoints
    after every step, resume from the newest checkpoint; writes the
    losses and the sha256 of the final parameters and moments."""
    import numpy as np
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.callbacks import (BroadcastGlobalVariablesCallback,
                                            CallbackList)
    from byteps_tpu_torch.models.transformer import TransformerLM, lm_loss
    from byteps_tpu_torch.utils import restore_checkpoint, save_checkpoint

    torch.set_num_threads(1)
    bps.init(device="cpu")
    rank = bps.rank()
    model = TransformerLM(vocab_size=64, num_layers=2, d_model=32,
                          num_heads=4, mlp_dim=64, max_len=16,
                          dtype=torch.float32, attn_impl="flash",
                          device="cpu",
                          generator=torch.Generator().manual_seed(0))
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)
    ckpt = os.path.join(out_dir, "ckpt")
    state, start = restore_checkpoint(
        ckpt, {"model": model.state_dict(), "optimizer": opt.state_dict()})
    if start is not None:
        model.load_state_dict(state["model"])
        opt.load_state_dict(state["optimizer"])
    start = start or 0
    dopt = bps.DistributedOptimizer(opt)
    CallbackList([BroadcastGlobalVariablesCallback(0)]).on_train_begin(
        {"model": model, "optimizer": dopt})
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, 64, size=(4, 16)))[2 * rank:2 * rank + 2]
    losses = {}
    for step in range(start + 1, STEPS + 1):
        dopt.zero_grad()
        loss = lm_loss(model(tokens), tokens)
        loss.backward()
        dopt.step()
        losses[step] = loss.item()
        save_checkpoint(ckpt, {"model": model.state_dict(),
                               "optimizer": opt.state_dict()}, step, keep=2)
        if rank == 0 and step == preempt_after:
            os._exit(3)
    h = hashlib.sha256()
    for t in [*model.state_dict().values(),
              *[v for _, s in sorted(opt.state_dict()["state"].items())
                for _, v in sorted(s.items())]]:
        h.update(t.numpy().tobytes())
    bps.shutdown()
    with open(os.path.join(out_dir, f"rank{rank}_from{start}.json"),
              "w") as f:
        json.dump({"losses": losses, "sha256": h.hexdigest()}, f)


def _fleet(out_dir, *extra):
    env = dict(os.environ)
    env.update({"PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", ""),
                "PS_HEARTBEAT_INTERVAL": "1", "PS_HEARTBEAT_TIMEOUT": "4",
                "BYTEPS_PS_MODE": "ps"})
    env.pop("DMLC_ROLE")
    out = subprocess.run(
        [sys.executable, "-m", "byteps_tpu_torch.launcher", "--local", "2",
         "--num-servers", "1", "--restarts", "1", "--", sys.executable,
         os.path.abspath(__file__), "--worker", out_dir, *extra],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, (out.stdout, out.stderr[-4000:])
    recs = {}
    for name in os.listdir(out_dir):
        if name.endswith(".json"):
            with open(os.path.join(out_dir, name)) as f:
                recs[name[:-5]] = json.load(f)
    return out.stderr, recs


@pytest.mark.ps
def test_preempted_fleet_resumes_bit_for_bit(tmp_path):
    from byteps_tpu_torch.core import build
    build.build(verbose=False)  # once, before four processes load it
    (tmp_path / "U").mkdir()
    (tmp_path / "P").mkdir()
    log_u, u = _fleet(str(tmp_path / "U"))
    log_p, p = _fleet(str(tmp_path / "P"), "--preempt-after",
                      str(PREEMPT_AFTER))
    assert "restart" not in log_u and "restart 1/1" in log_p, log_p
    assert sorted(u) == ["rank0_from0", "rank1_from0"]
    assert sorted(p) == ["rank0_from2", "rank1_from2"]
    for r in range(2):
        whole, resumed = u[f"rank{r}_from0"], p[f"rank{r}_from2"]
        assert resumed["sha256"] == whole["sha256"]
        assert resumed["losses"] == {k: v for k, v in whole["losses"].items()
                                     if int(k) > PREEMPT_AFTER}
    assert u["rank0_from0"]["sha256"] == u["rank1_from0"]["sha256"]


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _, flag, directory, *rest = sys.argv
    assert flag == "--worker", sys.argv
    _worker(directory, int(rest[1]) if rest else 0)
