"""The port's PS bridge (byteps_tpu_torch.ps).

- ``_wire_plan`` and the ``_tids`` wire names must equal the JAX bridge's
  for the same tree, so both name the same server tensors.
- A localhost fleet (scheduler + 2 servers from ``python -m
  byteps_tpu_torch.server``) with 2 port workers: exact sums and means
  against numpy, broadcast, and the PS train step. Run as a script, this
  file is that worker.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import byteps_tpu_torch as bps
from byteps_tpu_torch import ps

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


class _RecordingClient:
    """Stands in for the C core's Worker: records every declare."""

    def __init__(self):
        self.names = []

    def declare(self, name, nelem, dtype, compression=None):
        self.names.append((name, nelem, str(dtype), compression))
        return len(self.names) - 1


@pytest.mark.parametrize("codec", [False, True])
def test_wire_plan_and_names_match_jax_bridge(codec):
    import jax.numpy as jnp

    from byteps_tpu.jax import ps as jps

    shapes = [((3, 5), "float32"), ((7,), "bfloat16"), ((2, 2, 2), "float16"),
              ((1,), "int32")]
    tleaves = [torch.zeros(s, dtype=getattr(torch, d)) for s, d in shapes]
    jleaves = [jnp.zeros(s, getattr(jnp, d)) for s, d in shapes]
    plan = ps._wire_plan(tleaves, codec)
    assert plan == jps._wire_plan(jleaves, codec)

    ps.reset_declare_cache()
    jps.reset_declare_cache()
    mine, theirs = _RecordingClient(), _RecordingClient()
    ps._tids(mine, "grad", tleaves, plan)
    jps._tids(theirs, "grad", jleaves, plan)
    assert mine.names == theirs.names
    # cached: a second call with the same tree declares nothing new
    ps._tids(mine, "grad", tleaves, plan)
    assert len(mine.names) == len(shapes)
    ps.reset_declare_cache()
    jps.reset_declare_cache()


def test_numpy_view_of_bf16_is_16_bit_words():
    h = torch.tensor([1.0, -2.5, 3.0], dtype=torch.bfloat16)
    view = ps._numpy_view(h)
    assert view.dtype == np.int16 and view.shape == (3,)
    view[0] = torch.tensor([7.0], dtype=torch.bfloat16).view(torch.int16)[0]
    assert h[0].item() == 7.0  # a view: the core writes in place


# --- the fleet ---------------------------------------------------------------

def _spawn_role(role, env):
    return subprocess.Popen(
        [sys.executable, "-m", "byteps_tpu_torch.server"],
        env=dict(env, DMLC_ROLE=role), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


@pytest.mark.ps
def test_fleet_two_workers_two_servers():
    from ps_utils import spawn_worker, topology_env

    from byteps_tpu_torch.core import build
    from byteps_tpu_torch.utils.ports import free_port
    build.build(verbose=False)  # once, before four processes load it
    env = topology_env(2, 2, free_port(), {"BYTEPS_PS_MODE": "ps"})
    procs = [("scheduler", _spawn_role("scheduler", env)),
             ("server0", _spawn_role("server", env)),
             ("server1", _spawn_role("server", env))]
    procs += [(f"worker{r}", spawn_worker(os.path.abspath(__file__), env, r,
                                          mode="all"))
              for r in range(2)]
    failed = []
    try:
        for name, p in procs:
            out, _ = p.communicate(timeout=180)
            if p.returncode != 0:
                failed.append(f"--- {name} exited {p.returncode} ---\n{out}")
            elif name.startswith("worker"):
                assert "OK" in out, out
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert not failed, "\n".join(failed)


def _worker_main() -> int:
    from byteps_tpu_torch.models import TransformerLM, lm_loss
    from byteps_tpu_torch.training import make_train_step

    bps.init(device="cpu")
    rank, nw = bps.rank(), bps.size()
    rng = np.random.default_rng(1234)  # the same stream on every worker
    try:
        # exact sums and means against numpy, mixed dtypes and shapes
        bases = [rng.standard_normal((13, 5)), rng.standard_normal(1000),
                 rng.integers(-50, 50, size=(64,))]
        dtypes = [torch.float32, torch.float64, torch.int64]
        tensors = [torch.as_tensor(b * (rank + 1)).to(d)
                   for b, d in zip(bases, dtypes)]
        before = [t.clone() for t in tensors]
        out = bps.push_pull(tensors, average=False, name="sum")
        scale = sum(r + 1 for r in range(nw))
        for o, b, d, t0, t in zip(out, bases, dtypes, before, tensors):
            want = torch.as_tensor(b * scale).to(d)
            assert o.dtype == d
            torch.testing.assert_close(o, want, rtol=1e-6, atol=1e-6)
            torch.testing.assert_close(t, t0)  # inputs untouched
        mean = bps.push_pull({"x": torch.full((50,), float(rank + 1))},
                             average=True, name="mean")
        torch.testing.assert_close(mean["x"],
                                   torch.full((50,), scale / nw))
        # bf16 on the wire (summed by the servers as bfloat16)
        half = bps.push_pull(torch.full((8,), float(rank + 1),
                                        dtype=torch.bfloat16),
                             average=False, name="bf16")
        assert half.dtype == torch.bfloat16
        torch.testing.assert_close(half.float(), torch.full((8,), 3.0))
        # async handle
        h = bps.push_pull_async(torch.full((16,), float(rank)),
                                average=False, name="async")
        torch.testing.assert_close(bps.synchronize(h),
                                   torch.full((16,), 1.0))
        assert bps.poll(h)

        # broadcast: every worker ends with rank 0's weights
        cfg = dict(vocab_size=64, num_layers=1, d_model=32, num_heads=2,
                   mlp_dim=64, max_len=16, dtype=torch.float32,
                   attn_impl="flash", device="cpu")
        model = TransformerLM(
            **cfg, generator=torch.Generator().manual_seed(10 + rank))
        bps.broadcast_parameters(model.state_dict(), root_rank=0)
        ref = TransformerLM(**cfg,
                            generator=torch.Generator().manual_seed(10))
        for (k, a), b in zip(model.state_dict().items(),
                             ref.state_dict().values()):
            torch.testing.assert_close(a, b, msg=k)

        # the PS train step on half batches equals one process on the
        # whole batch (SGD: Adam would turn the rounding noise of the key
        # biases' zero gradient into lr-sized steps)
        tokens = torch.as_tensor(rng.integers(0, 64, size=(4, 12)))
        mine = tokens[rank * 2:(rank + 1) * 2]

        def loss_fn(m, t):
            return lm_loss(m(t), t)

        opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
        step = make_train_step(loss_fn, opt)
        ref_opt = torch.optim.SGD(ref.parameters(), lr=0.1, momentum=0.9)
        for _ in range(3):
            step(model, mine)
            ref_opt.zero_grad()
            loss_fn(ref, tokens).backward()
            ref_opt.step()
        for (k, a), b in zip(model.state_dict().items(),
                             ref.state_dict().values()):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5, msg=k)
        assert ps.declare_steps >= 1
        print(f"worker {rank}: OK")
        return 0
    finally:
        bps.shutdown()


if __name__ == "__main__":
    sys.exit(_worker_main())
