"""The port's int8 quantized transport against the JAX package's.

One gloo world of 4 spawned processes (``_torch_sp_worker.
quantized_worker``, once per session) runs every case on inputs made here
from numpy seeds; the JAX side runs here on 4 of the 8 CPU devices, on
the same inputs. Carried over from ``tests/test_seq_parallel.py`` and
``tests/test_training.py``, at the reference's tolerances:

- ``quantized_all_reduce`` with both levels (2 x 2, int8 on ici, exact
  or int8 on dcn) and with a quantized dcn level alone: within 0.05 of
  the exact mean, correlated above 0.999, and within 0.05 of the JAX
  function's result (the two quantize the same values; an f32 sum in
  another order may move a value across a rounding boundary, one step);
- all-zero and constant blocks (a 1 x 4 mesh, sum): zeros to 1e-6, the
  constant to 2 %;
- ``push_pull`` dispatches ``Compression.int8`` / ``int8_dcn`` to
  ``tree_quantized_all_reduce``, and ``make_train_step``'s five SGD
  steps equal that reduction applied by hand to the bit (the exact
  transport's steps do not);
- ``int8_dcn`` training converges on a 2 x 2 mesh (the final loss under
  0.15 of the first) as the JAX step does, from the same first loss
  (rtol 1e-5: no update has happened yet), and follows the JAX int8_dcn
  losses step by step: the two quantize the same values, so they stay
  within half the distance the quantiser itself puts between JAX's int8
  and exact losses by that step.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import byteps_tpu.jax as jbps
from byteps_tpu.jax._compat import shard_map as _shard_map
from byteps_tpu.jax.training import make_train_step as jax_make_train_step
from byteps_tpu.jax.training import replicate, shard_batch
from byteps_tpu.parallel.hierarchical import quantized_all_reduce
from byteps_tpu.parallel.mesh import MeshSpec, build_mesh
from byteps_tpu_torch.compression import QUANTIZED, Compression

from _torch_sp_worker import quantized_worker, run_once
from test_training import _make_problem

STEPS = 60


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _problem():
    """The reference test's problem, draws in its order."""
    rng = np.random.default_rng(9)
    init_params, loss_fn, make_batch = _make_problem(rng)
    params = jax.tree_util.tree_map(np.asarray,
                                    init_params(jax.random.PRNGKey(2)))
    return params, loss_fn, [make_batch(32) for _ in range(STEPS)]


def _inputs():
    rng = np.random.default_rng(0)
    params, _, batches = _problem()
    return {"g": rng.standard_normal((4, 123)).astype(np.float32),
            "edges": np.concatenate([np.zeros((4, 64), np.float32),
                                     np.full((4, 64), 3.0, np.float32)],
                                    axis=1),
            "problem_params": params, "problem_batches": batches}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return run_once(tmp_path_factory, "quantized", _inputs,
                    quantized_worker)


def _jax_quantized(x, spec, **kw):
    mesh = build_mesh(spec, devices=jax.devices()[:4])

    @partial(_shard_map, mesh=mesh, in_specs=P(("dcn", "ici")),
             out_specs=P(("dcn", "ici")), check_vma=False)
    def f(v):
        return quantized_all_reduce(v[0], **kw)[None]
    return np.asarray(f(jnp.asarray(x)))


@pytest.mark.parametrize("key,spec,kw", [
    ("close", MeshSpec(dcn=2, ici=2), {}),
    ("close_dcn", MeshSpec(dcn=2, ici=2), {"quantize_dcn": True}),
    ("dcn_only", MeshSpec(dcn=4, ici=1), {"quantize_dcn": True}),
])
def test_quantized_all_reduce_close_to_exact(run, key, spec, kw):
    inp, res = run
    g = inp["g"]
    expect = g.mean(axis=0)
    want = _jax_quantized(g, spec, average=True, **kw)
    for rank, r in enumerate(res):
        np.testing.assert_allclose(r[key], expect, rtol=0.05, atol=0.05)
        np.testing.assert_allclose(r[key], want[rank], rtol=0.05, atol=0.05)
        # every rank holds the same result
        np.testing.assert_array_equal(r[key], res[0][key])
    c = np.corrcoef(res[0][key].ravel(), expect.ravel())[0, 1]
    assert c > 0.999, c


def test_quantized_all_reduce_zero_and_constant(run):
    inp, res = run
    want = _jax_quantized(inp["edges"], MeshSpec(dcn=1, ici=4),
                          average=False)
    for rank, r in enumerate(res):
        np.testing.assert_allclose(r["edges"][:64], np.zeros(64), atol=1e-6)
        np.testing.assert_allclose(r["edges"][64:], np.full(64, 12.0),
                                   rtol=0.02)
        np.testing.assert_allclose(r["edges"], want[rank], rtol=0.02,
                                   atol=1e-6)


@pytest.mark.parametrize("name", QUANTIZED)
def test_push_pull_dispatches_int8_to_the_quantized_transport(run, name):
    for r in run[1]:
        assert r[f"push_pull_{name}"] == [True, True]


def test_int8_compressors_exist():
    assert (Compression.int8.name, Compression.int8_dcn.name) == QUANTIZED
    x = torch.arange(3.0)
    assert Compression.int8.compress(x) is x
    assert Compression.int8_dcn.decompress(x, torch.float64).dtype == \
        torch.float64


@pytest.mark.parametrize("name", QUANTIZED)
def test_make_train_step_dispatches_int8_to_the_quantized_transport(run,
                                                                   name):
    for r in run[1]:
        steps = r[f"step_{name}"]
        assert all(steps["step"]), steps
        assert not all(steps["exact"]), steps


@pytest.fixture(scope="module")
def jax_losses():
    """The JAX step's losses on the problem, a 2 x 2 mesh, with the
    int8_dcn transport and with the exact one."""
    params, loss_fn, batches = _problem()
    mesh = build_mesh(MeshSpec(dcn=2, ici=2), devices=jax.devices()[:4])
    jbps.init(mesh=mesh)
    tx = optax.adam(1e-2)
    out = {}
    for name in ("int8_dcn", "none"):
        step = jax_make_train_step(loss_fn, tx, mesh,
                                   compression=getattr(jbps.Compression,
                                                       name))
        p, o = replicate(params, mesh), replicate(tx.init(params), mesh)
        losses = []
        for b in batches:
            p, o, loss = step(p, o, shard_batch(b, mesh))
            losses.append(float(loss))
        out[name] = np.array(losses)
    return out


def test_int8_dcn_training_converges(run, jax_losses):
    """int8 on both levels of a 2 x 2 mesh: the port's make_train_step and
    the JAX one start from the same loss and both converge."""
    want = jax_losses["int8_dcn"]
    assert want[-1] < want[0] * 0.15, want
    for r in run[1]:
        got = r["int8_dcn_losses"]
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
        assert got[-1] < got[0] * 0.15, got


def test_int8_dcn_losses_follow_jax_step_by_step(run, jax_losses):
    """Step t's loss within 1e-5 relative plus half of the largest
    distance the quantiser put between JAX's int8_dcn and exact losses up
    to step t: the port and JAX quantize the same values and part only
    where an f32 rounding moves a value across a quantization boundary,
    so they must stay closer to each other than int8 stays to exact."""
    want, exact = jax_losses["int8_dcn"], jax_losses["none"]
    quantiser = np.maximum.accumulate(np.abs(want - exact))
    bound = 1e-5 * np.abs(want) + 0.5 * quantiser
    for r in run[1]:
        gap = np.abs(np.array(r["int8_dcn_losses"]) - want)
        assert (gap <= bound).all(), (gap / bound).max()
