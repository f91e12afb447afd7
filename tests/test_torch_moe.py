"""The port's MoE FFN and expert parallelism against the JAX package's.

The dense layer runs here, on numpy inputs from seeds, beside the JAX
``moe_ffn``; the expert-parallel cases run in one gloo world of 4
spawned processes (``_torch_par_worker.par_worker``, once per session),
the JAX side under ``shard_map`` on 4 of the 8 CPU devices on the same
4-way split. Carried over from ``tests/test_moe_vgg.py`` at its
tolerances: dense against the float64 per-token reference (rtol 1e-4,
atol 1e-5), EP against it, the capacity drop, top-2 against the dense
renormalised mixture and top-2 EP against the unsharded layer (2e-4 /
2e-5). Added: EP at capacity factor 1.25 with tokens dropped, against
JAX's EP (the same drops on every rank), its gradients against
``jax.grad`` under ``shard_map`` (2e-4 / 2e-5), and top-2's tie order.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from byteps_tpu.jax._compat import shard_map as _shard_map
from byteps_tpu.parallel.moe import moe_dispatch as jax_dispatch
from byteps_tpu.parallel.moe import moe_dispatch_top2 as jax_dispatch_top2
from byteps_tpu.parallel.moe import moe_ffn as jax_moe_ffn
from byteps_tpu_torch.parallel import (moe_dispatch, moe_dispatch_top2,
                                       moe_ffn)

from _torch_par_worker import par_inputs, par_worker
from _torch_sp_worker import WORLD, run_once


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def par(tmp_path_factory):
    return run_once(tmp_path_factory, "par", par_inputs, par_worker)


def _weights(rng, d=8, e=4, h=16, gate=0.3):
    return (rng.standard_normal((d, e)).astype(np.float32) * gate,
            rng.standard_normal((e, d, h)).astype(np.float32) * 0.3,
            rng.standard_normal((e, h, d)).astype(np.float32) * 0.3)


def _reference_moe(x, gw, w1, w2):
    """Per-token direct computation in float64 (no capacity drops)."""
    x = np.asarray(x, np.float64)
    gates = np.asarray(jax.nn.softmax(x @ gw, axis=-1), np.float64)
    eidx = gates.argmax(-1)
    out = np.zeros_like(x)
    for t in range(x.shape[0]):
        e = int(eidx[t])
        h = np.asarray(jax.nn.gelu(jnp.asarray(x[t] @ w1[e])), np.float64)
        out[t] = gates[t, e] * (h @ w2[e])
    return out


def _port(x, gw, w1, w2, **kw):
    y, aux = moe_ffn(*(torch.as_tensor(a) for a in (x, gw, w1, w2)), **kw)
    return y.numpy(), aux.item()


def _ep_mesh():
    return Mesh(np.asarray(jax.devices()[:WORLD]), ("ep",))


def _jax_ep(x, gw, w1, w2, **kw):
    @partial(_shard_map, mesh=_ep_mesh(), in_specs=(P("ep"), P(), P(), P()),
             out_specs=(P("ep"), P()), check_vma=False)
    def run(xl, gw_, w1_, w2_):
        return jax_moe_ffn(xl, gw_, w1_, w2_, ep_axis="ep", **kw)
    y, aux = run(*(jnp.asarray(a) for a in (x, gw, w1, w2)))
    return np.asarray(y), float(aux)


def test_moe_dense_matches_reference():
    rng = np.random.default_rng(0)
    gw, w1, w2 = _weights(rng)
    x = rng.standard_normal((16, 8)).astype(np.float32)
    # capacity factor big enough that nothing is dropped
    y, aux = _port(x, gw, w1, w2, capacity_factor=4.0)
    np.testing.assert_allclose(y, _reference_moe(x, gw, w1, w2), rtol=1e-4,
                               atol=1e-5)
    y_j, aux_j = jax_moe_ffn(*(jnp.asarray(a) for a in (x, gw, w1, w2)),
                             capacity_factor=4.0)
    np.testing.assert_allclose(y, np.asarray(y_j), rtol=1e-5, atol=1e-6)
    assert aux > 0
    np.testing.assert_allclose(aux, float(aux_j), rtol=1e-6)


def test_moe_expert_parallel_matches_dense(par):
    """EP over 4 processes == dense: all-to-all routing is exact when no
    tokens are dropped."""
    inp, ranks = par
    c = inp["moe_ep"]
    ref = _reference_moe(c["x"], c["gw"], c["w1"], c["w2"])
    y_j, _ = _jax_ep(c["x"], c["gw"], c["w1"], c["w2"], capacity_factor=8.0)
    got = np.concatenate([res["moe_ep"][0] for res in ranks])
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, y_j, rtol=1e-5, atol=1e-6)


def test_moe_capacity_drops_tokens():
    """Tiny capacity: overflow tokens contribute zero output, no crash;
    the same tokens as JAX's."""
    rng = np.random.default_rng(1)
    gw, w1, w2 = _weights(rng)
    x = rng.standard_normal((64, 8)).astype(np.float32)
    y, _ = _port(x, gw, w1, w2, capacity_factor=0.1)
    zeros = np.abs(y).sum(-1) == 0
    assert zeros.sum() > 0
    assert np.isfinite(y).all()
    y_j, _ = jax_moe_ffn(*(jnp.asarray(a) for a in (x, gw, w1, w2)),
                         capacity_factor=0.1)
    np.testing.assert_array_equal(zeros, np.abs(np.asarray(y_j)).sum(-1) == 0)
    np.testing.assert_allclose(y, np.asarray(y_j), rtol=1e-5, atol=1e-6)


def test_moe_top2_matches_dense_weighted_sum():
    """Top-2 gating with ample capacity equals the renormalised
    two-expert mixture (no drops)."""
    rng = np.random.default_rng(2)
    t, d, h, e = 24, 8, 16, 4
    gw, w1, w2 = _weights(rng, d, e, h, gate=0.5)
    x = rng.standard_normal((t, d)).astype(np.float32)
    out, aux = _port(x, gw, w1, w2, capacity_factor=2 * e, top_k=2)

    gates = np.asarray(jax.nn.softmax(x @ gw, axis=-1))
    order = np.argsort(-gates, axis=-1)
    expect = np.zeros((t, d), np.float32)
    for i in range(t):
        e1, e2 = order[i, 0], order[i, 1]
        z = gates[i, e1] + gates[i, e2]
        for ee in (e1, e2):
            hdn = np.asarray(jax.nn.gelu(x[i] @ w1[ee]))
            expect[i] += gates[i, ee] / z * (hdn @ w2[ee])
    np.testing.assert_allclose(out, expect, rtol=2e-4, atol=2e-5)
    assert np.isfinite(aux)
    y_j, aux_j = jax_moe_ffn(*(jnp.asarray(a) for a in (x, gw, w1, w2)),
                             capacity_factor=2 * e, top_k=2)
    np.testing.assert_allclose(out, np.asarray(y_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(aux, float(aux_j), rtol=1e-6)


def test_moe_top2_expert_parallel_matches_unsharded(par):
    inp, ranks = par
    c = inp["moe_top2"]
    e = c["gw"].shape[1]
    y_ref, _ = jax_moe_ffn(*(jnp.asarray(c[k]) for k in
                             ("x", "gw", "w1", "w2")),
                           capacity_factor=2 * e, top_k=2)
    got = np.concatenate([res["moe_top2_ep"][0] for res in ranks])
    np.testing.assert_allclose(got, np.asarray(y_ref), rtol=2e-4,
                               atol=2e-5)


def test_moe_top2_ties_go_to_the_lower_index():
    """lax.top_k's order among equal gates: the lower expert index first
    (torch.topk promises none)."""
    logits = np.zeros((6, 4), np.float32)
    logits[1, [1, 3]] = 1.0
    logits[2, [0, 2]] = 2.0
    logits[3] = [0.5, 1.0, 1.0, 1.0]
    for port_fn, jax_fn in ((moe_dispatch_top2, jax_dispatch_top2),
                            (moe_dispatch, jax_dispatch)):
        got = port_fn(torch.as_tensor(logits), 4)
        want = jax_fn(jnp.asarray(logits), 4)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)


def test_moe_dispatch_capacity_must_be_an_int():
    with pytest.raises(TypeError, match="capacity must be an int"):
        moe_dispatch(torch.zeros(4, 2), torch.zeros(4, 2))


def test_moe_ep_with_drops_matches_jax(par):
    """Capacity factor 1.25 over 4 ranks of 32 tokens (5 slots an expert
    a rank): tokens are dropped, the same as JAX's EP on the same split,
    outputs and the averaged aux loss alike."""
    inp, ranks = par
    c = inp["moe_drop"]
    y_j, aux_j = _jax_ep(c["x"], c["gw"], c["w1"], c["w2"],
                         capacity_factor=1.25)
    got = np.concatenate([res["moe_drop"]["y"] for res in ranks])
    np.testing.assert_allclose(got, y_j, rtol=1e-4, atol=1e-5)
    dropped = []
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["moe_drop"]["aux"], aux_j, rtol=1e-6)
        xl = jnp.asarray(c["x"][32 * r:32 * (r + 1)])
        d_j = jax_dispatch(xl @ jnp.asarray(c["gw"]), int(1.25 * 32 / 8))[0]
        dropped.append(32 - int(np.asarray(d_j).sum()))
        assert res["moe_drop"]["dropped"] == dropped[-1]
    assert sum(dropped) > 0
    assert (np.abs(got).sum(-1) == 0).sum() == sum(dropped)


def test_moe_ep_gradients_match_jax(par):
    """Gradients of sum(y * probe) + aux through both all-to-alls and
    the aux loss's pmean: each rank's against jax.grad of the same
    per-device function."""
    inp, ranks = par
    c = {k: jnp.asarray(v) for k, v in inp["moe_drop"].items()}

    @partial(_shard_map, mesh=_ep_mesh(),
             in_specs=(P("ep"), P("ep"), P(), P(), P()),
             out_specs=(P("ep"),) * 4, check_vma=False)
    def grads(xl, probe, gw, w1, w2):
        def loss(xx, a, b, cc):
            y, aux = jax_moe_ffn(xx, a, b, cc, capacity_factor=1.25,
                                 ep_axis="ep")
            return jnp.sum(y * probe) + aux
        gs = jax.grad(loss, argnums=(0, 1, 2, 3))(xl, gw, w1, w2)
        return gs[0], gs[1][None], gs[2][None], gs[3][None]

    want = [np.asarray(g) for g in grads(c["x"], c["probe"], c["gw"],
                                         c["w1"], c["w2"])]
    for r, res in enumerate(ranks):
        got = res["moe_drop"]["grads"]
        np.testing.assert_allclose(got[0], want[0][32 * r:32 * (r + 1)],
                                   rtol=2e-4, atol=2e-5)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g, w[r], rtol=2e-4, atol=2e-5)
