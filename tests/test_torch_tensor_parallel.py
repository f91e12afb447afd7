"""The port's tensor parallelism and differentiable psum against the JAX
package's.

One gloo world of 4 spawned processes (``_torch_par_worker.par_worker``,
once per session) runs the port on inputs made from numpy seeds; the JAX
side runs here under ``shard_map`` on 4 of the 8 CPU devices, on the same
inputs. Carried over from ``tests/test_tensor_parallel.py`` at its
tolerances: ``tp_mlp`` and ``tp_attention`` against the dense computation
(rtol 2e-5, atol 2e-5), here also against the JAX per-device results and
with the port's ``flash_attention`` (its plain version on the CPU) as
``attn_fn``; the gradients (2e-4 / 2e-5) of the shards against
``jax.grad`` under ``shard_map`` and, gathered, against the dense
gradient, and the input's gradient, which a psum whose backward were the
identity (Megatron's "g") would get wrong by the group's size.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from byteps_tpu.jax._compat import shard_map as _shard_map
from byteps_tpu.parallel.ring_attention import full_attention
from byteps_tpu.parallel.tensor_parallel import (shard_columns, shard_rows,
                                                 tp_attention, tp_mlp)

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


def _mesh():
    return Mesh(np.asarray(jax.devices()[:WORLD]), ("tp",))


@pytest.mark.parametrize("op", ["psum", "pmean"])
def test_psum_backward_is_psum(par, op):
    """d/dx_r of sum(psum(x) * w_r) is psum(w) on every rank, as
    jax.grad under shard_map(check_vma=False) gives; pmean's is that over
    the group's size."""
    inp, ranks = par
    c = inp["psum"]
    reduce = getattr(jax.lax, op)

    @partial(_shard_map, mesh=_mesh(), in_specs=(P("tp"), P("tp")),
             out_specs=P("tp"), check_vma=False)
    def grads(x, w):
        return jax.grad(lambda x_: jnp.sum(reduce(x_, "tp") * w))(x)

    want = np.asarray(grads(jnp.asarray(c["x"]), jnp.asarray(c["w"])))
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res[f"{op}_grad"], want[r], rtol=1e-6,
                                   atol=1e-6)
    total = c["w"].sum(0) / (WORLD if op == "pmean" else 1)
    np.testing.assert_allclose(ranks[0][f"{op}_grad"], total, rtol=1e-5,
                               atol=1e-6)


def test_tp_mlp_matches_dense(par):
    inp, ranks = par
    c = {k: jnp.asarray(v) for k, v in inp["tp_mlp"].items()}
    ref = (jax.nn.gelu(c["x"] @ c["w_in"] + c["b_in"]) @ c["w_out"]
           + c["b_out"])

    @partial(_shard_map, mesh=_mesh(), in_specs=(P(),) * 5, out_specs=P(),
             check_vma=False)
    def run(x_, w_in_, b_in_, w_out_, b_out_):
        return tp_mlp(x_, shard_columns(w_in_), shard_rows(w_out_),
                      b_in_shard=shard_columns(b_in_), b_out=b_out_)

    got = run(c["x"], c["w_in"], c["b_in"], c["w_out"], c["b_out"])
    for res in ranks:
        for want in (ref, got):
            np.testing.assert_allclose(res["tp_mlp"], np.asarray(want),
                                       rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("attn", ["full", "flash"])
def test_tp_attention_matches_dense(par, attn):
    inp, ranks = par
    c = {k: jnp.asarray(v) for k, v in inp["tp_attn"].items()}
    b, s, d = c["x"].shape
    heads = 8
    q, k, v = ((c["x"] @ c[w]).reshape(b, s, heads, d // heads)
               for w in ("wq", "wk", "wv"))
    ref = full_attention(q, k, v, causal=True).reshape(b, s, d) @ c["wo"]

    @partial(_shard_map, mesh=_mesh(), in_specs=(P(),) * 5, out_specs=P(),
             check_vma=False)
    def run(x_, wq_, wk_, wv_, wo_):
        return tp_attention(x_, shard_columns(wq_), shard_columns(wk_),
                            shard_columns(wv_), shard_rows(wo_),
                            num_local_heads=heads // WORLD, causal=True)

    got = run(c["x"], c["wq"], c["wk"], c["wv"], c["wo"])
    for res in ranks:
        for want in (ref, got):
            np.testing.assert_allclose(res[f"tp_attn_{attn}"],
                                       np.asarray(want), rtol=2e-5,
                                       atol=2e-5)


def test_tp_gradients_match_jax(par):
    """Each rank's shard gradients and input gradient against jax.grad of
    the same per-device function (the replicated loss divided by the
    axis size), and the gathered shards against the dense gradient."""
    inp, ranks = par
    c = {k: jnp.asarray(v) for k, v in inp["tp_grad"].items()}

    @partial(_shard_map, mesh=_mesh(), in_specs=(P(),) * 3,
             out_specs=(P("tp"),) * 3, check_vma=False)
    def tp_grads(x_, w_in_, w_out_):
        gs = jax.grad(lambda a, b_, xx: jnp.sum(tp_mlp(xx, a, b_) ** 2)
                      / WORLD, argnums=(0, 1, 2))(
            shard_columns(w_in_), shard_rows(w_out_), x_)
        return tuple(g[None] for g in gs)

    want = [np.asarray(g) for g in tp_grads(c["x"], c["w_in"], c["w_out"])]
    for r, res in enumerate(ranks):
        for got, w in zip(res["tp_grads"], want):
            np.testing.assert_allclose(got, w[r], rtol=2e-4, atol=2e-5)

    g_ref = jax.grad(lambda a, b_: jnp.sum(
        (jax.nn.gelu(c["x"] @ a) @ b_) ** 2), argnums=(0, 1))(
        c["w_in"], c["w_out"])
    gin = np.concatenate([res["tp_grads"][0] for res in ranks], axis=1)
    gout = np.concatenate([res["tp_grads"][1] for res in ranks], axis=0)
    np.testing.assert_allclose(gin, np.asarray(g_ref[0]), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(gout, np.asarray(g_ref[1]), rtol=2e-4,
                               atol=2e-5)
    # the input's gradient, summed over the group, is the dense one
    gx = jax.grad(lambda xx: jnp.sum(
        (jax.nn.gelu(xx @ c["w_in"]) @ c["w_out"]) ** 2))(c["x"])
    np.testing.assert_allclose(sum(res["tp_grads"][2] for res in ranks),
                               np.asarray(gx), rtol=2e-4, atol=2e-5)
