"""The port's pipeline schedules (GPipe, 1F1B) against the JAX package's.

One gloo world of 4 spawned processes (``_torch_par_worker.par_worker``,
once per session) runs the port, one stage a process; the JAX side runs
here under ``shard_map`` on 4 of the 8 CPU devices, on the same inputs.
Carried over from ``tests/test_pipeline.py`` at its tolerances: GPipe's
forward against the sequential stages, also with a single microbatch
(rtol 2e-5, atol 2e-6); GPipe's training gradients, the replicated loss
divided by N and the stage gradients summed over the group (2e-4 /
2e-6); 1F1B's loss (1e-5) and gradients (2e-4 / 1e-6) against the
sequential model at M = 12 microbatches. Here each is also held to the
JAX function's per-device result, 1F1B to the port's own GPipe, and a
GPT-2-config stage (two TransformerLayers a stage, the flash wrapper's
plain version, the embedding outside the pipeline and the tied head in
the loss) to JAX's GPipe over flax layers (loss 1e-5, gradients 2e-4 /
2e-5).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from jax.sharding import Mesh, PartitionSpec as P

from byteps_tpu.jax._compat import shard_map as _shard_map
from byteps_tpu.models.transformer import TransformerLayer
from byteps_tpu.models.transformer import lm_loss as jax_lm_loss
from byteps_tpu.parallel.pipeline import gpipe, pipeline_1f1b, stage_params
from byteps_tpu_torch.models.transformer import port_name

from _torch_par_worker import GPT_CFG, GPT_MB, par_inputs, par_worker
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
    return Mesh(np.asarray(jax.devices()[:WORLD]), ("pp",))


def _stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _stacked(c):
    return {k: jnp.asarray(c[k]) for k in ("w", "b")}


def _sequential(params, xs):
    for i in range(params["w"].shape[0]):
        xs = _stage(jax.tree_util.tree_map(lambda w: w[i], params), xs)
    return xs


def _jax_gpipe(params, mb):
    @partial(_shard_map, mesh=_mesh(), in_specs=(P(), P()), out_specs=P(),
             check_vma=False)
    def run(p, x):
        return gpipe(_stage, stage_params(p), x)
    return np.asarray(run(params, jnp.asarray(mb)))


@pytest.mark.parametrize("case", ["pp_fwd", "pp_one"])
def test_gpipe_forward_matches_sequential(par, case):
    """Several microbatches (pp_fwd: 6) and a single one (pp_one)."""
    inp, ranks = par
    c = inp[case]
    params = _stacked(c)
    ref = np.asarray(_sequential(params, jnp.asarray(c["mb"])))
    want = _jax_gpipe(params, c["mb"])
    for res in ranks:
        for w in (ref, want):
            np.testing.assert_allclose(res[case], w, rtol=2e-5, atol=2e-6)


def test_gpipe_training_matches_sequential(par):
    """Gradients of the stacked stage weights, each rank's summed over the
    group, against the sequential model's and against JAX's GPipe."""
    inp, ranks = par
    c = inp["pp_train"]
    params = _stacked(c)
    mb, tgt = jnp.asarray(c["mb"]), jnp.asarray(c["tgt"])
    g_ref = jax.grad(lambda p: jnp.mean((_sequential(p, mb) - tgt) ** 2))(
        params)

    @partial(_shard_map, mesh=_mesh(), in_specs=(P(), P(), P()),
             out_specs=P(), check_vma=False)
    def grads(p, x, y):
        def loss(p_):
            out = gpipe(_stage, stage_params(p_), x)
            return jnp.mean((out - y) ** 2) / WORLD
        return jax.tree_util.tree_map(lambda a: jax.lax.psum(a, "pp"),
                                      jax.grad(loss)(p))

    g_jax = grads(params, mb, tgt)
    for k in ("w", "b"):
        got = sum(res["pp_train"][k] for res in ranks)
        for want in (g_ref[k], g_jax[k]):
            np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4,
                                       atol=2e-6, err_msg=k)


def test_1f1b_matches_gpipe_gradients(par):
    """1F1B (O(N) stored activations, the stage recomputed in the
    backward tick) at M = 12 >> N = 4: the loss and each stage's
    gradients against the sequential model, JAX's 1F1B and the port's
    GPipe."""
    inp, ranks = par
    c = inp["pp_1f1b"]
    params = _stacked(c)
    mb, tgt = jnp.asarray(c["mb"]), jnp.asarray(c["tgt"])

    def mse(y, t):
        return jnp.mean((y - t) ** 2)

    loss_ref, g_ref = jax.value_and_grad(lambda p: jnp.mean(jnp.stack(
        [mse(_sequential(p, mb[i]), tgt[i]) for i in range(mb.shape[0])])))(
        params)

    @partial(_shard_map, mesh=_mesh(), in_specs=(P(), P(), P()),
             out_specs=(P(), P("pp")), check_vma=False)
    def run_1f1b(p, x, y):
        loss, g = pipeline_1f1b(_stage, mse, stage_params(p), x, y)
        return loss, jax.tree_util.tree_map(lambda a: a[None], g)

    loss_jax, g_jax = run_1f1b(params, mb, tgt)
    for r, res in enumerate(ranks):
        loss, g = res["pp_1f1b"]
        np.testing.assert_allclose(loss, float(loss_ref), rtol=1e-5)
        np.testing.assert_allclose(loss, float(loss_jax), rtol=1e-5)
        for k in ("w", "b"):
            for want in (g_ref[k][r], g_jax[k][r], res["pp_1f1b_gpipe"][k]):
                np.testing.assert_allclose(g[k], np.asarray(want),
                                           rtol=2e-4, atol=1e-6, err_msg=k)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def test_gpt2_config_stages_match_jax_gpipe(par):
    """Two TransformerLayers a stage (flash's plain version on the port's
    side), the embedding outside the pipeline, final LN + tied head +
    lm_loss on the last stage: the port's 1F1B and GPipe losses and
    layer gradients against jax.grad of JAX's GPipe over the flax
    layers."""
    inp, ranks = par
    g = inp["pp_gpt"]
    p = jax.tree_util.tree_map(jnp.asarray, g["params"]["params"])
    tokens = jnp.asarray(g["tokens"], jnp.int32)
    per = GPT_CFG["num_layers"] // WORLD
    seq = tokens.shape[-1]
    mbs = (p["tok_embed"]["embedding"][tokens]
           + p["pos_embed"]["embedding"][jnp.arange(seq)][None, None])
    stacked = {f"l{j}": jax.tree_util.tree_map(
        lambda *ls: jnp.stack(ls),
        *[p[f"layer_{i * per + j}"] for i in range(WORLD)])
        for j in range(per)}
    layer = TransformerLayer(GPT_CFG["num_heads"], GPT_CFG["mlp_dim"],
                             jnp.float32, causal=True)
    final_ln = nn.LayerNorm(dtype=jnp.float32)

    def stage(sp, x):
        for j in range(per):
            x = layer.apply({"params": sp[f"l{j}"]}, x)
        return x

    def head_loss(y, t):
        h = final_ln.apply({"params": p["final_ln"]}, y)
        return jax_lm_loss(h @ p["tok_embed"]["embedding"].T, t)

    @partial(_shard_map, mesh=_mesh(), in_specs=(P(), P(), P()),
             out_specs=(P(), P()), check_vma=False)
    def grads(sp, x, t):
        def loss(sp_):
            out = gpipe(stage, stage_params(sp_), x)
            return jnp.mean(jnp.stack([head_loss(out[i], t[i])
                                       for i in range(GPT_MB)]))
        val, gs = jax.value_and_grad(lambda s_: loss(s_) / WORLD)(sp)
        return val * WORLD, jax.tree_util.tree_map(
            lambda a: jax.lax.psum(a, "pp"), gs)

    loss_jax, g_jax = grads(stacked, mbs, tokens)
    want = {}
    for j in range(per):
        for i in range(WORLD):
            for k, v in _flat(g_jax[f"l{j}"]).items():
                want[port_name(f"layer_{i * per + j}/{k}")] = np.asarray(v[i])
    for res in ranks:
        for name in ("gpt_1f1b", "gpt_gpipe"):
            loss, gs = res[name]
            np.testing.assert_allclose(loss, float(loss_jax), rtol=1e-5)
            assert len(gs) == len(res["gpt_names"])
            for k, v in zip(res["gpt_names"], gs):
                np.testing.assert_allclose(v, want[k], rtol=2e-4, atol=2e-5,
                                           err_msg=f"{name} {k}")
