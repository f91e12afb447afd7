"""The port's sequence parallelism against the JAX package's.

One gloo world of 4 spawned processes (``_torch_sp_worker.sp_worker``,
once per session) runs every case on inputs made here from numpy seeds;
the JAX side runs here, on 4 of the 8 CPU devices, on the same inputs.
Carried over, at the reference's tolerances:

- ``tests/test_seq_parallel.py``: ring and Ulysses against full attention,
  causal and not (rtol 2e-5, atol 2e-6); ring gradients (2e-4 / 2e-5),
  and Ulysses' too; Ulysses rejects heads that do not divide; ring in
  bf16 (0.05); ring on a single process; Ulysses with a custom inner
  function; ``sp_lm_loss`` against the full-sequence loss (rtol 1e-6);
- ``tests/test_llama.py``: LlamaTiny under ring, Ulysses and flash (the
  port's kernels' plain versions on the CPU) against the full forward,
  GQA Ulysses with unrepeated K/V (2e-4), and the DP x SP training step
  on a 2 x 2 mesh against the JAX step on a 2 x 2 mesh (losses rtol 2e-4,
  parameters 3e-3 / 3e-4);
- ``tests/test_transformer.py``: the SP encoder against full (2e-4);
- ``tests/test_flash_attention.py``: flash as the Ulysses inner kernel.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import byteps_tpu.jax as jbps
from byteps_tpu.jax._compat import shard_map as _shard_map
from byteps_tpu.models import LlamaModel as FlaxLlama
from byteps_tpu.models.llama import LlamaTiny as FlaxLlamaTiny
from byteps_tpu.models.transformer import TransformerEncoder as FlaxEncoder
from byteps_tpu.models.transformer import lm_loss as jax_lm_loss
from byteps_tpu.models.transformer import sp_lm_loss as jax_sp_lm_loss
from byteps_tpu.parallel.mesh import MeshSpec, build_mesh
from byteps_tpu.parallel.ring_attention import (full_attention,
                                                ring_attention_sharded)
from byteps_tpu.parallel.ulysses import ulysses_attention_sharded
from byteps_tpu_torch.models import from_flax
from byteps_tpu_torch.parallel import ring_attention_sharded as port_ring

from _torch_sp_worker import WORLD, run_once, sp_worker

GQA_CFG = dict(vocab_size=512, num_layers=2, d_model=64, num_heads=8,
               num_kv_heads=4, mlp_dim=128)
ENC_CFG = dict(vocab_size=97, num_layers=2, d_model=32, num_heads=4,
               mlp_dim=64, max_len=64)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _inputs():
    rng = np.random.default_rng(0)

    def qkv(b=2, s=64, h=4, d=8):
        return [rng.standard_normal((b, s, h, d)).astype(np.float32)
                for _ in range(3)]
    inp = {"qkv": qkv(), "qkv_h8": qkv(h=8), "qkv_grad": qkv(1, 32, 2, 4),
           "qkv_grad_h4": qkv(1, 32, 4, 4), "qkv_h6": qkv(h=6),
           "qkv_flash": qkv(h=8, d=16),
           "lm_logits": rng.standard_normal((2, 32, 17)).astype(np.float32),
           "lm_tokens": rng.integers(0, 17, (2, 32)).astype(np.int64)}
    toks = np.random.default_rng(5).integers(0, 1024, (2, 32))
    inp["llama_tokens"] = toks
    inp["llama_params"] = _np_tree(FlaxLlamaTiny(dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.asarray(toks, jnp.int32)))
    toks = np.random.default_rng(9).integers(0, 512, (2, 32))
    inp["gqa_cfg"], inp["gqa_tokens"] = GQA_CFG, toks
    inp["gqa_params"] = _np_tree(FlaxLlama(**GQA_CFG, dtype=jnp.float32)
                                 .init(jax.random.PRNGKey(0),
                                       jnp.asarray(toks, jnp.int32)))
    toks = np.random.default_rng(3).integers(0, ENC_CFG["vocab_size"],
                                             (2, 32))
    inp["enc_cfg"], inp["enc_tokens"] = ENC_CFG, toks
    inp["enc_params"] = _np_tree(FlaxEncoder(**ENC_CFG, dtype=jnp.float32)
                                 .init(jax.random.PRNGKey(3),
                                       jnp.asarray(toks)))
    # the DP x SP step: the reference test's draws, in its order
    rng = np.random.default_rng(6)
    toks0 = rng.integers(0, 1024, (4, 32))
    inp["dpsp_params"] = _np_tree(FlaxLlamaTiny(dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.asarray(toks0, jnp.int32)))
    inp["dpsp_batches"] = [rng.integers(0, 1024, (4, 32)) for _ in range(4)]
    return inp


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return run_once(tmp_path_factory, "seq_parallel", _inputs, sp_worker)


def _mesh(n=WORLD, axis="sp"):
    return Mesh(np.asarray(jax.devices()[:n]), (axis,))


def _close(got, want, rtol=2e-5, atol=2e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _cat(results, key):
    """The ranks' sequence blocks of ``key``, concatenated in rank order."""
    return np.concatenate([r[key] for r in results], axis=1)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_full(run, causal):
    inp, res = run
    q, k, v = (jnp.asarray(x) for x in inp["qkv"])
    want = full_attention(q, k, v, causal=causal)
    for r in res:
        _close(r[f"ring_{causal}"], want)
    _close(res[0][f"ring_{causal}"],
           ring_attention_sharded(q, k, v, _mesh(), causal=causal))


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_attention_matches_full(run, causal):
    inp, res = run
    q, k, v = (jnp.asarray(x) for x in inp["qkv_h8"])
    want = full_attention(q, k, v, causal=causal)
    for r in res:
        _close(r[f"ulysses_{causal}"], want)
    _close(res[0][f"ulysses_{causal}"],
           ulysses_attention_sharded(q, k, v, _mesh(), causal=causal))


@pytest.mark.parametrize("impl,key", [("ring", "qkv_grad"),
                                      ("ulysses", "qkv_grad_h4")])
def test_attention_gradients_match(run, impl, key):
    """Training goes through the backward of the collectives: the ranks'
    block gradients of sum(out^2), concatenated, equal the JAX gradients
    of full attention."""
    inp, res = run
    q, k, v = (jnp.asarray(x) for x in inp[key])
    want = jax.grad(lambda a, b, c: (full_attention(a, b, c, causal=True)
                                     ** 2).sum(), argnums=(0, 1, 2))(q, k, v)
    for i, w in enumerate(want):
        got = np.concatenate([r[f"{impl}_grads"][i] for r in res], axis=1)
        _close(got, w, rtol=2e-4, atol=2e-5)


def test_ulysses_rejects_indivisible_heads(run):
    assert "divisible" in run[1][0]["indivisible"]


def test_ring_attention_bf16(run):
    inp, res = run
    q, k, v = (jnp.asarray(x) for x in inp["qkv"])
    dtype, got = res[0]["ring_bf16"]
    assert dtype == "torch.bfloat16"
    want = full_attention(*(x.astype(jnp.bfloat16).astype(jnp.float32)
                            for x in (q, k, v)), causal=True)
    _close(got, want, rtol=0.05, atol=0.05)


def test_ring_attention_single_process():
    """A group of one member is plain attention (no spawn)."""
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((2, 16, 4, 8)).astype(np.float32)
               for _ in range(3))
    got = port_ring(*(torch.as_tensor(x) for x in (q, k, v)), None,
                    causal=True)
    want = ring_attention_sharded(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), _mesh(1), causal=True)
    _close(got.numpy(), want)


def test_ulysses_with_custom_inner_attention(run):
    inp, res = run
    q, k, v = (jnp.asarray(x) for x in inp["qkv_h8"])
    got, calls = res[0]["spy"]
    _close(got, full_attention(q, k, v, causal=False))
    # the inner call saw the whole sequence with 1/4 of the heads
    assert calls and calls[0] == (2, 64, 2, 8)


def test_flash_as_ulysses_inner(run):
    inp, res = run
    q, k, v = (jnp.asarray(x) for x in inp["qkv_flash"])
    _close(res[0]["flash_inner"], full_attention(q, k, v, causal=True))


def test_sp_lm_loss_matches_full_sequence(run):
    """The mean over the group of the blocks' sp_lm_loss is the
    full-sequence lm_loss, as the JAX pmean of its sp_lm_loss is."""
    inp, res = run
    logits = jnp.asarray(inp["lm_logits"])
    tokens = jnp.asarray(inp["lm_tokens"], jnp.int32)
    full = float(jax_lm_loss(logits, tokens))
    got = float(np.mean([r["sp_lm_loss"] for r in res]))
    np.testing.assert_allclose(got, full, rtol=1e-6)

    @partial(_shard_map, mesh=_mesh(), in_specs=(P(None, "sp"),
                                                 P(None, "sp")),
             out_specs=P(), check_vma=False)
    def chunked(lg, tk):
        return jax.lax.pmean(jax_sp_lm_loss(lg, tk, "sp"), "sp")
    np.testing.assert_allclose(got, float(chunked(logits, tokens)),
                               rtol=1e-6)


@pytest.mark.parametrize("impl", ["ring", "ulysses", "flash"])
def test_llama_sequence_parallel_matches_full(run, impl):
    inp, res = run
    want = FlaxLlamaTiny(dtype=jnp.float32).apply(
        inp["llama_params"], jnp.asarray(inp["llama_tokens"], jnp.int32))
    _close(_cat(res, f"llama_{impl}"), want, rtol=2e-4, atol=2e-4)


def test_llama_gqa_ulysses_unrepeated_kv_matches_full(run):
    """KV heads (4) divide the group (4): K/V travel unrepeated, so each
    layer's all-to-alls carry q, k, v and the output at 8 + 4 + 4 + 8
    heads' width, not 8 + 8 + 8 + 8."""
    inp, res = run
    want = FlaxLlama(**GQA_CFG, dtype=jnp.float32).apply(
        inp["gqa_params"], jnp.asarray(inp["gqa_tokens"], jnp.int32))
    _close(_cat(res, "gqa"), want, rtol=2e-4, atol=2e-4)
    b, s = inp["gqa_tokens"].shape
    hd = GQA_CFG["d_model"] // GQA_CFG["num_heads"]
    per_layer = b * (s // WORLD) * hd * 4 * (8 + 4 + 4 + 8)
    assert res[0]["gqa_a2a_bytes"] == GQA_CFG["num_layers"] * per_layer


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sequence_parallel_encoder_matches_full(run, impl):
    """No positions passed: the encoder derives global positions from its
    rank in the group."""
    inp, res = run
    want = FlaxEncoder(**ENC_CFG, dtype=jnp.float32).apply(
        inp["enc_params"], jnp.asarray(inp["enc_tokens"]))
    _close(_cat(res, f"encoder_{impl}"), want, rtol=2e-4, atol=2e-4)


def test_full_attention_under_sp_raises(run):
    assert "sequence parallelism" in run[1][0]["full_under_sp"]


def test_llama_dp_x_sp_training_matches_jax_step(run):
    """DP over dcn x ring SP over ici on a 2 x 2 mesh, sp_lm_loss and the
    hierarchical push_pull over both levels: the port's make_train_step
    against the JAX test's step on a 2 x 2 mesh, step by step."""
    inp, res = run
    mesh = build_mesh(MeshSpec(dcn=2, ici=2), devices=jax.devices()[:4])
    jbps.init(mesh=mesh)
    model = FlaxLlamaTiny(dtype=jnp.float32, attn_impl="ring",
                          sp_axis="ici")
    tx = optax.sgd(0.2)

    @jax.jit
    @partial(_shard_map, mesh=mesh, in_specs=(P(), P(), P("dcn", "ici")),
             out_specs=(P(), P(), P()), check_vma=False)
    def step(p, opt_state, batch):
        loss, grads = jax.value_and_grad(
            lambda p_: jax_sp_lm_loss(model.apply(p_, batch), batch,
                                      "ici"))(p)
        grads = jbps.push_pull(grads, average=True)
        updates, opt_state = tx.update(grads, opt_state, p)
        p = optax.apply_updates(p, updates)
        for ax in ("dcn", "ici"):
            loss = jax.lax.pmean(loss, ax)
        return p, opt_state, loss

    p = jax.tree_util.tree_map(jnp.asarray, inp["dpsp_params"])
    o = tx.init(p)
    losses = []
    for b in inp["dpsp_batches"]:
        p, o, loss = step(p, o, jnp.asarray(b, jnp.int32))
        losses.append(float(loss))
    want = from_flax(_np_tree(p))
    for r in res:
        np.testing.assert_allclose(r["dpsp_losses"], losses, rtol=2e-4)
        assert set(r["dpsp_params"]) == set(want)
        for name, w in want.items():
            np.testing.assert_allclose(r["dpsp_params"][name], w.numpy(),
                                       rtol=3e-3, atol=3e-4, err_msg=name)
