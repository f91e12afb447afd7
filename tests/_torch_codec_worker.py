"""Workers of ``tests/test_torch_codec.py``'s fleets (``-m ps``).

    python tests/_torch_codec_worker.py port|jax|lm OUT_DIR

``port`` and ``jax`` train the gradient-input model: parameters ``a``,
``b`` and ``c`` (zeros) and loss = sum over the leaves of w * g, so the
gradient of each leaf is its input g exactly, in both frameworks; g of
step t on global rank r is ``grads(t, r)``, from numpy. SGD with lr 1
then moves each parameter by exactly the servers' sum (mean), and the
parameters after each step hold that sum's history. ``port`` runs
``PATHS`` of the port one after the other in one fleet, each under a
prefix of its own (tensors and error-feedback state of their own);
``jax`` runs the JAX package's PS ``make_train_step`` and, on a host of
two chips, its ``make_overlapped_train_step`` (``BPS_TEST_CHIPS``
devices, a host's ranks as its chips). A launched process with
``BYTEPS_LOCAL_SIZE`` 2 is one rank of a host of two, over a gloo group
at ``BPS_TEST_LOCAL_PORT``. Each writes the parameters after every step
to ``OUT_DIR/{kind}_r{rank}.npz``.

``lm`` is the port's counterpart of
``example/jax/train_gpt2_compression_byteps.py --model tiny``: the same
TransformerLM, corpus, row shard, Adam(3e-3) and steps, with the flax
weights the test converted (``OUT_DIR/weights.pt``); it prints one JSON
line with the final loss and the wire bytes of the run.
"""

import json
import os
import sys
import time

import numpy as np

SHAPES = {"a": (48, 20), "b": (300,), "c": (7,)}
STEPS = 3
PATHS = ("plain", "overlap_f32", "bucketed_multi", "distributed_optimizer")


def grads(step: int, rank: int):
    rng = np.random.default_rng(1000 * step + rank)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _local_group():
    """A launched rank of a host of k > 1: the host's gloo group."""
    k = int(os.environ.get("BYTEPS_LOCAL_SIZE", "1"))
    if k == 1:
        return 1
    import datetime

    import torch.distributed as dist
    dist.init_process_group(
        "gloo", init_method="tcp://127.0.0.1:"
        f"{os.environ['BPS_TEST_LOCAL_PORT']}",
        rank=int(os.environ["BYTEPS_LOCAL_RANK"]), world_size=k,
        timeout=datetime.timedelta(seconds=120))
    return k


def _port_step(path, model, loss):
    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.bucketed import make_bucketed_overlap_step
    from byteps_tpu_torch.overlap import make_overlapped_train_step
    from byteps_tpu_torch.training import make_train_step
    opt = torch.optim.SGD(model.parameters(), lr=1.0)
    if path == "plain":
        return make_train_step(loss, opt, ps_prefix=path)
    if path == "overlap_f32":
        return make_overlapped_train_step(loss, opt, prefix=path)
    if path == "bucketed_multi":
        return make_bucketed_overlap_step(loss, opt, n_buckets=2,
                                          multi_program=True, prefix=path)
    dopt = bps.DistributedOptimizer(
        opt, named_parameters=model.named_parameters())

    def step(model, batch):
        dopt.zero_grad()
        loss(model, batch).backward()
        dopt.step()
    step.close = dopt._taps.close
    return step


def port_worker(out_dir: str) -> int:
    import torch
    torch.set_num_threads(1)
    k = _local_group()
    import byteps_tpu_torch as bps
    bps.init(device="cpu")
    try:
        rank = bps.rank()

        def loss(model, batch):
            return sum((getattr(model, n) * batch[n]).sum() for n in SHAPES)

        out = {}
        for path in PATHS if k == 1 else PATHS[:2]:
            model = torch.nn.Module()
            for n, s in SHAPES.items():
                model.register_parameter(
                    n, torch.nn.Parameter(torch.zeros(s)))
            step = _port_step(path, model, loss)
            for t in range(STEPS):
                step(model, {n: torch.from_numpy(g)
                             for n, g in grads(t, rank).items()})
                for n, p in model.named_parameters():
                    out[f"{path}/{t}/{n}"] = p.detach().numpy().copy()
            if hasattr(step, "close"):
                step.close()
        np.savez(os.path.join(out_dir, f"port_r{rank}.npz"), **out)
        print(f"rank {rank}: port OK", flush=True)
        return 0
    finally:
        bps.shutdown()
        if k > 1:
            import torch.distributed as dist
            dist.destroy_process_group()


def jax_worker(out_dir: str) -> int:
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import optax

    import byteps_tpu.jax as jbps
    from byteps_tpu.jax.overlap import make_overlapped_train_step
    from byteps_tpu.jax.training import make_train_step, replicate, shard_batch
    from byteps_tpu.parallel.mesh import MeshSpec, build_mesh

    chips = int(os.environ.get("BPS_TEST_CHIPS", "1"))
    mesh = build_mesh(MeshSpec(dcn=1, ici=chips),
                      devices=jax.devices()[:chips])
    jbps.init(mesh=mesh)
    try:
        host = jbps.rank()

        def loss(params, batch):
            # this chip's shard of the batch: [1, *shape]
            return sum(jnp.sum(params[n] * batch[n][0]) for n in SHAPES)

        def batch(t):
            g = [grads(t, host * chips + j) for j in range(chips)]
            return shard_batch({n: np.stack([x[n] for x in g])
                                for n in SHAPES}, mesh)

        tx = optax.sgd(1.0)
        out = {}
        steps = {"plain": make_train_step(loss, tx, mesh, donate=False,
                                          ps_prefix="plain")}
        if chips > 1:
            steps["overlap_f32"] = make_overlapped_train_step(
                loss, tx, prefix="overlap_f32")
        for path, step in steps.items():
            params = replicate({n: jnp.zeros(s, jnp.float32)
                                for n, s in SHAPES.items()}, mesh)
            state = replicate(tx.init(params), mesh)
            for t in range(STEPS):
                params, state, _ = step(params, state, batch(t))
                for n in SHAPES:
                    out[f"{path}/{t}/{n}"] = np.asarray(params[n])
        np.savez(os.path.join(out_dir, f"jax_r{host}.npz"), **out)
        print(f"host {host}: jax OK", flush=True)
        return 0
    finally:
        jbps.shutdown()


def lm_worker(out_dir: str, steps: int) -> int:
    """See the module docstring; BYTEPS_COMPRESSOR names the codec."""
    import torch
    torch.set_num_threads(1)
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.models import TransformerLM, lm_loss
    from byteps_tpu_torch.training import make_train_step
    bps.init(device="cpu")
    try:
        rank, nworkers = bps.rank(), bps.size()
        model = TransformerLM(num_layers=2, d_model=128, num_heads=4,
                              mlp_dim=256, vocab_size=512, max_len=64,
                              dtype=torch.float32, device="cpu")
        model.load_state_dict(torch.load(os.path.join(out_dir, "weights.pt")))
        seq, batch = 64, 16
        rng = np.random.default_rng(7)
        corpus = rng.integers(0, 512 // 4, (batch, seq))
        corpus = (corpus * 3 + np.arange(seq)[None, :]) % 512
        toks = torch.as_tensor(corpus[rank::max(1, nworkers)])
        step = make_train_step(lambda m, t: lm_loss(m(t), t),
                               torch.optim.Adam(model.parameters(), lr=3e-3))
        client = bps._st().ps_client
        sent0, recv0 = client.net_bytes()
        t0 = time.perf_counter()
        for _ in range(steps):
            loss = step(model, toks)
        elapsed = time.perf_counter() - t0
        sent1, recv1 = client.net_bytes()
        print(json.dumps({
            "compressor": os.environ.get("BYTEPS_COMPRESSOR") or "none",
            "workers": nworkers, "steps": steps,
            "final_loss": round(float(loss), 4),
            "steps_per_sec": round(steps / elapsed, 3),
            "wire_sent_mb": round((sent1 - sent0) / 1e6, 3),
            "wire_recv_mb": round((recv1 - recv0) / 1e6, 3)}), flush=True)
        return 0
    finally:
        bps.shutdown()


if __name__ == "__main__":
    kind, out = sys.argv[1], sys.argv[2]
    if kind == "port":
        sys.exit(port_worker(out))
    if kind == "jax":
        sys.exit(jax_worker(out))
    sys.exit(lm_worker(out, int(sys.argv[3])))
