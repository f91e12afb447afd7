"""Gloo worlds for the port's sequence-parallel and quantized tests.

``run_once`` spawns a world of processes once per pytest session, also
when xdist spreads a file's tests over several workers (the first worker
to take the lock runs it, the others read its results), so a file costs
one spawn. The workers import torch and the port only: each is held to
one intra-op thread, and the world has a deadline.

``sp_worker`` and ``quantized_worker`` run every case of
``tests/test_torch_seq_parallel.py`` and ``tests/test_torch_quantized.py``
on the inputs the test process saved, and save what each rank computed.
"""

import datetime
import fcntl
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from byteps_tpu_torch.utils.ports import free_port

WORLD = 4


def _spawn(fn, world, out_dir, timeout):
    ctx = mp.spawn(fn, args=(world, free_port(), out_dir), nprocs=world,
                   join=False)
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            raise TimeoutError(f"{fn.__name__}: world of {world} still "
                               f"running after {timeout} s")


def run_once(tmp_path_factory, name, make_inputs, fn, world=WORLD,
             timeout=240):
    """(inputs, [rank 0's results, ...]): ``make_inputs()`` saved as
    ``inputs.pt``, then ``fn`` run on a gloo world of ``world``
    processes, each saving ``r<rank>.pt``; once per session."""
    xdist = os.environ.get("PYTEST_XDIST_WORKER")
    # the xdist workers of one session share their base temp's parent
    root = (tmp_path_factory.getbasetemp().parent if xdist
            else tmp_path_factory.getbasetemp())
    out = root / f"torch_gloo_{name}"
    with open(root / f"torch_gloo_{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not (out / "done").exists():
                out.mkdir(exist_ok=True)
                torch.save(make_inputs(), out / "inputs.pt")
                _spawn(fn, world, str(out), timeout)
                (out / "done").touch()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    load = lambda p: torch.load(p, weights_only=False)  # noqa: E731
    return (load(out / "inputs.pt"),
            [load(out / f"r{r}.pt") for r in range(world)])


def _init(rank, world, port):
    torch.set_num_threads(1)
    os.environ["BYTEPS_PS_MODE"] = "collective"
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))


def _t(x, dtype=None):
    t = torch.as_tensor(np.asarray(x))
    return t if dtype is None else t.to(dtype)


def _np(t):
    return t.detach().float().numpy() if t.dtype == torch.bfloat16 \
        else t.detach().numpy()


# --- sequence parallelism -------------------------------------------------

def sp_worker(rank, world, port, out_dir):
    """Every sequence-parallel case on a world of 4: the sp group is the
    whole world (``Mesh((4,), ("sp",))``), and the DP x SP step runs on a
    2 (dcn) x 2 (ici) mesh of the same world with sp on ici."""
    _init(rank, world, port)
    try:
        import byteps_tpu_torch as bps
        from byteps_tpu_torch.models import (LlamaModel, LlamaTiny,
                                             TransformerEncoder, from_flax,
                                             sp_lm_loss)
        from byteps_tpu_torch.ops.flash_attention import flash_attention
        from byteps_tpu_torch.parallel import (Mesh, MeshSpec, build_mesh,
                                               full_attention,
                                               ring_attention,
                                               ring_attention_sharded,
                                               ulysses_attention,
                                               ulysses_attention_sharded)
        from byteps_tpu_torch.parallel import _collectives as C
        from byteps_tpu_torch.training import make_train_step

        inp = torch.load(os.path.join(out_dir, "inputs.pt"),
                         weights_only=False)
        sp = Mesh((world,), ("sp",)).group("sp")
        grid = build_mesh(MeshSpec(dcn=2, ici=2))
        res = {}

        def qkv(name, dtype=torch.float32):
            return [_t(x, dtype) for x in inp[name]]

        for causal in (False, True):
            q, k, v = qkv("qkv")
            res[f"ring_{causal}"] = _np(ring_attention_sharded(
                q, k, v, sp, causal=causal))
            q, k, v = qkv("qkv_h8")
            res[f"ulysses_{causal}"] = _np(ulysses_attention_sharded(
                q, k, v, sp, causal=causal))

        # gradients: each rank's block of sum(out^2), causal
        for name, fn, key in (("ring", ring_attention, "qkv_grad"),
                              ("ulysses", ulysses_attention, "qkv_grad_h4")):
            n = inp[key][0].shape[1] // world
            blocks = [x[:, rank * n:(rank + 1) * n].clone().requires_grad_()
                      for x in qkv(key)]
            (fn(*blocks, group=sp, causal=True) ** 2).sum().backward()
            res[f"{name}_grads"] = [_np(x.grad) for x in blocks]

        q, k, v = qkv("qkv_h6")
        try:
            ulysses_attention_sharded(q, k, v, sp)
            res["indivisible"] = "no error"
        except ValueError as e:
            res["indivisible"] = str(e)

        q, k, v = qkv("qkv", torch.bfloat16)
        out = ring_attention_sharded(q, k, v, sp, causal=True)
        res["ring_bf16"] = (str(out.dtype), _np(out))

        calls = []

        def spy(q_, k_, v_, *, causal, scale):
            calls.append(tuple(q_.shape))
            return full_attention(q_, k_, v_, causal=causal, scale=scale)
        q, k, v = qkv("qkv_h8")
        res["spy"] = (_np(ulysses_attention_sharded(q, k, v, sp,
                                                    attn_fn=spy)), calls)

        def inner(q_, k_, v_, *, causal, scale):
            return flash_attention(q_, k_, v_, causal, scale, 32, 32)
        q, k, v = qkv("qkv_flash")
        res["flash_inner"] = _np(ulysses_attention_sharded(
            q, k, v, sp, causal=True, attn_fn=inner))

        # sp_lm_loss: this rank's chunk; the test takes the mean
        logits, tokens = _t(inp["lm_logits"]), _t(inp["lm_tokens"])
        s = tokens.shape[1] // world
        chunk = slice(rank * s, (rank + 1) * s)
        res["sp_lm_loss"] = sp_lm_loss(logits[:, chunk], tokens[:, chunk],
                                       sp).item()

        # models on this rank's chunk of the sequence, positions global
        def chunk_of(t):
            n = t.shape[1] // world
            return t[:, rank * n:(rank + 1) * n]
        toks = _t(inp["llama_tokens"]).long()
        for impl in ("ring", "ulysses", "flash"):
            m = LlamaTiny(dtype=torch.float32, attn_impl=impl, sp_group=sp,
                          device="cpu")
            m.load_state_dict(from_flax(inp["llama_params"]))
            with torch.no_grad():
                res[f"llama_{impl}"] = _np(m(chunk_of(toks)))
        m = LlamaModel(**inp["gqa_cfg"], dtype=torch.float32,
                       attn_impl="ulysses", sp_group=sp, device="cpu")
        m.load_state_dict(from_flax(inp["gqa_params"]))
        C.reset_bytes()
        with torch.no_grad():
            res["gqa"] = _np(m(chunk_of(_t(inp["gqa_tokens"]).long())))
        res["gqa_a2a_bytes"] = C.BYTES["all_to_all"]
        toks = _t(inp["enc_tokens"]).long()
        for impl in ("ring", "ulysses"):
            m = TransformerEncoder(**inp["enc_cfg"], dtype=torch.float32,
                                   attn_impl=impl, sp_group=sp,
                                   device="cpu")
            m.load_state_dict(from_flax(inp["enc_params"]))
            with torch.no_grad():
                res[f"encoder_{impl}"] = _np(m(chunk_of(toks)))
        try:
            TransformerEncoder(**inp["enc_cfg"], attn_impl="full",
                               sp_group=sp, device="cpu")
            res["full_under_sp"] = "no error"
        except ValueError as e:
            res["full_under_sp"] = str(e)

        # DP x SP: batch rows over dcn, sequence over ici (ring)
        bps.init(device="cpu", mesh=grid)
        ici = grid.group("ici")
        m = LlamaTiny(dtype=torch.float32, attn_impl="ring", sp_group=ici,
                      device="cpu")
        m.load_state_dict(from_flax(inp["dpsp_params"]))
        opt = torch.optim.SGD(m.parameters(), lr=0.2)
        step = make_train_step(
            lambda model, t: sp_lm_loss(model(t), t, ici), opt)
        rows = slice(2 * grid.index("dcn"), 2 * grid.index("dcn") + 2)
        seq = slice(16 * grid.index("ici"), 16 * grid.index("ici") + 16)
        res["dpsp_losses"] = [
            step(m, _t(b).long()[rows, seq]).item()
            for b in inp["dpsp_batches"]]
        res["dpsp_params"] = {k: _np(p) for k, p in m.state_dict().items()}
        bps.shutdown()
        torch.save(res, os.path.join(out_dir, f"r{rank}.pt"))
    finally:
        dist.destroy_process_group()


# --- int8 quantized transport ---------------------------------------------

def quantized_worker(rank, world, port, out_dir):
    """``quantized_all_reduce`` on a 2 (dcn) x 2 (ici) mesh and on a 1 x 4
    mesh of the same world, push_pull's and make_train_step's int8
    dispatch, and the int8_dcn training problem on the 2 x 2 mesh."""
    _init(rank, world, port)
    try:
        import byteps_tpu_torch as bps
        from byteps_tpu_torch.compression import Compression
        from byteps_tpu_torch.parallel import (MeshSpec, build_mesh,
                                               quantized_all_reduce,
                                               tree_quantized_all_reduce)
        from byteps_tpu_torch.training import make_train_step

        inp = torch.load(os.path.join(out_dir, "inputs.pt"),
                         weights_only=False)
        grid = build_mesh(MeshSpec(dcn=2, ici=2))
        row = build_mesh(MeshSpec(dcn=1, ici=4))
        kw = dict(ici_group=grid.group("ici"), dcn_group=grid.group("dcn"))
        res = {}
        g = _t(inp["g"])[rank]
        res["close"] = _np(quantized_all_reduce(g, average=True, **kw))
        res["close_dcn"] = _np(quantized_all_reduce(
            g, average=True, quantize_dcn=True, **kw))
        res["dcn_only"] = _np(quantized_all_reduce(
            g, average=True, quantize_dcn=True,
            dcn_group=row.group("ici")))
        res["edges"] = _np(quantized_all_reduce(
            _t(inp["edges"])[rank], average=False,
            ici_group=row.group("ici")))

        # push_pull and make_train_step dispatch int8 to the quantized
        # transport; the tree version fuses the leaves
        bps.init(device="cpu", mesh=grid)
        tree = {"a": g[:100].clone(), "b": g[100:].reshape(1, -1).clone()}
        for comp in (Compression.int8, Compression.int8_dcn):
            got = bps.push_pull(tree, compression=comp)
            want = tree_quantized_all_reduce(
                tree, quantize_dcn=comp is Compression.int8_dcn, **kw)
            res[f"push_pull_{comp.name}"] = [
                bool(torch.equal(got[k], want[k])) for k in tree]

        def fresh():
            return {k: torch.nn.Parameter(_t(v).clone())
                    for k, v in inp["problem_params"].items()}

        def loss_fn(params, batch):
            x, y = batch
            pred = torch.tanh(x @ params["w1"]) @ params["w2"]
            return ((pred - y) ** 2).mean()
        shard = slice(8 * rank, 8 * rank + 8)  # rank = ici + 2 dcn
        batches = [(_t(x)[shard], _t(y)[shard])
                   for x, y in inp["problem_batches"]]

        # make_train_step's int8 steps against tree_quantized_all_reduce
        # applied by hand, five SGD steps (SGD, unlike Adam, sees the
        # gradient's scale); and the exact transport's step, which must
        # land elsewhere
        for comp in (Compression.int8, Compression.int8_dcn):
            runs = {}
            for how in ("step", "by_hand", "exact"):
                w = runs[how] = fresh()
                opt = torch.optim.SGD(w.values(), lr=0.1)
                step = make_train_step(
                    loss_fn, opt,
                    compression=Compression.none if how == "exact" else comp)
                for b in batches[:5]:
                    if how != "by_hand":
                        step(w, b)
                        continue
                    opt.zero_grad()
                    loss_fn(w, b).backward()
                    red = tree_quantized_all_reduce(
                        [p.grad for p in w.values()],
                        quantize_dcn=comp is Compression.int8_dcn, **kw)
                    for p, g in zip(w.values(), red):
                        p.grad = g
                    opt.step()
            res[f"step_{comp.name}"] = {
                how: [bool(torch.equal(runs["by_hand"][k], p))
                      for k, p in runs[how].items()]
                for how in ("step", "exact")}

        w = fresh()
        opt = torch.optim.Adam(w.values(), lr=1e-2)
        step = make_train_step(loss_fn, opt,
                               compression=Compression.int8_dcn)
        res["int8_dcn_losses"] = [step(w, b).item() for b in batches]
        bps.shutdown()
        torch.save(res, os.path.join(out_dir, f"r{rank}.pt"))
    finally:
        dist.destroy_process_group()
