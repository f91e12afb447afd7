"""The gloo world for the port's tensor, pipeline and expert parallelism,
ZeRO and dry-run tests.

``par_inputs`` makes every case's inputs with numpy from seeds (the
GPT-2-config pipeline case's flax parameters with JAX, imported inside
it: the workers never import JAX). ``par_worker`` runs every case of
``tests/test_torch_tensor_parallel.py``, ``test_torch_moe.py``,
``test_torch_zero.py``, ``test_torch_pipeline.py`` and
``test_torch_dryrun.py`` on a world of ``WORLD`` processes (one intra-op
thread each; ``_torch_sp_worker.run_once`` spawns it once per session)
and saves what each rank computed.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

from _torch_sp_worker import WORLD, _init, _np, _t

# The GPT-2-config pipeline case: 4 stages of 2 layers, 4 microbatches
GPT_CFG = dict(vocab_size=64, num_layers=8, d_model=32, num_heads=2,
               mlp_dim=64, max_len=16)
GPT_MB, GPT_SEQ = 4, 16


def _n(rng, *shape, s=1.0):
    return (rng.standard_normal(shape) * s).astype(np.float32)


def par_inputs():
    g = np.random.default_rng(0)
    inp = {
        "psum": dict(x=_n(g, WORLD, 3, 5), w=_n(g, WORLD, 3, 5)),
        "tp_mlp": dict(x=_n(g, 8, 16), w_in=_n(g, 16, 64, s=0.1),
                       b_in=_n(g, 64, s=0.1), w_out=_n(g, 64, 16, s=0.1),
                       b_out=_n(g, 16, s=0.1)),
        "tp_attn": dict(x=_n(g, 2, 16, 64),
                        **{k: _n(g, 64, 64, s=0.1)
                           for k in ("wq", "wk", "wv", "wo")}),
        "tp_grad": dict(x=_n(g, 4, 8), w_in=_n(g, 8, 32, s=0.2),
                        w_out=_n(g, 32, 8, s=0.2)),
        # EP: 8 experts, ample capacity; top-2: 4 experts
        "moe_ep": dict(gw=_n(g, 8, 8, s=0.3), w1=_n(g, 8, 8, 16, s=0.3),
                       w2=_n(g, 8, 16, 8, s=0.3), x=_n(g, 32, 8)),
        "moe_top2": dict(gw=_n(g, 8, 4, s=0.5), w1=_n(g, 4, 8, 16, s=0.3),
                         w2=_n(g, 4, 16, 8, s=0.3), x=_n(g, 32, 8)),
        # EP at capacity factor 1.25: 32 tokens a rank, 8 experts, 5 slots
        # an expert; the gate is sharp enough that some expert overflows
        "moe_drop": dict(gw=_n(g, 8, 8), w1=_n(g, 8, 8, 16, s=0.3),
                         w2=_n(g, 8, 16, 8, s=0.3), x=_n(g, 4 * 32, 8),
                         probe=_n(g, 4 * 32, 8)),
        "pp_fwd": dict(w=_n(g, 4, 8, 8, s=0.4), b=_n(g, 4, 8, s=0.1),
                       mb=_n(g, 6, 5, 8)),
        "pp_one": dict(w=_n(g, 4, 8, 8, s=0.4), b=_n(g, 4, 8, s=0.1),
                       mb=_n(g, 1, 3, 8)),
        "pp_train": dict(w=_n(g, 4, 8, 8, s=0.4), b=_n(g, 4, 8, s=0.1),
                         mb=_n(g, 4, 5, 8), tgt=_n(g, 4, 5, 8)),
    }
    g = np.random.default_rng(13)
    inp["pp_1f1b"] = dict(w=_n(g, 4, 6, 6, s=0.4), b=_n(g, 4, 6, s=0.1),
                          mb=_n(g, 12, 3, 6), tgt=_n(g, 12, 3, 6))
    g = np.random.default_rng(21)
    w_true = _n(g, 9, 4)
    xs = [_n(g, 32, 9) for _ in range(8)]
    inp["zero"] = dict(
        params={"w1": _n(g, 9, 16, s=0.3), "b1": np.zeros(16, np.float32),
                "w2": _n(g, 16, 4, s=0.3)},
        batches=[(x, x @ w_true) for x in xs])
    inp["pp_gpt"] = _gpt_inputs()
    return inp


def _gpt_inputs():
    import jax
    import jax.numpy as jnp

    from byteps_tpu.models.transformer import TransformerLM

    tokens = np.random.default_rng(7).integers(
        0, GPT_CFG["vocab_size"], (GPT_MB, 1, GPT_SEQ))
    params = TransformerLM(**GPT_CFG, dtype=jnp.float32).init(
        jax.random.PRNGKey(3), jnp.asarray(tokens[0], jnp.int32))
    return dict(tokens=tokens,
                params=jax.tree_util.tree_map(np.asarray, params))


def _tp_cases(inp, res, W):
    from byteps_tpu_torch.ops.flash_attention import flash_attention
    from byteps_tpu_torch.parallel import (shard_columns, shard_rows,
                                           tp_attention, tp_mlp)
    from byteps_tpu_torch.parallel._collectives import pmean, psum

    rank = dist.get_rank()
    x = _t(inp["psum"]["x"][rank]).requires_grad_()
    w = _t(inp["psum"]["w"][rank])
    (psum(x, W) * w).sum().backward()
    res["psum_grad"] = _np(x.grad)
    x.grad = None
    (pmean(x, W) * w).sum().backward()
    res["pmean_grad"] = _np(x.grad)

    c = {k: _t(v) for k, v in inp["tp_mlp"].items()}
    res["tp_mlp"] = _np(tp_mlp(
        c["x"], shard_columns(c["w_in"], W), shard_rows(c["w_out"], W),
        group=W, b_in_shard=shard_columns(c["b_in"], W), b_out=c["b_out"]))

    c = {k: _t(v) for k, v in inp["tp_attn"].items()}
    for name, fn in (("full", None), ("flash", flash_attention)):
        res[f"tp_attn_{name}"] = _np(tp_attention(
            c["x"], *(shard_columns(c[k], W) for k in ("wq", "wk", "wv")),
            shard_rows(c["wo"], W), group=W, num_local_heads=8 // WORLD,
            causal=True, attn_fn=fn))

    c = {k: _t(v) for k, v in inp["tp_grad"].items()}
    x = c["x"].requires_grad_()
    a = shard_columns(c["w_in"], W).clone().requires_grad_()
    b = shard_rows(c["w_out"], W).clone().requires_grad_()
    # the output is whole on every rank: divide by the group's size so
    # that psum's backward gives the dense gradient
    (tp_mlp(x, a, b, group=W) ** 2).sum().div(WORLD).backward()
    res["tp_grads"] = [_np(t.grad) for t in (a, b, x)]


def _moe_cases(inp, res, W):
    from byteps_tpu_torch.parallel import moe_dispatch, moe_ffn

    rank = dist.get_rank()

    def local(t, n=None):
        n = n or t.shape[0] // WORLD
        return t[rank * n:(rank + 1) * n]

    c = {k: _t(v) for k, v in inp["moe_ep"].items()}
    y, aux = moe_ffn(local(c["x"]), c["gw"], c["w1"], c["w2"],
                     capacity_factor=8.0, group=W)
    res["moe_ep"] = (_np(y), aux.item())
    c = {k: _t(v) for k, v in inp["moe_top2"].items()}
    y, aux = moe_ffn(local(c["x"]), c["gw"], c["w1"], c["w2"],
                     capacity_factor=8.0, group=W, top_k=2)
    res["moe_top2_ep"] = (_np(y), aux.item())

    c = {k: _t(v) for k, v in inp["moe_drop"].items()}
    x = local(c["x"]).clone().requires_grad_()
    ws = [c[k].clone().requires_grad_() for k in ("gw", "w1", "w2")]
    y, aux = moe_ffn(x, *ws, capacity_factor=1.25, group=W)
    ((y * local(c["probe"])).sum() + aux).backward()
    dispatch = moe_dispatch(x.detach() @ c["gw"], int(1.25 * 32 / 8))[0]
    res["moe_drop"] = dict(
        y=_np(y), aux=aux.item(), grads=[_np(t.grad) for t in [x] + ws],
        dropped=int(32 - dispatch.sum().item()))


def _zero_cases(inp, res):
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.parallel import (MeshSpec, build_mesh,
                                           make_zero_train_step,
                                           zero_init_sharded)
    from byteps_tpu_torch.training import make_train_step

    rank = dist.get_rank()
    z = inp["zero"]

    def loss_fn(params, batch):
        x, y = batch
        h = torch.tanh(x @ params["w1"] + params["b1"])
        return ((h @ params["w2"] - y) ** 2).mean()

    def fresh():
        return {k: torch.nn.Parameter(_t(v).clone())
                for k, v in z["params"].items()}

    factories = {
        "sgdm": lambda ps: torch.optim.SGD(ps, lr=0.05, momentum=0.9),
        "adamw": lambda ps: torch.optim.AdamW(ps, lr=1e-2,
                                              weight_decay=1e-4)}
    # rank = 2 dcn + ici: rows [8 rank, 8 rank + 8) of each batch, the
    # JAX shard_batch over (dcn, ici)
    rows = slice(8 * rank, 8 * rank + 8)
    batches = [(_t(x)[rows], _t(y)[rows]) for x, y in z["batches"]]
    mesh = build_mesh(MeshSpec(dcn=2, ici=2))
    bps.init(device="cpu", mesh=mesh)
    for name, make in factories.items():
        runs = {}
        for how in ("dense", "zero"):
            p = fresh()
            if how == "dense":
                step = make_train_step(loss_fn, make(list(p.values())))
            else:
                opt = zero_init_sharded(p, make, mesh)
                step = make_zero_train_step(loss_fn, opt, mesh)
            losses = [step(p, b).item() for b in batches]
            runs[how] = (losses, {k: _np(v) for k, v in p.items()})
        res[f"zero_{name}"] = runs
    bps.shutdown()

    # the state is 1/n a rank: a 1 x 4 mesh, one AdamW step
    mesh = build_mesh(MeshSpec(dcn=1, ici=WORLD))
    bps.init(device="cpu", mesh=mesh)
    p = fresh()
    opt = zero_init_sharded(p, factories["adamw"], mesh)
    make_zero_train_step(loss_fn, opt, mesh)(p, batches[0])
    shard = opt.param_groups[0]["params"][0]
    res["zero_state"] = dict(
        shard=shard.numel(),
        exp_avg=opt.state[shard]["exp_avg"].numel(),
        total=sum(v.size for v in z["params"].values()))
    bps.shutdown()


def _gpt_stage_model():
    from byteps_tpu_torch.models import TransformerLM
    return TransformerLM(**GPT_CFG, dtype=torch.float32, attn_impl="flash",
                         device="cpu")


def _pipeline_cases(inp, res, W):
    from byteps_tpu_torch.models import from_flax, lm_loss
    from byteps_tpu_torch.parallel import gpipe, pipeline_1f1b, stage_params

    def stage(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    for case in ("pp_fwd", "pp_one"):
        c = {k: _t(v) for k, v in inp[case].items()}
        stacked = {k: c[k] for k in ("w", "b")}
        res[case] = _np(gpipe(stage, stage_params(stacked, W), c["mb"],
                              group=W))

    c = {k: _t(v) for k, v in inp["pp_train"].items()}
    stacked = {k: c[k].clone().requires_grad_() for k in ("w", "b")}
    out = gpipe(stage, stage_params(stacked, W), c["mb"], group=W)
    (((out - c["tgt"]) ** 2).mean() / WORLD).backward()
    res["pp_train"] = {k: _np(v.grad) for k, v in stacked.items()}

    c = {k: _t(v) for k, v in inp["pp_1f1b"].items()}
    stacked = {k: c[k].clone().requires_grad_() for k in ("w", "b")}

    def mse(y, t):
        return ((y - t) ** 2).mean()
    loss, grads = pipeline_1f1b(stage, mse, stage_params(stacked, W),
                                c["mb"], c["tgt"], group=W)
    res["pp_1f1b"] = (loss.item(), {k: _np(v) for k, v in grads.items()})
    out = gpipe(stage, stage_params(stacked, W), c["mb"], group=W)
    torch.stack([mse(out[i], c["tgt"][i]) for i in range(len(out))]).mean() \
        .div(WORLD).backward()
    # this rank's stage of the gradients of the whole stacked tree
    rank = dist.get_rank()
    res["pp_1f1b_gpipe"] = {k: _np(v.grad[rank]) for k, v in stacked.items()}

    # a GPT-2-config stage function: 2 TransformerLayers a stage, the
    # flash wrapper (its plain version on the CPU); the embedding outside
    g = inp["pp_gpt"]
    model = _gpt_stage_model()
    model.load_state_dict(from_flax(g["params"]))
    per = GPT_CFG["num_layers"] // WORLD
    layers = model.layers[rank * per:(rank + 1) * per]
    tokens = torch.as_tensor(g["tokens"]).long()
    with torch.no_grad():
        pos = torch.arange(GPT_SEQ)[None]
        mbs = torch.stack([model.tok_embed(t) + model.pos_embed(pos)
                           for t in tokens])

    def run(layers_, x):
        for layer in layers_:
            x = layer(x)
        return x

    def head_loss(y, t):
        logits = model.tok_embed.attend(model.final_ln(y)).float()
        return lm_loss(logits, t)

    loss, grads = pipeline_1f1b(run, head_loss, layers, mbs, tokens,
                                group=W)
    res["gpt_1f1b"] = (loss.item(), [_np(v) for v in grads])
    out = gpipe(run, layers, mbs, group=W)
    loss = torch.stack([head_loss(out[i], tokens[i])
                        for i in range(GPT_MB)]).mean()
    layers.zero_grad()
    (loss / WORLD).backward()
    res["gpt_gpipe"] = (loss.item(), [_np(p.grad) for p in
                                      layers.parameters()])
    res["gpt_names"] = [
        f"layers.{rank * per + int(n.split('.')[0])}.{n.split('.', 1)[1]}"
        for n, _ in layers.named_parameters()]


def par_worker(rank, world, port, out_dir):
    _init(rank, world, port)
    try:
        from byteps_tpu_torch.dryrun import dryrun_multichip

        inp = torch.load(os.path.join(out_dir, "inputs.pt"),
                         weights_only=False)
        W = dist.group.WORLD
        res = {}
        _tp_cases(inp, res, W)
        _moe_cases(inp, res, W)
        _pipeline_cases(inp, res, W)
        _zero_cases(inp, res)
        res["dryrun"] = dryrun_multichip(world, device="cpu")
        torch.save(res, os.path.join(out_dir, f"r{rank}.pt"))
    finally:
        dist.destroy_process_group()
