"""The batch norm of ``ops.batch_norm``: its plain version against the
torch-op norm ResNet ran before (and the ReLU after it), the backward
formula its kernels use against autograd, the launch geometry, and on a
CUDA card the kernels against the plain version.

This file imports torch and the port only (no JAX), so its ``cuda`` tests
also run on a GPU machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_batch_norm.py

Tolerances, kernels against the plain version on the card
(``chip_smoke.bn_bound``): f32 inputs within 1e-5 of each tensor's largest
magnitude (y, dx, the running statistics) or of the sum of |term| behind
each channel's sum (dscale, dbias): two f32 evaluations summing in
another order differ by about 1e-7 of those, and an element-wise rtol
cannot hold where a value cancels to near 0. bf16 inputs: the same, plus
one bf16 ulp of the plain version run in f32 (the kernel's own rounding
of y and dx). With the ReLU, dy is 0 where |y| < 1e-3 of its largest:
there the two sides' statistics, equal to about 1e-7, may put y on either
side of 0.
"""

import pytest
import torch
import torch.nn.functional as F

from byteps_tpu_torch.models import resnet
from byteps_tpu_torch.ops import batch_norm as bn
from byteps_tpu_torch.utils import timeline
from chip_smoke import bn_bound


@pytest.fixture(autouse=True)
def _one_thread():
    # one intra-op thread: the other test workers need the cores more, and
    # the reductions then sum in one order
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _todays_norm(x, scale, bias, mean, var, training, dtype):
    """``BatchNorm.forward`` as ResNet ran it before the kernels (torch
    ops, the ReLU a separate op after it)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    if training:
        m = xf.mean((0, 2, 3))
        v = torch.clamp((xf * xf).mean((0, 2, 3)) - m * m, min=0.0)
        with torch.no_grad():
            mean.copy_(0.9 * mean + (1 - 0.9) * m)
            var.copy_(0.9 * var + (1 - 0.9) * v)
    else:
        m, v = mean, var
    mul = torch.rsqrt(v + 1e-5) * scale
    y = (xf - m[:, None, None]) * mul[:, None, None]
    return (y + bias[:, None, None]).to(dtype)


def _inputs(shape, dtype, seed=0, device="cpu", constant=None):
    """x (N, C, H, W) channels_last, drawn from 0.5 + 2 N(0, 1), with
    channel 0 held at ``constant`` if given; f32 scale U(0.5, 1.5), bias
    N(0, 0.5), running mean N(0, 0.1) and var U(0.5, 1.5); dy N(0, 1)."""
    g = torch.Generator().manual_seed(seed)
    n, c, h, w = shape
    x = 0.5 + 2 * torch.randn(shape, generator=g, dtype=torch.float64)
    if constant is not None:
        x[:, 0] = constant
    vec = {"scale": 0.5 + torch.rand(c, generator=g),
           "bias": 0.5 * torch.randn(c, generator=g),
           "mean": 0.1 * torch.randn(c, generator=g),
           "var": 0.5 + torch.rand(c, generator=g)}
    dy = torch.randn(shape, generator=g, dtype=torch.float64)

    def act(t):
        return t.to(device, dtype).contiguous(
            memory_format=torch.channels_last)
    return act(x), act(dy), {k: v.to(device) for k, v in vec.items()}


# --- CPU: the plain version and the backward formula -------------------------

@pytest.mark.parametrize("relu", [True, False], ids=["relu", "norm"])
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16],
                         ids=["float64", "bfloat16"])
def test_plain_equals_todays_norm_then_relu(dtype, training, relu):
    x, _, v = _inputs((3, 5, 4, 6), dtype)
    x.requires_grad_()
    a = {k: t.clone() for k, t in v.items()}
    b = {k: t.clone() for k, t in v.items()}
    got = bn._plain(x, a["scale"], a["bias"], a["mean"], a["var"], training,
                    relu)
    want = _todays_norm(x, b["scale"], b["bias"], b["mean"], b["var"],
                        training, dtype)
    if relu:
        want = F.relu(want)
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got, want)
    assert torch.equal(a["mean"], b["mean"]) and torch.equal(a["var"],
                                                             b["var"])
    if dtype == torch.float64:
        g = torch.randn(got.shape, dtype=dtype,
                        generator=torch.Generator().manual_seed(1))
        assert torch.equal(torch.autograd.grad(got, x, g)[0],
                           torch.autograd.grad(want, x, g)[0])


def _clipped_inputs(shape, seed):
    """``_inputs`` in float64 with channel 0 held at a constant whose
    E[x^2] - E[x]^2, computed as ``_plain`` computes it, comes out below 0
    (and is clipped)."""
    for c in (1.1, 0.3, 0.6, 1.3, 0.15, 2.2, 0.7, 0.9, 1.7, 0.45):
        x, dy, v = _inputs(shape, torch.float64, seed=seed, constant=c)
        m = x.mean((0, 2, 3))
        if ((x * x).mean((0, 2, 3)) - m * m)[0].item() < 0:
            return x, dy, v
    raise AssertionError("no candidate constant is clipped")


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "norm"])
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("case", ["random", "constant"])
def test_backward_formula_matches_autograd(case, training, relu):
    """``_plain_backward`` (the kernels' formula: x - mean and the ReLU
    mask recomputed from x, dx = rstd scale (dy' - dbias / n - xhat dscale
    / n), the xhat term left out where var was clipped) against autograd
    of ``_plain`` in float64."""
    shape = (2, 4, 3, 5)
    x, dy, v = (_clipped_inputs(shape, 2) if case == "constant"
                else _inputs(shape, torch.float64, seed=2))
    vec = {k: t.double() for k, t in v.items()}
    scale = vec["scale"].clone().requires_grad_()
    bias = vec["bias"].clone().requires_grad_()
    x.requires_grad_()
    mean, var = vec["mean"].clone(), vec["var"].clone()
    y = bn._plain(x, scale, bias, mean, var, training, relu)
    want = torch.autograd.grad(y, (x, scale, bias), dy)

    xd = x.detach()
    if training:
        m = xd.mean((0, 2, 3))
        raw = (xd * xd).mean((0, 2, 3)) - m * m
        s, keep = torch.clamp(raw, min=0.0), (raw >= 0).double()
        if case == "constant":
            assert keep[0] == 0 and keep[1:].all()
    else:
        m, s, keep = vec["mean"], vec["var"], None
    got = bn._plain_backward(xd, dy, vec["scale"], vec["bias"], m, s, keep,
                             relu)
    for what, g, w in zip(("dx", "dscale", "dbias"), got, want):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-12, msg=what)


def test_cpu_tensors_launch_no_kernel():
    """A ResNet on the CPU takes the plain version: no kernel entry
    counts, also under a step trace."""
    bn.reset_launches()
    model = resnet.ResNet18(num_classes=10, num_filters=8,
                            dtype=torch.float32, device="cpu")
    x = torch.randn(2, 3, 32, 32)
    timeline.start_steps()
    try:
        model(x).sum().backward()
    finally:
        rec = timeline.stop_steps()
    assert bn.LAUNCHES == {"train": 0, "eval": 0, "backward": 0}
    assert all("bn_launches" not in r for r in rec["records"])


def test_each_entry_counts_in_the_step_record():
    """``_count`` adds to LAUNCHES and, under a step trace, to the current
    record's ``bn_launches``."""
    bn.reset_launches()
    timeline.start_steps()
    try:
        rec = timeline.steps.open()
        timeline.add_span(rec, "zero_grad", 0.0, 0.0)
        for name in ("train", "train", "backward"):
            bn._count(name)
    finally:
        out = timeline.stop_steps()
        bn.reset_launches()
    assert [r["bn_launches"] for r in out["records"]] == [3]


# ResNet-50's norm shapes at batch 256, 224 x 224 (rows, C): the stem,
# the largest and smallest C of each stage
SHAPES = {"stem": (256 * 112 * 112, 64), "s1_64": (256 * 56 * 56, 64),
          "s1_256": (256 * 56 * 56, 256), "s2_512": (256 * 28 * 28, 512),
          "s3_1024": (256 * 14 * 14, 1024), "s4_512": (256 * 7 * 7, 512),
          "s4_2048": (256 * 7 * 7, 2048), "narrow": (2 * 9 * 7, 12)}


@pytest.mark.parametrize("elem", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_geometry_covers_every_row_and_fills_the_card(shape, elem):
    rows, c = SHAPES[shape]
    g = bn.geometry(rows, c, elem)
    per16 = 16 // elem
    assert g.vec == (per16 if c % per16 == 0 else 1)
    assert g.tx * g.ty <= bn.THREADS and g.tx <= 32
    assert g.tiles * g.tx * g.vec >= c > (g.tiles - 1) * g.tx * g.vec
    assert (g.slabs - 1) * g.rows_per_slab < rows <= g.slabs * g.rows_per_slab
    assert g.slabs <= 65535
    if shape != "narrow":  # every ResNet-50 launch fills the 132 SMs
        assert 132 * 4 <= g.tiles * g.slabs <= bn.TARGET_BLOCKS + g.tiles
        assert g.rows_per_slab >= g.ty
    assert bn.geometry(rows, c, elem, aligned=False).vec == 1


def test_check_refuses_what_the_kernels_do_not_take():
    x, _, v = _inputs((2, 16, 3, 3), torch.float32)
    vecs = (v["scale"], v["bias"], v["mean"], v["var"])
    bn._check(x, *vecs)
    with pytest.raises(ValueError, match="channels_last"):
        bn._check(x.contiguous(), *vecs)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        bn._check(x.half(), *vecs)
    with pytest.raises(ValueError, match="f32"):
        bn._check(x, v["scale"].double(), *vecs[1:])


# --- CUDA: the kernels against the plain version -----------------------------

# (N, C, H, W): the stem and one norm of each ResNet-50 stage (the two
# extremes of the launch geometry at batch 256), and a C that takes one
# element a load in bf16
CARD_SHAPES = {"stem": (256, 64, 112, 112), "stage1": (32, 256, 56, 56),
               "stage2": (32, 512, 28, 28), "stage3": (32, 1024, 14, 14),
               "stage4": (256, 2048, 7, 7), "narrow": (2, 12, 9, 7)}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def _close(what, got, want, dtype, mag=None, failures=None):
    """|got - want| within ``bn_bound``: 1e-5 of mag (the tensor's largest
    |want| unless given), plus one bf16 ulp of want for a bf16 output."""
    ratio = ((got.double() - want.double()).abs()
             / bn_bound(dtype, want, mag)).max().item()
    print(f"{what}: err/bound {ratio:.3f}")
    if not (torch.isfinite(got).all() and ratio <= 1.0):
        failures.append(f"{what}: err/bound {ratio:.3f}")


def _run_kernels(x, dy, v, training, relu):
    """(y, dx, dscale, dbias, mean, var) through the kernels."""
    scale = v["scale"].clone().requires_grad_()
    bias = v["bias"].clone().requires_grad_()
    mean, var = v["mean"].clone(), v["var"].clone()
    xg = x.clone().requires_grad_()
    y = bn.batch_norm(xg, scale, bias, mean, var, training, relu)
    grads = torch.autograd.grad(y, (xg, scale, bias), dy)
    return (y.detach(), *grads, mean, var)


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "norm"])
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
def test_kernels_match_plain(shape, dtype, training, relu):
    _card()
    x, dy, v = _inputs(CARD_SHAPES[shape], dtype, seed=3, device="cuda",
                       constant=0.0)
    assert x.is_contiguous(memory_format=torch.channels_last)
    # the plain version in f32 on the same values
    xf = x.to(torch.float32, copy=True).requires_grad_()
    scale = v["scale"].clone().requires_grad_()
    bias = v["bias"].clone().requires_grad_()
    mean, var = v["mean"].clone(), v["var"].clone()
    y_ref = bn._plain(xf, scale, bias, mean, var, training, relu)
    if relu:  # no gradient where the two sides may disagree on the mask
        edge = y_ref.detach().abs() < 1e-3 * y_ref.detach().abs().max()
        dy = dy.masked_fill(edge, 0)
    want = torch.autograd.grad(y_ref, (xf, scale, bias), dy.float())
    bn.reset_launches()
    y, dx, dscale, dbias, r_mean, r_var = _run_kernels(x, dy, v, training,
                                                       relu)
    torch.cuda.synchronize()
    assert bn.LAUNCHES == {"train": int(training), "eval": int(not training),
                           "backward": 1}
    assert y.dtype == dx.dtype == dtype
    assert y.is_contiguous(memory_format=torch.channels_last)

    d = dy.float()
    if relu:
        d = d * (y_ref.detach() > 0)
    m_ref = mean if not training else xf.detach().mean((0, 2, 3))
    rstd = torch.rsqrt((var if not training else torch.clamp(
        (xf.detach() ** 2).mean((0, 2, 3)) - m_ref ** 2, min=0)) + 1e-5)
    xhat = (xf.detach() - m_ref[:, None, None]) * rstd[:, None, None]
    failures = []
    _close("y", y, y_ref.detach(), dtype, failures=failures)
    _close("dx", dx, want[0], dtype, failures=failures)
    _close("dscale", dscale, want[1], torch.float32,
           (d * xhat).abs().sum((0, 2, 3)), failures)
    _close("dbias", dbias, want[2], torch.float32, d.abs().sum((0, 2, 3)),
           failures)
    _close("running mean", r_mean, mean, torch.float32, failures=failures)
    _close("running var", r_var, var, torch.float32, failures=failures)
    assert not failures, failures


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_two_runs_equal_to_the_bit(dtype):
    _card()
    x, dy, v = _inputs(CARD_SHAPES["stem"], dtype, seed=4, device="cuda",
                       constant=0.0)
    first = _run_kernels(x, dy, v, True, True)
    second = _run_kernels(x, dy, v, True, True)
    for what, a, b in zip(("y", "dx", "dscale", "dbias", "mean", "var"),
                          first, second):
        assert torch.equal(a, b), what


@pytest.mark.cuda
def test_refuses_an_nchw_tensor_on_the_card():
    _card()
    x, _, v = _inputs((2, 16, 5, 5), torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="channels_last"):
        bn.batch_norm(x.contiguous(), v["scale"], v["bias"], v["mean"],
                      v["var"], True)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        bn.batch_norm(x.half(), v["scale"], v["bias"], v["mean"], v["var"],
                      True)
