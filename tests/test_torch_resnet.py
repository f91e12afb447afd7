"""The port's image models (ResNet, VGG, MLP) against the flax modules on
the same weights and inputs.

The flax variables have the shapes ``init`` gives and seeded values:
kernels from N(0, 1 / fan_in), every BatchNorm scale from U(0.5, 1.5),
every bias from N(0, 0.1) and the running statistics from N(0, 0.1)
(mean) and U(0.5, 1.5) (var), so that the residual branches (whose last
norm starts at scale 0 in ``init``) and eval mode's running averages
change the logits. NHWC images from ``default_rng`` go
to flax as they are and to the port transposed to NCHW.

Tolerances. The truth is the flax module in float64 (``jax.enable_x64``;
the f32 heads stay f32 on both sides):

- the port in float64 equals it: the logits to rtol 1e-5, atol 1e-5
  (the f32 heads sum up to 2048 f32 products in two orders, ~1e-6 of
  logits of order 1), the running statistics to rtol 1e-6, atol 1e-6
  (the port's buffers are f32). This is the check of the arithmetic, and
  it is tight whatever the conditioning;
- in f32 and bf16 the port may be at most twice as far from the truth as
  the flax module in the same dtype is (max over the logits, and over
  the elements of all batch_stats leaves together: the maximum over a
  leaf of 8 channels is too noisy to stand for a rounding error; 0.8-1.05
  of the reference's is seen), plus 1e-6: the two round at different points
  (summation order; where XLA fuses what PyTorch rounds), each by about
  its own rounding error. A bf16 port that computed in a lower precision,
  or an f32 one that computed in bf16, fails it. Train-mode BatchNorm on
  2 images of 32 x 32 normalises ResNet-50's last stage over 2 values a
  channel, where E[x^2] - E[x]^2 cancels: there both dtypes are far from
  the truth (flax's f32 logits by ~1.5), and the bound follows.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn

from byteps_tpu.models import mlp as fmlp
from byteps_tpu.models import resnet as fresnet
from byteps_tpu.models import vgg as fvgg
from byteps_tpu_torch.models import mlp, resnet, vgg

DTYPES = ("float32", "bfloat16")
RESNETS = {"resnet18_narrow": ("ResNet18", 8), "resnet50": ("ResNet50", 64)}


@pytest.fixture(autouse=True)
def _one_thread():
    # one intra-op thread: the other test workers need the cores more
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _variables(module, x, seed, **kw):
    """The flax module's variable tree (shapes by ``jax.eval_shape`` of
    its ``init``), drawn from ``default_rng(seed)``: kernels from
    N(0, 1 / fan_in), BatchNorm scales and running variances from
    U(0.5, 1.5), biases and running means from N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                jnp.asarray(x), **kw))

    def draw(path, leaf):
        name, shape = jax.tree_util.keystr(path[-1:]), leaf.shape
        if "kernel" in name:
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif "scale" in name or "var" in name:
            a = rng.uniform(0.5, 1.5, shape)
        else:
            a = 0.1 * rng.standard_normal(shape)
        return np.asarray(a, np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _images(n, size, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, size, size, 3)).astype(np.float32)


def _flax_run(make, variables, x, dtype, train=None):
    """(logits, new batch_stats or None) of the flax module in ``dtype``
    (float64 under ``jax.enable_x64``)."""
    with jax.enable_x64(dtype == "float64"):
        module = make(getattr(jnp, dtype))
        xj = jnp.asarray(x, getattr(jnp, dtype) if dtype == "float64"
                         else jnp.float32)
        if train is None:
            out = jax.jit(module.apply)(variables, xj)
            return np.asarray(out, np.float64), None
        if not train:
            out = jax.jit(partial(module.apply, train=False))(variables, xj)
            return np.asarray(out, np.float64), None
        out, state = jax.jit(partial(module.apply, train=True,
                                     mutable=["batch_stats"]))(variables, xj)
        return (np.asarray(out, np.float64),
                jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                       state["batch_stats"]))


def _port_run(model, x, train, nchw=True):
    """(logits, state_dict) of the port after one forward under no_grad."""
    model.train(bool(train))
    xt = torch.from_numpy(x)
    if nchw:
        xt = xt.permute(0, 3, 1, 2)
    with torch.no_grad():
        out = model(xt)
    return (out.double().numpy(),
            {k: v.double().numpy() for k, v in model.state_dict().items()})


def _within_reference_error(label, got, want, truth):
    """max |got - truth| <= 2 max |want - truth| + 1e-6."""
    ref = np.abs(want - truth).max()
    err = np.abs(got - truth).max()
    assert err <= 2 * ref + 1e-6, (label, err, ref)
    return err, ref


def _resnet_variables(name, filters):
    module = getattr(fresnet, name)(num_classes=10, num_filters=filters)
    return _variables(module, _images(1, 32), 1, train=False)


@pytest.fixture(scope="module")
def resnet_variables():
    return {label: _resnet_variables(*spec)
            for label, spec in RESNETS.items()}


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("label", sorted(RESNETS))
def test_resnet_matches_flax(label, train, resnet_variables):
    name, filters = RESNETS[label]
    variables = resnet_variables[label]
    sd = resnet.from_flax(variables["params"], variables["batch_stats"])
    x = _images(2, 32)

    def flax_make(dtype):
        return getattr(fresnet, name)(num_classes=10, num_filters=filters,
                                      dtype=dtype)

    def port(dtype):
        model = getattr(resnet, name)(num_classes=10, num_filters=filters,
                                      dtype=getattr(torch, dtype),
                                      device="cpu")
        model.load_state_dict(sd)
        return _port_run(model, x, train)

    truth, truth_stats = _flax_run(flax_make, variables, x, "float64", train)
    got, got_sd = port("float64")
    np.testing.assert_allclose(got, truth, rtol=1e-5, atol=1e-5)
    want_stats = resnet.from_flax({}, truth_stats) if train else {}
    for k, v in want_stats.items():
        np.testing.assert_allclose(got_sd[k], v.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    truth_stats = {k: v.numpy() for k, v in want_stats.items()}

    for dtype in DTYPES:
        want, stats = _flax_run(flax_make, variables, x, dtype, train)
        got, got_sd = port(dtype)
        assert np.isfinite(got).all()
        _within_reference_error(f"{label} {dtype} logits", got, want, truth)
        if train:
            stats = resnet.from_flax({}, stats)
            assert len(stats) == 2 * sum(
                isinstance(m, resnet.BatchNorm) for m in
                getattr(resnet, name)(num_filters=filters,
                                      device="cpu").modules())
            keys = sorted(stats)
            _within_reference_error(
                f"{label} {dtype} batch_stats",
                np.concatenate([got_sd[k] for k in keys]),
                np.concatenate([stats[k].numpy() for k in keys]),
                np.concatenate([truth_stats[k] for k in keys]))


@pytest.mark.parametrize("size", [7, 8])
def test_same_padding_matches_flax(size):
    """SAME for a 3x3 stride-2 window pads (0, 1) on an even input and
    (1, 1) on an odd one; torch's symmetric ``padding=1`` shifts the even
    case's windows by a pixel."""
    x = _images(2, size, seed=3)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    want_pool = np.asarray(fnn.max_pool(jnp.asarray(x), (3, 3), (2, 2),
                                        padding="SAME"))
    xp, pad = resnet._same(xt, 3, 2, float("-inf"))
    got_pool = F.max_pool2d(xp, 3, 2, padding=pad).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got_pool.numpy(), want_pool)

    conv = fnn.Conv(4, (3, 3), (2, 2), use_bias=False)
    params = jax.tree_util.tree_map(np.asarray, conv.init(
        jax.random.PRNGKey(0), jnp.asarray(x)))
    want_conv = np.asarray(conv.apply(params, jnp.asarray(x)))
    port = resnet.Conv(3, 4, 3, 2, torch.float32, torch.Generator())
    port.load_state_dict(resnet.flax_state_dict(
        (params["params"],), lambda k: k))
    got_conv = port(xt).detach().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got_conv, want_conv, rtol=1e-5, atol=1e-6)

    naive = F.conv2d(xt, port.weight, stride=2, padding=1)
    moved = np.abs(naive.detach().permute(0, 2, 3, 1).numpy()
                   - want_conv).max()
    assert (moved > 1e-2) == (size % 2 == 0), moved


def test_resnet_odd_input_matches_flax(resnet_variables):
    """33 x 33: every SAME split is even down the network, so each pad is
    symmetric (the 32 x 32 cases take the uneven ones)."""
    variables = resnet_variables["resnet18_narrow"]
    x = _images(2, 33, seed=4)
    for train in (True, False):
        model = resnet.ResNet18(num_classes=10, num_filters=8,
                                dtype=torch.float32, device="cpu")
        model.load_state_dict(resnet.from_flax(variables))
        want, _ = _flax_run(lambda d: fresnet.ResNet18(
            num_classes=10, num_filters=8, dtype=d), variables, x,
            "float32", train)
        got, _ = _port_run(model, x, train)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("size", [32, 64])
def test_vgg16_matches_flax(size):
    """At 64 x 64 the last feature map is 2 x 2, so fc1's (h, w, c) row
    order matters (at 32 x 32 it is 1 x 1)."""
    x = _images(2, size, seed=5)
    variables = _variables(fvgg.VGG16(num_classes=10), x, 2)
    sd = vgg.from_flax(variables)

    def flax_make(dtype):
        return fvgg.VGG16(num_classes=10, dtype=dtype)

    def port(dtype):
        model = vgg.VGG16(num_classes=10, dtype=getattr(torch, dtype),
                          image_size=size, device="cpu")
        model.load_state_dict(sd)
        return _port_run(model, x, True)[0]

    truth, _ = _flax_run(flax_make, variables, x, "float64")
    np.testing.assert_allclose(port("float64"), truth, rtol=1e-6, atol=1e-6)
    for dtype in DTYPES:
        want, _ = _flax_run(flax_make, variables, x, dtype)
        _within_reference_error(f"vgg16 {size} {dtype}", port(dtype), want,
                                truth)


def test_mlp_matches_flax():
    x = _images(4, 8, seed=6)
    variables = _variables(fmlp.MLP(features=(32, 16, 10)), x, 3)
    sd = mlp.from_flax(variables)

    def flax_make(dtype):
        return fmlp.MLP(features=(32, 16, 10), dtype=dtype)

    def port(dtype):
        model = mlp.MLP(8 * 8 * 3, (32, 16, 10), dtype=getattr(torch, dtype),
                        device="cpu")
        model.load_state_dict(sd)
        return _port_run(model, x, True, nchw=False)[0]

    truth, _ = _flax_run(flax_make, variables, x, "float64")
    np.testing.assert_allclose(port("float64"), truth, rtol=1e-12)
    for dtype in DTYPES:
        want, _ = _flax_run(flax_make, variables, x, dtype)
        _within_reference_error(f"mlp {dtype}", port(dtype), want, truth)


def test_from_flax_names_every_parameter_and_buffer(resnet_variables):
    for label, (name, filters) in RESNETS.items():
        variables = resnet_variables[label]
        sd = resnet.from_flax(variables["params"], variables["batch_stats"])
        model = getattr(resnet, name)(num_classes=10, num_filters=filters,
                                      device="cpu")
        want = model.state_dict()
        assert set(sd) == set(want), set(sd) ^ set(want)
        for k, v in sd.items():
            assert want[k].shape == v.shape, k
        assert model.conv_init.weight.is_contiguous(
            memory_format=torch.channels_last)
    r50 = resnet.ResNet50(device="cpu")
    n_bn = sum(isinstance(m, resnet.BatchNorm) for m in r50.modules())
    assert (len(list(r50.parameters())), 2 * n_bn) == (161, 106)
    sd = resnet.from_flax(resnet_variables["resnet18_narrow"])
    assert sd["blocks.0.conv_0.weight"].shape == (8, 8, 3, 3)  # OIHW

    sd = vgg.from_flax(_variables(fvgg.VGG16(num_classes=10), _images(1, 64),
                                  0))
    assert set(sd) == set(vgg.VGG16(num_classes=10, image_size=64,
                                    device="cpu").state_dict())
    assert sd["fc1.kernel"].shape == (2 * 2 * 512, 4096)


def test_image_models_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (resnet.ResNet18, vgg.VGG16, lambda: mlp.MLP(4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
