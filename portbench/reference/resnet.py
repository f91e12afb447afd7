"""Plain ResNet (He et al. 2016, arXiv:1512.03385, Table 1) with bottleneck
blocks: the network of ``configs/resnet50`` in f32, written from the
paper.

Stem: 7x7/2 convolution (64), batch norm, ReLU, 3x3/2 max-pool; stages
of bottleneck blocks (1x1, 3x3, 1x1 x expansion) with a projection
shortcut where the shape changes; global average pool; a fully
connected layer of ``num_classes``; cross-entropy. Batch norm in train
mode normalises by the batch's mean and biased variance. What the
configuration states beyond the paper: the stride of a downsampling
block on its 3x3 convolution (``stride_in_bottleneck``, "v1.5"), and
SAME padding (XLA's: an uneven pad puts the odd pixel on the high side;
the stem pads 3 on each side).

The parameter names are the port's state_dict (``blocks.<i>.conv_0``,
``bn_0``, ``conv_proj``, ``norm_proj``, ``head.kernel`` [in, out]).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference import operand


def _blocks(cfg):
    """[(name prefix, in channels, filters, stride, has projection)]."""
    out, cin, i = [], cfg["num_filters"], 0
    for stage, n in enumerate(cfg["stage_sizes"]):
        filters = cfg["num_filters"] * 2 ** stage
        for j in range(n):
            stride = 2 if stage > 0 and j == 0 else 1
            proj = stride != 1 or cin != filters * cfg["expansion"]
            out.append((f"blocks.{i}.", cin, filters, stride, proj))
            cin, i = filters * cfg["expansion"], i + 1
    return out, cin


def _conv_spec(name, cout, cin, k):
    return (name, (cout, cin, k, k),
            ("normal", math.sqrt(2.0 / (cin * k * k))))


def _bn_specs(name, c):
    return [(name + ".scale", (c,), ("ones",)),
            (name + ".bias", (c,), ("zeros",))]


def specs(cfg) -> list:
    """[(name, shape, init)]: He initialisation N(0, 2 / fan_in) for every
    convolution (the paper's [13]), batch norm scale 1 and bias 0 but for
    the last norm of each block, whose scale starts at 0 where the
    configuration says so (``zero_init_last_bn_scale``: Goyal et al. 2017,
    and the port's own ResNet), the head N(0, 1 / fan_in) with bias 0."""
    nf, e = cfg["num_filters"], cfg["expansion"]
    last = ("zeros",) if cfg["zero_init_last_bn_scale"] else ("ones",)
    out = [_conv_spec("conv_init.weight", nf, 3, 7), *_bn_specs("bn_init", nf)]
    blocks, cout = _blocks(cfg)
    for p, cin, f, _, proj in blocks:
        out += [_conv_spec(p + "conv_0.weight", f, cin, 1),
                *_bn_specs(p + "bn_0", f),
                _conv_spec(p + "conv_1.weight", f, f, 3),
                *_bn_specs(p + "bn_1", f),
                _conv_spec(p + "conv_2.weight", f * e, f, 1),
                (p + "bn_2.scale", (f * e,), last),
                (p + "bn_2.bias", (f * e,), ("zeros",))]
        if proj:
            out += [_conv_spec(p + "conv_proj.weight", f * e, cin, 1),
                    *_bn_specs(p + "norm_proj", f * e)]
    out += [("head.kernel", (cout, cfg["num_classes"]),
             ("normal", 1.0 / math.sqrt(cout))),
            ("head.bias", (cfg["num_classes"],), ("zeros",))]
    return out


def _same(size, k, stride):
    total = max((math.ceil(size / stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x, k, stride, value=0.0):
    ph, pw = _same(x.shape[2], k, stride), _same(x.shape[3], k, stride)
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value)


def loss(w: dict, batch, cfg, fp8: bool = False):
    """Mean cross-entropy of ``batch`` (images [n, 3, h, w], labels [n])."""
    images, labels = batch
    eps = cfg["bn_eps"]

    def conv(x, name, k, stride, pad=None):
        x = _pad_same(x, k, stride) if pad is None else x
        return F.conv2d(operand(x, fp8), operand(w[name + ".weight"], fp8),
                        stride=stride, padding=0 if pad is None else pad)

    def bn(x, name):
        mean = x.mean((0, 2, 3), keepdim=True)
        var = (x - mean).square().mean((0, 2, 3), keepdim=True)
        scale = w[name + ".scale"][:, None, None]
        return (x - mean) * torch.rsqrt(var + eps) * scale \
            + w[name + ".bias"][:, None, None]

    x = F.relu(bn(conv(images, "conv_init", 7, 2, pad=3), "bn_init"))
    x = F.max_pool2d(_pad_same(x, 3, 2, float("-inf")), 3, 2)
    for p, _, _, stride, proj in _blocks(cfg)[0]:
        y = F.relu(bn(conv(x, p + "conv_0", 1, 1), p + "bn_0"))
        y = F.relu(bn(conv(y, p + "conv_1", 3, stride), p + "bn_1"))
        y = bn(conv(y, p + "conv_2", 1, 1), p + "bn_2")
        if proj:
            x = bn(conv(x, p + "conv_proj", 1, stride), p + "norm_proj")
        x = F.relu(x + y)
    logits = operand(x.mean((2, 3)), fp8) @ operand(w["head.kernel"], fp8) \
        + w["head.bias"]
    return F.cross_entropy(logits, labels)


def forward_macs(cfg) -> int:
    """Multiply-adds of one image's forward pass: every convolution and
    the fully connected layer, from the layer shapes."""
    hw = cfg["image_size"]

    def out_size(size, stride):
        return math.ceil(size / stride)

    hw = out_size(hw, 2)
    macs = hw * hw * cfg["num_filters"] * 3 * 7 * 7
    hw = out_size(hw, 2)  # max-pool
    blocks, cout = _blocks(cfg)
    e = cfg["expansion"]
    for _, cin, f, stride, proj in blocks:
        macs += hw * hw * cin * f  # conv_0 1x1 at the input's size
        hw_out = out_size(hw, stride)
        macs += hw_out * hw_out * f * f * 9  # conv_1 3x3, strided
        macs += hw_out * hw_out * f * f * e  # conv_2 1x1
        if proj:
            macs += hw_out * hw_out * cin * f * e
        hw = hw_out
    return macs + cout * cfg["num_classes"]


def train_flops(cfg, traffic) -> float:
    """Model operations of one training step: 3 x the forward's
    multiply-adds x 2 a image, times the batch."""
    return 3 * 2 * forward_macs(cfg) * traffic["batch"]
