"""UNet building blocks (NCHW nn.Modules with the reference's parameter names).

Counterpart of `unet_goolenet_tpu/nn/blocks.py:70-125,203-251` (reference
分割/nets/basicUnet.py). Submodule names follow the reference, so a reference
state dict loads with `load_state_dict`: `conv`/`norm` inside ConvBatchNorm,
`nConvs.<i>` for the conv stacks, `cca.conv1_e.0`, `cca.fc_avg_max_sfot`.
CoordAtt3's never-called DeformConv2d is not declared (its keys are dropped
on load, models/convert.py).

BatchNorm in train mode is flax's (`batch_norm_train`), which is what the
JAX package trains with: momentum 0.9, eps 1e-5, float32 statistics, and
the running variance updated with the biased batch variance. torch's
BatchNorm2d would update it with the unbiased one (n/(n-1) larger), as the
original torch reference did. In eval mode the running statistics
normalise, as in BatchNorm2d.

`kernels=True` (off by default, as the JAX package's dispatch is) runs the
blocks on the CUDA kernels of `ops/kernels/conv.py`, with the same
parameters: in train mode each 3x3 conv that feeds a BatchNorm is
`conv3x3(x, w, None, b, relu=False)` (no scale), followed by `batch_norm_train` and relu
in torch; the transposed convs run `deconv` and the pools `pool2x2`. In
eval mode a ConvBatchNorm is `fused_conv3x3` with BatchNorm folded into its
scale and bias and relu, and a two-block conv stack is `fused_convstack2`.
A CUDA tensor launches the kernels or raises; a CPU tensor takes their
plain versions. Under CUDA autocast (the trainer's `--bf16`) the kernels
run in the autocast dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from unet_goolenet_tpu_torch.ops.kernels import conv as K
from unet_goolenet_tpu_torch.ops.pool import max_pool2d_nchw

MOMENTUM = 0.9   # flax: running = momentum * running + (1 - momentum) * batch
EPS = 1e-5


def batch_norm_train(y: torch.Tensor, norm: nn.BatchNorm2d) -> torch.Tensor:
    """flax.linen.BatchNorm in train mode on NCHW y: batch statistics in
    float32 (the "fast" variance E[y^2] - E[y]^2, clipped at 0),
    (y - mean) * rsqrt(var + eps) * weight + bias in float32, cast back to
    y's dtype; the running statistics advance with momentum 0.9 and the
    biased variance."""
    y32 = y.to(torch.promote_types(y.dtype, torch.float32))
    dims = (0, 2, 3)
    mean = y32.mean(dim=dims)
    var = ((y32 * y32).mean(dim=dims) - mean * mean).clamp_min(0.0)
    mul = torch.rsqrt(var + EPS) * norm.weight
    out = (y32 - mean[:, None, None]) * mul[:, None, None] + norm.bias[:, None, None]
    with torch.no_grad():
        norm.running_mean.mul_(MOMENTUM).add_(mean, alpha=1 - MOMENTUM)
        norm.running_var.mul_(MOMENTUM).add_(var, alpha=1 - MOMENTUM)
        norm.num_batches_tracked += 1
    return out.to(y.dtype)


def folded_scale_bias(conv: nn.Conv2d, norm: nn.BatchNorm2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode BatchNorm after a conv as the conv epilogue's (scale, bias):
    BN(conv(x) + b) = conv(x) * scale + bias."""
    scale = norm.weight * torch.rsqrt(norm.running_var + norm.eps)
    b = conv.bias if conv.bias is not None else torch.zeros_like(norm.running_mean)
    return scale, (b - norm.running_mean) * scale + norm.bias


def compute_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype the kernels run in: autocast's when it is on for x's
    device, else x's."""
    dev = x.device.type
    if dev == "cuda" and torch.is_autocast_enabled(dev):
        return torch.get_autocast_dtype(dev)
    return x.dtype


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW (channels_last memory) -> contiguous NHWC in the compute dtype."""
    return x.permute(0, 2, 3, 1).to(compute_dtype(x)).contiguous()


def nchw(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 3, 1, 2)


def conv_bn_relu(conv: nn.Conv2d, norm: nn.BatchNorm2d, x: torch.Tensor,
                 kernels: bool) -> torch.Tensor:
    """relu(BN(conv3x3(x))) in the module's mode, on the kernels or not."""
    if not kernels:
        y = conv(x)
        return torch.relu(batch_norm_train(y, norm) if norm.training else norm(y))
    xh = nhwc(x)
    if norm.training:
        y = K.conv3x3(xh, conv.weight, None, conv.bias, False)
        return torch.relu(batch_norm_train(nchw(y), norm))
    return nchw(K.conv3x3(xh, conv.weight, *folded_scale_bias(conv, norm), True))


class ConvBatchNorm(nn.Module):
    """conv3x3 (pad 1) -> BatchNorm (eps 1e-5) -> ReLU (basicUnet.py:25-40)."""

    def __init__(self, cin: int, cout: int, kernels: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm = nn.BatchNorm2d(cout)
        self.kernels = kernels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_bn_relu(self.conv, self.norm, x, self.kernels)


class ConvStack(nn.Sequential):
    """n ConvBatchNorm blocks (_make_nConv, basicUnet.py:17-23). With the
    kernels in eval mode, a pair runs as one `fused_convstack2`."""

    def __init__(self, cin: int, cout: int, n: int = 2, kernels: bool = False):
        super().__init__(*[ConvBatchNorm(cin if i == 0 else cout, cout, kernels)
                           for i in range(n)])
        self.kernels = kernels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.kernels and len(self) == 2 and not self.training):
            return super().forward(x)
        a, b = self[0], self[1]
        y = K.fused_convstack2(nhwc(x), a.conv.weight, *folded_scale_bias(a.conv, a.norm),
                               b.conv.weight, *folded_scale_bias(b.conv, b.norm))
        return nchw(y)


class DownBlock(nn.Module):
    """maxpool 2x2 then two ConvBatchNorm (basicUnet.py:42-52)."""

    def __init__(self, cin: int, cout: int, kernels: bool = False):
        super().__init__()
        self.nConvs = ConvStack(cin, cout, kernels=kernels)
        self.kernels = kernels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = nchw(K.pool2x2(nhwc(x))) if self.kernels else max_pool2d_nchw(x, 2)
        return self.nConvs(x)


class CoordAtt3(nn.Module):
    """Skip gate of the flagship model (basicUnet.py:201-231):
    out = CBN(e) + sigmoid(fc(relu(fc_a(GAP)) + relu(fc_m(GMP)))) * CBN(d) + CBN(d)."""

    def __init__(self, c: int, kernels: bool = False):
        super().__init__()
        self.conv1_e = ConvStack(c, c, 1, kernels)
        self.conv2_e = ConvStack(c, c, 1, kernels)
        self.fc_avg = nn.Conv2d(c, c // 2, 1)
        self.fc_max = nn.Conv2d(c, c // 2, 1)
        self.fc_avg_max_sfot = nn.Conv2d(c // 2, c, 1)

    def forward(self, e: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
        e1 = self.conv1_e(e)
        avg = e1.mean(dim=(2, 3), keepdim=True)
        mx = e1.amax(dim=(2, 3), keepdim=True)
        s = torch.relu(self.fc_avg(avg)) + torch.relu(self.fc_max(mx))
        s = torch.sigmoid(self.fc_avg_max_sfot(s))
        d2 = self.conv2_e(d)
        return e1 + s * d2 + d2


class UpBlockAlig(nn.Module):
    """ConvTranspose 2x2/s2, CoordAtt3-gated skip, concat, two ConvBatchNorm
    (basicUnet.py:115-129)."""

    def __init__(self, cin: int, cout: int, kernels: bool = False):
        super().__init__()
        self.up = nn.ConvTranspose2d(cin, cin, 2, stride=2)
        self.cca = CoordAtt3(cin, kernels)
        self.nConvs = ConvStack(2 * cin, cout, kernels=kernels)
        self.kernels = kernels

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        if self.kernels:
            up = nchw(K.deconv(nhwc(x), self.up.weight, self.up.bias))
        else:
            up = self.up(x)
        return self.nConvs(torch.cat([up, self.cca(skip, up)], dim=1))
