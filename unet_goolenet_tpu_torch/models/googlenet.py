"""GoogLeNet / Inception-v1, the stage-2 grader (分类/ROI_main.py:86-95).

Counterpart of `unet_goolenet_tpu/models/googlenet.py:116-195`, in the
torchvision flavour the reference wraps, with torchvision's parameter names
under the reference's `googlenet.` prefix:
  * BasicConv2d = conv (no bias) + BatchNorm (eps 1e-3) + ReLU; in train
    mode the BatchNorm is flax's, as the JAX model trains it
    (nn/blocks.py:batch_norm_train: biased variance, momentum 0.9);
  * the "5x5" inception branch uses a 3x3 kernel (torchvision's historical
    quirk, kept for weight compatibility);
  * transform_input re-normalises [0, 1]-mean-0.5 inputs to ImageNet stats;
  * every max pool is ceil mode with the JAX package's rule (ops/pool.py);
  * aux heads (`aux_logits`) are off by default, as in the reference. On,
    `googlenet.aux1` (after 4a) and `googlenet.aux2` (after 4d) are
    torchvision's InceptionAux: adaptive average pool to 4x4, `conv` (a
    BasicConv2d to 128 channels), `fc1` 2048 -> 1024, relu, dropout 0.7,
    `fc2`. Its flatten is the JAX package's, (h, w, c) order, not
    torchvision's (c, h, w): the JAX converter carries `fc1.weight` across
    untouched but for the transpose, so one state dict computes one head
    in both packages only in that order. In train mode the model then
    returns (logits, aux2, aux1), in eval mode the logits alone.
Dropout draws its masks from the `generator` forward is given (torch's
default generator without one), as the JAX step threads its dropout key.
forward takes NHWC like the JAX model.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from unet_goolenet_tpu_torch.nn.blocks import batch_norm_train
from unet_goolenet_tpu_torch.ops.pool import adaptive_avg_pool, max_pool2d_nchw

INCEPTION_CFG = {
    # name: (cin, ch1x1, ch3x3red, ch3x3, ch5x5red, ch5x5, pool_proj)
    "inception3a": (192, 64, 96, 128, 16, 32, 32),
    "inception3b": (256, 128, 128, 192, 32, 96, 64),
    "inception4a": (480, 192, 96, 208, 16, 48, 64),
    "inception4b": (512, 160, 112, 224, 24, 64, 64),
    "inception4c": (512, 128, 128, 256, 24, 64, 64),
    "inception4d": (512, 112, 144, 288, 32, 64, 64),
    "inception4e": (528, 256, 160, 320, 32, 128, 128),
    "inception5a": (832, 256, 160, 320, 32, 128, 128),
    "inception5b": (832, 384, 192, 384, 48, 128, 128),
}


class MaxPoolCeil(nn.Module):
    """Parameterless ceil-mode max pool (JAX package rule) on NCHW."""

    def __init__(self, window: int, stride: int, padding: int = 0):
        super().__init__()
        self.window, self.stride, self.padding = window, stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool2d_nchw(x, self.window, self.stride, padding=self.padding,
                               ceil_mode=True)


class BasicConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 1, stride: int = 1,
                 padding: int = 0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding,
                              bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        return torch.relu(batch_norm_train(y, self.bn) if self.bn.training else self.bn(y))


class Inception(nn.Module):
    def __init__(self, cin, ch1x1, ch3x3red, ch3x3, ch5x5red, ch5x5, pool_proj):
        super().__init__()
        self.branch1 = BasicConv2d(cin, ch1x1)
        self.branch2 = nn.Sequential(BasicConv2d(cin, ch3x3red),
                                     BasicConv2d(ch3x3red, ch3x3, 3, padding=1))
        self.branch3 = nn.Sequential(BasicConv2d(cin, ch5x5red),
                                     BasicConv2d(ch5x5red, ch5x5, 3, padding=1))
        self.branch4 = nn.Sequential(MaxPoolCeil(3, 1, 1), BasicConv2d(cin, pool_proj))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.branch1(x), self.branch2(x), self.branch3(x),
                          self.branch4(x)], dim=1)


def transform_input(x: torch.Tensor, dim: int) -> torch.Tensor:
    """torchvision's renormalisation for pretrained GoogLeNet; `dim` is the
    channel axis."""
    r, g, b = x.unbind(dim)
    return torch.stack([r * (0.229 / 0.5) + (0.485 - 0.5) / 0.5,
                        g * (0.224 / 0.5) + (0.456 - 0.5) / 0.5,
                        b * (0.225 / 0.5) + (0.406 - 0.5) / 0.5], dim=dim)


class Dropout(nn.Dropout):
    """nn.Dropout whose mask comes from a given generator: flax's rule,
    keep with probability 1 - p and scale the kept values by 1 / (1 - p)."""

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = torch.empty_like(x).bernoulli_(1.0 - self.p, generator=generator)
        return x * keep / (1.0 - self.p)


class InceptionAux(nn.Module):
    """torchvision's aux head, flattened in (h, w, c) order as the JAX
    package's (module docstring)."""

    def __init__(self, cin: int, num_classes: int):
        super().__init__()
        self.conv = BasicConv2d(cin, 128)
        self.fc1 = nn.Linear(2048, 1024)
        self.dropout = Dropout(0.7)
        self.fc2 = nn.Linear(1024, num_classes)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = adaptive_avg_pool(x.permute(0, 2, 3, 1), (4, 4)).permute(0, 3, 1, 2)
        x = self.conv(x).permute(0, 2, 3, 1).flatten(1)
        return self.fc2(self.dropout(torch.relu(self.fc1(x)), generator))


class GoogLeNet(nn.Module):
    def __init__(self, num_classes: int = 1000, aux_logits: bool = False):
        super().__init__()
        self.conv1 = BasicConv2d(3, 64, 7, stride=2, padding=3)
        self.maxpool1 = MaxPoolCeil(3, 2)
        self.conv2 = BasicConv2d(64, 64)
        self.conv3 = BasicConv2d(64, 192, 3, padding=1)
        self.maxpool2 = MaxPoolCeil(3, 2)
        for name, cfg in INCEPTION_CFG.items():
            setattr(self, name, Inception(*cfg))
        self.maxpool3 = MaxPoolCeil(3, 2)
        self.maxpool4 = MaxPoolCeil(2, 2)
        self.aux1 = InceptionAux(512, num_classes) if aux_logits else None
        self.aux2 = InceptionAux(528, num_classes) if aux_logits else None
        self.dropout = Dropout(0.2)
        self.fc = nn.Linear(1024, num_classes)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        """(N, C, H, W) in [0, 1] -> (N, num_classes) logits; in train mode
        with aux heads, (logits, aux2, aux1)."""
        x = transform_input(x, dim=1)
        x = self.maxpool1(self.conv1(x))
        x = self.maxpool2(self.conv3(self.conv2(x)))
        x = self.maxpool3(self.inception3b(self.inception3a(x)))
        x = self.inception4a(x)
        aux = self.aux1 is not None and self.training
        aux1 = self.aux1(x, generator) if aux else None
        x = self.inception4d(self.inception4c(self.inception4b(x)))
        aux2 = self.aux2(x, generator) if aux else None
        x = self.maxpool4(self.inception4e(x))
        x = self.inception5b(self.inception5a(x))
        logits = self.fc(self.dropout(x.mean(dim=(2, 3)), generator))
        return (logits, aux2, aux1) if aux else logits


class GoogLeNetClassifier(nn.Module):
    """The reference's stage-2 model: GoogLeNet with a num_classes-way fc;
    `aux_logits` adds the aux heads (off, as in the reference)."""

    def __init__(self, num_classes: int = 6, aux_logits: bool = False):
        super().__init__()
        self.googlenet = GoogLeNet(num_classes, aux_logits)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        """(N, H, W, 3) NHWC -> (N, num_classes) logits (train mode with aux
        heads: (logits, aux2, aux1)); dropout draws from `generator`."""
        return self.googlenet(x.permute(0, 3, 1, 2), generator)
