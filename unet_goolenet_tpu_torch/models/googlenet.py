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
  * aux heads are off, as in the reference.
forward takes NHWC like the JAX model.
"""

from __future__ import annotations

import torch
from torch import nn

from unet_goolenet_tpu_torch.nn.blocks import batch_norm_train
from unet_goolenet_tpu_torch.ops.pool import max_pool2d_nchw

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


class GoogLeNet(nn.Module):
    def __init__(self, num_classes: int = 1000):
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
        self.dropout = nn.Dropout(0.2)
        self.fc = nn.Linear(1024, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, C, H, W) in [0, 1] -> (N, num_classes) logits."""
        x = transform_input(x, dim=1)
        x = self.maxpool1(self.conv1(x))
        x = self.maxpool2(self.conv3(self.conv2(x)))
        x = self.maxpool3(self.inception3b(self.inception3a(x)))
        for name in ("inception4a", "inception4b", "inception4c", "inception4d",
                     "inception4e"):
            x = getattr(self, name)(x)
        x = self.maxpool4(x)
        x = self.inception5b(self.inception5a(x))
        return self.fc(self.dropout(x.mean(dim=(2, 3))))


class GoogLeNetClassifier(nn.Module):
    """The reference's stage-2 model: GoogLeNet with a num_classes-way fc."""

    def __init__(self, num_classes: int = 6):
        super().__init__()
        self.googlenet = GoogLeNet(num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) NHWC -> (N, num_classes) logits."""
        return self.googlenet(x.permute(0, 3, 1, 2))
