"""UNetTaskAligWeight, the flagship segmentation model (basicUnet.py:369-437).

Counterpart of `unet_goolenet_tpu/models/unet.py:136-160`. Gated-skip UNet
(BASE 64 channels, four levels) with the dual-stream transformer bottleneck;
only the seg stream feeds the decoder. The reference also declares fc1/fc2 it
never calls; they are not declared here (their keys are dropped on load).

forward takes and returns NHWC like the JAX model; inside, the modules run
NCHW views in channels_last memory. `kernels=True` puts every 3x3 conv
that feeds a BatchNorm (27 a forward), the four transposed convs and the
four pools on the CUDA kernels of `ops/kernels/conv.py` (nn/blocks.py says
how, in train and eval mode); it changes no parameter name.
"""

from __future__ import annotations

import torch
from torch import nn

from unet_goolenet_tpu_torch.nn.blocks import ConvBatchNorm, DownBlock, UpBlockAlig
from unet_goolenet_tpu_torch.nn.transformer import TransformerDecoder

BASE = 64


class UNetTaskAligWeight(nn.Module):
    """img_size sets the positional embeddings' side (img_size // 16, the
    bottleneck's); the reference's checkpoints are 224-only (14 x 14)."""

    def __init__(self, n_classes: int = 1, img_size: int = 224, kernels: bool = False):
        super().__init__()
        c, k = BASE, kernels
        self.inc = ConvBatchNorm(3, c, k)
        self.down1 = DownBlock(c, 2 * c, k)
        self.down2 = DownBlock(2 * c, 4 * c, k)
        self.down3 = DownBlock(4 * c, 8 * c, k)
        self.down4 = DownBlock(8 * c, 8 * c, k)
        self.task2 = TransformerDecoder(dim=8 * c, depth=1, heads=8, dim_head=64,
                                        mlp_dim=2048, pos_size=img_size // 16, kernels=k)
        self.up4 = UpBlockAlig(8 * c, 4 * c, k)
        self.up3 = UpBlockAlig(4 * c, 2 * c, k)
        self.up2 = UpBlockAlig(2 * c, c, k)
        self.up1 = UpBlockAlig(c, c, k)
        self.outc = nn.Conv2d(c, n_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) -> (N, H, W, n_classes) logits."""
        x1 = self.inc(x.permute(0, 3, 1, 2))
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        _, out0 = self.task2(x5, x5)
        y = self.up4(out0, x4)
        y = self.up3(y, x3)
        y = self.up2(y, x2)
        y = self.up1(y, x1)
        return self.outc(y).permute(0, 2, 3, 1)
