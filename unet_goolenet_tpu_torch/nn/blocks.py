"""UNet building blocks (NCHW nn.Modules with the reference's parameter names).

Counterpart of `unet_goolenet_tpu/nn/blocks.py:70-125,203-251` (reference
分割/nets/basicUnet.py). Submodule names follow the reference, so a reference
state dict loads with `load_state_dict`: `conv`/`norm` inside ConvBatchNorm,
`nConvs.<i>` for the conv stacks, `cca.conv1_e.0`, `cca.fc_avg_max_sfot`.
CoordAtt3's never-called DeformConv2d is not declared (its keys are dropped
on load, models/convert.py).
"""

from __future__ import annotations

import torch
from torch import nn

from unet_goolenet_tpu_torch.ops.pool import max_pool2d_nchw


class ConvBatchNorm(nn.Module):
    """conv3x3 (pad 1) -> BatchNorm (eps 1e-5) -> ReLU (basicUnet.py:25-40)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm = nn.BatchNorm2d(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.norm(self.conv(x)))


def conv_stack(cin: int, cout: int, n: int = 2) -> nn.Sequential:
    """n ConvBatchNorm blocks (_make_nConv, basicUnet.py:17-23)."""
    return nn.Sequential(*[ConvBatchNorm(cin if i == 0 else cout, cout)
                           for i in range(n)])


class DownBlock(nn.Module):
    """maxpool 2x2 then two ConvBatchNorm (basicUnet.py:42-52)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.nConvs = conv_stack(cin, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.nConvs(max_pool2d_nchw(x, 2))


class CoordAtt3(nn.Module):
    """Skip gate of the flagship model (basicUnet.py:201-231):
    out = CBN(e) + sigmoid(fc(relu(fc_a(GAP)) + relu(fc_m(GMP)))) * CBN(d) + CBN(d)."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1_e = conv_stack(c, c, 1)
        self.conv2_e = conv_stack(c, c, 1)
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

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.up = nn.ConvTranspose2d(cin, cin, 2, stride=2)
        self.cca = CoordAtt3(cin)
        self.nConvs = conv_stack(2 * cin, cout)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        up = self.up(x)
        return self.nConvs(torch.cat([up, self.cca(skip, up)], dim=1))
