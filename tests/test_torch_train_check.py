"""chip_smoke.py's train-step check (`one_train_step`, `errors_to`, `hold`)
on the CPU, at 32x32 and batch 2 with the full-width UNet: the float32
kernel path (on the CPU the kernels' plain versions and their backward
composition) with a planted fault, the transposed convs' bias gradient 25%
short, against the float32 stock path, each measured against the float64
stock path. The check must fail exactly the 4 faulty gradient leaves (they
read 3.8 of their limit, 25% off against about 0.066), which the check's
sum over all leaves cannot see, and pass every other error of the kernel
path, over all leaves and leaf by leaf.
"""

import pytest
import torch

import chip_smoke
from unet_goolenet_tpu_torch.models import UNetTaskAligWeight
from unet_goolenet_tpu_torch.ops.kernels import conv
from torch_threads import torch_threads  # noqa: F401  (autouse)

S, N = 32, 2


def test_train_step_check_fails_a_planted_fault_only():
    dev = torch.device("cpu")
    torch.manual_seed(6)
    sd = UNetTaskAligWeight(1, img_size=S).state_dict()
    g = torch.Generator().manual_seed(7)
    imgs = torch.rand((N, S, S, 3), generator=g)
    yy, xx = torch.meshgrid(torch.arange(S), torch.arange(S), indexing="ij")
    labels = (((yy - 16) ** 2 + (xx - 14) ** 2) < 9 ** 2).float()[None, :, :, None].expand(
        N, -1, -1, -1).contiguous()
    step = lambda kernels, dtype: chip_smoke.one_train_step(dev, sd, imgs, labels, kernels, dtype)
    truth = step(False, torch.float64)
    stock = chip_smoke.errors_to(step(False, torch.float32), truth, sd)
    dwdb = conv.deconv2x2_dwdb
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(conv, "deconv2x2_dwdb", lambda x, g: (lambda w, b: (w, 0.75 * b))(*dwdb(x, g)))
        fault = chip_smoke.errors_to(step(True, torch.float32), truth, sd)
    bad, _ = chip_smoke.hold(stock, fault)
    faulty = [f"up{i}.up.bias" for i in range(1, 5)]
    assert sorted(b.split()[1] for b in bad) == faulty and all(b.startswith("grad ") for b in bad)
