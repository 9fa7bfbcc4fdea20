"""The UNet's convolution, transposed convolution and pool for training, on
CUDA kernels.

Replaces the JAX package's Pallas kernels in
`unet_goolenet_tpu/ops/pallas/conv.py`:

  * `fused_conv3x3` <- `fused_conv3x3` (`_fwd_kernel`):
        y = [relu](conv3x3_p1(x, w) * scale + bias)
    and for its VJP `conv3x3_dw` <- `_dw_kernel` (dx launches
    `fused_conv3x3` with flipped, io-transposed weights, as the JAX VJP
    does; dscale and dbias stay plain reductions);
  * `fused_convstack2` <- `fused_convstack2` (`_stack2_kernel`): two
    chained `fused_conv3x3` with relu, inference only;
  * `deconv2x2` <- `conv_transpose2x2_pallas` (`_deconv_kernel`), with
    `deconv2x2_dx` <- `_deconv_dx_kernel` and `deconv2x2_dwdb` <-
    `_deconv_dwdb_kernel`;
  * `max_pool2x2` <- `max_pool2x2_pallas` (`_pool_kernel`), with
    `max_pool2x2_bwd` for its backward (plain jnp there: the gradient goes
    to the first maximum of each window, torch's tie rule).

Sources: `csrc/conv.cu` (on `csrc/dense_conv.cuh`), `csrc/deconv.cu` (its
own TMA + wgmma GEMM; dW/db on `csrc/conv_dw.cuh`), `csrc/conv_dw.cuh` and
`csrc/pool.cu`; bounds and design notes there. The weight gradients' split
(`wgrad_plan`) and the transposed conv's tiles (`deconv_plan`) are planned
here, in plain Python that the CPU tests reach.
Activations are dense NHWC, float32 or bfloat16; weights keep torch's
layouts (conv OIHW, transposed conv (Cin, Cout, 2, 2)). The conv's are laid
out for the kernels at each call, since training changes them every step;
the transposed conv's forward reads torch's float32 weight as it lies, and
its dx lays it out once, in one small launch. The kernels accumulate in
float32 and round each output to the activation dtype; weight gradients are
float32.

Each wrapper takes its plain version (`*_ref`) only for a tensor on the CPU.
For a CUDA tensor it launches the kernel or raises. Each counts its calls
that launch in `.launches`. `conv3x3`, `deconv` and `pool2x2` are the
autograd functions the model calls: their backward runs the backward
kernels (or, on the CPU, their plain versions).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from unet_goolenet_tpu_torch.ops.conv import conv2d, conv_transpose2x2
from unet_goolenet_tpu_torch.ops.kernels._common import (
    BLOCK, INT, PTR, blocked_taps, check, dense_channels, dtype_code, launched, lib_fn,
    round_to, stream, wide)
from unet_goolenet_tpu_torch.ops.pool import max_pool2d

# ------------------------------------------------------------ plain versions
# Float32 math (float64 for float64 inputs: `_common.wide`), rounded to the
# activation dtype where the kernels round.


def fused_conv3x3_ref(x, w, scale, bias, relu: bool) -> torch.Tensor:
    """Plain version of `fused_conv3x3`: x (N, H, W, cin); w (cout, cin, 3,
    3); scale, bias (cout,). The result in x's dtype."""
    dt = x.dtype
    y = conv2d(wide(x), round_to(w, dt), padding=1) * wide(scale) + wide(bias)
    return (y.relu() if relu else y).to(dt)


def conv3x3_dw_ref(x, g) -> torch.Tensor:
    """Plain version of `conv3x3_dw`: the (cout, cin, 3, 3) weight
    gradient of a 3x3 pad-1 conv, x (N, H, W, cin), g (N, H, W, cout)."""
    cin, cout = x.shape[-1], g.shape[-1]
    return torch.nn.grad.conv2d_weight(wide(x).permute(0, 3, 1, 2), (cout, cin, 3, 3),
                                       wide(g).permute(0, 3, 1, 2), padding=1)


def fused_convstack2_ref(x, w1, s1, b1, w2, s2, b2) -> torch.Tensor:
    """Plain version of `fused_convstack2`; the intermediate is rounded to
    x's dtype."""
    return fused_conv3x3_ref(fused_conv3x3_ref(x, w1, s1, b1, True), w2, s2, b2, True)


def deconv2x2_ref(x, w, b) -> torch.Tensor:
    """Plain version of `deconv2x2`: x (N, H, W, cin), w (cin, cout, 2, 2),
    b (cout,) rounded to x's dtype (as the TPU kernel takes it)."""
    dt = x.dtype
    return conv_transpose2x2(wide(x), round_to(w, dt), round_to(b, dt)).to(dt)


def _inv_d2s(g: torch.Tensor) -> torch.Tensor:
    """(N, 2H, 2W, C) -> (N, H, W, 4C), channels ordered (di, dj, c)."""
    n, h2, w2, c = g.shape
    return g.reshape(n, h2 // 2, 2, w2 // 2, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(
        n, h2 // 2, w2 // 2, 4 * c)


def deconv2x2_dx_ref(g, w) -> torch.Tensor:
    """Plain version of `deconv2x2_dx`: g (N, 2H, 2W, cout) -> dx (N, H, W,
    cin) in g's dtype."""
    cin, cout = w.shape[:2]
    wmat = round_to(w, g.dtype).permute(0, 2, 3, 1).reshape(cin, 4 * cout)
    return (_inv_d2s(wide(g)) @ wmat.T).to(g.dtype)


def deconv2x2_dwdb_ref(x, g):
    """Plain version of `deconv2x2_dwdb`: dw (cin, cout, 2, 2) and db
    (cout,) of x (N, H, W, cin) and g (N, 2H, 2W, cout)."""
    cin, cout = x.shape[-1], g.shape[-1]
    dwmat = wide(x).reshape(-1, cin).T @ _inv_d2s(wide(g)).reshape(-1, 4 * cout)
    return dwmat.reshape(cin, 2, 2, cout).permute(0, 3, 1, 2), wide(g).sum(dim=(0, 1, 2))


def max_pool2x2_ref(x) -> torch.Tensor:
    """Plain version of `max_pool2x2`: x (N, 2H, 2W, C) -> (N, H, W, C)."""
    return max_pool2d(x, 2)


def max_pool2x2_bwd_ref(x, gy) -> torch.Tensor:
    """Plain version of `max_pool2x2_bwd`: gy routed to the first maximum of
    each window in (r0c0, r0c1, r1c0, r1c1) order."""
    n, h2, w2, c = x.shape
    win = x.reshape(n, h2 // 2, 2, w2 // 2, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(
        n, h2 // 2, w2 // 2, 4, c)
    sel = F.one_hot(win.argmax(dim=3), 4).permute(0, 1, 2, 4, 3).to(gy.dtype)
    gx = gy[:, :, :, None, :] * sel
    return gx.reshape(n, h2 // 2, w2 // 2, 2, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(x.shape)


# ------------------------------------------------------------ kernel wrappers


def _cin64(cin: int) -> int:
    return -(-cin // BLOCK) * BLOCK


def conv_weights(w: torch.Tensor, dtype) -> torch.Tensor:
    """(cout, cin, 3, 3) -> the conv kernel's blocked layout in `dtype`, cin
    padded with zeros to a multiple of 64."""
    cin = w.shape[1]
    if cin % BLOCK:
        w = F.pad(w, (0, 0, 0, 0, 0, _cin64(cin) - cin))
    return blocked_taps(w.detach(), dtype)


def _f32(name: str, t: torch.Tensor, shape) -> torch.Tensor:
    """t as float32 and contiguous: itself, with no copy, for a float32
    parameter."""
    t = t.detach().float().contiguous()
    check(name, t, shape, torch.float32)
    return t


def fused_conv3x3(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                  bias: torch.Tensor, relu: bool) -> torch.Tensor:
    """[relu](conv3x3_p1(x, w) * scale + bias): x (N, H, W, cin), any cin;
    w (cout, cin, 3, 3), cout a multiple of 64; scale, bias (cout,).
    Returns (N, H, W, cout) in x's dtype."""
    if x.device.type == "cpu":
        return fused_conv3x3_ref(x, w, scale, bias, relu)
    code = dtype_code("fused_conv3x3", x)
    n, h, wd, cin = x.shape
    cout = w.shape[0]
    dense_channels("fused_conv3x3", cout)
    if tuple(w.shape) != (cout, cin, 3, 3):
        raise ValueError(f"fused_conv3x3: w must be ({cout}, {cin}, 3, 3), got {tuple(w.shape)}")
    check("x", x, (n, h, wd, cin), x.dtype)
    wk = conv_weights(w, x.dtype)
    sk, bk = _f32("scale", scale, (cout,)), _f32("bias", bias, (cout,))
    out = torch.empty((n, h, wd, cout), device=x.device, dtype=x.dtype)
    rc = lib_fn("conv3x3_launch", [INT] + [PTR] * 5 + [INT] * 6 + [PTR])(
        code, x.data_ptr(), wk.data_ptr(), sk.data_ptr(), bk.data_ptr(), out.data_ptr(),
        n, h, wd, cin, cout, int(relu), stream(x))
    launched("fused_conv3x3", rc)
    fused_conv3x3.launches += 1
    return out


class WgradPlan(NamedTuple):
    """How one weight-gradient launch (`csrc/conv_dw.cuh`) splits its work.
    The kernel is a GEMM over output tiles of `mtiles` x `ntiles` (64 input
    channels, all taps, times 64 columns for the conv; times 32 channels at
    the four parities for the deconv) whose reduction runs over `items`:
    `tile` (rows, cols) pixel tiles of each image (conv) or steps of 64
    pixels (deconv; `tile` None).
    The items are cut into `chunks` of `per_chunk`; block b of the grid
    takes chunk b % chunks of output tile b // chunks, as `blocks` lists.
    `out_elems` floats of the result (dw, then the deconv's db). `reduce`
    says how the chunks are summed: "one" (a single chunk), "cluster" (up
    to MAX_CLUSTER chunks, one thread-block cluster a tile, summed in
    distributed shared memory) or "grid" (float32 partials, `partial_elems`
    floats of scratch, one result per chunk, summed after a grid barrier)."""
    taps: int
    tile: Optional[Tuple[int, int]]
    items: int
    mtiles: int
    ntiles: int
    chunks: int
    per_chunk: int
    out_elems: int

    @property
    def grid(self) -> int:
        return self.mtiles * self.ntiles * self.chunks

    @property
    def reduce(self) -> str:
        return "one" if self.chunks == 1 else "cluster" if self.chunks <= MAX_CLUSTER else "grid"

    @property
    def partial_elems(self) -> int:
        return self.chunks * self.out_elems if self.reduce == "grid" else 0

    @property
    def partial_bytes(self) -> int:
        return 4 * self.partial_elems

    def blocks(self):
        """(chunk, mt, nt, first item, item count) of each block, in grid
        order: the kernel's own mapping of blockIdx.x."""
        for b in range(self.grid):
            chunk, tile = b % self.chunks, b // self.chunks
            i0 = chunk * self.per_chunk
            yield chunk, tile // self.ntiles, tile % self.ntiles, i0, min(
                self.items - i0, self.per_chunk)


# the conv kernel's pixel tiles, (rows, cols): bf16 runs wgmma, whose k steps
# of 16 pixels stay in one tile row; float32 may run them across rows
DW_TILES = {torch.bfloat16: ((8, 16), (4, 32)), torch.float32: ((8, 16), (4, 28), (7, 14))}
DW_STEP = 64          # the deconv kernel's pixels per item
DW_MIN_ITEMS = 8      # the fewest items a chunk of a split plan takes
# the most chunks summed in one thread-block cluster: on the H100, clusters
# of 4 and 8 one-block-per-SM blocks did not all fit its GPCs at once and ran
# in two waves, slower than the grid reduce
MAX_CLUSTER = 3
REDUCE_CODE = {"one": 0, "cluster": 1, "grid": 2}   # csrc/conv_dw.cuh's Reduce


def wgrad_plan(taps: int, n: int, h: int, w: int, cin: int, cout: int, dtype,
               sms: int) -> WgradPlan:
    """The split of a weight-gradient launch: a conv's dw (taps = 9; x (n,
    h, w, cin), g (n, h, w, cout)) or a deconv's dW/db (taps = 1; x (n, h,
    w, cin), g (n, 2h, 2w, cout)) in `dtype` on a card of `sms` SMs. The
    pixels are cut into chunks only as far as the output tiles leave SMs
    idle (the grid stays within one block per SM, as the grid barrier of a
    "grid" reduce needs) and never below DW_MIN_ITEMS items a chunk; beyond
    MAX_CLUSTER chunks each chunk's partial, as large as the result, goes
    through device memory."""
    if taps == 9:
        tile = dw_tile(h, w, dtype)
        items = n * -(-h // tile[0]) * -(-w // tile[1])
        mtiles, ntiles, out = -(-cin // BLOCK), cout // BLOCK, 9 * cin * cout
    elif taps == 1:
        tile, items = None, -(-(n * h * w) // DW_STEP)
        mtiles, ntiles, out = cin // BLOCK, cout // 32, 4 * cin * cout + cout
    else:
        raise ValueError(f"wgrad_plan: taps must be 9 or 1, got {taps}")
    chunks = max(1, min(sms // (mtiles * ntiles), items // DW_MIN_ITEMS))
    per = -(-items // chunks)
    return WgradPlan(taps, tile, items, mtiles, ntiles, -(-items // per), per, out)


def dw_tile(h: int, w: int, dtype) -> Tuple[int, int]:
    """The conv kernel's pixel tile for an h x w image in `dtype`: of
    DW_TILES, the one that takes the fewest k steps of 16 pixels (a tile's
    pixels rounded up to 16) to cover the image; the first of a tie."""
    return min(DW_TILES[dtype],
               key=lambda t: -(-h // t[0]) * -(-w // t[1]) * -(-t[0] * t[1] // 16))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_barriers = {}


def _launch_plan(x: torch.Tensor, plan: WgradPlan):
    """(part, bar) of a launch: for a "grid" reduce its partial scratch and
    the grid barrier's two counters (zeroed once per device and stream;
    every launch leaves them zero, and launches on one stream never
    overlap); None otherwise."""
    if plan.reduce != "grid":
        return None, None
    key = (x.device.index, stream(x))
    if key not in _barriers:
        _barriers[key] = torch.zeros(2, dtype=torch.int32, device=x.device)
    part = torch.empty(plan.partial_elems, device=x.device, dtype=torch.float32)
    return part, _barriers[key]


def _ptr(t):
    return None if t is None else t.data_ptr()


class DeconvPlan(NamedTuple):
    """The tiles of one transposed-conv GEMM launch (`csrc/deconv.cu`),
    M pixels x N columns x K: the forward (`dx` False) is x (N*H*W, cin) @
    w (cin, 4 cout); dx is g at its four parities (K = 4 cout, a K tile 64
    o of one parity) @ w (4 cout, cin). A is viewed as `rows` rows of
    `width` pixels (the forward: one row of N*H*W input pixels; dx: the N*H
    rows of x's width), an M tile as `R` rows x `S` pixels of them (R * S
    <= DC_BM).
    N tiles are `bn` columns; K runs in `ktiles` tiles of DC_BK, cut into
    `splits` runs of `kper` (the blocks of one thread-block cluster, their
    tiles summed in rank order). Block b of the grid takes split b %
    splits of M tile b // splits % mtiles and N tile b // splits // mtiles,
    as `blocks` lists."""
    dx: bool
    rows: int
    width: int
    R: int
    S: int
    n: int
    bn: int
    ktiles: int
    splits: int
    kper: int

    @property
    def ctiles(self) -> int:
        return -(-self.width // self.S)

    @property
    def mtiles(self) -> int:
        return -(-self.rows // self.R) * self.ctiles

    @property
    def ntiles(self) -> int:
        return self.n // self.bn

    @property
    def grid(self) -> int:
        return self.mtiles * self.ntiles * self.splits

    def pixels(self, mt: int):
        """The pixels (row * width + column) of M tile mt, in tile order."""
        rt, ct = divmod(mt, self.ctiles)
        return [r * self.width + j
                for r in range(rt * self.R, min(self.rows, rt * self.R + self.R))
                for j in range(ct * self.S, min(self.width, ct * self.S + self.S))]

    def blocks(self):
        """(split, mt, nt, first k tile, k tiles) of each block, in grid
        order: the kernel's own mapping of blockIdx.x."""
        for b in range(self.grid):
            split, tile = b % self.splits, b // self.splits
            k0 = split * self.kper
            yield split, tile % self.mtiles, tile // self.mtiles, k0, min(self.ktiles - k0,
                                                                          self.kper)

    def stores(self, split: int, dtype) -> range:
        """The 16-byte output chunks of a tile (R * S rows of bn / V, V
        elements of dtype to 16 bytes) that rank `split` of the cluster sums
        over the ranks and writes."""
        nch = self.R * self.S * self.bn * torch.finfo(dtype).bits // 128
        per = -(-nch // self.splits)
        return range(split * per, min(nch, (split + 1) * per))


DC_BM, DC_BK = 128, 64   # csrc/deconv.cu: pixels of an M tile; K of a stage
DC_MAX_SPLIT = 4         # the most K splits a cluster sums
DC_MIN_KTILES = 4        # the fewest K tiles a split takes


def deconv_plan(dx: bool, n: int, h: int, w: int, cin: int, cout: int, sms: int) -> DeconvPlan:
    """The tiles of the transposed conv's forward (dx False) or input
    gradient for x (n, h, w, cin) and y (n, 2h, 2w, cout) on a card of
    `sms` SMs. M tiles are 128 pixels: the forward's flattened, dx's whole
    rows of x's width where they fit (else 128-pixel segments of a row); N
    tiles are 128 columns for the forward (32 o at the four parities), 64
    for dx. dx splits K, up to DC_MAX_SPLIT ways and never below
    DC_MIN_KTILES tiles a split, while the grid stays within one block per
    SM: the 14^2 level has 7 M x 8 N tiles, so its dx runs 2 splits a
    tile."""
    rows, width, k, cols = (n * h, w, 4 * cout, cin) if dx else (1, n * h * w, cin, 4 * cout)
    s_ = min(width, DC_BM)
    r_ = min(rows, max(1, DC_BM // width))
    ktiles = k // DC_BK
    plan = DeconvPlan(dx, rows, width, r_, s_, cols, 64 if dx else 128, ktiles, 1, ktiles)
    splits = 1
    while dx and (splits < DC_MAX_SPLIT and plan.grid * (splits + 1) <= sms
                  and ktiles >= (splits + 1) * DC_MIN_KTILES):
        splits += 1
    kper = -(-ktiles // splits)
    return plan._replace(splits=-(-ktiles // kper), kper=kper)


def conv3x3_dw(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Float32 (cout, cin, 3, 3) weight gradient of a 3x3 pad-1 conv of x
    (N, H, W, cin), any cin, given g (N, H, W, cout) in x's dtype, cout a
    multiple of 64."""
    if x.device.type == "cpu":
        return conv3x3_dw_ref(x, g)
    code = dtype_code("conv3x3_dw", x)
    n, h, wd, cin = x.shape
    cout = g.shape[-1]
    dense_channels("conv3x3_dw", cout)
    check("x", x, (n, h, wd, cin), x.dtype)
    check("g", g, (n, h, wd, cout), x.dtype)
    cx = -(-cin // 8) * 8   # every staging copy is 16 bytes
    xk = x if cx == cin else F.pad(x, (0, cx - cin))
    plan = wgrad_plan(9, n, h, wd, cin, cout, x.dtype, _sms(x.device.index))
    part, bar = _launch_plan(x, plan)
    dw = torch.empty((cout, cin, 3, 3), device=x.device, dtype=torch.float32)
    rc = lib_fn("conv3x3_dw_launch", [INT] + [PTR] * 5 + [INT] * 10 + [PTR])(
        code, xk.data_ptr(), g.data_ptr(), _ptr(part), _ptr(bar), dw.data_ptr(), n, h, wd, cx,
        cin, cout, plan.tile[1], plan.chunks, plan.per_chunk, REDUCE_CODE[plan.reduce],
        stream(x))
    launched("conv3x3_dw", rc)
    conv3x3_dw.launches += 1
    return dw


def fused_convstack2(x, w1, s1, b1, w2, s2, b2) -> torch.Tensor:
    """relu(conv3x3(relu(conv3x3(x, w1) * s1 + b1), w2) * s2 + b2), the
    intermediate rounded to x's dtype: a ConvStack pair with folded
    BatchNorm. x (N, H, W, cin); w1 (cmid, cin, 3, 3); w2 (cout, cmid, 3, 3),
    cmid and cout multiples of 64."""
    if x.device.type == "cpu":
        return fused_convstack2_ref(x, w1, s1, b1, w2, s2, b2)
    code = dtype_code("fused_convstack2", x)
    n, h, wd, cin = x.shape
    cmid, cout = w1.shape[0], w2.shape[0]
    dense_channels("fused_convstack2", cmid, cout)
    if tuple(w1.shape) != (cmid, cin, 3, 3) or tuple(w2.shape) != (cout, cmid, 3, 3):
        raise ValueError(f"fused_convstack2: weights {tuple(w1.shape)}, {tuple(w2.shape)} "
                         f"do not chain from {cin} channels")
    check("x", x, (n, h, wd, cin), x.dtype)
    wk1, wk2 = conv_weights(w1, x.dtype), conv_weights(w2, x.dtype)
    vs = tuple(_f32(name, t, (c,)) for name, t, c in
               (("s1", s1, cmid), ("b1", b1, cmid), ("s2", s2, cout), ("b2", b2, cout)))
    mid = torch.empty((n, h, wd, cmid), device=x.device, dtype=x.dtype)
    out = torch.empty((n, h, wd, cout), device=x.device, dtype=x.dtype)
    rc = lib_fn("convstack2_launch", [INT] + [PTR] * 9 + [INT] * 6 + [PTR])(
        code, x.data_ptr(), wk1.data_ptr(), vs[0].data_ptr(), vs[1].data_ptr(), wk2.data_ptr(),
        vs[2].data_ptr(), vs[3].data_ptr(), mid.data_ptr(), out.data_ptr(), n, h, wd, cin, cmid,
        cout, stream(x))
    launched("fused_convstack2", rc)
    fused_convstack2.launches += 1
    return out


def _deconv_check(name, x, w):
    n, h, wd, cin = x.shape
    cout = w.shape[1]
    dense_channels(name, cin, cout)
    if tuple(w.shape) != (cin, cout, 2, 2):
        raise ValueError(f"{name}: w must be ({cin}, {cout}, 2, 2), got {tuple(w.shape)}")
    check("x", x, (n, h, wd, cin), x.dtype)
    return n, h, wd, cin, cout


def deconv2x2(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """ConvTranspose 2x2 / stride 2: x (N, H, W, cin), w (cin, cout, 2, 2),
    b (cout,), cin and cout multiples of 64 -> (N, 2H, 2W, cout) in x's
    dtype; w and b are rounded to x's dtype, as the TPU kernel takes them.
    One launch: the kernel reads the float32 weight and bias as they lie."""
    if x.device.type == "cpu":
        return deconv2x2_ref(x, w, b)
    code = dtype_code("deconv2x2", x)
    n, h, wd, cin, cout = _deconv_check("deconv2x2", x, w)
    wk, bk = _f32("w", w, (cin, cout, 2, 2)), _f32("b", b, (cout,))
    out = torch.empty((n, 2 * h, 2 * wd, cout), device=x.device, dtype=x.dtype)
    rc = lib_fn("deconv_launch", [INT] + [PTR] * 4 + [INT] * 5 + [PTR])(
        code, x.data_ptr(), wk.data_ptr(), bk.data_ptr(), out.data_ptr(), n, h, wd, cin, cout,
        stream(x))
    launched("deconv2x2", rc)
    deconv2x2.launches += 1
    return out


def deconv2x2_dx(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Input gradient of `deconv2x2`: g (N, 2H, 2W, cout), w (cin, cout, 2,
    2) -> (N, H, W, cin) in g's dtype; w is rounded to g's dtype. Two
    launches: w laid out as (cin, 4, cout) in g's dtype (each input
    channel's row in the kernel's K order, parity-major), then the GEMM,
    with the tiles `deconv_plan` gives."""
    if g.device.type == "cpu":
        return deconv2x2_dx_ref(g, w)
    code = dtype_code("deconv2x2_dx", g)
    n, h2, w2, cout = g.shape
    cin = w.shape[0]
    dense_channels("deconv2x2_dx", cin, cout)
    if tuple(w.shape) != (cin, cout, 2, 2) or h2 % 2 or w2 % 2:
        raise ValueError(f"deconv2x2_dx: g {tuple(g.shape)} and w {tuple(w.shape)} disagree")
    check("g", g, (n, h2, w2, cout), g.dtype)
    h, wd = h2 // 2, w2 // 2
    w32 = _f32("w", w, (cin, cout, 2, 2))
    wk = torch.empty((cin, 4, cout), device=g.device, dtype=g.dtype)
    rc = lib_fn("deconv_dx_weight_launch", [INT, PTR, PTR, INT, INT, PTR])(
        code, w32.data_ptr(), wk.data_ptr(), cin, cout, stream(g))
    launched("deconv2x2_dx", rc)
    plan = deconv_plan(True, n, h, wd, cin, cout, _sms(g.device.index))
    dx = torch.empty((n, h, wd, cin), device=g.device, dtype=g.dtype)
    rc = lib_fn("deconv_dx_launch", [INT] + [PTR] * 3 + [INT] * 6 + [PTR])(
        code, g.data_ptr(), wk.data_ptr(), dx.data_ptr(), n, h, wd, cin, cout, plan.splits,
        stream(g))
    launched("deconv2x2_dx", rc)
    deconv2x2_dx.launches += 1
    return dx


def deconv2x2_dwdb(x: torch.Tensor, g: torch.Tensor):
    """Float32 weight and bias gradients (cin, cout, 2, 2), (cout,) of
    `deconv2x2` of x (N, H, W, cin), given g (N, 2H, 2W, cout) in x's
    dtype."""
    if x.device.type == "cpu":
        return deconv2x2_dwdb_ref(x, g)
    code = dtype_code("deconv2x2_dwdb", x)
    n, h, wd, cin = x.shape
    cout = g.shape[-1]
    dense_channels("deconv2x2_dwdb", cin, cout)
    check("x", x, (n, h, wd, cin), x.dtype)
    check("g", g, (n, 2 * h, 2 * wd, cout), x.dtype)
    plan = wgrad_plan(1, n, h, wd, cin, cout, x.dtype, _sms(x.device.index))
    part, bar = _launch_plan(x, plan)
    out = torch.empty(plan.out_elems, device=x.device, dtype=torch.float32)
    rc = lib_fn("deconv_dwdb_launch", [INT] + [PTR] * 5 + [INT] * 8 + [PTR])(
        code, x.data_ptr(), g.data_ptr(), _ptr(part), _ptr(bar), out.data_ptr(), n, h, wd, cin,
        cout, plan.chunks, plan.per_chunk, REDUCE_CODE[plan.reduce], stream(x))
    launched("deconv2x2_dwdb", rc)
    deconv2x2_dwdb.launches += 1
    return out[:-cout].view(cin, cout, 2, 2), out[-cout:]


def _pool_check(name, x):
    n, h2, w2, c = x.shape
    if h2 % 2 or w2 % 2 or c % 4:
        raise ValueError(f"{name}: x's height and width must be even and its channels a "
                         f"multiple of 4, got {tuple(x.shape)}")
    check("x", x, (n, h2, w2, c), x.dtype)
    return n, h2 // 2, w2 // 2, c


def max_pool2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 / stride-2 max pool of x (N, 2H, 2W, C): (N, H, W, C)."""
    if x.device.type == "cpu":
        return max_pool2x2_ref(x)
    code = dtype_code("max_pool2x2", x)
    n, h, wd, c = _pool_check("max_pool2x2", x)
    out = torch.empty((n, h, wd, c), device=x.device, dtype=x.dtype)
    rc = lib_fn("pool_launch", [INT, PTR, PTR] + [INT] * 4 + [PTR])(
        code, x.data_ptr(), out.data_ptr(), n, h, wd, c, stream(x))
    launched("max_pool2x2", rc)
    max_pool2x2.launches += 1
    return out


def max_pool2x2_bwd(x: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """Input gradient of `max_pool2x2`: gy (N, H, W, C) routed to the first
    maximum of each window of x (N, 2H, 2W, C)."""
    if x.device.type == "cpu":
        return max_pool2x2_bwd_ref(x, gy)
    code = dtype_code("max_pool2x2_bwd", x)
    n, h, wd, c = _pool_check("max_pool2x2_bwd", x)
    check("gy", gy, (n, h, wd, c), x.dtype)
    gx = torch.empty_like(x)
    rc = lib_fn("pool_bwd_launch", [INT, PTR, PTR, PTR] + [INT] * 4 + [PTR])(
        code, x.data_ptr(), gy.data_ptr(), gx.data_ptr(), n, h, wd, c, stream(x))
    launched("max_pool2x2_bwd", rc)
    max_pool2x2_bwd.launches += 1
    return gx


WRAPPERS = (fused_conv3x3, conv3x3_dw, fused_convstack2, deconv2x2, deconv2x2_dx,
            deconv2x2_dwdb, max_pool2x2, max_pool2x2_bwd)
for _fn in WRAPPERS:
    _fn.launches = 0


# ------------------------------------------------------------ autograd


class Conv3x3(torch.autograd.Function):
    """`fused_conv3x3` with the JAX VJP's backward (`_fused_bwd`): dx by the
    forward kernel with flipped, io-transposed weights (skipped when x needs
    no gradient), dw by `conv3x3_dw`, dscale and dbias as plain sums."""

    @staticmethod
    def forward(ctx, x, w, scale, bias, relu: bool):
        y = fused_conv3x3(x, w, scale, bias, relu)
        ctx.relu = relu
        ctx.save_for_backward(x, w, scale, bias, y)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, w, scale, bias, y = ctx.saved_tensors
        need_x, need_w, need_s, need_b, _ = ctx.needs_input_grad
        gy = wide(gy)
        if ctx.relu:
            gy = gy * (y > 0)
        sums = (0, 1, 2)
        dscale = (gy * ((wide(y) - bias) / scale)).sum(sums) if need_s else None
        dbias = gy.sum(sums) if need_b else None
        gc = (gy * wide(scale)).to(x.dtype).contiguous()
        dx = dw = None
        if need_x:
            cin = x.shape[-1]
            w_rot = w.detach().flip(2, 3).transpose(0, 1)
            if cin % BLOCK:   # the kernel writes whole 64-channel blocks
                w_rot = F.pad(w_rot, (0, 0, 0, 0, 0, 0, 0, _cin64(cin) - cin))
            ones = torch.ones(w_rot.shape[0], device=x.device)
            dx = fused_conv3x3(gc, w_rot, ones, torch.zeros_like(ones), False)[..., :cin]
        if need_w:
            dw = conv3x3_dw(x, gc).to(w.dtype)
        return dx, dw, dscale, dbias, None


class Deconv(torch.autograd.Function):
    """`deconv2x2` with `deconv2x2_dx` and `deconv2x2_dwdb` as its backward."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        ctx.b_dtype = b.dtype
        return deconv2x2(x, w, b)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gy = gy.to(x.dtype).contiguous()
        dx = deconv2x2_dx(gy, w) if ctx.needs_input_grad[0] else None
        dw = db = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = deconv2x2_dwdb(x, gy)
            dw, db = dw.to(w.dtype), db.to(ctx.b_dtype)
        return dx, dw, db


class Pool2x2(torch.autograd.Function):
    """`max_pool2x2` with `max_pool2x2_bwd` as its backward."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return max_pool2x2(x)

    @staticmethod
    def backward(ctx, gy):
        (x,) = ctx.saved_tensors
        return max_pool2x2_bwd(x, gy.to(x.dtype).contiguous())


def conv3x3(x, w, scale, bias, relu: bool) -> torch.Tensor:
    """Differentiable `fused_conv3x3` (x contiguous NHWC)."""
    return Conv3x3.apply(x.contiguous(), w, scale, bias, relu)


def deconv(x, w, b) -> torch.Tensor:
    """Differentiable `deconv2x2` (x contiguous NHWC)."""
    return Deconv.apply(x.contiguous(), w, b)


def pool2x2(x) -> torch.Tensor:
    """Differentiable `max_pool2x2` (x contiguous NHWC)."""
    return Pool2x2.apply(x.contiguous())
