"""The UNet's convolution, transposed convolution and pool for training, on
CUDA kernels.

Replaces the JAX package's Pallas kernels in
`unet_goolenet_tpu/ops/pallas/conv.py`:

  * `fused_conv3x3` <- `fused_conv3x3` (`_fwd_kernel`):
        y = [relu](conv3x3_p1(x, w) * scale + bias)
    and for its VJP `conv3x3_dx` (the JAX VJP runs the forward kernel on
    flipped, io-transposed weights; here the same GEMM reads them so) and
    `conv3x3_dw` <- `_dw_kernel`; dscale and dbias stay plain reductions;
  * `fused_convstack2` <- `fused_convstack2` (`_stack2_kernel`): two
    chained `fused_conv3x3` with relu, inference only;
  * `deconv2x2` <- `conv_transpose2x2_pallas` (`_deconv_kernel`), with
    `deconv2x2_dx` <- `_deconv_dx_kernel` and `deconv2x2_dwdb` <-
    `_deconv_dwdb_kernel`;
  * `max_pool2x2` <- `max_pool2x2_pallas` (`_pool_kernel`), with
    `max_pool2x2_bwd` for its backward (plain jnp there: the gradient goes
    to the first maximum of each window, torch's tie rule).

Sources: `csrc/conv.cu` (bf16 forward and dx on `csrc/conv3x3.cuh`'s TMA +
wgmma GEMM, float32 on `csrc/dense_conv.cuh`), `csrc/deconv.cu` (its own
TMA + wgmma GEMM; dW/db on `csrc/conv_dw.cuh`), `csrc/conv_dw.cuh` and
`csrc/pool.cu` (the forward on `csrc/pool.cuh`'s streaming kernel); bounds
and design notes there. The conv's tiles and K split
(`conv_plan`; a decoder level's three, `level_plan`), the weight
gradients' split (`wgrad_plan`) and the transposed conv's tiles
(`deconv_plan`) are planned here, in plain Python that the CPU tests reach.
Activations are dense NHWC, float32 or bfloat16; weights keep torch's
layouts (conv OIHW, transposed conv (Cin, Cout, 2, 2)). The conv's are laid
out once a forward call (`conv3x3_weight`, one launch, since training
changes them every step) and its dx reuses the layout (float32 writes dx's
only where a backward will take dx); the transposed
conv's forward reads torch's float32 weight as it lies, and its dx lays it
out once, in one small launch. The kernels accumulate in float32 and round
each output to the activation dtype; weight gradients are float32.

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
    BLOCK, DTYPE_CODE, INT, PTR, check, dense_channels, dtype_code, launched, lib_fn,
    round_to, stream, wide)
from unet_goolenet_tpu_torch.ops.pool import max_pool2d

# ------------------------------------------------------------ plain versions
# Float32 math (float64 for float64 inputs: `_common.wide`), rounded to the
# activation dtype where the kernels round.


def fused_conv3x3_ref(x, w, scale, bias, relu: bool) -> torch.Tensor:
    """Plain version of `fused_conv3x3`: x (N, H, W, cin); w (cout, cin, 3,
    3); scale, bias (cout,) or None (1, 0). The result in x's dtype."""
    dt = x.dtype
    y = conv2d(wide(x), round_to(w, dt), padding=1)
    if scale is not None:
        y = y * wide(scale)
    if bias is not None:
        y = y + wide(bias)
    return (y.relu() if relu else y).to(dt)


def conv3x3_dx_ref(g, w) -> torch.Tensor:
    """Plain version of `conv3x3_dx`: the input gradient of a 3x3 pad-1
    conv, conv3x3_p1(g, w flipped and io-transposed), g (N, H, W, cout), w
    (cout, cin, 3, 3) rounded to g's dtype; (N, H, W, cin) in g's dtype."""
    w_rot = round_to(w, g.dtype).flip(2, 3).transpose(0, 1)
    return conv2d(wide(g), w_rot, padding=1).to(g.dtype)


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


def _cin8(cin: int) -> int:
    return -(-cin // 8) * 8


def _cin16(cin: int) -> int:
    return -(-cin // 16) * 16


def _gemm_input(x: torch.Tensor) -> torch.Tensor:
    """x as the conv's forward takes it: bf16 with its channels padded with
    zeros to a multiple of 16 (a wgmma k step of the bf16 conv; 16-byte rows
    for TMA and the weight gradient's staging copies), float32 (FMA, any
    channel count) as it is; itself where nothing is padded."""
    c = x.shape[-1]
    return x if c % 16 == 0 or x.dtype != torch.bfloat16 else F.pad(x, (0, _cin16(c) - c))


def _f32(name: str, t: torch.Tensor, shape) -> torch.Tensor:
    """t as float32 and contiguous: itself, with no copy, for a float32
    parameter."""
    t = t.detach().float().contiguous()
    check(name, t, shape, torch.float32)
    return t


def _opt_f32(name: str, t: Optional[torch.Tensor], shape) -> Optional[torch.Tensor]:
    return None if t is None else _f32(name, t, shape)


class ConvWeight(NamedTuple):
    """torch's (cout, cin, 3, 3) float32 weight laid out for the kernels,
    once a forward call (`conv3x3_weight`), and reused by its dx.
    bf16: `fwd` is (9, cout, cin8) bf16 (wk[tap][co][ci], cin8 = cin rounded
    up to 8, zeros beyond cin), which the forward and dx GEMMs both read
    (`dx` is the same tensor); float32: `fwd` and `dx` are
    csrc/dense_conv.cuh's blocked layouts of w and of w flipped and
    io-transposed, (cout/64, 9, cin64, 64) and (cin64/64, 9, cout, 64),
    `dx` None where no dx call will read it."""
    fwd: torch.Tensor
    dx: Optional[torch.Tensor]


def conv3x3_weight(w: torch.Tensor, dtype, dx: bool = True) -> ConvWeight:
    """Lay w (cout, cin, 3, 3) out for the forward and dx kernels in `dtype`
    (float32 or bfloat16): one launch, which reads w as it lies. dx False:
    for the forward only (float32 then writes no dx layout)."""
    if dtype not in DTYPE_CODE:
        raise ValueError(f"conv3x3_weight takes float32 or bfloat16, got {dtype}")
    cout, cin = w.shape[:2]
    dense_channels("conv3x3_weight", cout)
    w32 = _f32("w", w, (cout, cin, 3, 3))
    if dtype == torch.bfloat16:
        fwd = wd = torch.empty((9, cout, _cin8(cin)), device=w.device, dtype=dtype)
    else:
        c64 = _cin64(cin)
        fwd = torch.empty((cout // BLOCK, 9, c64, BLOCK), device=w.device, dtype=dtype)
        wd = torch.empty((c64 // BLOCK, 9, cout, BLOCK), device=w.device,
                         dtype=dtype) if dx else None
    rc = lib_fn("conv3x3_weight_launch", [INT, PTR, PTR, PTR, INT, INT, PTR])(
        DTYPE_CODE[dtype], w32.data_ptr(), fwd.data_ptr(), _ptr(wd), cin, cout, stream(w))
    launched("conv3x3_weight", rc)
    return ConvWeight(fwd, wd)


class ConvPlan(NamedTuple):
    """The tiles of one bf16 3x3-conv GEMM launch (`csrc/conv3x3.cuh`): M =
    the n*h*w output pixels in tiles of `R` rows x `S` pixels of one image,
    computed as R rows of the (S + 2)-wide halo (R (S + 2) <= `bm` GEMM
    rows, 256 for 64-column tiles, else 128; the two pad columns of each row
    are discarded outputs), N = `cols` output channels in tiles of `bn`, K =
    9 taps x `kc` input channels in `ktiles` tiles of one tap x CV_BK
    channels (K tile kt: tap kt % 9 of slab kt // 9), cut into `splits` runs
    of `kper` (whole slabs), the ranks of one thread-block cluster, summed
    in rank order. The grid is `clusters`
    clusters of `splits` blocks, persistent: cluster c takes tiles c, c +
    clusters, ... (tile t: M tile t % mtiles, N tile t // mtiles), as
    `blocks` lists. The forward (`dx` False) has cols = cout and kc = cin
    rounded up to 16; dx cols = cin and kc = cout."""
    dx: bool
    n: int
    h: int
    w: int
    cols: int
    kc: int
    R: int
    S: int
    bn: int
    splits: int
    kper: int
    clusters: int

    @property
    def bm(self) -> int:
        return CV_BM[self.bn]

    @property
    def rtiles(self) -> int:
        return -(-self.h // self.R)

    @property
    def ctiles(self) -> int:
        return -(-self.w // self.S)

    @property
    def mtiles(self) -> int:
        return self.n * self.rtiles * self.ctiles

    @property
    def ntiles(self) -> int:
        return -(-self.cols // self.bn)

    @property
    def tiles(self) -> int:
        return self.mtiles * self.ntiles

    @property
    def ktiles(self) -> int:
        return 9 * -(-self.kc // CV_BK)

    @property
    def grid(self) -> int:
        return self.clusters * self.splits

    def ints(self) -> Tuple[int, ...]:
        """(R, S, bn, splits, clusters), as the kernel's launch takes them."""
        return self.R, self.S, self.bn, self.splits, self.clusters

    def _tile(self, mt: int):
        """Output pixel po = row * S + column of M tile mt, for each po < R
        S, as image * h * w + row * w + column, or None past the image."""
        ct, rest = mt % self.ctiles, mt // self.ctiles
        rt, img = rest % self.rtiles, rest // self.rtiles
        return [(img * self.h + r) * self.w + j if r < self.h and j < self.w else None
                for r in range(rt * self.R, rt * self.R + self.R)
                for j in range(ct * self.S, ct * self.S + self.S)]

    def pixels(self, mt: int):
        """The output pixels (image * h * w + row * w + column) of M tile
        mt, in tile order; the tile's other rows are discarded."""
        return [p for p in self._tile(mt) if p is not None]

    def blocks(self):
        """(rank, cluster, its tiles, first K tile, K tiles) of each block,
        in grid order: the kernel's own mapping of blockIdx.x."""
        for b in range(self.grid):
            rank, cid = b % self.splits, b // self.splits
            k0 = rank * self.kper
            yield (rank, cid, range(cid, self.tiles, self.clusters), k0,
                   min(self.ktiles - k0, self.kper))

    def stores(self, rank: int) -> range:
        """The 16-byte output chunks of a tile (R * S pixels of bn / 8) that
        rank `rank` of the cluster sums over the ranks and writes: whole
        pixels, so that each thread keeps one 8-channel column."""
        px, cpr = self.R * self.S, self.bn // 8
        per = -(-px // self.splits)
        return range(rank * per * cpr, min(px, (rank + 1) * per) * cpr)

    @property
    def stats_slots(self) -> int:
        """Slots an image of the gate pass's statistics partials (the STATS
        epilogue): one a (M tile of the image, rank)."""
        return self.rtiles * self.ctiles * self.splits

    def stats_slot(self, mt: int, rank: int) -> Tuple[int, int]:
        """(image, slot) of the partial that rank `rank` of M tile mt writes."""
        per = self.rtiles * self.ctiles
        return mt // per, mt % per * self.splits + rank

    def slot_pixels(self, mt: int, rank: int):
        """The image pixels whose statistics rank `rank` of M tile mt sums
        into its slot: those of the pixels it stores that lie in the image."""
        cpr, st = self.bn // 8, self.stores(rank)
        return [p for p in self._tile(mt)[st.start // cpr:st.stop // cpr] if p is not None]


CV_BM = {64: 256, 128: 128}   # csrc/conv3x3.cuh: GEMM rows of a tile, by its columns
CV_BK = 64               # channels of a slab
CV_HW = 32               # the widest halo row, S + 2
CV_MAX_SPLIT = 3         # the most K splits a cluster sums
# the plan's cost model, in units of a 128 x 64 K tile's MMA: a K tile's
# fixed cost (its barriers, its boxes' issue) and a tile's epilogue
CV_STEP, CV_TILE = 0.5, 3.0


def conv_tile(h: int, w: int, bm: int) -> Tuple[int, int]:
    """The M tile (R rows, S pixels) of an h x w level, R (S + 2) <= bm and
    S + 2 <= CV_HW: the fewest tiles a level, then the smallest halo
    ((R + 2)(S + 2) pixels staged a slab), then the widest. For bm = 128:
    224, 112 and 56 wide 8 x 14 (112 of 128 rows used), 28 wide 4 x 28, 14
    wide 14 x 7."""
    best = None
    for s_ in range(1, min(w, CV_HW - 2) + 1):
        r_ = min(h, bm // (s_ + 2))
        key = (-(-h // r_) * -(-w // s_), (r_ + 2) * (s_ + 2), -s_)
        if best is None or key < best[0]:
            best = (key, r_, s_)
    return best[1], best[2]


@functools.lru_cache(maxsize=None)   # each call of the trainer's asks again
def conv_plan(dx: bool, n: int, h: int, w: int, cin: int, cout: int, sms: int) -> ConvPlan:
    """The tiles of the bf16 3x3 conv's forward (dx False) or input gradient
    for x (n, h, w, cin) and y (n, h, w, cout) on a card of `sms` SMs. M
    tiles from `conv_tile`; N tiles of 128 columns where the columns divide
    by 128, else 64; where the tiles leave SMs idle, K split into whole
    slabs, up to CV_MAX_SPLIT ways, with at most sms // splits clusters: the
    grid is one wave of one block an SM. Of those, the plan of least cost:
    rounds of tiles an SM x (K tiles a split x (CV_STEP + the tile's MMA in
    128 x 64 units) + the epilogue)."""
    cols, kc = (cin, cout) if dx else (cout, _cin16(cin))
    plan = ConvPlan(dx, n, h, w, cols, kc, 1, 1, 64, 1, 0, 0)
    ktiles, best = plan.ktiles, None
    for bn in (128, 64):
        if bn == 128 and cols % 128:
            continue
        r_, s_ = conv_tile(h, w, CV_BM[bn])
        tiles = plan._replace(bn=bn, R=r_, S=s_).tiles
        for splits in range(1, CV_MAX_SPLIT + 1):
            kper = 9 * -(-ktiles // 9 // splits)
            if splits > 1 and (tiles >= sms or (splits - 1) * kper >= ktiles):
                continue
            clusters = min(tiles, sms // splits)
            cost = -(-tiles // clusters) * (kper * (CV_STEP + CV_BM[bn] * bn / 8192)
                                            + CV_TILE + splits - 1)
            key = (cost, splits, -bn)
            if best is None or key < best[0]:
                best = (key, plan._replace(bn=bn, R=r_, S=s_, splits=splits, kper=kper,
                                           clusters=clusters))
    return best[1]


class LevelPlan(NamedTuple):
    """The three bf16 3x3-conv launches of one decoder level
    (`csrc/up_level.cu`, after its transposed conv) on an n x h x w output:
    `d2` (up, C -> C, GATE epilogue), `pair` (concat[up, gated], 2C -> cq)
    and `blk1` (hh, cq -> cq; with the 1x1 head, 64-column tiles), each
    `conv_plan`'s. `pair_slabs` names the source tensor and first channel of
    each of the pair conv's K slabs, in K order: up's C/64 slabs, then
    gated's, as the kernel's producer reads them from its two tensor maps."""
    d2: ConvPlan
    pair: ConvPlan
    blk1: ConvPlan
    pair_slabs: Tuple[Tuple[str, int], ...]

    def ints(self) -> Tuple[int, ...]:
        """`ConvPlan.ints` of each launch, as the kernel takes them."""
        return tuple(v for p in self[:3] for v in p.ints())


@functools.lru_cache(maxsize=None)
def level_plan(n: int, h: int, w: int, c: int, cq: int, sms: int) -> LevelPlan:
    """The conv launches of a decoder level of C input and cq output
    channels (multiples of 64) at output size h x w on a card of `sms` SMs."""
    slabs = c // CV_BK
    return LevelPlan(conv_plan(False, n, h, w, c, c, sms),
                     conv_plan(False, n, h, w, 2 * c, cq, sms),
                     conv_plan(False, n, h, w, cq, cq, sms),
                     tuple((src, CV_BK * s) for src in ("up", "gated") for s in range(slabs)))


def _gemm(x: torch.Tensor, wk: ConvWeight, scale, bias, relu: bool, out: torch.Tensor,
          cin: int, cout: int, dx: bool) -> None:
    """One launch of the conv's kernel: the forward (x (N, H, W, cin, or
    cin16 in bf16) -> out (N, H, W, cout)) or dx (x = g (N, H, W, cout) ->
    out (N, H, W, cin, or cin64 in float32)); scale and bias float32 or
    None."""
    n, h, wd = x.shape[:3]
    if x.dtype == torch.bfloat16:
        plan = conv_plan(dx, n, h, wd, cin, cout, _sms(x.device.index))
        rc = lib_fn("conv3x3_gemm_launch", [INT] + [PTR] * 5 + [INT] * 11 + [PTR])(
            int(dx), x.data_ptr(), wk.fwd.data_ptr(), _ptr(scale), _ptr(bias), out.data_ptr(),
            n, h, wd, cin, cout, int(relu), plan.R, plan.S, plan.bn, plan.splits,
            plan.clusters, stream(x))
    else:
        cx, co, w_ = (cout, out.shape[-1], wk.dx) if dx else (x.shape[-1], cout, wk.fwd)
        rc = lib_fn("conv3x3_launch", [PTR] * 5 + [INT] * 6 + [PTR])(
            x.data_ptr(), w_.data_ptr(), _ptr(scale), _ptr(bias), out.data_ptr(), n, h, wd,
            cx, co, int(relu), stream(x))
    launched("conv3x3_dx" if dx else "fused_conv3x3", rc)


def _conv_check(name: str, x: torch.Tensor, w: torch.Tensor):
    """(n, h, w, cin, cout) of a forward call: x (N, H, W, cin or cin16)."""
    n, h, wd, cx = x.shape
    cout, cin = w.shape[:2]
    dense_channels(name, cout)
    if tuple(w.shape) != (cout, cin, 3, 3) or cx not in (cin, _cin16(cin)):
        raise ValueError(f"{name}: x {tuple(x.shape)} and w {tuple(w.shape)} disagree")
    check("x", x, (n, h, wd, cx), x.dtype)
    return n, h, wd, cin, cout


def fused_conv3x3(x: torch.Tensor, w: torch.Tensor, scale: Optional[torch.Tensor],
                  bias: Optional[torch.Tensor], relu: bool,
                  wk: Optional[ConvWeight] = None) -> torch.Tensor:
    """[relu](conv3x3_p1(x, w) * scale + bias): x (N, H, W, cin), or cin
    rounded up to 16 with zeros beyond cin; w (cout, cin, 3, 3), cout a
    multiple of 64; scale, bias (cout,) or None (1 and 0). wk: w laid out
    by `conv3x3_weight` in x's dtype (laid out here for the forward only,
    one launch, if None). Returns (N, H, W, cout) in x's dtype."""
    if x.device.type == "cpu":
        return fused_conv3x3_ref(x[..., :w.shape[1]], w, scale, bias, relu)
    dtype_code("fused_conv3x3", x)
    n, h, wd, cin, cout = _conv_check("fused_conv3x3", x, w)
    x = _gemm_input(x)
    wk = wk or conv3x3_weight(w, x.dtype, dx=False)
    out = torch.empty((n, h, wd, cout), device=x.device, dtype=x.dtype)
    _gemm(x, wk, _opt_f32("scale", scale, (cout,)), _opt_f32("bias", bias, (cout,)), relu,
          out, cin, cout, False)
    fused_conv3x3.launches += 1
    return out


def conv3x3_dx(g: torch.Tensor, w: torch.Tensor, wk: Optional[ConvWeight] = None) -> torch.Tensor:
    """Input gradient of a 3x3 pad-1 conv, conv3x3_p1(g, w flipped and
    io-transposed): g (N, H, W, cout), cout a multiple of 64; w (cout, cin,
    3, 3), rounded to g's dtype -> (N, H, W, cin) in g's dtype. wk: w laid
    out by `conv3x3_weight` in g's dtype, as the forward leaves it (laid out
    here, one more launch, if None); then the call is one launch."""
    if g.device.type == "cpu":
        return conv3x3_dx_ref(g, w)
    dtype_code("conv3x3_dx", g)
    n, h, wd, cout = g.shape
    cin = w.shape[1]
    dense_channels("conv3x3_dx", cout)
    if tuple(w.shape) != (cout, cin, 3, 3):
        raise ValueError(f"conv3x3_dx: g {tuple(g.shape)} and w {tuple(w.shape)} disagree")
    check("g", g, (n, h, wd, cout), g.dtype)
    if wk is None or wk.dx is None:
        wk = conv3x3_weight(w, g.dtype)
    # float32 (dense_conv.cuh) writes whole 64-channel blocks
    width = cin if g.dtype == torch.bfloat16 else _cin64(cin)
    dx = torch.empty((n, h, wd, width), device=g.device, dtype=g.dtype)
    _gemm(g, wk, None, None, False, dx, cin, cout, True)
    conv3x3_dx.launches += 1
    return dx[..., :cin]


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


def conv3x3_dw(x: torch.Tensor, g: torch.Tensor, cin: Optional[int] = None) -> torch.Tensor:
    """Float32 (cout, cin, 3, 3) weight gradient of a 3x3 pad-1 conv of x
    (N, H, W, cx), given g (N, H, W, cout) in x's dtype, cout a multiple of
    64. cin: the conv's input channels, any count, x's first cin (x's
    channels if None); the others, such as the zeros the trainer pads a
    3-channel x with, are not read."""
    cin = cin or x.shape[-1]
    if x.device.type == "cpu":
        return conv3x3_dw_ref(x[..., :cin], g)
    code = dtype_code("conv3x3_dw", x)
    n, h, wd, cx = x.shape
    cout = g.shape[-1]
    dense_channels("conv3x3_dw", cout)
    if not 0 < cin <= cx:
        raise ValueError(f"conv3x3_dw: cin {cin} of an x of {cx} channels")
    check("x", x, (n, h, wd, cx), x.dtype)
    check("g", g, (n, h, wd, cout), x.dtype)
    xk = x if cx % 8 == 0 else F.pad(x, (0, -cx % 8))   # every staging copy is 16 bytes
    cx = xk.shape[-1]
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
    cmid and cout multiples of 64. Four launches: each weight laid out, then
    the two convs, the intermediate through device memory."""
    if x.device.type == "cpu":
        return fused_convstack2_ref(x, w1, s1, b1, w2, s2, b2)
    dtype_code("fused_convstack2", x)
    n, h, wd, cin = x.shape
    cmid, cout = w1.shape[0], w2.shape[0]
    dense_channels("fused_convstack2", cmid, cout)
    if tuple(w1.shape) != (cmid, cin, 3, 3) or tuple(w2.shape) != (cout, cmid, 3, 3):
        raise ValueError(f"fused_convstack2: weights {tuple(w1.shape)}, {tuple(w2.shape)} "
                         f"do not chain from {cin} channels")
    check("x", x, (n, h, wd, cin), x.dtype)
    x = _gemm_input(x)
    vs = tuple(_f32(name, t, (c,)) for name, t, c in
               (("s1", s1, cmid), ("b1", b1, cmid), ("s2", s2, cout), ("b2", b2, cout)))
    mid = torch.empty((n, h, wd, cmid), device=x.device, dtype=x.dtype)
    out = torch.empty((n, h, wd, cout), device=x.device, dtype=x.dtype)
    _gemm(x, conv3x3_weight(w1, x.dtype, dx=False), vs[0], vs[1], True, mid, cin, cmid, False)
    _gemm(mid, conv3x3_weight(w2, x.dtype, dx=False), vs[2], vs[3], True, out, cmid, cout,
          False)
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
    rc = lib_fn("deconv_launch", [INT] + [PTR] * 4 + [INT] * 6 + [PTR])(
        code, x.data_ptr(), wk.data_ptr(), bk.data_ptr(), out.data_ptr(), n, h, wd, cin, cout,
        0, stream(x))
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


def _pool_check(name, x, lanes: int = 4):
    """(n, H, W, C) of the output of a pool kernel's x (N, 2H, 2W, C): H and
    W of x even, C a multiple of `lanes` (the channels a thread takes)."""
    n, h2, w2, c = x.shape
    if h2 % 2 or w2 % 2 or c % lanes:
        raise ValueError(f"{name}: x's height and width must be even and its channels a "
                         f"multiple of {lanes}, got {tuple(x.shape)}")
    check("x", x, (n, h2, w2, c), x.dtype)
    return n, h2 // 2, w2 // 2, c


def max_pool2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 / stride-2 max pool of x (N, 2H, 2W, C): (N, H, W, C). The kernel
    takes 16 bytes of channels a thread: C a multiple of 4 in float32, of 8
    in bfloat16."""
    if x.device.type == "cpu":
        return max_pool2x2_ref(x)
    code = dtype_code("max_pool2x2", x)
    n, h, wd, c = _pool_check("max_pool2x2", x, 16 // x.element_size())
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


WRAPPERS = (fused_conv3x3, conv3x3_dx, conv3x3_dw, fused_convstack2, deconv2x2, deconv2x2_dx,
            deconv2x2_dwdb, max_pool2x2, max_pool2x2_bwd)
for _fn in WRAPPERS:
    _fn.launches = 0


# ------------------------------------------------------------ autograd


class Conv3x3(torch.autograd.Function):
    """`fused_conv3x3` with the JAX VJP's backward (`_fused_bwd`): dx by
    `conv3x3_dx` (skipped when x needs no gradient), dw by `conv3x3_dw`,
    dscale and dbias as plain sums. On a card the forward lays the weight
    out once (`conv3x3_weight`; float32 writes dx's layout only where
    `need_dx` says a backward will take dx), and pads a ragged x to 16
    channels once in bf16, for the forward and dw; scale and bias may be
    None (1 and 0)."""

    @staticmethod
    def forward(ctx, x, w, scale, bias, relu: bool, need_dx: bool):
        ctx.wk = None
        if x.device.type == "cuda":
            x = _gemm_input(x)
            ctx.wk = conv3x3_weight(w, x.dtype, need_dx)
        y = fused_conv3x3(x, w, scale, bias, relu, ctx.wk)
        ctx.relu = relu
        ctx.save_for_backward(x, w, scale, bias, y)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, w, scale, bias, y = ctx.saved_tensors
        need_x, need_w, need_s, need_b = ctx.needs_input_grad[:4]
        gy = wide(gy)
        if ctx.relu:
            gy = gy * (y > 0)
        sums = (0, 1, 2)
        dscale = (gy * ((wide(y) - (0 if bias is None else bias)) / scale)).sum(sums) \
            if need_s else None
        dbias = gy.sum(sums) if need_b else None
        gc = (gy if scale is None else gy * wide(scale)).to(x.dtype).contiguous()
        dx = conv3x3_dx(gc, w, ctx.wk) if need_x else None
        # a bf16 x may carry zero channels beyond w's (padded to 16): dw leaves them
        dw = conv3x3_dw(x, gc, w.shape[1]).to(w.dtype) if need_w else None
        return dx, dw, dscale, dbias, None, None


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
    """Differentiable `fused_conv3x3` (x contiguous NHWC; scale, bias or
    None)."""
    need_dx = torch.is_grad_enabled() and x.requires_grad
    return Conv3x3.apply(x.contiguous(), w, scale, bias, relu, need_dx)


def deconv(x, w, b) -> torch.Tensor:
    """Differentiable `deconv2x2` (x contiguous NHWC)."""
    return Deconv.apply(x.contiguous(), w, b)


def pool2x2(x) -> torch.Tensor:
    """Differentiable `max_pool2x2` (x contiguous NHWC)."""
    return Pool2x2.apply(x.contiguous())
