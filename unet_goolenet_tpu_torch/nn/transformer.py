"""Dual-stream transformer bottleneck (reference 分割/nets/tasks.py).

Counterpart of `unet_goolenet_tpu/nn/transformer.py:62-213`, with the
reference's parameter names (`to_qkv`, `to_out.0`, `net.0`/`net.3`,
`pos_embedding_decoder_cl`, `layers.<i>`). Reference quirks kept:
  * the attention scale is dim**-0.5 (dim = 512), not dim_head**-0.5;
  * both cross-attention directions use `cross_attention_cl`; the declared
    `cross_attention_seg` is never called, so it is not declared here;
  * exact (erf) GELU, LayerNorm eps 1e-5;
  * the positional embeddings are sized by the bottleneck (`pos_size`).
Attention is a plain matmul + float32 softmax. The two Conv2dReLU
projections train with flax's BatchNorm and run on the conv kernel with
`kernels=True`, as the UNet's ConvBatchNorm blocks do (nn/blocks.py).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from unet_goolenet_tpu_torch.nn.blocks import conv_bn_relu


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
           scale: float) -> torch.Tensor:
    """(B, N, H*D) q, k, v -> (B, N, H*D); logits and softmax in float32 (or
    float64)."""
    b, n, hd = q.shape
    d = hd // heads
    split = lambda t: t.reshape(b, -1, heads, d).transpose(1, 2)
    qh, kh, vh = split(q), split(k), split(v)
    wide = torch.promote_types(q.dtype, torch.float32)
    logits = torch.matmul(qh.to(wide), kh.to(wide).transpose(-1, -2)) * scale
    attn = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.matmul(attn, vh)
    return out.transpose(1, 2).reshape(b, n, hd)


class SelfAttention(nn.Module):
    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.scale = heads, dim ** -0.5
        self.to_qkv = nn.Linear(dim, 3 * inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, dim), nn.Dropout(0.0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.to_qkv(x).chunk(3, dim=-1)
        return self.to_out(attend(q, k, v, self.heads, self.scale))


class CrossAttention(nn.Module):
    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.scale = heads, dim ** -0.5
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(dim, inner, bias=False)
        self.to_v = nn.Linear(dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, dim), nn.Dropout(0.0))

    def forward(self, x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        out = attend(self.to_q(x), self.to_k(m), self.to_v(m), self.heads, self.scale)
        return self.to_out(out)


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.net = nn.Sequential(nn.Linear(dim, hidden), nn.GELU(), nn.Dropout(0.0),
                                 nn.Linear(hidden, dim), nn.Dropout(0.0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class MultiAttention(nn.Module):
    """One dual-stream block (tasks.py:149-184)."""

    def __init__(self, dim: int, heads: int, dim_head: int, mlp_dim: int):
        super().__init__()
        self.x_att_norm = nn.LayerNorm(dim)
        self.m_att_norm = nn.LayerNorm(dim)
        self.x_mlp_norm = nn.LayerNorm(dim)
        self.m_mlp_norm = nn.LayerNorm(dim)
        self.attention1 = SelfAttention(dim, heads, dim_head)
        self.attention2 = SelfAttention(dim, heads, dim_head)
        self.cross_attention_cl = CrossAttention(dim, heads, dim_head)
        self.x_feed = FeedForward(dim, mlp_dim)
        self.m_feed = FeedForward(dim, mlp_dim)

    def forward(self, x: torch.Tensor, m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        xn, mn = self.x_att_norm(x), self.m_att_norm(m)
        x_mid = self.attention1(xn) + self.cross_attention_cl(xn, mn) + x
        m_mid = self.attention2(mn) + self.cross_attention_cl(mn, xn) + m
        return (x_mid + self.x_feed(self.x_mlp_norm(x_mid)),
                m_mid + self.m_feed(self.m_mlp_norm(m_mid)))


def conv_relu(dim: int) -> nn.Sequential:
    """Conv2dReLU: conv3x3 (no bias) -> BatchNorm -> ReLU."""
    return nn.Sequential(nn.Conv2d(dim, dim, 3, padding=1, bias=False),
                         nn.BatchNorm2d(dim), nn.ReLU())


class TransformerDecoder(nn.Module):
    """The bottleneck (tasks.py:188-231): per-stream Conv2dReLU + learned 2D
    positional embedding, tokens, `depth` MultiAttention blocks, back to
    NCHW. Returns (x stream, m stream)."""

    def __init__(self, dim: int = 512, depth: int = 1, heads: int = 8,
                 dim_head: int = 64, mlp_dim: int = 2048, pos_size: int = 14,
                 kernels: bool = False):
        super().__init__()
        self.kernels = kernels
        self.conv_cl = conv_relu(dim)
        self.conv_seg = conv_relu(dim)
        self.pos_embedding_decoder_cl = nn.Parameter(torch.zeros(1, dim, pos_size, pos_size))
        self.pos_embedding_decoder_seg = nn.Parameter(torch.zeros(1, dim, pos_size, pos_size))
        self.layers = nn.ModuleList(MultiAttention(dim, heads, dim_head, mlp_dim)
                                    for _ in range(depth))

    def forward(self, x: torch.Tensor, m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        n, c, h, w = x.shape
        x = conv_bn_relu(*self.conv_cl[:2], x, self.kernels) + self.pos_embedding_decoder_cl
        m = conv_bn_relu(*self.conv_seg[:2], m, self.kernels) + self.pos_embedding_decoder_seg
        x = x.flatten(2).transpose(1, 2)
        m = m.flatten(2).transpose(1, 2)
        for layer in self.layers:
            x, m = layer(x, m)
        unflat = lambda t: t.transpose(1, 2).reshape(n, c, h, w)
        return unflat(x), unflat(m)
