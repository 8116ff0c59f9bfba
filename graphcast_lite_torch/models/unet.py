"""U-Net model family for regional regular grids (torch counterpart of
``graphcast_lite_tpu.models.unet``).

``WeatherUNet`` (3-level DoubleConv U-Net, stateless batch-statistics
norm, tanh GELU, align-corners bilinear upsampling), ``WeatherUNetV2``
(4-level residual U-Net: GroupNorm ``ResConvBlock``s with squeeze-and-
excitation, a bottleneck of spatial self-attention beside a learned
low-mode spectral convolution) and ``DownscalerUNet`` (the coarse→fine
cascade model, V1's topology under ``unet``).

Layout is PyTorch's NCHW: ``[B, C, H, W]`` in and out.  Children carry
the flax names (``inc``, ``down1``, ``conv_0``, ``bn_0``, ``gn_0``,
``se.fc1``, ``bottleneck_attn.qkv``, ``unet``, …) and are standard torch
layers (``Conv2d``, ``Linear``, ``GroupNorm``, ``LayerNorm``), so the
JAX package's parameter tree maps onto them by a rename and a transpose
(``utils.params.from_flax_params``).

The flax defaults are kept: GELU is the tanh approximation, GroupNorm and
LayerNorm use eps 1e-6, ``BatchStatNorm`` eps 1e-5 with the biased
variance of its input's (N, H, W), in evaluation too (it has no running
averages); inside ``per_sample_statistics()`` each image's (H, W).
``init_weights(generator)`` draws flax's initial values
(LeCun truncated normal kernels, zero biases, unit norm scales, the
spectral weights' scaled normal) from an explicit ``torch.Generator``;
they are not the JAX package's numbers.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "WeatherUNet",
    "WeatherUNetV2",
    "DownscalerUNet",
    "upsample_align_corners",
    "init_weights",
    "per_sample_statistics",
]

_PER_SAMPLE = contextvars.ContextVar("gclt_batch_stat_per_sample",
                                     default=False)


@contextlib.contextmanager
def per_sample_statistics() -> Iterator[None]:
    """Within it, ``BatchStatNorm`` normalizes each image of its input by
    that image's own (H, W) statistics: a batch of B images computes what
    B calls on one image each compute, as the JAX package's trainer
    ``vmap``s the single-image model (``models.grid_adapter``)."""
    token = _PER_SAMPLE.set(True)
    try:
        yield
    finally:
        _PER_SAMPLE.reset(token)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def upsample_align_corners(x: torch.Tensor,
                           out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear upsample with align_corners=True: [B, C, H, W] ->
    [B, C, out_h, out_w]; output index i reads source i·(H−1)/(H'−1)."""
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=True)


def _pool(x: torch.Tensor) -> torch.Tensor:
    """2×2 max pool, stride 2, flooring odd sizes (flax's VALID)."""
    return F.max_pool2d(x, 2, 2)


def _up2(x: torch.Tensor) -> torch.Tensor:
    return upsample_align_corners(x, (x.shape[2] * 2, x.shape[3] * 2))


def _match_and_concat(x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """Zero-pad ``x`` at the end of H and W to ``skip``'s size, then
    concatenate ``[skip, x]`` on channels."""
    dh = skip.shape[2] - x.shape[2]
    dw = skip.shape[3] - x.shape[3]
    if dh > 0 or dw > 0:
        x = F.pad(x, (0, max(dw, 0), 0, max(dh, 0)))
    return torch.cat([skip, x], dim=1)


def _conv3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1, bias=False)


class BatchStatNorm(nn.Module):
    """Stateless batch normalization: normalizes by the current input's
    (N, H, W) statistics (biased variance) with a learnable per-channel
    ``weight`` and ``bias``, in training and evaluation alike; by each
    image's (H, W) statistics inside ``per_sample_statistics()``."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dims = (2, 3) if _PER_SAMPLE.get() else (0, 2, 3)
        mean = x.mean(dim=dims, keepdim=True)
        var = x.var(dim=dims, unbiased=False, keepdim=True)
        w = self.weight[None, :, None, None]
        b = self.bias[None, :, None, None]
        return (x - mean) * torch.rsqrt(var + self.eps) * w + b


class DoubleConv(nn.Module):
    """(Conv3×3 → BatchStatNorm → GELU) twice."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.conv_0 = _conv3(in_channels, features)
        self.bn_0 = BatchStatNorm(features)
        self.conv_1 = _conv3(features, features)
        self.bn_1 = BatchStatNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _gelu(self.bn_0(self.conv_0(x)))
        return _gelu(self.bn_1(self.conv_1(x)))


class WeatherUNet(nn.Module):
    """3-level U-Net predicting a per-step delta: [B, in_channels, H, W]
    -> [B, out_channels, H, W]."""

    def __init__(self, in_channels: int, out_channels: int,
                 base_filters: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        f = base_filters
        self.inc = DoubleConv(in_channels, f)
        self.down1 = DoubleConv(f, 2 * f)
        self.down2 = DoubleConv(2 * f, 4 * f)
        self.down3 = DoubleConv(4 * f, 8 * f)
        self.up1 = DoubleConv(12 * f, 4 * f)
        self.up2 = DoubleConv(6 * f, 2 * f)
        self.up3 = DoubleConv(3 * f, f)
        self.out_conv = nn.Conv2d(f, out_channels, 1)
        init_weights(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.inc(x)
        x2 = self.down1(_pool(x1))
        x3 = self.down2(_pool(x2))
        x4 = self.down3(_pool(x3))
        y = self.up1(_match_and_concat(_up2(x4), x3))
        y = self.up2(_match_and_concat(_up2(y), x2))
        y = self.up3(_match_and_concat(_up2(y), x1))
        return self.out_conv(y)


class SEBlock(nn.Module):
    """Squeeze-and-excitation channel attention (hidden max(c // 8, 4))."""

    def __init__(self, channels: int, reduction: int = 8):
        super().__init__()
        hidden = max(channels // reduction, 4)
        self.fc1 = nn.Linear(channels, hidden)
        self.fc2 = nn.Linear(hidden, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = torch.sigmoid(self.fc2(_gelu(self.fc1(x.mean(dim=(2, 3))))))
        return x * w[:, :, None, None]


class ResConvBlock(nn.Module):
    """(Conv3×3 → GroupNorm → GELU) twice, plus a 1×1 ``skip`` projection
    where the channel count changes, then ``se``."""

    def __init__(self, in_channels: int, features: int,
                 num_groups: int = 8):
        super().__init__()
        g = min(num_groups, features)
        while features % g != 0 and g > 1:
            g -= 1
        self.conv_0 = _conv3(in_channels, features)
        self.gn_0 = nn.GroupNorm(g, features, eps=1e-6)
        self.conv_1 = _conv3(features, features)
        self.gn_1 = nn.GroupNorm(g, features, eps=1e-6)
        self.skip = (nn.Conv2d(in_channels, features, 1, bias=False)
                     if in_channels != features else None)
        self.se = SEBlock(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _gelu(self.gn_0(self.conv_0(x)))
        h = _gelu(self.gn_1(self.conv_1(h)))
        if self.skip is not None:
            x = self.skip(x)
        return self.se(h + x)


class SelfAttention2D(nn.Module):
    """Multi-head self-attention over the H·W tokens, pre-LayerNorm; the
    output is added to the NORMED tokens."""

    def __init__(self, channels: int, heads: int = 4):
        super().__init__()
        self.heads = heads
        self.norm = nn.LayerNorm(channels, eps=1e-6)
        self.qkv = nn.Linear(channels, 3 * channels, bias=False)
        self.proj = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        n, hd = h * w, c // self.heads
        normed = self.norm(x.permute(0, 2, 3, 1).reshape(b, n, c))
        qkv = self.qkv(normed).reshape(b, n, 3, self.heads, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)          # [B, heads, N, hd]
        attn = torch.softmax((q @ k.transpose(-2, -1)) * hd ** -0.5, dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(b, n, c)
        out = normed + self.proj(out)
        return out.reshape(b, h, w, c).permute(0, 3, 1, 2)


class SpectralConv2d(nn.Module):
    """Learned low-mode Fourier layer: the ortho ``rfft2`` over (H, W),
    the low-positive corner [:mh, :mw] (mh = min(modes_h, H), mw =
    min(modes_w, W // 2 + 1)) mixed by complex weights, written into zeros,
    ``irfft2`` back to (H, W)."""

    def __init__(self, in_channels: int, features: int, modes_h: int = 4,
                 modes_w: int = 4):
        super().__init__()
        shape = (in_channels, features, modes_h, modes_w)
        self.weights_re = nn.Parameter(torch.zeros(shape))
        self.weights_im = nn.Parameter(torch.zeros(shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        x_ft = torch.fft.rfft2(x, norm="ortho")
        mh = min(self.weights_re.shape[2], h)
        mw = min(self.weights_re.shape[3], x_ft.shape[-1])
        wc = torch.complex(self.weights_re[:, :, :mh, :mw],
                           self.weights_im[:, :, :mh, :mw])
        low = torch.einsum("bihw,iohw->bohw", x_ft[:, :, :mh, :mw], wc)
        out_ft = x_ft.new_zeros((b, wc.shape[1], h, x_ft.shape[-1]))
        out_ft[:, :, :mh, :mw] = low
        return torch.fft.irfft2(out_ft, s=(h, w), norm="ortho")


class WeatherUNetV2(nn.Module):
    """4-level residual U-Net with the attention + spectral bottleneck:
    [B, in_channels, H, W] -> [B, out_channels, H, W]."""

    def __init__(self, in_channels: int, out_channels: int,
                 base_filters: int = 64, attn_heads: int = 4,
                 spectral_modes: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        f = base_filters
        self.inc = ResConvBlock(in_channels, f)
        self.down1 = ResConvBlock(f, 2 * f)
        self.down2 = ResConvBlock(2 * f, 4 * f)
        self.down3 = ResConvBlock(4 * f, 8 * f)
        self.bottleneck_attn = SelfAttention2D(8 * f, attn_heads)
        self.bottleneck_spectral = SpectralConv2d(8 * f, 8 * f,
                                                  spectral_modes,
                                                  spectral_modes)
        self.bottleneck_mix = ResConvBlock(16 * f, 8 * f)
        self.up1 = ResConvBlock(12 * f, 4 * f)
        self.up2 = ResConvBlock(6 * f, 2 * f)
        self.up3 = ResConvBlock(3 * f, f)
        self.out_conv = nn.Conv2d(f, out_channels, 1)
        init_weights(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.inc(x)
        x2 = self.down1(_pool(x1))
        x3 = self.down2(_pool(x2))
        x4 = self.down3(_pool(x3))
        b = self.bottleneck_mix(torch.cat(
            [self.bottleneck_attn(x4), self.bottleneck_spectral(x4)], dim=1))
        y = self.up1(_match_and_concat(_up2(b), x3))
        y = self.up2(_match_and_concat(_up2(y), x2))
        y = self.up3(_match_and_concat(_up2(y), x1))
        return self.out_conv(y)


class DownscalerUNet(nn.Module):
    """Coarse (bilinearly upsampled) → fine refinement U-Net: V1's
    topology under ``unet``; input the upsampled coarse fields (and any
    static fields), output the fine-grid delta."""

    def __init__(self, in_channels: int, out_channels: int,
                 base_filters: int = 48,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.unet = WeatherUNet(in_channels, out_channels, base_filters,
                                generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.unet(x)


def _lecun_normal_(t: torch.Tensor, fan_in: int,
                   generator: Optional[torch.Generator]) -> None:
    """flax's ``lecun_normal``: a normal truncated at ±2 standard
    deviations, scaled to variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                          generator=generator)


@torch.no_grad()
def init_weights(module: nn.Module,
                 generator: Optional[torch.Generator] = None) -> None:
    """Draw flax's initial values for every layer of a U-Net (in place)
    from ``generator`` (a CPU ``torch.Generator``; None: torch's global
    one)."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            w = torch.empty(m.weight.shape)
            _lecun_normal_(w, fan_in, generator)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (BatchStatNorm, nn.GroupNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, SpectralConv2d):
            c_in, c_out = m.weights_re.shape[:2]
            scale = 1.0 / (c_in * c_out)
            for p in (m.weights_re, m.weights_im):
                p.copy_(scale * torch.randn(p.shape, generator=generator))
