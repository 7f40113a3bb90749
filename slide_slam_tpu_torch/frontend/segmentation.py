"""Range-image semantic segmentation network (RangeNet++-style) as PyTorch
modules (twin of the flax modules in slide_slam_tpu/frontend/segmentation.py).

A darknet53-style encoder that strides only along the width axis, a mirrored
upsampling decoder with skip connections, and a 1x1 classification head.
Submodules carry the flax names (`DarknetEncoder_0.ConvBNLeaky_0.Conv_0`,
...), so weights cross by path (convert.segmentator_from_flax) and the
reference's torch darknet state_dicts load in flax's walk order
(frontend/torch_convert.py).

Numerics follow flax:
- SAME padding: stride 1 pads (1, 1); stride 2 on the width of an even
  width pads (0, 1), as XLA splits it;
- mixed precision: conv inputs and kernels are cast to `dtype` (bf16 by
  default) and the conv output stays in it; BatchNorm (eps 1e-5),
  leaky-ReLU (0.1) and the residual and skip adds run in f32; the head conv
  is f32 with a bias;
- BatchNorm in training normalises with the batch mean and the biased
  variance E[x^2] - E[x]^2 (clipped at 0) and updates the running
  statistics with momentum 0.99 (flax's convention), both biased.

Inputs are [B, H, W, 5] at the API (range, x, y, z, remission); inside, the
modules run NCHW. An f32 model on the card matches the CPU's only with
TF32 off (`torch.backends.cudnn.allow_tf32 = False`).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def _same_pad(kernel: int, stride: int, size: int):
    """XLA's SAME split (low, high) of one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax nn.Conv with SAME padding, strides (1, stride_w), computing in
    `dtype` (the kernel is kept in f32)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride_w: int = 1,
                 bias: bool = False, dtype=torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.kernel, self.stride_w, self.dtype = kernel, stride_w, dtype

    def forward(self, x):
        ph = _same_pad(self.kernel, 1, x.shape[2])
        pw = _same_pad(self.kernel, self.stride_w, x.shape[3])
        x = F.pad(x.to(self.dtype), (pw[0], pw[1], ph[0], ph[1]))
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, self.weight.to(self.dtype), bias,
                        stride=(1, self.stride_w))


class BatchNorm(nn.Module):
    """flax nn.BatchNorm(momentum=0.99, epsilon=1e-5) in f32 over NCHW."""

    def __init__(self, features: int, momentum: float = 0.99,
                 eps: float = 1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.momentum, self.eps = momentum, eps

    def forward(self, x):
        x = x.float()
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean,
                              min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.mul_(m).add_((1 - m) * mean.detach())
                self.var.mul_(m).add_((1 - m) * var.detach())
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        return (x - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]


class ConvBNLeaky(nn.Module):
    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride_w: int = 1, dtype=torch.bfloat16):
        super().__init__()
        self.Conv_0 = Conv(cin, features, kernel, stride_w, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x):
        return F.leaky_relu(self.BatchNorm_0(self.Conv_0(x)), 0.1)


class ResidualBlock(nn.Module):
    def __init__(self, features: int, dtype=torch.bfloat16):
        super().__init__()
        self.ConvBNLeaky_0 = ConvBNLeaky(features, features // 2, 1,
                                         dtype=dtype)
        self.ConvBNLeaky_1 = ConvBNLeaky(features // 2, features, 3,
                                         dtype=dtype)

    def forward(self, x):
        return x + self.ConvBNLeaky_1(self.ConvBNLeaky_0(x))


class DarknetEncoder(nn.Module):
    """Darknet-53-ish: stage widths 64..1024, width-only strides."""

    def __init__(self, stage_blocks: Sequence[int] = (1, 2, 8, 8, 4),
                 base: int = 64, cin: int = 5, dtype=torch.bfloat16):
        super().__init__()
        self.stage_blocks = tuple(stage_blocks)
        self.ConvBNLeaky_0 = ConvBNLeaky(cin, 32, 3, dtype=dtype)
        self.skip_channels = []
        c, feats, r = 32, base, 0
        for s, blocks in enumerate(self.stage_blocks):
            self.skip_channels.append(c)
            self.add_module(f"ConvBNLeaky_{s + 1}",
                            ConvBNLeaky(c, feats, 3, stride_w=2, dtype=dtype))
            for _ in range(blocks):
                self.add_module(f"ResidualBlock_{r}",
                                ResidualBlock(feats, dtype=dtype))
                r += 1
            c, feats = feats, min(feats * 2, 1024)
        self.out_channels = c

    def forward(self, x):
        skips = []
        x = self.ConvBNLeaky_0(x)
        r = 0
        for s, blocks in enumerate(self.stage_blocks):
            skips.append(x)
            x = getattr(self, f"ConvBNLeaky_{s + 1}")(x)
            for _ in range(blocks):
                x = getattr(self, f"ResidualBlock_{r}")(x)
                r += 1
        return x, skips


class Decoder(nn.Module):
    """Per skip (deepest first): width-only nearest x2 upsample, a 3x3
    ConvBNLeaky to max(c // 2, 32) channels, then the skip added (equal
    widths) or concatenated and mixed by a 1x1 ConvBNLeaky."""

    def __init__(self, cin: int, skip_channels: Sequence[int],
                 dtype=torch.bfloat16):
        super().__init__()
        self.plan = []
        c, k = cin, 0
        for sc in reversed(list(skip_channels)):
            feats = max(c // 2, 32)
            self.add_module(f"ConvBNLeaky_{k}",
                            ConvBNLeaky(c, feats, 3, dtype=dtype))
            concat = sc != feats
            if concat:
                self.add_module(f"ConvBNLeaky_{k + 1}",
                                ConvBNLeaky(feats + sc, feats, 1,
                                            dtype=dtype))
            self.plan.append((k, concat))
            k += 2 if concat else 1
            c = feats
        self.out_channels = c

    def forward(self, x, skips):
        for (k, concat), skip in zip(self.plan, reversed(skips)):
            x = x.repeat_interleave(2, dim=3)[:, :, :, :skip.shape[3]]
            x = getattr(self, f"ConvBNLeaky_{k}")(x)
            if concat:
                x = torch.cat([x, skip.to(x.dtype)], dim=1)
                x = getattr(self, f"ConvBNLeaky_{k + 1}")(x)
            else:
                x = x + skip
        return x


class RangeSegmentator(nn.Module):
    """5-channel range image [B, H, W, 5] -> per-pixel class logits
    [B, H, W, num_classes] (f32)."""

    def __init__(self, num_classes: int = 20,
                 stage_blocks: Sequence[int] = (1, 2, 8, 8, 4),
                 dtype=torch.bfloat16):
        super().__init__()
        self.num_classes, self.dtype = num_classes, dtype
        self.stage_blocks = tuple(stage_blocks)
        self.DarknetEncoder_0 = DarknetEncoder(stage_blocks, dtype=dtype)
        enc = self.DarknetEncoder_0
        self.Decoder_0 = Decoder(enc.out_channels, enc.skip_channels,
                                 dtype=dtype)
        self.Conv_0 = Conv(self.Decoder_0.out_channels, num_classes, 1,
                           bias=True, dtype=torch.float32)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        h, skips = self.DarknetEncoder_0(x)
        d = self.Decoder_0(h, skips)
        return self.Conv_0(d.float()).permute(0, 2, 3, 1)


def small_segmentator(num_classes: int = 16, dtype=torch.bfloat16
                      ) -> RangeSegmentator:
    """Lightweight variant for tests."""
    return RangeSegmentator(num_classes=num_classes, stage_blocks=(1, 1, 2, 2),
                            dtype=dtype)


def init_params(model: RangeSegmentator, generator: torch.Generator
                ) -> RangeSegmentator:
    """flax's default initialisation, drawn from `generator`: conv kernels
    lecun-normal (truncated normal at +-2 sigma, variance 1 / fan_in),
    biases 0, BatchNorm scale 1 / bias 0, running mean 0 / variance 1.
    Returns the model."""
    # std of the unit normal truncated at +-2
    trunc_std = 0.87962566103423978
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, Conv):
                cout, cin, kh, kw = mod.weight.shape
                std = math.sqrt(1.0 / (cin * kh * kw)) / trunc_std
                w = torch.empty(mod.weight.shape, dtype=torch.float32)
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                mod.weight.copy_(w)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, BatchNorm):
                mod.scale.fill_(1.0)
                mod.bias.zero_()
                mod.mean.zero_()
                mod.var.fill_(1.0)
    return model


@torch.no_grad()
def _eval_logits(model: RangeSegmentator, range_input: torch.Tensor):
    """The model's inference-mode logits (running BatchNorm statistics),
    leaving its training flag as it was."""
    was = model.training
    model.eval()
    try:
        return model(range_input)
    finally:
        model.train(was)


def segment(model: RangeSegmentator, range_input: torch.Tensor
            ) -> torch.Tensor:
    """range_input [B, H, W, 5] -> labels [B, H, W] int32 (argmax), on the
    input's device."""
    return _eval_logits(model, range_input).argmax(dim=-1).to(torch.int32)


def crf_refine(xyz: torch.Tensor, softmax: torch.Tensor, mask: torch.Tensor,
               iters: int = 3, window=(3, 5), xyz_sigma: float = 0.7,
               xyz_coef: float = -0.1, compat: torch.Tensor = None,
               compat_bias: torch.Tensor = None) -> torch.Tensor:
    """Mean-field CRF refinement of per-pixel class probabilities on the
    range image: per iteration each pixel gathers its window's class
    probabilities weighted by a Gaussian of 3D distance, mixes the message
    through a class-compatibility matrix ((ones - I) * xyz_coef unless
    given), adds the current softmax and renormalises. The window is a stack
    of rolled copies, wrapping at both image borders as jnp.roll does.

    xyz [B,H,W,3], softmax [B,H,W,C], mask [B,H,W] valid pixels."""
    B, H, W, C = softmax.shape
    wh, ww = window
    assert wh % 2 == 1 and ww % 2 == 1, "window must be odd"
    dev, dt = softmax.device, softmax.dtype
    if compat is None:
        compat = (torch.ones((C, C), dtype=dt, device=dev)
                  - torch.eye(C, dtype=dt, device=dev)) * xyz_coef
    if compat_bias is None:
        compat_bias = torch.zeros((C,), dtype=dt, device=dev)
    den = 2.0 * xyz_sigma * xyz_sigma
    maskf = mask.to(dt)
    shifts = [(dy, dx) for dy in range(-(wh // 2), wh // 2 + 1)
              for dx in range(-(ww // 2), ww // 2 + 1)]
    # the window's weights do not change across iterations
    weights = []
    for dy, dx in shifts:
        x_s = torch.roll(xyz, (dy, dx), dims=(1, 2))
        m_s = torch.roll(maskf, (dy, dx), dims=(1, 2))
        d2 = ((x_s - xyz) ** 2).sum(dim=-1)
        weights.append(torch.exp(-d2 / den) * m_s)
    sm = softmax
    for _ in range(iters):
        sm = sm * maskf[..., None]
        msg = torch.zeros_like(sm)
        for (dy, dx), w in zip(shifts, weights):
            msg = msg + torch.roll(sm, (dy, dx), dims=(1, 2)) * w[..., None]
        sm = torch.softmax(msg @ compat + compat_bias + sm, dim=-1)
    return sm


@torch.no_grad()
def segment_with_crf(model: RangeSegmentator, range_input: torch.Tensor,
                     iters: int = 3, window=(3, 5), xyz_sigma: float = 0.7,
                     xyz_coef: float = -0.1, compat: torch.Tensor = None,
                     compat_bias: torch.Tensor = None) -> torch.Tensor:
    """Forward + CRF refinement -> labels [B, H, W] int32. Channels 1:4 of
    the range image are x, y, z; mask = range > 0."""
    sm = torch.softmax(_eval_logits(model, range_input), dim=-1)
    sm = crf_refine(range_input[..., 1:4], sm, range_input[..., 0] > 0,
                    iters=iters, window=window, xyz_sigma=xyz_sigma,
                    xyz_coef=xyz_coef, compat=compat, compat_bias=compat_bias)
    return sm.argmax(dim=-1).to(torch.int32)
