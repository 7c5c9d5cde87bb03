"""Conv blocks with the JAX package's dtype policy and init schemes.

State-dict keys follow the reference: a ``conv_block`` is
``nn.Sequential(Conv2d, LeakyReLU(0.1))`` (keys ``<name>.0.weight`` and
``<name>.0.bias``); the flow heads are bare ``Conv2d`` (``<name>.weight``).

Dtype policy (``unopticalflow_tpu/models/layers.py::conv_apply``): weights
are stored in float32; with a compute dtype set, the weight and the input are
cast to it, the convolution runs in it and the bias is added in it.

Init (``scheme``): ``"torch"`` is torch.nn.Conv2d's default,
uniform(+-1/sqrt(fan_in)) for weight and bias; ``"pwc"`` is PWC-Net's
kaiming_normal (fan_in, LeakyReLU(0.1) gain) with zero bias.  At the
``"torch"`` init the network is nearly input-blind (see the JAX module's
docstring), so parity tests use ``"pwc"``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

LEAKY_SLOPE = 0.1


class Conv2d(nn.Conv2d):
    """``ksize`` x ``ksize`` conv (3 by default), padding = dilation * (ksize //
    2) as the JAX ``raw_conv`` pads, with the compute-dtype policy above."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1, dilation: int = 1,
                 device=None, ksize: int = 3):
        super().__init__(in_ch, out_ch, ksize, stride=stride, padding=dilation * (ksize // 2),
                         dilation=dilation, device=device)
        self.compute_dtype: torch.dtype | None = None

    def reset_parameters(self, scheme: str = "torch", generator: torch.Generator | None = None):
        fan_in = self.in_channels * self.kernel_size[0] * self.kernel_size[1]
        with torch.no_grad():
            if scheme == "pwc":
                std = math.sqrt(2.0 / (1.0 + LEAKY_SLOPE**2)) / math.sqrt(fan_in)
                self.weight.copy_(std * _draw(torch.randn, self.weight, generator))
                self.bias.zero_()
            elif scheme == "torch":
                bound = 1.0 / math.sqrt(fan_in)
                for p in (self.weight, self.bias):
                    p.copy_((2.0 * _draw(torch.rand, p, generator) - 1.0) * bound)
            else:
                raise ValueError(f"unknown init scheme {scheme!r} (torch|pwc)")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv(x, self.padding)

    def forward_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The same convolution of a row slab that already carries the rows
        above and below it that its output rows read (a row-shard with its
        halo, ``parallel/spatial.py``): no padding along H, the usual along W.
        The weights are moved to the slab's device when they live elsewhere."""
        return self._conv(x, (0, self.padding[1]))

    def _conv(self, x: torch.Tensor, padding) -> torch.Tensor:
        dt = self.compute_dtype or x.dtype
        x = x.to(dt)
        out = F.conv2d(x, self.weight.to(x.device, dt), None, self.stride, padding,
                       self.dilation)
        return out + self.bias.to(x.device, dt)[:, None, None]


def _draw(fn, like: torch.Tensor, generator) -> torch.Tensor:
    """Draw on the generator's device (CPU by default), then move to ``like``."""
    dev = generator.device if generator is not None else "cpu"
    return fn(like.shape, generator=generator, device=dev).to(like.device)


def conv_block(in_ch: int, out_ch: int, stride: int = 1, dilation: int = 1,
               device=None) -> nn.Sequential:
    """conv + LeakyReLU(0.1): the reference's ``conv`` helper."""
    return nn.Sequential(
        Conv2d(in_ch, out_ch, stride, dilation, device=device),
        nn.LeakyReLU(LEAKY_SLOPE),
    )


def init_convs(module: nn.Module, scheme: str, generator: torch.Generator | None):
    """Re-initialise every ``Conv2d`` under ``module`` in registration order."""
    for m in module.modules():
        if isinstance(m, Conv2d):
            m.reset_parameters(scheme, generator)


def set_compute_dtype(module: nn.Module, dtype: torch.dtype | None):
    for m in module.modules():
        if isinstance(m, Conv2d):
            m.compute_dtype = dtype
