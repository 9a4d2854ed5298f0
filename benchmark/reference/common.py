"""Shared layers, [B, C, T] layout (a frozen plain copy of the PyTorch
port's ``modules/common.py``).

  - ``Conv1d`` (grouped, strided, torch "same" or explicit padding),
    ``ConvTranspose1d`` and the period discriminator's ``Conv2dP``, with an
    explicit weight norm g·v/sqrt(Σv² + 1e-12) over every axis but the
    out-feature (``torch.nn.utils.weight_norm`` on a transposed conv
    normalises per *input* channel, the wrong axis);
  - ``dropout`` with masks from an explicit generator;
  - ``ChannelLayerNorm`` (eps 1e-4, float32 statistics);
  - ``TokenEmbedding`` (row 0 zero, N(0, H^-0.5));
  - sinusoidal positions from the nonpadding cumsum.

Initialisers reproduce the JAX package's torch-default ones:
U(±1/sqrt(fan_in)) for kernels and biases (fan_in = in/groups·k), fan =
k·out for a transposed conv's kernel and bias, and weight-norm g = ||v|| at
init.

Compute dtype.  Parameters stay float32.  A layer with a ``dtype``
attribute (float32 unless ``set_compute_dtype`` changes it) casts its input,
its effective weight and its bias to that dtype and computes in it, as the
JAX package's ``dtype=`` modules do; LayerNorm keeps float32 statistics
and returns its input's dtype.  ``use_spectral_norm`` replaces the weight
norm of the discriminators' convolutions by ``spectral_normalize``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LRELU_SLOPE = 0.1


def torch_conv_pad(kernel_size: int, dilation: int = 1) -> int:
    """Length-preserving pad for odd kernels."""
    return (kernel_size * dilation - dilation) // 2


def _weight_norm(v: torch.Tensor, g: torch.Tensor, out_dim: int) -> torch.Tensor:
    dims = [d for d in range(v.dim()) if d != out_dim]
    norm = torch.sqrt(torch.sum(v * v, dim=dims, keepdim=True) + 1e-12)
    shape = [1] * v.dim()
    shape[out_dim] = -1
    return v * (g.reshape(shape) / norm)


def _init_weight_norm(module: nn.Module, v: torch.Tensor, out_dim: int):
    dims = [d for d in range(v.dim()) if d != out_dim]
    module.weight_v = nn.Parameter(v)
    module.weight_g = nn.Parameter(
        torch.sqrt(torch.sum(v * v, dim=dims) + 1e-12))


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> None:
    """Make ``module`` and every layer below it that has a compute dtype
    (a ``dtype`` class attribute) compute in ``dtype``."""
    for m in module.modules():
        if hasattr(type(m), "dtype"):
            m.dtype = dtype


def in_dtype(fn, x, w, bias, dtype, **kw):
    """``fn(x, w, bias)`` in ``dtype``.  Below float32 the bias is added
    after the product is rounded, as the JAX layers add it."""
    x, w = x.to(dtype), w.to(dtype)
    if dtype == torch.float32 or bias is None:
        return fn(x, w, bias, **kw)
    y = fn(x, w, None, **kw)
    # channels last after a linear, second after a convolution
    shape = (-1,) if fn is F.linear else (-1,) + (1,) * (y.dim() - 2)
    return y + bias.to(dtype).reshape(shape)


@torch.no_grad()
def _power_iteration(mat: torch.Tensor, n_iters: int):
    u = torch.full((mat.shape[0],), mat.shape[0] ** -0.5, dtype=mat.dtype,
                   device=mat.device)
    for _ in range(n_iters):
        v = mat.t() @ u
        v = v / torch.linalg.vector_norm(v).clamp(min=1e-12)
        u = mat @ v
        u = u / torch.linalg.vector_norm(u).clamp(min=1e-12)
    return u, v


def spectral_normalize(w: torch.Tensor, n_iters: int = 5) -> torch.Tensor:
    """w / σ_max(w), stateless: the JAX package's ``spectral_normalize``.
    The matrix is w (out-features first) with every other axis flattened
    into rows, in the JAX kernel's axis order ([k, in, out] -> [k·in,
    out]); the power iteration restarts from the fixed vector 1/sqrt(rows)
    with ``n_iters`` steps every call (no state across steps, unlike
    ``torch.nn.utils.spectral_norm``), and σ = uᵀ W v takes no gradient."""
    mat = w.permute(*reversed(range(1, w.dim())), 0).reshape(-1, w.shape[0])
    u, v = _power_iteration(mat.detach(), n_iters)
    sigma = (u @ mat.detach() @ v).clamp(min=1e-12)
    return w / sigma


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator | None) -> torch.Tensor:
    """Keep each entry with probability 1 - rate (scaled by 1/(1 - rate)),
    the mask drawn from ``generator``; the identity when ``generator`` is
    None (evaluation) or ``rate`` is 0."""
    if generator is None or rate <= 0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x * (1.0 / (1.0 - rate)), torch.zeros_like(x))


class Conv1d(nn.Module):
    """1-D convolution on [B, C, T]; weight [out, in/groups, k].

    ``padding`` None gives torch "same" padding.  ``init``: "torch"
    (U(±1/sqrt(in/groups·k))), "xavier" (xavier-uniform, the attention
    projections) or "zeros" (the flow's ``post``); the bias is always
    U(±1/sqrt(in/groups·k)).  ``spectral_norm`` divides the plain weight by
    its largest singular value (``spectral_normalize``).
    """

    dtype = torch.float32

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 1, dilation: int = 1, bias: bool = True,
                 weight_norm: bool = False, init: str = "torch",
                 stride: int = 1, groups: int = 1, padding: int | None = None,
                 spectral_norm: bool = False):
        super().__init__()
        if in_channels % groups or out_channels % groups:
            raise ValueError(f"Conv1d: channels {in_channels}->{out_channels} "
                             f"not divisible by groups {groups}")
        self.dilation = dilation
        self.stride = stride
        self.groups = groups
        self.padding = torch_conv_pad(kernel_size, dilation) \
            if padding is None else padding
        self.weight_norm = weight_norm
        self.spectral_norm = spectral_norm
        fan_in = in_channels // groups * kernel_size
        v = torch.empty(out_channels, in_channels // groups, kernel_size)
        if init == "torch":
            nn.init.uniform_(v, -fan_in ** -0.5, fan_in ** -0.5)
        elif init == "xavier":
            nn.init.xavier_uniform_(v)
        elif init == "zeros":
            nn.init.zeros_(v)
        else:
            raise ValueError(f"Conv1d: unknown init {init!r}")
        if weight_norm:
            _init_weight_norm(self, v, 0)
        else:
            self.weight = nn.Parameter(v)
        self.bias = nn.Parameter(
            torch.empty(out_channels).uniform_(-fan_in ** -0.5,
                                               fan_in ** -0.5)) \
            if bias else None

    def effective_weight(self) -> torch.Tensor:
        if self.weight_norm:
            return _weight_norm(self.weight_v, self.weight_g, 0)
        if self.spectral_norm:
            return spectral_normalize(self.weight)
        return self.weight

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return in_dtype(F.conv1d, x, self.effective_weight(), self.bias,
                        self.dtype, stride=self.stride, padding=self.padding,
                        dilation=self.dilation, groups=self.groups)


class ConvTranspose1d(nn.Module):
    """``F.conv_transpose1d(stride=u, padding=(k-u)//2)``: length T -> T·u.

    Weight [in, out, k] is the JAX kernel [k, in, out] permuted (1, 2, 0)
    with no flip: the JAX package flips only because it lowers the op to an
    lhs-dilated convolution."""

    dtype = torch.float32

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int):
        super().__init__()
        self.stride = stride
        self.padding = (kernel_size - stride) // 2
        bound = (kernel_size * out_channels) ** -0.5
        v = torch.empty(in_channels, out_channels, kernel_size)
        nn.init.uniform_(v, -bound, bound)
        _init_weight_norm(self, v, 1)
        self.bias = nn.Parameter(
            torch.empty(out_channels).uniform_(-bound, bound))

    def effective_weight(self) -> torch.Tensor:
        return _weight_norm(self.weight_v, self.weight_g, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return in_dtype(F.conv_transpose1d, x, self.effective_weight(),
                        self.bias, self.dtype, stride=self.stride,
                        padding=self.padding)


class Conv2dP(nn.Module):
    """The period discriminator's 2-D conv on [B, C, H, W]: kernel (kh, 1),
    stride (sh, 1), padding ((kh-1)//2, 0), weight-norm weight
    [out, in, kh, 1] (the JAX kernel [kh, 1, in, out] permuted (3, 2, 0, 1))
    and a bias; with ``spectral_norm`` a plain ``weight`` divided by its
    largest singular value instead."""

    dtype = torch.float32

    def __init__(self, in_channels: int, out_channels: int, kernel_h: int,
                 stride_h: int = 1, spectral_norm: bool = False):
        super().__init__()
        self.stride = (stride_h, 1)
        self.padding = (torch_conv_pad(kernel_h), 0)
        self.spectral_norm = spectral_norm
        bound = (in_channels * kernel_h) ** -0.5
        v = torch.empty(out_channels, in_channels, kernel_h, 1)
        nn.init.uniform_(v, -bound, bound)
        if spectral_norm:
            self.weight = nn.Parameter(v)
        else:
            _init_weight_norm(self, v, 0)
        self.bias = nn.Parameter(
            torch.empty(out_channels).uniform_(-bound, bound))

    def effective_weight(self) -> torch.Tensor:
        if self.spectral_norm:
            return spectral_normalize(self.weight)
        return _weight_norm(self.weight_v, self.weight_g, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return in_dtype(F.conv2d, x, self.effective_weight(), self.bias,
                        self.dtype, stride=self.stride, padding=self.padding)


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channel axis of [B, C, T], eps 1e-4, statistics in
    float32."""

    def __init__(self, channels: int, eps: float = 1e-4):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=1, keepdim=True)
        var = (xf - mean).square().mean(dim=1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.gamma[:, None] + self.beta[:, None]).to(x.dtype)


class TokenEmbedding(nn.Embedding):
    """Embedding with a zero row 0 (padding) and N(0, H^-0.5) init."""

    def __init__(self, vocab_size: int, features: int):
        super().__init__(vocab_size, features)
        with torch.no_grad():
            self.weight.normal_(0.0, features ** -0.5)
            self.weight[0] = 0.0


def sinusoidal_table(num_positions: int, dim: int) -> np.ndarray:
    """tensor2tensor-style sin/cos table with zeroed row 0 (padding):
    concat(sin, cos) halves, not interleaved."""
    half = dim // 2
    scale = math.log(10000) / (half - 1)
    freqs = np.exp(np.arange(half, dtype=np.float64) * -scale)
    ang = np.arange(num_positions, dtype=np.float64)[:, None] * freqs[None, :]
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=1)
    if dim % 2 == 1:
        emb = np.concatenate([emb, np.zeros((num_positions, 1))], axis=1)
    emb[0, :] = 0.0
    return emb.astype(np.float32)


def positional_embedding(nonpadding: torch.Tensor, dim: int) -> torch.Tensor:
    """[B, T] mask -> [B, T, dim] sinusoidal embeddings; positions are the
    cumsum of the mask, so padding gets position 0 and a zero embedding."""
    half = dim // 2
    scale = math.log(10000) / (half - 1)
    freqs = torch.from_numpy(
        np.exp(np.arange(half) * -scale).astype(np.float32)).to(
            nonpadding.device)
    mask = (nonpadding > 0).to(torch.int32)
    positions = torch.cumsum(mask, dim=1) * mask
    ang = positions.float()[..., None] * freqs
    emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb * (positions != 0)[..., None]
