"""The control of a bf16 configuration: the plain reference with the
operands of every matrix product and convolution of the model and the
discriminators rounded to fp8 (e4m3, each tensor scaled to its range
first), the precision below bf16.  The rounding passes the gradient
straight through, so the backward computes with the rounded operands in
float32.  The STFT and the losses stay float32, as they do in the port's
bf16 recipe."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

E4M3_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / E4M3_MAX
    y = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (y - x).detach()


# the products and the positions of their two operands
PRODUCTS = {F.linear: (0, 1), F.conv1d: (0, 1), F.conv2d: (0, 1),
            F.conv_transpose1d: (0, 1), torch.matmul: (0, 1),
            torch.Tensor.__matmul__: (0, 1), torch.Tensor.matmul: (0, 1),
            torch.bmm: (0, 1), torch.einsum: (1, 2)}


class Fp8Products(TorchFunctionMode):
    """Inside this mode, products take fp8-rounded operands."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        where = PRODUCTS.get(func)
        if where:
            args = list(args)
            for i in where:
                if i < len(args) and isinstance(args[i], torch.Tensor) \
                        and args[i].is_floating_point():
                    args[i] = _fp8(args[i])
        return func(*args, **kwargs)
