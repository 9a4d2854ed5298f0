"""K2: fused gated WaveNet stack (forward).

Replaces ``visinger_tpu/ops/pallas/wavenet_kernel.py::_wavenet_kernel``
(host side ``_pallas_forward``, entry ``wavenet_fused_forward``).  The CUDA
kernel is ``csrc/wavenet_stack.cu``; its note gives the design.  On the H100
the function is bound by operations (~2·B·T·(L·(K+1)·C·2C − C·C) flops —
the last layer's 1x1 is C -> C — against ~1.5 MB of weights per layer),
and this first kernel runs on the float32 CUDA cores.

``wavenet_stack`` is the entry point: on a CPU tensor it runs
``wavenet_stack_plain``; on a CUDA tensor it launches the kernel or raises.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from visinger_tpu_torch.ops import cuda_build

launches = 0


def _bias(b_in, g_bias, batch):
    """Conv bias plus per-(item, layer) conditioning -> [B, L, 2C]."""
    g_all = b_in[None].expand(batch, -1, -1)
    return g_all if g_bias is None else g_all + g_bias


def wavenet_stack_plain(x, w_in, b_in, w_rs, b_rs, g_bias, mask):
    """The same function in plain PyTorch, the counterpart of the JAX
    ``_stack_forward_xla``.

    x [B, T, C]; w_in [L, K, C, 2C]; b_in [L, 2C]; w_rs [L, C, 2C] (the last
    layer's skip weights in columns [C:2C)); b_rs [L, 2C]; g_bias [B, L, 2C]
    or None; mask [B, T, 1].  Returns the skip sum [B, T, C] (unmasked).
    """
    n_layers, k, c, _ = w_in.shape
    g_all = _bias(b_in, g_bias, x.shape[0])
    h = x.float().transpose(1, 2)                    # [B, C, T]
    m = mask.float().transpose(1, 2)                 # [B, 1, T]
    out = torch.zeros_like(h)
    for i in range(n_layers):
        a = F.conv1d(h, w_in[i].permute(2, 1, 0), padding=k // 2)
        a = a + g_all[:, i, :, None]
        z = torch.tanh(a[:, :c]) * torch.sigmoid(a[:, c:])
        rs = torch.einsum("bct,cd->bdt", z, w_rs[i]) + b_rs[i][None, :, None]
        if i < n_layers - 1:
            h = (h + rs[:, :c]) * m
        out = out + rs[:, c:]
    return out.transpose(1, 2)


def wavenet_stack_fwd(x, w_in, b_in, w_rs, b_rs, g_bias, mask):
    """Launch the CUDA kernel (CUDA float32 tensors only)."""
    global launches
    b, t, c = x.shape
    n_layers, k = w_in.shape[:2]
    args = {"x": x, "w_in": w_in, "b_in": b_in, "w_rs": w_rs, "b_rs": b_rs,
            "mask": mask}
    if g_bias is not None:
        args["g_bias"] = g_bias
    for name, a in args.items():
        if a.device != x.device or a.device.type != "cuda" \
                or a.dtype != torch.float32:
            raise ValueError(f"wavenet_stack_fwd: {name} must be float32 on "
                             f"{x.device}, got {a.device} {a.dtype}")
    shapes = {"w_in": (n_layers, k, c, 2 * c), "b_in": (n_layers, 2 * c),
              "w_rs": (n_layers, c, 2 * c), "b_rs": (n_layers, 2 * c),
              "mask": (b, t, 1), "g_bias": (b, n_layers, 2 * c)}
    for name, a in args.items():
        if name in shapes and tuple(a.shape) != shapes[name]:
            raise ValueError(f"wavenet_stack_fwd: {name} shape "
                             f"{tuple(a.shape)} != {shapes[name]}")
    if k % 2 == 0:
        raise ValueError("wavenet_stack_fwd: kernel size must be odd")
    x, w_in, w_rs, b_rs, mask = (a.contiguous()
                                 for a in (x, w_in, w_rs, b_rs, mask))
    g_all = _bias(b_in, g_bias, b).contiguous()
    lib = cuda_build.load("wavenet_stack")
    fn = lib.wavenet_stack_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), mask.data_ptr(), w_in.data_ptr(), g_all.data_ptr(),
             w_rs.data_ptr(), b_rs.data_ptr(), out.data_ptr(),
             b, t, c, n_layers, k, stream)
    cuda_build.check(err, "wavenet_stack_fwd")
    launches += 1
    return out


def wavenet_stack(x, w_in, b_in, w_rs, b_rs, g_bias, mask):
    """Fused WaveNet stack; arguments as in ``wavenet_stack_plain``."""
    if x.device.type == "cpu":
        return wavenet_stack_plain(x, w_in, b_in, w_rs, b_rs, g_bias, mask)
    return wavenet_stack_fwd(x, w_in, b_in, w_rs, b_rs, g_bias, mask)
