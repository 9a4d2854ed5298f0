"""K2: fused gated WaveNet stack (forward; the backward recomputes the plain
version under autograd, as the JAX ``_fused_stack_bwd`` does).

Replaces ``visinger_tpu/ops/pallas/wavenet_kernel.py::_wavenet_kernel``
(host side ``_pallas_forward``, entry ``wavenet_fused_forward``).  The CUDA
kernel is ``csrc/wavenet_stack.cu``; its note gives the design: layer by
layer over the whole activation, two tensor-core GEMMs per layer in
float32-accurate 3xTF32 (``csrc/tf32x3.cuh``).  On the H100 the function
is bound by operations (~2·B·T·(L·(K+1)·C·2C − C·C) flops — the last
layer's 1x1 is C -> C — against ~1.5 MB of weights per layer).

K2 is the registered ``torch.library`` op ``visinger_torch::wavenet_stack``:
on a CUDA tensor it launches the kernel (or raises), on a CPU tensor it runs
``wavenet_stack_plain``; no other device has an implementation.
``wavenet_stack`` is the entry point, differentiable: the op's backward
differentiates ``wavenet_stack_plain`` recomputed from the saved inputs.
``launches`` counts stack calls on the card (each runs 2·L kernel
launches).

The kernel's tiles take C in multiples of 32; the wrapper takes any C, as
the TPU kernel does: another C is zero-padded on the card to the next
multiple of 32 (``ops/pad_pack.py``: x, the weights and biases with each
gate half and each res/skip half padded on its own, so a padded channel
gates to exactly 0), and the skip sum is cut back, one padding launch each
side of the stack.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from visinger_tpu_torch.ops import cuda_build, pad_pack

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
    if c % 32 == 0:
        return _launch(x, mask, w_in, g_all, w_rs, b_rs)
    x, w_in, g_all, w_rs, b_rs = pad_channels(x, w_in, g_all, w_rs, b_rs)
    return cut_channels(_launch(x, mask, w_in, g_all, w_rs, b_rs), c)


def channel_jobs(x, w_in, g_all, w_rs, b_rs) -> list:
    """``pad_pack`` jobs that zero-pad x [B, T, C], w_in [L, K, C, 2C],
    g_all [B, L, 2C], w_rs [L, C, 2C] and b_rs [L, 2C] to the next multiple
    of 32 channels, each half of a 2C axis on its own."""
    b, t, c = x.shape
    n_layers, k = w_in.shape[:2]
    cp = pad_pack.padded(c, 32)
    halves = (1, 1, 2, c, cp)       # [.., 2C] -> [.., 2Cp], half by half
    return [(x, (1, 1, 1, c, cp), (b, t, cp)),
            (w_in, (c, cp, 2, c, cp), (n_layers, k, cp, 2 * cp)),
            (g_all, halves, (b, n_layers, 2 * cp)),
            (w_rs, (c, cp, 2, c, cp), (n_layers, cp, 2 * cp)),
            (b_rs, halves, (n_layers, 2 * cp))]


def pad_channels(x, w_in, g_all, w_rs, b_rs) -> list:
    """``channel_jobs`` run in one launch of the padding kernel."""
    return pad_pack.pack(channel_jobs(x, w_in, g_all, w_rs, b_rs))


def cut_channels(out, c: int):
    """The skip sum [B, T, Cp] cut back to its first ``c`` channels."""
    b, t, cp = out.shape
    return pad_pack.pack([(out, (1, 1, 1, c, cp), (b, t, c))],
                         unpack=True)[0]


def _launch(x, mask, w_in, g_all, w_rs, b_rs):
    """One stack call of the kernel on checked, contiguous tensors."""
    global launches
    b, t, c = x.shape
    n_layers, k = w_in.shape[:2]
    lib = cuda_build.load("wavenet_stack")
    fn = lib.wavenet_stack_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    out, h, z = (torch.empty_like(x) for _ in range(3))  # h, z: scratch
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), mask.data_ptr(), w_in.data_ptr(), g_all.data_ptr(),
             w_rs.data_ptr(), b_rs.data_ptr(), out.data_ptr(), h.data_ptr(),
             z.data_ptr(), b, t, c, n_layers, k, stream)
    cuda_build.check(err, "wavenet_stack_fwd")
    launches += 1
    return out


@torch.library.custom_op(
    "visinger_torch::wavenet_stack", mutates_args=(), device_types="cpu",
    schema="(Tensor x, Tensor w_in, Tensor b_in, Tensor w_rs, Tensor b_rs, "
           "Tensor? g_bias, Tensor mask) -> Tensor")
def wavenet_stack_op(x, w_in, b_in, w_rs, b_rs, g_bias, mask):
    """K2 as an op: the skip sum [B, T, C], contiguous."""
    return wavenet_stack_plain(x, w_in, b_in, w_rs, b_rs, g_bias,
                               mask).contiguous()


@wavenet_stack_op.register_kernel("cuda")
def _fwd_cuda(x, w_in, b_in, w_rs, b_rs, g_bias, mask):
    return wavenet_stack_fwd(x, w_in, b_in, w_rs, b_rs, g_bias, mask)


@wavenet_stack_op.register_fake
def _fwd_fake(x, w_in, b_in, w_rs, b_rs, g_bias, mask):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, g):
    """Autograd of the plain version, recomputed from the saved inputs."""
    x, w_in, b_in, w_rs, b_rs, g_bias, mask = ctx.saved_tensors
    ins = [None if a is None else a.detach().requires_grad_(need)
           for a, need in zip((x, w_in, b_in, w_rs, b_rs, g_bias),
                              ctx.needs_input_grad)]
    with torch.enable_grad():
        out = wavenet_stack_plain(*ins, mask)
        wanted = [a for a in ins if a is not None and a.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, g))
    return (*(next(grads) if a is not None and a.requires_grad else None
              for a in ins), None)


wavenet_stack_op.register_autograd(_backward, setup_context=_setup)


def wavenet_stack(x, w_in, b_in, w_rs, b_rs, g_bias, mask):
    """Fused WaveNet stack; arguments as in ``wavenet_stack_plain``."""
    return wavenet_stack_op(x, w_in, b_in, w_rs, b_rs, g_bias, mask)
