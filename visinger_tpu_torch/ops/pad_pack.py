"""Zero padding of widths for K1, K3 and K2, and its inverse.

K1 and K3 (and their bf16 builds) take a head width dk that is a multiple
of 8, K2 channels that are a multiple of 32.  The TPU kernels take any dk up
to 128 and any C, because the JAX package zero-pads each head to 128 lanes
(``visinger_tpu/modules/transformer.py:92-103``) and K2's channels to a
multiple of 128 (``visinger_tpu/ops/pallas/wavenet_kernel.py:140-166``).
For other widths the wrappers in ``rel_attention.py`` and
``wavenet_stack.py`` pad here to the next multiple the kernel takes, launch
the kernel on the padded tensors and cut the results back; zero columns
change no result (``csrc/pad_pack.cu`` says why).

A job is a tensor seen as [A, R, G, D], padded with zeros to
[A, Rp, G, Dp] (``pack``) or cut from [A, Rp, G, Dp] back to [A, R, G, D]
(``pack(..., unpack=True)``): ``dims`` = (R, Rp, G, D, Dp).  On CUDA
tensors every job of one call runs in one launch of ``csrc/pad_pack.cu``
(at most ``MAX_JOBS``), on CPU tensors in ``pack_plain``.  ``launches``
counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from visinger_tpu_torch.ops import cuda_build

MAX_JOBS = 8
launches = 0


def padded(width: int, multiple: int) -> int:
    """``width`` rounded up to a multiple of ``multiple``."""
    return -(-width // multiple) * multiple


def pack_plain(x: torch.Tensor, dims, shape, unpack: bool = False):
    """One job in plain PyTorch: the zero pad (or the cut) of ``x`` with
    ``dims`` = (R, Rp, G, D, Dp), returned contiguous in ``shape``."""
    r, rp, g, d, dp = dims
    if unpack:
        out = x.reshape(-1, rp, g, dp)[:, :r, :, :d]
    else:
        out = F.pad(x.reshape(-1, r, g, d), (0, dp - d, 0, 0, 0, rp - r))
    return out.reshape(shape).contiguous()


def pack(jobs, unpack: bool = False) -> list:
    """Run ``jobs``, each (tensor, dims, result shape), on their device: one
    kernel launch for CUDA tensors (float32 or bf16, contiguous), the plain
    version for CPU tensors.  Returns the results in order."""
    global launches
    if jobs[0][0].device.type == "cpu":
        return [pack_plain(x, dims, shape, unpack) for x, dims, shape in jobs]
    if len(jobs) > MAX_JOBS:
        raise ValueError(f"pad_pack: {len(jobs)} jobs, at most {MAX_JOBS}")
    outs, dims_all, rows, elem = [], [], [], []
    for x, dims, shape in jobs:
        r, rp, g, d, dp = dims
        big, small = (rp * g * dp, r * g * d)
        inner = big if unpack else small
        if (x.device != jobs[0][0].device or x.device.type != "cuda"
                or x.dtype not in (torch.float32, torch.bfloat16)
                or not x.is_contiguous() or x.numel() % inner):
            raise ValueError(f"pad_pack: a job's tensor must be a contiguous "
                             f"float32 or bf16 CUDA tensor of whole [R, G, D] "
                             f"rows, got {x.device} {x.dtype} "
                             f"{tuple(x.shape)} for dims {dims}")
        a = x.numel() // inner
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
        if out.numel() != a * (small if unpack else big):
            raise ValueError(f"pad_pack: result shape {tuple(shape)} does not "
                             f"hold {a} rows of dims {dims}")
        outs.append(out)
        dims_all += [r, rp, g, d, dp]
        rows.append(a)
        elem.append(x.element_size())
    n = len(jobs)
    fn = cuda_build.load("pad_pack").pad_pack
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_longlong),
                   ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                   ctypes.c_int, ctypes.c_void_p]
    stream = torch.cuda.current_stream(outs[0].device).cuda_stream
    err = fn(n, (ctypes.c_void_p * n)(*(x.data_ptr() for x, _, _ in jobs)),
             (ctypes.c_void_p * n)(*(o.data_ptr() for o in outs)),
             (ctypes.c_longlong * n)(*rows), (ctypes.c_int * (5 * n))(
                 *dims_all), (ctypes.c_int * n)(*elem), int(unpack), stream)
    cuda_build.check(err, "pad_pack")
    launches += 1
    return outs
