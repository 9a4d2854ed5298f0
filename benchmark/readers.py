"""What the per-layer metric files (``metrics/<name>.py``) share: the port's
kernels by their ``__global__`` names in ``csrc/*.cu``, the library
convolution and GEMM kernels by name, and the roofline share of a kernel
over the traced stretch.

A reader gets the run's ``Reading`` and returns a number, or None when the
run has nothing for it to read (another kind of cell, a kernel that did
not run): the harness then leaves the metric out."""

from __future__ import annotations

import re
import sys

import counters

# the port's kernels (csrc/rel_attention.cu, rel_attention_bf16.cu,
# wavenet_stack.cu): K1 forward, K3 backward (sum_partials_kernel is K3's
# in both libraries), K2 the WaveNet stack
K1 = re.compile(r"rel_attention(_bf16)?_fwd_kernel")
K3 = re.compile(r"rel_attention(_bf16)?_bwd_\w*kernel|sum_partials_kernel")
K2 = re.compile(r"wavenet_(gate|res_skip)_kernel")
# cuDNN and cuBLAS convolution and matrix-product kernels
LIBRARY_PRODUCTS = re.compile(
    r"cudnn|xmma|implicit_convolve|fprop|dgrad|wgrad|gemm|cutlass|nvjet"
    r"|conv2d|conv1d|convolve|winograd|fft", re.IGNORECASE)


class Reading:
    """What a run hands the per-layer metric readers."""

    def __init__(self, kind: str, cfg):
        self.kind, self.cfg = kind, cfg
        self.trace = None
        self.traced = []
        self.mfu_flops = self.mfu_seconds = 0.0
        self.syncs = self.sync_units = 0
        self.launches_off = set()

    def launch_check(self, counts, expected, names) -> None:
        """Note each kernel whose launches in the traced stretch differ
        from the layers the shapes were counted for; its roofline is left
        out."""
        for name, got, want in zip(names, counts, expected):
            if got != want:
                self.launches_off.add(name)
                print(f"run: {name} launched {got} times in the traced "
                      f"stretch, {want} expected: its roofline is left out",
                      file=sys.stderr)


def attention_layers(cfg) -> tuple[int, int]:
    """(token-level, frame-level) relative-attention layers of one forward
    of the kind's path: the score encoder at the token edge; the pitch
    predictor, the frame prior and, in training, the phoneme predictor at
    the frame edge."""
    frame = cfg.frame_prior_layers + (
        cfg.pitch_predictor_layers if cfg.use_pitch_embed else 0)
    return cfg.enc_layers, frame


def attention_least_seconds(reading, work) -> float:
    """The least device seconds of every K1 (``k1_work``) or K3
    (``k3_work``) call of the traced units, at the peak of the build's
    precision."""
    cfg = reading.cfg
    bf16 = cfg.compute_dtype == "bfloat16"
    elem = 2 if bf16 else 4
    peak = counters.PEAKS["bfloat16" if bf16 else "float32"]
    tok_layers, frame_layers = attention_layers(cfg)
    if reading.kind == "train" and cfg.use_phoneme_pred:
        frame_layers += cfg.phoneme_predictor_layers
    total = 0.0
    for u in reading.traced:
        for layers, lengths, t in ((tok_layers, u.token_lengths, u.n),
                                   (frame_layers, u.frame_lengths, u.t)):
            flops, nbytes = work(lengths, t, cfg.hidden_size, cfg.num_heads,
                                 cfg.attn_window_size, elem)
            total += layers * counters.least_seconds(flops, nbytes, peak)
    return total


def k1_least(reading) -> float:
    return attention_least_seconds(reading, counters.k1_work)


def k3_least(reading) -> float:
    return attention_least_seconds(reading, counters.k3_work)


def k2_least_seconds(reading) -> float:
    """The least device seconds of every K2 call of the traced units (the
    posterior's stack in training, and each coupling of the flow), float32
    on the tensor cores."""
    cfg = reading.cfg
    stacks = [(cfg.flow_wn_layers, cfg.flow_wn_kernel)] * cfg.flow_n_flows
    if reading.kind == "train":
        stacks.append((cfg.posterior_wn_layers, cfg.posterior_wn_kernel))
    total = 0.0
    for u in reading.traced:
        for layers, kernel in stacks:
            flops, nbytes = counters.k2_work(u.frame_lengths, u.t,
                                             cfg.hidden_size, layers, kernel)
            total += counters.least_seconds(flops, nbytes,
                                            counters.TC_F32_PEAK)
    return total


def share(least: float, seconds: float):
    """``least`` over ``seconds`` in %, or None when nothing ran."""
    return None if seconds <= 0 else 100.0 * least / seconds


def traced(reading, kind: str) -> bool:
    """Whether the run traced kernels of a ``kind`` cell on the device."""
    return (reading.kind == kind and reading.trace is not None
            and bool(reading.trace.kernels))


def roofline(reading, kind: str, pattern, least_fn):
    if not traced(reading, kind):
        return None
    return share(least_fn(reading), reading.trace.kernel_seconds(pattern))


def conv_share(reading, kind: str):
    if not traced(reading, kind):
        return None
    busy = reading.trace.busy_s
    return share(reading.trace.kernel_seconds(LIBRARY_PRODUCTS), busy)


def mfu(reading, kind: str):
    """Model FLOPs of the untraced part of the window over its seconds at
    the configuration's peak, in %."""
    if not traced(reading, kind) or reading.mfu_seconds <= 0:
        return None
    peak = counters.PEAKS[reading.cfg.compute_dtype]
    return 100.0 * reading.mfu_flops / (reading.mfu_seconds * peak)


def idle(reading, kind: str):
    if not traced(reading, kind) or reading.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - reading.trace.busy_s / reading.trace.window_s)


def launches_per_unit(reading, kind: str):
    if not traced(reading, kind) or not reading.trace.units:
        return None
    return len(reading.trace.kernels) / reading.trace.units
