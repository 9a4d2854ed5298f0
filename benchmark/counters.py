"""The yardstick's arithmetic from shapes and lengths: the work each port
kernel's function needs (``k1_work``, ``k3_work``, ``k2_work``, frozen
copies of ``chip_smoke.py``'s) and the model FLOPs of a training step and a
synthesis call (``train_step_flops``, ``synth_flops``).

Model FLOPs count the matrix products and convolutions the plain model
computes at the padded shapes, 2 per multiply-add: each product's forward,
and in training the gradients autograd computes for it, one forward's worth
for the input and one for the weight (none for an input that takes no
gradient: the spectrogram, the pitch condition, the real waveform; none
for the discriminator's weights in the generator's update).  A grouped
convolution's weight gradient costs one forward.  Nothing is counted twice
for recomputation.  The optimizer updates add ``ADAM_FLOPS`` per parameter.
Gathers, norms and elementwise work are not counted."""

from __future__ import annotations

# float32 work on the tensor cores in 3xTF32 (495 TFLOP/s dense TF32 over
# three products), bf16 dense, device memory: H100 SXM data sheet
TC_F32_PEAK = 495e12 / 3
BF16_PEAK = 989e12
HBM_RATE = 3.35e12
ADAM_FLOPS = 12       # per parameter and update: moments, bias, decay, step

PEAKS = {"float32": TC_F32_PEAK, "bfloat16": BF16_PEAK}


def k1_work(lengths, t, c, heads, window, elem=4) -> tuple[float, float]:
    """Flops and bytes K1's function needs for these lengths, q, k, v and
    the output of ``elem`` bytes an element.  A valid row
    gives a key at or past its item's length exp(-1e4 - max) = 0 weight, so
    it needs only len keys; every masked row is the same uniform mean of v
    (plus its band term), computed once per (item, head)."""
    dk, nb = c // heads, 2 * window + 1
    flops = nbytes = 0
    for n in lengths:
        flops += heads * (4 * dk * n * n + 4 * nb * dk * n
                          + (dk * (t + nb) if n < t else 0))
        nbytes += elem * c * (2 * n + 2 * t)  # q, k: n rows; v, out: t
    return flops, nbytes + 4 * 2 * nb * dk + 4 * len(lengths)


def k3_work(lengths, t, c, heads, window, elem=4) -> tuple[float, float]:
    """Flops and bytes K3's function needs for these lengths, the [B, T, C]
    tensors of ``elem`` bytes an element.  For each valid
    pair (i, j < len): the score, g.v, and the dq, dk and dv products
    (5 x 2·dk); per valid row the band terms (5 x 2·nb·dk); D_i = g.out
    per row; the masked rows are uniform, so their dv share is one sum of
    their g added to every key."""
    dk, nb = c // heads, 2 * window + 1
    flops = nbytes = 0
    for n in lengths:
        flops += heads * (10 * dk * n * n + 10 * nb * dk * n + 2 * dk * t
                          + (dk * (2 * t - n) if n < t else 0))
        # q, k, v, out: n rows; g: t rows; dq, dk, dv: t rows
        nbytes += elem * c * (4 * n + 4 * t)
    return flops, nbytes + 4 * 4 * nb * dk + 4 * len(lengths) * (1 + heads
                                                                  * t)


def k2_work(lengths, t, c, n_layers, k) -> tuple[float, float]:
    """Flops and bytes K2's function needs for these lengths.  Layer 0
    reads x at every frame; later layers read h, which the stack zeroes at
    or past each item's length, so only len + K//2 frames differ and the
    rest share one value.  The last layer's 1x1 is C -> C (skip half only)."""
    flops = 0
    for n in lengths:
        live = min(t, n + k // 2) + (1 if n + k // 2 < t else 0)
        for i in range(n_layers):
            per_frame = k * c * 2 * c + (c * c if i == n_layers - 1
                                         else c * 2 * c)
            flops += 2 * (t if i == 0 else live) * per_frame
    b = len(lengths)
    weights = (n_layers * k * c * 2 * c + (n_layers - 1) * c * 2 * c + c * c
               + n_layers * 2 * c + (n_layers - 1) * 2 * c + c)
    nbytes = 4 * (2 * b * t * c + b * t + weights + b * n_layers * 2 * c)
    return flops, nbytes


def least_seconds(flops: float, nbytes: float, peak: float) -> float:
    """The least time the card needs for ``flops`` at ``peak`` and
    ``nbytes`` at the memory rate."""
    return max(flops / peak, nbytes / HBM_RATE)


# --- model FLOPs -------------------------------------------------------------

class Tally:
    """Sums products: ``add(fwd, dx, dw)`` counts the forward and, in a
    training tally, the input (dx) and weight (dw) gradients it asks for."""

    def __init__(self, train: bool):
        self.train = train
        self.flops = 0.0

    def add(self, fwd: float, dx: bool = True, dw: bool = True,
            dw_share: float = 1.0) -> None:
        self.flops += fwd
        if self.train:
            self.flops += fwd * (int(dx) + dw_share * int(dw))


def _conv(tally, b, t_out, c_in, c_out, k, groups=1, dx=True, dw=True):
    """A 1-D convolution with ``t_out`` output frames."""
    tally.add(2.0 * b * t_out * c_out * (c_in // groups) * k, dx, dw)


def _attention_layer(tally, b, n, cfg, dx=True):
    """One relative-attention block (projections, scores, band terms, P·V,
    the FFN) at length ``n``."""
    h, heads, w = cfg.hidden_size, cfg.num_heads, cfg.attn_window_size
    dk, nb = h // heads, 2 * w + 1
    for _ in range(4):                                   # q, k, v, o
        tally.add(2.0 * b * n * h * h, dx)
    for fwd in (2.0 * b * heads * n * n * dk, 2.0 * b * heads * n * dk * nb,
                2.0 * b * heads * n * n * dk, 2.0 * b * heads * n * nb * dk):
        tally.add(fwd)                                   # both sides learn
    _conv(tally, b, n, h, cfg.ffn_filter_channels, cfg.ffn_kernel_size)
    _conv(tally, b, n, cfg.ffn_filter_channels, h, 1)


def _encoder(tally, b, n, cfg, layers, pre_in=0, pre_len=1, pre_dx=True):
    """A relative encoder of ``layers`` blocks; ``pre_in`` > 0: its
    ``pre_net`` from ``pre_in`` channels over ``pre_len`` frames."""
    if pre_in:
        _conv(tally, b, pre_len, pre_in, cfg.hidden_size, 1, dx=pre_dx)
    for _ in range(layers):
        _attention_layer(tally, b, n, cfg)


def _wavenet(tally, b, t, c, layers, k, gin):
    if gin:
        _conv(tally, b, 1, gin, 2 * c * layers, 1)
    for _ in range(layers):
        _conv(tally, b, t, c, 2 * c, k)
        tally.add(2.0 * b * t * c * 2 * c)               # res/skip 1x1


def _gin(cfg) -> int:
    return cfg.gin_channels if cfg.use_spk_id or cfg.use_spk_embed else 0


def _prior(tally, b, n, t, cfg, train: bool):
    """Score encoder, pitch predictor and frame prior."""
    h = cfg.hidden_size
    tally.add(2.0 * b * n * 3 * h * h)                   # token linear
    _encoder(tally, b, n, cfg, cfg.enc_layers)
    if cfg.use_pitch_embed:
        _encoder(tally, b, t, cfg, cfg.pitch_predictor_layers, _gin(cfg))
        _conv(tally, b, t, h, 2, 1)
    # the frame prior's condition is the teacher-forced f0 in training
    _encoder(tally, b, t, cfg, cfg.frame_prior_layers,
             1 if cfg.use_pitch_embed else 0, t, pre_dx=not train)
    _conv(tally, b, t, h, 2 * h, 1)


def _flow(tally, b, t, cfg):
    h = cfg.hidden_size
    for _ in range(cfg.flow_n_flows):
        _conv(tally, b, t, h // 2, h, 1)
        _wavenet(tally, b, t, h, cfg.flow_wn_layers, cfg.flow_wn_kernel,
                 _gin(cfg))
        _conv(tally, b, t, h, h // 2, 1)


def _decoder(tally, b, t, cfg):
    ch = cfg.initial_upsample_channels
    _conv(tally, b, t, cfg.hidden_size, ch, 7)
    if _gin(cfg):
        _conv(tally, b, 1, _gin(cfg), ch, 1)
    blocks = list(zip(cfg.dec_kernel_size, cfg.dec_dilation_sizes))
    convs_per_dilation = 2 if str(cfg.dec_blocks) == "1" else 1
    for u, k in zip(cfg.upsample_rates, cfg.upsample_kernel_sizes):
        out = ch // 2
        tally.add(2.0 * b * t * k * ch * out)            # transposed conv
        t *= u
        for rk, dilations in blocks:
            for _ in range(len(dilations) * convs_per_dilation):
                _conv(tally, b, t, out, out, rk)
        ch = out
    _conv(tally, b, t, ch, 1, 7)


def _stft(tally, b, n_frames, cfg, dx: bool, mel: bool = True):
    """Frames @ DFT and, with ``mel``, power @ mel filterbank (constants: no
    weight gradient)."""
    bins = cfg.fft_size // 2 + 1
    tally.add(2.0 * b * n_frames * cfg.fft_size * 2 * bins, dx, False)
    if mel:
        tally.add(2.0 * b * n_frames * bins * cfg.num_mel_bins, dx, False)


def _conv_len(length, k, stride, pad):
    return (length + 2 * pad - k) // stride + 1


def _discriminators(tally, b, length, cfg, first_dx, dx, dw):
    """MSD and MPD on ``b`` waveforms of ``length`` samples."""
    m = cfg.disc_s_base
    specs = [(m, 15, 1, 1, 7), (4 * m, 41, 4, 4, 20), (16 * m, 41, 4, 16, 20),
             (64 * m, 41, 4, 64, 20), (64 * m, 41, 4, min(256, 16 * m), 20),
             (64 * m, 5, 1, 1, 2)]
    c_in, t = 1, length
    for i, (ch, k, s, groups, pad) in enumerate(specs):
        t = _conv_len(t, k, s, pad)
        tally.add(2.0 * b * t * ch * (c_in // groups) * k,
                  first_dx if i == 0 else dx, dw, 1.0)
        c_in = ch
    t = _conv_len(t, 3, 1, 1)
    tally.add(2.0 * b * t * c_in * 3, dx, dw)
    for p in cfg.disc_periods:
        rows = -(-length // p)
        c_in = 1
        chans = list(cfg.disc_p_channels)
        for i, ch in enumerate(chans + [chans[-1]]):
            rows = _conv_len(rows, 5, 3 if i < len(chans) else 1, 2)
            tally.add(2.0 * b * rows * p * ch * c_in * 5,
                      first_dx if i == 0 else dx, dw)
            c_in = ch
        rows = _conv_len(rows, 3, 1, 1)
        tally.add(2.0 * b * rows * p * c_in * 3, dx, dw)


def train_step_flops(cfg, b: int, n: int, t: int,
                     n_params: int = 0) -> float:
    """Model FLOPs of one GAN training step on a batch of ``b`` items padded
    to ``n`` tokens and ``t`` frames; ``n_params`` parameters updated."""
    tally = Tally(train=True)
    h, seg = cfg.hidden_size, cfg.segment_size
    _prior(tally, b, n, t, cfg, train=True)
    _stft(tally, b, t + 1, cfg, dx=False, mel=False)     # linear spectrogram
    tally.add(2.0 * b * t * h * cfg.num_linear_bins, dx=False)  # post. pre
    _wavenet(tally, b, t, h, cfg.posterior_wn_layers, cfg.posterior_wn_kernel,
             _gin(cfg))
    _conv(tally, b, t, h, 2 * h, 1)                      # posterior proj
    if cfg.use_phoneme_pred:
        _encoder(tally, b, t, cfg, cfg.phoneme_predictor_layers)
        _conv(tally, b, t, h, cfg.vocabs[0], 1)
    _flow(tally, b, t, cfg)
    _decoder(tally, b, seg, cfg)
    _stft(tally, b, seg, cfg, dx=False)                  # target slices
    _stft(tally, b, seg + 1, cfg, dx=True)               # generated slice
    if cfg.lambda_mel_adv > 0:
        length = seg * cfg.hop_size
        # the generator's update: the input gradient only
        _discriminators(tally, 2 * b, length, cfg, True, True, False)
        # the discriminator's update: the weight gradients, and the input
        # gradient of every layer but the first
        _discriminators(tally, 2 * b, length, cfg, False, True, True)
    return tally.flops + ADAM_FLOPS * n_params


def synth_flops(cfg, b: int, n: int, t: int) -> float:
    """Model FLOPs of one synthesis call of ``b`` scores padded to ``n``
    tokens and ``t`` frames: the prior, the reverse flow and the
    decoder."""
    tally = Tally(train=False)
    _prior(tally, b, n, t, cfg, train=False)
    _flow(tally, b, t, cfg)
    _decoder(tally, b, t, cfg)
    return tally.flops
