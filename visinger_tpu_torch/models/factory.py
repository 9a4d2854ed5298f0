"""Model construction (counterpart of the JAX package's
``models/factory.py``)."""

from __future__ import annotations

import torch

from visinger_tpu_torch.config import Config, check_supported
from visinger_tpu_torch.models.visinger import VISinger, subsystem_dtype
from visinger_tpu_torch.models.vits import VITS
from visinger_tpu_torch.modules.common import set_compute_dtype
from visinger_tpu_torch.modules.discriminator import MultiPeriodDiscriminator


def resolve_device(device) -> torch.device:
    """The requested device; a CUDA device on a machine without CUDA raises
    (entry points never fall back to the CPU on their own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


def build_model(cfg: Config, ph_vocab: int, pitch_vocab: int = 0,
                dur_vocab: int = 0, device="cuda", seed: int = 0):
    """The config's generator (``cfg.model``: a ``VISinger``, or a ``VITS``
    over ``cfg.n_vocab`` symbols, ``ph_vocab`` when that is 0) with the
    torch-default initialisers, drawn on the CPU from ``seed`` (so every
    device gets the same weights), in eval mode on ``device``; a setting
    or width the port does not run on ``device`` raises first."""
    dev = resolve_device(device)
    check_supported(cfg, dev)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        if cfg.model == "vits":
            model = VITS(cfg, cfg.n_vocab or ph_vocab)
        else:
            model = VISinger(cfg, ph_vocab, pitch_vocab, dur_vocab)
    return model.to(dev).eval()


def build_models(cfg: Config, ph_vocab: int, pitch_vocab: int = 0,
                 dur_vocab: int = 0, device="cuda", seed: int = 0
                 ) -> tuple[torch.nn.Module, MultiPeriodDiscriminator]:
    """The generator (``build_model``) and the discriminator (MPD + MSD,
    VISinger's and VITS's alike) for training, drawn
    on the CPU from ``seed`` as ``build_model`` does, on ``device``; the
    discriminator computes in ``compute_dtype`` unless ``bf16_f32_islands``
    holds "disc"."""
    dev = resolve_device(device)
    model = build_model(cfg, ph_vocab, pitch_vocab, dur_vocab, dev, seed)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed + 1)
        disc = MultiPeriodDiscriminator(
            tuple(cfg.disc_periods), cfg.disc_s_base,
            tuple(cfg.disc_p_channels), cfg.disc_pair_batch,
            cfg.use_spectral_norm)
    set_compute_dtype(disc, subsystem_dtype(cfg, "disc"))
    return model, disc.to(dev).eval()
