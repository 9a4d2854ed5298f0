"""Model construction (counterpart of the JAX package's
``models/factory.py``)."""

from __future__ import annotations

import torch

from visinger_tpu_torch.config import Config
from visinger_tpu_torch.models.visinger import VISinger


def resolve_device(device) -> torch.device:
    """The requested device; a CUDA device on a machine without CUDA raises
    (entry points never fall back to the CPU on their own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


def build_model(cfg: Config, ph_vocab: int, pitch_vocab: int, dur_vocab: int,
                device="cuda", seed: int = 0) -> VISinger:
    """A VISinger with the torch-default initialisers, drawn on the CPU from
    ``seed`` (so every device gets the same weights), in eval mode on
    ``device``."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = VISinger(cfg, ph_vocab, pitch_vocab, dur_vocab)
    return model.to(dev).eval()
