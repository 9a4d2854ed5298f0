"""Serving export (the counterpart of the JAX package's ``infer/export.py``):
the synthesis program written once with ``torch.export`` and served
without the model source.

The program is the live path of ``VISingerInfer``: ``infer_prior`` then
``decode_frames`` in eval mode, score tokens -> prior sample -> flow
reverse -> HiFi-GAN -> waveform.  It takes the prior noise eps [B, nf, H]
as an input (the JAX program draws it from a seed with ``jax.random``,
which PyTorch cannot reproduce); the loader draws it as the live path does
(``prior_noise``), so an artifact's waveform for a score and a seed equals
the live path's at the same padding.  Kernels K1 and K2 (and K1's bf16
build in a bf16 model) are registered ops (``ops/rel_attention.py``,
``ops/wavenet_stack.py``) and stay nodes of the program.

Artifact layout (a directory):
  synthesis_t{N}_f{T}.pt2   the ``torch.export`` program of one
                            (token, frame) bucket; its weights are inputs
  weights.pt                the generator's parameters, one file for every
                            bucket (``torch.save``; loaded with
                            ``weights_only=True``)
  meta.json                 version, the device type it was exported for,
                            compute dtype, batch size, buckets, voice
                            embedding, audio parameters, and the kernel
                            libraries the programs call

A program bakes in tensors on the device it was traced on (the positional
table, for one), so an artifact serves that device type only: the loader
refuses another.  ``ExportedSynthesizer`` imports torch, numpy and the
port's op registrations (``visinger_tpu_torch.ops``), nothing of the model,
the modules, the config, training or data; ``export_synthesis`` imports the
config and the model factory when it is called.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

# importing the package registers K1, K3 and K2 as ops, which the programs
# call
from visinger_tpu_torch.ops import cuda_build

ARTIFACT_VERSION = 1
WEIGHTS = "weights.pt"


def bucket_file(n_tokens: int, n_frames: int) -> str:
    return f"synthesis_t{n_tokens}_f{n_frames}.pt2"


def prior_noise(n_frames: int, hidden: int, seed: int) -> torch.Tensor:
    """A score's prior noise eps [1, n_frames, hidden], float32, drawn on
    the CPU from a generator seeded by ``seed``: the same on every
    device, for the live path and for an artifact."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(1, n_frames, hidden, generator=gen)


class _Synthesis(torch.nn.Module):
    """The live synthesis path of ``model`` as a module's forward."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, text_tokens, note_pitch, note_dur, mel2ph, spk_ids, eps,
                spk_embed=None):
        z_p, mask = self.model.infer_prior(
            text_tokens, note_pitch, note_dur, mel2ph, spk_id=spk_ids,
            eps=eps, spk_embed=spk_embed)
        return self.model.decode_frames(z_p, mask, spk_id=spk_ids,
                                        spk_embed=spk_embed)


class _Program(torch.nn.Module):
    """``_Synthesis`` with the weights as the first input: the traced
    program holds no parameter, so every bucket shares one weights file."""

    def __init__(self, synthesis: _Synthesis):
        super().__init__()
        self.__dict__["synthesis"] = synthesis   # not a submodule

    def forward(self, params, *inputs):
        return torch.func.functional_call(self.synthesis, params, inputs)


def _kernels(program) -> set:
    """The kernel libraries an exported program calls: K1's by the dtype of
    its q, K2's, and the padding kernel's for a head width or a channel
    count that K1 or K2 take padded."""
    libs = set()
    for node in program.graph.nodes:
        if node.target is torch.ops.visinger_torch.rel_attention_fwd.default:
            bf16 = node.args[0].meta["val"].dtype == torch.bfloat16
            libs.add("rel_attention_bf16" if bf16 else "rel_attention")
            if node.args[3].meta["val"].shape[1] % 8:     # emb_rel_k's dk
                libs.add("pad_pack")
        elif node.target is torch.ops.visinger_torch.wavenet_stack.default:
            libs.add("wavenet_stack")
            if node.args[0].meta["val"].shape[-1] % 32:   # x's channels
                libs.add("pad_pack")
    return libs


def _drop_no_ops(program) -> None:
    """Remove what the tracer records around casts that change nothing: the
    metadata asserts and each cast of a tensor to its own dtype, many of a
    program's nodes (each one parsed at every load and dispatched at every
    call)."""
    graph = program.graph
    for node in list(graph.nodes):
        if node.target is torch.ops.aten._assert_tensor_metadata.default:
            graph.erase_node(node)
        elif (node.target is torch.ops.aten.to.dtype and len(node.args) == 2
              and not node.kwargs
              and node.args[0].meta["val"].dtype == node.args[1]):
            node.replace_all_uses_with(node.args[0])
            graph.erase_node(node)
    program.graph_module.recompile()


def export_synthesis(cfg, model, out_dir: str, *, batch_size: int = 1,
                     buckets: list[tuple[int, int]] | None = None,
                     device="cuda") -> dict:
    """Export the synthesis program of ``model`` (a port ``VISinger``, moved
    to ``device`` and set to eval mode) for each (n_tokens, n_frames) of
    ``buckets`` (default: the largest configured token and frame buckets)
    at ``batch_size`` into ``out_dir``; returns the meta dict."""
    from visinger_tpu_torch.config import check_supported
    from visinger_tpu_torch.models.factory import resolve_device
    from visinger_tpu_torch.utils.audio.spk_embed import SPK_EMBED_DIM

    dev = resolve_device(device)
    check_supported(cfg, dev)
    if buckets is None:
        buckets = [(max(cfg.token_buckets), max(cfg.frame_buckets))]
    buckets = [(int(nt), int(nf)) for nt, nf in buckets]
    use_spk_embed = bool(cfg.use_spk_embed)
    model = model.to(dev).eval()
    params = {f"model.{k}": v.detach()
              for k, v in model.state_dict(keep_vars=True).items()}
    program = _Program(_Synthesis(model))
    os.makedirs(out_dir, exist_ok=True)
    libs = set()
    b, h = batch_size, cfg.hidden_size
    for nt, nf in buckets:
        # distinct tensors: the tracer takes one tensor passed twice for
        # one input of the program
        tokens = [torch.ones(b, nt, dtype=torch.long, device=dev)
                  for _ in range(3)]
        mel2ph = torch.clamp(torch.arange(nf, device=dev) * nt // nf + 1,
                             max=nt).expand(b, nf).contiguous()
        args = [*tokens, mel2ph, torch.zeros(b, dtype=torch.long, device=dev),
                torch.zeros(b, nf, h, device=dev)]
        if use_spk_embed:
            args.append(torch.zeros(b, SPK_EMBED_DIM, device=dev))
        with torch.no_grad():
            exported = torch.export.export(program, (params, *args))
        _drop_no_ops(exported)
        libs |= _kernels(exported)
        exported._example_inputs = None     # else saved with the program
        torch.export.save(exported, os.path.join(out_dir, bucket_file(nt, nf)))
    torch.save({k[len("model."):]: v.cpu() for k, v in params.items()},
               os.path.join(out_dir, WEIGHTS))
    meta = {
        "artifact_version": ARTIFACT_VERSION,
        "torch_version": torch.__version__,
        "device": dev.type,
        "compute_dtype": str(cfg.compute_dtype),
        "batch_size": batch_size,
        "buckets": [[nt, nf] for nt, nf in buckets],
        "hidden_size": h,
        "use_spk_embed": use_spk_embed,
        "spk_embed_dim": SPK_EMBED_DIM if use_spk_embed else 0,
        "sample_rate": int(cfg.sample_rate),
        "hop_size": int(cfg.hop_size),
        "out_wav_norm": bool(cfg.out_wav_norm),
        "kernels": sorted(libs),
    }
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


class ExportedSynthesizer:
    """Load and serve an artifact of ``export_synthesis`` on ``device`` (the
    card unless the CPU is asked for), with no model source.

    ``__call__`` takes one unpadded score (1-D int arrays), pads it to the
    smallest exported bucket that fits (ordered by frames, then tokens),
    draws its noise from ``seed`` and returns the valid waveform samples,
    ``len(mel2ph) * hop_size``."""

    def __init__(self, art_dir: str, device="cuda"):
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but CUDA is not available; "
                "serve an artifact exported for the CPU with device='cpu'")
        self.art_dir = art_dir
        with open(os.path.join(art_dir, "meta.json")) as f:
            self.meta = json.load(f)
        if self.meta["artifact_version"] > ARTIFACT_VERSION:
            raise ValueError(
                f"artifact version {self.meta['artifact_version']} is newer "
                f"than this loader ({ARTIFACT_VERSION})")
        if self.meta["device"] != dev.type:
            raise ValueError(
                f"the artifact in {art_dir} was exported for "
                f"{self.meta['device']!r} and serves that device type only, "
                f"not {dev.type!r}: export it again on {dev.type!r}")
        self.device = dev
        if dev.type == "cuda":   # build the kernels now, not in a first call
            cuda_build.build_all(self.meta["kernels"])
            for name in self.meta["kernels"]:
                cuda_build.load(name)
        self.buckets = sorted((tuple(b) for b in self.meta["buckets"]),
                              key=lambda b: (b[1], b[0]))
        weights = torch.load(os.path.join(art_dir, WEIGHTS), map_location=dev,
                             weights_only=True)
        self.params = {f"model.{k}": v for k, v in weights.items()}
        self._calls: dict[tuple[int, int], torch.nn.Module] = {}

    def program(self, bucket: tuple[int, int]) -> torch.nn.Module:
        """The program of ``bucket``, loaded at its first use."""
        if bucket not in self._calls:
            program = torch.export.load(os.path.join(self.art_dir,
                                                     bucket_file(*bucket)))
            self._calls[bucket] = program.module()
        return self._calls[bucket]

    def bucket_for(self, n_tokens: int, n_frames: int) -> tuple[int, int]:
        for nt, nf in self.buckets:
            if n_tokens <= nt and n_frames <= nf:
                return nt, nf
        raise ValueError(
            f"score ({n_tokens} tokens, {n_frames} frames) exceeds every "
            f"exported bucket {self.buckets} — split into phrases or "
            "export again with larger buckets")

    def pad(self, text_tokens, note_pitch, note_dur, mel2ph, spk_id: int = 0,
            seed: int = 0, spk_embed=None) -> list[torch.Tensor]:
        """One score -> the program's inputs on the device, padded to its
        bucket: tokens, pitch, durations, mel2ph, speaker ids, eps [and the
        voice embedding]; rows past the first are zero."""
        m = self.meta
        n, t = len(text_tokens), len(mel2ph)
        nt, nf = self.bucket_for(n, t)
        b = m["batch_size"]

        def rows(x, width):
            out = np.zeros((b, width), np.int64)
            out[0, :len(x)] = np.asarray(x, np.int64).reshape(-1)
            return torch.from_numpy(out)

        eps = torch.zeros(b, nf, m["hidden_size"])
        eps[:1] = prior_noise(nf, m["hidden_size"], seed)
        args = [rows(text_tokens, nt), rows(note_pitch, nt),
                rows(note_dur, nt), rows(mel2ph, nf),
                torch.full((b,), int(spk_id), dtype=torch.long), eps]
        if m["use_spk_embed"]:
            emb = torch.zeros(b, m["spk_embed_dim"])
            if spk_embed is not None:
                emb[0] = torch.as_tensor(np.asarray(spk_embed, np.float32))
            args.append(emb)
        return [a.to(self.device) for a in args]

    @torch.no_grad()
    def synthesize(self, *inputs: torch.Tensor) -> torch.Tensor:
        """The padded inputs of ``pad`` -> waveform [B, nf * hop] on the
        device."""
        bucket = (inputs[0].shape[1], inputs[3].shape[1])
        # through ``forward``, not ``__call__``: the module's pre-call hook
        # checks the shape of each of its inputs, the weights' too, on the
        # host at every call; ``pad`` and the weights file give the shapes
        # the program was traced with
        return self.program(bucket).forward(self.params, *inputs)

    def __call__(self, text_tokens, note_pitch, note_dur, mel2ph,
                 spk_id: int = 0, seed: int = 0,
                 spk_embed=None) -> np.ndarray:
        inputs = self.pad(text_tokens, note_pitch, note_dur, mel2ph, spk_id,
                          seed, spk_embed)
        wav = self.synthesize(*inputs)
        return wav[0, :len(mel2ph) * self.meta["hop_size"]].cpu().numpy()
