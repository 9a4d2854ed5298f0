"""Entry points of the PyTorch port (the counterpart of
``__graft_entry__.py``): a single-card forward and a multi-rank dry run.

``entry()`` returns a train-mode forward of the flagship ``visinger_csd``
model on the card with example arguments; ``dryrun_multichip(n)`` starts
n ranks of ``torch.distributed``, runs one data-parallel train step on a
batch of n items of the tiny recipe (``tiny_config``), then the
time-sharded synthesis of one score over the same ranks.

    python __graft_entry_torch__.py            # entry() on the card
    python __graft_entry_torch__.py dryrun 2   # dryrun_multichip(2)

Imports torch and the port only.
"""

from __future__ import annotations

import socket

import torch

from visinger_tpu_torch.config import tiny_config, visinger_csd
from visinger_tpu_torch.data.synthetic import synthetic_batch
from visinger_tpu_torch.models.factory import build_model

VOCABS = (60, 117, 98)        # as __graft_entry__.py's flagship example
TINY_VOCABS = (40, 96, 64)    # as its dry run's tiny batch


def entry(device="cuda"):
    """(fn, example_args): ``fn(model, text_tokens, note_pitch, note_dur,
    mel2ph, spk_ids, f0, uv, spec, mel_lengths, generator) -> (wav_out,
    kl)``, the training forward of ``visinger_csd`` (B=2, 24 tokens, 128
    frames) in train mode on ``device`` (the card unless the caller asks
    for the CPU)."""
    cfg = visinger_csd()
    model = build_model(cfg, *VOCABS, device=device).train()
    dev = next(model.parameters()).device
    raw = synthetic_batch(2, 24, 128, *VOCABS,
                          num_linear_bins=cfg.num_linear_bins,
                          hop_size=cfg.hop_size)
    b = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
    gen = torch.Generator(device=dev).manual_seed(0)

    def fn(model, text_tokens, note_pitch, note_dur, mel2ph, spk_ids, f0, uv,
           spec, mel_lengths, generator):
        out = model(text_tokens.long(), note_pitch.long(), note_dur.long(),
                    mel2ph.long(), spk_id=spk_ids.long(), infer=False,
                    generator=generator, f0=f0, uv=uv, spec=spec,
                    lengths=mel_lengths)
        return out["wav_out"], out["kl"]

    example_args = (model, b["text_tokens"], b["note_pitch"], b["note_dur"],
                    b["mel2ph"], b["spk_ids"], b["f0"], b["uv"], b["spec"],
                    b["mel_lengths"], gen)
    return fn, example_args


def free_port() -> int:
    """A TCP port on localhost that no process listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dryrun_rank(rank: int, n: int, port: int, backend: str,
                 device: str) -> None:
    """One rank of ``dryrun_multichip``: asserts raise in the rank, and
    ``torch.multiprocessing`` re-raises them in the parent."""
    from visinger_tpu_torch.models.factory import build_models
    from visinger_tpu_torch.parallel import mesh, multihost
    from visinger_tpu_torch.parallel.sp import pad_frames_for_mesh, sp_decode
    from visinger_tpu_torch.training.train_state import create_train_state
    from visinger_tpu_torch.training.train_step import make_train_step

    dev = multihost.initialize_distributed(f"localhost:{port}", n, rank,
                                           backend=backend, device=device)
    # float32 convolutions on the card, so the sharded and the whole decode
    # differ by float32 rounding only
    torch.backends.cudnn.allow_tf32 = False
    try:
        cfg = tiny_config()
        t = pad_frames_for_mesh(64, n)
        batch = synthetic_batch(n, 12, t, *TINY_VOCABS,
                                num_linear_bins=cfg.num_linear_bins,
                                hop_size=cfg.hop_size, seed=0)
        model, disc = build_models(cfg, *TINY_VOCABS, device=dev)
        state = create_train_state(model, disc, seed=cfg.seed)
        step = make_train_step(cfg, model, disc, device=dev)
        state, metrics = step(state, mesh.shard_batch(batch))
        assert state.step == 1, state.step
        for k, v in metrics.items():
            assert bool(torch.isfinite(v)), f"{k} = {v}"
        spread = mesh.replicated_check([*model.parameters(),
                                        *disc.parameters()])
        assert spread == 0.0, f"parameters differ across ranks by {spread}"

        # one score's frames shared out over the same ranks
        model.eval()
        x = {k: torch.from_numpy(batch[k][:1]).to(dev).long()
             for k in ("text_tokens", "note_pitch", "note_dur", "mel2ph",
                       "spk_ids")}
        eps = torch.randn(1, t, cfg.hidden_size,
                          generator=torch.Generator().manual_seed(0)).to(dev)
        with torch.no_grad():
            z_p, mask = model.infer_prior(
                x["text_tokens"], x["note_pitch"], x["note_dur"],
                x["mel2ph"], spk_id=x["spk_ids"], eps=eps)
            wav = sp_decode(model, z_p, mask, spk_id=x["spk_ids"])
            ref = model.decode_frames(z_p, mask, spk_id=x["spk_ids"])
        assert bool(torch.isfinite(wav).all())
        assert mesh.replicated_check([wav]) == 0.0, "waveforms differ"
        err = float((wav - ref).abs().max())
        peak = float(ref.abs().max())
        assert err <= 1e-4 * peak, f"sp waveform off by {err} (peak {peak})"
        if rank == 0:
            print(f"| dryrun rank 0 of {n} ({backend}, {dev}): step "
                  f"{state.step}, total_g {float(metrics['total_g']):.4f}, "
                  f"gnorm_g {float(metrics['gnorm_g']):.4f}; sp wav "
                  f"{tuple(wav.shape)} within {err:.2e} of the 1-rank "
                  f"decode (peak {peak:.3e})", flush=True)
    finally:
        multihost.shutdown()


def dryrun_multichip(n_devices: int) -> None:
    """One data-parallel train step of ``tiny_config`` on a batch of
    ``n_devices`` items over ``n_devices`` ranks, then the sequence-parallel
    synthesis of one score over the same ranks; asserts finite metrics,
    step 1, and the same parameters and waveform on every rank.  NCCL on
    the cards when there are ``n_devices`` of them, else gloo on the CPU
    with the kernels' plain versions (printed)."""
    import torch.multiprocessing as mp

    if n_devices <= torch.cuda.device_count():
        backend, device = "nccl", "cuda"
    else:
        backend, device = "gloo", "cpu"
        print(f"| dryrun_multichip: {torch.cuda.device_count()} cards for "
              f"{n_devices} ranks: gloo on the CPU with the plain kernels",
              flush=True)
    mp.start_processes(_dryrun_rank, args=(n_devices, free_port(), backend,
                                           device),
                       nprocs=n_devices, start_method="spawn")


if __name__ == "__main__":
    import sys

    if len(sys.argv) > 1 and sys.argv[1] == "dryrun":
        dryrun_multichip(int(sys.argv[2]) if len(sys.argv) > 2 else 8)
        print("dryrun_multichip OK")
    else:
        fn, args = entry()
        out = fn(*args)
        torch.cuda.synchronize()
        print("entry OK:", tuple(out[0].shape), float(out[1]))
