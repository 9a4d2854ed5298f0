"""Training runtime: the epoch and step loop around the train step (the
counterpart of the JAX package's ``training/trainer.py``), on one device.

Per epoch ``seed + epoch`` plans the batches (``data/dataset.py``).  Two
data routes:

- ``device_resident_data`` (default): the train and valid splits are
  uploaded to the device once (``data/device_store.py``) with each epoch's
  index plan, and each step gathers its rows there;
- otherwise a producer thread decodes, collates and pins each batch
  (``data/prefetch.py``) and the loop copies it to the device with
  ``non_blocking=True`` on the compute stream.

Loss meters stay on the device and are read once per ``tb_log_interval``
(one transfer), so the loop waits for the device only to log, validate or
checkpoint.  Every ``val_check_interval`` steps: validation on the
generator's reconstruction losses (``deterministic_eval``: the eval step
with fixed draws; else a train step on a copy of the state) and a
checkpoint, with the best tracked by validation loss.  A run resumes from
the newest checkpoint of its work dir; as in the JAX package, the epoch
loop then starts again at epoch 0 (``seed + 0``), without skipping the
batches the earlier run consumed.  ``log.jsonl`` holds every logged metric,
mirrored to TensorBoard when ``torch.utils.tensorboard`` imports.

With ``render_valid``, each validation at a multiple of
``valid_infer_interval`` also synthesizes the first ``num_valid_plots``
valid items into ``valid_{step}/`` (wavs, mel PNGs when matplotlib imports,
TensorBoard audio and figures).  ``Trainer.test`` synthesizes the test
split into ``generated_{step}/`` with its RTF and objective-quality metrics
(``results.json``).  Both synthesize with ``VISinger.forward(infer=True)``,
the prior noise drawn from a CPU generator (seeded with the step, or 0 for
the test) and moved to the device, so the card and the CPU see the same
noise.

Data parallelism (``parallel/``): under a process group every rank builds
the same epoch plan and keeps its contiguous rows of each batch
(``multihost.host_batch_slice``; the world size must divide
``max_sentences``), on either data route; the step sums gradients and
metrics over the ranks.  Only the primary rank writes: checkpoints (then a
barrier, so every rank sees the file), ``log.jsonl`` and TensorBoard, the
code snapshot, renders and the test split.  Every rank restores the same
newest checkpoint on resume.
"""

from __future__ import annotations

import copy
import json
import os
import shutil
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

from visinger_tpu_torch.config import Config
from visinger_tpu_torch.data.dataset import batch_by_size, build_dataset
from visinger_tpu_torch.data.device_store import DeviceStore, gather_batch
from visinger_tpu_torch.data.prefetch import prefetch
from visinger_tpu_torch.models.factory import build_models, resolve_device
from visinger_tpu_torch.ops.stft import STFTParams, log_mel_spectrogram
from visinger_tpu_torch.parallel import mesh
from visinger_tpu_torch.parallel.multihost import host_batch_slice, is_primary
from visinger_tpu_torch.training.checkpoint import (AsyncCheckpointer,
                                                    restore_latest,
                                                    save_checkpoint,
                                                    warm_start)
from visinger_tpu_torch.training.train_state import (TrainState,
                                                     create_train_state)
from visinger_tpu_torch.training.train_step import (make_eval_step,
                                                    make_train_step,
                                                    recon_loss_total)
from visinger_tpu_torch.utils.text.token_encoder import build_token_encoder


class MetricLogger:
    """``log.jsonl`` in ``work_dir``, and TensorBoard event files under
    ``work_dir/tb`` when ``torch.utils.tensorboard`` imports."""

    def __init__(self, work_dir: str):
        self.path = os.path.join(work_dir, "log.jsonl")
        os.makedirs(work_dir, exist_ok=True)
        self._tb = None
        # Event files need no TensorFlow: tensorboard's own switch
        # (``tensorboard.compat.notf``) keeps it on its stub API, where it
        # would otherwise import an installed TensorFlow (~14 s)
        sys.modules.setdefault("tensorboard.compat.notf",
                               types.ModuleType("tensorboard.compat.notf"))
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self._tb = SummaryWriter(os.path.join(work_dir, "tb"))

    def log(self, step: int, metrics: dict, prefix: str = "train"):
        rec = {"step": step, "prefix": prefix,
               **{k: float(v) for k, v in metrics.items()}}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(f"{prefix}/{k}", float(v), step)

    # TB media (reference save_valid_result/plot_mel pushes rendered audio
    # and mel figures into TensorBoard, tasks/visinger.py:175-185 +
    # tasks/base.py:249-271) — no-ops when TB is unavailable.
    def add_audio(self, tag: str, wav, step: int, sample_rate: int):
        if self._tb is None:
            return
        w = torch.from_numpy(np.asarray(wav, np.float32)).clamp(-1.0, 1.0)
        self._tb.add_audio(tag, w.unsqueeze(0), step, sample_rate=sample_rate)

    def add_figure(self, tag: str, fig, step: int):
        """Log a matplotlib figure and close it."""
        import matplotlib.pyplot as plt

        if self._tb is not None:
            self._tb.add_figure(tag, fig, step, close=False)
        plt.close(fig)

    def flush(self):
        if self._tb is not None:
            self._tb.flush()


@torch.no_grad()
def synthesize(model, batch: dict, seed: int
               ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """``model.forward(infer=True)`` in eval mode on a host batch (numpy
    arrays, ``VISingerDataset.collate``'s layout) -> (waveforms [B, T*hop],
    f0_pred [B, T, 2] or None) on the model's device.  The prior noise
    [B, T, H] comes from a CPU generator seeded with ``seed`` and is moved
    to the device."""
    dev = next(model.parameters()).device
    x = {k: torch.from_numpy(np.asarray(batch[k])).to(dev)
         for k in ("text_tokens", "note_pitch", "note_dur", "mel2ph",
                   "spk_ids", "spk_embed") if k in batch}
    b, t = x["mel2ph"].shape
    eps = torch.randn(b, t, model.cfg.hidden_size,
                      generator=torch.Generator().manual_seed(seed)).to(dev)
    was_training = model.training
    model.eval()
    try:
        out = model(x["text_tokens"], x["note_pitch"], x["note_dur"],
                    x["mel2ph"], spk_id=x["spk_ids"], infer=True, eps=eps,
                    spk_embed=x.get("spk_embed"))
    finally:
        model.train(was_training)
    return out["wav_out"], out.get("f0_pred")


def _matplotlib_ok() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


class Trainer:
    """Trains the generator and the discriminators of ``cfg`` on ``device``
    (CUDA unless the caller asks for the CPU), from the binarized splits of
    ``cfg.binary_data_dir`` (or every ``cfg.binary_data_dirs``, which must
    share the first one's dictionaries), into ``work_dir`` (default
    ``cfg.work_dir``).  Under a process group it is one rank of the data
    parallelism (the module docstring); ``device`` is the rank's own."""

    def __init__(self, cfg: Config, work_dir: str | None = None,
                 device="cuda"):
        self.device = resolve_device(device)
        world = mesh.world_size()
        if cfg.max_sentences % world:
            raise ValueError(f"max_sentences {cfg.max_sentences} is not "
                             f"divisible by the {world} ranks")
        self.cfg = cfg
        self.work_dir = work_dir or cfg.work_dir
        data_dir = (cfg.binary_data_dirs[0] if cfg.binary_data_dirs
                    else cfg.binary_data_dir)
        self.token_encoder = build_token_encoder(f"{data_dir}/phone_set.json")
        with open(f"{data_dir}/pitch_map.json") as f:
            pitch_map = json.load(f)
        with open(f"{data_dir}/dur_map.json") as f:
            dur_map = json.load(f)
        self.model, self.disc = build_models(
            cfg, len(self.token_encoder), len(pitch_map), len(dur_map),
            device=self.device, seed=cfg.seed)
        self.logger = MetricLogger(self.work_dir) if is_primary() else None
        self._png_skip_said = False

    def init_state(self) -> TrainState:
        """A fresh train state of the trainer's models (generator seeded
        from ``cfg.seed``)."""
        return create_train_state(self.model, self.disc, seed=self.cfg.seed)

    # --- batches ---------------------------------------------------------
    def _host_batches(self, ds, **kw):
        """``ds.batches(**kw)`` as CPU tensors, pinned for a CUDA device so
        that the copy to it can be asynchronous."""
        pin = self.device.type == "cuda"
        for batch in ds.batches(**kw):
            rows = host_batch_slice(len(batch["mel2ph"]))
            batch = {k: torch.from_numpy(v[rows]) for k, v in batch.items()}
            yield {k: v.pin_memory() for k, v in batch.items()} if pin \
                else batch

    def _to_device(self, batch: dict) -> dict:
        return {k: v.to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def _store_batches(self, store: DeviceStore, plans: list):
        """The batches of ``plans`` gathered on the device (the rank's
        rows of each); the plan's indices go to the device in one copy."""
        if not plans:
            return
        idx = torch.from_numpy(np.stack([p[0] for p in plans]))
        if self.device.type == "cuda":
            idx = idx.pin_memory()
        idx = idx.to(self.device, non_blocking=True)
        rows = host_batch_slice(idx.shape[1])
        for i, (_, t_b, n_b) in enumerate(plans):
            yield gather_batch(store.arrays, idx[i], t_b, n_b,
                               self.cfg.hop_size, rows)

    def _valid_batches(self, valid_ds, valid_store, max_batches: int):
        if valid_store is not None:
            yield from self._store_batches(
                valid_store, valid_store.plan_batches(shuffle=False)[
                    :max_batches])
            return
        for i, batch in enumerate(self._host_batches(
                valid_ds, max_sentences=self.cfg.max_sentences,
                shuffle=False)):
            if i >= max_batches:
                return
            yield self._to_device(batch)

    # --- the loop --------------------------------------------------------
    def fit(self, max_updates: int | None = None) -> TrainState:
        cfg = self.cfg
        max_updates = max_updates or cfg.max_updates
        train_ds = build_dataset(cfg, cfg.train_set_name)
        valid_ds = build_dataset(cfg, cfg.valid_set_name)
        if cfg.save_codes and is_primary():
            self._snapshot_code()
        state, start_step = restore_latest(self.work_dir, self.init_state())
        if start_step:
            print(f"| resumed from step {start_step}")
        elif cfg.load_ckpt:
            warm_start(cfg.load_ckpt, state)
        # the learning rate decays once per epoch of the real plan
        steps_per_epoch = max(len(batch_by_size(
            train_ds.item_lengths(), cfg.max_tokens, cfg.max_sentences)), 1)
        train_step = make_train_step(cfg, self.model, self.disc, self.device,
                                     steps_per_epoch)
        ckpt_async = AsyncCheckpointer() if cfg.async_checkpoint else None

        def save_ckpt(val_loss=None, last=False):
            """Rank 0 writes; the last save is on disk before any rank
            returns (a resume reads it)."""
            if is_primary():
                if ckpt_async is not None:
                    ckpt_async.save(self.work_dir, state, cfg.num_ckpt_keep,
                                    val_loss)
                    if last:
                        ckpt_async.wait()
                else:
                    save_checkpoint(self.work_dir, state, cfg.num_ckpt_keep,
                                    val_loss)
            mesh.barrier()

        use_store = cfg.device_resident_data
        est_mb = len(train_ds) * max(cfg.frame_buckets) * cfg.hop_size * 4 \
            / 1e6
        if use_store and est_mb > cfg.device_data_max_mb:
            use_store = False
            print(f"| device store disabled ({est_mb:.0f} MB > "
                  f"device_data_max_mb {cfg.device_data_max_mb})")
        train_store = valid_store = None
        if use_store:
            train_store = DeviceStore(train_ds, self.device)
            valid_store = DeviceStore(valid_ds, self.device)

        eval_step = (make_eval_step(cfg, self.model, self.device)
                     if cfg.deterministic_eval else None)

        def eval_loss(max_batches: int) -> float:
            """Mean reconstruction loss over the first valid batches."""
            totals = []
            for batch in self._valid_batches(valid_ds, valid_store,
                                             max_batches):
                if eval_step is not None:
                    totals.append(float(eval_step(batch)["total_g"]))
                else:  # a train step on a copy, the state left as it is
                    snap = copy.deepcopy(state)
                    _, m = make_train_step(cfg, snap.model, snap.disc,
                                           self.device, steps_per_epoch)(
                        snap, batch)
                    totals.append(recon_loss_total(m))
            return float(np.mean(totals)) if totals else float("nan")

        n_sanity = cfg.num_sanity_val_steps
        if n_sanity > 0 and not start_step:
            sanity = eval_loss(n_sanity)
            if is_primary():
                print(f"| sanity val ({n_sanity} batches): {sanity:.3f}")

        # max_updates, val_check_interval and tb_log_interval count
        # optimizer steps; ``step`` counts batches
        accum = max(cfg.accumulate_grad_batches, 1)
        step, epoch, meters, meters_n = start_step, 0, None, 0
        profiler = None
        t_start = time.time()
        try:
            while step < max_updates * accum:
                if use_store:
                    epoch_iter = self._store_batches(
                        train_store,
                        train_store.plan_batches(seed=cfg.seed + epoch))
                else:
                    epoch_iter = prefetch(self._host_batches(
                        train_ds, seed=cfg.seed + epoch))
                n_batches = 0
                try:
                    for batch in epoch_iter:
                        n_batches += 1
                        if cfg.profile_dir and is_primary() \
                                and step == cfg.profile_start_step:
                            profiler = self._start_profile()
                        if not use_store:
                            batch = self._to_device(batch)
                        state, metrics = train_step(state, batch)
                        if meters is None:
                            meters = {k: torch.zeros_like(v)
                                      for k, v in metrics.items()}
                        torch._foreach_add_(list(meters.values()),
                                            [metrics[k] for k in meters])
                        step += 1
                        meters_n += 1
                        opt_step, boundary = step // accum, step % accum == 0
                        if profiler is not None and \
                                step == cfg.profile_start_step + 5:
                            self._stop_profile(profiler, step)
                            profiler = None
                        if boundary and opt_step % cfg.tb_log_interval == 0:
                            now = time.time()
                            self._log_window(opt_step, meters, meters_n,
                                             now - t_start)
                            t_start, meters_n = now, 0
                        if boundary and opt_step % cfg.val_check_interval == 0:
                            val_loss = eval_loss(cfg.eval_max_batches)
                            if self.logger is not None:
                                self.logger.log(opt_step,
                                                {"val_loss": val_loss}, "val")
                            save_ckpt(val_loss)
                            if cfg.render_valid and is_primary() and \
                                    opt_step % cfg.valid_infer_interval == 0:
                                self.render_valid(state, valid_ds, opt_step)
                        if step >= max_updates * accum:
                            break
                finally:
                    epoch_iter.close()      # stops a prefetch producer
                if n_batches == 0:
                    raise ValueError(
                        f"split {cfg.train_set_name!r} gives no batch: no "
                        "item has more than segment_size and at most "
                        "max_frames frames")
                epoch += 1
            save_ckpt(last=True)
        finally:
            if profiler is not None:
                self._stop_profile(profiler, step)
            if self.logger is not None:
                self.logger.flush()
        return state

    def _log_window(self, step: int, meters: dict, n: int, seconds: float):
        """Log and print the meters' means over the window's ``n`` steps
        (one read from the device) and its steps per second; zero the
        meters."""
        names = list(meters)
        fetched = torch.stack([meters[k] for k in names]).cpu().tolist()
        torch._foreach_zero_(list(meters.values()))
        if self.logger is None:   # the meters are global: rank 0 logs them
            return
        avg = {k: v / n for k, v in zip(names, fetched)}
        avg["steps_per_s"] = self.cfg.tb_log_interval / max(seconds, 1e-9)
        self.logger.log(step, avg)
        print(f"| step {step}: " + ", ".join(
            f"{k}={v:.3f}" for k, v in sorted(avg.items())))

    def _start_profile(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        return prof

    def _stop_profile(self, prof, step: int):
        """End the trace window and write it as a chrome trace into
        ``profile_dir``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        fn = os.path.join(self.cfg.profile_dir,
                          f"trace_steps_{self.cfg.profile_start_step}_"
                          f"{step}.json")
        prof.export_chrome_trace(fn)
        print(f"| profile: {fn}")

    def _snapshot_code(self):
        """Copy the package's source into the work dir, for the record."""
        src = Path(__file__).resolve().parents[1]
        dst = os.path.join(self.work_dir, "codes", src.name)
        if not os.path.exists(dst):
            shutil.copytree(src, dst,
                            ignore=shutil.ignore_patterns("__pycache__"))

    @torch.no_grad()
    def validate(self, state: TrainState,
                 max_batches: int | None = None) -> dict:
        """The eval step's metrics averaged over the valid split (its first
        ``max_batches`` batches), on the host data route."""
        cfg = self.cfg
        valid_ds = build_dataset(cfg, cfg.valid_set_name)
        eval_step = make_eval_step(cfg, state.model, self.device)
        sums: dict = {}
        n = 0
        for i, batch in enumerate(self._host_batches(
                valid_ds, max_sentences=cfg.max_sentences, shuffle=False)):
            if max_batches and i >= max_batches:
                break
            for k, v in eval_step(self._to_device(batch)).items():
                sums[k] = sums.get(k, 0.0) + float(v)
            n += 1
        means = {k: v / max(n, 1) for k, v in sums.items()}
        print(f"| validate ({n} batches): " + ", ".join(
            f"{k}={v:.4f}" for k, v in sorted(means.items())))
        return means

    # --- rendered validation items and the test split --------------------
    def render_valid(self, state: TrainState, valid_ds, step: int,
                     n_items: int | None = None) -> list[str]:
        """Synthesize the first ``n_items`` (default ``num_valid_plots``)
        valid items with noise seeded by ``step`` and write
        ``valid_{step}/item{i}.wav`` and, when matplotlib imports,
        ``item{i}_mel.png`` (mel with f0 overlays and duration ticks); with
        TensorBoard, the audio, the ground truth's audio in the first render
        window and a predicted-beside-true mel figure (reference
        save_valid_result, tasks/visinger.py:175-185).  Padding rows are not
        rendered.  Prints the synthesis time; returns the wav paths."""
        from visinger_tpu_torch.utils.audio.io import save_wav
        from visinger_tpu_torch.utils.audio.pitch import denorm_f0
        from visinger_tpu_torch.utils.plot import save_spec_png, spec_to_figure

        cfg, hop, sr = self.cfg, self.cfg.hop_size, int(self.cfg.sample_rate)
        n_items = cfg.num_valid_plots if n_items is None else n_items
        out_dir = os.path.join(self.work_dir, f"valid_{step}")
        os.makedirs(out_dir, exist_ok=True)
        mel_params = STFTParams.from_config(cfg, self.device)
        png = _matplotlib_ok()
        if not png and not self._png_skip_said:
            print("| render_valid: matplotlib does not import; mel PNGs and "
                  "TensorBoard figures skipped")
            self._png_skip_said = True
        tb_on = self.logger._tb is not None
        vmin, vmax = cfg.mel_vmin, cfg.mel_vmax
        written, synth_s = [], 0.0
        for batch in valid_ds.batches(max_sentences=cfg.max_sentences,
                                      shuffle=False):
            if len(written) >= n_items:
                break
            self._sync()
            t0 = time.perf_counter()
            wavs, f0_pred = synthesize(state.model, batch, step)
            mels = log_mel_spectrogram(wavs, mel_params)
            self._sync()
            synth_s += time.perf_counter() - t0
            wavs, mels = wavs.cpu().numpy(), mels.cpu().numpy()
            f0_pred = None if f0_pred is None else f0_pred.cpu().numpy()
            if tb_on:
                gt_wavs = torch.from_numpy(batch["wavs"]).float()
                if batch["wavs"].dtype == np.int16:
                    gt_wavs = gt_wavs / 32767.0
                gt_wavs = gt_wavs.to(self.device)
                gt_mels = log_mel_spectrogram(gt_wavs, mel_params
                                              ).cpu().numpy()
                gt_wavs = gt_wavs.cpu().numpy()
            n_real = int(batch["item_weights"].sum())
            for i in range(min(n_real, n_items - len(written))):
                done = len(written)
                t = int(batch["mel_lengths"][i])
                wav = wavs[i, : t * hop]
                fn = f"{out_dir}/item{done}.wav"
                save_wav(wav, fn, sr, norm=True)
                written.append(fn)
                f0s = {"f0_gt": denorm_f0(batch["f0"][i][:t],
                                          uv=batch["uv"][i][:t])}
                if f0_pred is not None:
                    f0s["f0_pred"] = denorm_f0(
                        f0_pred[i, :t, 0], uv=(f0_pred[i, :t, 1] > 0))
                duration_gt = np.bincount(batch["mel2ph"][i][:t])[1:]
                dur_info = {"duration_gt": duration_gt}
                if png:
                    save_spec_png(f"{out_dir}/item{done}_mel.png",
                                  mels[i, :t], vmin=vmin, vmax=vmax, f0s=f0s,
                                  dur_info=dur_info)
                if tb_on:
                    peak = max(float(np.max(np.abs(wav))), 1e-6)
                    self.logger.add_audio(f"wav_val_{done}", wav / peak,
                                          step, sr)
                    if step <= cfg.valid_infer_interval:
                        self.logger.add_audio(f"wav_gt_{done}",
                                              gt_wavs[i, : t * hop], step, sr)
                    if png:
                        side_by_side = np.concatenate(
                            [mels[i, :t], gt_mels[i, :t]], axis=-1)
                        self.logger.add_figure(
                            f"mel_val_{done}",
                            spec_to_figure(side_by_side, vmin=vmin,
                                           vmax=vmax, f0s=f0s,
                                           dur_info=dur_info), step)
        n = len(written)
        print(f"| render_valid step {step}: {n} items, synthesis "
              f"{synth_s * 1e3:.1f} ms ({synth_s * 1e3 / max(n, 1):.1f} ms "
              f"per item), pngs {'written' if png else 'skipped'} -> "
              f"{out_dir}")
        return written

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def test(self, state: TrainState, out_dir: str | None = None
             ) -> list[dict]:
        """Synthesize the test split with noise seeded 0 into
        ``out_dir/wavs`` (default ``generated_{step}``) and measure RTF and
        objective quality against the ground truth per item (reference
        VISingerTask.test_step, tasks/visinger.py:244-263; the reference
        records RTF only).  ``per_item_rtf``: batches of 1, each item timed
        alone (``rtf_kind`` "per_item"); else batches of ``max_sentences``
        padded by repeating the last item, and every item of a batch gets
        the batch's RTF ("batch_mean").  The clock stops after the device
        has finished (``torch.cuda.synchronize``); the copy to the host and
        the metrics are outside it.  Padding rows count neither as results
        nor as audio seconds.  Writes ``results.json``, prints a summary
        line and returns the results."""
        from visinger_tpu_torch.utils.audio.io import save_wav
        from visinger_tpu_torch.utils.audio.quality import (f0_metrics, mcd,
                                                            mel_l1_np)

        cfg, hop, sr = self.cfg, self.cfg.hop_size, self.cfg.sample_rate
        mel_params = STFTParams.from_config(cfg)
        test_ds = build_dataset(cfg, cfg.test_set_name)
        out_dir = out_dir or os.path.join(self.work_dir,
                                          f"generated_{state.step}")
        os.makedirs(os.path.join(out_dir, "wavs"), exist_ok=True)
        per_item = cfg.per_item_rtf
        results = []
        for batch in test_ds.batches(
                max_sentences=1 if per_item else cfg.max_sentences,
                shuffle=False, pad_to_max_sentences=not per_item):
            self._sync()
            t0 = time.perf_counter()
            wavs, _ = synthesize(state.model, batch, 0)
            self._sync()
            dt = time.perf_counter() - t0
            wavs = wavs.cpu().numpy()
            weights = batch["item_weights"]
            batch_audio_s = float(np.sum(batch["mel_lengths"] * weights)) \
                * hop / sr
            for i in range(int(weights.sum())):
                t = int(batch["mel_lengths"][i])
                wav = wavs[i, : t * hop]
                fn = f"item_{len(results):04d}_synth.wav"
                save_wav(wav, os.path.join(out_dir, "wavs", fn), sr,
                         norm=cfg.out_wav_norm)
                gt = batch["wavs"][i][: t * hop]
                gt = gt.astype(np.float32) / (32767.0 if gt.dtype == np.int16
                                              else 1.0)
                f0m = f0_metrics(gt, wav, sr, hop, float(cfg.f0_min),
                                 float(cfg.f0_max))
                results.append({
                    "wav_fn_pred": fn,
                    "audio_s": t * hop / sr,
                    "rtf": dt / max(batch_audio_s, 1e-9),
                    "rtf_kind": "per_item" if per_item else "batch_mean",
                    "mcd": round(mcd(gt, wav, mel_params), 3),
                    "mel_l1": round(mel_l1_np(gt, wav, mel_params), 4),
                    "f0_rmse_cents": round(f0m["f0_rmse_cents"], 1),
                    "vuv_error": round(f0m["vuv_error"], 4),
                })
        with open(os.path.join(out_dir, "results.json"), "w") as f:
            json.dump(results, f, indent=1)
        if results:
            def mean(key, fn=np.mean):
                return float(fn([r[key] for r in results]))

            print(f"| test: {len(results)} items, mean RTF {mean('rtf'):.4f} "
                  f"({results[0]['rtf_kind']}), MCD {mean('mcd'):.2f} dB, "
                  f"mel-L1 {mean('mel_l1'):.3f}, f0-RMSE "
                  f"{mean('f0_rmse_cents', np.nanmean):.0f} cents, V/UV err "
                  f"{mean('vuv_error', np.nanmean):.3f} -> {out_dir}")
        return results
