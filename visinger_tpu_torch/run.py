"""The port's command line: train, validate, infer.

  python -m visinger_tpu_torch.run train    --exp_name x [--config cfg.json]
                                            [--hparams "a=1,b=[1, 2]"]
  python -m visinger_tpu_torch.run validate --exp_name x
  python -m visinger_tpu_torch.run infer    --exp_name x --midi song.mid
                                            --out out.wav [--stream]
  python -m visinger_tpu_torch.run infer    --exp_name x --midi_dir songs/
                                            --out_dir gen/

The work dir is ``checkpoints/<exp_name>``.  ``train`` writes the merged
config there as ``config.json``, and the next launch of the experiment
reads it back (``--reset`` starts from ``--config`` or the recipe again);
``validate`` and ``infer`` read it and leave it as it is, so their one-off
``--hparams`` do not change later training.  ``--config`` is a JSON file of
``Config`` fields (``Config.to_dict``); ``--hparams`` overrides fields, with
dotted keys into the argument dicts.  Everything runs on ``--device``
(default ``cuda``; ``cpu`` runs the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from visinger_tpu_torch.config import Config, parse_overrides, visinger_csd


def load_config_file(path: str) -> Config:
    with open(path) as f:
        return Config.from_dict(json.load(f))


def resolve_config(args, persist: bool = True) -> Config:
    """The experiment's config: its saved ``config.json`` (unless
    ``--reset``), else ``--config`` or the ``visinger_csd`` recipe; then
    ``--hparams``.  With ``persist`` it is written to the work dir."""
    overrides = parse_overrides(args.hparams or "")
    work_dir = None
    if args.exp_name:
        work_dir = os.path.join("checkpoints", args.exp_name)
        saved = os.path.join(work_dir, "config.json")
        if os.path.exists(saved) and not args.reset:
            return load_config_file(saved).apply(overrides).replace(
                work_dir=work_dir, exp_name=args.exp_name)
    cfg = load_config_file(args.config) if args.config else visinger_csd()
    cfg = cfg.apply(overrides)
    if work_dir:
        cfg = cfg.replace(work_dir=work_dir, exp_name=args.exp_name)
    if persist and cfg.work_dir:
        os.makedirs(cfg.work_dir, exist_ok=True)
        with open(os.path.join(cfg.work_dir, "config.json"), "w") as f:
            json.dump(cfg.to_dict(), f, indent=1, ensure_ascii=False)
    return cfg


def cmd_train(args):
    from visinger_tpu_torch.training.trainer import Trainer

    Trainer(resolve_config(args), device=args.device).fit()


def cmd_validate(args):
    """Validation losses of the newest checkpoint."""
    from visinger_tpu_torch.training.checkpoint import restore_latest
    from visinger_tpu_torch.training.trainer import Trainer

    cfg = resolve_config(args, persist=False)
    tr = Trainer(cfg, device=args.device)
    state, step = restore_latest(cfg.work_dir, tr.init_state())
    if step == 0:
        raise SystemExit(f"no checkpoint in {cfg.work_dir}")
    print(f"| validating from step {step}")
    return tr.validate(state, max_batches=cfg.eval_max_batches or None)


def cmd_infer(args):
    """MIDI -> wav with the newest checkpoint's generator."""
    from visinger_tpu_torch.infer.infer import VISingerInfer
    from visinger_tpu_torch.models.factory import build_model
    from visinger_tpu_torch.training.checkpoint import (latest_checkpoint,
                                                        load_checkpoint)
    from visinger_tpu_torch.utils.audio.io import save_wav

    if not args.midi and not args.midi_dir:
        raise SystemExit("infer requires --midi <file> or --midi_dir <dir>")
    cfg = resolve_config(args, persist=False)
    if args.stream:
        cfg = cfg.replace(stream_infer=True)
    ckpt = latest_checkpoint(cfg.work_dir)
    if ckpt is None:
        raise SystemExit(f"no checkpoint in {cfg.work_dir}")
    data_dir = cfg.binary_data_dir
    vocabs = []
    for name in ("phone_set", "pitch_map", "dur_map"):
        with open(f"{data_dir}/{name}.json") as f:
            vocabs.append(len(json.load(f)))
    saved = load_checkpoint(ckpt)
    model = build_model(cfg, *vocabs, device="cpu")
    model.load_state_dict(saved["model"], strict=True)
    print(f"| loaded {ckpt} (step {saved['step']})")
    infer = VISingerInfer(cfg, model, data_dir, device=args.device)
    if args.midi_dir:
        fns = sorted(glob.glob(os.path.join(args.midi_dir, "*.mid"))
                     + glob.glob(os.path.join(args.midi_dir, "*.midi")))
        if not fns:
            raise SystemExit(f"no .mid files in {args.midi_dir}")
        out_dir = args.out_dir or "generated"
        os.makedirs(out_dir, exist_ok=True)
        summary = []
        for r in infer.synthesize_batch(fns,
                                        pitch_control=args.pitch_control):
            out_fn = os.path.join(
                out_dir, os.path.splitext(os.path.basename(r["fn"]))[0]
                + ".wav")
            save_wav(r.pop("wav"), out_fn, cfg.sample_rate,
                     norm=cfg.out_wav_norm)
            summary.append({**r, "out": out_fn})
        with open(os.path.join(out_dir, "results.json"), "w") as f:
            json.dump(summary, f, indent=1)
        mean_rtf = sum(r["rtf"] for r in summary) / len(summary)
        print(f"| wrote {len(summary)} wavs to {out_dir} "
              f"(mean RTF {mean_rtf:.3f})")
        return summary
    rtf = infer.to_file(args.midi, args.out, pitch_control=args.pitch_control)
    print(f"| wrote {args.out} (RTF {rtf:.3f})")
    return rtf


def main(argv=None):
    p = argparse.ArgumentParser(prog="visinger_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn in [("train", cmd_train), ("validate", cmd_validate),
                     ("infer", cmd_infer)]:
        sp = sub.add_parser(name)
        sp.add_argument("--config", default="",
                        help="a JSON file of Config fields")
        sp.add_argument("--exp_name", default="")
        sp.add_argument("-hp", "--hparams", default="")
        sp.add_argument("--reset", action="store_true",
                        help="ignore the experiment's saved config.json")
        sp.add_argument("--device", default="cuda")
        if name == "infer":
            sp.add_argument("--midi", default="")
            sp.add_argument("--midi_dir", default="",
                            help="synthesize every .mid in a directory, "
                                 "max_sentences at a time")
            sp.add_argument("--out", default="out.wav")
            sp.add_argument("--out_dir", default="")
            sp.add_argument("--pitch_control", type=int, default=0)
            sp.add_argument("--stream", action="store_true",
                            help="decode window by window "
                                 "(stream_infer: true)")
        sp.set_defaults(fn=fn)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
