"""The port's command line: the data pipeline, training, validation, the
test split and MIDI inference.

  python -m visinger_tpu_torch.run synth-data --config tpu_run
  python -m visinger_tpu_torch.run preprocess --config cfg.json
  python -m visinger_tpu_torch.run binarize   --config tpu_run
  python -m visinger_tpu_torch.run train      --config tpu_run [--exp_name x]
                                              [--hparams "a=1,b=[1, 2]"]
  python -m visinger_tpu_torch.run test       --config tpu_run
  python -m visinger_tpu_torch.run validate   --exp_name x
  python -m visinger_tpu_torch.run infer      --exp_name x --midi song.mid
                                              --out out.wav [--stream]
  python -m visinger_tpu_torch.run infer      --exp_name x --midi_dir songs/
                                              --out_dir gen/
  python -m visinger_tpu_torch.run export     --exp_name x --out_dir art/
                                              [--buckets 96x320,192x640]

``synth-data`` writes a synthetic corpus into ``processed_data_dir``
(``synth_n_items`` songs of ``synth_notes`` notes); ``preprocess`` turns a
raw CSD layout under ``raw_data_dir`` (``midi/*.mid``, ``wav/*.wav``,
optional ``text/*.txt``) into the same layout; ``binarize`` writes the
records of ``binary_data_dir`` from it.  These three are numpy on the host.
``train`` (then the test split with ``test_after_train``), ``test``,
``validate``, ``infer`` and ``export`` run the model on ``--device``
(default ``cuda``; ``cpu`` runs the kernels' plain versions); ``export``
writes a serving artifact for that device type (``infer/export.py``).

``train`` runs data-parallel under a process group: one process per card,
started by ``torchrun --nproc-per-node N -m visinger_tpu_torch.run train
...`` (or with the JAX package's ``VISINGER_COORDINATOR``,
``VISINGER_NUM_PROCESSES`` and ``VISINGER_PROCESS_ID``); ``--device cuda``
is then ``cuda:<LOCAL_RANK>`` and the backend NCCL, or gloo on the CPU or
when the ranks outnumber the cards (``multihost.choose_backend``).  Rank 0
writes the config, the checkpoints, the logs and the test split.

``--config`` is a recipe name (``visinger_csd``, the default, ``tpu_run``,
``soak_r5`` or ``parity_run``), a JSON file of ``Config`` fields
(``Config.to_dict``) or a YAML experiment file with ``base_config`` chains,
as the JAX package's ``--config`` takes (``configs/*.yaml``;
``config_loader.py``); ``--hparams`` overrides fields, with dotted keys
into the argument dicts.
With ``--exp_name`` the work dir is ``checkpoints/<exp_name>``, else the
config's ``work_dir``.  Every command but ``test``, ``validate``,
``infer`` and ``export`` writes the merged config there as
``config.json``, and the next launch of the experiment (``--exp_name``)
reads it back (``--reset`` starts from ``--config`` again); the read-only
commands leave it as it is, so their one-off ``--hparams`` do not change
later training.  ``--remove`` asks, then deletes the experiment's work dir
first.  ``train`` copies its terminal output to
``<work_dir>/terminal_logs/``.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import shutil
import sys
import time

from visinger_tpu_torch.config import RECIPES, Config, parse_overrides


def load_config_file(path: str) -> Config:
    with open(path) as f:
        return Config.from_dict(json.load(f))


def load_config_arg(spec: str) -> Config:
    """A recipe by name, a YAML experiment file (``.yaml`` or ``.yml``) or
    a JSON file of ``Config`` fields."""
    if spec in RECIPES:
        return RECIPES[spec]()
    if spec.endswith((".yaml", ".yml")):
        from visinger_tpu_torch.config_loader import load_config

        return load_config(spec)
    return load_config_file(spec)


def resolve_config(args, persist: bool = True) -> Config:
    """The experiment's config: its saved ``config.json`` (unless
    ``--reset``), else ``--config`` (default ``visinger_csd``); then
    ``--hparams`` and ``--debug``.  With ``persist`` it is written to the
    work dir."""
    overrides = parse_overrides(args.hparams or "")
    if args.debug:
        # reference --debug (hparams.py:39,120): carried in the config
        overrides["debug"] = True
    work_dir = None
    if args.exp_name:
        work_dir = os.path.join("checkpoints", args.exp_name)
        if args.remove and os.path.exists(work_dir):
            remove_work_dir(work_dir)
        saved = os.path.join(work_dir, "config.json")
        if os.path.exists(saved) and not args.reset:
            return load_config_file(saved).apply(overrides).replace(
                work_dir=work_dir, exp_name=args.exp_name)
    cfg = load_config_arg(args.config or "visinger_csd").apply(overrides)
    if work_dir:
        cfg = cfg.replace(work_dir=work_dir, exp_name=args.exp_name)
    if persist and cfg.work_dir:
        os.makedirs(cfg.work_dir, exist_ok=True)
        with open(os.path.join(cfg.work_dir, "config.json"), "w") as f:
            json.dump(cfg.to_dict(), f, indent=1, ensure_ascii=False)
    return cfg


def remove_work_dir(work_dir: str) -> None:
    """reference --remove (hparams.py:110-113): ask, then delete the work
    dir; no answer (end of input) is the default N."""
    try:
        answer = input("REMOVE old checkpoint? Y/N [Default: N]: ")
    except EOFError:
        answer = "n"
    if answer.strip().lower() == "y":
        shutil.rmtree(work_dir)
        print(f"| removed {work_dir}")


class _Tee:
    """Writes to a stream and to a log file (reference Tee,
    utils/commons/trainer.py:28-43)."""

    def __init__(self, stream, f):
        self._stream, self._f = stream, f

    def write(self, data):
        self._stream.write(data)
        self._f.write(data)

    def flush(self):
        self._stream.flush()
        self._f.flush()

    def __getattr__(self, name):
        return getattr(self._stream, name)


@contextlib.contextmanager
def tee_terminal(work_dir: str, tag: str = ""):
    """Copy stdout and stderr into ``work_dir/terminal_logs/log_<time>.txt``
    (``log_<time>_<tag>.txt`` with a ``tag``: one file per rank) while the
    block runs; the streams are restored after it."""
    log_dir = os.path.join(work_dir, "terminal_logs")
    os.makedirs(log_dir, exist_ok=True)
    fn = os.path.join(log_dir, f"log_{int(time.time())}"
                      f"{'_' + tag if tag else ''}.txt")
    out, err = sys.stdout, sys.stderr
    with open(fn, "a", buffering=1) as f:
        sys.stdout, sys.stderr = _Tee(out, f), _Tee(err, f)
        try:
            yield fn
        finally:
            sys.stdout, sys.stderr = out, err


def cmd_synth_data(args):
    from visinger_tpu_torch.data.synthetic_corpus import generate_corpus

    cfg = resolve_config(args)
    n_items = args.n_items or cfg.synth_n_items
    notes = tuple(cfg.synth_notes)
    meta_fn = generate_corpus(cfg.processed_data_dir, n_items=n_items,
                              sample_rate=cfg.sample_rate,
                              notes_per_item=notes)
    print(f"| synthetic corpus at {cfg.processed_data_dir} "
          f"({n_items} items, {notes[0]}-{notes[1]} notes)")
    return meta_fn


def cmd_preprocess(args):
    from visinger_tpu_torch.data.preprocess import Preprocessor

    return Preprocessor(resolve_config(args)).process()


def cmd_binarize(args):
    """-> {"counts": {split: records}, "seconds": s}."""
    from visinger_tpu_torch.data.binarizer import Binarizer

    cfg = resolve_config(args)
    t0 = time.perf_counter()
    counts = Binarizer(cfg).process()
    seconds = time.perf_counter() - t0
    n = sum(counts.values())
    print(f"| binarized {counts} into {cfg.binary_data_dir} in "
          f"{seconds:.2f} s ({seconds / max(n, 1):.3f} s per item)")
    return {"counts": counts, "seconds": seconds}


def cmd_train(args):
    """Train; with ``test_after_train``, then synthesize the test split with
    the final state into ``<work_dir>/test_after_train``.  When the
    environment asks for a process group (torchrun's or the JAX package's
    variables), each process is one data-parallel rank: the group starts
    first, and a failure to start it raises."""
    from visinger_tpu_torch.parallel import mesh, multihost
    from visinger_tpu_torch.training.trainer import Trainer

    device = args.device
    if multihost.requested():
        device = multihost.initialize_distributed(device=device)
    primary = multihost.is_primary()
    if primary:
        cfg = resolve_config(args)
    mesh.barrier()      # rank 0 has written the config the others read
    if not primary:
        cfg = resolve_config(args, persist=False)
    with tee_terminal(cfg.work_dir, "" if primary else f"rank{mesh.rank()}"):
        trainer = Trainer(cfg, device=device)
        state = trainer.fit()
        if cfg.test_after_train and primary:
            trainer.test(state, out_dir=os.path.join(cfg.work_dir,
                                                     "test_after_train"))
    return state


def _trainer_at_latest(args):
    """(config, trainer, state) of the newest checkpoint of the work dir."""
    from visinger_tpu_torch.training.checkpoint import restore_latest
    from visinger_tpu_torch.training.trainer import Trainer

    cfg = resolve_config(args, persist=False)
    tr = Trainer(cfg, device=args.device)
    state, step = restore_latest(cfg.work_dir, tr.init_state())
    if step == 0:
        raise SystemExit(f"no checkpoint in {cfg.work_dir}")
    return cfg, tr, state


def cmd_test(args):
    """The test split from the newest checkpoint: wavs, RTF and quality
    metrics in ``<work_dir>/generated_<step>``."""
    _, tr, state = _trainer_at_latest(args)
    print(f"| testing from step {state.step}")
    return tr.test(state)


def cmd_validate(args):
    """Validation losses of the newest checkpoint."""
    cfg, tr, state = _trainer_at_latest(args)
    print(f"| validating from step {state.step}")
    return tr.validate(state, max_batches=cfg.eval_max_batches or None)


def vocab_sizes(data_dir: str) -> list[int]:
    """The phone, pitch and duration vocabulary sizes of a binarized data
    dir."""
    sizes = []
    for name in ("phone_set", "pitch_map", "dur_map"):
        with open(f"{data_dir}/{name}.json") as f:
            sizes.append(len(json.load(f)))
    return sizes


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
    saved = load_checkpoint(ckpt)
    model = build_model(cfg, *vocab_sizes(data_dir), device="cpu")
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


def cmd_export(args):
    """Export the newest checkpoint's generator as a serving artifact
    (``infer/export.py``: one program per bucket, one weights file, meta);
    -> the meta dict."""
    from visinger_tpu_torch.infer.export import export_synthesis
    from visinger_tpu_torch.models.factory import build_model, resolve_device
    from visinger_tpu_torch.training.checkpoint import (latest_checkpoint,
                                                        load_checkpoint)

    cfg = resolve_config(args, persist=False)
    device = resolve_device(args.device)
    ckpt = latest_checkpoint(cfg.work_dir)
    if ckpt is None:
        raise SystemExit(f"no checkpoint in {cfg.work_dir}")
    saved = load_checkpoint(ckpt)   # the generator's weights are all it reads
    model = build_model(cfg, *vocab_sizes(cfg.binary_data_dir), device="cpu")
    model.load_state_dict(saved["model"], strict=True)
    print(f"| exporting {ckpt} (step {saved['step']})")
    buckets = None
    if args.buckets:  # "96x320,192x640" -> [(96, 320), (192, 640)]
        buckets = [tuple(int(v) for v in part.split("x"))
                   for part in args.buckets.split(",") if part]
    meta = export_synthesis(cfg, model, args.out_dir,
                            batch_size=args.batch_size, buckets=buckets,
                            device=device)
    print(f"| wrote artifact to {args.out_dir}: {json.dumps(meta)}")
    return meta


COMMANDS = {"synth-data": cmd_synth_data, "preprocess": cmd_preprocess,
            "binarize": cmd_binarize, "train": cmd_train, "test": cmd_test,
            "validate": cmd_validate, "infer": cmd_infer,
            "export": cmd_export}
MODEL_COMMANDS = ("train", "test", "validate", "infer", "export")


def main(argv=None):
    """Parse ``argv`` and run the command; returns what the command
    returns."""
    p = argparse.ArgumentParser(prog="visinger_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn in COMMANDS.items():
        sp = sub.add_parser(name)
        sp.add_argument("--config", default="",
                        help="a recipe name (" + ", ".join(RECIPES)
                             + "), a YAML experiment file or a JSON "
                             "file of Config fields")
        sp.add_argument("--exp_name", default="")
        sp.add_argument("-hp", "--hparams", default="")
        sp.add_argument("--reset", action="store_true",
                        help="ignore the experiment's saved config.json")
        sp.add_argument("--remove", action="store_true",
                        help="delete the experiment's work dir (asks "
                             "first) before the command runs")
        sp.add_argument("--debug", action="store_true")
        if name in MODEL_COMMANDS:
            sp.add_argument("--device", default="cuda")
        if name == "synth-data":
            sp.add_argument("--n_items", type=int, default=0,
                            help="0: the config's synth_n_items")
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
        if name == "export":
            sp.add_argument("--out_dir", default="exported_model")
            sp.add_argument("--batch_size", type=int, default=1)
            sp.add_argument("--buckets", default="",
                            help="'<tokens>x<frames>,...' shapes to export "
                                 "into one artifact (default: the largest "
                                 "configured bucket)")
        sp.set_defaults(fn=fn)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
