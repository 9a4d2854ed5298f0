"""The port's training entry point on the CPU at ``tiny_config`` size, on a
corpus the JAX pipeline binarized (``test_torch_port_data.build_corpus``):
``Trainer.fit`` (logs, checkpoints, best, sanity validation, the code
snapshot), resume, the learning-rate schedule against JAX's optax schedule
for the trainer's epoch plan, the device-store and prefetch routes, a
repeatable ``validate``, and ``run train`` -> ``validate`` -> ``infer``
through ``main(argv)``.  No JAX ``Trainer`` runs here (its compile takes
minutes on the CPU)."""

import contextlib
import io
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from visinger_tpu.models.factory import tiny_config as jax_tiny_config
from visinger_tpu.training.train_state import \
    make_optimizers as j_make_optimizers
from visinger_tpu_torch import run
from visinger_tpu_torch.config import tiny_config
from visinger_tpu_torch.data.dataset import VISingerDataset, batch_by_size
from visinger_tpu_torch.training import trainer as trainer_mod
from visinger_tpu_torch.training.checkpoint import latest_checkpoint
from visinger_tpu_torch.training.train_state import make_optimizers
from visinger_tpu_torch.training.trainer import Trainer
from visinger_tpu_torch.utils.midi import Note, write_midi

import test_torch_port_cores  # noqa: F401  (shares the cores)
from test_torch_port_data import build_corpus

# 7 train items in batches of 2 under a 700-frame budget: 4 batches an epoch
LOOP = dict(tb_log_interval=2, val_check_interval=2, num_sanity_val_steps=1,
            eval_max_batches=1, num_ckpt_keep=5)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return build_corpus(tmp_path_factory.mktemp("corpus"))


def read_log(work_dir):
    with open(os.path.join(work_dir, "log.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def fitted(corpus, tmp_path_factory):
    """A 4-step fit (validation and checkpoint at steps 2 and 4) with the
    epoch plan the trainer hands to its train step; -> (cfg, stdout, the
    steps_per_epoch it passed)."""
    _, pcfg, _ = corpus
    cfg = pcfg.replace(work_dir=str(tmp_path_factory.mktemp("fit")), **LOOP)
    seen = []
    real = trainer_mod.make_train_step

    def spy(*args):
        seen.append(args[-1])
        return real(*args)

    mp = pytest.MonkeyPatch()
    mp.setattr(trainer_mod, "make_train_step", spy)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            Trainer(cfg, device="cpu").fit(max_updates=4)
    finally:
        mp.undo()
    return cfg, out.getvalue(), seen


def test_fit_logs_validates_and_checkpoints(fitted):
    cfg, out, seen = fitted
    wd = cfg.work_dir
    plan = batch_by_size(VISingerDataset(cfg, "train").item_lengths(),
                         cfg.max_tokens, cfg.max_sentences)
    assert seen == [len(plan)] == [4]
    assert "| sanity val (1 batches):" in out
    files = set(os.listdir(wd))
    assert {"model_ckpt_steps_2.pt", "model_ckpt_steps_4.pt", "best.json",
            "model_ckpt_best.pt", "log.jsonl"} <= files
    assert os.path.isdir(os.path.join(wd, "codes", "visinger_tpu_torch",
                                      "training"))
    assert any(f.startswith("events") for f in os.listdir(
        os.path.join(wd, "tb")))
    log = read_log(wd)
    train = [r for r in log if r["prefix"] == "train"]
    val = [r for r in log if r["prefix"] == "val"]
    assert [r["step"] for r in train] == [2, 4]
    assert [r["step"] for r in val] == [2, 4]
    keys = {"kl", "kl_v", "mel_l1", "uv", "f0", "ctc", "adv", "fm",
            "total_g", "disc", "gnorm_g", "steps_per_s"}
    for r in train:
        assert set(r) == keys | {"step", "prefix"}
        assert all(math.isfinite(r[k]) for k in keys)
    best = json.loads(open(os.path.join(wd, "best.json")).read())
    assert best["val_loss"] == min(r["val_loss"] for r in val)
    assert best["step"] in (2, 4) and math.isfinite(best["val_loss"])


def test_fit_resumes_from_the_last_checkpoint(fitted, capsys):
    """A new trainer on the same work dir resumes at step 4 (no sanity
    validation) and goes on to ``max_updates``."""
    cfg, _, _ = fitted
    state = Trainer(cfg, device="cpu").fit(max_updates=6)
    out = capsys.readouterr().out
    assert "| resumed from step 4" in out and "sanity" not in out
    assert state.step == 6
    assert latest_checkpoint(cfg.work_dir).endswith("steps_6.pt")
    train = [r["step"] for r in read_log(cfg.work_dir)
             if r["prefix"] == "train"]
    assert train == [2, 4, 6]


@pytest.mark.parametrize("plan,accum,override", [
    (4, 1, 0), (7, 1, 0), (7, 2, 0), (7, 1, 3)])
def test_learning_rate_per_step_matches_optax(plan, accum, override):
    """The port's learning rate after each optimizer step against JAX's
    ``make_optimizers(cfg, steps_per_epoch)``, read from its update with
    zero gradients (weight decay 1: the update is -lr * param).  With
    gamma 0.5 the float32 values are exact."""
    hp = dict(scheduler_gamma=0.5, weight_decay=1.0, steps_per_epoch=override,
              accumulate_grad_batches=accum)
    opt_j = j_make_optimizers(jax_tiny_config(**hp), plan)[0]
    opt_p = make_optimizers(tiny_config().replace(**hp), plan)[0]
    params = {"w": jnp.ones(())}
    state = opt_j.init(params)
    zeros = {"w": jnp.zeros(())}
    update = jax.jit(opt_j.update)
    lrs = []
    for _ in range(16 * accum):
        upd, state = update(zeros, state, params)
        lrs.append(-float(upd["w"]))
    lrs = lrs[accum - 1::accum]        # the optimizer steps
    want = [np.float32(opt_p.learning_rate(k)) for k in range(16)]
    assert lrs == want
    assert len(set(lrs)) >= 3           # two decays inside the window


def _one_step(cfg, work_dir):
    cfg = cfg.replace(work_dir=work_dir, tb_log_interval=1,
                      val_check_interval=10 ** 6, num_sanity_val_steps=0,
                      save_codes=False)
    Trainer(cfg, device="cpu").fit(max_updates=1)
    return read_log(work_dir)[0]


def test_device_store_and_prefetch_routes_give_the_same_first_step(
        corpus, tmp_path):
    _, pcfg, _ = corpus
    store = _one_step(pcfg.replace(device_resident_data=True),
                      str(tmp_path / "store"))
    host = _one_step(pcfg.replace(device_resident_data=False),
                     str(tmp_path / "host"))
    for rec in (store, host):
        rec.pop("steps_per_s")
    assert store == host
    capped = _one_step(pcfg.replace(device_data_max_mb=0.001),
                       str(tmp_path / "capped"))
    capped.pop("steps_per_s")
    assert capped == host


def test_profile_window_writes_a_chrome_trace(corpus, tmp_path):
    """``profile_dir``: steps from ``profile_start_step`` are traced, the
    window closed at the end of the run when it is shorter than 5 steps."""
    _, pcfg, _ = corpus
    prof = tmp_path / "prof"
    cfg = pcfg.replace(work_dir=str(tmp_path / "w"), tb_log_interval=1,
                       val_check_interval=10 ** 6, num_sanity_val_steps=0,
                       save_codes=False, profile_dir=str(prof),
                       profile_start_step=1)
    Trainer(cfg, device="cpu").fit(max_updates=2)
    trace = json.loads((prof / "trace_steps_1_2.json").read_text())
    assert any(e.get("name") == "aten::conv1d"
               for e in trace["traceEvents"])


def test_validate_is_repeatable(fitted):
    """Two validations of one state give the same metrics (fixed draws,
    no dropout) and leave the model in training mode."""
    cfg, _, _ = fitted
    tr = Trainer(cfg, device="cpu")
    state = tr.init_state()
    tr.model.train()
    a = tr.validate(state)
    b = tr.validate(state, max_batches=5)
    assert a == b and set(a) == {"kl", "mel_l1", "uv", "f0", "ctc",
                                 "total_g"}
    assert all(math.isfinite(v) for v in a.values())
    assert tr.model.training


def test_run_cli_train_validate_infer(corpus, tmp_path, monkeypatch,
                                      capsys):
    """``train`` writes the merged config and checkpoints; a second launch
    re-reads the saved config and resumes; ``validate`` and ``infer``
    (a MIDI file to a wav, full and streamed) leave the config as it was."""
    _, pcfg, _ = corpus
    monkeypatch.chdir(tmp_path)
    cfg_fn = tmp_path / "cfg.json"
    cfg_fn.write_text(json.dumps(pcfg.replace(save_codes=False).to_dict()))
    hp = "max_updates=2,val_check_interval=2,tb_log_interval=1," \
         "num_sanity_val_steps=0,eval_max_batches=1"
    run.main(["train", "--exp_name", "x", "--config", str(cfg_fn),
              "--hparams", hp, "--device", "cpu"])
    wd = tmp_path / "checkpoints" / "x"
    saved = (wd / "config.json").read_bytes()
    conf = json.loads(saved)
    assert conf["max_updates"] == 2 and conf["work_dir"] == "checkpoints/x"
    assert conf["binary_data_dir"] == pcfg.binary_data_dir
    assert latest_checkpoint(str(wd)).endswith("steps_2.pt")

    # the saved config is re-read (its data dir, not the recipe's)
    run.main(["train", "--exp_name", "x", "--hparams", "max_updates=3",
              "--device", "cpu"])
    assert "| resumed from step 2" in capsys.readouterr().out
    assert latest_checkpoint(str(wd)).endswith("steps_3.pt")

    means = run.main(["validate", "--exp_name", "x", "--device", "cpu",
                      "--hparams", "eval_max_batches=2"])
    assert "| validating from step 3" in capsys.readouterr().out
    assert set(means) == {"kl", "mel_l1", "uv", "f0", "ctc", "total_g"}

    midi = str(tmp_path / "song.mid")
    write_midi(midi, [Note(480 * i, 480 * i + 400, 60 + i, 80)
                      for i in range(4)],
               lyrics=[(480 * i, s) for i, s in enumerate("가나다라")])
    for extra in ([], ["--stream"]):
        out = str(tmp_path / f"out{len(extra)}.wav")
        rtf = run.main(["infer", "--exp_name", "x", "--device", "cpu",
                        "--midi", midi, "--out", out, *extra])
        assert rtf > 0 and os.path.getsize(out) > 1000
    assert (wd / "config.json").read_bytes() == saved
    with pytest.raises(KeyError, match="no_such_key"):
        run.main(["validate", "--exp_name", "x", "--device", "cpu",
                  "--hparams", "no_such_key=1"])
