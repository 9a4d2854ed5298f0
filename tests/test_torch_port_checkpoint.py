"""The port's checkpoints (the counterpart of ``tests/test_checkpoint.py``):
save, restore, rotation and best-tracking; the background writer against
the synchronous one and its error propagation; the shape-tolerant warm
start; and a restored state that continues bit for bit on the CPU."""

import json
import os

import pytest
import torch

from visinger_tpu_torch.config import tiny_config
from visinger_tpu_torch.data.synthetic import synthetic_batch
from visinger_tpu_torch.models.factory import build_models
from visinger_tpu_torch.training.checkpoint import (AsyncCheckpointer,
                                                    latest_checkpoint,
                                                    load_checkpoint,
                                                    restore_checkpoint,
                                                    restore_latest,
                                                    save_checkpoint,
                                                    warm_start)
from visinger_tpu_torch.training.train_state import create_train_state
from visinger_tpu_torch.training.train_step import make_train_step

import test_torch_port_cores  # noqa: F401  (shares the cores)

VOCABS = (40, 96, 64)


def make_state(seed=0, vocabs=VOCABS):
    model, disc = build_models(tiny_config(), *vocabs, device="cpu",
                               seed=seed)
    return create_train_state(model, disc, seed=seed)


def batch(seed=0):
    raw = synthetic_batch(2, 12, 64, *VOCABS, 16, 300, seed=seed)
    raw.pop("spec")
    return raw


def params(state):
    return [p.detach().clone() for p in
            list(state.model.parameters()) + list(state.disc.parameters())]


def test_save_restore_rotate_best(tmp_path):
    state = make_state()
    wd = str(tmp_path)
    for step, vl in [(1, 5.0), (2, 3.0), (3, 4.0)]:
        state.step = step
        save_checkpoint(wd, state, num_keep=2, val_loss=vl)
    files = sorted(os.listdir(wd))
    assert "model_ckpt_steps_3.pt" in files
    assert "model_ckpt_steps_2.pt" in files
    assert "model_ckpt_steps_1.pt" not in files       # rotated out
    assert not any(f.endswith(".part") for f in files)
    assert json.loads((tmp_path / "best.json").read_text()) == \
        {"val_loss": 3.0, "step": 2}
    assert load_checkpoint(str(tmp_path / "model_ckpt_best.pt"))["step"] == 2
    assert latest_checkpoint(wd).endswith("steps_3.pt")

    other = make_state(seed=1)
    assert not all(torch.equal(a, b) for a, b in zip(params(other),
                                                     params(state)))
    restored, step = restore_latest(wd, other)
    assert step == 3 == restored.step
    assert all(torch.equal(a, b) for a, b in zip(params(restored),
                                                 params(state)))
    assert restore_latest(str(tmp_path / "empty"), other)[1] == 0


def test_async_checkpointer_matches_sync(tmp_path):
    """The background writer gives the synchronous writer's bytes and the
    same best-tracking."""
    state = make_state()
    state.step = 5
    save_checkpoint(str(tmp_path / "sync"), state, num_keep=2, val_loss=1.0)
    ac = AsyncCheckpointer()
    ac.save(str(tmp_path / "async"), state, num_keep=2, val_loss=1.0)
    ac.wait()
    for name in ("model_ckpt_steps_5.pt", "model_ckpt_best.pt", "best.json"):
        assert (tmp_path / "sync" / name).read_bytes() == \
            (tmp_path / "async" / name).read_bytes(), name


def test_async_checkpointer_snapshots_and_rotates(tmp_path):
    """Back-to-back saves write one after the other and rotate as the
    synchronous path; each file holds the state as it was at its save,
    although the state changes in place right after."""
    state = make_state()
    wd = str(tmp_path)
    ac = AsyncCheckpointer()
    first = params(state)
    for step, vl in [(1, 5.0), (2, 3.0), (3, 4.0)]:
        state.step = step
        ac.save(wd, state, num_keep=2, val_loss=vl)
        with torch.no_grad():
            for p in state.model.parameters():
                p.add_(1.0)
    ac.wait()
    assert sorted(f for f in os.listdir(wd) if "steps" in f) == \
        ["model_ckpt_steps_2.pt", "model_ckpt_steps_3.pt"]
    saved = load_checkpoint(os.path.join(wd, "model_ckpt_steps_3.pt"))
    p0 = dict(zip([n for n, _ in state.model.named_parameters()], first))
    for name, p in saved["model"].items():
        if name in p0:
            assert torch.equal(p, p0[name] + 1.0 + 1.0), name


def test_async_checkpointer_error_propagates(tmp_path):
    """A writer-thread failure re-raises on ``wait`` and the checkpointer
    stays usable."""
    state = make_state()
    blocker = tmp_path / "blocked"
    blocker.write_text("a file where a directory is needed")
    ac = AsyncCheckpointer()
    ac.save(str(blocker / "sub"), state)        # makedirs fails in the thread
    with pytest.raises(OSError):
        ac.wait()
    ok = str(tmp_path / "ok")
    ac.save(ok, state)
    ac.wait()
    assert latest_checkpoint(ok) is not None


def test_warm_start_shape_tolerant(tmp_path, capsys):
    """Matching tensors are copied in; the embedding of another vocabulary
    keeps its fresh init; step and optimizer state stay fresh."""
    state = make_state()
    state.step = 7
    state.opt_state_g.count = 7
    save_checkpoint(str(tmp_path), state)
    target = make_state(seed=3, vocabs=(55, 96, 64))
    fresh = {n: p.detach().clone() for n, p in target.model.named_parameters()}
    warm_start(latest_checkpoint(str(tmp_path)), target)
    src = dict(state.model.named_parameters())
    mismatched = [n for n, p in target.model.named_parameters()
                  if p.shape != src[n].shape]
    # the phoneme embedding and the CTC head's projection
    assert len(mismatched) == 3 and "text_encoder.ph_emb.weight" in mismatched
    for name, p in target.model.named_parameters():
        assert torch.equal(p, fresh[name] if name in mismatched
                           else src[name]), name
    assert all(torch.equal(a, b) for a, b in zip(
        target.disc.parameters(), state.disc.parameters()))
    assert target.step == 0 and target.opt_state_g.count == 0
    assert all(float(m.abs().max()) == 0 for m in target.opt_state_g.mu)
    out = capsys.readouterr().out
    assert "skip gen/text_encoder.ph_emb.weight" in out


def test_restored_state_continues_bit_for_bit(tmp_path):
    """Two CPU train steps (dropout on) from a restored state equal, bit
    for bit, two steps from the state that was saved: parameters, Adam
    moments, metrics and the generator's draws."""
    cfg = tiny_config()
    state = make_state()
    step_fn = make_train_step(cfg, state.model, state.disc, device="cpu")
    state, _ = step_fn(state, batch(0))        # Adam state and draws moved
    save_checkpoint(str(tmp_path), state)
    runs = []
    for st in (state, restore_checkpoint(latest_checkpoint(str(tmp_path)),
                                         make_state(seed=9))):
        fn = make_train_step(cfg, st.model, st.disc, device="cpu")
        metrics = []
        for s in (1, 2):
            st, m = fn(st, batch(s))
            metrics.append({k: v.clone() for k, v in m.items()})
        runs.append((params(st), st.opt_state_g.mu + st.opt_state_d.nu,
                     metrics, st.step, st.generator.get_state()))
    (p_a, o_a, m_a, s_a, g_a), (p_b, o_b, m_b, s_b, g_b) = runs
    assert s_a == s_b == 3
    assert all(torch.equal(a, b) for a, b in zip(p_a, p_b))
    assert all(torch.equal(a, b) for a, b in zip(o_a, o_b))
    assert all(torch.equal(a[k], b[k]) for a, b in zip(m_a, m_b) for k in a)
    assert torch.equal(g_a, g_b)
