"""Checkpoint save and restore with rotation and best-tracking (the
counterpart of the JAX package's ``training/checkpoint.py``).

One file per step, ``model_ckpt_steps_{step}.pt``, written atomically
(``.part`` + ``os.replace``); the newest ``num_ckpt_keep`` are kept, and the
checkpoint with the lowest validation loss is copied to
``model_ckpt_best.pt`` beside ``best.json``.  A file holds plain CPU
tensors, ints and dicts only: both models' ``state_dict``s, both
``AdamState``s, the step and the state's ``torch.Generator`` state.  It is
loaded with ``torch.load(weights_only=True)`` on the CPU and copied into
the state's tensors, so a checkpoint written on the card restores on the
CPU and the other way round.  The generator's state restores onto a
generator of the same device type only (a CUDA generator's state is a
Philox seed and offset, a CPU generator's a Mersenne Twister state); across
device types the state keeps its fresh generator.
"""

from __future__ import annotations

import glob
import json
import os
import re
import shutil
import threading

import torch

from visinger_tpu_torch.convert import params_from_jax
from visinger_tpu_torch.training.train_state import AdamState, TrainState
from visinger_tpu_torch.utils import flax_msgpack

_CKPT_RE = re.compile(r"model_ckpt_steps_(\d+)\.pt$")


def _ckpt_path(work_dir: str, step: int) -> str:
    return os.path.join(work_dir, f"model_ckpt_steps_{step}.pt")


def _ckpt_step(path: str) -> int:
    m = _CKPT_RE.search(path)
    return int(m.group(1)) if m else -1


def state_to_host(state: TrainState) -> dict:
    """A copy of ``state`` as plain CPU tensors, ints and dicts: what a
    checkpoint file holds."""
    def host(t: torch.Tensor) -> torch.Tensor:
        return t.detach().to("cpu", copy=True)

    def adam(a: AdamState) -> dict:
        out = {"mu": [host(t) for t in a.mu], "nu": [host(t) for t in a.nu],
               "count": int(a.count)}
        if a.acc is not None:  # gradient accumulation in flight
            out["acc"] = [host(t) for t in a.acc]
            out["mini_step"] = int(a.mini_step)
        return out

    return {
        "model": {k: host(v) for k, v in state.model.state_dict().items()},
        "disc": {k: host(v) for k, v in state.disc.state_dict().items()},
        "opt_state_g": adam(state.opt_state_g),
        "opt_state_d": adam(state.opt_state_d),
        "step": int(state.step),
        "generator": state.generator.get_state(),
        "generator_device": state.generator.device.type,
    }


def write_checkpoint(work_dir: str, snap: dict, num_keep: int = 100,
                     val_loss: float | None = None) -> str:
    """Write a host snapshot (``state_to_host``) atomically, rotate to the
    newest ``num_keep`` and track the best ``val_loss``; -> the path."""
    os.makedirs(work_dir, exist_ok=True)
    step = snap["step"]
    path = _ckpt_path(work_dir, step)
    torch.save(snap, path + ".part")
    os.replace(path + ".part", path)
    for old in sorted(all_checkpoints(work_dir), key=_ckpt_step)[:-num_keep]:
        os.remove(old)
    if val_loss is not None:
        best_fn = os.path.join(work_dir, "best.json")
        best = {"val_loss": float("inf")}
        if os.path.exists(best_fn):
            with open(best_fn) as f:
                best = json.load(f)
        if val_loss < best["val_loss"]:
            best_ckpt = os.path.join(work_dir, "model_ckpt_best.pt")
            shutil.copyfile(path, best_ckpt + ".part")
            os.replace(best_ckpt + ".part", best_ckpt)
            with open(best_fn + ".part", "w") as f:
                json.dump({"val_loss": float(val_loss), "step": step}, f)
            os.replace(best_fn + ".part", best_fn)
    return path


def save_checkpoint(work_dir: str, state: TrainState, num_keep: int = 100,
                    val_loss: float | None = None) -> str:
    """Copy ``state`` to the host and write it (``write_checkpoint``)."""
    return write_checkpoint(work_dir, state_to_host(state), num_keep,
                            val_loss)


class AsyncCheckpointer:
    """Checkpoint writes on a worker thread (``async_checkpoint: true``).

    ``save`` copies the state to the host on the caller's thread (the
    training loop goes on changing the state's tensors in place, so the
    copy must be taken before the call returns); serialization, the atomic
    write, rotation and best-tracking run on the worker.  One write at a
    time: a second ``save`` waits for the first.  A worker's error
    re-raises on the next ``save`` or ``wait``."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._exc: BaseException | None = None

    def save(self, work_dir: str, state: TrainState, num_keep: int = 100,
             val_loss: float | None = None) -> None:
        self.wait()
        snap = state_to_host(state)

        def run():
            try:
                write_checkpoint(work_dir, snap, num_keep, val_loss)
            except BaseException as e:  # re-raised by wait()
                self._exc = e

        self._thread = threading.Thread(target=run, name="ckpt-writer",
                                        daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the write in flight; re-raise its error if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc


def all_checkpoints(work_dir: str) -> list[str]:
    return [p for p in glob.glob(os.path.join(work_dir,
                                              "model_ckpt_steps_*.pt"))
            if _ckpt_step(p) >= 0]


def latest_checkpoint(work_dir: str) -> str | None:
    ckpts = sorted(all_checkpoints(work_dir), key=_ckpt_step)
    return ckpts[-1] if ckpts else None


def load_checkpoint(path: str) -> dict:
    """A checkpoint file's contents, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


@torch.no_grad()
def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Copy a checkpoint into ``state`` in place (its models, Adam states,
    step and, for the same device type, generator); -> ``state``."""
    saved = load_checkpoint(path)
    state.model.load_state_dict(saved["model"], strict=True)
    state.disc.load_state_dict(saved["disc"], strict=True)
    for mine, theirs in ((state.opt_state_g, saved["opt_state_g"]),
                         (state.opt_state_d, saved["opt_state_d"])):
        for key in ("mu", "nu"):
            own = getattr(mine, key)
            if len(own) != len(theirs[key]):
                raise ValueError(f"{path}: {len(theirs[key])} Adam moments, "
                                 f"the state has {len(own)}")
            for t, s in zip(own, theirs[key]):
                t.copy_(s)
        mine.count = int(theirs["count"])
        if "acc" in theirs:
            mine.acc = [s.to(t.device) for t, s in zip(mine.mu,
                                                        theirs["acc"])]
            mine.mini_step = int(theirs["mini_step"])
        else:
            mine.acc, mine.mini_step = None, 0
    state.step = int(saved["step"])
    if saved["generator_device"] == state.generator.device.type:
        state.generator.set_state(saved["generator"])
    else:
        print(f"| {path}: the {saved['generator_device']} generator's state "
              f"is not restored on {state.generator.device.type}")
    return state


def restore_latest(work_dir: str, state: TrainState
                   ) -> tuple[TrainState, int]:
    """-> (state, step) from the newest checkpoint; (state, 0) when there
    is none."""
    path = latest_checkpoint(work_dir)
    if path is None:
        return state, 0
    state = restore_checkpoint(path, state)
    return state, state.step


def load_jax_params(path: str) -> dict:
    """The generator's and the discriminator's parameters of a JAX
    package's checkpoint (``model_ckpt_*.msgpack``, flax's msgpack of its
    ``TrainState``) as the port's ``state_dict`` entries: {"model": ...,
    "disc": ...}.  Read by the port's own msgpack decoder and
    ``convert.params_from_jax``; the optimizer states, step and key in the
    file are not read."""
    with open(path, "rb") as f:
        raw = flax_msgpack.restore(f.read())
    return {"model": params_from_jax(raw["params_g"]),
            "disc": params_from_jax(raw["params_d"])}


@torch.no_grad()
def warm_start(path: str, state: TrainState) -> TrainState:
    """Shape-tolerant warm start from another experiment's checkpoint, the
    port's ``.pt`` or the JAX package's ``.msgpack``: every parameter and
    buffer whose name and shape match is copied in; the rest, the step and
    the optimizer states stay fresh (a JAX checkpoint's optax states are not
    carried over, as the JAX package's own warm start does not)."""
    saved = (load_jax_params(path) if path.endswith(".msgpack")
             else load_checkpoint(path))
    for scope, module, key in (("gen", state.model, "model"),
                               ("disc", state.disc, "disc")):
        own, theirs = module.state_dict(), saved[key]
        n_loaded = 0
        for name, t in own.items():
            s = theirs.get(name)
            if s is not None and s.shape == t.shape:
                t.copy_(s)
                n_loaded += 1
            else:
                print(f"| warm_start skip {scope}/{name} (shape "
                      f"{None if s is None else tuple(s.shape)} vs "
                      f"{tuple(t.shape)})")
        print(f"| warm_start {scope}: {n_loaded}/{len(own)} tensors loaded")
    return state
