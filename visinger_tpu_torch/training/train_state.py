"""Train state and optimizers (counterpart of the JAX package's
``training/train_state.py``).

Two AdamW optimizers (β = (0.8, 0.99), eps 1e-9; weight decay 1e-3 for the
generator, 0 for the discriminator) behind a global-norm clip of 1.0, with a
staircase exponential learning-rate decay once per epoch of optimizer
steps (``make_optimizers``: the trainer's epoch plan unless the config sets
``steps_per_epoch``).  Each is the
optax chain ``clip_by_global_norm -> adamw`` written out, so the same
gradients give the same parameters: the clip is g·max/‖g‖ when ‖g‖ > max
(``torch.nn.utils.clip_grad_norm_`` divides by ‖g‖ + 1e-6 instead), Adam
bias-corrects both moments, and the weight decay is added to the Adam step
before the learning rate scales it.

The routes (``ops/clipped_adamw.py``).  On the card ``ClippedAdamW.update``
is one hand-written CUDA kernel in three launches (a float32 sum of squares
a chunk of the leaves, the norm and clip factor from those sums in a fixed
order, then the AdamW step on every element), and ``global_norm`` its
first two; the host passes the constants by value and never waits.  On the
CPU the norm is a sum of per-leaf sums and the step the multi-tensor
(``torch._foreach_*``) chain.  ``update`` returns the norm before the
clip, so the train step reads ``gnorm_g`` from it instead of taking the
norm twice.

With ``accumulate_grad_batches`` = k > 1, ``ClippedAdamW.step`` is
``optax.MultiSteps(chain, k)``: each call folds its gradients into a
running mean (acc += (g - acc) / (n + 1), n the micro-steps so far), and
every k-th call runs the clip and AdamW once on the mean and clears it;
the other calls leave the parameters and the Adam moments as they are.
The learning-rate schedule counts the AdamW updates, i.e. optimizer steps.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from visinger_tpu_torch.config import Config
from visinger_tpu_torch.ops import clipped_adamw


@dataclass
class AdamState:
    """Moments of every parameter and the number of updates so far; with
    gradient accumulation also the running mean of this optimizer step's
    gradients and the micro-steps folded into it."""
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]
    count: int = 0
    acc: list[torch.Tensor] | None = None
    mini_step: int = 0


def init_adam(params: list[torch.Tensor]) -> AdamState:
    return AdamState([torch.zeros_like(p) for p in params],
                     [torch.zeros_like(p) for p in params])


@dataclass(frozen=True)
class ClippedAdamW:
    lr: float
    decay_steps: int
    gamma: float
    b1: float
    b2: float
    eps: float
    weight_decay: float
    max_norm: float

    def learning_rate(self, count: int) -> float:
        """Staircase exponential decay after ``count`` updates."""
        return self.lr * self.gamma ** (count // self.decay_steps)

    @torch.no_grad()
    def update(self, params: list[torch.Tensor], grads: list[torch.Tensor],
               state: AdamState) -> torch.Tensor:
        """One clipped AdamW step, in place on ``params`` and ``state``;
        returns the global norm of ``grads`` before the clip (0-d, on their
        device)."""
        lr = self.learning_rate(state.count)
        state.count += 1
        return clipped_adamw.update(
            params, grads, state, lr=lr, count=state.count, b1=self.b1,
            b2=self.b2, eps=self.eps, weight_decay=self.weight_decay,
            max_norm=self.max_norm)

    @torch.no_grad()
    def step(self, params: list[torch.Tensor], grads: list[torch.Tensor],
             state: AdamState, accum: int = 1) -> bool:
        """One micro-step of ``accum`` (``optax.MultiSteps``): fold
        ``grads`` into the running mean and, at the k-th, ``update`` with the
        mean.  Returns whether the parameters moved."""
        if accum <= 1:
            self.update(params, grads, state)
            return True
        if state.acc is None:
            state.acc = [torch.zeros_like(g) for g in grads]
        delta = torch._foreach_sub(grads, state.acc)
        torch._foreach_div_(delta, float(state.mini_step + 1))
        torch._foreach_add_(state.acc, delta)
        state.mini_step += 1
        if state.mini_step < accum:
            return False
        self.update(params, state.acc, state)
        torch._foreach_zero_(state.acc)
        state.mini_step = 0
        return True


def make_optimizers(cfg: Config, steps_per_epoch: int | None = None
                    ) -> tuple[ClippedAdamW, ClippedAdamW]:
    """(generator optimizer, discriminator optimizer), clipping at
    ``clip_grad_norm`` (at 0 not at all: the clip factor is then exactly 1,
    and the norm is still returned).  The learning rate
    decays once per epoch: ``cfg.steps_per_epoch`` when it is above 0, else
    ``steps_per_epoch`` (the trainer's epoch plan, in batches), else 280;
    divided by ``accumulate_grad_batches``, since the schedule counts
    optimizer steps."""
    spe = cfg.steps_per_epoch or int(steps_per_epoch or 0) or 280
    spe = max(spe // max(cfg.accumulate_grad_batches, 1), 1)
    common = dict(lr=cfg.lr, decay_steps=spe,
                  gamma=cfg.scheduler_gamma, b1=cfg.optimizer_adam_beta1,
                  b2=cfg.optimizer_adam_beta2, eps=cfg.eps,
                  max_norm=cfg.clip_grad_norm if cfg.clip_grad_norm > 0
                  else float("inf"))
    return (ClippedAdamW(weight_decay=cfg.weight_decay, **common),
            ClippedAdamW(weight_decay=cfg.disc_weight_decay, **common))


@dataclass
class TrainState:
    """The models, both optimizers' states, the step count and the one
    generator every random draw of a step comes from (posterior noise, slice
    starts, dropout masks and attention-dropout seeds)."""
    model: torch.nn.Module
    disc: torch.nn.Module
    opt_state_g: AdamState
    opt_state_d: AdamState
    step: int
    generator: torch.Generator


def create_train_state(model: torch.nn.Module, disc: torch.nn.Module,
                       seed: int = 0) -> TrainState:
    """A fresh state for ``model`` and ``disc``, with a generator on the
    models' device seeded from ``seed``."""
    dev = next(model.parameters()).device
    return TrainState(
        model, disc, init_adam(list(model.parameters())),
        init_adam(list(disc.parameters())), 0,
        torch.Generator(device=dev).manual_seed(seed))
