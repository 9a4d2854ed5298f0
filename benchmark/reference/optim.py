"""The two optimizers in plain PyTorch: a frozen copy of the port's
``ClippedAdamW`` (global-norm clip, then AdamW with bias-corrected moments
and the weight decay added before the learning rate scales the step).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


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
               state: AdamState) -> None:
        """One clipped AdamW step, in place on ``params`` and ``state``."""
        norm = global_norm(grads)
        factor = torch.where(norm < self.max_norm, torch.ones_like(norm),
                             self.max_norm / norm)
        grads = torch._foreach_mul(grads, factor)
        lr = self.learning_rate(state.count)
        state.count += 1
        torch._foreach_mul_(state.mu, self.b1)
        torch._foreach_add_(state.mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(state.nu, self.b2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1 - self.b2)
        mu_hat = torch._foreach_div(state.mu, 1 - self.b1 ** state.count)
        nu_hat = torch._foreach_div(state.nu, 1 - self.b2 ** state.count)
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, self.eps)
        step = torch._foreach_div(mu_hat, denom)
        if self.weight_decay:
            torch._foreach_add_(step, params, alpha=self.weight_decay)
        torch._foreach_add_(params, step, alpha=-lr)


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


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ t²) over every element of every tensor."""
    return torch.sqrt(sum(t.square().sum() for t in tensors))


def make_optimizers(cfg, steps_per_epoch: int | None = None
                    ) -> tuple[ClippedAdamW, ClippedAdamW]:
    """(generator optimizer, discriminator optimizer).  The learning rate
    decays once per epoch: ``cfg.steps_per_epoch`` when it is above 0, else
    ``steps_per_epoch`` (the trainer's epoch plan, in batches), else 280;
    divided by ``accumulate_grad_batches``, since the schedule counts
    optimizer steps."""
    spe = cfg.steps_per_epoch or int(steps_per_epoch or 0) or 280
    spe = max(spe // max(cfg.accumulate_grad_batches, 1), 1)
    common = dict(lr=cfg.lr, decay_steps=spe,
                  gamma=cfg.scheduler_gamma, b1=cfg.optimizer_adam_beta1,
                  b2=cfg.optimizer_adam_beta2, eps=cfg.eps,
                  max_norm=cfg.clip_grad_norm)
    return (ClippedAdamW(weight_decay=cfg.weight_decay, **common),
            ClippedAdamW(weight_decay=cfg.disc_weight_decay, **common))
