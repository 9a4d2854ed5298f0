"""Train state and optimizers (counterpart of the JAX package's
``training/train_state.py``).

Two AdamW optimizers (β = (0.8, 0.99), eps 1e-9; weight decay 1e-3 for the
generator, 0 for the discriminator) behind a global-norm clip of 1.0, with a
staircase exponential learning-rate decay once per epoch of
``steps_per_epoch`` optimizer steps (0 in the config: 280).  Each is the
optax chain ``clip_by_global_norm -> adamw`` written out, so the same
gradients give the same parameters: the clip is g·max/‖g‖ when ‖g‖ > max
(``torch.nn.utils.clip_grad_norm_`` divides by ‖g‖ + 1e-6 instead), Adam
bias-corrects both moments, and the weight decay is added to the Adam step
before the learning rate scales it.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from visinger_tpu_torch.config import Config


@dataclass
class AdamState:
    """Moments of every parameter and the number of updates so far."""
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]
    count: int = 0


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


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ t²) over every element of every tensor."""
    return torch.sqrt(sum(t.square().sum() for t in tensors))


def make_optimizers(cfg: Config) -> tuple[ClippedAdamW, ClippedAdamW]:
    """(generator optimizer, discriminator optimizer); an epoch is
    ``cfg.steps_per_epoch`` steps, or 280 when that is 0."""
    common = dict(lr=cfg.lr, decay_steps=cfg.steps_per_epoch or 280,
                  gamma=cfg.scheduler_gamma, b1=cfg.optimizer_adam_beta1,
                  b2=cfg.optimizer_adam_beta2, eps=cfg.eps,
                  max_norm=cfg.clip_grad_norm)
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
