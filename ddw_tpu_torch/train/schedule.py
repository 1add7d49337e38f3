"""LR-schedule + callback wiring — the port's copy of
``ddw_tpu.train.schedule``.

The trainer needs the same four-piece suite — per-batch Goyal warmup,
optional cosine decay, ReduceLROnPlateau, optional EarlyStopping — with the
same subtle semantics: counters restore from checkpoint metadata so resume =
continuation; past warmup the LR is set to the scaled target exactly once
(and NOT on resume, which would clobber plateau cuts the restored opt_state
carries); plateau only runs past warmup (a cut fired during warmup would be
dropped while still resetting the patience counter); callbacks consume the
epoch's metrics BEFORE the checkpoint saves their counters. This module is
the single home for those rules.
"""

from __future__ import annotations

import dataclasses

from ddw_tpu_torch.train.callbacks import (
    CosineDecay,
    EarlyStopping,
    LRWarmup,
    ReduceLROnPlateau,
)
from ddw_tpu_torch.train.step import TrainState, get_lr, set_lr


@dataclasses.dataclass
class ScheduleSuite:
    """The trainer callback suite; build via :meth:`build`."""

    warmup: LRWarmup
    cosine: CosineDecay | None
    plateau: ReduceLROnPlateau
    early: EarlyStopping | None
    warmup_epochs: int

    @classmethod
    def build(cls, cfg, world: int, restored_meta: dict | None
              ) -> "ScheduleSuite":
        if cfg.lr_schedule not in ("plateau", "cosine"):
            raise ValueError(f"unknown train.lr_schedule "
                             f"{cfg.lr_schedule!r}; use 'plateau' or "
                             f"'cosine'")
        scale = world if cfg.scale_lr_by_world else 1
        warmup = LRWarmup(cfg.learning_rate, scale, cfg.warmup_epochs)
        cosine = (CosineDecay(cfg.learning_rate, scale, cfg.warmup_epochs,
                              cfg.epochs, cfg.cosine_final_lr_frac)
                  if cfg.lr_schedule == "cosine" else None)
        plateau = ReduceLROnPlateau(cfg.plateau_patience, cfg.plateau_factor)
        early = (EarlyStopping(cfg.early_stop_patience)
                 if cfg.early_stop_patience else None)
        if restored_meta and "callbacks" in restored_meta:
            # Resumed patience counters: an interrupted-then-resumed run
            # tracks the uninterrupted one metric-for-metric.
            cb = restored_meta["callbacks"]
            plateau.load_state_dict(cb["plateau"])
            if early is not None and "early" in cb:
                early.load_state_dict(cb["early"])
        return cls(warmup, cosine, plateau, early, cfg.warmup_epochs)

    # -- the drift-prone rules, in one place ----------------------------
    def initial_state(self, state: TrainState, start_epoch: int,
                      resumed: bool) -> TrainState:
        """Past warmup (incl. warmup_epochs=0): start at the scaled target
        once; afterwards only the plateau callback may change the LR. A
        resumed opt_state already carries the LR training left off at
        (including plateau cuts) — don't clobber it."""
        if (self.cosine is None and start_epoch >= self.warmup_epochs
                and not resumed):
            return set_lr(state,
                          self.warmup.lr_for_epoch(self.warmup_epochs))
        return state

    def lr_for_batch(self, epoch: int, step_in_epoch: int,
                     steps_per_epoch: int) -> float | None:
        """Per-batch LR, or None when the live LR must be left alone (the
        plateau regime past warmup)."""
        if self.cosine is not None:
            return self.cosine.lr_for_step(epoch, step_in_epoch,
                                           steps_per_epoch)
        if epoch < self.warmup_epochs and self.warmup.world_size > 1:
            return self.warmup.lr_for_step(epoch, step_in_epoch,
                                           steps_per_epoch)
        return None

    def epoch_end(self, state: TrainState, val_loss: float,
                  epoch: int) -> tuple[TrainState, bool]:
        """Run plateau (gated past warmup) + early stop on this epoch's
        metric. Call BEFORE checkpointing so the saved counters (and any LR
        cut) are exactly the state the next epoch starts from."""
        if self.cosine is None and epoch + 1 >= self.warmup_epochs:
            lr_now = get_lr(state)
            new_lr = self.plateau.update(val_loss, lr_now)
            if new_lr != lr_now:
                state = set_lr(state, new_lr)
        stop = self.early is not None and self.early.should_stop(val_loss)
        return state, stop

    def state_dicts(self) -> dict:
        out = {"plateau": self.plateau.state_dict()}
        if self.early is not None:
            out["early"] = self.early.state_dict()
        return out
