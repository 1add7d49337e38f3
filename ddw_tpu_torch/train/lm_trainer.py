"""LM trainer — the port of ``ddw_tpu.train.lm_trainer``: the Trainer
amenities for the TransformerLM family.

What it keeps from ``ddw_tpu``:

- data parallel over the ``torch.distributed`` group, one process per card
  (:func:`ddw_tpu_torch.runtime.dist.process_topology`); the global batch
  is ``batch_size * world``;
- the shared callback suite (:mod:`ddw_tpu_torch.train.schedule`):
  per-batch warmup, plateau or cosine LR, early stopping, through the
  optimizer state's dynamic learning rate;
- ``steps_per_dispatch`` chain plans, gradient accumulation, EMA (evaluated
  through its shadow; refused with LoRA), LoRA (the base frozen by
  :mod:`ddw_tpu_torch.train.lm_step`);
- epoch checkpoints after the callbacks, with the callbacks' counters and
  the epoch's metrics in the metadata; ``resume=True`` continues at the
  next epoch (the loader replays its stream with ``skip_records``), and a
  checkpoint that already covers every epoch returns its metrics with a
  warning; ``checkpoint_keep_best``; tracker logging.

Two data paths, as in ``ddw_tpu``: :meth:`LMTrainer.fit` from an in-memory
token array ``[num_seqs, seq_len + 1]`` (seeded validation split, a
``seed + 1 + epoch`` order per epoch), and :meth:`LMTrainer.fit_tables`
from ``tokens_i32`` tables through :class:`ddw_tpu_torch.data.loader.
ShardedLoader`.

Observability: ``tracer=`` records ``ddw_tpu``'s ``train_chain`` span per
chain boundary, and a :func:`~ddw_tpu_torch.obs.telemetry.tee_run` run
receives ``train.chain_ms`` / ``train.ckpt_write_ms``. ``trace_dir`` and
``monitor_interval_s`` work as in the vision ``Trainer``
(:class:`~ddw_tpu_torch.train.trainer.EpochProfile`, the sysmon monitor on
process 0), where ``ddw_tpu``'s LM trainer leaves them unread.

Not yet ported, refused naming ``ROADMAP.md``: sequence parallelism
(``seq_devices != 1``), pipelines and ZeRO/FSDP (by ``require_ported``) and
MoE (by ``build_lm``). The fault, elastic and preemption hooks are absent,
as in the vision ``Trainer``.
"""

from __future__ import annotations

import dataclasses
import time
import warnings

import numpy as np
import torch

from ddw_tpu_torch.checkpoint.ckpt import (BestCheckpointKeeper,
                                           CheckpointManager)
from ddw_tpu_torch.models.lm import _not_ported, build_lm
from ddw_tpu_torch.runtime.dist import process_topology
from ddw_tpu_torch.train.lm_step import (init_lm_state, make_lm_eval_step,
                                         make_lm_train_chain,
                                         make_lm_train_step)
from ddw_tpu_torch.train.schedule import ScheduleSuite
from ddw_tpu_torch.train.trainer import EpochProfile
from ddw_tpu_torch.train.step import (TrainState, chain_plan, ema_params,
                                      fetch_metrics_mean, get_lr,
                                      make_optimizer, set_lr, with_param_ema)
from ddw_tpu_torch.utils.config import LMCfg, TrainCfg, require_ported, to_dict
from ddw_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class LMTrainResult:
    val_loss: float
    val_accuracy: float
    history: list[dict[str, float]]
    state: TrainState
    epochs_run: int


class LMTrainer:
    """``fit(tokens)`` / ``fit_tables(train, val)`` for
    :class:`ddw_tpu_torch.models.lm.TransformerLM`. ``device`` is the card
    unless the caller asks for ``"cpu"``."""

    def __init__(self, lm_cfg: LMCfg, train_cfg: TrainCfg, device=None,
                 seq_devices: int = 1, run=None, tracer=None):
        require_ported(train_cfg)
        if seq_devices != 1:
            raise _not_ported(f"sequence-parallel LM training (seq_devices="
                              f"{seq_devices})")
        if train_cfg.ema_decay and lm_cfg.lora_rank:
            raise ValueError("train.ema_decay with lm.lora_rank is not "
                             "supported: the LoRA mask would wrap outside "
                             "the EMA shadow — drop one")
        if train_cfg.steps_per_dispatch < 1:
            raise ValueError(f"train.steps_per_dispatch must be >= 1, got "
                             f"{train_cfg.steps_per_dispatch}")
        self.lm_cfg, self.train_cfg, self.run = lm_cfg, train_cfg, run
        self.tracer = tracer   # optional obs Tracer: chain-boundary spans
        self.device = resolve_device(device)
        self.model = build_lm(lm_cfg)

    @property
    def world_size(self) -> int:
        return process_topology()[1]

    def _global_batch(self) -> int:
        world = self.world_size
        if self.train_cfg.num_devices not in (0, world):
            raise ValueError(f"train.num_devices={self.train_cfg.num_devices}"
                             f" but the process group has {world} workers "
                             f"(one card each); launch that many processes")
        return self.train_cfg.batch_size * world

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    # ------------------------------------------------------------------
    def fit(self, tokens: np.ndarray, val_fraction: float = 0.1,
            resume: bool = False) -> LMTrainResult:
        """Train from an in-memory token corpus ``[num_seqs, seq_len+1]``:
        a seeded ``RandomState(seed)`` validation split, each epoch's order
        from ``RandomState(seed + 1 + epoch)``, every rank drawing its slice
        of each global batch."""
        cfg = self.train_cfg
        tokens = np.asarray(tokens, np.int32)
        if tokens.ndim != 2 or tokens.shape[1] < 2:
            raise ValueError(f"tokens must be [num_seqs, seq_len+1], got "
                             f"{tokens.shape}")
        perm = np.random.RandomState(cfg.seed).permutation(len(tokens))
        n_val = max(1, int(len(tokens) * val_fraction))
        val, train = tokens[perm[:n_val]], tokens[perm[n_val:]]
        global_batch = self._global_batch()
        if len(train) < global_batch:
            raise ValueError(f"{len(train)} train sequences < global batch "
                             f"{global_batch}")
        steps_per_epoch = max(1, len(train) // global_batch)
        val_steps = max(1, len(val) // global_batch)
        rank, _ = process_topology()
        local = slice(rank * cfg.batch_size, (rank + 1) * cfg.batch_size)

        def make_providers(start_epoch, plan, chained):
            def train_batches(epoch):
                order = np.random.RandomState(cfg.seed + 1 + epoch
                                              ).permutation(len(train))
                i = 0
                for k in plan:
                    b = train[order[i * global_batch:(i + k) * global_batch]]
                    i += k
                    if chained:
                        # the same k batches the per-step path would draw
                        b = b.reshape(k, global_batch, -1)[:, local]
                        yield (self._to_device(b[..., :-1]),
                               self._to_device(b[..., 1:]))
                    else:
                        b = b[local]
                        yield (self._to_device(b[:, :-1]),
                               self._to_device(b[:, 1:]))

            def val_batches():
                for i in range(val_steps):
                    # modulo the split: every eval batch is a full batch
                    idx = np.arange(i * global_batch,
                                    (i + 1) * global_batch) % len(val)
                    vb = val[idx][local]
                    yield self._to_device(vb[:, :-1]), \
                        self._to_device(vb[:, 1:])

            return train_batches, val_batches, None

        return self._run(steps_per_epoch, val_steps, global_batch,
                         make_providers, resume)

    def fit_tables(self, train_table, val_table,
                   resume: bool = False) -> LMTrainResult:
        """Train from ``tokens_i32`` tables (:func:`ddw_tpu_torch.data.prep.
        write_token_table`) through the sharded loader: shard-selected reads
        per rank, a seeded shuffle, infinite repeat, and exact
        ``skip_records`` resume of the consumed stream."""
        from ddw_tpu_torch.data.loader import ShardedLoader

        cfg = self.train_cfg
        for tbl, role in ((train_table, "train"), (val_table, "val")):
            if tbl.meta.get("encoding") != "tokens_i32":
                raise ValueError(
                    f"{role} table encoding {tbl.meta.get('encoding')!r} != "
                    f"'tokens_i32' — materialize with prep.write_token_table")
        if val_table.meta["seq_plus_one"] != train_table.meta["seq_plus_one"]:
            raise ValueError("train/val token tables disagree on sequence "
                             "length")
        global_batch = self._global_batch()
        steps_per_epoch = train_table.num_records // global_batch
        if steps_per_epoch < 1:
            raise ValueError(f"{train_table.num_records} train sequences < "
                             f"global batch {global_batch}")
        val_steps = val_table.num_records // global_batch
        if val_steps < 1:
            raise ValueError(
                f"{val_table.num_records} val sequences < global batch "
                f"{global_batch} — the eval pass needs at least one full "
                f"batch")
        rank, world = process_topology()
        host_batch = cfg.batch_size
        shard_kw = dict(cur_shard=rank, shard_count=world,
                        prefetch_to=self.device)

        def make_providers(start_epoch, plan, chained):
            train_iter = iter(ShardedLoader(
                train_table, batch_size=host_batch, num_epochs=None,
                shuffle=True, seed=cfg.seed + 1,
                skip_records=start_epoch * steps_per_epoch * host_batch,
                super_batch=plan if chained else None, **shard_kw))

            def train_batches(epoch):
                for _ in range(len(plan)):  # one item per chain
                    yield next(train_iter)

            def val_batches():
                # a fresh unshuffled pass: every eval sees the same batches
                it = iter(ShardedLoader(val_table, batch_size=host_batch,
                                        num_epochs=1, shuffle=False,
                                        **shard_kw))
                try:
                    for _ in range(val_steps):
                        yield next(it)
                finally:
                    it.close()

            return train_batches, val_batches, train_iter.close

        return self._run(steps_per_epoch, val_steps, global_batch,
                         make_providers, resume)

    # ------------------------------------------------------------------
    def _run(self, steps_per_epoch, val_steps, global_batch, make_providers,
             resume) -> LMTrainResult:
        cfg = self.train_cfg
        world = self.world_size
        tx = make_optimizer(cfg)
        if cfg.ema_decay:
            tx = with_param_ema(tx, cfg.ema_decay)
        plan = chain_plan(steps_per_epoch, cfg.steps_per_dispatch)
        chained = cfg.steps_per_dispatch > 1 and any(k > 1 for k in plan)
        state = init_lm_state(self.model, tx,
                              torch.Generator().manual_seed(cfg.seed),
                              self.device)
        step = make_lm_train_step(self.model, tx, cfg.grad_accum_steps)
        chain = (make_lm_train_chain(self.model, tx, cfg.grad_accum_steps)
                 if chained else None)
        eval_step = make_lm_eval_step(self.model)

        ckpt = (CheckpointManager(cfg.checkpoint_dir,
                                  async_write=cfg.async_checkpoint,
                                  max_inflight=cfg.async_checkpoint_inflight)
                if cfg.checkpoint_dir else None)
        start_epoch = 0
        restored_meta = None
        if ckpt and resume:
            state, at_step = ckpt.restore(state)
            if at_step is not None:
                start_epoch = int(at_step) // steps_per_epoch
                restored_meta = ckpt.read_metadata(at_step)

        if ckpt and resume and start_epoch > 0 and start_epoch >= cfg.epochs:
            # the checkpoint already covers every requested epoch: return
            # its own last metrics rather than a NaN result
            saved = (restored_meta or {}).get("metrics")
            ckpt.close()
            if saved is None:
                raise ValueError(
                    f"resume=True restored a checkpoint at epoch "
                    f"{start_epoch} >= cfg.epochs={cfg.epochs}, and it "
                    f"predates metric metadata; raise cfg.epochs above "
                    f"{start_epoch} to continue training, or retrain")
            warnings.warn(
                f"resume=True restored a checkpoint at epoch {start_epoch} "
                f">= cfg.epochs={cfg.epochs}; the run is already complete — "
                f"returning the checkpointed metrics, no training performed")
            return LMTrainResult(val_loss=saved["val_loss"],
                                 val_accuracy=saved["val_accuracy"],
                                 history=[saved], state=state,
                                 epochs_run=start_epoch)

        best = None
        if cfg.checkpoint_keep_best:
            if not ckpt:
                raise ValueError("checkpoint_keep_best needs a "
                                 "checkpoint_dir")
            best = BestCheckpointKeeper(
                cfg.checkpoint_dir,
                lambda d: CheckpointManager(d, keep=1,
                                            async_write=cfg.async_checkpoint))

        sched = ScheduleSuite.build(cfg, world, restored_meta)
        if self.run is not None:
            self.run.log_params({f"train.{k}": v
                                 for k, v in to_dict(cfg).items()})
            self.run.log_params({f"lm.{k}": v
                                 for k, v in to_dict(self.lm_cfg).items()})
            self.run.log_params({"world_size": world,
                                 "steps_per_epoch": steps_per_epoch,
                                 "global_batch": global_batch})

        train_batches, val_batches, close = make_providers(start_epoch, plan,
                                                           chained)
        history: list[dict[str, float]] = []
        epochs_run = start_epoch
        resumed = ckpt is not None and resume and start_epoch > 0
        state = sched.initial_state(state, start_epoch, resumed)
        dropout_seed = cfg.seed + 1
        # a Run wrapped by obs.telemetry.tee_run exposes its hub
        hub = (getattr(self.run, "telemetry_hub", None)
               if self.run is not None else None)
        host_step = int(state.step)
        monitor = profile = None
        if (cfg.monitor_interval_s > 0 and self.run is not None
                and process_topology()[0] == 0):
            from ddw_tpu_torch.utils.sysmon import SystemMonitor

            monitor = SystemMonitor(self.run, cfg.monitor_interval_s,
                                    device=self.device).start()
        try:
            for epoch in range(start_epoch, cfg.epochs):
                if (cfg.trace_dir and epoch == start_epoch
                        and process_topology()[0] == 0):
                    profile = EpochProfile(cfg.trace_dir, self.device, epoch)
                    if self.run is not None:
                        self.run.log_params(
                            {"trace_dir": profile.trace_dir})
                t0 = time.time()
                tlosses, taccs = [], []
                batch_it = train_batches(epoch)
                step_i = 0
                seq_len = 0
                for k_chain in plan:
                    t_chain = (time.monotonic()
                               if self.tracer is not None or hub is not None
                               else 0.0)
                    inputs, targets = next(batch_it)
                    seq_len = inputs.shape[-1]
                    lr = sched.lr_for_batch(epoch, step_i, steps_per_epoch)
                    if lr is not None:
                        state = set_lr(state, lr)
                    if chained:
                        m = chain(state, inputs, targets, dropout_seed)
                    else:
                        m = step(state, inputs, targets, dropout_seed)
                    if self.tracer is not None:
                        # chain-boundary span: the host-side dispatch window
                        self.tracer.record_span(
                            "train_chain", "train", t_chain,
                            time.monotonic(), tid="train",
                            args={"epoch": epoch, "step": host_step,
                                  "k": k_chain, "chained": bool(chained)})
                    if hub is not None:
                        hub.observe("train.chain_ms",
                                    (time.monotonic() - t_chain) * 1e3)
                    host_step += k_chain
                    step_i += k_chain
                    tlosses.append(m["loss"])
                    taccs.append(m["accuracy"])
                train_loss = fetch_metrics_mean(tlosses)  # one fetch
                train_acc = fetch_metrics_mean(taccs)
                epoch_s = time.time() - t0
                if profile is not None:
                    done, profile = profile, None   # stop() ends it either way
                    done.stop()

                eval_params = ema_params(state) if cfg.ema_decay else None
                vlosses, vaccs = [], []
                for vin, vtg in val_batches():
                    vm = eval_step(state, vin, vtg, eval_params)
                    vlosses.append(vm["loss"])
                    vaccs.append(vm["accuracy"])
                row = {
                    "epoch": epoch, "loss": train_loss,
                    "accuracy": train_acc,
                    "val_loss": fetch_metrics_mean(vlosses),
                    "val_accuracy": fetch_metrics_mean(vaccs),
                    "lr": get_lr(state), "epoch_seconds": epoch_s,
                    "tokens_per_sec": (steps_per_epoch * global_batch
                                       * seq_len / epoch_s),
                }
                history.append(row)
                epochs_run = epoch + 1
                if self.run is not None:
                    self.run.log_metrics(
                        {k: v for k, v in row.items() if k != "epoch"},
                        step=epoch)

                # callbacks first, then the checkpoint of the post-callback
                # counters and LR: resume = continuation
                state, stop = sched.epoch_end(state, row["val_loss"], epoch)
                if ckpt and (epoch + 1) % cfg.checkpoint_every_epochs == 0:
                    t_ck = time.monotonic()
                    ckpt.save(state, state.step,
                              metadata={"epoch": epoch,
                                        "callbacks": sched.state_dicts(),
                                        "metrics": row})
                    if hub is not None:
                        hub.observe("train.ckpt_write_ms",
                                    (time.monotonic() - t_ck) * 1e3)
                if best is not None:
                    best.maybe_save(state, state.step, row, {"epoch": epoch})
                if stop:
                    break
        finally:
            try:
                if profile is not None:
                    profile.close()
            finally:
                if monitor is not None:
                    monitor.stop()
            if close is not None:
                close()
            if ckpt is not None:
                ckpt.close()
            if best is not None:
                best.close()
        last = history[-1] if history else {"val_loss": float("nan"),
                                            "val_accuracy": float("nan")}
        return LMTrainResult(val_loss=last["val_loss"],
                             val_accuracy=last["val_accuracy"],
                             history=history, state=state,
                             epochs_run=epochs_run)
