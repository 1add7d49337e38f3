"""Trainer — the port of ``ddw_tpu.train.trainer`` (``model.fit`` plus the
reference's ``train_and_evaluate_hvd``).

The distributed data-parallel contract, one process per card:

1. process bootstrap      -> :func:`ddw_tpu_torch.runtime.dist.init_distributed`
                             (done by the caller or launcher);
2. tracking               -> a :class:`ddw_tpu_torch.tracking.tracker.Run`,
                             written by rank 0;
3. LR x world             -> ``TrainCfg.scale_lr_by_world``;
4. gradient averaging     -> ``all_reduce`` inside the step (train/step.py);
5. callback suite         -> :mod:`ddw_tpu_torch.train.schedule`;
6. shard-by-rank loading  -> a :class:`ShardedLoader` per rank, infinite repeat;
7. step accounting        -> ``train_size // (batch * world)`` steps per epoch,
                             floor-divided ``val_steps``;
8. checkpoint after the callbacks, keep-best, and ``resume=True`` continuing
   the loader stream with ``skip_records``;
9. ``model.pretrained_path``: the converted backbone artifact merged over
   the seeded init (:func:`ddw_tpu_torch.models.convert.load_pretrained`),
   and LoRA's leaf-level freezing for ``model.lora_rank`` (ViT).

"Worker" = one process = one card; the global batch is ``batch_size *
world``.

Observability, as in ``ddw_tpu``: ``TrainCfg.trace_dir`` profiles the
first epoch's training steps (``torch.profiler`` with CPU and, on the card,
CUDA activity — where ``ddw_tpu`` runs ``jax.profiler``) and writes a Chrome
trace JSON into that directory, logging the ``trace_dir`` param into the
run; a profile that recorded no CUDA kernel on the card is an error.
``TrainCfg.monitor_interval_s`` runs a
:class:`~ddw_tpu_torch.utils.sysmon.SystemMonitor` (process 0 only).
``tracer=`` (an :class:`~ddw_tpu_torch.obs.trace.Tracer`) records one
``train_chain`` span per chain boundary, and a run wrapped by
:func:`~ddw_tpu_torch.obs.telemetry.tee_run` receives ``train.chain_ms`` and
``train.ckpt_write_ms`` observations in its hub.

``TrainCfg.zero`` / ``TrainCfg.fsdp`` train through the sharded-state
steps of :mod:`ddw_tpu_torch.parallel.zero` over a ``data`` mesh of the
world, and checkpoint in the sharded format (every rank writes its own
blocks, :mod:`ddw_tpu_torch.checkpoint.sharded`).

The gang runtime's hooks sit at every chain boundary, in ``ddw_tpu``'s
order: ``maybe_fault("step", ...)`` (:mod:`ddw_tpu_torch.runtime.faults`),
``maybe_elastic_restart`` (a survivor of an elastic gang leaves through
:class:`~ddw_tpu_torch.runtime.elastic.ElasticRestart` and its worker re-runs
the fit from the latest durable checkpoint), and on SIGTERM a mid-epoch
checkpoint with ``"preempted": True`` in its metadata, then
:class:`~ddw_tpu_torch.runtime.faults.Preempted`. The loaders partition the
table at the gang's current ``(rank, world)``
(:func:`~ddw_tpu_torch.runtime.dist.process_topology`), so after an elastic
shrink every record is still read once an epoch; the data-parallel world of
the step is the process group's.
"""

from __future__ import annotations

import dataclasses
import os
import time

import torch
from torch import nn

from ddw_tpu_torch.checkpoint.ckpt import (BestCheckpointKeeper,
                                           CheckpointManager)
from ddw_tpu_torch.data.loader import ShardedLoader
from ddw_tpu_torch.data.store import Table
from ddw_tpu_torch.models.convert import load_pretrained_module
from ddw_tpu_torch.models.lora import lora_optimizer
from ddw_tpu_torch.models.layers import init_params
from ddw_tpu_torch.models.registry import build_model
from ddw_tpu_torch.runtime.dist import group_topology, process_topology
from ddw_tpu_torch.runtime.elastic import maybe_elastic_restart
from ddw_tpu_torch.runtime.faults import (Preempted, maybe_fault,
                                          preemption_requested)
from ddw_tpu_torch.tracking.tracker import Run
from ddw_tpu_torch.train.schedule import ScheduleSuite
from ddw_tpu_torch.train.step import (TrainState, chain_plan, ema_params,
                                      fetch_metrics_mean, get_lr, init_state,
                                      make_eval_step, make_optimizer,
                                      make_train_chain, make_train_step,
                                      params_checksum, set_lr, with_param_ema)
from ddw_tpu_torch.utils.config import DataCfg, ModelCfg, TrainCfg, to_dict
from ddw_tpu_torch.utils.device import resolve_device


class EpochProfile:
    """``torch.profiler`` over one epoch's training steps — the port's
    ``jax.profiler.start_trace`` / ``stop_trace`` pair. CPU activity always,
    CUDA activity on the card. :meth:`stop` writes the Chrome trace JSON
    ``trace_<pid>_<epoch>.json`` into ``trace_dir`` and returns its path;
    on the card it raises when the profile holds no CUDA kernel (CUPTI
    missing would otherwise give a silently empty trace)."""

    def __init__(self, trace_dir: str, device: torch.device, epoch: int):
        self.trace_dir = os.path.abspath(trace_dir)
        self.device = device
        self.epoch = epoch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()

    def stop(self) -> str:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.stop()
        os.makedirs(self.trace_dir, exist_ok=True)
        path = os.path.join(self.trace_dir,
                            f"trace_{os.getpid()}_{self.epoch}.json")
        self._prof.export_chrome_trace(path)
        # the profiler's raw events: ``events()`` would first build the
        # Python event tree of the whole epoch (tens of seconds on the card)
        if self.device.type == "cuda" and not any(
                e.device_type() == torch.autograd.DeviceType.CUDA
                for e in self._prof.profiler.kineto_results.events()):
            raise RuntimeError(
                f"torch.profiler recorded no CUDA kernel over epoch "
                f"{self.epoch} (is CUPTI available?); trace at {path}")
        return path

    def close(self) -> None:
        """Close a dangling profile on the error path (no export)."""
        self._prof.stop()


@dataclasses.dataclass
class TrainResult:
    val_loss: float
    val_accuracy: float
    history: list[dict[str, float]]
    state: TrainState
    epochs_run: int


class Trainer:
    def __init__(self, data_cfg: DataCfg, model_cfg: ModelCfg,
                 train_cfg: TrainCfg, run: Run | None = None,
                 model: nn.Module | None = None, initial=None, on_epoch=None,
                 device=None, tracer=None):
        """``model`` overrides the registry module; ``initial=(state, tx)``
        supplies a built :class:`TrainState` and optimizer instead of a
        fresh seeded init. ``on_epoch(row)`` runs after each epoch's metrics
        and callbacks; returning True stops training. ``device`` is the card
        unless the caller asks for ``"cpu"``. ``tracer`` (an obs
        :class:`~ddw_tpu_torch.obs.trace.Tracer`) records chain-boundary
        spans."""
        self.tracer = tracer
        self.data_cfg = data_cfg
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.run = run
        self.device = resolve_device(device)
        self.model = model if model is not None else build_model(
            model_cfg, (data_cfg.img_height, data_cfg.img_width))
        self._initial = initial
        self._on_epoch = on_epoch

    @property
    def world_size(self) -> int:
        """Data-parallel workers: the processes of the group."""
        return group_topology()[1]

    def _init_state(self):
        cfg = self.train_cfg
        if self._initial is not None:
            state, tx = self._initial
            if cfg.ema_decay and ema_params(state) is None:
                raise ValueError(
                    "train.ema_decay is set but the provided initial "
                    "optimizer state carries no EMA shadow — build the tx "
                    "with ddw_tpu_torch.train.step.with_param_ema or drop "
                    "the flag")
            return state, tx
        # Seeded init, identical on every rank: the rank-0 weight broadcast.
        init_params(self.model, torch.Generator().manual_seed(cfg.seed))
        if self.model_cfg.pretrained_path:
            # transfer mode: the converted backbone artifact over the fresh
            # init; the head stays as drawn
            load_pretrained_module(self.model, self.model_cfg.pretrained_path)
        self.model.to(self.device)
        frozen = type(self.model).frozen_prefixes(
            getattr(self.model, "freeze_base", False))
        if getattr(self.model, "lora_rank", 0):
            # LoRA freezes the base at leaf granularity itself; stacking
            # freeze_base on it would freeze the adapters too
            if frozen:
                raise ValueError(
                    "freeze_base and lora_rank are mutually exclusive — "
                    "LoRA already freezes the base; set "
                    "model.freeze_base=false")
            tx = lora_optimizer(make_optimizer(cfg))
        else:
            tx = make_optimizer(cfg, frozen)
        if cfg.ema_decay:
            tx = with_param_ema(tx, cfg.ema_decay)
        return init_state(self.model, tx), tx

    def _loaders(self, train_table: Table, val_table: Table,
                 consumed_batches: int = 0, super_plan=None):
        # the gang's topology: under an elastic gang outside a process group
        # each rank reads its partition at its share of the batch, and
        # after a shrink the N-1 ranks re-partition the same shards
        rank, world = process_topology()
        size = (self.data_cfg.img_height, self.data_cfg.img_width)
        batch = self.train_cfg.batch_size * self.world_size // world
        train_loader = ShardedLoader(
            train_table, batch_size=batch, image_size=size, cur_shard=rank,
            shard_count=world, num_epochs=None, shuffle=True,
            seed=self.train_cfg.seed,
            shuffle_buffer=self.data_cfg.shuffle_buffer,
            workers=self.data_cfg.loader_workers,
            prefetch=self.data_cfg.prefetch, prefetch_to=self.device,
            skip_records=consumed_batches * batch, super_batch=super_plan)

        def val_loader():  # a fresh pass per epoch
            return ShardedLoader(
                val_table, batch_size=batch, image_size=size, cur_shard=rank,
                shard_count=world, num_epochs=None, shuffle=False,
                workers=self.data_cfg.loader_workers,
                prefetch=self.data_cfg.prefetch, prefetch_to=self.device)

        return train_loader, val_loader

    def _sharded_steps(self, state, tx):
        """The ZeRO-1 or FSDP step and chain over a ``data`` mesh of the
        world, the state placed on its shards; the eval step reads the
        gathered parameters (and the gathered EMA shadow)."""
        from ddw_tpu_torch.parallel import zero
        from ddw_tpu_torch.runtime.mesh import make_data_mesh

        cfg = self.train_cfg
        mesh = make_data_mesh()
        kind = "fsdp" if cfg.fsdp else "zero"
        step = getattr(zero, f"make_{kind}_train_step")(
            self.model, tx, mesh, mesh.axis_names[0], cfg.grad_accum_steps)
        chain = (getattr(zero, f"make_{kind}_train_chain")(
            self.model, tx, mesh, mesh.axis_names[0], cfg.grad_accum_steps)
            if cfg.steps_per_dispatch > 1 else None)
        step.place_state(state)
        plain_eval = make_eval_step()

        def eval_step(st, images, labels, params=None):
            with zero.gathered(st):
                if params is not None:
                    params = st.layout.compute_tree(params)
                return plain_eval(st, images, labels, params)

        return step, chain, eval_step

    def fit(self, train_table: Table, val_table: Table,
            resume: bool = False) -> TrainResult:
        cfg = self.train_cfg
        world = self.world_size
        if cfg.num_devices not in (0, world):
            raise ValueError(f"train.num_devices={cfg.num_devices} but the "
                             f"process group has {world} workers (one card "
                             f"each); launch that many processes")
        if cfg.steps_per_dispatch < 1:
            raise ValueError(f"train.steps_per_dispatch must be >= 1, got "
                             f"{cfg.steps_per_dispatch}")
        sharded = cfg.zero or cfg.fsdp
        if cfg.zero and cfg.fsdp:
            raise ValueError("train.zero and train.fsdp are mutually "
                             "exclusive (fsdp already shards the "
                             "optimizer state) — pick one")
        state, tx = self._init_state()
        if sharded:
            train_step, train_chain, eval_step = self._sharded_steps(state,
                                                                     tx)
        else:
            train_step = make_train_step(tx, cfg.grad_accum_steps)
            train_chain = (make_train_chain(tx, cfg.grad_accum_steps)
                           if cfg.steps_per_dispatch > 1 else None)
            eval_step = make_eval_step()

        def checkpointer(d: str, keep: int = 3):
            if sharded:
                from ddw_tpu_torch.checkpoint.sharded import \
                    ShardedCheckpointManager

                return ShardedCheckpointManager(
                    d, keep, async_write=cfg.async_checkpoint,
                    max_inflight=cfg.async_checkpoint_inflight,
                    clip=bool(cfg.grad_clip_norm))
            return CheckpointManager(
                d, keep, async_write=cfg.async_checkpoint,
                max_inflight=cfg.async_checkpoint_inflight)

        ckpt = checkpointer(cfg.checkpoint_dir) if cfg.checkpoint_dir else None
        start_epoch = 0
        steps_per_epoch = max(1, train_table.num_records
                              // (cfg.batch_size * world))
        val_steps = max(1, val_table.num_records // (cfg.batch_size * world))
        restored_meta = None
        if ckpt and resume:
            state, at_step = ckpt.restore(state)
            if at_step is not None:
                start_epoch = int(at_step) // steps_per_epoch
                restored_meta = ckpt.read_metadata(at_step)

        best = None
        if cfg.checkpoint_keep_best:
            if not ckpt:
                raise ValueError("checkpoint_keep_best needs a checkpoint_dir")
            best = BestCheckpointKeeper(
                cfg.checkpoint_dir, lambda d: checkpointer(d, keep=1))

        sched = ScheduleSuite.build(cfg, world, restored_meta)
        if self.run is not None:
            self.run.log_params({f"train.{k}": v
                                 for k, v in to_dict(cfg).items()})
            self.run.log_params({f"model.{k}": v
                                 for k, v in to_dict(self.model_cfg).items()})
            self.run.log_params({"world_size": world,
                                 "steps_per_epoch": steps_per_epoch,
                                 "global_batch": cfg.batch_size * world})

        monitor = None
        if (cfg.monitor_interval_s > 0 and self.run is not None
                and process_topology()[0] == 0):
            # sys.* utilization series next to the training curves
            from ddw_tpu_torch.utils.sysmon import SystemMonitor

            monitor = SystemMonitor(self.run, cfg.monitor_interval_s,
                                    device=self.device)
        plan = chain_plan(steps_per_epoch, cfg.steps_per_dispatch)
        chained = train_chain is not None and any(k > 1 for k in plan)
        train_loader, val_loader = self._loaders(
            train_table, val_table,
            consumed_batches=start_epoch * steps_per_epoch,
            super_plan=plan if chained else None)
        train_iter = iter(train_loader)
        dropout_seed = cfg.seed + 1

        history: list[dict[str, float]] = []
        val_loss = val_acc = float("nan")
        epochs_run = 0
        profile = None
        # a Run wrapped by obs.telemetry.tee_run exposes its hub: chain
        # dispatch and checkpoint-write latencies become dist series
        hub = (getattr(self.run, "telemetry_hub", None)
               if self.run is not None else None)
        resumed = ckpt is not None and resume and start_epoch > 0
        state = sched.initial_state(state, start_epoch, resumed)
        if monitor is not None:
            monitor.start()
        try:
            for epoch in range(start_epoch, cfg.epochs):
                if (cfg.trace_dir and epoch == start_epoch
                        and process_topology()[0] == 0):
                    profile = EpochProfile(cfg.trace_dir, self.device, epoch)
                    if self.run is not None:
                        # the report links this param as the run's
                        # profiler-trace artifact
                        self.run.log_params(
                            {"trace_dir": profile.trace_dir})
                t0 = time.time()
                losses, accs = [], []
                step_i = 0
                for k_chain in plan:
                    t_chain = (time.monotonic()
                               if self.tracer is not None or hub is not None
                               else 0.0)
                    # fault injection: a no-op unless DDW_FAULT targets this
                    # rank, step and generation (chain boundaries when
                    # chained, as every hook here)
                    at = epoch * steps_per_epoch + step_i
                    maybe_fault("step", step=at,
                                ckpt_dir=cfg.checkpoint_dir or None)
                    # elastic park point (a no-op outside an elastic gang):
                    # a peer died and the gang re-formed — leave here; the
                    # worker re-runs fit(resume=True) in this process
                    maybe_elastic_restart(step=at)
                    if preemption_requested():
                        # SIGTERM: checkpoint the live state mid-epoch and
                        # leave; the worker exits EXIT_PREEMPTED and the
                        # supervisor restarts outside the crash budget (the
                        # finally below joins the async writer)
                        if ckpt:
                            ckpt.save(state, state.step,
                                      metadata={"epoch": epoch,
                                                "preempted": True,
                                                "callbacks":
                                                    sched.state_dicts()})
                        raise Preempted(int(state.step))
                    # per-batch LR: cosine, or the warmup ramp; None past
                    # warmup in the plateau regime (chain boundaries when
                    # chained)
                    lr_b = sched.lr_for_batch(epoch, step_i, steps_per_epoch)
                    if lr_b is not None:
                        state = set_lr(state, lr_b)
                    images, labels = next(train_iter)
                    if chained:
                        metrics = train_chain(state, images, labels,
                                              dropout_seed)
                    else:
                        metrics = train_step(state, images, labels,
                                             dropout_seed)
                    losses.append(metrics["loss"])
                    accs.append(metrics["accuracy"])
                    if self.tracer is not None:
                        # one span per chain BOUNDARY (the host-side
                        # dispatch window; device time for the chain lives
                        # in the profiler trace)
                        self.tracer.record_span(
                            "train_chain", "train", t_chain,
                            time.monotonic(), tid="train",
                            args={"epoch": epoch, "step": step_i,
                                  "k": k_chain, "chained": bool(chained)})
                    if hub is not None:
                        hub.observe("train.chain_ms",
                                    (time.monotonic() - t_chain) * 1e3)
                    step_i += k_chain
                # one fetch for the whole epoch
                train_loss = fetch_metrics_mean(losses)
                train_acc = fetch_metrics_mean(accs)
                epoch_s = time.time() - t0
                if profile is not None:
                    done, profile = profile, None   # stop() ends it either way
                    done.stop()

                vlosses, vaccs = [], []
                viter = iter(val_loader())
                eval_params = ema_params(state) if cfg.ema_decay else None
                try:
                    for _ in range(val_steps):
                        images, labels = next(viter)
                        m = eval_step(state, images, labels, eval_params)
                        vlosses.append(m["loss"])
                        vaccs.append(m["accuracy"])
                finally:
                    viter.close()
                val_loss = fetch_metrics_mean(vlosses)
                val_acc = fetch_metrics_mean(vaccs)

                row = {
                    "epoch": epoch, "loss": train_loss,
                    "accuracy": train_acc, "val_loss": val_loss,
                    "val_accuracy": val_acc, "lr": get_lr(state),
                    "epoch_seconds": epoch_s,
                    "images_per_sec": (steps_per_epoch * cfg.batch_size
                                       * world / epoch_s),
                }
                history.append(row)
                epochs_run = epoch + 1
                if self.run is not None:
                    self.run.log_metrics(
                        {k: v for k, v in row.items() if k != "epoch"},
                        step=epoch)
                if cfg.debug_cross_host_checks and self.run is not None:
                    # equal across ranks iff params are in lockstep
                    self.run.log_metric("params_checksum",
                                        params_checksum(state), epoch)

                # plateau / early stop on world-consistent metrics
                state, stop = sched.epoch_end(state, val_loss, epoch)
                if self._on_epoch is not None and self._on_epoch(row):
                    stop = True
                # checkpoint AFTER the callbacks: resume = continuation
                if ckpt and (epoch + 1) % cfg.checkpoint_every_epochs == 0:
                    t_ck = time.monotonic()
                    ckpt.save(state, state.step,
                              metadata={"epoch": epoch, "val_loss": val_loss,
                                        "val_accuracy": val_acc,
                                        "callbacks": sched.state_dicts()})
                    if hub is not None:
                        hub.observe("train.ckpt_write_ms",
                                    (time.monotonic() - t_ck) * 1e3)
                if best is not None:
                    best.maybe_save(state, state.step, row, {"epoch": epoch})
                if stop:
                    break
        finally:
            # always runs, the abort path too: a dangling profile is
            # closed, the loader and the async checkpoint writer joined
            try:
                if profile is not None:
                    profile.close()
            finally:
                train_iter.close()
                if monitor is not None:
                    monitor.stop()
            if ckpt is not None:
                ckpt.close()
            if best is not None:
                best.close()
        return TrainResult(val_loss, val_acc, history, state, epochs_run)
