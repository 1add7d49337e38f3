"""The drivers: one per kind of traffic mix, over the program's own entry
points. The model is the configuration's: its ``family`` names the module
in ``families/`` that builds the port's model and knows its leaves, its
seeded weights, its plain reference and its FLOPs.

- ``image_train``: an image model with ``train.step.make_optimizer`` /
  ``init_state`` / ``make_train_step`` as ``Trainer.fit`` builds them, fed
  by a ``data.loader.ShardedLoader`` (``prefetch_to`` the card) over a
  seeded ``raw_u8`` table;
- ``lm_train``: a language model with ``train.lm_step.make_lm_train_step``
  and Adam, fed by a ``ShardedLoader`` over a seeded ``tokens_i32`` table;
- ``lm_serve``: a ``serve.engine.ServingEngine`` over an
  ``LMEngineHandle``, driven by the mix's closed loop of clients.

Each driver builds the program and fills its weights from the seed
(``setup``), runs the measured window (``window``), frees the program
(``release``) and holds what the window produced against the plain
reference (``check``). A training driver's set-up drives the same state
through its first steps with the window's own step call and loader, and
keeps what the reference needs to follow them: the rows fed, the losses,
the first gradient's norms (from Adam's first moment after one step) and
the parameters' change after the last.
"""

from __future__ import annotations

import contextlib
import gc
import statistics
import time

import numpy as np
import torch

from benchmark.lib import traffic, weights
from benchmark.reference.precision import BF16, FLOAT32, FP8

# a leaf whose reference gradient is below this share of the median leaf's
# moves under Adam by round-off alone: its change is not compared
NEGLIGIBLE_GRAD = 1e-3


class RunRecord:
    """What one run measured, for the metric readers."""

    def __init__(self, bench):
        self.bench = bench
        self.e2e: dict[str, float] = {}
        self.window_s = 0.0
        self.untraced_s = 0.0
        self.work_flops = 0.0
        self.loader_wait_s: list[float] | None = None
        self.ticks_untraced: int | None = None
        self.queue_ms: list[float] | None = None
        self.trace = None
        self.op_bound_s: dict[str, float] = {}
        self.launches: dict | None = None
        self.attempted = self.failed = 0


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _span(name: str):
    from torch.profiler import record_function

    return record_function(name)


def _launch_counts() -> dict:
    from ddw_tpu_torch.ops import depthwise_conv as dw
    from ddw_tpu_torch.ops import flash_attention as fa

    return {"k1": dict(dw.depthwise_conv3x3_cuda.launches_by_variant),
            "k2": dict(dw.depthwise_conv3x3_wgrad_cuda.launches_by_variant),
            "k3": dict(fa.flash_attention_cuda.launches_by_variant),
            "k4": dict(fa.flash_attention_dq_cuda.launches_by_variant),
            "k5": dict(fa.flash_attention_dkv_cuda.launches_by_variant)}


def _launch_delta(a: dict, b: dict) -> dict:
    return {k: {v: b[k][v] - a[k][v] for v in b[k] if b[k][v] - a[k][v]}
            for k in b if any(b[k][v] - a[k][v] for v in b[k])}


def _check_specs(module: torch.nn.Module, specs: list, buffers: bool) -> dict:
    """The program's leaves by name, after holding their names and shapes
    to the reference's list."""
    leaves = dict(module.named_parameters())
    if buffers:
        leaves.update(module.named_buffers())
    have = {n: tuple(t.shape) for n, t in leaves.items()}
    want = {n: tuple(s) for n, s in specs}
    if have != want:
        diff = sorted(set(have.items()) ^ set(want.items()))[:8]
        raise RuntimeError(f"the program's leaves differ from the "
                           f"reference's: {diff}")
    return leaves


def leaf_gap(prog: dict, ref: dict, names) -> tuple[float, str, float]:
    """Each leaf's gap between the two norms, over the larger of the
    reference's norm of that leaf and of the median leaf: the worst leaf's
    gap, that leaf, and the median leaf's gap."""
    names = list(names)
    med = statistics.median(ref[n] for n in names)
    gaps = {n: abs(prog[n] - ref[n]) / max(ref[n], med) for n in names}
    worst = max(names, key=gaps.get)
    return gaps[worst], worst, statistics.median(gaps.values())


def train_numbers(prog: dict, ref: dict, groups: dict | None = None) -> dict:
    """The numbers a training cell compares: each step's loss, the first
    gradient and the change after the checked steps, by the worst leaf;
    and for each group of leaves in ``groups`` (name -> leaf names)
    ``grad_gap_<group>``, the first gradient's gap by the worst leaf of
    that group alone."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                  ref["losses"]))
    names = sorted(ref["grad_norms"])
    grad, g_leaf, g_med = leaf_gap(prog["grad_norms"], ref["grad_norms"],
                                   names)
    med = statistics.median(ref["grad_norms"][n] for n in names)
    moved = [n for n in names if ref["grad_norms"][n] >= NEGLIGIBLE_GRAD * med]
    change, c_leaf, c_med = leaf_gap(prog["change_norms"],
                                     ref["change_norms"], moved)
    first = abs(prog["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    gq = sorted(abs(prog["grad_norms"][n] - ref["grad_norms"][n])
                / max(ref["grad_norms"][n], med) for n in names)
    top = sorted(names, key=lambda n: -abs(prog["grad_norms"][n]
                                          - ref["grad_norms"][n]))[:6]
    out = {f"grad_gap_{g}": leaf_gap(prog["grad_norms"], ref["grad_norms"],
                                      members)[0]
           for g, members in (groups or {}).items()}
    return {"loss_gap": loss, "first_loss_gap": first, "grad_gap": grad,
            "grad_gap_median": g_med, "change_gap": change,
            "change_gap_median": c_med, **out,
            "_where": {"grad_gap": g_leaf, "change_gap": c_leaf,
                       "grad_median": med,
                       "grad_gap_q": [gq[int(q * (len(gq) - 1))]
                                      for q in (0.5, 0.75, 0.9, 1.0)],
                       "grad_top": [[n, prog["grad_norms"][n],
                                     ref["grad_norms"][n]] for n in top],
                       "losses": [prog["losses"], ref["losses"]],
                       "not_compared": len(set(names) - set(moved))}}


class _TrainDriver:
    rate_name = ""

    def __init__(self, bench, cfg: dict, mix: dict, seed: int, device,
                 tmpdir: str, hooks: dict | None = None):
        self.bench, self.cfg, self.mix = bench, cfg, mix
        self.fam = bench.family(cfg["family"])
        self.seed, self.device, self.tmpdir = seed, torch.device(device), tmpdir
        self.hooks = hooks or {}
        self.rec = RunRecord(bench)

    # -- the program -------------------------------------------------------
    def step_call(self, x, y):
        fn = self.hooks.get("step")
        if fn is not None:
            return fn(self, x, y)
        return self.step(self.state, x, y, self.seed)

    def build_model(self):
        """The port's model with its weights drawn from the seed, and the
        optimizer's transform over its trainable leaves."""
        from ddw_tpu_torch.train.step import make_optimizer
        from ddw_tpu_torch.utils.config import TrainCfg

        self.model = self.fam.build(self.cfg, self.mix, self.device)
        params, buffers = self.fam.specs(self.cfg)
        self.specs = params + buffers
        leaves = _check_specs(self.model, self.specs, buffers=bool(buffers))
        weights.draw(self.specs, self.fam.init, self.seed, self.device,
                     into=leaves)
        return make_optimizer(
            TrainCfg(optimizer="adam", learning_rate=self.mix["learning_rate"]),
            type(self.model).frozen_prefixes(
                bool(self.mix.get("freeze_base", False))))

    def setup(self) -> None:
        self.build()
        self.it = iter(self.loader)
        self.fed, losses = [], []
        for i in range(self.mix["checked_steps"]):
            x, y = next(self.it)
            self.fed.append(self.rows_of(x, y))
            losses.append(self.step_call(x, y)["loss"])
            if i == 0:
                mu = self.state.opt_state["mu"]
                norms = torch.stack([t.float().norm() for t in mu.values()])
                self.first_grad = dict(zip(mu, (norms / (1.0 - 0.9)).tolist()))
        self.change = self._change_norms()
        self.losses = [float(l) for l in losses]
        _sync(self.device)

    @torch.no_grad()
    def _change_norms(self) -> dict:
        p0 = weights.draw(self.specs, self.fam.init, self.seed, self.device)
        params = dict(self.state.model.named_parameters())
        names = list(self.first_grad)
        norms = torch.stack([(params[n] - p0[n]).float().norm() for n in names])
        return dict(zip(names, norms.tolist()))

    def window(self, seconds: float, tw) -> RunRecord:
        rec, mix = self.rec, self.mix
        waits, steps, traced = [], 0, 0
        t_tr = 0.0
        t0 = time.perf_counter()
        while True:
            if tw is not None and steps == mix["trace_after_steps"] \
                    and tw.state == "idle":
                before = _launch_counts()
                ta = time.perf_counter()
                tw.start()
            tl = time.perf_counter()
            with _span("loader_next"):
                x, y = next(self.it)
            waits.append(time.perf_counter() - tl)
            with _span("train_step"):
                self.step_call(x, y)
            steps += 1
            if tw is not None and tw.state == "on":
                traced += 1
                if traced == mix["trace_steps"]:
                    tw.stop()
                    t_tr = time.perf_counter() - ta
                    rec.launches = _launch_delta(before, _launch_counts())
            done = tw is None or traced >= mix["trace_steps"]
            if done and time.perf_counter() - t0 >= seconds:
                break
        _sync(self.device)
        rec.window_s = time.perf_counter() - t0
        rec.untraced_s = rec.window_s - t_tr
        rec.work_flops = (steps - traced) * self.fam.step_flops(self.cfg, mix)
        rec.loader_wait_s = waits
        rec.attempted = steps
        rec.e2e[self.rate_name] = steps * self.work_per_step() / rec.window_s
        if traced:
            rec.op_bound_s = {op: traced * s for op, s in
                              self.fam.op_bounds(self.cfg, mix).items()}
        return rec

    def release(self) -> None:
        self.it.close()
        del self.it, self.loader, self.state, self.step, self.model
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, p0: dict, batches: list, prec) -> dict:
        return self.fam.reference(self.cfg, self.mix, p0, batches, self.seed,
                                  prec)

    def check(self, extra: tuple = ()) -> dict:
        prog = {"losses": self.losses, "grad_norms": self.first_grad,
                "change_norms": self.change}
        with _no_tf32():
            p0 = weights.draw(self.specs, self.fam.init, self.seed,
                              self.device)
            batches, unmatched = self.reference_batches()
            ref = self.reference(p0, batches, FLOAT32)
            groups = self.fam.leaf_groups(self.cfg, self.mix)
            out = train_numbers(prog, ref, groups)
            out["rows_unmatched"] = unmatched
            if "control" in extra:
                out["_control"] = train_numbers(
                    self.reference(p0, batches, FP8), ref, groups)
            if "witness" in extra:
                out["_bf16_reference"] = train_numbers(
                    self.reference(p0, batches, BF16), ref, groups)
            if "half_batch" in extra:
                half = [tuple(t[:t.shape[0] // 2] for t in b) for b in batches]
                out["_half_batch"] = train_numbers(
                    self.reference(p0, half, FLOAT32), ref, groups)
        return out


class ImageTrain(_TrainDriver):
    rate_name = "train_images_per_s"

    def build(self) -> None:
        from ddw_tpu_torch.data.loader import ShardedLoader
        from ddw_tpu_torch.train.step import init_state, make_train_step

        cfg, mix = self.cfg, self.mix
        size = cfg["image_size"]
        tx = self.build_model()
        self.state = init_state(self.model, tx)
        self.step = make_train_step(tx)
        self.table, self.images, self.labels = traffic.image_table(
            self.tmpdir, mix["images"], size, cfg["num_classes"], self.seed,
            self.device)
        self.index = {traffic.row_key(im): i for i, im in enumerate(self.images)}
        self.loader = ShardedLoader(
            self.table, batch_size=mix["batch"], image_size=(size, size),
            shuffle=True, seed=self.seed, workers=mix["loader_workers"],
            prefetch=mix["prefetch"], prefetch_to=self.device)

    def rows_of(self, x, y):
        u8 = ((x + 1.0) * 127.5).round().clamp(0, 255).to(torch.uint8)
        return u8.cpu().numpy(), y.cpu().numpy()

    def work_per_step(self) -> int:
        return self.mix["batch"]

    def reference_batches(self):
        batches, unmatched = [], 0
        for u8, y in self.fed:
            idx = [self.index.get(traffic.row_key(r), -1) for r in u8]
            unmatched += sum(1 for i, lbl in zip(idx, y)
                             if i < 0 or self.labels[i] != lbl)
            rows = [max(i, 0) for i in idx]
            batches.append((torch.from_numpy(self.images[rows]).to(self.device),
                            torch.from_numpy(self.labels[rows]).to(self.device)))
        return batches, unmatched


class LMTrain(_TrainDriver):
    rate_name = "train_tokens_per_s"

    def build(self) -> None:
        from ddw_tpu_torch.data.loader import ShardedLoader
        from ddw_tpu_torch.train.lm_step import make_lm_train_step
        from ddw_tpu_torch.train.step import init_state

        cfg, mix = self.cfg, self.mix
        tx = self.build_model()
        self.state = init_state(self.model, tx)
        self.step = make_lm_train_step(self.model, tx)
        self.table, self.tokens = traffic.token_table(
            self.tmpdir, mix["table_rows"], mix["seq"], cfg["vocab_size"],
            self.seed)
        self.index = {traffic.row_key(r): i for i, r in enumerate(self.tokens)}
        self.loader = ShardedLoader(
            self.table, batch_size=mix["batch"], shuffle=True, seed=self.seed,
            workers=mix["loader_workers"], prefetch=mix["prefetch"],
            prefetch_to=self.device)

    def rows_of(self, x, y):
        return x.cpu().numpy(), y.cpu().numpy()

    def work_per_step(self) -> int:
        return self.mix["batch"] * self.mix["seq"]

    def reference_batches(self):
        batches, unmatched = [], 0
        for x, y in self.fed:
            rows = []
            for xr, yr in zip(x, y):
                i = self.index.get(traffic.row_key(
                    np.concatenate([xr, yr[-1:]])), -1)
                if i < 0 or not np.array_equal(self.tokens[i, 1:], yr):
                    unmatched += 1
                rows.append(max(i, 0))
            t = torch.from_numpy(self.tokens[rows]).to(self.device)
            batches.append((t[:, :-1], t[:, 1:]))
        return batches, unmatched


class LMServe:
    """The serving engine under the mix's clients."""

    def __init__(self, bench, cfg: dict, mix: dict, seed: int, device,
                 tmpdir: str, hooks: dict | None = None):
        self.bench, self.cfg, self.mix = bench, cfg, mix
        self.fam = bench.family(cfg["family"])
        self.seed, self.device = seed, torch.device(device)
        self.hooks = hooks or {}
        self.rec = RunRecord(bench)

    def setup(self) -> None:
        from ddw_tpu_torch.serve.engine import EngineCfg, ServingEngine
        from ddw_tpu_torch.serving.lm_package import LMEngineHandle

        cfg, mix = self.cfg, self.mix
        self.model = self.fam.build(cfg, mix, self.device)
        self.specs, _ = self.fam.specs(cfg)
        leaves = _check_specs(self.model, self.specs, buffers=False)
        weights.draw(self.specs, self.fam.init, self.seed, self.device,
                     into=leaves)
        self.model.eval().requires_grad_(False)
        self.engine = ServingEngine(
            lm=LMEngineHandle(model=self.model, cfg=self.fam.lm_cfg(cfg),
                              device=self.device),
            cfg=EngineCfg(n_slots=mix["n_slots"],
                          steps_per_tick=mix["steps_per_tick"]))
        if "engine" in self.hooks:
            self.hooks["engine"](self)
        self.reqs = traffic.Requests(mix, cfg["vocab_size"], self.seed)
        self.engine.warmup(sorted({len(p) for p in self.reqs.prompts}))
        _sync(self.device)
        self.engine.start()

        def submit(prompt, n_out, on_token):
            return self.engine.submit_generate(prompt, n_out,
                                               on_token=on_token, timeout_s=0)

        self.pool = traffic.ClientPool(mix, self.reqs, submit)
        self.pool.start()
        self.pool.run_until(time.perf_counter() + mix["ramp_s"], None)

    def _ticks(self) -> int:
        return int(self.engine.metrics.counters_view().get("decode_ticks", 0))

    def window(self, seconds: float, tw) -> RunRecord:
        rec, mix, pool = self.rec, self.mix, self.pool
        t_open, m_open = time.perf_counter(), time.monotonic()
        tok_open, ticks_open = pool.delivered, self._ticks()
        traced_ticks, tr = 0, (0.0, 0.0)
        if tw is not None:
            pool.run_until(t_open + mix["trace_after_s"], t_open)
            ticks_a, ta = self._ticks(), time.perf_counter()
            before = _launch_counts()
            tw.start()
            pool.run_until(time.perf_counter() + mix["trace_s"], t_open)
            tw.stop()
            tr = (ta, time.perf_counter())
            traced_ticks = self._ticks() - ticks_a
            rec.launches = _launch_delta(before, _launch_counts())
        pool.run_until(t_open + seconds, t_open)
        t_close, m_close = time.perf_counter(), time.monotonic()
        delivered = pool.delivered - tok_open
        ticks = self._ticks() - ticks_open
        pool.drain(mix["drain_s"])
        self.engine.stop()
        rec.window_s = t_close - t_open
        rec.untraced_s = rec.window_s - (tr[1] - tr[0])
        rec.ticks_untraced = ticks - traced_ticks
        mine = [r for r in pool.records if r.in_window]
        rec.attempted = len(mine)
        rec.failed = sum(1 for r in mine if r.failed)
        rec.e2e.update(traffic.serve_e2e(pool.records, delivered,
                                         rec.window_s))
        rec.queue_ms = [r.queue_ms for r in self.engine.metrics.records()
                        if m_open <= r.submitted < m_close]
        rec.work_flops = self._work_flops(t_open, t_close, tr)
        return rec

    def _work_flops(self, t_open, t_close, tr) -> float:
        """Model FLOPs of the prompts whose first token, and of the
        generated tokens, came in the window and outside the traced
        stretch."""
        def counted(t):
            return t_open <= t < t_close and not tr[0] <= t < tr[1]

        total = 0.0
        for r in self.pool.records:
            p = len(self.reqs.prompts[r.i])
            for j, t in enumerate(r.stamps):
                if counted(t):
                    total += (self.fam.prefill_flops(self.cfg, p) if j == 0
                              else self.fam.token_flops(self.cfg, p + j))
        return total

    def release(self) -> None:
        self.engine.close()
        del self.engine, self.model
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, extra: tuple = ()) -> dict:
        mine = [r for r in self.pool.records if r.in_window]
        good = [r for r in mine if not r.failed and not r.late
                and len(r.tokens) == r.n_out]
        out = {"unanswered": sum(1 for r in mine if r.failed or (
            not r.late and len(r.tokens) != r.n_out))}
        if not good:
            return out
        rng = np.random.default_rng(weights.sub_seed(self.seed, "sample"))
        longest = max(good, key=lambda r: len(self.reqs.prompts[r.i]) + r.n_out)
        rest = [r for r in good if r is not longest]
        k = min(self.mix["checked_requests"] - 1, len(rest))
        sample = [longest] + [rest[i] for i in
                              sorted(rng.choice(len(rest), k, replace=False))]
        gaps, ctl = [], []
        with _no_tf32():
            p = weights.draw(self.specs, self.fam.init, self.seed,
                             self.device)
            for r in sample:
                prompt = self.reqs.prompts[r.i]
                seq = np.concatenate([prompt, np.asarray(r.tokens[:-1], np.int32)])
                toks = torch.from_numpy(seq).to(self.device)
                pos = np.arange(len(prompt) - 1, len(seq))
                served = torch.as_tensor(r.tokens, device=self.device)
                ref = self.fam.logits_at(self.cfg, p, toks, pos)
                best = ref.max(dim=-1).values
                gaps.append(float((best - ref.gather(
                    1, served[:, None].long())[:, 0]).max()))
                if "control" in extra:
                    low = self.fam.logits_at(self.cfg, p, toks, pos, FP8)
                    pick = low.argmax(dim=-1, keepdim=True)
                    ctl.append(float((best - ref.gather(1, pick)[:, 0]).max()))
                del ref
        out["logit_gap"] = max(gaps)
        out["_where"] = {"checked_requests": len(sample),
                         "checked_tokens": sum(r.n_out for r in sample),
                         "late": sum(1 for r in mine if r.late),
                         "finished": len(good)}
        if ctl:
            out["_control"] = {"logit_gap": max(ctl)}
        return out


DRIVERS = {"image_train": ImageTrain, "lm_train": LMTrain,
           "lm_serve": LMServe}
