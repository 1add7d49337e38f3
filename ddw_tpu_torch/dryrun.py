"""Multi-rank dry run — the port's counterpart of
``__graft_entry__.dryrun_multichip``.

``dryrun_multichip(n, device)`` spawns ``n`` ranks joined by gloo
(:func:`ddw_tpu_torch.runtime.dist.spawn_cpu`; on the card every rank works
on ``cuda:0``, since NCCL refuses two ranks on one device) and runs one
training step of every parallelism strategy at ``ddw_tpu``'s dry-run sizes,
printing the same ``dryrun ... OK`` line per arm:

1. DP and DP + gradient accumulation (MobileNetV2, width 0.35, 32 px);
2. DP x TP and FSDP x TP (ViT over ``(data=n/2, model=2)``);
3. SP (ring attention over ``seq=n`` against full attention);
4. DP x SP (the LM over ``(data=2, seq=n/2)``), with learned positions and
   with RoPE + GQA;
5. LoRA (adapter-only fine-tune through the LM step);
6. ZeRO-1 with a sharded checkpoint round trip, and ZeRO-3/FSDP;
7. DP x PP, GPipe and interleaved (``(data=2, pipe=n/2)``);
8. EP (MoE LM, experts over ``data``);
9. a hybrid slice-major data mesh (two slices of ``n/2`` ranks).

Every rank draws the same global inputs from ``numpy.random.RandomState(0)``
in ``ddw_tpu``'s order and takes its own shard. Run it with ``python -m
ddw_tpu_torch.dryrun [n] [--device cuda|cpu]``.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch


def _arms(device: str, ckpt_dir: str | None) -> dict:
    """Every arm, in one rank. Returns the printed lines (rank 0) and the
    checksums of the ZeRO state the checkpoint arm wrote."""
    from ddw_tpu_torch.checkpoint.sharded import (restore_sharded,
                                                  save_sharded)
    from ddw_tpu_torch.models.layers import init_params
    from ddw_tpu_torch.models.lm import TransformerLM
    from ddw_tpu_torch.models.lora import is_lora_trainable
    from ddw_tpu_torch.models.registry import build_model
    from ddw_tpu_torch.ops.flash_attention import flash_mha
    from ddw_tpu_torch.parallel import zero
    from ddw_tpu_torch.parallel.pipeline import (init_pp_state,
                                                 make_pp_lm_train_step)
    from ddw_tpu_torch.parallel.ring_attention import ring_attention
    from ddw_tpu_torch.parallel.sharding import (VIT_TP_RULES,
                                                 make_sharded_train_step)
    from ddw_tpu_torch.runtime.mesh import (DATA_AXIS, MODEL_AXIS, SEQ_AXIS,
                                            MeshSpec, bind_mesh,
                                            make_hybrid_mesh, make_mesh,
                                            process_count, process_index)
    from ddw_tpu_torch.train.lm_step import init_lm_state, make_lm_train_step
    from ddw_tpu_torch.train.step import (init_state, make_eval_step,
                                          make_optimizer, make_train_step)
    from ddw_tpu_torch.utils.config import ModelCfg, TrainCfg

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    n = process_count()
    me = process_index()
    rng = np.random.RandomState(0)
    lines: list[str] = []
    say = lines.append

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def mine(a, mesh, axis=DATA_AXIS):
        per = a.shape[0] // mesh.shape[axis]
        d = mesh.axis_index(axis)
        return a[d * per:(d + 1) * per]

    def finite(x) -> float:
        v = float(x)
        assert np.isfinite(v), v
        return v

    # -- 1. DP --------------------------------------------------------------
    img = (32, 32, 3)
    per_worker_batch = 4
    model_cfg = ModelCfg(name="mobilenet_v2", num_classes=5, dropout=0.5,
                         freeze_base=True, allow_frozen_random=True,
                         dtype="float32", width_mult=0.35)
    train_cfg = TrainCfg(batch_size=per_worker_batch, optimizer="adam",
                         learning_rate=1e-3)
    mesh = make_mesh(MeshSpec(((DATA_AXIS, n),)))

    def mobilenet_state():
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            m = build_model(model_cfg, image_size=img[:2])
        init_params(m, torch.Generator().manual_seed(0))
        m.to(dev)
        tx = make_optimizer(train_cfg, type(m).frozen_prefixes(True))
        return init_state(m, tx), tx

    global_batch = per_worker_batch * n
    images = rng.rand(global_batch, *img).astype(np.float32)
    labels = rng.randint(0, 5, size=(global_batch,)).astype(np.int32)
    im, lb = t(mine(images, mesh)), t(mine(labels, mesh))
    state, tx = mobilenet_state()
    m = make_train_step(tx)(state, im, lb, 1)
    ev = make_eval_step()(state, im, lb)
    assert state.step == 1 and np.isfinite(float(ev["loss"]))
    say(f"dryrun DP    OK: mesh={mesh.shape} global_batch={global_batch} "
        f"loss={finite(m['loss']):.4f}")
    state, tx = mobilenet_state()
    m = make_train_step(tx, grad_accum_steps=2)(state, im, lb, 1)
    assert state.step == 1
    say(f"dryrun DP+accum OK: mesh={mesh.shape} microbatches=2 "
        f"loss={finite(m['loss']):.4f}")

    # -- 2. DP x TP and FSDP x TP: ViT -------------------------------------
    if n >= 2 and n % 2 == 0:
        dp = n // 2
        mesh2 = make_mesh(MeshSpec(((DATA_AXIS, dp), (MODEL_AXIS, 2))))
        vcfg = ModelCfg(name="vit", num_classes=5, dropout=0.0,
                        dtype="float32")

        def vit_state():
            v = build_model(vcfg, image_size=(32, 32))
            init_params(v, torch.Generator().manual_seed(0))
            v.to(dev)
            vtx = make_optimizer(TrainCfg(optimizer="adam",
                                          learning_rate=1e-3))
            return init_state(v, vtx), vtx

        vbatch = 4 * dp
        vimages = rng.rand(vbatch, 32, 32, 3).astype(np.float32)
        vlabels = rng.randint(0, 5, (vbatch,)).astype(np.int32)
        vim, vlb = t(mine(vimages, mesh2)), t(mine(vlabels, mesh2))
        vstate, vtx = vit_state()
        vstep = make_sharded_train_step(vstate.model, vtx, mesh2,
                                        VIT_TP_RULES)
        vm = vstep(vstate, vim, vlb, 2)
        fc1 = vstate.layout.compute["backbone_block0.mlp.fc1.kernel"]
        assert fc1 == (None, MODEL_AXIS), fc1
        say(f"dryrun DPxTP OK: mesh={mesh2.shape} "
            f"loss={finite(vm['loss']):.4f} fc1 sharding={fc1}")
        tstate, ttx = vit_state()
        tstep = zero.make_fsdp_tp_train_step(tstate.model, ttx, mesh2,
                                             VIT_TP_RULES)
        tm = tstep(tstate, vim, vlb, 2)
        fc1_2d = tstate.layout.rest["backbone_block0.mlp.fc1.kernel"]
        assert fc1_2d == (DATA_AXIS, MODEL_AXIS), fc1_2d
        say(f"dryrun FSDPxTP OK: mesh={mesh2.shape} "
            f"loss={finite(tm['loss']):.4f} fc1 tiled={fc1_2d}")

    # -- 3. SP: ring attention ---------------------------------------------
    mesh3 = make_mesh(MeshSpec(((SEQ_AXIS, n),)))
    b, h, s, d = 1, 2, 16 * n, 16
    q, k, v = (rng.randn(b, h, s, d).astype(np.float32) for _ in range(3))
    sl = slice(me * 16, (me + 1) * 16)
    with bind_mesh(mesh3):
        out = ring_attention(t(q[:, :, sl]), t(k[:, :, sl]), t(v[:, :, sl]),
                             SEQ_AXIS, causal=True)
    ref = flash_mha(t(q), t(k), t(v), causal=True, impl="xla")[:, :, sl]
    err = torch.tensor(float((out - ref).abs().max()))
    torch.distributed.all_reduce(err, op=torch.distributed.ReduceOp.MAX)
    assert float(err) < 1e-3, f"ring attention mismatch {float(err)}"
    say(f"dryrun SP    OK: mesh={mesh3.shape} seq={s} "
        f"ring-vs-full err={float(err):.2e}")

    def lm_step_arm(mesh_, lm, lr, seq_len, rows):
        ltx = make_optimizer(TrainCfg(optimizer="adam", learning_rate=lr))
        lstate = init_lm_state(lm, ltx, torch.Generator().manual_seed(0),
                               dev)
        toks = rng.randint(0, 64, (rows, seq_len + 1)).astype(np.int32)
        seq = lm.seq_axis
        step = make_lm_train_step(lm, ltx, seq_axis=seq, mesh=mesh_)
        x, y = mine(toks[:, :-1], mesh_), mine(toks[:, 1:], mesh_)
        if seq:
            per = seq_len // mesh_.shape[SEQ_AXIS]
            r = mesh_.axis_index(SEQ_AXIS)
            x, y = x[:, r * per:(r + 1) * per], y[:, r * per:(r + 1) * per]
        return lstate, step(lstate, t(x), t(y), 1)

    # -- 4. DP x SP: the LM, learned positions and RoPE + GQA ---------------
    if n >= 4 and n % 2 == 0:
        sp = n // 2
        mesh4 = make_mesh(MeshSpec(((DATA_AXIS, 2), (SEQ_AXIS, sp))))
        lm = TransformerLM(vocab_size=64, max_len=256, hidden=32, depth=2,
                           num_heads=2, mlp_dim=64, dtype=torch.float32,
                           seq_axis=SEQ_AXIS)
        lstate, lm_m = lm_step_arm(mesh4, lm, 1e-3, 8 * sp, 4)
        assert lstate.step == 1
        say(f"dryrun DPxSP(LM) OK: mesh={mesh4.shape} seq={8 * sp} "
            f"loss={finite(lm_m['loss']):.4f}")
        rlm = TransformerLM(vocab_size=64, max_len=256, hidden=32, depth=2,
                            num_heads=4, num_kv_heads=2, mlp_dim=64,
                            dtype=torch.float32, seq_axis=SEQ_AXIS,
                            pos_encoding="rope")
        rstate, rm = lm_step_arm(mesh4, rlm, 1e-3, 8 * sp, 4)
        assert not hasattr(rlm, "pos_embed")
        say(f"dryrun DPxSP(rope+GQA) OK: mesh={mesh4.shape} seq={8 * sp} "
            f"kv_heads=2 loss={finite(rm['loss']):.4f}")

    # -- 5. LoRA ------------------------------------------------------------
    lora_lm = TransformerLM(vocab_size=64, max_len=64, hidden=32, depth=1,
                            num_heads=2, mlp_dim=64, dtype=torch.float32,
                            lora_rank=2)
    before = {}
    lora_lm.register_forward_pre_hook(
        lambda mod, args: before or before.update(
            {nm: p.detach().clone() for nm, p in mod.named_parameters()}))
    lr_state, lr_m = lm_step_arm(mesh, lora_lm, 1e-2, 8, n)
    moved = {nm: bool((p.detach() != before[nm].to(p.device)).any())
             for nm, p in lora_lm.named_parameters()}
    trainable = {nm: is_lora_trainable(nm) for nm in moved}
    assert not any(mv and not trainable[nm] for nm, mv in moved.items())
    assert any(mv and trainable[nm] for nm, mv in moved.items())
    say(f"dryrun LoRA  OK: mesh={mesh.shape} rank=2 "
        f"trainable_leaves={sum(trainable.values())} base_frozen=True "
        f"loss={finite(lr_m['loss']):.4f}")

    # -- 6. ZeRO-1, its sharded checkpoint, FSDP ----------------------------
    zstate, ztx = mobilenet_state()
    zstep = zero.make_zero_train_step(zstate.model, ztx, mesh)
    zm = zstep(zstate, im, lb, 4)
    frac = zero.zero_fraction_sharded(zstate, mesh)
    assert frac > 0
    say(f"dryrun ZeRO-1 OK: mesh={mesh.shape} opt-state sharded={frac:.0%} "
        f"loss={finite(zm['loss']):.4f}")
    keep = ckpt_dir is not None
    zdir = ckpt_dir or tempfile.mkdtemp(prefix="ddw_zero_")
    if not keep:
        # one directory for the group: rank 0's
        box = [zdir]
        torch.distributed.broadcast_object_list(box, src=0)
        zdir = box[0]
    save_sharded(zdir, zstate, step=1)
    rest, _ = mobilenet_state()
    zstep.place_state(rest)
    rest, at = restore_sharded(zdir, rest)
    assert at == 1 and rest.step == zstate.step
    for a, b_ in zip(zstate.model.state_dict().values(),
                     rest.model.state_dict().values()):
        assert torch.equal(a, b_)
    for key in ("mu", "nu"):
        for nm, a in zstate.opt_state[key].items():
            assert torch.equal(a, rest.opt_state[key][nm])
    # what the checkpoint holds, whole: the moments gathered from the ranks
    checks = {"params": float(sum(p.detach().double().sum() for p in
                                  zstate.model.parameters())),
              "mu": {nm: float(a.double().sum()) for nm, a in
                     zstate.layout.compute_tree(
                         zstate.opt_state["mu"]).items()}}
    torch.distributed.barrier()
    if not keep and me == 0:
        import shutil

        shutil.rmtree(zdir, ignore_errors=True)
    say(f"dryrun ZeRO-ckpt OK: sharded save/restore round-trip on "
        f"{mesh.shape}")
    fstate, ftx = mobilenet_state()
    fstep = zero.make_fsdp_train_step(fstate.model, ftx, mesh)
    fm = fstep(fstate, im, lb, 4)
    pfrac = zero.fsdp_fraction_sharded(fstate, mesh)
    lay = fstate.layout
    assert lay.shards and all(
        sh.numel() * n == int(np.prod(lay.global_shapes[nm]))
        for nm, sh in lay.shards.items())
    say(f"dryrun FSDP  OK: mesh={mesh.shape} params sharded={pfrac:.0%} "
        f"(1/{n} residency) loss={finite(fm['loss']):.4f}")

    # -- 7. DP x PP, GPipe and interleaved ----------------------------------
    if n >= 4 and n % 2 == 0:
        pipe = n // 2
        mesh6 = make_mesh(MeshSpec(((DATA_AXIS, 2), ("pipe", pipe))))
        ptoks = rng.randint(0, 64, (8, 17)).astype(np.int32)
        px, py = t(mine(ptoks[:, :-1], mesh6)), t(mine(ptoks[:, 1:], mesh6))

        def pp_arm(depth, schedule, v):
            plm = TransformerLM(vocab_size=64, max_len=64, hidden=32,
                                depth=depth, num_heads=2, mlp_dim=64,
                                dtype=torch.float32)
            ptx = make_optimizer(TrainCfg(optimizer="adam",
                                          learning_rate=1e-3))
            pstate = init_pp_state(plm, ptx, mesh6,
                                   torch.Generator().manual_seed(0),
                                   virtual_stages=v, device=dev)
            pstep = make_pp_lm_train_step(plm, ptx, mesh6,
                                          data_axis=DATA_AXIS,
                                          num_microbatches=2,
                                          schedule=schedule,
                                          virtual_stages=v)
            return pstate, pstep(pstate, px, py)

        pstate, pm = pp_arm(pipe, "gpipe", 1)
        blocks = sorted(int(nm.split(".")[0][len("backbone_block"):])
                        for nm, _ in pstate.model.named_parameters()
                        if nm.startswith("backbone_block"))
        assert set(blocks) == {mesh6.axis_index("pipe")}
        say(f"dryrun DPxPP OK: mesh={mesh6.shape} stages={pipe} "
            f"loss={finite(pm['loss']):.4f} stage blocks={sorted(set(blocks))}")
        istate, imm = pp_arm(2 * pipe, "interleaved", 2)
        say(f"dryrun DPxPP-interleaved OK: v=2 "
            f"bubble={float(imm['pp_bubble_fraction']):.3f} "
            f"loss={finite(imm['loss']):.4f}")

    # -- 8. EP --------------------------------------------------------------
    moe_lm = TransformerLM(vocab_size=64, max_len=64, hidden=32, depth=2,
                           num_heads=2, mlp_dim=64, dtype=torch.float32,
                           num_experts=n, expert_axis=DATA_AXIS)
    estate, em = lm_step_arm(mesh, moe_lm, 1e-3, 16, 2 * n)
    say(f"dryrun EP    OK: mesh={mesh.shape} experts={n} "
        f"loss={finite(em['loss']):.4f} aux={finite(em['aux_loss']):.3f}")

    # -- 9. hybrid slice-major data mesh ------------------------------------
    if n >= 4 and n % 2 == 0:
        half = n // 2
        hmesh = make_hybrid_mesh(((DATA_AXIS, 2, half),),
                                 slice_index_fn=lambda r: r // half)
        slices = [int(r) // half for r in hmesh.ranks.ravel()]
        assert slices == sorted(slices), slices
        hstate, htx = mobilenet_state()
        hm = make_train_step(htx)(hstate, t(mine(images, hmesh)),
                                  t(mine(labels, hmesh)), 1)
        say(f"dryrun hybrid OK: mesh={hmesh.shape} slices=2 (slice-major) "
            f"loss={finite(hm['loss']):.4f}")
    return {"lines": lines, "zero_checks": checks}


def _rank(device: str, ckpt_dir: str | None, threads: int) -> dict:
    torch.set_num_threads(threads)
    return _arms(device, ckpt_dir)


def dryrun_multichip(n_devices: int = 8, device: str = "cuda",
                     ckpt_dir: str | None = None) -> list[dict]:
    """Run every arm on ``n_devices`` gloo ranks over ``device`` (each
    rank on ``cuda:0``, or the CPU) and print rank 0's ``dryrun ... OK``
    lines. ``ckpt_dir`` keeps the ZeRO arm's sharded checkpoint there.
    Returns every rank's result (its lines and the checksums of the ZeRO
    state it wrote)."""
    from ddw_tpu_torch.runtime.dist import spawn_cpu
    from ddw_tpu_torch.utils.device import resolve_device

    device = str(resolve_device(device))
    threads = max(1, (os.cpu_count() or 1) // n_devices)
    out = spawn_cpu(_rank, n_devices, device, ckpt_dir, threads,
                    timeout_s=600.0)
    for line in out[0]["lines"]:
        print(line, flush=True)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=8)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, args.device)


if __name__ == "__main__":
    main()
