"""Contract 2 on a real weights artifact — pretrain -> export -> convert ->
frozen-base transfer -> package -> score (the port's mirror of
``examples/08_pretrained_transfer.py``).

The reference's result rests on a frozen ImageNet-pretrained MobileNetV2.
This example runs that chain with no network access: it produces the
pretrained artifact itself, then consumes it as a downloaded one would be.

1. Pretrain a MobileNetV2 on a seeded generated corpus (8 shape classes,
   disjoint from the 5 flowers classes).
2. Export the backbone in both public layouts, a torchvision-style
   state_dict and a Keras-applications weights archive
   (:mod:`ddw_tpu_torch.models.export`).
3. Convert each through the import paths (:mod:`ddw_tpu_torch.models.
   convert`, the code that takes real ImageNet weights) and check that the
   two artifacts agree.
4. Train a frozen-base head on flowers from the artifact, against a
   frozen-random baseline: pretrained must win.
5. Package the pretrained model and batch-score the validation table.

With real ImageNet weights (exported on a machine with network access):

    python -m ddw_tpu_torch.models.convert mnv2_imagenet.pt backbone.npz
    python examples_torch/02_train_single_node.py --source <flowers_dir> \\
        model.name=mobilenet_v2 model.pretrained_path=backbone.npz

Run this example:
    python examples_torch/08_pretrained_transfer.py --quick

``model.dw_impl`` (e.g. ``pallas``: the depthwise kernels on the card) and
``model.width_mult`` (with ``model.name=mobilenet_v2``) carry over to every
model of the chain; ``--pretrain-epochs`` sets the pretraining length.
"""

import copy
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from ddw_tpu_torch.data.prep import (generate_synthetic_flowers,  # noqa: E402
                                     prepare_flowers)
from ddw_tpu_torch.models.convert import (  # noqa: E402
    convert_keras_mobilenet_v2, convert_torch_mobilenet_v2,
    load_keras_weights, save_pretrained, to_flax_variables)
from ddw_tpu_torch.models.export import (  # noqa: E402
    export_keras_mobilenet_v2, export_torch_mobilenet_v2)
from ddw_tpu_torch.serving.batch import BatchScorer  # noqa: E402
from ddw_tpu_torch.serving.package import save_packaged_model  # noqa: E402
from ddw_tpu_torch.train.trainer import Trainer  # noqa: E402
from ddw_tpu_torch.utils.config import ModelCfg  # noqa: E402
from examples_torch.common import (parse_args, require_tables,  # noqa: E402
                                   setup)


def main(argv=None):
    args = parse_args(__doc__, extra=lambda ap: ap.add_argument(
        "--pretrain-epochs", type=int, default=6,
        help="epochs of the backbone pretraining (smoke tests pass 1; the "
             "transfer separation needs about 6)"), argv=argv)
    ws = setup(args)
    data_cfg = ws["cfgs"]["data"]
    store = ws["store"]
    device = ws["device"]
    base = ws["cfgs"]["model"]
    width = base.width_mult if base.name == "mobilenet_v2" else 0.35
    dw_impl = base.dw_impl

    # -- 1. pretraining corpus (classes disjoint from flowers) + pretrain ----
    pre_src = os.path.join(ws["workdir"], "raw_pretrain")
    if not os.path.isdir(pre_src):
        print(f"[pretrain] generating shape corpus at {pre_src}")
        generate_synthetic_flowers(
            pre_src, images_per_class=40, size=48,
            classes=[f"shape_{i}" for i in range(8)], seed=123)
    if not store.exists("pretrain_train"):
        prepare_flowers(pre_src, store, sample_fraction=1.0,
                        shard_size=data_cfg.shard_size,
                        bronze_name="pretrain_bronze",
                        train_name="pretrain_train", val_name="pretrain_val")
    pre_train, pre_val = store.table("pretrain_train"), store.table(
        "pretrain_val")

    pre_mcfg = ModelCfg(name="mobilenet_v2", num_classes=8, dropout=0.1,
                        width_mult=width, freeze_base=False, dtype="float32",
                        dw_impl=dw_impl)
    pre_tcfg = copy.deepcopy(ws["cfgs"]["train"])
    pre_tcfg.epochs = args.pretrain_epochs
    pre_tcfg.learning_rate = 2e-3
    pre_tcfg.checkpoint_dir = ""
    with ws["tracker"].start_run("pretrain_backbone") as run:
        pre_res = Trainer(data_cfg, pre_mcfg, pre_tcfg, run=run,
                          device=device).fit(pre_train, pre_val)
    print(f"[pretrain] val_accuracy={pre_res.val_accuracy:.3f} "
          f"({pre_tcfg.epochs} epochs, width {width})")
    v = to_flax_variables(pre_res.state.model)
    backbone = {"params": v["params"]["backbone"],
                "batch_stats": v["batch_stats"]["backbone"]}

    # -- 2+3. export both public layouts, convert back, artifacts must agree -
    art_torch = os.path.join(ws["workdir"], "backbone_via_torch.npz")
    art_keras = os.path.join(ws["workdir"], "backbone_via_keras.npz")
    sd = export_torch_mobilenet_v2(backbone)
    save_pretrained(art_torch, convert_torch_mobilenet_v2(sd))
    keras_npz = os.path.join(ws["workdir"], "keras_weights.npz")
    np.savez(keras_npz, **export_keras_mobilenet_v2(backbone))
    save_pretrained(art_keras,
                    convert_keras_mobilenet_v2(load_keras_weights(keras_npz)))
    with np.load(art_torch) as a, np.load(art_keras) as b:
        assert set(a.files) == set(b.files)
        worst = max(float(np.max(np.abs(a[k] - b[k]))) for k in a.files)
    print(f"[convert] torch and keras layout round-trips agree "
          f"(max |diff| {worst:.2e})")

    # -- 4. frozen transfer on flowers: pretrained vs random ----------------
    train_tbl, val_tbl = require_tables(store, data_cfg)

    def head_fit(pretrained_path: str, tag: str):
        mcfg = ModelCfg(name="mobilenet_v2", num_classes=5, dropout=0.1,
                        width_mult=width, freeze_base=True, dtype="float32",
                        dw_impl=dw_impl, pretrained_path=pretrained_path,
                        allow_frozen_random=not pretrained_path)
        tcfg = copy.deepcopy(ws["cfgs"]["train"])
        tcfg.learning_rate = 5e-3
        tcfg.checkpoint_dir = ""
        with ws["tracker"].start_run(f"transfer_{tag}") as run:
            res = Trainer(data_cfg, mcfg, tcfg, run=run,
                          device=device).fit(train_tbl, val_tbl)
        print(f"[transfer] {tag}: val_accuracy={res.val_accuracy:.3f}")
        return res, mcfg

    res_pre, mcfg_pre = head_fit(art_torch, "pretrained_frozen")
    res_rnd, _ = head_fit("", "random_frozen")
    won = res_pre.val_accuracy > res_rnd.val_accuracy
    print(f"[contract] pretrained-frozen {res_pre.val_accuracy:.3f} vs "
          f"random-frozen {res_rnd.val_accuracy:.3f} "
          f"({'OK' if won else 'VIOLATION'})")

    # -- 5. package + batch-score the pretrained model ----------------------
    label_to_idx = train_tbl.meta["label_to_idx"]
    classes = [c for c, _ in sorted(label_to_idx.items(),
                                    key=lambda kv: kv[1])]
    pkg = os.path.join(ws["workdir"], "pretrained_pkg")
    v = to_flax_variables(res_pre.state.model)
    save_packaged_model(pkg, mcfg_pre, classes, v["params"], v["batch_stats"],
                        img_height=data_cfg.img_height,
                        img_width=data_cfg.img_width)
    rows = BatchScorer(pkg, batch_per_device=8, device=device).score_table(
        val_tbl)
    truth = {r.path: r.label for r in val_tbl.iter_records()}
    agree = sum(truth[p] == pred for p, pred in rows) / len(rows)
    print(f"[score] {len(rows)} rows, packaged-model accuracy {agree:.3f}")
    return {"pretrain": pre_res, "pretrained": res_pre, "random": res_rnd,
            "artifact_max_diff": worst, "contract_ok": won,
            "artifacts": (art_torch, art_keras), "scored": rows,
            "packaged_accuracy": agree}


if __name__ == "__main__":
    main()
