"""Contract 5 — packaged-model training with single-node and distributed
inference (the port's mirror of ``examples/06_packaged_inference.py``):
train the full pipeline with early stopping and save a self-contained
packaged model, score an in-memory batch of 10 rows, then score a table
distributed over ``--score-procs`` processes (the ``spark_udf`` over
content role), whose parts rank 0 merges into one predictions table.

    python examples_torch/06_packaged_inference.py --quick
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from ddw_tpu_torch.models.convert import to_flax_variables  # noqa: E402
from ddw_tpu_torch.serving.package import (PackagedModel,  # noqa: E402
                                           save_packaged_model)
from ddw_tpu_torch.train.trainer import Trainer  # noqa: E402
from examples_torch.common import (parse_args, require_tables,  # noqa: E402
                                   score_distributed, setup)


def main(argv=None):
    def extra(ap):
        ap.add_argument(
            "--int8", action="store_true",
            help="store kernels as per-channel int8 (~4x smaller artifact; "
                 "loads transparently)")
        ap.add_argument("--score-procs", type=int, default=2,
                        help="processes of the distributed scoring run")

    args = parse_args(__doc__, extra=extra, argv=argv)
    ws = setup(args)
    cfgs = ws["cfgs"]
    train_tbl, val_tbl = require_tables(ws["store"], cfgs["data"])

    cfgs["train"].early_stop_patience = 3
    run = ws["tracker"].start_run("pyfunc_training")
    res = Trainer(cfgs["data"], cfgs["model"], cfgs["train"], run=run,
                  device=ws["device"]).fit(train_tbl, val_tbl)

    label_to_idx = train_tbl.meta["label_to_idx"]
    classes = [c for c, _ in sorted(label_to_idx.items(),
                                    key=lambda kv: kv[1])]
    pkg_dir = os.path.join(run.artifact_dir(), "pyfunc_model")
    v = to_flax_variables(res.state.model)
    save_packaged_model(pkg_dir, cfgs["model"], classes, v["params"],
                        v.get("batch_stats"),
                        img_height=cfgs["data"].img_height,
                        img_width=cfgs["data"].img_width,
                        extra_meta={"val_accuracy": res.val_accuracy},
                        quantize="int8" if args.int8 else None)
    run.end()
    blob = os.path.getsize(os.path.join(pkg_dir, "params.msgpack"))
    print(f"packaged model at {pkg_dir} (val_accuracy={res.val_accuracy:.4f},"
          f" params blob {blob / 1024:.0f} KiB"
          + (", int8 weight-only" if args.int8 else "") + ")")

    # single-node scoring of an in-memory batch
    pm = PackagedModel(pkg_dir, device=ws["device"])
    sample = val_tbl.take(10)
    preds = pm.predict([r.content for r in sample]
                       if val_tbl.meta.get("encoding") != "raw_u8"
                       else _decoded(sample, val_tbl))
    correct = sum(p == r.label for p, r in zip(preds, sample))
    print(f"pandas-batch analog: {preds} ({correct}/{len(sample)} correct)")

    # distributed scoring over the table, merged into one table by rank 0
    rows = score_distributed(pkg_dir, ws["store"], val_tbl.manifest["name"],
                             "predictions", args.score_procs,
                             device=ws["device"])
    labels = {r.path: r.label for r in val_tbl.iter_records()}
    acc = sum(labels[p] == pred for p, pred in rows) / len(rows)
    merged = ws["store"].table("predictions")
    print(f"distributed scoring: {len(rows)} rows over {args.score_procs} "
          f"processes, accuracy={acc:.4f}; predictions table of "
          f"{merged.num_records} records written")
    return {"pkg_dir": pkg_dir, "rows": rows, "accuracy": acc,
            "predictions": merged, "val_accuracy": res.val_accuracy}


def _decoded(records, table):
    """Pre-decoded ``raw_u8`` records as float images in [-1, 1]."""
    import numpy as np

    from ddw_tpu_torch.data.loader import dequantize_raw_u8, raw_u8_view

    x = np.stack([raw_u8_view(r.content, table.meta["height"],
                              table.meta["width"]) for r in records])
    x = x.astype(np.float32)
    dequantize_raw_u8(x)
    return x


if __name__ == "__main__":
    main()
