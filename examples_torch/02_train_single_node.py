"""Contract 2 — single-node training: the transfer CNN on one device (the
port's mirror of ``examples/02_train_single_node.py``).

Batch 32, 3 epochs, Adam 1e-3, sparse cross-entropy from logits, a tracker
run with per-epoch metrics.

    python examples_torch/02_train_single_node.py --quick

``--cache-features`` is the frozen-transfer path: the frozen backbone runs
once over the dataset (features cached in the table store, fenced by a
fingerprint of its weights), then only the head trains.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from ddw_tpu_torch.train.trainer import Trainer  # noqa: E402
from examples_torch.common import (parse_args, require_tables,  # noqa: E402
                                   setup)


def main(argv=None):
    args = parse_args(__doc__, extra=lambda ap: ap.add_argument(
        "--cache-features", action="store_true",
        help="frozen-transfer fast path: featurise once with the frozen "
             "backbone, then train only the head "
             "(ddw_tpu_torch.train.transfer)"), argv=argv)
    ws = setup(args)
    cfgs = ws["cfgs"]
    train_tbl, val_tbl = require_tables(ws["store"], cfgs["data"])

    run = ws["tracker"].start_run("single_node")
    if args.cache_features:
        from ddw_tpu_torch.train.transfer import train_frozen_via_features
        from examples_torch.common import ensure_frozen_backbone_cfg

        mcfg = cfgs["model"]
        ensure_frozen_backbone_cfg(mcfg)
        res = train_frozen_via_features(cfgs["data"], mcfg, cfgs["train"],
                                        train_tbl, val_tbl, ws["store"],
                                        run=run, device=ws["device"])
    else:
        trainer = Trainer(cfgs["data"], cfgs["model"], cfgs["train"],
                          run=run, device=ws["device"])
        res = trainer.fit(train_tbl, val_tbl)
    run.end()
    for row in res.history:
        print({k: round(v, 4) if isinstance(v, float) else v
               for k, v in row.items()})
    print(f"run {run.run_id}: val_loss={res.val_loss:.4f} "
          f"val_accuracy={res.val_accuracy:.4f}")
    return res


if __name__ == "__main__":
    main()
