"""Contract 1 — data prep: raw JPEG tree -> bronze -> silver train/val tables
(the port's mirror of ``examples/01_data_prep.py``).

Recursive scan with a seeded sample, label from the path, seeded 90/10
split, sorted-distinct label index, silver tables.

    python examples_torch/01_data_prep.py --quick
    python examples_torch/01_data_prep.py --quick --etl-procs 2

``--etl-procs N`` runs the shared-nothing multi-worker ETL: N OS processes
each read a disjoint round-robin slice and write part tables; worker 0
commits the final tables by manifest merge. ``--materialize`` also writes
pre-decoded ``raw_u8`` tables, which the loader reads with no JPEG work.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from ddw_tpu_torch.data.prep import (prepare_flowers,  # noqa: E402
                                     prepare_flowers_distributed)
from examples_torch.common import parse_args, setup  # noqa: E402


def _etl_worker(w, n, source_dir, table_root, kwargs):
    from ddw_tpu_torch.data.store import TableStore

    prepare_flowers_distributed(source_dir, TableStore(table_root), w, n,
                                **kwargs)


def main(argv=None):
    def extra(ap):
        ap.add_argument(
            "--etl-procs", type=int, default=1,
            help="shared-nothing ETL worker processes (1 = single-process "
                 "prep)")
        ap.add_argument(
            "--materialize", action="store_true",
            help="also write pre-decoded raw_u8 tables (decode once at "
                 "prep; the loader then skips JPEG work)")

    args = parse_args(__doc__, extra=extra, argv=argv)
    ws = setup(args)
    data = ws["cfgs"]["data"]
    kwargs = dict(sample_fraction=data.sample_fraction,
                  train_fraction=data.train_fraction,
                  split_seed=data.split_seed, shard_size=data.shard_size)
    if args.etl_procs > 1:
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_etl_worker,
                             args=(w, args.etl_procs, data.source_dir,
                                   ws["store"].root, kwargs))
                 for w in range(1, args.etl_procs)]
        for p in procs:
            p.start()

        def dead_worker():
            # polled while the coordinator waits for parts: fail at once
            # with the child's exit status
            for i, p in enumerate(procs):
                if p.exitcode not in (None, 0):
                    return f"ETL worker {i + 1} exited with {p.exitcode}"
            return None

        try:
            train_tbl, val_tbl, label_to_idx = prepare_flowers_distributed(
                data.source_dir, ws["store"], 0, args.etl_procs,
                abort=dead_worker, **kwargs)
        finally:
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
    else:
        train_tbl, val_tbl, label_to_idx = prepare_flowers(
            data.source_dir, ws["store"], **kwargs)
    print(f"bronze+silver written under {data.table_root}")
    print(f"label_to_idx: {label_to_idx}")
    print(f"silver_train: {train_tbl.num_records} records in "
          f"{len(train_tbl.shard_paths)} shards")
    print(f"silver_val:   {val_tbl.num_records} records in "
          f"{len(val_tbl.shard_paths)} shards")
    out = {"train": train_tbl, "val": val_tbl, "label_to_idx": label_to_idx}

    if args.materialize:
        from ddw_tpu_torch.data.prep import materialize_decoded

        for tbl, name in ((train_tbl, "silver_train_decoded"),
                          (val_tbl, "silver_val_decoded")):
            g = materialize_decoded(tbl, ws["store"], name,
                                    data.img_height, data.img_width,
                                    shard_size=data.shard_size)
            out[name] = g
            print(f"{name}: {g.num_records} records pre-decoded at "
                  f"{data.img_height}x{data.img_width}")
    return out


if __name__ == "__main__":
    main()
