"""The readings the correctness limits are set from, on the card at the
cells' own sizes.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,13 \\
        --seconds 10 [--control 1]

For each seed, in one process, one run of the cell as ``run.py`` runs it,
printing one JSON line: the numbers it compared (the program's readings,
whose largest over a dozen seeds is a limit's lower reading) and, with
``--control 1``, the same numbers of the control (the reference in fp8, one
precision below the configurations' bfloat16) and, for a training cell, of
the fault "half of the batch left out" planted in the reference: the upper
readings. ``--k2-double 1`` plants a fault in the program instead: K2,
the depthwise weight gradient, returns twice its answer. The benchmark's
own runs take none of these.
"""

import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def k2_double(patch=setattr) -> None:
    """From now on K2 (and its plain version, which the CPU runs) returns
    twice the weight gradient; ``patch(module, name, value)`` sets it (a
    test passes one that undoes itself)."""
    from ddw_tpu_torch.ops import depthwise_conv as dw

    for name in ("depthwise_conv3x3_wgrad_cuda",
                 "depthwise_conv3x3_wgrad_plain"):
        orig = getattr(dw, name)

        def doubled(*a, _orig=orig, **k):
            return 2.0 * _orig(*a, **k)

        doubled.__dict__.update(orig.__dict__)
        patch(dw, name, doubled)



def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", type=int, default=1)
    ap.add_argument("--config", default="{}",
                    help="JSON of configuration keys to change, for a trial")
    ap.add_argument("--witness", type=int, default=0,
                    help="also the reference in bfloat16, for a look")
    ap.add_argument("--k2-double", type=int, default=0,
                    help="1: K2 returns twice the weight gradient")
    ap.add_argument("--tf32", type=int, default=1,
                    help="0: the program's float32 products without TF32")
    args = ap.parse_args()

    import torch

    from benchmark.lib.harness import run_cell

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 3
    if not args.tf32:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if args.k2_double:
        k2_double()
    extra = ("control", "half_batch") if args.control else ()
    extra += ("witness",) if args.witness else ()
    t = T_PROC
    for seed in (int(s) for s in args.seeds.split(",")):
        r = run_cell(ROOT, args.workload, seed, args.seconds, False, "cuda",
                     t, extra=extra, config_changes=json.loads(args.config))
        t = time.perf_counter()
        print(json.dumps({"seed": seed, "correct": r["correct"],
                          "checks": {k: v["value"]
                                     for k, v in r["checks"].items()},
                          "details": r["details"],
                          "metrics": {k: v["value"]
                                      for k, v in r["metrics"].items()},
                          "memory_peak_bytes":
                              r["device"]["memory_peak_bytes"]}),
              flush=True)
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
