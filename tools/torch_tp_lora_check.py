#!/usr/bin/env python3
"""LoRA under tensor parallelism on one card, alone: ``chip_smoke.py``'s
parallel-drill TP arm (a LoRA-built lm_flash over ``model=2``, two rank
processes on the card, against the single-process step in this process)
and its tp_serve arms (c) and (d) (an adapter pool at tp=2 beside tp=1 on
serve_plus's cut, a third adapter evicting one, and a LoRA-built package at
tp=2), with ``chip_smoke.py``'s checks and JSON lines.

    python3 tools/torch_tp_lora_check.py     # needs one card; about 2 min

Prints the card's name and power limit, then ``TP LORA CHECK OK``."""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


def rank(toks):
    import torch

    from ddw_tpu_torch.runtime.mesh import process_index

    torch.cuda.set_device(0)
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    return cs.tp_lora_rank(toks, process_index())


def main():
    import numpy as np

    from ddw_tpu_torch.runtime.dist import spawn_cpu
    from ddw_tpu_torch.serving.lm_package import (LMPackagedModel,
                                                  save_lm_package)
    from ddw_tpu_torch.utils.config import LMCfg

    name, smi = cs.phase_device()
    cs.phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        toks = cs.arithmetic_tokens(16, cs.SEED + 60,
                                    cs.LM_CFG["vocab_size"], cs.LM_SEQ)
        np.save(os.path.join(tmp, "sp_train.npy"), toks)
        os.environ.update(DDW_ATTN_XLA_PLAIN_MAX="0",
                          DDW_ATTN_XLA_CKPT_MAX="0")
        ranks = spawn_cpu(rank, 2, {"sp_train": toks}, timeout_s=600)
        cs.tp_lora_reference(tmp, ranks)
        cs.emit(phase="tp_lora_check", parallel_tp_lora_s=(
            time.perf_counter() - t0))
        t0 = time.perf_counter()
        pkg = save_lm_package(os.path.join(tmp, "serve_lm"),
                              LMCfg(**cs.LM_CFG), cs.serve_params())
        pm = LMPackagedModel(pkg)
        prompts, _ = cs.serve_mix()
        cs.tp_serve_lora(tmp, pm, prompts[:cs.TP_SERVE_REQUESTS])
        cs.emit(phase="tp_lora_check",
                tp_serve_lora_s=time.perf_counter() - t0)
    print(smi, flush=True)
    print("TP LORA CHECK OK", flush=True)


if __name__ == "__main__":
    main()
