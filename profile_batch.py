"""Profile one bf16 word-meaning batch of the port on one card, from a
given checkout of it: launches, device time, and the elementwise adds.

    python3 profile_batch.py [--tree DIR] [--label NAME]

DIR (default: this checkout) is the root of a checkout whose
``lir_tpu_torch`` package is used, so that two commits' batches can be
profiled in turns in one call (e.g. a parent commit unpacked with ``git
archive`` into ``build/``). Builds that package's kernels, makes
llama-2-7b with seeded random bf16 weights on the card and an engine at
B = 32, and prints one JSON line of :func:`profile` of ``decode_fused``
(prefill + 50 greedy steps) on the first 32 word-meaning questions. Then
the card's name and power limit. ``chip_smoke.py`` profiles its batches
with the same :func:`profile`.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch


def profile(call) -> dict:
    """Where the device time of ``call`` (which ends by synchronizing the
    card) goes: run once to warm up, once on the host clock, once under
    ``torch.profiler``. Returns the host-clock ms and, where the trace
    holds kernels, their launches, the device-busy ms (the union of the
    kernel intervals) and its share of the host-clock time, the ms and
    launches of each ``CUDAFunctor_add`` kernel (the elementwise adds,
    among them the residual adds that ``row_add_norm`` takes over) and the
    ten largest kernels; else device-busy "not measured"."""
    from torch.profiler import ProfilerActivity, profile as trace

    call()
    t0 = time.perf_counter()
    call()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return {"wall_ms": wall_ms, "device_busy": "not measured"}
    busy, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in kernels):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    by_name, count = {}, {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        count[e.name] = count.get(e.name, 0) + 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "wall_ms": wall_ms, "kernel_launches": len(kernels),
        "device_busy_ms": busy / 1e3, "device_busy_share": busy / 1e3 / wall_ms,
        "add_kernels_ms_launches": {n[-120:]: [us / 1e3, count[n]]
                                    for n, us in by_name.items() if "CUDAFunctor_add" in n},
        "top_kernels_ms": {n[:80]: us / 1e3 for n, us in top}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=Path(__file__).resolve().parent)
    ap.add_argument("--label", default="this")
    args = ap.parse_args()
    sys.path.insert(0, str(args.tree.resolve()))
    import numpy as np

    if not torch.cuda.is_available():
        print("profile_batch: no CUDA device; nothing measured", file=sys.stderr)
        return 1
    import lir_tpu_torch
    from lir_tpu_torch.backends.fake import FakeTokenizer
    from lir_tpu_torch.config import RuntimeConfig
    from lir_tpu_torch.data import WORD_MEANING_QUESTIONS, format_base_prompt
    from lir_tpu_torch.engine.runner import ScoringEngine
    from lir_tpu_torch.models import decoder, registry
    from lir_tpu_torch.ops import _build

    if Path(lir_tpu_torch.__file__).resolve().parents[1] != args.tree.resolve():
        raise RuntimeError(f"lir_tpu_torch came from {lir_tpu_torch.__file__}, "
                           f"not {args.tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    cfg = registry.llama2_7b()
    batch = 32
    params = decoder.init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    engine = ScoringEngine(params, cfg, FakeTokenizer(vocab=cfg.vocab_size),
                           RuntimeConfig(batch_size=batch), device="cuda")
    prompts = [format_base_prompt(q) for q in WORD_MEANING_QUESTIONS[:batch]]
    yes = np.full(batch, engine.yes_id, np.int32)
    no = np.full(batch, engine.no_id, np.int32)

    def call():
        engine.decode_fused(prompts, yes, no)
        torch.cuda.synchronize()

    print(json.dumps({"profile_batch": args.label, "tree": str(args.tree),
                      "call": f"decode_fused, B={batch}, 50 steps", **profile(call)}),
          flush=True)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    print(out.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
