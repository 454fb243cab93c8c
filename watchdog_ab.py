"""Rows/s of the perturbation sweep with the dispatch watchdog at its
default and off, in one process on one card.

    python3 watchdog_ab.py [--pairs 10]

Builds the port's kernels, seeds llama-2-7b's weights on the card (bf16,
B = 32: ``chip_smoke.py``'s phase 3 engine, whose watchdog runs at
``RuntimeConfig.watchdog_multiple``'s default) and a twin engine on the
same weights with ``watchdog_multiple=0``. For the flat and grouped
grids (``chip_smoke.sweep_grids(15)``, 80 cells each) and the chain grid
(``chip_smoke.chain_grid``, its piggyback chains) it sweeps each engine
once untimed, then ``--pairs`` pairs, alternating which engine runs
first, each run's rows/s by the host clock around
``run_perturbation_sweep`` ending in a synchronize
(``chip_smoke.timed_sweep``). Fails unless every watched run's rows are
byte for byte the unwatched rows, and unless the watchdog watched
dispatches on one engine and none on the other. Prints one JSON line a
grid (each run's rows/s, each side's median and quartiles, the share of
pairs the watched run won), then the card's name and power limit.
Exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from lir_tpu_torch.backends.fake import FakeTokenizer
from lir_tpu_torch.config import RuntimeConfig
from lir_tpu_torch.engine.runner import ScoringEngine
from lir_tpu_torch.models import decoder, registry
from lir_tpu_torch.ops import _build


def side(runs) -> dict:
    q1, med, q3 = np.percentile(runs, [25, 50, 75])
    return {"rows_per_s": runs, "median": float(med),
            "quartiles": [float(q1), float(q3)]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("watchdog_ab: no CUDA device; nothing measured",
              file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    _build.build()
    cfg = registry.llama2_7b()
    params = decoder.init_params(cfg, seed=0, device="cuda",
                                 dtype=torch.bfloat16)
    on = ScoringEngine(params, cfg, FakeTokenizer(vocab=cfg.vocab_size),
                       RuntimeConfig(batch_size=cs.BATCH), device="cuda")
    off = cs.engine_with(on, watchdog_multiple=0.0)
    grids = cs.sweep_grids(15)
    cases = {"flat": grids["flat"], "grouped": grids["grouped"],
             "chain": cs.chain_grid()}
    engines = {"on": on, "off": off}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for name, (prompts, perts) in cases.items():
            for mode, eng in engines.items():
                cs.sweep.run_perturbation_sweep(
                    eng, cs.SWEEP_MODEL, prompts, perts,
                    tmp / f"{name}_{mode}_warm.csv")
            runs = {"on": [], "off": []}
            for k in range(args.pairs):
                order = ("on", "off") if k % 2 == 0 else ("off", "on")
                for mode in order:
                    path = tmp / f"{name}_{mode}{k}.csv"
                    st = cs.timed_sweep(engines[mode], prompts, perts, path)
                    runs[mode].append(st["rows_per_s"])
                    if (mode == "on" and cs.d6_records(path)
                            != cs.d6_records(tmp / f"{name}_off_warm.csv")):
                        raise AssertionError(f"{name}: watched rows differ "
                                             f"from the unwatched rows")
            wins = sum(a > b for a, b in zip(runs["on"], runs["off"]))
            print(json.dumps({
                "grid": name, "pairs": args.pairs, "on": side(runs["on"]),
                "off": side(runs["off"]),
                "on_over_off_medians": float(np.median(runs["on"])
                                             / np.median(runs["off"])),
                "on_wins": wins}), flush=True)
    if off.guard_stats.watched or not on.guard_stats.watched:
        raise AssertionError(f"watched: on {on.guard_stats.watched}, off "
                             f"{off.guard_stats.watched}")
    print(json.dumps({"watched": on.guard_stats.summary(),
                      "multiple": on.watchdog.multiple,
                      "seconds": time.perf_counter() - t0}))
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
