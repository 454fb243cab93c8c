"""Command-line interface of the port: ``python -m lir_tpu_torch``.

  sweep        word-meaning model-comparison sweep -> D1/D2 CSVs
  perturb      perturbation grid sweep (with resume) -> D6 CSV
  analyze      statistical analyses over the D1/D2/D6 artifacts
  survey       the human-survey pipeline (D3 + D1/D2 -> D7/D8/D9, C38-C43)
  repro        the survey pipeline and every analysis from a data directory
  rephrase     generate perturbations.json with a local rephraser model
  serve        the online scoring service: one model, N replicas behind a
               router, or a fleet of models (JSONL in/out)

Port of the ``sweep``, ``perturb``, ``analyze``, ``survey``, ``repro``,
``rephrase`` and ``serve`` commands of ``lir_tpu/cli.py``.
Each flag lands in the same ``RuntimeConfig`` / ``SpecConfig`` /
``CascadeConfig`` / ``GovernorConfig`` / ``ServeConfig`` field as there
(``--kv-cache-int8`` and ``--param-cache`` in
``models.factory.load_engine(kv_cache_int8=, cache_root=)``;
``--weight-cache-gb`` and ``--no-weight-prefetch`` in
``run_model_comparison_sweep`` and the serving fleet's ``ModelFleet``;
the router flags in ``RouterConfig``). The watchdog flags also reach
``sweep``, whose word-meaning batches run under the watchdog in the
port. The migration flags (``--no-migrate``, ``--migrate-*``) land in
``MigrationConfig`` for the router's disaggregated prefill and decode.
A flag of a feature the port does not have yet (meshes, leased
shards, serving's memory tiers, the sentinels, the metrics op, tracing)
is not defined, so argparse rejects it. ``--device`` (default ``cuda``) says where the models and the
statistics run; the CPU must be asked for. Where matplotlib is absent,
``analyze``, ``survey`` and ``repro`` log that figures were skipped and
write everything else; ``repro --no-figures`` also reaches the survey
pipeline, which the JAX command's does not.

Model weights must be local checkpoint directories (zero egress); pass
--checkpoints pointing at a root containing ``<org>__<name>`` dirs.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional

from .utils.logging import get_logger

log = get_logger(__name__)


def _positive_int(text: str) -> int:
    """argparse type for decode budgets: a 0/negative budget would run an
    empty decode whose position-0 readout is garbage."""
    value = int(text)
    if value < 1:
        raise argparse.ArgumentTypeError(f"{value} is not >= 1")
    return value


def _add_common(p) -> None:
    p.add_argument("--checkpoints", type=Path, required=True)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--int8", action="store_true",
                   help="int8 weights (per-output-channel scales)")
    p.add_argument("--int8-dynamic", action="store_true",
                   help="with --int8: quantize activations per token and "
                        "run s8 x s8 products")
    p.add_argument("--kv-cache-int8", action="store_true",
                   help="store the KV cache int8 with per-vector scales: "
                        "half the cache bytes, s8 x s8 cached attention "
                        "(no effect on an encoder-decoder)")
    p.add_argument("--param-cache", type=Path, default=None,
                   help="converted-parameter cache root: the first load of "
                        "a model converts its checkpoint and writes the "
                        "tree (before int8 quantization) under "
                        "ROOT/<checkpoint dir name>; later loads read it "
                        "back without converting (models/cache.py)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the model runs (default cuda; cpu runs every "
                        "kernel's plain PyTorch version)")
    _add_watchdog_flags(p)


def _add_watchdog_flags(p) -> None:
    """The dispatch watchdog's knobs (RuntimeConfig; guard/watchdog.py)."""
    p.add_argument("--watchdog-multiple", type=float, default=None,
                   help="dispatch watchdog deadline = floor + multiple x "
                        "predicted dispatch seconds (bucket_cost-priced, "
                        "self-calibrated; default 20). <= 0 disables "
                        "stall detection")
    p.add_argument("--watchdog-floor", type=float, default=None,
                   help="hard minimum watchdog deadline in seconds "
                        "(default 30)")


def _guard_rt_kw(args, rt_kw: dict) -> None:
    """Fold the watchdog flags into a RuntimeConfig kwargs dict."""
    if args.watchdog_multiple is not None:
        rt_kw["watchdog_multiple"] = args.watchdog_multiple
    if args.watchdog_floor is not None:
        rt_kw["watchdog_floor_s"] = args.watchdog_floor


def _add_sweep(sub) -> None:
    p = sub.add_parser("sweep", help="word-meaning model comparison (D1/D2)")
    p.add_argument("--models", nargs="+", required=True,
                   help="repo ids; suffix ':base' or ':instruct' "
                        "(default instruct)")
    p.add_argument("--out", type=Path, default=Path("results/comparison"))
    p.add_argument("--sweep-kind", choices=["base_vs_instruct", "instruct_only"],
                   default="base_vs_instruct")
    _add_common(p)
    _add_fleet_flags(p)


def _add_fleet_flags(p, with_models: bool = False) -> None:
    """The fleet's knobs (config.FleetConfig; engine/fleet.py over
    models/weights.py); ``with_models`` adds serving's fleet flags."""
    if with_models:
        p.add_argument("--fleet-models", default=None,
                       help="comma-separated model ids served as a FLEET: "
                            "per-model dispatch queues under one weight "
                            "budget, and the {\"op\": \"fleet_score\"} "
                            "request class (a line without \"model\"): "
                            "one question under every model, answered with "
                            "per-model P(yes)/P(no), kappa and "
                            "disagreement")
        p.add_argument("--fleet-deadline", type=float, default=None,
                       help="default deadline in seconds of a fleet_score "
                            "fan-out (default 60; a request's "
                            "\"deadline_s\" overrides)")
    p.add_argument("--weight-cache-gb", type=float, default=None,
                   help="device budget for co-resident model weights in the "
                        "fleet's LRU weight cache (default 0 = unbounded; "
                        "it must hold the largest model)")
    p.add_argument("--no-weight-prefetch", action="store_true",
                   help="disable async weight streaming: every model swap "
                        "then loads inline, after the previous model's "
                        "dispatches (measurement baseline)")


def _add_router_flags(p) -> None:
    """The replica router's knobs (config.RouterConfig;
    serve/router.py)."""
    p.add_argument("--replicas", type=int, default=None,
                   help="N in-process replica servers behind the failover "
                        "router (single-model serving; default 1 = no "
                        "router)")
    p.add_argument("--hedge-threshold", type=float, default=None,
                   help="hedge whisker in seconds: a request this close to "
                        "its deadline is duplicated onto a second replica, "
                        "first payload wins (default 0 = off)")
    p.add_argument("--replica-failure-threshold", type=int, default=None,
                   help="error results in a row from one replica before "
                        "its router-side breaker opens (default 2)")
    p.add_argument("--replica-cooldown", type=float, default=None,
                   help="router-side breaker open -> half-open cooldown in "
                        "seconds (default 5)")
    p.add_argument("--residency-bonus", type=float, default=None,
                   help="placement bonus (queue rows) for a replica holding "
                        "the request's model (default 8)")
    p.add_argument("--pressure-weight", type=float, default=None,
                   help="placement penalty (queue rows) per unit of a "
                        "replica's governor pressure (default 6; 0 off)")
    p.add_argument("--slo-wait-weight", type=float, default=None,
                   help="weight on a replica's oldest queued-row wait "
                        "against the request's remaining deadline "
                        "(default 4; 0 off)")
    p.add_argument("--router-tick", type=float, default=None,
                   help="router tick in seconds (hedging, breaker "
                        "promotion; default 0.02)")
    p.add_argument("--router-cache-entries", type=int, default=None,
                   help="router dedup cache capacity, the exactly-once "
                        "backstop (default 4096; 0 off)")


def _add_migrate_flags(p) -> None:
    """Disaggregated prefill and decode (config.MigrationConfig;
    serve/migrate.py)."""
    p.add_argument("--no-migrate", action="store_true",
                   help="disable KV-page migration and disaggregated "
                        "placement (MigrationConfig.enabled; the role-less "
                        "replica router)")
    p.add_argument("--migrate-prefill-replicas", type=int, default=None,
                   help="of --replicas N, the first K take the PREFILL "
                        "role: long prompts prefill there and their KV "
                        "pages migrate to decode-role replicas (default 0 "
                        "= colocated)")
    p.add_argument("--migrate-chunk-pages", type=int, default=None,
                   help="KV pages a transfer chunk (default 8)")
    p.add_argument("--migrate-inflight-chunks", type=int, default=None,
                   help="transfer chunks in flight a leg (default 2)")
    p.add_argument("--migrate-min-prefix", type=int, default=None,
                   help="shortest tokenized shared prefix worth a remote "
                        "prefill and a migration; shorter prompts score "
                        "colocated (default 32)")
    p.add_argument("--migrate-page-bonus", type=float, default=None,
                   help="placement bonus (queue rows) per prefix page a "
                        "replica already holds (default 0.5)")
    p.add_argument("--no-migrate-verify", action="store_true",
                   help="skip the per-chunk transfer checksums "
                        "(MigrationConfig.verify); measurement only")
    p.add_argument("--migrate-timeout", type=float, default=None,
                   help="seconds one migration chain may take before the "
                        "router falls back to a local re-prefill "
                        "(default 30)")


def _migrate_cfg(args):
    """MigrationConfig from the flags (an unset flag keeps the
    default)."""
    from .config import MigrationConfig

    kw = {}
    if getattr(args, "no_migrate", False):
        kw["enabled"] = False
    for flag, field in (("migrate_prefill_replicas", "prefill_replicas"),
                        ("migrate_chunk_pages", "chunk_pages"),
                        ("migrate_inflight_chunks", "inflight_chunks"),
                        ("migrate_min_prefix", "min_prefix_tokens"),
                        ("migrate_page_bonus", "page_bonus"),
                        ("migrate_timeout", "timeout_s")):
        if getattr(args, flag, None) is not None:
            kw[field] = getattr(args, flag)
    if getattr(args, "no_migrate_verify", False):
        kw["verify"] = False
    return MigrationConfig(**kw)


def _router_cfg(args):
    """RouterConfig from the flags (an unset flag keeps the default)."""
    from .config import RouterConfig

    kw = {}
    for flag, field in (("replicas", "replicas"),
                        ("hedge_threshold", "hedge_s"),
                        ("replica_failure_threshold",
                         "replica_failure_threshold"),
                        ("replica_cooldown", "replica_cooldown_s"),
                        ("residency_bonus", "residency_bonus"),
                        ("slo_wait_weight", "slo_wait_weight"),
                        ("pressure_weight", "pressure_weight"),
                        ("router_tick", "tick_s"),
                        ("router_cache_entries", "cache_entries")):
        if getattr(args, flag, None) is not None:
            kw[field] = getattr(args, flag)
    return RouterConfig(**kw)


def _add_governor_flags(p) -> None:
    """The device-memory governor's knobs (config.GovernorConfig;
    engine/hbm.py)."""
    p.add_argument("--no-hbm-governor", action="store_true",
                   help="disable the device-memory governor: no ladder "
                        "walks, whatever the pressure")
    p.add_argument("--hbm-budget-gb", type=float, default=None,
                   help="governed budget in GiB (default 0: the card's "
                        "memory less the reserve; on the CPU 0 means "
                        "unbounded and the ladder never engages)")
    p.add_argument("--hbm-reserve-frac", type=float, default=None,
                   help="fraction of the card's memory held back from a "
                        "derived budget (default 0.08)")
    p.add_argument("--hbm-engage-pressure", type=float, default=None,
                   help="ledger/budget pressure at which the ladder "
                        "engages its next rung (default 0.9)")
    p.add_argument("--hbm-hysteresis", type=float, default=None,
                   help="release band below the engage pressure (default "
                        "0.15): rungs re-arm below engage - hysteresis")
    p.add_argument("--hbm-sustain-ticks", type=int, default=None,
                   help="consecutive over-pressure dispatch ticks before a "
                        "rung engages (default 2)")
    p.add_argument("--hbm-evict-pages", type=int, default=None,
                   help="radix pages evicted per evict_pages rung "
                        "engagement (default 32)")


def _governor_cfg(args):
    """GovernorConfig from the flags (an unset flag keeps the default)."""
    from .config import GovernorConfig

    kw = {}
    if getattr(args, "no_hbm_governor", False):
        kw["enabled"] = False
    for flag, field in (("hbm_budget_gb", "hbm_budget_gb"),
                        ("hbm_reserve_frac", "hbm_reserve_frac"),
                        ("hbm_engage_pressure", "engage_pressure"),
                        ("hbm_hysteresis", "hysteresis"),
                        ("hbm_sustain_ticks", "sustain_ticks"),
                        ("hbm_evict_pages", "evict_pages_per_step")):
        if getattr(args, flag, None) is not None:
            kw[field] = getattr(args, flag)
    return GovernorConfig(**kw)


def _add_rephrase(sub) -> None:
    from .config import PerturbationConfig

    defaults = PerturbationConfig()
    p = sub.add_parser("rephrase", help="generate perturbations.json locally")
    p.add_argument("--checkpoints", type=Path, required=True)
    p.add_argument("--model", required=True,
                   help="instruct model acting as the rephraser")
    p.add_argument("--out", type=Path, default=Path("perturbations.json"))
    p.add_argument("--sessions", type=int,
                   default=defaults.sessions_per_prompt)
    p.add_argument("--per-session", type=int,
                   default=defaults.rephrasings_per_session)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the rephraser runs (default cuda)")


def _add_perturb(sub) -> None:
    p = sub.add_parser("perturb", help="perturbation grid sweep (D6)")
    p.add_argument("--model", required=True)
    p.add_argument("--perturbations", type=Path,
                   default=Path("perturbations.json"))
    p.add_argument("--out", type=Path,
                   default=Path("results/perturbation_results.xlsx"),
                   help="results path (an .xlsx path is written as .csv "
                        "beside it)")
    p.add_argument("--subset-size", type=int, default=None)
    _add_common(p)
    p.add_argument("--full-completions", action="store_true",
                   help="decode the reference's full 50-token responses per "
                        "cell instead of the short budgets; disables the "
                        "early stops")
    p.add_argument("--sweep-decode-tokens", type=_positive_int, default=None,
                   help="binary-format decode budget per cell (default 4)")
    p.add_argument("--sweep-confidence-tokens", type=_positive_int,
                   default=None,
                   help="confidence-format decode budget per cell (default 8)")
    p.add_argument("--no-early-stop", action="store_true",
                   help="disable the digit/EOS early stops (they change no "
                        "recorded value)")
    # Engine shape (RuntimeConfig).
    p.add_argument("--max-seq-len", type=_positive_int, default=None,
                   help="prompt-length ceiling in tokens (default 1024)")
    p.add_argument("--max-new-tokens", type=_positive_int, default=None,
                   help="full-completion decode budget (default 50)")
    p.add_argument("--no-ragged-scheduler", action="store_true",
                   help="legacy todo-order batching instead of the ragged "
                        "bucket-ladder scheduler (results identical per cell)")
    p.add_argument("--sweep-group-min-prefix", type=_positive_int,
                   default=None,
                   help="cross-cell prefix grouping: minimum shared leading "
                        "tokens (default 16)")
    p.add_argument("--sweep-group-min-cells", type=int, default=None,
                   help="cross-cell prefix grouping: minimum cells per group "
                        "(default 4; 0 disables grouping)")
    p.add_argument("--scan-positions", type=_positive_int, default=None,
                   help="generated positions scanned for the yes/no top-k "
                        "match (default 10)")
    # Kernels, speculation, cascade.
    p.add_argument("--no-fused-decode", action="store_true",
                   help="dense decode attention instead of the flash-decode "
                        "kernels")
    p.add_argument("--no-piggyback", action="store_true",
                   help="disable piggyback chains (each shared dispatch then "
                        "runs its own prefill and decode call; results "
                        "identical)")
    p.add_argument("--no-spec-decode", action="store_true",
                   help="disable speculative scoring decode")
    p.add_argument("--spec-k", type=_positive_int, default=None,
                   help="speculative verify window (default 4, < 2 disables)")
    p.add_argument("--spec-draft-model", type=str, default=None,
                   help="fleet model id that drafts for the scored model "
                        "(same tokenizer required; acquired through the "
                        "weight cache). Empty = self-drafting (radix tree "
                        "+ n-gram lookup)")
    p.add_argument("--spec-ngram", type=_positive_int, default=None,
                   help="n-gram match length of the prompt-lookup drafter "
                        "(default 2)")
    p.add_argument("--no-spec-tree-probe", action="store_true",
                   help="skip the radix prefix tree's token-history "
                        "continuation probe when drafting (n-gram lookup "
                        "only)")
    p.add_argument("--spec-tree-tails", type=_positive_int, default=None,
                   help="continuation tails recorded per radix node for "
                        "drafting, LRU beyond this (default 32; host memory "
                        "only)")
    # The cross-request prefix cache (models/paged.py, engine/prefix_tree.py).
    p.add_argument("--prefix-cache", action="store_true",
                   help="enable the cross-request radix prefix cache for the "
                        "sweep (paged KV pool + radix tree): repeated grids "
                        "on one engine resume shared prefixes from the page "
                        "pool")
    p.add_argument("--prefix-cache-pages", type=_positive_int, default=None,
                   help="KV page pool size in pages (default 512; each page "
                        "holds --prefix-page-size token positions and costs "
                        "models/paged.kv_page_bytes of device memory)")
    p.add_argument("--prefix-page-size", type=_positive_int, default=None,
                   help="token positions per KV page (default 16; also the "
                        "radix tree's edge granularity: prefixes cache in "
                        "full pages, tails recompute)")
    p.add_argument("--no-cascade-prefill", action="store_true",
                   help="dense shared prefill instead of the cascade")
    p.add_argument("--cascade-min-trunk", type=_positive_int, default=None,
                   help="shortest shared trunk worth the cascade (default 32)")
    p.add_argument("--cascade-trunk-quantum", type=_positive_int,
                   default=None,
                   help="trunk lengths snap down to this multiple (default 16)")
    p.add_argument("--cascade-min-rows", type=_positive_int, default=None,
                   help="fewest real rows sharing the trunk (default 2)")
    p.add_argument("--cascade-int8-qk", action="store_true",
                   help="int8 QK^T in the cascade's trunk leg")
    p.add_argument("--no-cascade-decode", action="store_true",
                   help="flat decode kernels instead of the trunk-aware ones")
    p.add_argument("--no-cascade-fused-suffix", action="store_true",
                   help="the two-leg cascade instead of the fused kernel")
    # Streaming statistics and the numerics guard.
    p.add_argument("--no-streaming-stats", action="store_true",
                   help="disable the device-resident streaming-statistics "
                        "sink (per-dispatch lattice fold, accumulator "
                        "checkpoints); statistics then come only from the "
                        "row artifact")
    p.add_argument("--no-row-artifact", action="store_true",
                   help="with streaming stats on, write no per-row CSV: no "
                        "per-row payload crosses to the host, and resume "
                        "runs on the manifest + accumulator checkpoint")
    p.add_argument("--no-numerics-guard", action="store_true",
                   help="disable the score-extraction numerics guard "
                        "(NaN/Inf/out-of-range rows are then written "
                        "verbatim instead of quarantined as error:numerics "
                        "— measurement only)")
    _add_governor_flags(p)


def _add_serve(sub) -> None:
    p = sub.add_parser(
        "serve",
        help="online scoring service: continuous batching over the bucket "
             "ladder (lir_tpu_torch/serve), over one model (--model), N "
             "replicas of it behind a router (--replicas) or a fleet "
             "(--fleet-models). Reads JSONL requests from --requests "
             "(default stdin), writes one JSONL result a line to stdout. "
             "Request lines: {\"id\", \"binary_prompt\", "
             "\"confidence_prompt\"} or {\"prompt\"} with optional "
             "\"response_format\"/\"confidence_format\", plus optional "
             "\"targets\": [t1, t2], \"class\", \"deadline_s\" (and "
             "\"model\" on a fleet); {\"op\": \"stats\"} answers the "
             "live statistics")
    p.add_argument("--checkpoints", type=Path, required=True)
    p.add_argument("--model", default=None,
                   help="the served model (single-model serving: breaker, "
                        "ladder, checkpoint)")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--int8", action="store_true")
    p.add_argument("--int8-dynamic", action="store_true")
    p.add_argument("--kv-cache-int8", action="store_true")
    p.add_argument("--param-cache", type=Path, default=None)
    p.add_argument("--sweep-decode-tokens", type=_positive_int, default=None)
    p.add_argument("--sweep-confidence-tokens", type=_positive_int,
                   default=None)
    p.add_argument("--requests", type=str, default="-",
                   help="JSONL request file, or '-' for stdin (default)")
    p.add_argument("--queue-depth", type=int, default=256,
                   help="admission bound; a submit into a full queue "
                        "sheds the least-urgent request")
    p.add_argument("--linger-ms", type=float, default=20.0,
                   help="a partial bucket dispatches once its oldest "
                        "request waited this long")
    p.add_argument("--cache-entries", type=int, default=4096,
                   help="content-addressed result cache capacity (0 "
                        "disables dedup)")
    p.add_argument("--deadline", action="append", default=None,
                   metavar="CLASS=SECONDS",
                   help="deadline class override, repeatable (default: "
                        "interactive=10, batch=300)")
    p.add_argument("--breaker-cooldown", type=float, default=30.0,
                   help="circuit-breaker open -> half-open cooldown in "
                        "seconds")
    p.add_argument("--state-checkpoint", type=Path, default=None,
                   help="SIGTERM stops the supervisor and atomically "
                        "writes every unresolved request here; on start, "
                        "an existing file is re-submitted")
    p.add_argument("--no-prefix-cache", action="store_true",
                   help="disable the cross-request radix prefix cache "
                        "(serving default on)")
    p.add_argument("--prefix-cache-pages", type=_positive_int, default=None,
                   help="KV page pool size in pages (default 512)")
    p.add_argument("--prefix-page-size", type=_positive_int, default=None,
                   help="token positions per KV page (default 16)")
    p.add_argument("--no-pad-full", action="store_true",
                   help="pad dispatches to the power-of-two tail instead "
                        "of the full batch")
    p.add_argument("--no-degrade-ladder", action="store_true",
                   help="on a dispatch that spends its retries, error the "
                        "whole batch instead of bisecting out poison rows")
    p.add_argument("--max-consecutive-failures", type=_positive_int,
                   default=None,
                   help="failed dispatches in a row before the circuit "
                        "breaker opens (default 3)")
    p.add_argument("--stream-window", type=int, default=None,
                   help="live statistics ring size (default 4096; 0 "
                        "disables)")
    p.add_argument("--no-streaming-stats", action="store_true",
                   help="no live statistics ring")
    p.add_argument("--no-numerics-guard", action="store_true",
                   help="return NaN/Inf/out-of-range payloads verbatim "
                        "instead of quarantining them as error:numerics")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the model runs (default cuda)")
    _add_watchdog_flags(p)
    _add_governor_flags(p)
    _add_fleet_flags(p, with_models=True)
    _add_router_flags(p)
    _add_migrate_flags(p)


def _add_analyze(sub) -> None:
    p = sub.add_parser("analyze", help="statistical analyses over artifacts")
    p.add_argument("--perturbation-results", type=Path, default=None,
                   help="D6 results -> perturbation distribution suite")
    p.add_argument("--base-csv", type=Path, default=None,
                   help="D1 -> base-vs-instruct deltas")
    p.add_argument("--instruct-csv", type=Path, default=None,
                   help="D2 -> model graph suite (+ kappa combiner when the "
                        "D6 results are also given)")
    p.add_argument("--out", type=Path, default=Path("results/analysis"))
    p.add_argument("--no-figures", action="store_true")
    p.add_argument("--n-simulations", type=int, default=100_000)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the statistics run (default cuda)")


def _add_repro(sub) -> None:
    p = sub.add_parser(
        "repro",
        help="regenerate the full published analysis from a reference-style "
             "data directory (D1/D2/D3 CSVs) in one shot",
    )
    p.add_argument("--data", type=Path, required=True,
                   help="directory holding model_comparison_results.csv, "
                        "instruct_model_comparison_results.csv, "
                        "word_meaning_survey_results.csv")
    p.add_argument("--perturbation-results", type=Path, default=None,
                   help="optional D6 results for the perturbation suite")
    p.add_argument("--out", type=Path, default=Path("results/repro"))
    p.add_argument("--quick", action="store_true")
    p.add_argument("--no-figures", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the statistics run (default cuda)")


def _add_survey(sub) -> None:
    p = sub.add_parser("survey", help="human-survey analysis pipeline")
    p.add_argument("--survey", type=Path, required=True)
    p.add_argument("--instruct", type=Path, required=True)
    p.add_argument("--base", type=Path, default=None)
    p.add_argument("--out", type=Path, default=Path("results/survey"))
    p.add_argument("--quick", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the statistics run (default cuda)")


def _figures_wanted(command: str, no_figures: bool = False) -> bool:
    """Whether to draw figures: not with --no-figures, and not (with a
    warning) where matplotlib is absent."""
    if no_figures:
        return False
    from .report.figures import require_matplotlib

    try:
        require_matplotlib()
    except ImportError:
        log.warning("%s: matplotlib is not installed; figures skipped",
                    command)
        return False
    return True


def _perturb_configs(args):
    """(RuntimeConfig, SpecConfig, CascadeConfig) of the perturb flags, the
    fields the JAX ``*_rt_kw`` helpers fill."""
    from .config import CascadeConfig, RuntimeConfig, SpecConfig

    if args.full_completions and (args.sweep_decode_tokens is not None
                                  or args.sweep_confidence_tokens is not None):
        raise SystemExit(
            "--full-completions decodes the reference's full 50-token "
            "responses unconditionally; it cannot combine with "
            "--sweep-decode-tokens / --sweep-confidence-tokens")
    rt_kw = dict(batch_size=args.batch_size,
                 sweep_full_completions=args.full_completions,
                 sweep_early_stop=not args.no_early_stop)
    _guard_rt_kw(args, rt_kw)
    # Flags named as their RuntimeConfig field.
    for name in ("sweep_decode_tokens", "sweep_confidence_tokens",
                 "max_seq_len", "max_new_tokens", "sweep_group_min_prefix",
                 "sweep_group_min_cells", "scan_positions", "spec_k",
                 "prefix_cache_pages", "prefix_page_size"):
        if getattr(args, name) is not None:
            rt_kw[name] = getattr(args, name)
    for flag, field in (("no_ragged_scheduler", "ragged_scheduler"),
                        ("no_fused_decode", "fused_decode"),
                        ("no_piggyback", "piggyback_prefill"),
                        ("no_spec_decode", "spec_decode"),
                        ("no_cascade_prefill", "cascade_prefill"),
                        ("no_cascade_decode", "cascade_decode"),
                        ("no_cascade_fused_suffix", "cascade_fused_suffix"),
                        ("no_streaming_stats", "streaming_stats"),
                        ("no_row_artifact", "row_artifact"),
                        ("no_numerics_guard", "numerics_guard")):
        if getattr(args, flag):
            rt_kw[field] = False
    if args.prefix_cache:
        rt_kw["prefix_cache"] = True
    if args.spec_draft_model is not None:
        rt_kw["spec_draft_model"] = args.spec_draft_model
    spec_kw = {}
    if args.spec_ngram is not None:
        spec_kw["ngram"] = args.spec_ngram
    if args.no_spec_tree_probe:
        spec_kw["tree_probe"] = False
    if args.spec_tree_tails is not None:
        spec_kw["tree_tails_per_node"] = args.spec_tree_tails
    cascade_kw = {}
    for flag, field in (("cascade_min_trunk", "min_trunk"),
                        ("cascade_trunk_quantum", "trunk_quantum"),
                        ("cascade_min_rows", "min_rows")):
        if getattr(args, flag) is not None:
            cascade_kw[field] = getattr(args, flag)
    if args.cascade_int8_qk:
        cascade_kw["int8_qk"] = True
    return (RuntimeConfig(**rt_kw), SpecConfig(**spec_kw),
            CascadeConfig(**cascade_kw))


def _parse_models(items: List[str]):
    from .engine.multi import ModelSpec

    specs = []
    for item in items:
        name, _, kind = item.partition(":")
        specs.append(ModelSpec(name, kind or "instruct"))
    return specs


def cmd_sweep(args) -> None:
    from .config import RuntimeConfig
    from .engine.multi import run_model_comparison_sweep
    from .models.factory import engine_factory

    rt_kw = dict(batch_size=args.batch_size)
    _guard_rt_kw(args, rt_kw)
    factory = engine_factory(
        args.checkpoints, RuntimeConfig(**rt_kw),
        quantize_int8=args.int8, int8_dynamic=args.int8_dynamic,
        device=args.device, kv_cache_int8=args.kv_cache_int8,
        cache_root=args.param_cache)
    run_model_comparison_sweep(
        _parse_models(args.models), factory, args.out,
        sweep_kind=args.sweep_kind,
        weight_prefetch=not args.no_weight_prefetch,
        weight_cache_bytes=(int(args.weight_cache_gb * 2**30)
                            if args.weight_cache_gb else None))


def cmd_perturb(args) -> None:
    from .data.prompts import LEGAL_PROMPTS
    from .engine.rephrase import load_or_generate_perturbations
    from .engine.sweep import run_perturbation_sweep
    from .models.factory import engine_factory

    rt, spec_cfg, cascade_cfg = _perturb_configs(args)
    factory = engine_factory(
        args.checkpoints, rt, quantize_int8=args.int8,
        int8_dynamic=args.int8_dynamic, spec_config=spec_cfg,
        cascade_config=cascade_cfg, device=args.device,
        kv_cache_int8=args.kv_cache_int8,
        governor_config=_governor_cfg(args), cache_root=args.param_cache)
    entries = load_or_generate_perturbations(args.perturbations, LEGAL_PROMPTS)
    perturbations = [rephrasings for _, rephrasings in entries]
    engine = factory(args.model)
    if not rt.spec_draft_model:
        rows = run_perturbation_sweep(engine, args.model, LEGAL_PROMPTS,
                                      perturbations, args.out,
                                      subset_size=args.subset_size)
    else:
        fleet, engine, draft_id = _fleet_draft(factory, args.model, engine)
        try:
            rows = run_perturbation_sweep(engine, args.model, LEGAL_PROMPTS,
                                          perturbations, args.out,
                                          subset_size=args.subset_size)
        finally:
            fleet.release_spec_draft(engine, draft_id)
            fleet.release(args.model)
            fleet.shutdown()
    log.info("perturbation sweep wrote %d rows", len(rows))


def _fleet_draft(factory, model_id: str, engine):
    """``--spec-draft-model``: the scored model and its draft model in
    one fleet that shares the engine's governor (weights, pages and the
    draft's pin in one ledger), the draft armed through
    ``ModelFleet.acquire_spec_draft`` with both models' weights held for
    the sweep. Returns (fleet, engine, draft id); exits 2 where the
    draft could not draft."""
    from .engine.fleet import ModelFleet

    draft = engine.rt.spec_draft_model
    if draft == model_id or not engine.spec_supported():
        log.error("perturb: --spec-draft-model needs speculative decode "
                  "on a decoder model and a draft model other than "
                  "--model")
        sys.exit(2)
    fleet = ModelFleet.from_engines([(model_id, engine)], prefetch=False,
                                    stage_reloads=False)
    fleet.attach_governor(engine.governor)
    fleet.add_model(draft, make_engine=factory)
    engine = fleet.acquire(model_id)
    try:
        draft_id = fleet.acquire_spec_draft(engine, model_id)
    except BaseException:
        fleet.release(model_id)
        fleet.shutdown()
        raise
    return fleet, engine, draft_id


def cmd_serve(args) -> None:
    """The JAX ``serve`` command: JSONL requests in, one JSONL result a
    request out (in request order, after the input ends), the ``{"op":
    "stats"}`` line answered at once. One model (``--model``), with
    ``--state-checkpoint`` SIGTERM checkpointing every unresolved
    request (re-submitted on the next start); N replicas of it behind
    the router (``--replicas``); or a fleet (``--fleet-models``)."""
    import json
    import signal

    from .config import RuntimeConfig, ServeConfig
    from .models.factory import engine_factory
    from .serve import ScoringServer

    rt_kw = dict(batch_size=args.batch_size)
    for name in ("sweep_decode_tokens", "sweep_confidence_tokens",
                 "prefix_cache_pages", "prefix_page_size"):
        if getattr(args, name) is not None:
            rt_kw[name] = getattr(args, name)
    if args.no_streaming_stats:
        rt_kw["streaming_stats"] = False
    if args.no_numerics_guard:
        rt_kw["numerics_guard"] = False
    _guard_rt_kw(args, rt_kw)
    classes = dict(ServeConfig().classes)
    for spec in args.deadline or ():
        name, sep, secs = spec.partition("=")
        try:
            classes[name] = float(secs)
        except ValueError:
            sep = ""
        if not sep or not name:
            raise SystemExit(f"--deadline {spec!r} must be CLASS=SECONDS")
    serve_kw = {}
    if args.max_consecutive_failures is not None:
        serve_kw["max_consecutive_failures"] = args.max_consecutive_failures
    if args.stream_window is not None:
        serve_kw["stream_window"] = args.stream_window
    serve_cfg = ServeConfig(
        queue_depth=args.queue_depth, classes=tuple(classes.items()),
        linger_s=args.linger_ms / 1000.0,
        cache_entries=args.cache_entries,
        breaker_cooldown_s=args.breaker_cooldown,
        prefix_cache=not args.no_prefix_cache,
        pad_full=not args.no_pad_full,
        degrade_ladder=not args.no_degrade_ladder, **serve_kw)
    if bool(args.model) == bool(args.fleet_models):
        raise SystemExit("serve needs exactly one of --model (single-"
                         "model) or --fleet-models (multiplexed fleet)")
    n_replicas = args.replicas if args.replicas is not None else 1
    if n_replicas > 1 and args.fleet_models:
        raise SystemExit("--replicas fronts single-model replica servers; "
                         "combine it with --model")
    if n_replicas > 1 and args.state_checkpoint is not None:
        raise SystemExit("--state-checkpoint is per-server state; with "
                         "--replicas the router's failover replaces it")
    factory = engine_factory(
        args.checkpoints, RuntimeConfig(**rt_kw), quantize_int8=args.int8,
        int8_dynamic=args.int8_dynamic, device=args.device,
        kv_cache_int8=args.kv_cache_int8,
        governor_config=_governor_cfg(args), cache_root=args.param_cache)
    if args.fleet_models:
        _run_fleet_serve(args, serve_cfg, factory)
        return
    if n_replicas > 1:
        _run_router_serve(args, serve_cfg, factory, n_replicas)
        return
    engine = factory(args.model)
    server = ScoringServer(engine, args.model, serve_cfg).start()

    futures = []
    if args.state_checkpoint is not None:
        def _on_sigterm(signum, frame):
            n = server.shutdown_checkpoint(args.state_checkpoint)
            log.warning("SIGTERM: checkpointed %d pending requests -> %s"
                        "; exiting", n, args.state_checkpoint)
            sys.exit(0)

        signal.signal(signal.SIGTERM, _on_sigterm)
        if args.state_checkpoint.exists():
            # The previous run's unresolved requests go first.
            futures.extend(server.resume_from_checkpoint(
                args.state_checkpoint))

    for i, obj in _jsonl_lines(args.requests):
        if obj.get("op") == "stats":
            print(json.dumps({"op": "stats",
                              "stats": server.stream_summary()}),
                  flush=True)
            continue
        futures.append(server.submit(
            _request_of(obj, i, serve_cfg.default_class)))
    for fut in futures:
        r = fut.result()
        print(json.dumps({k: v for k, v in vars(r).items()
                          if not k.startswith("_")}), flush=True)
    server.stop()
    if args.state_checkpoint is not None and args.state_checkpoint.exists():
        args.state_checkpoint.unlink()   # clean drain: nothing pending
    log.info("serve stats: %s", json.dumps(server.stats.summary()))
    log.info("serve faults: %s", json.dumps(server.faults.summary()))
    log.info("serve guard: %s",
             json.dumps(engine.guard_stats.summary()))


def _request_of(obj: dict, i: int, default_class: str):
    """A ServeRequest from one JSONL request line (a bare ``prompt``
    takes the canonical legal-prompt formats, so it scores like a sweep
    cell)."""
    from .data.prompts import LEGAL_PROMPTS
    from .serve import ServeRequest

    prompt = obj.get("prompt")
    rf = obj.get("response_format", LEGAL_PROMPTS[0].response_format)
    cf = obj.get("confidence_format", LEGAL_PROMPTS[0].confidence_format)
    return ServeRequest(
        binary_prompt=obj.get("binary_prompt", f"{prompt} {rf}"),
        confidence_prompt=obj.get("confidence_prompt", f"{prompt} {cf}"),
        targets=tuple(obj.get("targets", ("Yes", "No"))),
        klass=obj.get("class", default_class),
        deadline_s=obj.get("deadline_s"),
        request_id=str(obj.get("id", i)))


def _jsonl_lines(path: str):
    """(index, parsed object) of each non-empty line of ``path`` ('-':
    stdin)."""
    import json

    stream = sys.stdin if path == "-" else open(path, encoding="utf-8")
    try:
        for i, line in enumerate(stream):
            line = line.strip()
            if line:
                yield i, json.loads(line)
    finally:
        if stream is not sys.stdin:
            stream.close()


def _run_router_serve(args, serve_cfg, factory, n_replicas: int) -> None:
    """``serve --model X --replicas N``: N in-process replica
    ScoringServers (an engine each) behind a ReplicaRouter. With
    ``--migrate-prefill-replicas K`` the first K replicas take the
    prefill role and the rest decode (disaggregated serving; 0 keeps
    every replica "both"). The JSONL surface is the single-model one;
    ``{"op": "stats"}`` answers the router's counters, its ``"migrate"``
    block and the per-replica health view. Exits 1 when no replica is
    alive at the end. (Each replica's disk-tier directory comes with the
    memory tiers, ROADMAP A8d.)"""
    import json

    from .serve import ReplicaRouter, ScoringServer

    servers = [ScoringServer(factory(args.model), args.model,
                             serve_cfg).start()
               for _ in range(n_replicas)]
    n_prefill = getattr(args, "migrate_prefill_replicas", None) or 0
    roles = ({f"r{i}": ("prefill" if i < n_prefill else "decode")
              for i in range(n_replicas)} if n_prefill else None)
    router = ReplicaRouter([(f"r{i}", s) for i, s in enumerate(servers)],
                           config=_router_cfg(args), roles=roles,
                           migrate=_migrate_cfg(args)).start()
    log.info("router: %d replica servers for %s (%d prefill-role)",
             n_replicas, args.model, n_prefill)
    futures = []
    for i, obj in _jsonl_lines(args.requests):
        if obj.get("op") == "stats":
            print(json.dumps({"op": "stats", **router.stats_summary()}),
                  flush=True)
            continue
        futures.append(router.submit(
            _request_of(obj, i, serve_cfg.default_class)))
    for fut in futures:
        r = fut.result()
        print(json.dumps({k: v for k, v in vars(r).items()
                          if not k.startswith("_")}), flush=True)
    router.stop()
    for s in servers:
        s.stop()
    log.info("router stats: %s", json.dumps(router.stats_summary()))
    if not router.alive_replicas():
        sys.exit(1)


def _run_fleet_serve(args, serve_cfg, factory) -> None:
    """``serve --fleet-models a,b``: a line without a "model" key fans
    across every fleet model and prints one agreement payload (per-model
    P(yes)/P(no)/decision, kappa, disagreement); a "model" key routes the
    line to that model's queue. ``{"op": "stats"}`` answers the serve
    counters and the fleet's swap accounting."""
    import json

    from .engine.fleet import ModelFleet
    from .serve import FleetScoringServer

    if args.state_checkpoint is not None:
        raise SystemExit(
            "--state-checkpoint is not supported with --fleet-models; "
            "run fleet serving behind an external retry layer")
    models = [m for m in args.fleet_models.split(",") if m]
    if not models:
        raise SystemExit("--fleet-models needs at least one model id")
    # Engines load at boot (tokenizers and buckets are submit-time
    # state); weight residency is the cache's from here on.
    fleet = ModelFleet.from_engines(
        [(m, factory(m)) for m in models],
        cache_budget_bytes=(int(args.weight_cache_gb * 2**30)
                            if args.weight_cache_gb else None),
        prefetch=not args.no_weight_prefetch)
    server = FleetScoringServer(
        fleet, serve_cfg,
        fleet_deadline_s=(args.fleet_deadline
                          if args.fleet_deadline is not None else 60.0),
    ).start()
    futures = []
    for i, obj in _jsonl_lines(args.requests):
        if obj.get("op") == "stats":
            print(json.dumps({"op": "stats", **server.stats_summary()}),
                  flush=True)
            continue
        req = _request_of(obj, i, serve_cfg.default_class)
        if obj.get("model"):
            futures.append(("single", server.submit(req, obj["model"])))
        else:
            futures.append(("fleet", server.submit_fleet(req)))
    for kind, fut in futures:
        r = fut.result()
        print(json.dumps(r if kind == "fleet"
                         else {k: v for k, v in vars(r).items()
                               if not k.startswith("_")}), flush=True)
    server.stop()
    fleet.shutdown()
    log.info("serve stats: %s", json.dumps(server.stats.summary()))
    log.info("fleet stats: %s", json.dumps(server.fleet_summary()))


def cmd_rephrase(args) -> None:
    """The five legal prompts' rephrasings sampled by ``--model`` (the
    JAX command's key, ``prng_key(42)``, and temperature 0.9) into
    ``--out``; a valid cache there is kept."""
    from .config import PerturbationConfig
    from .data.prompts import LEGAL_PROMPTS
    from .engine import prng
    from .engine.rephrase import (load_or_generate_perturbations,
                                  rephraser_from_engine)
    from .models.factory import engine_factory

    cfg = PerturbationConfig()
    engine = engine_factory(args.checkpoints, device=args.device)(args.model)
    load_or_generate_perturbations(
        args.out, LEGAL_PROMPTS,
        rephraser_from_engine(engine, temperature=cfg.rephrase_temperature),
        prng.prng_key(cfg.seed),
        sessions_per_prompt=args.sessions,
        rephrasings_per_session=args.per_session)


def cmd_analyze(args) -> None:
    from .device import resolve_device

    device = resolve_device(args.device)
    if not (args.perturbation_results or args.base_csv or args.instruct_csv):
        log.error("analyze: give at least one of --perturbation-results, "
                  "--base-csv, --instruct-csv")
        sys.exit(2)
    make_figures = _figures_wanted("analyze", args.no_figures)
    if args.perturbation_results:
        from .analysis.perturbation import analyze_all_models

        analyze_all_models(
            args.perturbation_results, args.out / "perturbation",
            n_simulations=args.n_simulations, make_figures=make_figures,
            device=device,
        )
    if args.base_csv:
        from .analysis.base_vs_instruct import run_base_vs_instruct_analysis

        run_base_vs_instruct_analysis(
            args.base_csv, args.out / "base_vs_instruct",
            make_figures=make_figures,
        )
    if args.instruct_csv:
        from .analysis.model_graph import run_model_graph_analysis

        run_model_graph_analysis(
            args.instruct_csv, args.out / "model_graph",
            make_figures=make_figures, device=device,
        )
        if args.perturbation_results:
            from .analysis.kappa_combined import run_kappa_analysis

            run_kappa_analysis(
                args.instruct_csv, args.perturbation_results,
                args.out / "kappa", make_figures=make_figures, device=device,
            )


def cmd_survey(args) -> None:
    from .device import resolve_device
    from .survey.run import QUICK_BUDGETS, run_survey_pipeline

    device = resolve_device(args.device)
    run_survey_pipeline(args.survey, args.instruct, args.base, args.out,
                        make_figures=_figures_wanted("survey"),
                        device=device,
                        **(QUICK_BUDGETS if args.quick else {}))


def cmd_repro(args) -> None:
    """Survey pipeline + every CSV-driven analysis in one pass, in the JAX
    command's order and with its --quick budgets."""
    from .analysis.base_vs_instruct import run_base_vs_instruct_analysis
    from .analysis.model_graph import run_model_graph_analysis
    from .device import resolve_device
    from .survey.run import QUICK_BUDGETS, run_survey_pipeline

    device = resolve_device(args.device)
    data = args.data
    base_csv = data / "model_comparison_results.csv"
    instruct_csv = data / "instruct_model_comparison_results.csv"
    survey_csv = data / "word_meaning_survey_results.csv"
    figures = _figures_wanted("repro", args.no_figures)

    run_survey_pipeline(
        survey_csv, instruct_csv,
        base_csv if base_csv.exists() else None,
        args.out / "survey", make_figures=figures, device=device,
        **(QUICK_BUDGETS if args.quick else {}),
    )
    if base_csv.exists():
        run_base_vs_instruct_analysis(
            base_csv, args.out / "base_vs_instruct", make_figures=figures)
    run_model_graph_analysis(
        instruct_csv, args.out / "model_graph",
        n_bootstrap=50 if args.quick else 1000, make_figures=figures,
        device=device)
    if args.perturbation_results:
        from .analysis.kappa_combined import run_kappa_analysis
        from .analysis.perturbation import analyze_all_models

        analyze_all_models(
            args.perturbation_results, args.out / "perturbation",
            n_simulations=2000 if args.quick else 100_000,
            make_figures=figures, device=device,
        )
        run_kappa_analysis(
            instruct_csv, args.perturbation_results, args.out / "kappa",
            n_bootstrap=100 if args.quick else 1000, make_figures=figures,
            device=device,
        )
    log.info("repro complete; artifacts under %s", args.out)


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        prog="lir_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)
    _add_sweep(sub)
    _add_perturb(sub)
    _add_analyze(sub)
    _add_survey(sub)
    _add_repro(sub)
    _add_rephrase(sub)
    _add_serve(sub)
    args = parser.parse_args(argv)
    if getattr(args, "int8_dynamic", False) and not args.int8:
        parser.error("--int8-dynamic requires --int8 (it selects HOW int8 "
                     "matmuls run, not whether weights are quantized)")
    {"sweep": cmd_sweep, "perturb": cmd_perturb, "analyze": cmd_analyze,
     "survey": cmd_survey, "repro": cmd_repro,
     "rephrase": cmd_rephrase, "serve": cmd_serve}[args.command](args)
