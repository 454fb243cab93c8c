"""Multi-model sweep orchestration: the model-comparison sweep (D1/D2).

Port of ``lir_tpu/engine/multi.py``:

- the (base, instruct) pair loop of compare_base_vs_instruct.py:386-550
  and the instruct-only loop of compare_instruct_models.py:376-566,
  including the per-model try/except that emits NaN rows instead of
  killing a long sweep (:482-492 / :512-522);
- C15 memory management through the fleet (engine/fleet.py): the sweep
  acquires each model from a :class:`~lir_tpu_torch.engine.fleet.
  ModelFleet`, whose worker loads model i+1 while model i scores
  (``weight_prefetch``), co-resident models stay cached inside
  ``weight_cache_bytes`` (None = unbounded, except on a card, where the
  sweep's own fleet drops each model after its rows) and the LRU cache
  evicts only idle models. A fleet the sweep builds itself stages no host
  copies (each model is visited once) and gives every model back at
  the end (``gc.collect()``, ``torch.cuda.empty_cache()``). A model
  whose ``rt.spec_draft_model`` names another fleet model drafts with
  it (``ModelFleet.acquire_spec_draft``);
- C16 session capture: the sweep's log is written next to the CSVs.

Failures are classified as in the JAX package: ``error:model`` (a load
or dispatch exception: the model's rows are NaN) and ``error:numerics``
(rows whose readouts fail ``guard.numerics.check_values`` are
quarantined: cell identity kept, measurement fields nulled), counted in
``GuardStats``. Every scored prompt feeds a ``ThroughputMeter``.
"""

from __future__ import annotations

import dataclasses
import gc
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..data import schemas
from ..data.prompts import (
    WORD_MEANING_QUESTIONS,
    format_baichuan_prompt,
    format_base_prompt,
    format_instruct_direct,
    format_instruct_prompt,
)
from ..guard import numerics
from ..models.quant import QuantTensor
from ..utils.logging import get_logger, save_captured_output, start_capture
from ..utils.profiling import (GuardStats, ThroughputMeter,
                               device_memory_stats, scoring_step_flops)
from . import hbm
from .fleet import ModelFleet
from .runner import ScoringEngine
from .sweep import run_word_meaning_sweep

log = get_logger(__name__)

# Model-level failure status prefix (vs error:numerics for row-level
# quarantine) — guard/numerics owns the numerics spelling.
MODEL_ERROR = "error:model"

# An engine factory returns a ready ScoringEngine for a model name
# (models.factory.engine_factory); the fleet owns its weights afterwards.
EngineFactory = Callable[[str], ScoringEngine]


@dataclasses.dataclass
class ModelSpec:
    """One model in a sweep."""

    name: str
    base_or_instruct: str  # "base" | "instruct"

    @property
    def is_base(self) -> bool:
        return self.base_or_instruct == "base"


def nan_rows_for_model(
    spec: ModelSpec, questions: Sequence[str]
) -> List[schemas.ScoreRow]:
    """NaN fallback rows — one bad model must not abort the sweep
    (compare_base_vs_instruct.py:482-492)."""
    return [
        schemas.ScoreRow(
            prompt=q, model=spec.name, base_or_instruct=spec.base_or_instruct,
            model_output="ERROR", yes_prob=float("nan"),
            no_prob=float("nan"), yes_no_found=False,
        )
        for q in questions
    ]


def format_for(spec: ModelSpec, sweep_kind: str = "base_vs_instruct"
               ) -> Callable[[str], str]:
    """C14 prompt-formatter routing.

    ``base_vs_instruct`` (D1 semantics, compare_base_vs_instruct.py:462-463):
    base models (plus bloom-7b1) get the few-shot 'Question:/Answer:'
    scaffold; instruct models get the few-shot prefix + bare question.
    ``instruct_only`` (D2 semantics, compare_instruct_models.py:488-492):
    bare question, with the Baichuan chat template special case.
    """
    if sweep_kind == "instruct_only":
        if "baichuan" in spec.name.lower():
            return format_baichuan_prompt
        return format_instruct_direct
    if spec.is_base or spec.name.lower() == "bigscience/bloom-7b1":
        return format_base_prompt
    return format_instruct_prompt


def _quarantine_rows(rows: List[schemas.ScoreRow],
                     guard: GuardStats) -> Tuple[List[schemas.ScoreRow], int]:
    """Row-level numerics boundary: every scored row's readouts are
    validated; offenders keep their cell identity with measurement fields
    nulled and count as ``error:numerics`` quarantines."""
    out: List[schemas.ScoreRow] = []
    n_bad = 0
    for r in rows:
        guard.site("checked", "multi")
        reason = numerics.check_values(r.yes_prob, r.no_prob)
        if reason is None:
            out.append(r)
            continue
        n_bad += 1
        guard.quarantine("multi", reason)
        log.warning("numerics guard: quarantined %s row %r (%s)",
                    r.model, r.prompt[:60], reason)
        out.append(dataclasses.replace(
            r, model_output="ERROR", yes_prob=float("nan"),
            no_prob=float("nan"), yes_no_found=False))
    return out, n_bad


def _release() -> None:
    """Return a released model's device memory (C15)."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _score_model(spec: ModelSpec, engine: ScoringEngine,
                 questions: Sequence[str], sweep_kind: str,
                 meter: ThroughputMeter, guard: GuardStats):
    """One model's rows and its ``per_model`` entry."""
    fmt = format_for(spec, sweep_kind)
    with meter.measure():
        rows = run_word_meaning_sweep(
            engine, spec.name, spec.base_or_instruct, questions, fmt)
    rows, n_quarantined = _quarantine_rows(rows, guard)
    # Token accounting — the counters the reference priced into dollars
    # (perturb_prompts.py:1021-1066) feed throughput here.
    tokens_in = sum(len(engine.tokenizer(fmt(q)).input_ids)
                    for q in questions)
    # The FLOP count and the int8 probe are the decoder's: an
    # encoder-decoder model adds no FLOPs (it only dilutes the implied
    # MFU downward), as in the JAX package.
    flops = 0.0
    if not engine.encoder_decoder:
        flops = len(rows) * scoring_step_flops(
            engine.cfg, 1, max(tokens_in // max(len(rows), 1), 1),
            engine.rt.max_new_tokens)
        meter.int8_dots = meter.int8_dots or any(
            isinstance(w, QuantTensor) and w.dynamic
            for w in engine.params["layers"].values())
    meter.add(len(rows), tokens_in=tokens_in,
              tokens_out=len(rows) * engine.rt.max_new_tokens, flops=flops)
    n_found = sum(r.yes_no_found for r in rows)
    entry = {
        "rows": len(rows),
        "yes_no_found": n_found,
        "status": ("ok" if n_quarantined == 0 else
                   f"{numerics.NUMERICS_ERROR} — {n_quarantined} "
                   f"row(s) quarantined"),
        "rows_quarantined": n_quarantined,
    }
    log.info("%s: %d rows, yes/no found in %d", spec.name, len(rows), n_found)
    return rows, entry


def run_model_comparison_sweep(
    specs: Sequence[ModelSpec],
    engine_factory: EngineFactory,
    out_dir: Path,
    questions: Sequence[str] = WORD_MEANING_QUESTIONS,
    write_base_csv: bool = True,
    write_instruct_csv: bool = True,
    sweep_kind: str = "base_vs_instruct",
    fleet: Optional[ModelFleet] = None,
    weight_prefetch: bool = True,
    weight_cache_bytes: Optional[int] = None,
) -> Dict[str, object]:
    """Sweep every model over the word-meaning questions, producing the
    D1 and/or D2 CSVs, throughput and guard counters, and
    ``sweep_session_log.txt`` in ``out_dir``.

    The sweep runs through the fleet (engine/fleet.py): model i+1's
    weights load in the background while model i scores
    (``weight_prefetch``), co-resident models stay cached inside
    ``weight_cache_bytes``, and every model's rows are bitwise a
    standalone engine's (weights are moved, never transformed). Pass
    ``fleet`` to reuse its residency and staging across sweeps;
    otherwise one is built from ``engine_factory`` for this call and
    emptied at its end.

    ``weight_cache_bytes=None`` is the JAX package's unbounded cache
    where the device's memory is not governed (the CPU). On a card it
    would keep every swept model until the card is full, so there the
    sweep's own fleet drops each model once its rows are in: only the
    model scoring and the one prefetched are resident, as in the loop
    before the fleet (one model at a time) plus the prefetch.

    Returns the JAX function's artifacts: ``per_model`` (rows, yes/no
    found, status per model), ``throughput``, ``fleet`` (FleetStats),
    ``guard`` and the written records under ``model_comparison_csv`` /
    ``instruct_comparison_csv``."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    capture = start_capture()
    meter = ThroughputMeter()
    guard = GuardStats()
    all_rows: List[schemas.ScoreRow] = []
    per_model: Dict[str, Dict[str, object]] = {}

    own_fleet = fleet is None
    if own_fleet:
        fleet = ModelFleet.from_factory(
            engine_factory, [], prefetch=weight_prefetch,
            cache_budget_bytes=weight_cache_bytes,
            # A comparison sweep visits each model once: a host copy for
            # reloads that never happen would only take host memory.
            stage_reloads=False)
    known = set(fleet.model_ids)
    for spec in specs:
        if spec.name not in known:
            fleet.add_model(spec.name, make_engine=engine_factory)
            known.add(spec.name)

    for i, spec in enumerate(specs):
        log.info("=== %s (%s) ===", spec.name, spec.base_or_instruct)
        acquired = False
        draft_id = None
        engine = None
        try:
            engine = fleet.acquire(spec.name)
            acquired = True
            # Fleet drafting: a co-resident model drafts for this
            # verifier, both refcounts held for the model's dispatches.
            draft_id = fleet.acquire_spec_draft(engine, spec.name)
            if i + 1 < len(specs):
                # The prefetch pipeline: the next model loads on the
                # worker while this one's dispatches run.
                fleet.prefetch(specs[i + 1].name)
            rows, per_model[spec.name] = _score_model(
                spec, engine, questions, sweep_kind, meter, guard)
        except Exception as exc:
            log.error("Model %s failed: %s — emitting NaN rows", spec.name, exc)
            guard.quarantine("multi", MODEL_ERROR)
            rows = nan_rows_for_model(spec, questions)
            per_model[spec.name] = {"rows": len(rows),
                                    "status": f"{MODEL_ERROR}: {exc}"}
        finally:
            # Drop this dispatch stream's reference; the LRU cache
            # decides whether the model stays resident, unless the cache
            # is unbounded on a governed device.
            if acquired:
                fleet.release_spec_draft(engine, draft_id)
                fleet.release(spec.name)
                if (own_fleet and weight_cache_bytes is None
                        and fleet.resident(spec.name)
                        and hbm.device_budget_bytes(
                            device=engine.device) is not None):
                    fleet.cache.drop(spec.name)
            del engine
        all_rows.extend(rows)
        mem = device_memory_stats()
        if mem:
            log.info("device memory: %s", mem)
    fleet_summary = fleet.stats.summary()
    if own_fleet:
        fleet.shutdown()
        fleet.drop_all()
        del fleet
        _release()

    artifacts: Dict[str, object] = {"per_model": per_model,
                                    "throughput": meter.summary(),
                                    "fleet": fleet_summary,
                                    "guard": guard.summary()}
    log.info("fleet: %s", artifacts["fleet"])
    if write_base_csv:
        # D1 holds every swept model, base and instruct alike.
        artifacts["model_comparison_csv"] = schemas.write_model_comparison_csv(
            all_rows, out_dir / "model_comparison_results.csv")
    if write_instruct_csv:
        instruct_rows = [r for r in all_rows if r.base_or_instruct == "instruct"]
        if instruct_rows:
            artifacts["instruct_comparison_csv"] = (
                schemas.write_instruct_comparison_csv(
                    instruct_rows,
                    out_dir / "instruct_model_comparison_results.csv"))

    log.info("Sweep throughput: %s", meter.summary())
    save_captured_output(capture, out_dir / "sweep_session_log.txt")
    return artifacts


def base_instruct_pairs(
    pairs: Sequence[Tuple[str, str]]
) -> List[ModelSpec]:
    """Expand (base, instruct) repo-id pairs into a sweep order matching the
    reference's pair loop (compare_base_vs_instruct.py:136-180)."""
    specs: List[ModelSpec] = []
    for base, instruct in pairs:
        specs.append(ModelSpec(base, "base"))
        specs.append(ModelSpec(instruct, "instruct"))
    return specs
