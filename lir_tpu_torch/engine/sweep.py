"""Sweep drivers: the word-meaning model comparison (D1/D2 rows) and the
perturbation grid (D6 rows), with manifest resume and periodic
checkpoints.

Port of ``lir_tpu/engine/sweep.py``, replacing the reference's two
orchestration bodies: compare_base_vs_instruct.py:386-550 /
compare_instruct_models.py:376-566 (sequential per-prompt GPU loops, here
one batched decode per bucket) and perturb_prompts.py:551-726,917-1066
(OpenAI Batch upload/poll/decode, here local batched scoring with the
checkpoint-every-100-rows and done-set resume semantics kept,
perturb_prompts.py:975-984,161-188).

The perturbation sweep routes as the JAX sweep does, with its
streaming-statistics sink (``engine/stream_stats.py``: every dispatch
folds its readouts into a device lattice, checkpointed beside the CSV
as ``<stem>.accum.npz``, its bootstrap seed recorded in the manifest)
and its numerics guard (a row whose readouts fail
``guard.numerics.check_values`` is written quarantined as
``error:numerics``), with the cross-request prefix cache when the
engine has one (the planner's cached-token pricing, paged dispatches,
completion tails recorded for the tree's drafts), with its piggyback chains
(runs of consecutive same-shape shared dispatches without a cascade
trunk ride one another's engine calls, ``ScoringEngine.
decode_fused_shared_piggy``; a failed chain call falls back to the
plain dispatch of both batches), with its dispatch recovery
(:func:`_dispatch_with_recovery`: every dispatch under the engine's
watchdog, a failed one retried after ``ScoringEngine.
reset_dispatch_state``, an out-of-memory one after the governor's
reclaim), and with these of its engine features off, which the port
does not have yet: multihost shards and leases, and the XLA compile
plan (which has no counterpart in eager PyTorch). The
reasoning mode (``reasoning=True``) samples each cell's binary prompt
``reasoning_runs`` times on ``generate.sample_decode`` and writes
count-fraction rows.
"""

from __future__ import annotations

import collections
import json
import logging
import queue
import re
import threading
import time
from pathlib import Path
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..config import RetryConfig
from ..data import schemas
from ..data.prompts import LegalPrompt
from ..guard import numerics
from ..guard.watchdog import EnginePoisoned
from ..ops import _build
from ..utils.manifest import SweepManifest
from ..utils.profiling import OccupancyStats, StreamStats, is_oom_error
from ..utils.retry import retry_with_exponential_backoff
from . import generate
from . import hbm
from . import grid as grid_mod
from . import prng
from . import scheduler as sched_mod
from . import score as score_mod
from . import stream_stats as stream_mod
from . import tokens as tok
from .runner import PiggybackIneligible, ScoringEngine, _tail_batch

log = logging.getLogger(__name__)

CHECKPOINT_EVERY = 100  # rows, perturb_prompts.py:975-984

# Dispatch recovery policy of the offline sweep: a transient fault (or
# an injected one, faults/) costs a short full-jitter retry window, not
# the sweep. Brief on purpose: the sweep resumes from its manifest, so a
# persistent outage should fail fast into the operator's restart.
DISPATCH_RETRY = RetryConfig(max_retries=3, initial_delay=0.05,
                             max_delay=1.0, backoff_factor=2.0,
                             full_jitter=True, max_elapsed=30.0)


def _watched(engine, call, cost=None, stamp=None):
    """``call()`` under the engine's dispatch watchdog (site "sweep",
    ``cost`` the dispatch's ``scheduler.bucket_cost`` price), so that its
    deadline covers the device work and not only the enqueue. On the
    card the call ends with an event recorded on the dispatch's own
    stream (the worker runs on the caller's current stream; never a
    device-wide synchronize, which would also wait on the fleet's
    prefetch stream and the writer's copies):

    - with ``stamp`` (a dict), the call returns once enqueued and puts
      (event, start, builds at start, cost) in ``stamp["v"]``; the
      pipeline's writer waits for the event under the deadline
      (``DispatchWatchdog.watch_device``), so the main thread plans the
      next dispatch while the card runs this one;
    - without, the call waits for the event itself.

    With the watchdog off nothing waits. The engine ticks its governor
    itself, once a dispatch (no tick here)."""
    wd = engine.watchdog
    if not wd.enabled:
        return call()
    if engine.device.type != "cuda":
        return wd.watch(call, cost=cost, site="sweep")

    def enqueued():
        t0, built0 = time.monotonic(), _build.build_seconds()
        out = call()
        done = torch.cuda.Event()
        done.record()
        if stamp is None:
            done.synchronize()
        else:
            stamp["v"] = (done, t0, built0, cost)
        return out

    return wd.watch(enqueued, cost=cost, site="sweep",
                    calibrate=stamp is None)


def _dispatch_with_recovery(engine, call, cost=None, stamp=None):
    """One device dispatch with the sweep's recovery (the JAX sweep's
    ``_dispatch_with_recovery``). The call runs under the watchdog
    (:func:`_watched`), so a hang surfaces DispatchStalled here after
    one deadline. On failure, first the abandoned call of a stall must
    leave the engine (``DispatchWatchdog.settle``; an engine it still
    holds after the grace raises ``EnginePoisoned`` out of the sweep, as
    does any later retry that finds one), then:

    - an out-of-memory error (``profiling.is_oom_error``: a
      ``torch.cuda.OutOfMemoryError`` or the JAX package's texts) goes
      to the governor's ``handle_oom``, which force-engages the reclaim
      rungs; when that freed anything the dispatch is retried ONCE, and
      a second out-of-memory error raises ``hbm.HbmExhausted`` with the
      ledger's arithmetic. Nothing freed re-raises the error;
    - any other error resets what the failed dispatch may have left
      (``ScoringEngine.reset_dispatch_state``) and retries under
      DISPATCH_RETRY, counting ``fault_stats.recovered_dispatches``.

    KeyboardInterrupt, SystemExit and injected preemptions
    (BaseException) always propagate: recovery outlives faults, not
    kills."""

    def watched():
        return _watched(engine, call, cost, stamp)

    try:
        return watched()
    except (KeyboardInterrupt, SystemExit, EnginePoisoned):
        raise
    except Exception as err:  # noqa: BLE001 — retried below
        engine.watchdog.settle()
        gov = engine.governor
        if is_oom_error(err):
            if gov.handle_oom("sweep"):
                log.warning("sweep dispatch OOMed (%r); governor "
                            "reclaimed — retrying once", err)
                try:
                    return watched()
                except (KeyboardInterrupt, SystemExit, EnginePoisoned):
                    raise
                except Exception as err2:  # noqa: BLE001
                    if is_oom_error(err2):
                        gov.stats.count("oom_exhausted")
                        raise hbm.HbmExhausted(
                            gov.oom_message("sweep", err2)) from err2
                    raise
            raise
        log.warning("sweep dispatch failed (%r); resetting the engine's "
                    "dispatch state and retrying", err)
        engine.reset_dispatch_state()
        out = retry_with_exponential_backoff(
            watched, retry_on=(Exception,), config=DISPATCH_RETRY,
            log=lambda m: log.warning("sweep dispatch retry: %s", m),
            give_up_on=(EnginePoisoned,))
        engine.fault_stats.count("recovered_dispatches")
        return out


def run_word_meaning_sweep(
    engine: ScoringEngine, model_name: str, base_or_instruct: str,
    questions: Sequence[str], format_prompt: Callable[[str], str],
) -> List[schemas.ScoreRow]:
    """Score the word-meaning questions for one model -> D1/D2 rows.

    ``format_prompt`` is the C14 formatter (few-shot for base models, direct
    for instruct — compare_base_vs_instruct.py:462-463)."""
    prompts = [format_prompt(q) for q in questions]
    # Each batch under the dispatch recovery and its watchdog (the JAX
    # sweep calls score_prompts bare): a hung batch costs one deadline.
    results = engine.score_prompts(
        prompts, dispatch=lambda call: _dispatch_with_recovery(engine, call))
    rows = []
    for q, r in zip(questions, results):
        rows.append(schemas.ScoreRow(
            prompt=q, model=model_name, base_or_instruct=base_or_instruct,
            model_output=r.completion, yes_prob=r.yes_prob, no_prob=r.no_prob,
            position_found=r.position_found, yes_no_found=r.yes_no_found))
    return rows


def _parse_confidence(text: str, complete: bool = True) -> Optional[int]:
    """First integer in the response (perturb_prompts.py:500-502).

    ``complete=False`` marks a decode that hit its token budget without
    emitting EOS: an integer whose digits touch the end of such text may be
    cut mid-number ("...about 85" truncated to "...about 8"), so it is
    rejected (None) rather than silently recorded wrong. An integer followed
    by more text is always safe.

    The prompt asks for a confidence in [0, 100]; an integer outside that
    range (a year, a policy number) is model noise, not a confidence, and
    is rejected (None), as is no integer at all.
    """
    m = re.search(r"\b(\d+)\b", text)
    if m is None:
        return None
    if not complete and m.end() == len(text.rstrip()):
        return None
    try:
        val = int(m.group(1))
    except ValueError:
        return None
    if not 0 <= val <= 100:
        return None
    return val


def _decode_complete(generated_row: np.ndarray, eos_id) -> bool:
    """True when the fixed-length decode emitted EOS (the reply finished
    inside the budget). Tokenizers without EOS can't signal completion;
    treat their output as complete (legacy behavior)."""
    if eos_id is None:
        return True
    return bool(np.any(np.asarray(generated_row) == eos_id))


def _steps_used(gen_row: np.ndarray, eos_id) -> int:
    """Decode steps a row actually used: up to and including its first
    EOS (stopped rows emit EOS fill afterwards), else the full budget."""
    hits = np.flatnonzero(np.asarray(gen_row) == eos_id)
    return int(hits[0]) + 1 if hits.size else int(len(gen_row))


def run_perturbation_sweep(
    engine: ScoringEngine, model_name: str,
    prompts: Sequence[LegalPrompt], perturbations: Sequence[Sequence[str]],
    results_path: Path, manifest: Optional[SweepManifest] = None,
    subset_size: Optional[int] = None, seed: int = 42,
    checkpoint_every: int = CHECKPOINT_EVERY,
    reasoning: bool = False, reasoning_runs: int = 10,
) -> List[schemas.PerturbationRow]:
    """Run (or resume) the perturbation grid for one model, writing D6 rows
    to ``results_path`` (CSV: schemas.resolve_results_path) and returning
    the rows scored by this call.

    Readout parity with the API backend (perturb_prompts.py:474-526):
    Token_1/2_Prob come from the FIRST generated position (the exact
    softmax probability of each target's first token); 'Log
    Probabilities' stores the top-20 (token_id -> logprob) map; the
    confidence value is the first integer of the decoded confidence
    response, and Weighted Confidence is E[v] over the integer tokens in
    [0, 100] at the first confidence position.

    An encoder-decoder engine takes no streaming sink and no ragged plan,
    and its first dispatch raises (the shared dispatch is decoder-only),
    before any row is written: the JAX sweep fails there too (ROADMAP
    caveat R7).

    ``reasoning=True`` is the local reasoning-model mode (REASONING_MODEL_
    RUNS, perturb_prompts.py:47,412-446): each binary prompt is sampled
    ``reasoning_runs`` times and Token_i_Prob becomes the answer-count
    fraction (``ScoringEngine.score_prompts_sampled``); Weighted
    Confidence equals the parsed confidence integer (:459-464) and no
    log-prob map is stored. It takes no streaming sink, and each row's
    draws are keyed by its grid cell (:func:`_reasoning_batch`)."""
    results_path = schemas.resolve_results_path(results_path)
    # Crash-consistent resume: the done-set is the UNION of the manifest
    # and the rows already in the results artifact. The flush order is
    # results-append THEN manifest-mark, so a kill between the two leaves
    # rows only the results file knows about. (An EMPTY explicit manifest
    # is falsy: test None explicitly.)
    if manifest is None:
        manifest = SweepManifest.from_existing_results(
            results_path.with_suffix(".manifest.jsonl"), results_path,
            grid_mod.RESUME_KEY_FIELDS,
            column_map=grid_mod.RESUME_COLUMN_MAP)
    engine.occupancy = None  # set by _run_pipelined's ragged planner
    cells = grid_mod.build_grid(model_name, prompts, perturbations)
    cells = grid_mod.random_subset(cells, subset_size, seed)
    todo = grid_mod.pending_cells(cells, manifest)
    log.info("%s: %d/%d grid cells pending", model_name, len(todo), len(cells))

    # Streaming statistics (engine/stream_stats.py): a device lattice
    # every dispatch folds its readouts into with one launch — grid ->
    # percentile/kappa/bootstrap-CI estimates without rows through the
    # host. The bootstrap seed is recorded in the manifest on the first
    # run and read back on resume; the lattice checkpoints at every
    # flush (atomic write) and is re-seeded from that checkpoint, re-folds
    # of already-dispatched rows being idempotent by slot.
    sink = None
    accum_path = None
    write_rows = True
    if (engine.rt.streaming_stats and not reasoning
            and not engine.encoder_decoder and cells):
        n_reph = 1 + max(c.rephrase_idx for c in cells)
        stream_seed = manifest.meta.get("stream_seed")
        if stream_seed is None:
            stream_seed = int(seed)
            manifest.set_meta("stream_seed", stream_seed)
        sink = stream_mod.StreamSink(
            len(prompts), n_reph, int(stream_seed),
            guard=engine.rt.numerics_guard, stats=StreamStats(),
            device=engine.device)
        accum_path = results_path.with_suffix(stream_mod.ACCUM_SUFFIX)
        if len(manifest) and accum_path.exists() and sink.load(accum_path):
            log.info("streaming stats: resumed accumulator from %s "
                     "(%d rows already folded)", accum_path,
                     sink.snapshot().rows_folded)
        write_rows = bool(engine.rt.row_artifact)
    engine.stream_sink = sink

    # Pre-resolve per-prompt target token ids once (SURVEY §7 hard part 1).
    target_ids = {pi: tok.target_token_ids(
        engine.tokenizer, p.target_tokens,
        encoder_decoder=engine.encoder_decoder)
        for pi, p in enumerate(prompts)}

    rows: List[schemas.PerturbationRow] = []
    pending_rows: List[schemas.PerturbationRow] = []
    checkpoint_every = max(1, checkpoint_every)
    # Only position 0 feeds the D6 readouts; decode just enough tokens for
    # the confidence integer / leading response text unless full-completion
    # parity is requested (config.RuntimeConfig.sweep_decode_tokens).
    rt = engine.rt
    new_tokens = (rt.max_new_tokens if rt.sweep_full_completions
                  else min(rt.sweep_decode_tokens, rt.max_new_tokens))
    conf_tokens = (rt.max_new_tokens if rt.sweep_full_completions
                   else min(rt.sweep_confidence_tokens, rt.max_new_tokens))
    if reasoning:
        # Chain-of-thought models answer after their reasoning: every
        # sampled run gets the full max_new_tokens (the sweep budgets
        # above are not used).
        B = rt.batch_size
        for start in range(0, len(todo), B):
            batch = todo[start:start + B]
            n = len(batch)
            bsz = B if n == B else _tail_batch(n, B)
            full = list(batch) + [batch[-1]] * (bsz - n)
            _reasoning_batch(engine, model_name, prompts, batch, full, seed,
                             reasoning_runs, pending_rows, rows)
            if len(pending_rows) >= checkpoint_every:
                _flush(pending_rows, results_path, manifest)
                pending_rows = []
        if pending_rows:
            _flush(pending_rows, results_path, manifest)
        return rows
    _run_pipelined(engine, model_name, todo, target_ids, results_path,
                   manifest, checkpoint_every, new_tokens, conf_tokens, rows,
                   pending_rows, sink, accum_path, write_rows)
    engine.spec_flush()
    if engine.kernel_stats.counters:
        log.info("piggyback chains: %s",
                 json.dumps(engine.kernel_stats.counters))
    if engine.spec_stats.get("spec_dispatches"):
        log.info("speculative decode: %s", json.dumps(dict(engine.spec_stats)))
    if engine.prefix_cache is not None:
        log.info("prefix cache: %s", json.dumps(engine.prefix_stats.summary()))
    if engine.guard_stats.quarantined or engine.guard_stats.stalls:
        log.info("guard: %s", json.dumps(engine.guard_stats.summary()))
    if engine.fault_stats.recovered_dispatches:
        log.info("fault recovery: %s",
                 json.dumps(engine.fault_stats.summary()))
    if sink is not None:
        # Cheap finalize (counts + kappa; CIs on demand through
        # sink.finalize(n_boot=...)): the live-estimate readout.
        final = sink.finalize(n_boot=0)
        log.info("streaming stats: %d rows folded on device, kappa=%.4f; "
                 "counters: %s", final["rows_folded"],
                 final["kappa"]["kappa"], json.dumps(sink.stats.summary()))
    if pending_rows:
        _flush(pending_rows, results_path, manifest, sink=sink,
               accum_path=accum_path)
    return rows


def _plan_ragged(engine, todo, new_tokens, conf_tokens):
    """Tokenize the pending grid ONCE and plan every dispatch through the
    ragged scheduler (bucket ladder + slot refill + prefix groups). The
    occupancy counters hang off ``engine.occupancy``."""
    with engine._tok_lock:
        bin_ids = [engine.tokenizer(c.binary_prompt).input_ids for c in todo]
        conf_ids = [engine.tokenizer(c.confidence_prompt).input_ids
                    for c in todo]
    items = sched_mod.build_items(bin_ids, conf_ids, todo)
    stats = OccupancyStats()
    max_extent = (engine.cfg.max_seq_len
                  if getattr(engine.cfg, "pos_embedding", None) == "learned"
                  else None)
    # Prefix-aware slot-refill pricing: with the prefix cache built,
    # cached-prefix tokens are free prefill, and a promoted tail abandons
    # this bucket's namespace (the probe reads the tree on this thread,
    # its owner).
    cached_probe = None
    if engine.prefix_cache is not None:
        cached_probe = (lambda it, b: engine.prefix_cache.match_len(
            b, it.bin_ids[:it.lcp]))
    planner = sched_mod.RaggedScheduler(
        engine.buckets, engine.rt.batch_size,
        new_budget=max(new_tokens, conf_tokens),
        decode_cost=new_tokens + conf_tokens, max_extent=max_extent,
        min_group_prefix=engine.rt.sweep_group_min_prefix,
        min_group_cells=engine.rt.sweep_group_min_cells,
        group_cells=engine.rt.sweep_group_min_cells > 0,
        cached_probe=cached_probe,
        fused_decode=engine.rt.fused_decode,
        stats=stats)
    dispatches = planner.schedule(items)
    engine.occupancy = stats
    log.info(
        "ragged schedule: %d cells -> %d dispatches over buckets %s "
        "(occupancy %.1f%%, padding waste %.1f%%, refilled %d, "
        "grouped %d)", len(todo), len(dispatches),
        sorted({d.bucket for d in dispatches}), stats.occupancy_pct,
        stats.padding_waste_pct,
        sum(b.refilled for b in stats.buckets.values()),
        stats.grouped_cells)
    return dispatches, stats


def chain_keys(engine, dispatches, batch_size: int) -> list:
    """Each planned dispatch's piggyback key: (bucket, padded rows, suffix
    buckets) for a shared dispatch without a cascade trunk, None for a
    grouped one or one that takes the cascade (two None keys never
    chain). Consecutive dispatches with one key chain."""
    keys = []
    for d in dispatches:
        key = None
        if d.kind == "shared":
            n = len(d.items)
            trunk = engine.cascade_trunk_for(
                [it.bin_ids[:it.lcp] for it in d.items], n, d.bucket)
            if not trunk:
                key = (d.bucket, batch_size if n == batch_size
                       else _tail_batch(n, batch_size),
                       d.sfx_bucket_a, d.sfx_bucket_b)
        keys.append(key)
    return keys


def _run_pipelined(engine, model_name, todo, target_ids, results_path,
                   manifest, checkpoint_every, new_tokens, conf_tokens,
                   rows, pending_rows, sink=None, accum_path=None,
                   write_rows=True) -> None:
    """The sweep loop, pipelined over a writer thread.

    - MAIN thread: plan (ragged) or batch in todo order (legacy), and
      dispatch each batch's binary and confidence decodes, then the
      sink's fold of its readouts; CUDA work is queued on the stream,
      and the result tensors go to the writer.
    - WRITER thread: copy a batch's outputs to the host (``.cpu()``
      waits for the device), check each row's readouts with the
      numerics guard, decode completion text, build D6 rows, and run
      the checkpoint flushes (the sink's lattice first, so stream order
      makes every checkpoint a superset of the rows it flushes). With
      ``write_rows`` False (streaming only), nothing is copied: the
      writer marks the batch's cells done after a lattice checkpoint.

    The radix tree of the prefix cache (``engine.prefix_cache``) is
    owned by the MAIN thread: its dispatches look pages up, insert and
    evict there. The JAX sweep records each drained shared dispatch's
    completions into the tree from its row drain; here the writer only
    hands its host copies back (``tails``), and the main thread records
    them, in dispatch order, before it plans each dispatch and once more
    after the writer has joined — the same tails in the same order, and
    no writer touches the tree while the main thread plans against it.

    The queue is bounded (depth 2), so at most ~3 batches of decode
    outputs are alive on the device, each referenced until its copy is
    drained. Row order is dispatch order. A writer failure stops the
    producer at the next batch boundary and re-raises on the caller's
    thread; rows scored but not yet flushed are NOT marked done, so a
    resumed sweep re-scores at most ``checkpoint_every`` cells.
    """
    B = engine.rt.batch_size
    fused_dec = engine.rt.fused_decode
    work_q: "queue.Queue" = queue.Queue(maxsize=2)
    failed = threading.Event()
    writer_err: List[BaseException] = []
    early_stop = (engine.rt.sweep_early_stop
                  and not engine.rt.sweep_full_completions)
    ragged = bool(engine.rt.ragged_scheduler and todo
                  and not engine.encoder_decoder)
    occupancy = None
    stop_armed = False
    if ragged:
        dispatches, occupancy = _plan_ragged(engine, todo, new_tokens,
                                             conf_tokens)
        stop_armed = early_stop and engine.digit_stop_mask is not None

    def _targets(cells):
        t1 = np.asarray([target_ids[c.prompt_idx][0] for c in cells], np.int32)
        t2 = np.asarray([target_ids[c.prompt_idx][1] for c in cells], np.int32)
        return t1, t2

    # Completion tails for the tree's drafts: (bucket, binary ids, binary
    # generated, confidence ids, confidence generated, real rows), put by
    # the writer, recorded by the main thread (see the docstring).
    record = engine.spec_supported() and engine.prefix_cache is not None
    tails: "collections.deque" = collections.deque()

    def _record_tails():
        while tails:
            bucket, b_ids, gen, c_ids, cgen, n = tails.popleft()
            engine.spec_record(bucket, b_ids, gen, n)
            engine.spec_record(bucket, c_ids, cgen, n)

    def _emit(batch, fused, cfused, t1, t2, spec_rec=None, stamp=None):
        """Readout, the sink's fold (on this thread, on the dispatch's
        stream; pad rows past ``batch`` drop), then the writer, with the
        watched dispatch's ``stamp`` (its device work's deadline)."""
        res = score_mod.readout_from_fused(
            fused, engine._t(t1), engine._t(t2), scan_positions=1)
        if sink is not None:
            sink.fold(res.yes_prob, res.no_prob, cfused.weighted_confidence,
                      fused.topk_logprobs, batch)
        work_q.put((batch, fused, res, cfused, spec_rec,
                    (stamp or {}).get("v")))

    # Streaming-only manifest marks (no rows to key them off). The
    # lattice checkpoints FIRST, then the cells are marked done: a crash
    # between the two re-dispatches cells whose folds are already
    # (idempotently) in the checkpoint, and never marks a cell done that
    # the lattice lost.
    pending_marks: List[dict] = []

    def _flush_marks():
        sink.checkpoint(accum_path)
        manifest.mark_done_many(pending_marks)
        log.info("checkpoint: +%d rows (streaming-only) -> %s",
                 len(pending_marks), accum_path)
        del pending_marks[:]

    def _drain(batch, fused, res, cfused, spec_rec, device_work):
        if device_work is not None:
            # The dispatch's device work under its watchdog deadline; a
            # stall fails the sweep (the card never gives it back).
            engine.watchdog.watch_device(*device_work, site="sweep")
        if not write_rows:
            # Streaming only: no per-row payload is copied to the host;
            # the bytes the CSV path would have copied are counted.
            sink.note_bytes_avoided(
                (fused.generated, fused.topk_logprobs, fused.topk_ids,
                 cfused.generated, cfused.weighted_confidence,
                 res.yes_prob, res.no_prob))
            pending_marks.extend(c.resume_record() for c in batch)
            if len(pending_marks) >= checkpoint_every:
                _flush_marks()
            return
        yes_p, no_p, lp_vals, lp_ids, gen_host, wconf, cgen_host = (
            t.cpu().numpy() for t in (
                res.yes_prob, res.no_prob, fused.topk_logprobs,
                fused.topk_ids, fused.generated, cfused.weighted_confidence,
                cfused.generated))
        if spec_rec is not None:
            b_ids, c_ids, rec_bucket, rec_n = spec_rec
            tails.append((rec_bucket, b_ids, gen_host, c_ids, cgen_host,
                          rec_n))
        if occupancy is not None and stop_armed:
            # Decode-step occupancy: rows retired by the early stop idle
            # until the batch's slowest row (profiling.OccupancyStats).
            for j in range(len(batch)):
                occupancy.add_decode(_steps_used(gen_host[j], engine.eos_id),
                                     int(gen_host.shape[1]))
                occupancy.add_decode(_steps_used(cgen_host[j], engine.eos_id),
                                     int(cgen_host.shape[1]))
        for j, cell in enumerate(batch):
            t1p, t2p, wc = float(yes_p[j]), float(no_p[j]), float(wconf[j])
            # Numerics guard: the readouts are checked BEFORE they become
            # a row. A corrupt row (NaN/Inf logits, an insane
            # renormalization) is written quarantined with its cell
            # identity and every measurement field nulled, instead of
            # landing in the CSV as plausible-looking numbers.
            reason = None
            if engine.rt.numerics_guard:
                engine.guard_stats.site("checked", "sweep")
                reason = numerics.check_values(t1p, t2p, wc, lp_vals[j])
            if reason is not None:
                engine.guard_stats.quarantine("sweep", reason)
                log.warning("numerics guard: quarantined cell %r (%s)",
                            cell.rephrased_main[:40], reason)
                row = schemas.PerturbationRow(
                    model=model_name,
                    original_main=cell.original_main,
                    response_format=cell.response_format,
                    confidence_format=cell.confidence_format,
                    rephrased_main=cell.rephrased_main,
                    full_rephrased_prompt=cell.binary_prompt,
                    full_confidence_prompt=cell.confidence_prompt,
                    model_response=numerics.NUMERICS_ERROR,
                    model_confidence_response=(
                        f"{numerics.NUMERICS_ERROR} — {reason} "
                        f"(row quarantined by the numerics guard)"),
                    log_probabilities="",
                    token_1_prob=None,
                    token_2_prob=None,
                    confidence_value=None,
                    weighted_confidence=None,
                )
                rows.append(row)
                pending_rows.append(row)
                continue
            completion = engine.decode_completion(gen_host[j])
            conf_text = engine.decode_completion(cgen_host[j])
            # A short confidence decode that never reached EOS may have cut
            # an integer mid-number; don't trust an end-of-text match then.
            conf_complete = (engine.rt.sweep_full_completions
                             or _decode_complete(cgen_host[j], engine.eos_id))
            logprob_map = {int(i): round(float(v), 6)
                           for i, v in zip(lp_ids[j], lp_vals[j])}
            row = schemas.PerturbationRow(
                model=model_name,
                original_main=cell.original_main,
                response_format=cell.response_format,
                confidence_format=cell.confidence_format,
                rephrased_main=cell.rephrased_main,
                full_rephrased_prompt=cell.binary_prompt,
                full_confidence_prompt=cell.confidence_prompt,
                model_response=completion,
                model_confidence_response=conf_text,
                log_probabilities=json.dumps(logprob_map),
                token_1_prob=t1p,
                token_2_prob=t2p,
                confidence_value=_parse_confidence(conf_text, conf_complete),
                weighted_confidence=wc,
            )
            rows.append(row)
            pending_rows.append(row)
        if len(pending_rows) >= checkpoint_every:
            _flush(pending_rows, results_path, manifest, sink=sink,
                   accum_path=accum_path)
            del pending_rows[:]

    def _writer():
        while True:
            item = work_q.get()
            if item is None:
                return
            if failed.is_set():
                continue        # drain remaining items to unblock the producer
            try:
                _drain(*item)
            except BaseException as e:      # noqa: BLE001 — re-raised below
                writer_err.append(e)
                failed.set()

    def _dispatch_legacy():
        for start in range(0, len(todo), B):
            if failed.is_set():
                return
            batch = todo[start:start + B]
            n = len(batch)
            # Tail batch: pad to the next power of two, not the full B.
            bsz = B if n == B else _tail_batch(n, B)
            full = list(batch) + [batch[-1]] * (bsz - n)
            # Both formats in ONE call: the binary and confidence prompts
            # share the rephrased legal text, prefilled once.
            t1, t2 = _targets(full)
            stamp: dict = {}
            fused, cfused = _dispatch_with_recovery(
                engine, lambda: engine.decode_fused_shared(
                    [c.binary_prompt for c in full],
                    [c.confidence_prompt for c in full],
                    t1, t2, new_tokens=new_tokens, conf_tokens=conf_tokens,
                    early_stop=early_stop),
                # Legacy batches pick their bucket inside the engine:
                # priced at the ladder's widest edge.
                cost=sched_mod.bucket_cost(bsz, max(engine.buckets), B,
                                           new_tokens + conf_tokens,
                                           fused_decode=fused_dec),
                stamp=stamp)
            _emit(batch, fused, cfused, t1, t2, stamp=stamp)

    # Piggyback chains: runs of CONSECUTIVE shared dispatches of one
    # shape (bucket queues drain same-shape batches back to back) chain
    # through the engine's piggyback path, each dispatch's engine call
    # running the PARKED decode loops of the one before it, then its own
    # prefill. Rows are the plain dispatch's; a failed call falls back
    # to the plain path for both dispatches (chain_keys gives the
    # shapes).
    use_piggy = ragged and engine.piggyback_supported()
    piggy_keys = chain_keys(engine, dispatches, B) if ragged else []
    pending: List[Optional[dict]] = [None]   # the parked dispatch's meta
    # The watchdog's prices (scheduler.bucket_cost, the planner's model):
    # a speculating engine at the verify-window floor. A cascade
    # dispatch is priced without its trunk discount (the engine finds
    # its trunk itself; the seed headroom covers the spread).
    spec_on = engine.spec_supported()

    def _shared_cost(meta):
        return sched_mod.bucket_cost(
            meta["n"], meta["bucket"], B, new_tokens + conf_tokens,
            fused_decode=fused_dec, spec_decode=spec_on)

    def _plain_shared(meta):
        full_items = meta["full_items"]
        stamp: dict = {}
        fused, cfused = _dispatch_with_recovery(
            engine, lambda: engine.decode_fused_shared(
                [it.cell.binary_prompt for it in full_items],
                [it.cell.confidence_prompt for it in full_items],
                meta["t1"], meta["t2"], new_tokens=new_tokens,
                conf_tokens=conf_tokens, early_stop=early_stop,
                pretokenized_a=[it.bin_ids for it in full_items],
                pretokenized_b=[it.conf_ids for it in full_items],
                bucket=meta["bucket"], sfx_buckets_ab=meta["sfx_ab"],
                reuse_cache=True, n_real=meta["n"]),
            cost=_shared_cost(meta), stamp=stamp)
        spec_rec = None
        if record:
            spec_rec = ([it.bin_ids for it in full_items],
                        [it.conf_ids for it in full_items],
                        meta["bucket"], meta["n"])
        _emit(meta["batch"], fused, cfused, meta["t1"], meta["t2"], spec_rec,
              stamp)

    def _redispatch_pending():
        """Broken chain: the parked dispatch is recomputed through the
        plain path, which owes nothing to the chain (once an abandoned
        chain call has left the engine)."""
        engine.watchdog.settle()
        meta, pending[0] = pending[0], None
        engine.piggy_abort()
        _plain_shared(meta)

    def _drain_pending():
        if pending[0] is None:
            return
        meta = pending[0]
        stamp: dict = {}
        try:
            fused, cfused = _watched(
                engine, lambda: engine.piggy_drain(meta["t1"], meta["t2"]),
                cost=sched_mod.decode_floor(meta["n"], B,
                                            new_tokens + conf_tokens,
                                            fused_decode=fused_dec),
                stamp=stamp)
        except (KeyboardInterrupt, SystemExit, EnginePoisoned):
            raise
        except BaseException as err:  # noqa: BLE001 — plain-path fallback
            log.warning("piggyback drain failed (%r); re-dispatching the "
                        "parked batch through the plain path", err)
            _redispatch_pending()
            return
        pending[0] = None
        _emit(meta["batch"], fused, cfused, meta["t1"], meta["t2"],
              stamp=stamp)

    def _dispatch_ragged():
        for i, d in enumerate(dispatches):
            if failed.is_set():
                return
            _record_tails()
            batch = d.cells
            n = len(d.items)
            if d.kind == "shared":
                bsz = B if n == B else _tail_batch(n, B)
                full_items = list(d.items) + [d.items[-1]] * (bsz - n)
                t1, t2 = _targets([it.cell for it in full_items])
                meta = dict(batch=batch, full_items=full_items, t1=t1, t2=t2,
                            bucket=d.bucket, n=n, key=piggy_keys[i],
                            sfx_ab=(d.sfx_bucket_a, d.sfx_bucket_b))
                # Chain iff the parked dispatch shares this shape, or this
                # dispatch opens a run the NEXT dispatch will ride.
                key = piggy_keys[i]
                chainable = use_piggy and key is not None and (
                    (pending[0] is not None and pending[0]["key"] == key)
                    or (pending[0] is None and i + 1 < len(dispatches)
                        and piggy_keys[i + 1] == key))
                if not chainable:
                    _drain_pending()
                    _plain_shared(meta)
                    continue
                prev = pending[0]
                cost = sched_mod.bucket_cost(
                    n, d.bucket, B, new_tokens + conf_tokens,
                    fused_decode=fused_dec)
                if prev is not None:
                    cost += sched_mod.decode_floor(
                        prev["n"], B, new_tokens + conf_tokens,
                        fused_decode=fused_dec)
                stamp: dict = {}
                try:
                    out = _watched(
                        engine, lambda: engine.decode_fused_shared_piggy(
                            [it.bin_ids for it in full_items],
                            [it.conf_ids for it in full_items], new_tokens,
                            conf_tokens, early_stop, d.bucket,
                            (d.sfx_bucket_a, d.sfx_bucket_b),
                            prev_yes=prev["t1"] if prev else None,
                            prev_no=prev["t2"] if prev else None), cost,
                        stamp)
                except PiggybackIneligible as err:
                    log.info("piggyback ineligible (%s); dispatching "
                             "plainly", err)
                    _drain_pending()
                    _plain_shared(meta)
                    continue
                except (KeyboardInterrupt, SystemExit, EnginePoisoned):
                    raise
                except BaseException as err:  # noqa: BLE001
                    log.warning("piggyback step failed (%r); falling back "
                                "to the plain path for both dispatches", err)
                    if pending[0] is not None:
                        _redispatch_pending()
                    else:
                        engine.watchdog.settle()
                        engine.piggy_abort()
                    _plain_shared(meta)
                    continue
                if out is not None:
                    _emit(prev["batch"], *out, prev["t1"], prev["t2"],
                          stamp=stamp)
                pending[0] = meta
                continue
            else:
                _drain_pending()   # grouped shapes never ride the chain
                t1, t2 = _targets(batch)
                stamp = {}
                out, m = _dispatch_with_recovery(
                    engine, lambda: engine.decode_fused_grouped(
                        d.groups, t1, t2, new_tokens, conf_tokens,
                        early_stop, d.bucket,
                        max(d.sfx_bucket_a, d.sfx_bucket_b),
                        reuse_cache=True),
                    # Grouped dispatches run [bin, conf] member rows a
                    # cell: the doubled row count is priced.
                    cost=sched_mod.bucket_cost(
                        2 * n, d.bucket, B, new_tokens + conf_tokens,
                        fused_decode=fused_dec), stamp=stamp)

                # Member rows are [bin, conf] per cell: even rows carry
                # the binary readout, odd rows the confidence one. Both
                # ran the shared max(new, conf) budget, so each branch
                # view trims its per-step fields back to ITS budget —
                # greedy decoding is prefix-stable, so the trimmed tokens
                # equal what a budget-exact decode would have produced.
                def _branch(start, budget):
                    idx = slice(start, m, 2)
                    return generate.FusedDecodeOut(
                        generated=out.generated[idx, :budget],
                        p_yes=out.p_yes[idx, :budget],
                        p_no=out.p_no[idx, :budget],
                        top2_ids=out.top2_ids[idx, :budget],
                        topk_logprobs=out.topk_logprobs[idx],
                        topk_ids=out.topk_ids[idx],
                        weighted_confidence=out.weighted_confidence[idx])

                fused = _branch(0, new_tokens)
                cfused = _branch(1, conf_tokens)
            _emit(batch, fused, cfused, t1, t2, stamp=stamp)
        _drain_pending()   # close the chain's last dispatch

    wt = threading.Thread(target=_writer, name="sweep-writer", daemon=True)
    wt.start()
    try:
        with torch.inference_mode():
            if ragged:
                _dispatch_ragged()
            else:
                _dispatch_legacy()
    finally:
        work_q.put(None)
        wt.join()
    if writer_err:
        raise writer_err[0]
    _record_tails()
    if pending_marks:
        _flush_marks()


def _reasoning_batch(engine, model_name, prompts, batch, full, seed,
                     reasoning_runs, pending_rows, rows) -> None:
    """Score one padded bucket in reasoning mode: ``reasoning_runs``
    sampled binary runs with count averaging, and one sampled confidence
    response, per cell; rows appended to ``rows`` and ``pending_rows``.

    Draws are keyed by GRID-CELL identity: cell (p, r) takes
    ``fold_in(fold_in(prng_key(seed), p), r)`` and its confidence run
    ``fold_in`` of that with 10,000, whatever its position in the todo
    list or the batch, so a resumed or subset sweep samples what the
    whole run sampled for every cell."""
    base = prng.prng_key(seed)
    cell_keys = torch.stack([
        prng.fold_in(prng.fold_in(base, c.prompt_idx), c.rephrase_idx)
        for c in full])
    targets = [prompts[c.prompt_idx].target_tokens for c in full]
    sampled = engine.score_prompts_sampled(
        [c.binary_prompt for c in full], targets, n_runs=reasoning_runs,
        key=cell_keys)
    conf_texts, conf_ids = engine.sample_completions_with_ids(
        [c.confidence_prompt for c in full], prng.fold_in(cell_keys, 10_000))
    for j, cell in enumerate(batch):
        s = sampled[j]
        conf_text = conf_texts[j].strip()
        # The greedy path's truncation guard: a reply that never reached
        # EOS may have been cut inside its integer.
        conf_val = _parse_confidence(
            conf_text, _decode_complete(conf_ids[j], engine.eos_id))
        row = schemas.PerturbationRow(
            model=model_name,
            original_main=cell.original_main,
            response_format=cell.response_format,
            confidence_format=cell.confidence_format,
            rephrased_main=cell.rephrased_main,
            full_rephrased_prompt=cell.binary_prompt,
            full_confidence_prompt=cell.confidence_prompt,
            model_response=s.response,
            model_confidence_response=conf_text,
            log_probabilities="",       # reasoning models expose no logprobs
            token_1_prob=s.token_1_prob,
            token_2_prob=s.token_2_prob,
            # Weighted confidence is the parsed integer in reasoning mode
            # (perturb_prompts.py:459-464).
            confidence_value=conf_val,
            weighted_confidence=None if conf_val is None else float(conf_val),
        )
        rows.append(row)
        pending_rows.append(row)


def _flush(rows: List[schemas.PerturbationRow], results_path: Path,
           manifest: SweepManifest, sink=None, accum_path=None) -> None:
    """Append rows then mark them done (write-ahead order: a crash
    between the two re-scores at most one checkpoint, never loses rows).

    The sink's lattice checkpoints FIRST: the resume done-set is the
    union of the manifest and the results artifact, so a lattice written
    after the rows could miss rows that union declares done — a
    permanent hole. Checkpoint-then-append keeps the lattice a superset
    of the done-set, and superset folds are idempotent re-scores."""
    if sink is not None:
        sink.checkpoint(accum_path)
    schemas.write_perturbation_results(rows, results_path, append=True)
    manifest.mark_done_many([
        {"model": r.model, "original_main": r.original_main,
         "rephrased_main": r.rephrased_main} for r in rows])
    log.info("checkpoint: +%d rows -> %s", len(rows), results_path)
