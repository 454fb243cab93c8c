"""Runtime configuration of the PyTorch scoring engine.

A copy of the part of the JAX package's ``RuntimeConfig``,
``SpecConfig``, ``CascadeConfig``, ``GovernorConfig``, ``FleetConfig``,
``RetryConfig``, ``ServeConfig`` and ``PerturbationConfig`` that this
port implements, the dispatch watchdog's knobs included. A flag of the
JAX engine that the port does not implement yet (leased shards,
meshes, the XLA compile plan) is absent here, so that no caller can set
it and have it ignored. int8
weights are not a flag: they are a param tree of
``models.quant.QuantTensor`` leaves (``quantize_decoder_params`` or
``init_quantized_params``); the int8 KV cache is
``ModelConfig.kv_cache_int8`` (``models.factory.load_engine(
kv_cache_int8=True)``), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Numerics + execution knobs for the inference engine."""

    max_new_tokens: int = 50          # reference: compare_base_vs_instruct.py:253
    scan_positions: int = 10          # MAX_LOOK_AHEAD, compare_base_vs_instruct.py:187
    batch_size: int = 32              # padded scoring batch per device step
    max_seq_len: int = 1024           # legal prompt + format ≲ 700 tokens (SURVEY §5)

    # Perturbation-sweep decode budget: the sweep's numeric readouts read
    # position 0 only (perturb_prompts.py:474-526), so a binary cell
    # decodes a few tokens; the confidence call keeps a larger budget for
    # the parsed integer.
    sweep_decode_tokens: int = 4
    sweep_confidence_tokens: int = 8
    # Stop the confidence decode once every row has emitted EOS or a
    # complete first integer (needs per-token strings and an EOS id).
    sweep_early_stop: bool = True
    # True restores the reference's 50-token 'Model Response' / 'Model
    # Confidence Response' text: both budgets become max_new_tokens and
    # the early stop is off.
    sweep_full_completions: bool = False

    # Ragged sweep scheduler (engine/scheduler.py). ON: grid cells are
    # tokenized up front, sorted into a ~sqrt(2) prompt-length bucket
    # ladder (tokens.bucket_ladder), drained per bucket with slot refill,
    # and cells sharing a long token prefix score through one shared
    # prefill (cross-cell prefix reuse). OFF restores the legacy
    # todo-order batching on the powers-of-two buckets. Per-cell results
    # are the same either way within float tolerance (padding is masked
    # out of every readout).
    ragged_scheduler: bool = True
    # Cross-cell prefix grouping engages for >= min_cells cells agreeing
    # on >= min_prefix leading tokens AND on at least half their prefill
    # (see scheduler.RaggedScheduler). 0 cells disables grouping.
    sweep_group_min_prefix: int = 16
    sweep_group_min_cells: int = 4

    # Speculative scoring decode (engine/spec.py + generate.
    # greedy_decode_fused_shared_spec). ON: shared-path dispatches that
    # do not take the cascade draft up to spec_k tokens ahead (n-gram
    # self-lookup over the dispatch's own prompt and emissions) and
    # VERIFY them in one multi-query pass through the decode attention
    # path (ops.flash_decode_mq / flash_decode_mq_trunk) — the ≤10-token
    # sequential scan collapses to ~T/k verify forwards when drafts
    # land. Greedy acceptance keeps every consumed result (generated
    # ids, position-0 readouts) identical to the sequential scan; a
    # rejected draft only costs re-verification.
    spec_decode: bool = True
    # Verify window: tokens checked per verify forward (1 emission + up
    # to spec_k-1 accepted drafts). < 2 disables speculation.
    spec_k: int = 4
    # Fleet model id that drafts for this engine (engine/fleet.py
    # acquires its weights through the WeightCache, refcounted for the
    # dispatch stream, so drafting never evicts the verifier). Empty =
    # self-drafting (tree + n-gram lookup).
    spec_draft_model: str = ""

    # Cross-request radix prefix cache over the paged KV allocator
    # (models/paged.py + engine/prefix_tree.py). ON: the engine keeps a
    # device-resident pool of `prefix_cache_pages` KV pages of
    # `prefix_page_size` token positions each, indexed by a per-bucket
    # radix tree over tokenized prefixes; a warm dispatch gathers its
    # rows' cached prefix pages into the exact slots the right-padded
    # prefill would fill and recomputes only a small remainder window
    # (across batches AND across sweeps on one engine). A warm row is
    # not bitwise the cold one: its pages hold the bits of the dispatch
    # that made them, and the window runs at another row count and
    # attention route than the cold prefill, so floats agree within
    # float tolerance and a greedy id may flip where its top two are
    # near tied; what a row reads thus depends on what ran before it on
    # the engine. Pool bytes =
    # pages x models/paged.kv_page_bytes. Offline sweeps default OFF
    # (the ragged scheduler's prefix groups already share within a
    # plan; opt in for repeated grids on one engine via --prefix-cache).
    prefix_cache: bool = False
    prefix_cache_pages: int = 512
    prefix_page_size: int = 16

    # Decode steps through the flash-decode kernel (ops/flash_decode);
    # off restores the dense decode path. Mirrored into
    # ModelConfig.fused_decode.
    fused_decode: bool = True

    # Piggyback chains: the ragged sweep parks each chained shared
    # dispatch's decode loops and runs them in the same engine call as
    # the NEXT same-shape dispatch's prefill
    # (generate.shared_piggyback_*), on one stream with no host sync
    # between them. A chained dispatch decodes on the sequential loop,
    # its two branches in disjoint cache regions; its rows are the plain
    # dispatch's. Off (--no-piggyback): every shared dispatch runs on
    # its own.
    piggyback_prefill: bool = True

    # Shared-trunk cascade prefill (ops/cascade_prefill + generate.
    # greedy_decode_fused_shared_cascade): a shared dispatch whose rows
    # begin with the same trunk prefills it once at batch 1 and extends
    # the per-row remainders over it.
    cascade_prefill: bool = True
    # Cascade decode (ops/flash_decode.flash_decode_trunk): trunk splits
    # read K/V from cache row 0 once per kv head, bitwise the flat kernel.
    cascade_decode: bool = True
    # Fused cascade prefill: trunk leg, suffix leg and merge in one
    # kernel. Off runs the two-leg route: the trunk-leg kernel
    # (ops.cascade_prefix), then the suffix leg and the merge. The
    # int8-QK^T cascade (CascadeConfig.int8_qk) takes the two-leg route
    # whatever this says.
    cascade_fused_suffix: bool = True

    # Numerics guard (guard/numerics.py): the perturbation sweep checks
    # every row's readouts before the row is built; a row with NaN/Inf or
    # out-of-range probabilities is written quarantined as
    # "error:numerics" with its measurement fields nulled, and the
    # streaming sink's fold marks it invalid by the same bounds. Off
    # writes such rows verbatim (measurement only).
    numerics_guard: bool = True

    # Dispatch watchdog (guard/watchdog.py): every sweep and serve
    # dispatch runs on a watched thread whose deadline is floor +
    # multiple x the predicted seconds (scheduler.bucket_cost priced at
    # this engine's own observed rate). A dispatch that outlives it is
    # abandoned with a stack dump of every thread and surfaces
    # DispatchStalled into the recovery path, so an injected or host-side
    # hang costs one deadline, not the run. multiple <= 0 disables; the
    # first dispatches are observe-only, and a kernel build (nvcc at
    # first use) neither counts toward a deadline nor calibrates one.
    watchdog_multiple: float = 20.0   # cli: --watchdog-multiple
    watchdog_floor_s: float = 30.0    # cli: --watchdog-floor

    # Streaming statistics (engine/stream_stats.py): every perturbation-
    # sweep dispatch folds its position-0 readouts into a device-resident
    # (prompt, rephrasing) lattice with one kernel launch, checkpointed
    # beside the results as <stem>.accum.npz; stats/streaming.summarize
    # turns it into per-prompt moments, percentiles, bootstrap CIs and
    # the within-prompt kappa without reloading the CSV. Off: statistics
    # only from the row artifact.
    streaming_stats: bool = True
    # With streaming_stats on, False skips the row artifact entirely: no
    # per-row payload is copied to the host, resume runs on the manifest
    # and the lattice checkpoint. True keeps the CSV (schema parity).
    row_artifact: bool = True


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative-decode DRAFTING policy (engine/spec.py). It can change
    speed, never results (greedy acceptance keeps every accepted token
    identical to the sequential scan's). The on/off switch and the
    verify-window size live on RuntimeConfig."""

    # N-gram match length for the prompt-lookup drafter: the verify scan
    # drafts the tokens that followed the most recent earlier occurrence
    # of the last `ngram` context tokens (prompt + accepted emissions).
    ngram: int = 2
    # Probe the radix prefix tree's token history for a whole-window
    # draft of the dispatch's continuation (prefix_tree.continuation)
    # before falling back to n-gram matching. Needs the prefix cache
    # (the tree) to be enabled on the engine; off otherwise.
    tree_probe: bool = True
    # Continuation tails recorded per radix node (host memory only, LRU
    # beyond this): each completed dispatch records its prompt's
    # observed continuation so a repeat visit drafts the whole reply.
    tree_tails_per_node: int = 32


@dataclasses.dataclass(frozen=True)
class CascadeConfig:
    """Cascade-prefill eligibility policy: which shared dispatches take
    the cascade split. It changes speed, never results (the cascade
    matches the dense path it replaces within float tolerance)."""

    # Minimum shared-trunk length (tokens, after snapping).
    min_trunk: int = 32
    # Trunk lengths snap DOWN to this grid.
    trunk_quantum: int = 16
    # Minimum REAL rows in the dispatch: one row has nothing to dedup.
    min_rows: int = 2
    # int8 QK^T inside the trunk-leg kernel (ops.cascade_prefix_int8):
    # each query row and trunk key row quantized by models/quant.py's
    # dynamic rule, s8 x s8 -> s32, softmax and PV in float32. Scores
    # are tolerance-bound; off keeps float32 scores.
    int8_qk: bool = False


@dataclasses.dataclass(frozen=True)
class GovernorConfig:
    """Device-memory governor knobs (engine/hbm.py).

    Every device-memory consumer (weight cache, KV page pool, the parked
    chain carry, spec-draft pins) registers projected bytes into ONE
    ledger; sustained pressure against the budget walks a reversible
    degradation ladder (evict idle weights -> evict cold radix pages ->
    disable piggyback chaining -> disable spec drafting -> step the
    batch ladder down -> shed), each rung re-arming with hysteresis once
    pressure clears.
    """

    # Master switch: off leaves every consumer self-governed.
    enabled: bool = True                 # cli: --no-hbm-governor
    # Governed budget in GiB. 0 derives it from the card's memory
    # (torch.cuda.mem_get_info total, `hbm_reserve_frac` held back); on
    # the CPU 0 means unbounded: the ladder never engages.
    hbm_budget_gb: float = 0.0           # cli: --hbm-budget-gb
    # Fraction of the card's memory held back from a derived budget
    # (the allocator's reserve, fragmentation slack).
    hbm_reserve_frac: float = 0.08       # cli: --hbm-reserve-frac
    # Ledger pressure (ledger_bytes / budget) at which the ladder engages
    # its next rung, and the band below it at which the most recent rung
    # re-arms: walk down above 0.9, back up below 0.75.
    engage_pressure: float = 0.9         # cli: --hbm-engage-pressure
    hysteresis: float = 0.15             # cli: --hbm-hysteresis
    # Consecutive over-pressure ticks (one a dispatch) before a rung
    # engages; the same count of under-pressure ticks releases one.
    sustain_ticks: int = 2               # cli: --hbm-sustain-ticks
    # Radix pages evicted per evict_pages rung engagement.
    evict_pages_per_step: int = 32       # cli: --hbm-evict-pages

    @property
    def budget_bytes(self) -> Optional[int]:
        return (int(self.hbm_budget_gb * 2**30)
                if self.hbm_budget_gb > 0 else None)


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Multi-model fleet knobs (engine/fleet.py over models/weights.py).

    - ``fleet_models``: the model ids a fleet serves (``serve
      --fleet-models``; serve/server.FleetScoringServer).
    - ``weight_cache_gb``: device budget for co-resident model weights;
      0 = unbounded. When a model would not fit, the LRU model with no
      in-flight dispatch is evicted; a budget smaller than the largest
      model is a loud error.
    - ``weight_prefetch``: stream the next model's weights on a
      background worker while the current model scores
      (``--no-weight-prefetch`` serializes every swap).
    - ``fleet_deadline_s``: default deadline of a serving fan-out.
    """

    fleet_models: Tuple[str, ...] = ()
    weight_cache_gb: float = 0.0
    weight_prefetch: bool = True
    fleet_deadline_s: float = 60.0

    @property
    def weight_cache_bytes(self) -> Optional[int]:
        return (int(self.weight_cache_gb * 2**30)
                if self.weight_cache_gb > 0 else None)


@dataclasses.dataclass(frozen=True)
class RetryConfig:
    """Exponential-backoff policy (reference: perturb_prompts.py:72-106).

    ``full_jitter=True`` draws each wait from U[0, delay] instead of the
    multiplicative 0.8-1.2 band; ``max_elapsed`` caps the total time of
    the retry loop (attempts + sleeps): once another sleep would cross
    it, the last failure is raised. None keeps the reference's unbounded
    loop."""

    max_retries: int = 10
    initial_delay: float = 60.0
    max_delay: float = 300.0
    backoff_factor: float = 1.5
    jitter: Tuple[float, float] = (0.8, 1.2)
    full_jitter: bool = False
    max_elapsed: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Online serving knobs (serve/), the JAX package's fields.

    - ``queue_depth``: admission bound; a submit into a full queue sheds
      the newcomer, or the queued request with the latest deadline when
      the newcomer is more urgent.
    - ``stream_window``: the live statistics ring
      (engine/stream_stats.ServeStreamSink) behind the ``stats``
      endpoint; gated on RuntimeConfig.streaming_stats, 0 disables it.
    - ``prefix_cache``: the cross-request radix prefix cache, on by
      default for serving (the pool is RuntimeConfig.prefix_cache_pages
      pages); a warm row is within float tolerance of the cold one.
    - ``classes`` / ``default_class``: (name, deadline seconds) pairs; a
      request names its class, an unknown class takes the default's.
    - ``linger_s``: a partial bucket dispatches once its oldest request
      waited this long.
    - ``pad_full``: pad every dispatch to the full batch (one shape per
      bucket) instead of the sweep's power-of-two tail.
    - ``cache_entries``: the content-addressed result cache (0: off).
    - ``max_consecutive_failures`` / ``breaker_cooldown_s``: the circuit
      breaker (faults/breaker.py) opens after that many failed
      dispatches in a row and probes again after the cooldown.
    - ``degrade_ladder``: a dispatch that fails all its retries is
      bisected to isolate poison rows (faults/ladder.py) instead of
      erroring the whole batch.
    - ``retry``: the dispatch retry policy (short, full jitter, capped).
    """

    queue_depth: int = 256
    stream_window: int = 4096
    prefix_cache: bool = True
    classes: Tuple[Tuple[str, float], ...] = (
        ("interactive", 10.0), ("batch", 300.0))
    default_class: str = "batch"
    linger_s: float = 0.02
    pad_full: bool = True
    cache_entries: int = 4096
    max_consecutive_failures: int = 3
    breaker_cooldown_s: float = 30.0
    degrade_ladder: bool = True
    retry: RetryConfig = dataclasses.field(
        default_factory=lambda: RetryConfig(
            max_retries=2, initial_delay=0.25, max_delay=2.0,
            backoff_factor=2.0, full_jitter=True, max_elapsed=8.0))

    def deadline_for(self, klass: str) -> float:
        table = dict(self.classes)
        if klass in table:
            return table[klass]
        return table.get(self.default_class,
                         max(table.values()) if table else 300.0)


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Multi-replica serving knobs (serve/router.py), the JAX package's.

    The router spreads one request stream over N replica servers.
    Placement reads per replica its queue depth, its router-side circuit
    breaker, for fleet replicas its weight residency (WeightCache
    listener events), its prefix-page residency (the cluster prefix
    index), its oldest queued row against the request's remaining
    deadline, and its device-memory pressure. A dead or erroring
    replica's requests are re-admitted to survivors exactly once, and a
    request close to its deadline is hedged onto a second replica (first
    payload wins).

    - ``replicas``: in-process replica servers of ``serve --replicas``
      (1: no router).
    - ``hedge_s``: hedge a request whose deadline is closer than this
      (0: no hedging).
    - ``replica_failure_threshold`` / ``replica_cooldown_s``: a
      replica's router-side breaker opens after that many error results
      in a row and probes again after the cooldown (monotonic clock).
    - ``residency_bonus``: placement bonus, in queue rows, for a replica
      already holding the request's model.
    - ``pressure_weight``: placement penalty, in queue rows, per unit of
      the replica's governor pressure (0: off).
    - ``slo_wait_weight``: weight on a replica's oldest queued-row wait
      relative to the request's remaining deadline (0: off).
    - ``tick_s``: the router's tick (hedging scans, breaker promotion).
    - ``cache_entries``: the router's content-addressed dedup cache, the
      exactly-once backstop against zombie payloads (0: off).
    """

    replicas: int = 1
    hedge_s: float = 0.0
    replica_failure_threshold: int = 2
    replica_cooldown_s: float = 5.0
    residency_bonus: float = 8.0
    pressure_weight: float = 6.0
    slo_wait_weight: float = 4.0
    tick_s: float = 0.02
    cache_entries: int = 4096


@dataclasses.dataclass(frozen=True)
class MigrationConfig:
    """Disaggregated prefill and decode serving (serve/migrate.py), every
    field and default of the JAX package's.

    - ``enabled``: page migration and disaggregated placement; False
      gives the role-less router.
    - ``prefill_replicas``: of ``--replicas N``, the first K take the
      PREFILL role (long prompts prefill there, their KV pages migrate to
      a decode replica); 0 keeps every replica colocated.
    - ``chunk_pages``: KV pages a transfer chunk (``paged.kv_page_bytes``
      a page).
    - ``inflight_chunks``: chunks in flight a leg (2: double buffering).
    - ``min_prefix_tokens``: the shortest tokenized shared prefix worth a
      remote prefill and a migration; shorter prompts score colocated.
    - ``page_bonus``: placement bonus, in queue rows, per prefix page a
      replica already holds.
    - ``verify``: check each chunk's CRC32 before any page lands.
    - ``timeout_s``: one chain's wall-clock budget (prefill, export,
      transfer, import); past it the router falls back to a local
      re-prefill.
    """

    enabled: bool = True
    prefill_replicas: int = 0
    chunk_pages: int = 8
    inflight_chunks: int = 2
    min_prefix_tokens: int = 32
    page_bonus: float = 0.5
    verify: bool = True
    timeout_s: float = 30.0


@dataclasses.dataclass(frozen=True)
class PerturbationConfig:
    """Perturbation-generation parameters (reference: perturb_prompts.py),
    the fields of the JAX package's ``PerturbationConfig`` that the
    port's ``rephrase`` command reads."""

    sessions_per_prompt: int = 100      # :787-788
    rephrasings_per_session: int = 20   # numbered 1..20
    rephrase_temperature: float = 0.9   # :802
    seed: int = 42                      # RANDOM_SEED, :34
