"""Drive the PyTorch port (``lir_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):

1. Build: compile every kernel of ``lir_tpu_torch/csrc`` with nvcc for
   sm_90a, one nvcc per source, all at once; print ptxas's registers,
   shared memory and spills per kernel, and from ``cuobjdump -sass`` of
   the built libraries the tensor-core instructions of each
   instantiation: HMMA (or HGMMA for wgmma) in the bf16 kernels
   (``cascade_mma_kernel``, ``prefix_wgmma_kernel``, ``prefix_imma_kernel``,
   ``flash_mma_kernel``, ``row_gemm_kernel``, ``suffix_merge_kernel``),
   HGMMA (wgmma) in ``row_gemm_kernel``, ``prefix_wgmma_kernel``, the
   fused ``cascade_mma_kernel`` and ``suffix_merge_kernel`` at every head
   dim, and ``flash_wgmma_kernel`` at head dims 64 and 128 with one and
   two consumer warpgroups, IMMA in ``prefix_imma_kernel`` and in the
   int8-KV attention's blocks of 8 rows or more (``kv_int8_attention_kernel``
   at every head dim and query dtype); fail if one has none.
2. Kernels against their plain PyTorch versions on the card, at the
   shapes the main path gives them (llama-2-7b widths, B = 32, the cache
   extents and trunks of phase 3's dispatches; the verify window's
   S = spec_k = 4 queries a row for the multi-query kernels; the trunk
   leg at the cascade dispatch's shape, float32 and int8 QK^T, and the
   trunk keys' quantization pass at every layer's keys at once, as the
   dispatch calls it; the prefill flash kernel at buckets 64, 128 and
   512, with the route it
   took; the row-invariant projections at M = B and B * spec_k for all
   seven of a layer, the norm, and the residual add fused with the norm
   (``row_add_norm``, also at falcon-7b's width 4544), and the same at the
   grouped sweep dispatch's M = 64 member rows (with ``flash_decode`` at
   B = 64 and its cache extent, bucket + suffix bucket + 8), the norms beside
   an empty kernel's time, the floor of the timing), plus GQA
   (mistral-7b), MQA (falcon-7b) and ALiBi (bloom-7b1)
   shapes: bf16 kernel output against the float32 plain version of the
   same bf16 inputs, atol = rtol = 1e-2 (bf16 output rounding; the trunk
   leg's float32 partials to the same bar). Bitwise: the trunk decode
   kernels against the flat ones, query j of the multi-query kernel
   against the single-query kernel at its position, the int8 trunk
   leg's row max against its plain twin's, the trunk keys' quantization
   pass against ``dynamic_quant``, the fused cascade against
   ``cascade_prefix`` + ``cascade_suffix_merge`` at every cascade case,
   the row kernels' first rows against the same rows alone, and
   ``row_add_norm``'s sum against torch's bf16 add and its norm against
   ``row_norm`` of the sum. The streaming-statistics fold
   (``stream_fold``) bitwise its plain twin on a (5, 2,000) lattice, B =
   32 rows a dispatch, K = 20 log-probs, with pad rows, NaN / negative /
   over-1 and zero-mass readouts, guard on and off, contiguous and
   strided readouts and a refold (idempotent), at B = 32 and 64, timed
   beside the empty kernel and PR 12's time. The sampler
   (``gumbel_argmax``) at V = 32,000, B = 1, 8, 32 and 64, one key and a
   key a row, four temperatures, and at V = 32,001 and 50, on row views
   of a stride that is not a multiple of 4, a row of NaNs and rows of
   exact ties: ids equal to its plain twin's (a differing row prints the
   twin's top-2 gap), again after the timing loop, timed beside the
   empty kernel and PR 17's time, with the host's microseconds a wrapper
   call; its bound is the largest of the bytes, the INT32 operations and
   all the instructions an entry, counted in the built kernel's SASS
   (``sample_sass_counts``). The int8-KV attention
   (``kv_int8_attention``) at the cascade dispatch's extent, B = 32: the
   decode step (S = 1, its main-path case), S = spec_k + 1, a 16-token
   extension, GQA (mistral-7b) and ALiBi (bloom-7b1); at the chain's
   extent (156 slots) and the flat grid's promoted tail (1,088) a decode
   step and a verify window each; a GQA verify window (20 rows a pair);
   on the decode inputs with K and V quantized per vector: its s32
   scores bitwise the twin's, its output within ``tie_bar`` (one level
   of the quantized probabilities at each key whose value sits within
   1e-2 of a rounding tie, times the value payload, plus a unit in the
   output's last place: the two float chains sum in other orders), a
   second launch bitwise the first; bound by the int8 payloads and
   scales, no library call; each row with its launch plan (blocks a
   cluster, rows a block, IMMA or dp4a), its share of the bound and PR
   18's time. One query row alone (B = 1, S = 1) bitwise the same row in
   a B = 32 verify launch, MHA and GQA.
   Times by CUDA events after warm-up, the L2 cache flushed before every
   launch and the stream held by a spin kernel while the host enqueues it
   (device time, without the host's launch time); the library yardstick
   (``library_ms``: SDPA, torch.matmul, F.rms_norm) is timed beside the
   kernels and used nowhere in the port; the two legs of
   ``flash_decode_mq_trunk`` and its merge are also timed one launch at
   a time. Then the whole slice at a small float32 size: the cascade and
   the speculative dispatch on the card against the same on the CPU
   (plain versions), the speculative dispatch against the sequential one
   on the card (ids exact, position-0 readouts bitwise), a speculative
   run given the sequential stream as its drafts, and the 8-bit engine
   (dynamic int8 weights, int8 QK^T, flash prefill) on the card against
   the same on the CPU (ids exact, floats within 1e-2), and the
   perturbation sweep over the three grids of ``sweep_grids`` at 20 cells
   each (B = 4) on the card against the same on the CPU (D6 text fields
   exact, probabilities, weighted confidence and log-probs within 1e-4,
   a grouped, a cascade and a speculative dispatch taken; the streaming
   sinks' lattices the same slots, values within 1e-4). Then the stats
   phase (``run_stream_stats_phase``): ``summarize(n_boot=1000)`` of a
   seeded (5, 2,000) lattice, ``truncated_normal_mc_fit`` at 100,000
   draws, ``bootstrap_correlation_matrix`` (Pearson, Spearman) and
   ``aggregate_kappa`` on a seeded 50 x 18 matrix at n_boot = 1,000, on
   the card against the CPU (the same resample indices on both; CIs
   within 1e-6, the fit and the correlation CIs within 1e-5), with the
   seconds of each. Then the analysis phase (``run_analysis_phase``):
   the pinned synthetic D6 (``data.synthetic``, 1,300 rows, two models)
   through ``analysis.perturbation.analyze_all_models`` on the card and
   on the CPU (the same files; the ``.tex`` identical; text, flags and
   counts equal; numbers within 1e-5 of max(1, |x|), the fits'
   goodness-of-fit statistics within 1e-3), each held to the executed
   reference's ``analyze_perturbation_results`` in
   ``tests/golden/reference_executed.json`` (the CPU tests'
   tolerances); then the paper's scale through ``python -m
   lir_tpu_torch analyze`` (a seeded D6 of 5 x 2,000 rows by the port's
   D6 writer at 100,000 draws a fit, a D2 of 50 questions x 18 models
   and its D1 over 9 base/instruct families), once on the card and once
   on the CPU, compared as above and checked against what the inputs
   fix, with each driver's seconds and the card's peak memory on the
   ``{"phase": "analysis", ...}`` line. Then the survey phase's part (a)
   (``run_survey_phase``): ``python -m lir_tpu_torch repro --no-figures``
   at the survey pipeline's default budgets (n_boot 1,000 / 100 /
   10,000) on a data directory at the paper's scale (the seeded
   Qualtrics fixture of ``data.synthetic``, 507 respondents; a D1 of
   nine base/instruct families, three with the names the family
   differences look up; its D2 with two more instruct models), once on
   the card and once on the CPU: every survey JSON the same keys, text,
   flags and counts, floats within 1e-5 of max(1, |x|) (of the larger
   mean under a two-group difference; counted p-values within two
   counts of 10,000), the report's numbers within its printed place, the
   base-vs-instruct and model-graph CSVs as the analysis phase compares
   them, the exclusion counts and matches the fixture fixes, with the
   seconds of each survey block on each device and the card's peak
   memory. Its parts (b) and (c) run later: the loader phase's swept
   D1/D2 through ``run_survey_pipeline`` on the card (the model with no
   checkpoint taken as the JAX package takes it), and
   ``llm_prompt_estimates_from_accum`` on every sweep's StreamSink
   snapshot on the card against the CPU replay of its D6 rows; one
   ``{"phase": "survey", ...}`` line after the loader phase. Last, at
   llama-2-7b width, spec_k decode steps against one verify window fed
   the steps' tokens, on the flat and the trunk kernels: window position
   j's logits must be bitwise step j's (and the same on the 8-bit engine
   in phase 3); beside it, whether the library ops the row kernels
   replaced give a row the same bits at B and B * spec_k rows (printed).
3. The slice at full width: llama-2-7b with seeded random bf16 weights
   made on the card, four engines sharing them. The word-meaning sweep
   over the 50 questions (dense prefill + the flat decode kernel); one
   shared dispatch of 32 cells sharing a ~430-token legal trunk (cascade
   prefill + the trunk decode kernel), and the same on an engine with
   the fused cascade off (the trunk-leg kernel + the suffix merge), whose
   every readout and generated id must be bitwise the fused route's; the
   32 cells with no common trunk on the sequential engine (dense shared
   prefill + the flat kernel) and on the default engine (the speculative
   verify loop on the multi-query kernel); the trunk cells on the
   sequential engine and on an engine with the cascade prefill off (the
   verify loop on the trunk-aware multi-query kernel). Each speculative
   dispatch must be bitwise the sequential one on every readout (later
   ids agreeing with share 1.0). The cost of the row kernels: ms per
   no-trunk dispatch on both routes with them and with the library calls
   patched back in, in turns. Then the 8-bit engine at the same width,
   its int8 weights born on the card (``init_quantized_params``,
   dynamic): the verify-vs-step check, the word-meaning sweep (flash
   prefill + flat decode), the trunk dispatch (one key quantization pass
   for every layer + int8 trunk-leg kernel and suffix merge a layer, the
   launches counted exactly + trunk decode), and the no-trunk
   dispatch on the sequential and the speculative route (flash prefill
   at bucket 128), bitwise alike, with rows/s and peak memory beside the
   bf16 engine's, and a profile of one of its word-meaning batches beside
   the bf16 one's (launches, and the elementwise adds' ms). Each phase
   resets the launch counts just before it and reads them just after,
   and fails if a kernel of its path never launched: ``row_add_norm`` in
   every decode phase of both engines, and in the 8-bit phases the
   prefill flash kernel's wgmma route.
   The sampling phase, after the bf16 phase 3 (``run_sampling_phase``):
   (a) ``generate.sample_decode`` on the small float32 model, card
   against CPU, per-row keys and one key, EOS stop armed: ids equal save
   flips at near ties (the twin's scores of the two ids within 1e-3,
   each printed); the EOS probe (identical prompts, temperature 1e-4,
   eos the unstopped run's step-3 id): the stopped ids, EOS fill after
   it, and the forwards ending at the first all-done check
   (``flash_decode`` launches); (b) the rephraser at llama-2-7b width
   (``generate_rephrasings(rephraser_from_engine(engine),
   LEGAL_PROMPTS[:1], prng_key(42), sessions_per_prompt=8)``: one batch
   of 8 x 512 sampled tokens), failing if a batch raised, with seconds,
   steps/s, tokens/s, peak memory, launches and the parsed rephrasings,
   and 16 steps of the same batch profiled (device-busy share);
   (c) ``run_perturbation_sweep(reasoning=True, reasoning_runs=10)``
   over 16 cells at B = 8 (50 tokens a run): count fractions, no log-prob
   map, the weighted confidence the parsed integer, then a resume with
   the first 8 cells done whose rows must be the whole run's bitwise.
   The sweep phase, after each engine's phase 3: ``run_perturbation_sweep``
   over three grids of 80 cells that ``sweep_grids`` builds from the five
   legal prompts (grouped: rephrasings that keep a prompt's text; trunk:
   every cell behind a 77-word preamble; flat: openings that differ),
   each into its own CSV, at B = 32: the plan by kind with occupancy and
   padding waste, the routing counters, the launches, rows/s and the
   peak memory of each, failing unless the grid's route ran with its
   kernels (a grouped dispatch on ``flash_decode``; a cascade dispatch on
   its cascade kernels; a speculative one on ``flash_decode_mq``) and
   unless the artifact holds one row a cell with its values in range.
   The streaming sink is on (its default): ``stream_fold`` must launch
   once a dispatch and fold every cell, and the lattice's slots,
   decisions, counts and kappa must be bitwise ``accum_from_rows`` over
   the CSV's rows, its moments within FLOAT_TOL. On the bf16 engine the
   grouped grid profiled (three more runs through
   ``profile_batch.profile``: launches, device-busy ms and share), once
   more on its results path, which must return no rows and launch
   nothing, once more with ``row_artifact=False`` (no CSV, every cell
   marked, the lattice bitwise the first run's), and each grid with the
   sink off (rows/s beside the sink-on run's: the sink's cost).
   The chain phase, after the prefix-cache phase: the chain grid (one
   legal prompt, 160 cells whose openings differ: five shared
   dispatches of one shape, the plan's piggyback keys printed) through
   ``run_perturbation_sweep`` with piggyback chains on and then off
   (rows/s, launches, the chain counters: a chain of at least four, every
   chain drained, no fallback); the rows bitwise, or else held to twice a
   half-batch control's movement, flips only at near ties, each
   reported. Then the int8-KV engine (the bf16 weights, ``cfg`` with
   ``kv_cache_int8``): the chain grid and the flat grid, rows/s (beside
   PR 18's), peak memory beside the bf16-KV engine's,
   ``kv_int8_attention`` launched and no ``flash_decode*``, the largest
   differences from the bf16-KV rows (reported). After the small sweep check, the small float32 model
   with an int8 KV cache over the small flat grid, card against CPU:
   texts equal save flips within a 1e-2-nat gap under the int8 cache,
   floats within 1e-2.
   The loader phase, after the bf16 sweep phase, while phase 3's
   llama-2-7b params are resident: they are written as an HF checkpoint
   in fp16 (two safetensors shards by this script's own writer, an
   index, llama-2-7b's ``config.json``) under a temporary directory
   (16 GB free required), loaded through ``models.factory.engine_factory``
   (the FakeTokenizer passed as ``tokenizer=``: no transformers on the
   card's machine), the config checked field by field against
   ``registry.llama2_7b()`` and every loaded leaf bitwise
   ``params[leaf].half().bfloat16()`` (write and load seconds and GB/s,
   host peak RSS, device peak memory); beside it a T5 checkpoint at
   google/t5-v1_1-base's width (seeded weights at HF T5's init scales,
   one fp16 safetensors file by the same writer with HF T5 key names,
   flan-t5-base's published ``config.json`` fields), loaded the same way
   (an encoder-decoder engine, its config and every leaf bitwise); then
   ``run_model_comparison_sweep`` over Llama-2-7b-hf (base), a
   Llama-2-7b-chat-hf symlink to it (instruct), t5-v1_1-base (base), a
   flan-t5-base symlink to it (instruct) and a model with no
   checkpoint: four ``ok`` models of 50 rows, one ``error:model`` of 50
   NaN rows, D1 250 rows and D2 150 on disk, ``flash_decode``,
   ``row_gemm``, ``row_norm`` and ``row_add_norm`` launched, and the
   device memory allocated after the call within 64 MB of before (each
   model released); those D1/D2 files through ``analyze`` on the card:
   the llama family's base-vs-instruct deltas, the D2's model graph
   stopped by KeyError on the model with no checkpoint (its NaN rows;
   the JAX package's behaviour, ROADMAP caveat R5), and run to its end
   without those rows (over the chat model and flan-t5-base). Once more
   on the two base models loaded with ``quantize_int8=True,
   int8_dynamic=True``: every int8 leaf bitwise
   ``quantize_decoder_params``' (``quantize_encdec_params``')
   quantization of the fp16 checkpoint's bf16 tree, status ``ok``, 50
   rows each, rows/s and peak memory beside the bf16 run's.
   The fleet phase (``engine/fleet.py``, ``models/weights.py``,
   ``engine/hbm.py``): (a), in the loader phase, the five specs scored
   with no fleet (each model built inline and released before the next:
   rows bitwise the loader phase's), then ``run_model_comparison_sweep``
   through a ``ModelFleet`` whose cache holds one 7B model, prefetch on
   and off, rows bitwise that reference (seconds, rows/s, FleetStats,
   peak memory); (b) a llama / T5 / llama acquire with pinned host
   staging, every re-streamed leaf and a batch bitwise (GB/s); (c) on
   phase 3's engine, a seeded 4-layer draft and a perfect drafter armed
   through ``acquire_spec_draft``, bitwise the sequential route, the
   perfect drafter accepting every draft; (d) a ``squeeze`` of that
   engine's governor, the rungs down and up in the JAX order with rows
   bitwise. After every phase the governors' ledger and level, no rung
   engaged where a route is asserted. In the loader phase the
   checkpoint also goes through the converted-parameter cache
   (``engine_factory(cache_root=)``, ``--param-cache``): once cold, once
   warm with the converter refusing, the warm tree bitwise the cold one
   (seconds of each). The guard phase (``run_guard_phase``, guard/,
   faults/, the sweep's dispatch recovery) on phase 3's params: the
   flat grid clean (the reference; it calibrates the watchdog at
   multiple 2, floor 0.5 s), then fault-wrapped: a dispatch fault, a
   hang of three times its deadline (stalled by the watchdog), a
   corrupt draft, a budget squeeze, NaN rows and a real allocator OOM
   (a ballast filling the card, released through a governor action),
   every D6 row byte for byte the clean run's save the quarantined
   ones; then an irreducible OOM that must raise ``HbmExhausted``. The
   serve phase (``run_serve_phase``, serve/): 128 requests of two
   classes at seeded Poisson arrivals through a ``ScoringServer``,
   prefix cache off (payloads bitwise the same rows dispatched directly
   on an engine with no server and no watchdog) and on (the default
   pool beside the model under the governor's budget, payloads within
   the prefix phase's bars), per-class latency, requests/s, dispatches,
   peak memory and launches; drills on a server (a fault, a hang, a
   poison row, the breaker opening and closing on its probe, a
   checkpoint and resume bitwise the direct dispatch); and ``python -m
   lir_tpu_torch serve --requests`` on the small model. The router phase
   (``run_router_phase``, serve/router.py): two replica ScoringServers
   on phase 3's read-only tree behind a ``ReplicaRouter``, (a) the serve
   phase's 128 Poisson requests, prefix off, every payload bitwise the
   direct dispatch of the dispatch that carried it, placements,
   requests/s, per-class latency, launches; (b) drills through
   ``faults.wrap_replica``: a replica kill mid-run (re-admitted, each
   request resolved once, zombie payloads dropped), revive and the
   half-open probe, a lagging replica hedged (the hedge wins, the
   straggler dropped), a faulting replica (failovers, its breaker
   open); (c) prefix on: a shared trunk placed on its holder by page
   residency, payloads within the prefix phase's bars. The fleet-serve
   phase (``run_fleet_serve_phase``): a ``FleetScoringServer`` over phase
   3's tree and a second seeded llama-2-7b under a one-model weight
   budget, 32 ``fleet_score`` requests (every per-model payload bitwise
   a single-model ScoringServer on the same engine, kappa and
   disagreement the CPU recomputation's, swaps with seconds hidden and
   exposed), then a squeeze of the shared governor through
   ``batch_down`` (rows within the prefix phase's bars) and ``shed``
   and back; and ``serve --replicas 2`` / ``serve --fleet-models`` as
   subprocesses on the small model. The migrate phase
   (``run_migrate_phase``, serve/migrate.py): two replica servers on
   the one tree, r0 prefill-role and r1 decode-role, prefix on: (a)
   MIGRATE_CHAINS requests one at a time, each through prefill ->
   export -> import -> score (r1's pool pages byte-equal to r0's after
   each import; every payload bitwise the direct replay of its carrying
   dispatch on a third engine that imported the same exports, and
   within the prefix phase's bars of the prefix-off serve payloads),
   the legs timed alone (``migrate_legs``); (b) pure pulls of prefixes
   scored on r0 first; (c) drills through ``faults.wrap_migrator``
   (a stall past a short chain deadline, a corrupt chunk with r1's tree
   unchanged at the refusal, a kill of r0 mid-chain), each request
   resolved once by a local re-prefill; (d) one int8-KV chain, pages
   byte-equal with their scales; (e) ``serve --replicas 2
   --migrate-prefill-replicas 1`` as a subprocess on the small model.
   The T5 phase (the encoder-decoder branch, ``models/encdec.py``): part
   (a), after the small sweep check, a small gated untied T5 and a small
   ReLU tied (v1.0) T5 in float32 through ``t5_greedy_decode``
   (``decode_prompts``) and ``score_prompts`` on the card against the
   CPU (ids and texts exact, step logits and readouts within 1e-4), and
   the decoder half of the capture path (``decode_prompts`` on the small
   decoder engine: the same, and ``flash_decode`` launched); parts (b)
   and (c), last: T0_3B (``registry.t0_3b()``, 2,849.9 M parameters)
   with seeded bf16 weights at HF T5's init scales made on the card,
   the 50 word-meaning questions at B = 32 and 50 new tokens through
   ``run_word_meaning_sweep`` (rows/s, seconds, peak memory; readouts in
   range, ``position_found`` in [0, 10)), the first decoded position's
   log-probs of 4 rows against the same weights upcast to float32 on the
   card, within 4 times the gap a width-reduced twin shows on the CPU
   (logged beside the twin's gap at twice its width and with
   ``encdec.init_params``' 0.02 weights, where the network is chaotic);
   then ``quantize_encdec_params(dynamic=True)`` of the tree on the
   card, layers 0 and 23 of both stacks and the head bitwise the same
   quantization on the CPU, and the same sweep on the 8-bit engine.
4. The ``{"kernels": [...]}`` summary, the card's name and power limit,
   and the last line ``{"ok": true, "device": {...}}``. Along the way,
   ``{"phase": "elapsed", ...}`` lines give the seconds since the start
   after each part.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import json
import math
import os
import re
import resource
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time
import types
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from lir_tpu_torch import faults, ops
from lir_tpu_torch.backends.fake import FakeTokenizer
from lir_tpu_torch.config import (CascadeConfig, GovernorConfig,
                                  MigrationConfig, RetryConfig, RouterConfig,
                                  RuntimeConfig, ServeConfig)
from lir_tpu_torch.data import (LEGAL_PROMPTS, WORD_MEANING_QUESTIONS,
                                format_base_prompt, format_instruct_prompt,
                                schemas)
from lir_tpu_torch.data.prompts import rephrase_request
from lir_tpu_torch.engine import (generate, grid, prefix_tree, prng, rephrase,
                                  sweep, tokens as tok)
from lir_tpu_torch.engine import hbm
from lir_tpu_torch.engine import scheduler as sched_mod
from lir_tpu_torch.engine import score as score_mod
from lir_tpu_torch.engine.fleet import ModelFleet
from lir_tpu_torch.engine.multi import (ModelSpec, format_for,
                                       nan_rows_for_model,
                                       run_model_comparison_sweep)
from lir_tpu_torch.engine.runner import (SFX_BUCKETS, PiggybackIneligible,
                                         ScoringEngine)
from lir_tpu_torch.models import (decoder, encdec, loader, paged, quant,
                                  registry)
from lir_tpu_torch.models import weights
from lir_tpu_torch.models.factory import engine_factory
from lir_tpu_torch.ops import _build
from lir_tpu_torch.ops.flash_decode import (decode_legs,
                                            flash_decode_mq_plain,
                                            flash_decode_mq_trunk_plain,
                                            flash_decode_plain,
                                            flash_decode_trunk_plain,
                                            trunk_splits, DECODE_SPLIT)
from lir_tpu_torch.ops.cascade_prefill import (cascade_attention_plain,
                                               prefix_partials,
                                               prefix_partials_int8,
                                               suffix_merge_plain)
from lir_tpu_torch.ops.row_gemm import (row_add_norm_plain, row_gemm_plain,
                                        row_norm_plain)
from lir_tpu_torch.ops.flash_attention import flash_attention_plain
from lir_tpu_torch.ops.stream_fold import stream_fold_plain
from lir_tpu_torch.ops.sample import gumbel_argmax_plain, gumbel_scores_plain
from lir_tpu_torch.ops.kv_int8_attention import HEAD_DIMS as KV8_HEAD_DIMS
from lir_tpu_torch.ops.kv_int8_attention import (kv_int8_attention_plain,
                                                 qk_s32_plain, tie_bar)
from lir_tpu_torch.ops.kv_int8_attention import plan as kv8_plan
from lir_tpu_torch.engine import stream_stats
from lir_tpu_torch.guard import numerics
from lir_tpu_torch.serve import (FleetScoringServer, ReplicaRouter,
                                 ScoringServer, ServeRequest, fleet_decision)
from lir_tpu_torch.serve import migrate
from lir_tpu_torch.stats import streaming
from lir_tpu_torch.stats.core import generator_for, resample_indices
from lir_tpu_torch.stats.correlations import bootstrap_correlation_matrix
from lir_tpu_torch.stats.fits import truncated_normal_mc_fit
from lir_tpu_torch.stats.kappa import aggregate_kappa
from lir_tpu_torch.utils.manifest import SweepManifest
from lir_tpu_torch import cli as port_cli
from lir_tpu_torch.analysis import base_vs_instruct as analysis_bvi
from lir_tpu_torch.analysis import kappa_combined as analysis_kappa
from lir_tpu_torch.analysis import model_graph as analysis_graph
from lir_tpu_torch.analysis import perturbation as analysis_perturbation
from lir_tpu_torch.data import synthetic, table as table_mod
from lir_tpu_torch.survey import consolidated as survey_consolidated
from lir_tpu_torch.survey import family_differences as survey_family
from lir_tpu_torch.survey import human_llm as survey_human_llm
from lir_tpu_torch.survey import loader as survey_loader
from lir_tpu_torch.survey import proportions as survey_proportions
from lir_tpu_torch.survey import pvalues as survey_pvalues
from lir_tpu_torch.survey import run as survey_run
from lir_tpu_torch.survey import simulated as survey_simulated

import profile_batch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, published
BF16_FLOP_PER_S = 989e12         # H100 SXM dense bf16 tensor cores, published
INT8_OP_PER_S = 1979e12          # H100 SXM dense int8 tensor cores, published
# H100 SXM INT32 ALU rate: 64 INT32 lanes an SM against 128 FP32 lanes,
# whose fused multiply-adds (two operations) make the published 67 TFLOP/s
# float32: 132 SMs x 64 lanes x 1.98 GHz.
INT32_OP_PER_S = 67e12 / 4
# H100 SXM instruction issue: 132 SMs x 4 schedulers x one warp
# instruction (32 lanes) a cycle x 1.98 GHz.
ISSUE_PER_S = 132 * 128 * 1.98e9
ATOL = RTOL = 1e-2
BATCH = 32
DEV = "cuda"
# SDPA groups query heads itself where this PyTorch supports it (2.5+).
_SDPA_GQA = "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or "")
# Each kernel's source, the TPU kernel it replaces, and the phase-2 case
# whose shape is its main-path shape in the summary line.
SOURCES = {
    "flash_decode": ("lir_tpu_torch/csrc/flash_decode.cu",
                     "lir_tpu/ops/flash_decode.py:65",
                     "llama2-7b/cascade-dispatch"),
    "flash_decode_trunk": ("lir_tpu_torch/csrc/flash_decode.cu",
                           "lir_tpu/ops/flash_decode.py:179",
                           "llama2-7b/cascade-dispatch"),
    "cascade_attention": ("lir_tpu_torch/csrc/cascade_prefill.cu",
                          "lir_tpu/ops/cascade_prefill.py:204",
                          "llama2-7b/cascade-dispatch"),
    "flash_decode_mq": ("lir_tpu_torch/csrc/flash_decode.cu",
                        "lir_tpu/ops/flash_decode.py:348",
                        "llama2-7b/spec-dispatch"),
    "flash_decode_mq_trunk": ("lir_tpu_torch/csrc/flash_decode.cu",
                              "lir_tpu/ops/flash_decode.py:464",
                              "llama2-7b/spec-trunk-dispatch"),
    "cascade_prefix": ("lir_tpu_torch/csrc/cascade_prefill.cu",
                       "lir_tpu/ops/cascade_prefill.py:68",
                       "llama2-7b/cascade-dispatch"),
    "cascade_prefix_int8": ("lir_tpu_torch/csrc/cascade_prefill.cu",
                            "lir_tpu/ops/cascade_prefill.py:68",
                            "llama2-7b/cascade-dispatch"),
    "flash_attention": ("lir_tpu_torch/csrc/flash_attention.cu",
                        "lir_tpu/ops/flash_attention.py:41",
                        "llama2-7b/spec-dispatch"),
    # Launches without a Pallas original: "replaces" names the JAX code
    # they stand in for (XLA there).
    "row_gemm": ("lir_tpu_torch/csrc/row_gemm.cu",
                 "lir_tpu/models/decoder.py:439 (XLA dot)",
                 "llama2-7b/w_up/M32"),
    "row_norm": ("lir_tpu_torch/csrc/row_gemm.cu",
                 "lir_tpu/models/decoder.py:114 (XLA)",
                 "llama2-7b/M32"),
    "row_add_norm": ("lir_tpu_torch/csrc/row_gemm.cu",
                     "lir_tpu/models/decoder.py:496 (XLA)",
                     "llama2-7b/M32"),
    "cascade_suffix_merge": ("lir_tpu_torch/csrc/cascade_prefill.cu",
                             "lir_tpu/ops/cascade_prefill.py:174 (XLA)",
                             "llama2-7b/cascade-dispatch"),
    "quantize_rows": ("lir_tpu_torch/csrc/cascade_prefill.cu",
                      "lir_tpu/ops/cascade_prefill.py:86 (in-kernel)",
                      "llama2-7b/cascade-dispatch"),
    "stream_fold": ("lir_tpu_torch/csrc/stream_fold.cu",
                    "lir_tpu/engine/stream_stats.py:114 (XLA fold_update)",
                    "5x2000/B32"),
    "gumbel_argmax": ("lir_tpu_torch/csrc/sample.cu",
                      "lir_tpu/engine/generate.py:1442 (XLA "
                      "jax.random.categorical)",
                      "B8/V32000/one_key"),
    "kv_int8_attention": ("lir_tpu_torch/csrc/kv_int8_attention.cu",
                          "lir_tpu/models/decoder.py:229 (XLA einsums, "
                          "_attention_cached_int8)",
                          "llama2-7b/decode"),
}
# The streaming-statistics lattice of phase 2 and the stats phase: the
# paper's five legal prompts x ~2,000 rephrasings, and the top-20 map.
STREAM_P, STREAM_R, STREAM_K = 5, 2000, 20
# The stats phase's resamples, the truncated-normal fit's draws
# (cli.py's default), and the model-comparison matrix (the paper's axis
# 2: 50 questions x 18 models).
STATS_N_BOOT, FIT_N_SIM, AXIS2 = 1000, 100_000, (50, 18)
# The 8-bit small slice on the card against the CPU: floats within this
# bound. The two devices' activations differ by ~1e-7 (other summation
# orders); where that crosses a rounding boundary of the per-token
# quantization one int8 payload moves by a step, which moves a logit by
# a few 1e-3 at this size (3.5e-3 seen in a top-k log-prob).
INT8_SLICE_TOL = 1e-2
# Position-0 readouts of a shared dispatch, held bitwise between the
# speculative and the sequential route.
POS0_FIELDS = ("topk_logprobs", "topk_ids", "weighted_confidence")


def log(*args):
    print(*args, flush=True)


# ---------------------------------------------------------------------------
# Phase 3's inputs (planned first, so phase 2 runs at their shapes)
# ---------------------------------------------------------------------------

def legal_cells(shared_trunk: bool):
    """32 (binary, confidence, yes id, no id) cells. With a trunk, every
    cell opens with the five legal questions' text (~430 words) and ends
    in its own variation; without, every cell opens differently."""
    trunk = " ".join(p.main for p in LEGAL_PROMPTS)
    cells = []
    for r in range(BATCH):
        p = LEGAL_PROMPTS[r % len(LEGAL_PROMPTS)]
        words = p.main.split()
        tail = " ".join(words[r % 7: r % 7 + 10 + r % 13])
        text = (f"{trunk} Variation {r}: {tail}" if shared_trunk
                else f"Variation {r}: {p.main} {tail}")
        cells.append((p.rephrased_binary(text), p.rephrased_confidence(text),
                      p.target_tokens))
    return cells


def plan_shared(engine: ScoringEngine, cells, rt: RuntimeConfig):
    """The bucket, trunk and cache extents decode_fused_shared will use:
    T0 for the sequential loop, T_spec for the speculative one."""
    t = engine.tokenizer
    bins = [t(b).input_ids for b, _, _ in cells]
    confs = [t(c).input_ids for _, c, _ in cells]
    lcp = [tok.shared_prefix_len(a, b) for a, b in zip(bins, confs)]
    bucket = tok.pick_bucket(lcp, engine.buckets)
    ba = tok.pick_bucket([len(a) - n for a, n in zip(bins, lcp)], SFX_BUCKETS)
    bb = tok.pick_bucket([len(c) - n for c, n in zip(confs, lcp)], SFX_BUCKETS)
    trunk = engine.cascade_trunk_for([a[:n] for a, n in zip(bins, lcp)],
                                     len(cells), bucket)
    T0 = bucket + max(ba + rt.sweep_decode_tokens,
                      bb + rt.sweep_confidence_tokens)
    T_spec = generate.spec_total_len(bucket, ba, bb, rt.sweep_decode_tokens,
                                     rt.sweep_confidence_tokens, rt.spec_k)
    return dict(bucket=bucket, trunk=trunk, T0=T0, T_spec=T_spec, lcp=lcp,
                prefix_rows=[a[:n] for a, n in zip(bins, lcp)])


# A preamble of 77 words: the trunk grid's every cell opens with it, so
# its dispatches share a 64-token trunk (one 64-key split of the trunk
# decode kernel; a shorter trunk prefills through the cascade but
# decodes on the flat kernel).
SWEEP_PREAMBLE = (
    "Read the contract clause below as a court would, giving each word its "
    "ordinary meaning in the context of the whole agreement, weigh the text "
    "against the evident purpose of the parties, and only then answer the "
    "question that follows about how the clause applies. Assume that the "
    "parties were represented by counsel, that the document is the final "
    "expression of their bargain, and that no evidence outside it shows "
    "what either party meant by its terms.")
SWEEP_MODEL = "llama-2-7b (seeded random weights)"


def sweep_grids(n: int) -> dict:
    """The sweep phase's three grids over the five legal prompts, ``n``
    rephrasings of each (5 * (n + 1) cells with the originals):

    - grouped: every rephrasing keeps its prompt's text and varies a short
      ending, so the scheduler groups a prompt's cells (one prefill);
    - trunk: every cell opens with SWEEP_PREAMBLE, then varies its opening
      (too short a share of each prompt to group), so shared dispatches
      take the cascade and the trunk decode;
    - flat: openings differ, so shared dispatches take the speculative
      route."""
    grouped, trunk, flat = [], [], []
    for p in LEGAL_PROMPTS:
        words = p.main.split()

        def tail(r):
            return " ".join(words[r % 7: r % 7 + 10 + r % 13])

        grouped.append([f"{p.main} Variant {r}: "
                        + " ".join(words[r % 5: r % 5 + 1 + r % 4])
                        for r in range(n)])
        trunk.append([f"{SWEEP_PREAMBLE} Variation {r}: {p.main} {tail(r)}"
                      for r in range(n)])
        flat.append([f"Variation {r}: {p.main} {tail(r)}" for r in range(n)])
    trunk_prompts = [dataclasses.replace(p, main=f"{SWEEP_PREAMBLE} {p.main}")
                     for p in LEGAL_PROMPTS]
    return {"grouped": (LEGAL_PROMPTS, grouped),
            "trunk": (trunk_prompts, trunk),
            "flat": (LEGAL_PROMPTS, flat)}


def plan_sweep(engine: ScoringEngine, prompts, perts, rt: RuntimeConfig):
    """The ragged scheduler's plan of one grid (sweep._plan_ragged, as
    run_perturbation_sweep plans it)."""
    cells = grid.build_grid(SWEEP_MODEL, prompts, perts)
    dispatches, stats = sweep._plan_ragged(engine, cells,
                                           rt.sweep_decode_tokens,
                                           rt.sweep_confidence_tokens)
    return cells, dispatches, stats


def grouped_shape(engine: ScoringEngine, grids: dict, rt: RuntimeConfig):
    """(member rows, cache extent) of the grouped grid's first dispatch
    with the most member rows: the shape its decode steps run at."""
    _, dispatches, _ = plan_sweep(engine, *grids["grouped"], rt)
    d = max((d for d in dispatches if d.kind == "grouped"),
            key=lambda d: d.padded_rows(rt.batch_size)[1])
    m_pad = d.padded_rows(rt.batch_size)[1]
    T = d.bucket + max(d.sfx_bucket_a, d.sfx_bucket_b) + max(
        rt.sweep_decode_tokens, rt.sweep_confidence_tokens)
    return m_pad, T


# ---------------------------------------------------------------------------
# Timing and bounds
# ---------------------------------------------------------------------------

_FLUSH = None


# Cycles of the spin kernel that holds the stream before each timed launch
# (~0.5 ms): longer than the host takes to enqueue a wrapper's launches.
SPIN_CYCLES = 1_000_000


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median device ms of ``fn`` over ``iters`` launches, each after an L2
    flush (a 64 MB write), by CUDA events. A spin kernel between the flush
    and the start event keeps the stream busy while the host enqueues
    ``fn``, so the reading is device time, not the host's launch time.
    The median, not the mean: one stalled launch among ten can move a
    mean several-fold."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        _FLUSH.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# The host's side of a wrapper call: a spin kernel of this many cycles
# (~5 ms) holds the stream while HOST_CALLS calls are enqueued.
HOST_SPIN_CYCLES = 10_000_000
HOST_CALLS = 100


def host_us(fn, rounds: int = 5) -> float:
    """Median host microseconds of one call of ``fn`` (the wrapper's
    checks, plan and allocations and the launch's enqueue), by the host
    clock around HOST_CALLS calls while a spin kernel holds the stream,
    so that no call waits for the device."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        torch.cuda._sleep(HOST_SPIN_CYCLES)
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        times.append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
        torch.cuda.synchronize()
    return float(np.median(times))


def empty_kernel() -> None:
    """One launch of a kernel that does nothing (a spin of no cycles):
    timed by :func:`time_ms`, the floor of its readings."""
    torch.cuda._sleep(0)


def warm_up(seconds: float = 2.0) -> None:
    """Run the card at full load for ``seconds`` (bf16 products), so that
    the first timing does not read it at the idle clocks of the build."""
    x = torch.randn((8192, 8192), device="cuda", dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        x @ x
        torch.cuda.synchronize()


def bound(nbytes: float, flops: float, int8_ops: float = 0.0):
    """The least time for the work: bytes over the memory rate against
    bf16-rate FLOPs plus int8-rate operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (flops / BF16_FLOP_PER_S + int8_ops / INT8_OP_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def check_close(name, got, ref):
    err = (got.float() - ref.float()).abs()
    limit = ATOL + RTOL * ref.float().abs()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    if bool((err > limit).any()):
        raise AssertionError(f"{name}: max |err| {err.max().item():.3e} over "
                             f"atol=rtol={ATOL}")
    return float(err.max())


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def decode_inputs(gen, B, H, K, hd, T, trunk_len, S=None):
    """Decode-step inputs at the main path's shapes: q (B, H, hd) and
    q_positions (B,), or with ``S`` a verify window, q (B, S, H, hd) and
    q_positions (B, S) at the row's last S valid slots."""
    dev = DEV
    qshape = (B, H, hd) if S is None else (B, S, H, hd)
    q = torch.randn(qshape, generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((K, T, B, hd), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((K, T, B, hd), generator=gen, device=dev).to(torch.bfloat16)
    if trunk_len:
        k[:, :trunk_len] = k[:, :trunk_len, :1]
        v[:, :trunk_len] = v[:, :trunk_len, :1]
    # The shared dispatch's mask: trunk and each row's prefix valid, the
    # right-padded gap to the bucket masked, the decode slots filling.
    mask = torch.ones((B, T), dtype=torch.int32, device=dev)
    for b in range(B):
        lo = max(trunk_len, T // 2) + (b * 7) % max(T // 4, 1)
        mask[b, lo:lo + 5 + b % 9] = 0
    mask[:, T - 3:] = 0                     # decode slots not yet written
    kpos = torch.clamp_min(torch.cumsum(mask, -1, dtype=torch.int32) - 1, 0)
    qpos = kpos.max(dim=-1).values.to(torch.int32)
    if S is not None:
        qpos = (qpos[:, None] - (S - 1)
                + torch.arange(S, device=dev)[None, :]).to(torch.int32)
    return q, k, v, qpos, mask, kpos


def decode_work(q, k, mask, trunk_len, hd, kpos=None, qpos=None):
    """Bytes and flops the decode function needs on these inputs: q, the
    valid-or-not K/V slots (each row's own, the trunk's once), the int
    arrays, the output; two flops per multiply-add of QK^T and PV over
    the keys each query may see. q is (B, H, hd), or (B, S, H, hd) with
    ``kpos``/``qpos`` for a verify window (each query its own keys)."""
    q4 = q if q.dim() == 4 else q[:, None]
    B, S, H, _ = q4.shape
    K, T = k.shape[0], k.shape[1]
    tk = trunk_splits(trunk_len, T) * DECODE_SPLIT
    kv_slots = tk + (T - tk) * B
    kv_bytes = 2 * K * kv_slots * hd * k.element_size()
    int_bytes = 4 * (2 * B * T + B * S)
    byts = nbytes(q) * 2 + kv_bytes + int_bytes
    if qpos is None:
        pairs = float(mask.sum())
    else:
        pairs = float(((mask > 0)[:, None, :]
                       & (kpos[:, None, :] <= qpos[:, :, None])).sum())
    return byts, 4.0 * H * hd * pairs


def _gqa(grouped: bool) -> dict:
    return {"enable_gqa": True} if grouped and _SDPA_GQA else {}


def _sdpa_kv(k, v, G):
    """K/V for the SDPA yardstick, (B, K, T, hd); repeated to the query
    heads (outside the timed call) where SDPA cannot group them."""
    if G > 1 and not _SDPA_GQA:
        return k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
    return k, v


def check_decode(gen, label, B, H, K, hd, T, trunk_len, alibi, results):
    q, k, v, qpos, mask, kpos = decode_inputs(gen, B, H, K, hd, T, trunk_len)
    slopes = decoder.alibi_slopes(H, DEV) if alibi else None
    args = (q, k, v, qpos, mask)
    kw = dict(key_positions=kpos, alibi_slopes=slopes)
    flat = ops.flash_decode(*args, **kw)
    ref = flash_decode_plain(*args, **kw)
    torch.cuda.synchronize()
    err_flat = check_close(f"flash_decode[{label}]", flat, ref)
    rows = []
    bias = torch.where((mask > 0)[:, None, None, :], 0.0, float("-inf"))
    if alibi:
        bias = bias + slopes[None, :, None, None] * kpos.float()[:, None, None, :]
    kb, vb = _sdpa_kv(k.permute(2, 0, 1, 3), v.permute(2, 0, 1, 3), H // K)
    bias = bias.to(q.dtype)

    def sdpa():
        return F.scaled_dot_product_attention(q[:, :, None, :], kb, vb,
                                              attn_mask=bias, **_gqa(K != H))

    lib_ms = time_ms(sdpa)
    byts, flops = decode_work(q, k, mask, 0, hd)
    b_ms, b_by = bound(byts, flops)
    rows.append(dict(kernel="flash_decode", case=label, B=B, H=H, K=K, hd=hd,
                     T=T, max_abs_err=err_flat,
                     kernel_ms=time_ms(lambda: ops.flash_decode(*args, **kw)),
                     plain_ms=time_ms(lambda: flash_decode_plain(*args, **kw)),
                     library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by))
    if trunk_len:
        tkw = dict(kw, trunk_len=trunk_len)
        trunk = ops.flash_decode_trunk(*args, **tkw)
        tref = flash_decode_trunk_plain(*args, **tkw)
        torch.cuda.synchronize()
        err_trunk = check_close(f"flash_decode_trunk[{label}]", trunk, tref)
        if not torch.equal(trunk, flat):
            raise AssertionError(f"flash_decode_trunk[{label}] is not bitwise "
                                 f"the flat kernel")
        byts, flops = decode_work(q, k, mask, trunk_len, hd)
        b_ms, b_by = bound(byts, flops)
        # Its legs one launch at a time, the tail leg beside its own bound.
        legs = mq_trunk_legs((q[:, None], k, v, qpos[:, None], mask), kw,
                             trunk_len, bias)
        rows.append(dict(
            kernel="flash_decode_trunk", case=label, B=B, H=H, K=K, hd=hd,
            T=T, trunk_len=trunk_len, max_abs_err=err_trunk,
            bitwise_equal_flat=True,
            kernel_ms=time_ms(lambda: ops.flash_decode_trunk(*args, **tkw)),
            plain_ms=time_ms(lambda: flash_decode_trunk_plain(*args, **tkw)),
            library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, **legs))
    for row in rows:
        log(json.dumps(row))
        results.append(row)


def check_decode_mq(gen, label, B, S, H, K, hd, T, trunk_len, alibi,
                    results):
    """The multi-query kernels at a verify window's shape: against their
    plain versions, query j bitwise the single-query kernel, and the
    trunk kernel (at ``trunk_len``) bitwise the flat one."""
    q, k, v, qpos, mask, kpos = decode_inputs(gen, B, H, K, hd, T, trunk_len,
                                              S=S)
    slopes = decoder.alibi_slopes(H, DEV) if alibi else None
    args = (q, k, v, qpos, mask)
    kw = dict(key_positions=kpos, alibi_slopes=slopes)
    mq = ops.flash_decode_mq(*args, **kw)
    ref = flash_decode_mq_plain(*args, **kw)
    torch.cuda.synchronize()
    err = check_close(f"flash_decode_mq[{label}]", mq, ref)
    for j in range(S):
        one = ops.flash_decode(q[:, j].contiguous(), k, v,
                               qpos[:, j].contiguous(), mask, **kw)
        if not torch.equal(one, mq[:, j]):
            raise AssertionError(f"flash_decode_mq[{label}] query {j} is not "
                                 f"bitwise the single-query kernel")
    valid = ((mask > 0)[:, None, :]
             & (kpos[:, None, :] <= qpos[:, :, None]))          # (B, S, T)
    bias = torch.where(valid[:, None], 0.0, float("-inf"))
    if alibi:
        bias = bias + slopes[None, :, None, None] * kpos.float()[:, None, None, :]
    bias = bias.to(q.dtype)
    kb, vb = _sdpa_kv(k.permute(2, 0, 1, 3), v.permute(2, 0, 1, 3), H // K)
    qh = q.permute(0, 2, 1, 3)

    def sdpa():
        return F.scaled_dot_product_attention(qh, kb, vb, attn_mask=bias,
                                              **_gqa(K != H))

    lib_ms = time_ms(sdpa)
    rows = []
    byts, flops = decode_work(q, k, mask, 0, hd, kpos, qpos)
    b_ms, b_by = bound(byts, flops)
    rows.append(dict(
        kernel="flash_decode_mq", case=label, B=B, S=S, H=H, K=K, hd=hd, T=T,
        max_abs_err=err, bitwise_equal_single_query=True,
        kernel_ms=time_ms(lambda: ops.flash_decode_mq(*args, **kw)),
        plain_ms=time_ms(lambda: flash_decode_mq_plain(*args, **kw)),
        library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by))
    tkw = dict(kw, trunk_len=trunk_len)
    trunk = ops.flash_decode_mq_trunk(*args, **tkw)
    tref = flash_decode_mq_trunk_plain(*args, **tkw)
    torch.cuda.synchronize()
    err_trunk = check_close(f"flash_decode_mq_trunk[{label}]", trunk, tref)
    if not torch.equal(trunk, mq):
        raise AssertionError(f"flash_decode_mq_trunk[{label}] is not bitwise "
                             f"flash_decode_mq")
    byts, flops = decode_work(q, k, mask, trunk_len, hd, kpos, qpos)
    b_ms, b_by = bound(byts, flops)
    rows.append(dict(
        kernel="flash_decode_mq_trunk", case=label, B=B, S=S, H=H, K=K,
        hd=hd, T=T, trunk_len=trunk_len, max_abs_err=err_trunk,
        bitwise_equal_flat=True,
        kernel_ms=time_ms(lambda: ops.flash_decode_mq_trunk(*args, **tkw)),
        plain_ms=time_ms(lambda: flash_decode_mq_trunk_plain(*args, **tkw)),
        library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
        **mq_trunk_legs(args, kw, trunk_len, bias)))
    for row in rows:
        log(json.dumps(row))
        results.append(row)


def mq_trunk_legs(args, kw, trunk_len, bias):
    """The launches of ``flash_decode_mq_trunk`` timed one at a time: the
    trunk leg, the row leg over the tail splits, the merge. The tail leg
    beside its own bound (q, the tail's K/V slots of every row, the int
    arrays, the partials it writes; the products over the tail keys each
    query may see) and beside the plain multi-query function and SDPA on
    the tail keys alone."""
    q, k, v, qpos, mask = args
    kpos = kw["key_positions"]
    _, legs = decode_legs(*args, trunk_len=trunk_len, **kw)
    key = {"trunk": "trunk_leg_ms", "rows": "tail_leg_ms", "merge": "merge_ms"}
    times = {key[name]: time_ms(fn) for name, fn in legs.items()}
    tk = trunk_splits(trunk_len, k.shape[1]) * DECODE_SPLIT
    B, S, H, hd = q.shape
    K, T = k.shape[0], k.shape[1]
    kt, vt = k[:, tk:].contiguous(), v[:, tk:].contiguous()
    mt, pt = mask[:, tk:].contiguous(), kpos[:, tk:].contiguous()
    ns_tail = -(-(T - tk) // DECODE_SPLIT)
    partial_bytes = B * K * ns_tail * S * (H // K) * (hd + 2) * 4
    pairs = float(((mt > 0)[:, None, :] & (pt[:, None, :] <= qpos[:, :, None])).sum())
    byts = (nbytes(q, kt, vt, qpos) + 4 * 2 * mt.numel() + partial_bytes)
    b_ms, b_by = bound(byts, 4.0 * H * hd * pairs)
    tkw = dict(key_positions=pt, alibi_slopes=kw["alibi_slopes"])
    bt = bias[..., tk:].contiguous()
    kb, vb = _sdpa_kv(kt.permute(2, 0, 1, 3), vt.permute(2, 0, 1, 3), H // K)
    qh = q.permute(0, 2, 1, 3)

    def sdpa():
        return F.scaled_dot_product_attention(qh, kb, vb, attn_mask=bt,
                                              **_gqa(K != H))

    return dict(times, tail_leg_bound_ms=b_ms, tail_leg_bound_by=b_by,
                tail_leg_plain_ms=time_ms(lambda: flash_decode_mq_plain(
                    q, kt, vt, qpos, mt, **tkw)),
                tail_leg_library_ms=time_ms(sdpa))


def check_cascade(gen, label, B, R, H, K, hd, Tt, alibi, results):
    dev = DEV
    bf = torch.bfloat16

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    q, sk, sv = rnd(B, R, H, hd), rnd(B, R, K, hd), rnd(B, R, K, hd)
    tk, tv = rnd(K, Tt, hd), rnd(K, Tt, hd)
    mask = torch.ones((B, R), dtype=torch.int32, device=dev)
    for b in range(B):
        mask[b, R - (b * 5) % R:] = 0       # ragged right-padded windows
    qpos = (Tt + torch.clamp_min(torch.cumsum(mask, -1, dtype=torch.int32) - 1,
                                 0)).to(torch.int32)
    slopes = decoder.alibi_slopes(H, dev) if alibi else None
    args = (q, sk, sv, tk, tv, mask, qpos)
    got = ops.cascade_attention(*args, alibi_slopes=slopes)
    ref = cascade_attention_plain(*args, alibi_slopes=slopes)
    torch.cuda.synchronize()
    err = check_close(f"cascade_attention[{label}]", got, ref)
    # Fused == two-leg, bitwise: the trunk leg's partials, then the
    # suffix merge, give the fused kernel's bits.
    o_t, m_t, l_t = ops.cascade_prefix(q, tk, tv, slopes)
    sm_args = (q, sk, sv, o_t, m_t, l_t, mask, qpos, slopes)
    pair = ops.cascade_suffix_merge(*sm_args)
    if not torch.equal(got, pair):
        raise AssertionError(f"cascade_attention[{label}]: fused is not bitwise "
                             f"cascade_prefix + cascade_suffix_merge")
    err_sm = check_close(f"cascade_suffix_merge[{label}]", pair,
                         suffix_merge_plain(*sm_args))

    # Yardstick: SDPA over trunk + window keys under the same mask.
    G = H // K
    keys = torch.cat([tk[None].expand(B, -1, -1, -1),
                      sk.permute(0, 2, 1, 3)], dim=2)        # (B, K, Tt+R, hd)
    vals = torch.cat([tv[None].expand(B, -1, -1, -1),
                      sv.permute(0, 2, 1, 3)], dim=2)
    causal = ((mask[:, None, :] > 0)
              & (qpos[:, None, :] <= qpos[:, :, None]))      # (B, Rq, Rk)
    allowed = torch.cat([torch.ones((B, R, Tt), dtype=torch.bool, device=dev),
                         causal], dim=-1)
    kp = torch.cat([torch.arange(Tt, device=dev)[None].expand(B, -1).float(),
                    qpos.float()], dim=-1)
    bias = torch.where(allowed[:, None], 0.0, float("-inf"))
    if alibi:
        bias = bias + slopes[None, :, None, None] * kp[:, None, None, :]
    bias = bias.to(bf)
    qh = q.permute(0, 2, 1, 3)
    keys, vals = _sdpa_kv(keys, vals, G)

    def sdpa():
        return F.scaled_dot_product_attention(qh, keys, vals, attn_mask=bias,
                                              **_gqa(G > 1))

    pairs = float(Tt * B * R + causal.sum())
    flops = 4.0 * H * hd * pairs
    byts = nbytes(q, sk, sv, tk, tv, mask, qpos, slopes) + nbytes(q)
    b_ms, b_by = bound(byts, flops)
    row = dict(kernel="cascade_attention", case=label, B=B, R=R, H=H, K=K,
               hd=hd, Tt=Tt, max_abs_err=err,
               kernel_ms=time_ms(lambda: ops.cascade_attention(
                   *args, alibi_slopes=slopes)),
               plain_ms=time_ms(lambda: cascade_attention_plain(
                   *args, alibi_slopes=slopes), iters=3),
               library_ms=time_ms(sdpa), bound_ms=b_ms, bound_by=b_by,
               fused_bitwise_two_leg=True)
    log(json.dumps(row))
    results.append(row)
    sm_flops = 4.0 * H * hd * float(causal.sum())
    sm_bytes = (nbytes(q, sk, sv, o_t, m_t, l_t, mask, qpos, slopes)
                + nbytes(q))
    b_ms, b_by = bound(sm_bytes, sm_flops)
    row = dict(kernel="cascade_suffix_merge", case=label, B=B, R=R, H=H, K=K,
               hd=hd, max_abs_err=err_sm,
               kernel_ms=time_ms(lambda: ops.cascade_suffix_merge(*sm_args)),
               plain_ms=time_ms(lambda: suffix_merge_plain(*sm_args), iters=3),
               library_ms=None, bound_ms=b_ms, bound_by=b_by)
    log(json.dumps(row))
    results.append(row)


def check_prefix(gen, label, B, R, H, K, hd, Tt, alibi, layers, results):
    """The trunk-leg kernels (float32 and int8 QK^T) against their plain
    versions: (o, m, l) within atol = rtol = 1e-2, and with int8 the row
    max m bitwise (the payloads and s32 dots are exact and fold in the
    same order). SDPA over the trunk with the same ALiBi bias is the
    float kernel's yardstick; no PyTorch call computes int8 QK^T. Then
    the trunk keys' quantization pass at its main-path shape, every
    layer's keys at once ((layers * K * Tt, hd) rows, as
    ``decoder.cascade_extend`` calls it), bitwise ``dynamic_quant``."""
    dev = DEV
    bf = torch.bfloat16
    q = torch.randn((B, R, H, hd), generator=gen, device=dev).to(bf)
    tk = torch.randn((K, Tt, hd), generator=gen, device=dev).to(bf)
    tv = torch.randn((K, Tt, hd), generator=gen, device=dev).to(bf)
    slopes = decoder.alibi_slopes(H, dev) if alibi else None
    G = H // K
    bias = None
    if alibi:
        bias = (slopes[:, None, None]
                * torch.arange(Tt, device=dev).float()[None, None, :]
                ).to(bf)[None].expand(B, -1, R, -1)
    qh = q.permute(0, 2, 1, 3)
    keys, vals = _sdpa_kv(tk[None].expand(B, -1, -1, -1),
                          tv[None].expand(B, -1, -1, -1), G)

    def sdpa():
        return F.scaled_dot_product_attention(qh, keys, vals, attn_mask=bias,
                                              **_gqa(G > 1))

    lib_ms = time_ms(sdpa)
    n_q = B * R * H
    out_bytes = n_q * (hd + 2) * 4
    byts = nbytes(q, tk, tv, slopes) + out_bytes
    for name, kernel, plain in (
            ("cascade_prefix", ops.cascade_prefix, prefix_partials),
            ("cascade_prefix_int8", ops.cascade_prefix_int8,
             prefix_partials_int8)):
        got = kernel(q, tk, tv, slopes)
        ref = plain(q, tk, tv, slopes)
        torch.cuda.synchronize()
        err = max(check_close(f"{name}[{label}]/{part}", g, r)
                  for part, g, r in zip("oml", got, ref))
        int8 = name.endswith("int8")
        if int8 and not torch.equal(got[1], ref[1]):
            raise AssertionError(f"{name}[{label}]: row max is not bitwise "
                                 f"the plain twin's")
        pair_ops = 2.0 * n_q * Tt * hd                 # one product of QK^T or PV
        b_ms, b_by = bound(byts, pair_ops if int8 else 2 * pair_ops,
                           pair_ops if int8 else 0.0)
        row = dict(kernel=name, case=label, B=B, R=R, H=H, K=K, hd=hd, Tt=Tt,
                   max_abs_err=err, row_max_bitwise=int8 or None,
                   kernel_ms=time_ms(lambda: kernel(q, tk, tv, slopes)),
                   plain_ms=time_ms(lambda: plain(q, tk, tv, slopes), iters=3),
                   library_ms=None if int8 else lib_ms, bound_ms=b_ms,
                   bound_by=b_by)
        log(json.dumps(row))
        results.append(row)
    keys = torch.randn((layers * K * Tt, hd), generator=gen, device=dev).to(bf)
    kq, ks = ops.quantize_rows(keys)
    rq, rs = quant.dynamic_quant(keys)
    torch.cuda.synchronize()
    if not (torch.equal(kq, rq) and torch.equal(ks, rs)):
        raise AssertionError(f"quantize_rows[{label}]: not bitwise dynamic_quant")
    b_ms, b_by = bound(nbytes(keys, kq, ks), 0.0)
    row = dict(kernel="quantize_rows", case=label, rows=layers * K * Tt, hd=hd,
               max_abs_err=0.0, bitwise=True,
               kernel_ms=time_ms(lambda: ops.quantize_rows(keys)),
               plain_ms=time_ms(lambda: quant.dynamic_quant(keys), iters=3),
               library_ms=None, bound_ms=b_ms, bound_by=b_by)
    log(json.dumps(row))
    results.append(row)


def check_row_gemm(gen, label, M, K, N, results):
    """The row-invariant projection against torch.matmul (its plain
    version, and the library call) at a decode step's (M = B) or a verify
    window's (M = B * spec_k) rows: within bf16 rounding of the float32
    product, and the first rows bitwise the same rows taken alone."""
    x = torch.randn((M, K), generator=gen, device=DEV).to(torch.bfloat16)
    w = (torch.randn((K, N), generator=gen, device=DEV) * 0.02).to(torch.bfloat16)
    got = ops.row_gemm(x, w)
    err = check_close(f"row_gemm[{label}]", got, x.float() @ w.float())
    if not torch.equal(ops.row_gemm(x[:8], w), got[:8]):
        raise AssertionError(f"row_gemm[{label}]: rows depend on the row count")
    b_ms, b_by = bound(nbytes(x, w, got), 2.0 * M * K * N)
    row = dict(kernel="row_gemm", case=label, M=M, K=K, N=N, max_abs_err=err,
               splits=ops.gemm_splits(N, K),
               kernel_ms=time_ms(lambda: ops.row_gemm(x, w)),
               plain_ms=time_ms(lambda: row_gemm_plain(x, w)),
               library_ms=time_ms(lambda: torch.matmul(x, w)),
               bound_ms=b_ms, bound_by=b_by)
    log(json.dumps(row))
    results.append(row)


def check_row_norm(gen, label, M, D, floor_ms, results):
    """The row-invariant RMSNorm against the decoder's plain norm; the
    library yardstick is F.rms_norm where this PyTorch has it. Beside it
    the empty kernel's time (``floor_ms``), the floor of time_ms."""
    x = (torch.randn((M, D), generator=gen, device=DEV) * 2).to(torch.bfloat16)
    scale = torch.randn((D,), generator=gen, device=DEV).to(torch.bfloat16)
    eps = 1e-5
    got = ops.row_norm(x, scale, None, eps)
    err = check_close(f"row_norm[{label}]", got, row_norm_plain(x, scale, None, eps))
    if not torch.equal(ops.row_norm(x[:3], scale, None, eps), got[:3]):
        raise AssertionError(f"row_norm[{label}]: rows depend on the row count")
    lib = getattr(F, "rms_norm", None)
    b_ms, b_by = bound(nbytes(x, scale, got), 0.0)
    row = dict(kernel="row_norm", case=label, M=M, D=D, max_abs_err=err,
               kernel_ms=time_ms(lambda: ops.row_norm(x, scale, None, eps)),
               plain_ms=time_ms(lambda: row_norm_plain(x, scale, None, eps)),
               library_ms=(time_ms(lambda: lib(x, (D,), scale, eps))
                           if lib is not None else None),
               bound_ms=b_ms, bound_by=b_by, floor_ms=floor_ms)
    log(json.dumps(row))
    results.append(row)


def check_row_add_norm(gen, label, M, D, floor_ms, results):
    """The residual add and the RMSNorm after it in one launch: the sum
    bitwise torch's bf16 add, the norm bitwise ``row_norm`` of the sum and
    within the bar of the plain version, the first rows bitwise the same
    rows alone. No single PyTorch call computes both (library_ms null)."""
    x = (torch.randn((M, D), generator=gen, device=DEV) * 2).to(torch.bfloat16)
    d = torch.randn((M, D), generator=gen, device=DEV).to(torch.bfloat16)
    scale = torch.randn((D,), generator=gen, device=DEV).to(torch.bfloat16)
    eps = 1e-5
    s, h = ops.row_add_norm(x, d, scale, None, eps)
    if not torch.equal(s, x + d):
        raise AssertionError(f"row_add_norm[{label}]: the sum is not torch's bf16 add")
    if not torch.equal(h, ops.row_norm(s, scale, None, eps)):
        raise AssertionError(f"row_add_norm[{label}]: the norm is not row_norm of the sum")
    err = check_close(f"row_add_norm[{label}]", h,
                      row_add_norm_plain(x, d, scale, None, eps)[1])
    s3, h3 = ops.row_add_norm(x[:3], d[:3], scale, None, eps)
    if not (torch.equal(s3, s[:3]) and torch.equal(h3, h[:3])):
        raise AssertionError(f"row_add_norm[{label}]: rows depend on the row count")
    b_ms, b_by = bound(nbytes(x, d, scale, s, h), 0.0)
    row = dict(kernel="row_add_norm", case=label, M=M, D=D, max_abs_err=err,
               kernel_ms=time_ms(lambda: ops.row_add_norm(x, d, scale, None, eps)),
               plain_ms=time_ms(lambda: row_add_norm_plain(x, d, scale, None, eps)),
               library_ms=None, bound_ms=b_ms, bound_by=b_by, floor_ms=floor_ms)
    log(json.dumps(row))
    results.append(row)


def fold_inputs(gen, B, K, P, R):
    """One dispatch's fold inputs on the card: B readouts with every
    branch of the fold's predicate (NaN, negative and over-1
    probabilities, a zero-mass row, a confidence out of range, NaN and
    positive log-probs) and three pad rows (ridx = R) last."""
    yes = torch.rand(B, generator=gen, device=DEV) * 0.7
    no = torch.rand(B, generator=gen, device=DEV) * (1 - yes)
    wc = torch.rand(B, generator=gen, device=DEV) * 100
    lp = -torch.rand((B, K), generator=gen, device=DEV) * 5
    yes[1], no[2], yes[3], wc[4] = float("nan"), -0.01, 1.2, 100.5
    yes[5] = no[5] = 0.0
    lp[6, 3], lp[7, 0] = float("nan"), 0.5
    cells = torch.randperm(P * R, generator=gen, device=DEV)[:B]
    pidx, ridx = (cells // R).int(), (cells % R).int()
    ridx[-3:] = R
    return yes, no, wc, lp, pidx, ridx


def lattice_bits(acc):
    return {k: v.view(torch.int32) if v.dtype == torch.float32 else v
            for k, v in acc.items()}


# The fold's time in PR 12's call (its one-thread-a-row kernel, NVIDIA
# H100 80GB HBM3, 700 W), printed beside this run's.
FOLD_PR12_MS = {"5x2000/B32": 0.0084}


def check_stream_fold(gen, floor_ms, results):
    """The streaming-statistics fold against its plain twin on the card,
    bitwise: a (5, 2,000) lattice, B = 32 and 64 rows a dispatch, K = 20,
    pad rows and invalid rows, guard on and off, contiguous and strided
    (the grouped dispatch's row views) readouts, three folds and a refold
    of the first (idempotent). Timed at each B beside the empty kernel's
    floor (and its ratio to it) and PR 12's time; its bound is the bytes
    it must move (the B rows' readouts and coordinates read once, 16
    bytes stored a real row)."""
    P, R, K = STREAM_P, STREAM_R, STREAM_K
    for B in (BATCH, 2 * BATCH):
        for guard in (True, False):
            for strided in (False, True):
                kern = stream_stats.new_accum(P, R, DEV)
                plain = stream_stats.new_accum(P, R, DEV)
                batches = [fold_inputs(gen, B, K, P, R) for _ in range(3)]
                for yes, no, wc, lp, pidx, ridx in batches + batches[:1]:
                    if strided:
                        yes, no, wc = (torch.stack([t, t], 1)[:, 0]
                                       for t in (yes, no, wc))
                        lp = torch.stack([lp, lp], 1)[:, 0]
                    ops.stream_fold(kern, yes, no, wc, lp, pidx, ridx, guard)
                    stream_fold_plain(plain, yes, no, wc, lp, pidx, ridx,
                                      guard)
                torch.cuda.synchronize()
                got, ref = lattice_bits(kern), lattice_bits(plain)
                bad = [k for k in got if not torch.equal(got[k], ref[k])]
                if bad:
                    raise AssertionError(f"stream_fold (B={B}, guard={guard}, "
                                         f"strided={strided}): {bad} differ "
                                         f"from the plain twin")
                slots = {(int(p), int(r)) for b in batches
                         for p, r in zip(b[4][:-3], b[5][:-3])}
                if int(kern["filled"].sum()) != len(slots):
                    raise AssertionError("stream_fold: pad rows folded")
        rows = batches[0]
        acc = stream_stats.new_accum(P, R, DEV)
        real = int((rows[5] < R).sum())
        b_ms, b_by = bound(nbytes(*rows) + 16 * real, 0.0)
        label = f"{P}x{R}/B{B}"
        kernel_ms = time_ms(lambda: ops.stream_fold(acc, *rows))
        row = dict(kernel="stream_fold", case=label, P=P, R=R, B=B,
                   K=K, max_abs_err=0.0, kernel_ms=kernel_ms,
                   pr12_ms=FOLD_PR12_MS.get(label),
                   plain_ms=time_ms(lambda: stream_fold_plain(acc, *rows)),
                   library_ms=None, bound_ms=b_ms, bound_by=b_by,
                   floor_ms=floor_ms, floor_ratio=kernel_ms / floor_ms)
        log(json.dumps(row))
        results.append(row)


# The sampler at the card's vocabulary (llama-2-7b): one row, the
# rephraser's and the reasoning sweep's batch, the sweep's and the
# grouped dispatch's.
SAMPLE_V = 32000
SAMPLE_BATCHES = (1, 8, 32, 64)
# The sampler's times in PR 17's call (its ticket kernel, NVIDIA H100
# 80GB HBM3, 700 W), printed beside this run's.
SAMPLE_PR17_MS = {"B8/V32000/one_key": 0.0113, "B8/V32000/per_row": 0.0112,
                  "B32/V32000/one_key": 0.0192}
# SASS opcodes (the part before the first dot) by class, for the
# sampler's count an entry: the INT32 pipe's integer operations (IMAD,
# which the compiler also uses for adds and moves, issues on the FP32
# pipe and is counted apart), the FP32 pipe's, compares, loads and
# conversions; the rest (branches, barriers) is "other".
SASS_CLASSES = {
    "int32": {"IADD3", "IADD", "VIADD", "LOP3", "LOP", "SHF", "SHL", "SHR",
              "LEA", "SEL", "PRMT", "IMNMX", "VIMNMX", "MOV", "IABS", "POPC",
              "FLO", "BREV", "BMSK", "SGXT"},
    "imad": {"IMAD"},
    "fp32": {"FFMA", "FADD", "FMUL", "FMNMX", "FSEL", "MUFU", "FCHK"},
    "compare": {"ISETP", "FSETP", "PLOP3"},
    "load": {"LDG", "LD", "LDS", "LDC"},
    "convert": {"I2FP", "I2F", "F2I", "F2F", "FRND"},
}


def sample_sass_counts() -> dict:
    """Instructions an entry of the built sampler, from ``cuobjdump
    -sass`` of ``gumbel_argmax_kernel``: the kernel's main loop (its
    widest backward branch) by SASS_CLASSES, over the entries a loop
    iteration takes (``lir_sample_per_thread``); ``int32_ops`` adds the
    integer compares (ISETP) to the int32 class, ``total`` is every
    instruction of the loop. The division's slow path lies outside the
    loop (a call the check rarely takes) and is not counted."""
    ins, fn = [], None
    for line in _build.sass("sample").splitlines():
        found = re.search(r"Function : (\w+)", line)
        if found:
            fn = kernel_label(found.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                     r"([^;]*);", line)
        if m and fn == "gumbel_argmax_kernel":
            ins.append((int(m.group(1), 16), m.group(2).split(".")[0],
                        m.group(3)))
    loops = [(at, int(t.group(1), 16)) for at, op, rest in ins if op == "BRA"
             for t in [re.search(r"0x([0-9a-f]+)", rest)]
             if t and int(t.group(1), 16) < at]
    if not loops:
        raise AssertionError("sample_sass_counts: no loop in "
                             "gumbel_argmax_kernel's SASS")
    end, start = max(loops, key=lambda x: x[0] - x[1])
    body = [op for at, op, _ in ins if start <= at <= end]
    per = ops.sample._lib().lir_sample_per_thread()
    counts = {k: 0 for k in list(SASS_CLASSES) + ["other"]}
    ops_seen = {}
    for op in body:
        cls = next((k for k, v in SASS_CLASSES.items() if op in v), "other")
        counts[cls] += 1
        ops_seen[op] = ops_seen.get(op, 0) + 1
    out = {k: n / per for k, n in counts.items()}
    out["int32_ops"] = (counts["int32"] + ops_seen.get("ISETP", 0)) / per
    out["total"] = len(body) / per
    out["loop_instructions"] = len(body)
    out["entries_a_loop"] = per
    out["opcodes"] = dict(sorted(ops_seen.items(), key=lambda x: -x[1]))
    return out


def sample_inputs(gen, B: int, V: int, per_row: bool):
    """Logits (B, V) at a model's spread and one step's keys and offsets,
    made as ``generate.sample_keys`` makes them in each key mode."""
    logits = torch.randn((B, V), generator=gen, device=DEV) * 3.0
    key = torch.randint(0, 2**32, (B, 2), generator=gen, device=DEV,
                        dtype=torch.int64)
    keys, offsets = generate.sample_keys(key if per_row else key[0], B, V, 1,
                                         DEV)
    return logits, keys[0], offsets


def twin_gaps(logits, keys, offsets, temperature, rows, a=None, b=None):
    """Per row in ``rows``: the twin's perturbed-score gap between ids
    ``a[row]`` and ``b[row]`` (default: its top two candidates)."""
    scores = gumbel_scores_plain(logits, keys, offsets, temperature)
    out = []
    for r in rows:
        if a is None:
            top = torch.topk(scores[r], 2).values
            out.append(float(top[0] - top[1]))
        else:
            out.append(abs(float(scores[r, int(a[r])] - scores[r, int(b[r])])))
    return out


def sample_edge_cases(gen):
    """(label, logits, keys, offsets) beyond the timed shapes: an odd V
    and one smaller than a block's unit count; rows that are views of a
    wider tensor at a stride that is not a multiple of 4 (each row
    starts at another 16-byte phase); a row of NaNs (id 0), a row with
    NaNs at two places (the lower wins), and rows of exact ties (equal
    logits of 1e6 from V // 3 on: at temperature 1e-4 the scores round
    to one value, the lowest index wins across the cluster's blocks)."""
    cases = []
    for V in (32001, 50):
        logits, keys, offsets = sample_inputs(gen, 8, V, False)
        cases.append((f"B8/V{V}/one_key", logits, keys, offsets))
    V = SAMPLE_V
    wide = torch.randn((8, V + 3), generator=gen, device=DEV) * 3.0
    _, keys, offsets = sample_inputs(gen, 8, V, True)
    cases.append((f"B8/V{V}/strided{V + 3}", wide[:, 1:V + 1], keys,
                  offsets))
    logits, keys, offsets = sample_inputs(gen, 8, V, False)
    logits[0] = float("nan")
    logits[1, 17] = logits[1, V - 5] = float("nan")
    logits[2, V // 3:] = 1e6
    logits[3] = 1e6
    cases.append((f"B8/V{V}/nan_and_ties", logits, keys, offsets))
    return cases


def check_gumbel_argmax(gen, floor_ms, results):
    """The sampler kernel against its plain twin on the card at V =
    32,000 and B = 1, 8, 32 and 64 (one key and a key a row), and at the
    cases of :func:`sample_edge_cases`, four temperatures: the ids equal
    (a differing row prints the twin's top-2 gap, then fails), each case
    again after every timing loop has run (the kernel keeps nothing
    between launches). Timed beside the empty kernel's floor and PR 17's
    time, with the host microseconds a wrapper call (:func:`host_us`);
    its bound is the largest of the bytes it must move (the logits, keys
    and offsets read once, the ids written) over the memory rate, its
    INT32 operations over the INT32 rate and all its instructions over
    the issue rate, each an entry as :func:`sample_sass_counts` counts
    them in the built kernel."""
    counts = sample_sass_counts()
    log(json.dumps({"phase": "sass", "source": "sample.cu",
                    "kernel": "gumbel_argmax_kernel", "per_entry": counts}))
    V = SAMPLE_V
    cases = [(f"B{B}/V{V}/{'per_row' if per_row else 'one_key'}",
              *sample_inputs(gen, B, V, per_row))
             for B in SAMPLE_BATCHES for per_row in (False, True)]
    edges = sample_edge_cases(gen)

    def same(label, logits, keys, offsets, temp, when):
        got = ops.gumbel_argmax(logits, keys, offsets, temp)
        ref = gumbel_argmax_plain(logits, keys, offsets, temp)
        bad = (got != ref).nonzero().flatten().tolist()
        if bad:
            log(json.dumps({
                "phase": "gumbel_argmax_mismatch", "case": label,
                "when": when, "temperature": temp, "rows": bad,
                "twin_top2_gap": twin_gaps(logits, keys, offsets, temp,
                                           bad)}))
            raise AssertionError(f"gumbel_argmax {label} (T={temp}, {when}): "
                                 f"rows {bad} differ from the plain twin")

    for case in cases + edges:
        for temp in (0.5, 0.9, 1.0, 1e-4):
            same(*case, temp, "first")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, logits, keys, offsets in cases:
        B = logits.shape[0]
        t_bytes = (nbytes(logits, keys, offsets) + 4 * B) \
            / HBM_BYTES_PER_S * 1e3
        t_ops = max(B * V * counts["int32_ops"] / INT32_OP_PER_S,
                    B * V * counts["total"] / ISSUE_PER_S) * 1e3
        p = ops.sample.plan(B, V, sms)
        row = dict(kernel="gumbel_argmax", case=label, B=B, V=V,
                   cluster=p.cluster, blocks=p.blocks, max_abs_err=0.0,
                   kernel_ms=time_ms(lambda: ops.gumbel_argmax(
                       logits, keys, offsets, 0.9)),
                   pr17_ms=SAMPLE_PR17_MS.get(label),
                   host_us=host_us(lambda: ops.gumbel_argmax(
                       logits, keys, offsets, 0.9)),
                   plain_ms=time_ms(lambda: gumbel_argmax_plain(
                       logits, keys, offsets, 0.9)),
                   library_ms=None, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   floor_ms=floor_ms)
        log(json.dumps(row))
        results.append(row)
    for case in cases + edges:
        for temp in (0.5, 0.9, 1.0, 1e-4):
            same(*case, temp, "after timing")


# B-1's times in PR 18's call (its first kernel, NVIDIA H100 80GB HBM3,
# 700 W), printed beside this run's at the same cases.
KV8_PR18_MS = {"llama2-7b/decode": 0.2602, "llama2-7b/verify": 0.2813,
               "llama2-7b/extend16": 0.3552, "mistral-7b/gqa": 0.1218,
               "bloom-7b1/alibi": 0.2648}
# The int8-KV phase's rows/s in PR 18's two calls (dev2, final): chain
# grid and flat grid.
KV8_PR18_ROWS_PER_S = {"chain": (39.19, 32.83), "flat": (17.25, 16.88)}
# The piggyback chain's cache extent at bucket 96 (PR 18's chain phase)
# and the flat grid's promoted tail at bucket 1,024, with the speculative
# window.
KV8_CHAIN_T = 156
KV8_FLAT_TAIL_T = 1088


def kv8_inputs(gen, B, S, H, K, hd, T, alibi):
    """:func:`decode_inputs` with the cache quantized per vector as the
    int8-KV engine stores it: the kernel's arguments and ALiBi slopes."""
    q, k, v, qpos, mask, kpos = decode_inputs(gen, B, H, K, hd, T, 0, S=S)
    kq, ks = quant.dynamic_quant(k)
    vq, vs = quant.dynamic_quant(v)
    slopes = decoder.alibi_slopes(H, DEV) if alibi else None
    return (q, kq, ks, vq, vs, qpos, mask, kpos), slopes


def check_kv_int8_attention(gen, label, B, S, H, K, hd, T, alibi, results):
    """The int8-KV attention kernel against its plain twin at a decode
    step's (S = 1), a verify window's or an extension's shape: the
    decode inputs of :func:`decode_inputs` with the cache quantized per
    vector as the engine stores it. The s32 scores (the kernel's
    ``s32_out``) bitwise the twin's; the output within ``tie_bar``: the
    two float chains may put a value of the probabilities on either side
    of a rounding tie, so each output element may differ by one int8
    level of pw (times its scale) at each key whose pw sits within 1e-2
    of a tie, times the value payload there, plus a unit in the last
    place of the output dtype; a second launch bitwise the first. Timed
    beside its bound (the q, the int8 payloads and float32 scales of K
    and V, the int arrays and the output; two s8 products over every key
    at the int8 rate), its share of the bound, the launch plan (split,
    rows a block, IMMA or dp4a) and PR 18's time of the case; no library
    call computes it (``library_ms`` None)."""
    args, slopes = kv8_inputs(gen, B, S, H, K, hd, T, alibi)
    q, kq = args[0], args[1]
    s32 = torch.empty((B, H, S, T), dtype=torch.int32, device=DEV)
    got = ops.kv_int8_attention(*args, alibi_slopes=slopes, s32_out=s32)
    ref = kv_int8_attention_plain(*args, alibi_slopes=slopes)
    bar = tie_bar(*args, alibi_slopes=slopes)
    torch.cuda.synchronize()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"kv_int8_attention[{label}]: non-finite output")
    if not torch.equal(s32, qk_s32_plain(q, kq)):
        raise AssertionError(f"kv_int8_attention[{label}]: s32 scores differ "
                             f"from the twin's")
    err = (got.float() - ref.float()).abs()
    over = int((err > bar).sum())
    if over:
        raise AssertionError(f"kv_int8_attention[{label}]: {over} outputs "
                             f"past the tie bar (max |err| "
                             f"{float(err.max()):.3e})")
    if not torch.equal(ops.kv_int8_attention(*args, alibi_slopes=slopes),
                       got):
        raise AssertionError(f"kv_int8_attention[{label}]: a second launch "
                             f"gave other bits")
    byts = nbytes(*args, slopes) + nbytes(got)
    b_ms, b_by = bound(byts, 0.0, 4.0 * B * H * S * T * hd)
    pl = kv8_plan(T, hd, S * (H // K))
    k_ms = time_ms(lambda: ops.kv_int8_attention(*args, alibi_slopes=slopes))
    row = dict(kernel="kv_int8_attention", case=label, B=B, S=S, H=H, K=K,
               hd=hd, T=T, max_abs_err=float(err.max()),
               max_tie_bar=float(bar.max()), s32_bitwise=True,
               same_bits_relaunched=True,
               elements_differing=int((err > 0).sum()),
               splits=pl.splits, slice=pl.slice, rows_per_block=pl.rows,
               row_chunks=pl.chunks, route="imma" if pl.mma else "dp4a",
               kernel_ms=k_ms,
               plain_ms=time_ms(lambda: kv_int8_attention_plain(
                   *args, alibi_slopes=slopes), iters=3),
               library_ms=None, bound_ms=b_ms, bound_by=b_by,
               bound_fraction=b_ms / k_ms,
               pr18_ms=KV8_PR18_MS.get(label))
    log(json.dumps(row))
    results.append(row)


def check_kv_int8_row_invariance(gen, label, H, K, hd, T, S):
    """One query row's output alone (B = 1, S = 1) and inside a B = BATCH,
    S = ``S`` launch: bitwise equal. The split and every float reduction
    order come from T alone, and the integer products are exact on
    either route (here dp4a alone, and dp4a or IMMA in the batch by S *
    G), so the row's bits cannot depend on the launch that holds it."""
    args, _ = kv8_inputs(gen, BATCH, S, H, K, hd, T, False)
    q, kq, ks, vq, vs, qpos, mask, kpos = args
    full = ops.kv_int8_attention(*args)
    checked = []
    for b, s in ((0, 0), (BATCH // 2 + 1, S - 1), (BATCH - 1, S // 2)):
        alone = ops.kv_int8_attention(
            q[b:b + 1, s:s + 1].contiguous(),
            *(x[:, :, b:b + 1].contiguous() for x in (kq, ks, vq, vs)),
            qpos[b:b + 1, s:s + 1].contiguous(), mask[b:b + 1].contiguous(),
            kpos[b:b + 1].contiguous())
        torch.cuda.synchronize()
        if not torch.equal(alone[0, 0], full[b, s]):
            raise AssertionError(f"kv_int8_attention row invariance "
                                 f"[{label}]: row ({b}, {s}) alone differs "
                                 f"from the B = {BATCH}, S = {S} launch")
        checked.append([b, s])
    G = H // K
    log(json.dumps({"phase": "kv_int8_row_invariance", "case": label,
                    "T": T, "rows_checked": checked, "bitwise": True,
                    "route_alone": "imma" if kv8_plan(T, hd, G).mma
                    else "dp4a",
                    "route_batch": "imma" if kv8_plan(T, hd, S * G).mma
                    else "dp4a"}))


def check_flash_attention(gen, label, B, S, H, K, hd, alibi, results):
    """The prefill flash kernel against its plain version at a bucket's
    shape: each row left-padded by its own amount (as the sweep pads
    prompts), one row with a hole. SDPA with the same causal mask, key
    mask and ALiBi bias is the yardstick."""
    dev = DEV
    bf = torch.bfloat16
    q = torch.randn((B, S, H, hd), generator=gen, device=dev).to(bf)
    k = torch.randn((B, S, K, hd), generator=gen, device=dev).to(bf)
    v = torch.randn((B, S, K, hd), generator=gen, device=dev).to(bf)
    mask = torch.ones((B, S), dtype=torch.int32, device=dev)
    for b in range(B):
        mask[b, :(b * 7) % max(S // 2, 1)] = 0
    mask[1, S // 2:S // 2 + 3] = 0
    kpos = torch.clamp_min(torch.cumsum(mask, -1, dtype=torch.int32) - 1, 0)
    slopes = decoder.alibi_slopes(H, dev) if alibi else None
    kw = dict(key_mask=mask, alibi_slopes=slopes,
              key_positions=kpos if alibi else None)
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, **kw)
    route = next(r for r, n in ops.flash_attention.route_launches.items() if n)
    ref = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    err = check_close(f"flash_attention[{label}]", got, ref)
    idx = torch.arange(S, device=dev)
    allowed = (mask[:, None, :] > 0) & (idx[None, None, :] <= idx[None, :, None])
    bias = torch.where(allowed[:, None], 0.0, float("-inf"))
    if alibi:
        bias = bias + slopes[None, :, None, None] * kpos.float()[:, None, None, :]
    bias = bias.to(bf)
    kb, vb = _sdpa_kv(k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3), H // K)
    qh = q.permute(0, 2, 1, 3)

    def sdpa():
        return F.scaled_dot_product_attention(qh, kb, vb, attn_mask=bias,
                                              **_gqa(K != H))

    pairs = float(allowed.sum())
    byts = nbytes(q, k, v, mask, kpos if alibi else None, slopes) + nbytes(q)
    b_ms, b_by = bound(byts, 4.0 * H * hd * pairs)
    row = dict(kernel="flash_attention", case=label, B=B, S=S, H=H, K=K,
               hd=hd, route=route, max_abs_err=err,
               kernel_ms=time_ms(lambda: ops.flash_attention(q, k, v, **kw)),
               plain_ms=time_ms(lambda: flash_attention_plain(q, k, v, **kw),
                                iters=3),
               library_ms=time_ms(sdpa), bound_ms=b_ms, bound_by=b_by)
    log(json.dumps(row))
    results.append(row)


def _shared_dispatch(eng, rows, bucket):
    """One shared dispatch of the small slice: each row's binary and
    confidence prompts differ in their last two tokens."""
    n = len(rows)
    return eng.decode_fused_shared(
        [""] * n, [""] * n, np.full(n, 5, np.int32), np.full(n, 9, np.int32),
        new_tokens=3, conf_tokens=4, pretokenized_a=[r + [5, 6] for r in rows],
        pretokenized_b=[r + [7, 8] for r in rows], bucket=bucket,
        reuse_cache=True, n_real=n)


def compare_pos0(label, spec_outs, seq_outs):
    """The speculative route against the sequential one on the same
    cells: the first generated id and the position-0 readouts bitwise.
    Returns the share of the later generated ids that agree, and per
    branch the share of rows whose ids still all agree up to each
    position (a near-tie flip at one position changes every later id of
    its row)."""
    agree = total = 0
    prefix_agree = {}
    for fmt, a, b in zip(("binary", "confidence"), spec_outs, seq_outs):
        for name in POS0_FIELDS:
            if not torch.equal(getattr(a, name), getattr(b, name)):
                raise AssertionError(f"{label}/{fmt}: {name} is not bitwise "
                                     f"the sequential route's")
        for name in ("p_yes", "p_no", "generated"):
            if not torch.equal(getattr(a, name)[:, 0], getattr(b, name)[:, 0]):
                raise AssertionError(f"{label}/{fmt}: {name}[:, 0] is not "
                                     f"bitwise the sequential route's")
        same = a.generated[:, 1:] == b.generated[:, 1:]
        agree += int(same.sum())
        total += same.numel()
        rows_ok = torch.cumprod((a.generated == b.generated).int(), dim=1)
        prefix_agree[fmt] = rows_ok.float().mean(dim=0).tolist()
    return agree / max(total, 1), prefix_agree


def full_accept_check(params, cfg):
    """generate.greedy_decode_fused_shared_spec given the sequential
    stream as its drafts: the same ids, in ceil(T / k) windows or fewer
    a branch."""
    rng = np.random.default_rng(2)
    B, k, Ta, Tb = 4, 4, 4, 8
    rows = [[int(x) for x in rng.integers(3, 900, 20 + r)] for r in range(B)]
    prefix, prefix_mask = tok.right_pad_ids(rows, 32, 0)
    sfx_a, sfx_a_mask = tok.right_pad_ids([[5, 6]] * B, 8, 0)
    sfx_b, sfx_b_mask = tok.right_pad_ids([[7, 8]] * B, 8, 0)
    def t(a, dt=torch.int32):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=DEV)

    args = (params, cfg, t(prefix), t(prefix_mask), t(sfx_a), t(sfx_a_mask),
            t(sfx_b), t(sfx_b_mask), t([5] * B), t([9] * B), t([10, 11, 12]),
            t([1.0, 2.0, 3.0], torch.float32))
    seq_a, seq_b = generate.greedy_decode_fused_shared(
        *args, max_new_a=Ta, max_new_b=Tb)
    spec_args = []
    for sfx, seq, T in ((sfx_a, seq_a, Ta), (sfx_b, seq_b, Tb)):
        ctx = [r + list(map(int, s[:np.count_nonzero(s)])) for r, s in
               zip(rows, sfx)]
        width = 32 + 8 + T
        c = np.zeros((B, width), np.int32)
        for r, row in enumerate(ctx):
            c[r, :len(row)] = row
        spec_args += [t(c), t([len(r) for r in ctx]), seq.generated,
                      t([T] * B)]
    out_a, out_b, sp_a, sp_b = generate.greedy_decode_fused_shared_spec(
        *args, *spec_args, max_new_a=Ta, max_new_b=Tb, spec_k=k)
    for name, out, seq, sp, T in (("binary", out_a, seq_a, sp_a, Ta),
                                  ("confidence", out_b, seq_b, sp_b, Tb)):
        if not torch.equal(out.generated, seq.generated):
            raise AssertionError(f"full-accept {name}: ids differ from the "
                                 f"sequential stream")
        if int(sp.chunks) > -(-T // k):
            raise AssertionError(f"full-accept {name}: {int(sp.chunks)} "
                                 f"windows for {T} tokens at k = {k}")
    return int(sp_a.chunks), int(sp_b.chunks)


def small_model():
    """The small float32 model of the small checks, its weights scaled up
    so that the logits spread: (cfg, params on the CPU, the same on the
    card)."""
    cfg = registry.ModelConfig(name="smoke-tiny", vocab_size=1000,
                               hidden_size=128, n_layers=2, n_heads=4,
                               n_kv_heads=2, intermediate_size=256,
                               max_seq_len=512)
    params_cpu = decoder.init_params(cfg, seed=1, device="cpu")
    for name, w in params_cpu["layers"].items():
        if name.startswith("w"):
            w.mul_(4.0)
    return cfg, params_cpu, _to_device(params_cpu, DEV)


def small_slice_check(cfg, params_cpu, params_gpu):
    """The whole slice at a small float32 size: the engine on the card
    (kernels) against the engine on the CPU (plain versions), same
    params, through a cascade dispatch and a speculative one (token ids
    exact, floats within 1e-4); on the card, the speculative dispatch
    against the sequential one (ids exact, position-0 readouts bitwise)
    and a speculative run given the sequential stream as its drafts."""
    rt = RuntimeConfig(batch_size=4, max_new_tokens=6)
    rng = np.random.default_rng(0)
    head = [int(x) for x in rng.integers(3, 900, 80)]
    trunk_rows = [head + [int(x) for x in rng.integers(3, 900, 5 + r)]
                  for r in range(4)]
    flat_rows = [[int(x) for x in rng.integers(3, 900, 40 + r)]
                 for r in range(4)]
    outs = []
    for params, dev in ((params_gpu, DEV), (params_cpu, "cpu")):
        eng = ScoringEngine(params, cfg, FakeTokenizer(), rt, device=dev)
        casc = _shared_dispatch(eng, trunk_rows, 96)
        if eng.cascade_stats["cascade_dispatches"] != 1:
            raise AssertionError("small slice did not take the cascade")
        spec = _shared_dispatch(eng, flat_rows, 64)
        if eng.spec_stats["spec_dispatches"] != 1:
            raise AssertionError("small slice did not take the spec route")
        outs.append((casc, spec))
    for route, card, cpu in zip(("cascade", "spec"), *outs):
        for a, b in zip(card, cpu):
            if not torch.equal(a.generated.cpu(), b.generated):
                raise AssertionError(f"small slice {route}: generated ids "
                                     f"differ card vs CPU")
            for name in ("p_yes", "p_no", "topk_logprobs",
                         "weighted_confidence"):
                diff = (getattr(a, name).cpu() - getattr(b, name)).abs().max()
                if not diff <= 1e-4:
                    raise AssertionError(f"small slice {route}: {name} "
                                         f"differs by {diff}")
    seq_eng = ScoringEngine(params_gpu, cfg, FakeTokenizer(),
                            RuntimeConfig(batch_size=4, max_new_tokens=6,
                                          spec_decode=False), device=DEV)
    seq = _shared_dispatch(seq_eng, flat_rows, 64)
    spec_card = outs[0][1]
    agree, _ = compare_pos0("small slice", spec_card, seq)
    if agree != 1.0 or not all(torch.equal(a.generated, b.generated)
                               for a, b in zip(spec_card, seq)):
        raise AssertionError("small slice: spec ids differ from sequential")
    chunks = full_accept_check(params_gpu, cfg)
    int8_diff, int8_launches = small_int8_check(cfg, params_cpu, trunk_rows,
                                                flat_rows)
    log(json.dumps({"phase": "small_slice", "ok": True,
                    "cascade_and_spec_vs_cpu": True,
                    "spec_vs_sequential_bitwise_pos0": True,
                    "full_accept_windows": {"binary": chunks[0],
                                            "confidence": chunks[1]},
                    "int8_vs_cpu_max_float_diff": int8_diff,
                    "int8_launches": int8_launches}))


def small_int8_check(cfg, params_cpu, trunk_rows, flat_rows):
    """The 8-bit engine at the small size: dynamic int8 weights, the
    two-leg cascade with int8 QK^T, flash prefill. On the card against
    the same engine on the CPU: ids exact, floats within INT8_SLICE_TOL.
    Returns the largest float difference and the card's launch counts,
    which must include every kernel of the 8-bit path."""
    cfg8 = dataclasses.replace(cfg, use_flash_attention=True)
    q_cpu = quant.quantize_decoder_params(params_cpu, dynamic=True)
    q_gpu = _to_device(q_cpu, DEV)
    rt = RuntimeConfig(batch_size=4, max_new_tokens=6,
                       cascade_fused_suffix=False)
    outs, launches = [], None
    for params, dev in ((q_gpu, DEV), (q_cpu, "cpu")):
        eng = ScoringEngine(params, cfg8, FakeTokenizer(), rt,
                            cascade_config=CascadeConfig(int8_qk=True),
                            device=dev)
        if dev == DEV:
            torch.cuda.synchronize()
            ops.reset_launches()
        outs.append((_shared_dispatch(eng, trunk_rows, 96),
                     _shared_dispatch(eng, flat_rows, 64)))
        if dev == DEV:
            torch.cuda.synchronize()
            launches = ops.launch_counts()
        if (eng.cascade_stats["cascade_dispatches"] != 1
                or eng.spec_stats["spec_dispatches"] != 1):
            raise AssertionError("8-bit small slice did not route as planned")
    missing = [k for k in ("flash_attention", "cascade_prefix_int8",
                           "flash_decode_trunk", "flash_decode_mq")
               if launches[k] <= 0]
    if missing:
        raise AssertionError(f"8-bit small slice: never launched {missing}")
    worst = {}
    for route, card, cpu in zip(("cascade", "spec"), *outs):
        for a, b in zip(card, cpu):
            if not torch.equal(a.generated.cpu(), b.generated):
                raise AssertionError(f"8-bit small slice {route}: generated "
                                     f"ids differ card vs CPU")
            for name in ("p_yes", "p_no", "topk_logprobs",
                         "weighted_confidence"):
                diff = float((getattr(a, name).cpu()
                              - getattr(b, name)).abs().max())
                worst[name] = max(worst.get(name, 0.0), diff)
                if not diff <= INT8_SLICE_TOL:
                    raise AssertionError(f"8-bit small slice {route}: {name} "
                                         f"differs by {diff}")
    return worst, launches


SWEEP_TEXT_FIELDS = ("rephrased_main", "full_rephrased_prompt",
                     "full_confidence_prompt", "model_response",
                     "model_confidence_response", "confidence_value")
SMALL_SWEEP_TOL = 1e-4


def small_sweep_check(cfg, params_cpu, params_gpu):
    """The sweep at the small float32 size: the three grids of
    sweep_grids(3) (20 cells each) through run_perturbation_sweep on the
    card (kernels) and on the CPU (plain versions), same params, B = 4.
    D6 text fields, Model Response, Model Confidence Response and
    Confidence Value exact; Token_1/2_Prob, Weighted Confidence and the
    log-prob values within 1e-4, the log-prob keys exact wherever the
    neighbouring values are more than that apart. On the card the grids
    must take their routes: a grouped dispatch, a cascade one, a
    speculative one. Returns the largest float differences."""
    grids = sweep_grids(3)
    rt = RuntimeConfig(batch_size=4, max_new_tokens=12)
    rows, routes, lattices = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for side, (params, dev) in enumerate(((params_gpu, DEV),
                                              (params_cpu, "cpu"))):
            eng = ScoringEngine(params, cfg, FakeTokenizer(), rt, device=dev)
            for name, (prompts, perts) in grids.items():
                rows[dev, name] = sweep.run_perturbation_sweep(
                    eng, "smoke-tiny", prompts, perts,
                    Path(tmp) / f"{side}_{name}.csv")
                lattices[dev, name] = eng.stream_sink.snapshot()
                if name == "grouped":
                    routes[dev] = {"grouped_cells":
                                   eng.occupancy.grouped_cells}
            eng.spec_flush()
            routes[dev].update(
                cascade_dispatches=eng.cascade_stats["cascade_dispatches"],
                spec_dispatches=eng.spec_stats["spec_dispatches"])
    if routes[DEV] != routes["cpu"] or not all(routes[DEV].values()):
        raise AssertionError(f"small sweep routes: card {routes[DEV]}, "
                             f"CPU {routes['cpu']}")
    worst = {}
    for name in grids:
        card, cpu = rows[DEV, name], rows["cpu", name]
        if len(card) != len(cpu):
            raise AssertionError(f"small sweep {name}: row counts differ")
        for a, b in zip(card, cpu):
            for f in SWEEP_TEXT_FIELDS:
                if getattr(a, f) != getattr(b, f):
                    raise AssertionError(f"small sweep {name}: {f} differs "
                                         f"card vs CPU")
            la = json.loads(a.log_probabilities)
            lb = json.loads(b.log_probabilities)
            va, vb = np.asarray(list(la.values())), np.asarray(list(lb.values()))
            diffs = {"token_probs": max(abs(a.token_1_prob - b.token_1_prob),
                                        abs(a.token_2_prob - b.token_2_prob)),
                     "weighted_confidence": abs(a.weighted_confidence
                                                - b.weighted_confidence),
                     "log_probs": float(np.abs(va - vb).max())}
            for k, d in diffs.items():
                worst[k] = max(worst.get(k, 0.0), d)
                if not d <= SMALL_SWEEP_TOL:
                    raise AssertionError(f"small sweep {name}: {k} differs "
                                         f"by {d}")
            gap = np.abs(np.diff(vb)) > SMALL_SWEEP_TOL
            sep = np.ones(len(vb), bool)
            sep[1:] &= gap
            sep[:-1] &= gap
            if np.asarray(list(la))[sep].tolist() != \
                    np.asarray(list(lb))[sep].tolist():
                raise AssertionError(f"small sweep {name}: top-20 ids differ")
        # The sinks' lattices: the same slots, values within the bar.
        a, b = lattices[DEV, name], lattices["cpu", name]
        d = max(float(np.nanmax(np.abs(getattr(a, f) - getattr(b, f))))
                for f in ("rel", "conf"))
        if not (np.array_equal(a.filled, b.filled)
                and all(np.array_equal(np.isnan(getattr(a, f)),
                                       np.isnan(getattr(b, f)))
                        for f in ("rel", "conf"))
                and d <= SMALL_SWEEP_TOL):
            raise AssertionError(f"small sweep {name}: lattices differ card "
                                 f"vs CPU (max {d})")
        worst["lattice"] = max(worst.get("lattice", 0.0), d)
    log(json.dumps({"phase": "small_sweep", "ok": True, "routes": routes[DEV],
                    "max_float_diff": worst}))
    return worst


def library_row_invariance(params, cfg, B: int, spec_k: int) -> dict:
    """Whether the library ops the row kernels replaced give a row the
    same bits at B rows as at B * spec_k: PyTorch's norm (its row
    reduction), the bf16 projection through torch.matmul (cuBLAS), the
    float32 head, and the 8-bit engine's dynamic s8 product. Measured,
    not asserted: it records why the decode path takes the row kernels."""
    g = torch.Generator(device=DEV)
    g.manual_seed(7)
    D = cfg.hidden_size
    x = (torch.randn((B, spec_k, D), generator=g, device=DEV) * 2
         ).to(torch.bfloat16)
    lp = decoder._layer(params["layers"], 0)
    first = x[:, :1].contiguous()

    def same(fn):
        return bool(torch.equal(fn(x)[:, :1], fn(first)))

    w8 = dataclasses.replace(quant.quantize(lp["w_up"]), dynamic=True)
    head = decoder._head_weight(params, cfg)
    return {
        "norm": same(lambda t: decoder._norm(t, lp["ln1"], cfg)),
        "row_norm": same(lambda t: decoder._row_norm(t, lp["ln1"], cfg)),
        "row_add_norm": same(lambda t: decoder._row_add_norm(t, t, lp["ln2"], cfg)[1]),
        "matmul_bf16": same(lambda t: torch.matmul(t, lp["w_up"])),
        "row_gemm": same(lambda t: ops.row_gemm(t, lp["w_up"])),
        "head_f32": same(lambda t: decoder._head(cfg, t, head)),
        "int8_dynamic_matmul": same(lambda t: quant.matmul(t, w8)),
    }


def verify_step_check(params, cfg, spec_k: int, label: str = "bf16",
                      measure_library: bool = False):
    """At full width: spec_k sequential decode steps against ONE verify
    window fed the tokens the steps emit, from the same prefilled cache;
    the steps' cache at the sequential extent, the window's at a longer
    one (trailing splits with no valid key), as the two routes of a
    shared dispatch allocate them. The rows share a 64-token head and
    their prompts end ragged (a split of masked slots before the decode
    slots in some rows). Asserts that window position j's logits are
    bitwise step j's at every j, on the flat kernels and, with the head
    as a shared trunk, on the trunk kernels."""
    rng = np.random.default_rng(3)
    B, S0, trunk = BATCH, 128, 64
    T_seq, T_spec = S0 + 16, S0 + 16 + 8 * spec_k + 64
    toks = rng.integers(3, cfg.vocab_size, (B, S0))
    toks[:, :trunk] = toks[:1, :trunk]
    mask = np.ones((B, S0), np.int64)
    for b in range(B):
        mask[b, S0 - (b * 13) % 70:] = 0
    toks = torch.as_tensor(toks, dtype=torch.int32, device=DEV)
    mask = torch.as_tensor(mask, dtype=torch.int32, device=DEV)
    row = {"phase": "verify_vs_step", "engine": label, "B": B, "S": spec_k,
           "T_seq": T_seq, "T_spec": T_spec}
    with torch.inference_mode():
        for trunk_len in (0, trunk):
            logits0, cache, pos = decoder.prefill(params, cfg, toks, mask,
                                                  T_spec)
            cache_seq = tuple(c[:, :, :T_seq].contiguous() for c in cache)
            cm = F.pad(mask, (0, T_seq - S0))
            tok = torch.argmax(logits0, dim=-1).to(torch.int32)
            fed, steps = [], []
            for j in range(spec_k):
                cm[:, S0 + j] = 1
                lj, _ = decoder.decode_step(params, cfg, cache_seq, tok,
                                            pos + j, S0 + j, cm,
                                            trunk_len=trunk_len)
                fed.append(tok)
                steps.append(lj)
                tok = torch.argmax(lj, dim=-1).to(torch.int32)
            cmw = F.pad(mask, (0, T_spec - S0))
            cmw[:, S0:S0 + spec_k] = 1
            start = torch.full((B,), S0, dtype=torch.int32, device=DEV)
            V, _ = decoder.verify_extend(params, cfg, cache,
                                         torch.stack(fed, dim=1), cmw, start,
                                         trunk_len=trunk_len)
            diffs = [float((V[:, j] - steps[j]).abs().max())
                     for j in range(spec_k)]
            row[f"trunk{trunk_len}_max_abs_logit_diff"] = diffs
            row[f"trunk{trunk_len}_bitwise"] = all(
                torch.equal(V[:, j], steps[j]) for j in range(spec_k))
        if measure_library:
            row["same_bits_at_B_and_B_times_spec_k"] = library_row_invariance(
                params, cfg, B, spec_k)
    log(json.dumps(row))
    if not (row["trunk0_bitwise"] and row[f"trunk{trunk}_bitwise"]):
        raise AssertionError(f"verify_vs_step[{label}]: window logits are not "
                             f"bitwise the steps' ({row})")
    return row


# ---------------------------------------------------------------------------
# Phase 3: the slice at full width
# ---------------------------------------------------------------------------

def check_scores(name, arrs):
    for key, a in arrs.items():
        a = torch.as_tensor(a).float()
        if not torch.isfinite(a).all():
            raise AssertionError(f"{name}: non-finite {key}")
    p_yes = torch.as_tensor(arrs["p_yes"]).float()
    p_no = torch.as_tensor(arrs["p_no"]).float()
    for key, p in (("p_yes", p_yes), ("p_no", p_no)):
        if bool(((p < 0) | (p > 1)).any()):
            raise AssertionError(f"{name}: {key} outside [0, 1]")
    if bool((p_yes + p_no > 1 + 1e-5).any()):
        raise AssertionError(f"{name}: p_yes + p_no > 1")


def run_word_meaning(engine, label="word_meaning_sweep",
                     kernels=("flash_decode",), flash_route=None):
    """Word-meaning sweep: 50 D1 rows, 50 decode steps. Launch counts
    reset just before, read just after; fails unless every kernel in
    ``kernels`` launched (and the prefill flash kernel on ``flash_route``,
    where given)."""
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    rows = sweep.run_word_meaning_sweep(
        engine, "llama-2-7b (seeded random weights)", "base",
        WORD_MEANING_QUESTIONS, format_base_prompt)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = ops.launch_counts()
    if len(rows) != len(WORD_MEANING_QUESTIONS):
        raise AssertionError("word-meaning sweep lost rows")
    check_scores(label, {
        "p_yes": [r.yes_prob for r in rows], "p_no": [r.no_prob for r in rows]})
    missing = [k for k in kernels if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched: {missing}")
    routes = check_flash_route(label, flash_route)
    stats = dict(rows=len(rows), seconds=dt, rows_per_s=len(rows) / dt,
                 launches=launches, flash_routes=routes)
    log(json.dumps({"phase": label, **stats}))
    return stats


def check_flash_route(label, route):
    """The prefill flash kernel's launches per route since the last reset;
    fails unless ``route`` (where given) launched."""
    routes = dict(ops.flash_attention.route_launches)
    if route is not None and routes[route] <= 0:
        raise AssertionError(f"{label}: the flash kernel's {route} route never "
                             f"launched ({routes})")
    return routes


def _dispatch_call(engine, cells, rt):
    """The call of one 32-cell shared dispatch, ready to run."""
    t = engine.tokenizer
    yes = np.asarray([tok.first_token_id(t, " " + a) for _, _, (a, _) in cells],
                     np.int32)
    no = np.asarray([tok.first_token_id(t, " " + b) for _, _, (_, b) in cells],
                    np.int32)
    return lambda: engine.decode_fused_shared(
        [c[0] for c in cells], [c[1] for c in cells], yes, no,
        new_tokens=rt.sweep_decode_tokens,
        conf_tokens=rt.sweep_confidence_tokens, reuse_cache=True,
        n_real=len(cells))


def _library_add_norm(x, d, p, cfg):
    """The residual add and PyTorch's norm of the sum, apart: the library
    route that ``decoder._row_add_norm`` replaced."""
    s = x + d
    return s, decoder._norm(s, p, cfg)


def route_cost(engine, seq_engine, cells, rt, rounds: int = 2) -> dict:
    """What the row-invariant projections and norms cost a dispatch: ms
    per no-trunk shared dispatch on the sequential and the speculative
    route, with the decoder's row kernels and with the library calls they
    replaced patched back in for the step and the window (torch.matmul,
    PyTorch's norm, the residual adds apart; the compacted slots and the
    per-position head stay), in turns within this call (library, row
    kernels, row kernels, library)."""
    row_ops = (decoder._row_mm, decoder._row_norm, decoder._row_add_norm)
    library = (decoder._mm, decoder._norm, _library_add_norm)
    calls = {"sequential": _dispatch_call(seq_engine, cells, rt),
             "speculative": _dispatch_call(engine, cells, rt)}
    ms = {}
    try:
        for _ in range(rounds):
            for name, fns in (("library", library), ("row_kernels", row_ops),
                              ("row_kernels", row_ops), ("library", library)):
                decoder._row_mm, decoder._row_norm, decoder._row_add_norm = fns
                for route, call in calls.items():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    call()
                    torch.cuda.synchronize()
                    ms.setdefault(f"{route}/{name}", []).append(
                        (time.perf_counter() - t0) * 1e3)
    finally:
        decoder._row_mm, decoder._row_norm, decoder._row_add_norm = row_ops
    engine.spec_flush()
    row = {"phase": "route_cost", "ms_per_dispatch": ms,
           "mean_ms": {k: sum(v) / len(v) for k, v in ms.items()}}
    log(json.dumps(row))
    return row


def run_dispatch(label, engine, cells, rt, kernels, routing, flash_route=None,
                 exact=None):
    """One 32-cell shared dispatch through ``decode_fused_shared``, the
    launch counts reset just before and read just after. Fails unless
    every kernel in ``kernels`` launched (the prefill flash kernel on
    ``flash_route``, where given), every kernel in ``exact`` (name ->
    count) launched exactly that often, and every counter in ``routing``
    moved by exactly one."""
    call = _dispatch_call(engine, cells, rt)
    casc0, spec0 = dict(engine.cascade_stats), dict(engine.spec_stats)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    outs = call()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = ops.launch_counts()
    engine.spec_flush()
    moved = {k: v - casc0.get(k, 0) for k, v in engine.cascade_stats.items()
             if v != casc0.get(k, 0)}
    spec = {k: v - spec0.get(k, 0) for k, v in engine.spec_stats.items()
            if v != spec0.get(k, 0)}
    for out, fmt in zip(outs, ("binary", "confidence")):
        check_scores(f"{label}/{fmt}", {
            "p_yes": out.p_yes, "p_no": out.p_no,
            "topk_logprobs": out.topk_logprobs,
            "weighted_confidence": out.weighted_confidence})
        if out.generated.shape[0] != len(cells):
            raise AssertionError(f"{label}: wrong batch")
    missing = [k for k in kernels if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched: {missing}")
    off = {k: launches[k] for k, n in (exact or {}).items() if launches[k] != n}
    if off:
        raise AssertionError(f"{label}: launches {off}, expected {exact}")
    wrong = {k: moved.get(k, spec.get(k, 0)) for k in routing
             if moved.get(k, spec.get(k, 0)) != 1}
    if wrong:
        raise AssertionError(f"{label}: routing counters {wrong}, expected 1")
    routes = check_flash_route(label, flash_route)
    stats = dict(rows=len(cells), ms_per_dispatch=dt * 1e3,
                 rows_per_s=len(cells) / dt, routing=moved, spec_stats=spec,
                 launches=launches, flash_routes=routes)
    log(json.dumps({"phase": label, **stats}))
    return outs, stats


OUT_FIELDS = ("generated", "p_yes", "p_no", "top2_ids", "topk_logprobs",
              "topk_ids", "weighted_confidence")


def compare_outs(label, outs_a, outs_b, what: str) -> dict:
    """Two routes of one shared dispatch on the same cells: every readout
    of both format branches (the generated ids and the per-position
    p_yes, p_no and top-2 at every position, the position-0 top-k and
    weighted confidence) bitwise equal. The share of equal later ids and
    the largest float differences are printed before a failure."""
    row = {"phase": f"{label}_vs_{what}"}
    bad = []
    for fmt, a, b in zip(("binary", "confidence"), outs_a, outs_b):
        same = a.generated[:, 1:] == b.generated[:, 1:]
        row[f"{fmt}_later_ids_agree_share"] = float(same.float().mean())
        for name in OUT_FIELDS:
            x, y = getattr(a, name), getattr(b, name)
            if not torch.equal(x, y):
                bad.append(f"{fmt}.{name}")
                if x.is_floating_point():
                    row[f"{fmt}_{name}_max_diff"] = float((x - y).abs().max())
    row["bitwise"] = not bad
    log(json.dumps(row))
    if bad:
        raise AssertionError(f"{label} vs {what}: not bitwise on {bad}")
    return row


def compare_routes(label, spec_outs, seq_outs) -> dict:
    """The speculative route against the sequential one: every readout
    bitwise (the reference's contract, lir_tpu/engine/generate.py:694-712),
    so the later ids agree with share 1.0."""
    row = compare_outs(label, spec_outs, seq_outs, "sequential")
    row["later_ids_agree_share"] = min(
        row[f"{fmt}_later_ids_agree_share"] for fmt in ("binary", "confidence"))
    return row


def compare_two_leg(two_leg, fused):
    """The two-leg cascade dispatch against the fused one on the same
    cells: every readout and generated id bitwise (the reference's
    fused == two-leg invariant)."""
    return compare_outs("two_leg_cascade_dispatch", two_leg, fused, "fused")


def run_int8_slice(cfg, tokenizer, cells_trunk, cells_flat, rt, grids):
    """The 8-bit engine at llama-2-7b width: dynamic int8 weights born on
    the card, flash prefill, the two-leg cascade with int8 QK^T. Its
    phases: the word-meaning sweep, the trunk dispatch and the no-trunk
    dispatch, each with its own launch counts, then the sweep phase over
    ``grids``. Returns (per-phase stats, param bytes, peak memory over the
    phases before the sweep, the sweep phase's stats)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params8 = quant.init_quantized_params(cfg, seed=0, device=DEV,
                                          dtype=torch.bfloat16, dynamic=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg8 = dataclasses.replace(cfg, use_flash_attention=True)
    engine8 = ScoringEngine(
        params8, cfg8, tokenizer,
        RuntimeConfig(batch_size=BATCH, cascade_fused_suffix=False),
        cascade_config=CascadeConfig(int8_qk=True), device=DEV)
    stats = {"int8_verify_vs_step": verify_step_check(params8, cfg8, rt.spec_k,
                                                      "int8")}
    stats["int8_word_meaning"] = run_word_meaning(
        engine8, "int8_word_meaning_sweep",
        ("flash_attention", "flash_decode", "row_norm", "row_add_norm"),
        flash_route="wgmma")
    # One quantization of every layer's trunk keys, then each layer's
    # int8 trunk leg and suffix merge.
    _, stats["int8_cascade_dispatch"] = run_dispatch(
        "int8_cascade_dispatch", engine8, cells_trunk, rt,
        ("quantize_rows", "cascade_prefix_int8", "cascade_suffix_merge",
         "flash_decode_trunk"),
        ("cascade_dispatches", "cascade_decode_dispatches"),
        exact={"quantize_rows": 1, "cascade_prefix_int8": cfg.n_layers,
               "cascade_suffix_merge": cfg.n_layers})
    seq8 = ScoringEngine(
        params8, cfg8, tokenizer,
        RuntimeConfig(batch_size=BATCH, cascade_fused_suffix=False,
                      spec_decode=False),
        cascade_config=CascadeConfig(int8_qk=True), device=DEV)
    seq_out, stats["int8_sequential_dispatch"] = run_dispatch(
        "int8_sequential_dispatch", seq8, cells_flat, rt,
        ("flash_attention", "flash_decode", "row_add_norm"),
        ("dense_shared_dispatches",), flash_route="wgmma")
    spec_out, stats["int8_spec_dispatch"] = run_dispatch(
        "int8_spec_dispatch", engine8, cells_flat, rt,
        ("flash_attention", "flash_decode_mq", "row_add_norm"),
        ("spec_dispatches",), flash_route="wgmma")
    stats["int8_spec_dispatch"]["vs_sequential"] = compare_routes(
        "int8_spec_dispatch", spec_out, seq_out)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    profile_scoring(engine8, rt, "int8_profile")
    nbytes8 = quant.param_bytes(params8)
    log(json.dumps({"phase": "int8_slice", "init_seconds": init_s,
                    "param_bytes": nbytes8,
                    "max_memory_allocated_bytes": peak}))
    with tempfile.TemporaryDirectory() as tmp:
        sweep8 = run_sweep_phase("int8", engine8, rt, grids, Path(tmp))
        sweep8["prefix_cache_trunk"] = run_prefix_int8_trunk(
            engine8, rt, grids, Path(tmp))
    del engine8, seq8, params8
    torch.cuda.empty_cache()
    return stats, nbytes8, peak, sweep8


def run_slice(params, cfg, tokenizer, engine, cells_trunk, cells_flat, rt):
    """Phase 3: every path of the slice at full width, each with its own
    launch counts. Returns (per-phase stats, launches summed over the
    phases)."""
    seq_engine = ScoringEngine(
        params, cfg, tokenizer,
        RuntimeConfig(batch_size=BATCH, spec_decode=False,
                      cascade_prefill=False), device=DEV)
    spec_trunk_engine = ScoringEngine(
        params, cfg, tokenizer,
        RuntimeConfig(batch_size=BATCH, cascade_prefill=False), device=DEV)
    two_leg_engine = ScoringEngine(
        params, cfg, tokenizer,
        RuntimeConfig(batch_size=BATCH, cascade_fused_suffix=False),
        device=DEV)
    row_kernels = ("row_gemm", "row_norm", "row_add_norm")
    stats = {"word_meaning": run_word_meaning(
        engine, kernels=("flash_decode",) + row_kernels)}
    fused_out, stats["cascade_dispatch"] = run_dispatch(
        "cascade_dispatch", engine, cells_trunk, rt,
        ("cascade_attention", "flash_decode_trunk") + row_kernels,
        ("cascade_dispatches", "cascade_decode_dispatches"))
    two_leg_out, stats["two_leg_cascade_dispatch"] = run_dispatch(
        "two_leg_cascade_dispatch", two_leg_engine, cells_trunk, rt,
        ("cascade_prefix", "cascade_suffix_merge", "flash_decode_trunk"),
        ("cascade_dispatches", "cascade_decode_dispatches"))
    if stats["two_leg_cascade_dispatch"]["launches"]["cascade_attention"]:
        raise AssertionError("two-leg dispatch launched the fused kernel")
    stats["two_leg_cascade_dispatch"]["vs_fused"] = compare_two_leg(
        two_leg_out, fused_out)
    seq_out, stats["sequential_dispatch"] = run_dispatch(
        "sequential_dispatch", seq_engine, cells_flat, rt,
        ("flash_decode",) + row_kernels, ("dense_shared_dispatches",))
    spec_out, stats["spec_dispatch"] = run_dispatch(
        "spec_dispatch", engine, cells_flat, rt,
        ("flash_decode_mq",) + row_kernels, ("spec_dispatches",))
    seq_t_out, stats["sequential_trunk_dispatch"] = run_dispatch(
        "sequential_trunk_dispatch", seq_engine, cells_trunk, rt,
        ("flash_decode_trunk",) + row_kernels,
        ("dense_shared_dispatches", "cascade_decode_dispatches"))
    spec_t_out, stats["spec_trunk_dispatch"] = run_dispatch(
        "spec_trunk_dispatch", spec_trunk_engine, cells_trunk, rt,
        ("flash_decode_mq_trunk",) + row_kernels,
        ("spec_dispatches", "cascade_decode_dispatches"))
    for label, spec, seq in (("spec_dispatch", spec_out, seq_out),
                             ("spec_trunk_dispatch", spec_t_out, seq_t_out)):
        stats[label]["vs_sequential"] = compare_routes(label, spec, seq)
    stats["route_cost"] = route_cost(engine, seq_engine, cells_flat, rt)
    total = {name: sum(st["launches"][name] for st in stats.values()
                       if "launches" in st)
             for name in ops.KERNELS}
    return stats, total


def profile_scoring(engine, rt, label="profile"):
    """Where one word-meaning batch's time goes: ``profile_batch.profile``
    of ``decode_fused`` (prefill + the 50 greedy steps) at B = 32, the
    device-busy time set against the same call's host-clock time without
    the profiler."""
    prompts = [format_base_prompt(q) for q in WORD_MEANING_QUESTIONS[:BATCH]]
    yes = np.full(BATCH, engine.yes_id, np.int32)
    no = np.full(BATCH, engine.no_id, np.int32)

    def call():
        engine.decode_fused(prompts, yes, no)
        torch.cuda.synchronize()

    log(json.dumps({"phase": label, "call": "decode_fused, B=32, 50 steps",
                    **profile_batch.profile(call)}))


# The kernels that show each grid's route ran, by engine: the grouped
# dispatch's decode steps on the single-query kernel, the cascade
# dispatch's prefill and trunk decode, the speculative verify windows.
SWEEP_ROUTE_KERNELS = {
    "bf16": {"grouped": ("flash_decode",),
             "trunk": ("cascade_attention", "flash_decode_trunk"),
             "flat": ("flash_decode_mq",)},
    "int8": {"grouped": ("flash_decode",),
             "trunk": ("quantize_rows", "cascade_prefix_int8",
                       "cascade_suffix_merge", "flash_decode_trunk"),
             "flat": ("flash_decode_mq",)},
}


def check_d6(label, path, n_cells):
    """The artifact on disk: one row a cell, every Token_1/2_Prob in
    [0, 1], every Weighted Confidence in [0, 100], every Log
    Probabilities a map of 20 entries."""
    recs = schemas.read_results(path)
    if len(recs) != n_cells:
        raise AssertionError(f"{label}: {len(recs)} rows for {n_cells} cells")
    for r in recs:
        for col, hi in (("Token_1_Prob", 1.0), ("Token_2_Prob", 1.0),
                        ("Weighted Confidence", 100.0)):
            v = float(r[col])
            if not 0.0 <= v <= hi:
                raise AssertionError(f"{label}: {col} {v} outside [0, {hi}]")
        if len(json.loads(r["Log Probabilities"])) != 20:
            raise AssertionError(f"{label}: a log-prob map without 20 entries")
    return len(recs)


def check_stream_lattice(label, sink, cells, path):
    """The sweep's streaming sink against the CSV it wrote: the lattice's
    filled slots and decisions bitwise ``accum_from_rows`` over the rows
    read back (the same code path as a ``--no-streaming-stats`` re-run's
    analysis), counts and kappa bitwise and moments within FLOAT_TOL
    (``streaming.assert_parity``); the survey's per-prompt estimates from
    the lattice on the card against the same from the rows on the CPU
    (``accum_survey_estimates``). Returns the lattice and a summary."""
    acc = sink.snapshot()
    reload = streaming.accum_from_rows(
        schemas.read_results(path), streaming.slot_map_from_cells(cells),
        sink.n_prompts, sink.n_rephrase, acc.seed)
    if not (np.array_equal(acc.filled, reload.filled)
            and np.array_equal(acc.dec, reload.dec)):
        raise AssertionError(f"{label}: lattice differs from the CSV's rows")
    streamed = streaming.summarize(acc, n_boot=0)
    streaming.assert_parity(streamed,
                            streaming.summarize(reload, n_boot=0))
    return acc, dict(rows_folded=acc.rows_folded,
                     kappa=streamed["kappa"]["kappa"],
                     n_valid=sum(p["n_valid"] for p in streamed["per_prompt"]),
                     counters=sink.stats.summary(),
                     survey_estimates=accum_survey_estimates(label, acc,
                                                             reload))


def run_sweep(label, engine, prompts, perts, path, rt, grid_name, engine_kind,
              trace=False):
    """One perturbation sweep through run_perturbation_sweep into its own
    CSV, the streaming sink on (its default): the plan by kind, the
    routing counters, the launch counts (reset just before, read just
    after), rows/s by the host clock around work that ends in a
    synchronize, and the peak device memory. Fails unless the grid's
    route ran (a grouped dispatch in the plan, a cascade dispatch, a
    speculative one) with its kernels, unless the rows on disk are one a
    cell with their values in range, unless ``stream_fold`` launched once
    a dispatch and folded every cell, and unless the sink's lattice is the
    CSV's (``check_stream_lattice``). With ``trace``, the sweep three
    times more into other CSVs through profile_batch.profile (a warm-up,
    one on the host clock, one under ``torch.profiler``): its launches,
    device-busy ms and busy share. Returns (stats, the lattice)."""
    cells, dispatches, _ = plan_sweep(engine, prompts, perts, rt)
    plan = {k: sum(d.kind == k for d in dispatches)
            for k in ("shared", "grouped")}
    casc0, spec0 = dict(engine.cascade_stats), dict(engine.spec_stats)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    rows = sweep.run_perturbation_sweep(engine, SWEEP_MODEL, prompts, perts,
                                        path)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    casc = {k: v - casc0.get(k, 0) for k, v in engine.cascade_stats.items()
            if v != casc0.get(k, 0)}
    spec = {k: v - spec0.get(k, 0) for k, v in engine.spec_stats.items()
            if v != spec0.get(k, 0)}
    occ = engine.occupancy
    n_rows = check_d6(label, path, len(cells))
    if len(rows) != len(cells):
        raise AssertionError(f"{label}: {len(rows)} rows for {len(cells)} cells")
    route_ok = {"grouped": plan["grouped"] > 0,
                "trunk": casc.get("cascade_dispatches", 0) > 0,
                "flat": spec.get("spec_dispatches", 0) > 0}[grid_name]
    missing = [k for k in SWEEP_ROUTE_KERNELS[engine_kind][grid_name]
               if launches[k] <= 0]
    if not route_ok or missing:
        raise AssertionError(f"{label}: route not taken (plan {plan}, "
                             f"cascade {casc}, spec {spec}, never launched "
                             f"{missing})")
    sink = engine.stream_sink
    if (launches["stream_fold"] != len(dispatches)
            or sink.stats.rows_folded != len(cells)):
        raise AssertionError(f"{label}: stream_fold launched "
                             f"{launches['stream_fold']} times for "
                             f"{len(dispatches)} dispatches, folded "
                             f"{sink.stats.rows_folded} of {len(cells)} cells")
    acc, stream = check_stream_lattice(label, sink, cells, path)
    stats = dict(cells=len(cells), rows=n_rows, seconds=dt,
                 rows_per_s=n_rows / dt, plan=plan,
                 occupancy_pct=occ.occupancy_pct,
                 padding_waste_pct=occ.padding_waste_pct,
                 grouped_cells=occ.grouped_cells,
                 buckets=sorted({d.bucket for d in dispatches}),
                 cascade_stats=casc, spec_stats=spec, launches=launches,
                 max_memory_allocated_bytes=peak, stream=stream)
    if trace:
        runs = iter(range(3))

        def again():
            sweep.run_perturbation_sweep(
                engine, SWEEP_MODEL, prompts, perts,
                path.with_name(f"{path.stem}_traced{next(runs)}.csv"))
            torch.cuda.synchronize()

        prof = profile_batch.profile(again)
        stats["profile"] = {k: prof[k] for k in
                            ("wall_ms", "kernel_launches", "device_busy_ms",
                             "device_busy_share", "top_kernels_ms")
                            if k in prof}
    log(json.dumps({"phase": label, **stats}))
    return stats, acc


def engine_with(engine, **rt):
    """An engine on ``engine``'s params and configs with RuntimeConfig
    fields replaced."""
    return ScoringEngine(engine.params, engine.cfg, engine.tokenizer,
                         dataclasses.replace(engine.rt, **rt),
                         cascade_config=engine.cascade_cfg,
                         spec_config=engine.spec_cfg, device=DEV)


def sink_cost(kind, engine, grids, tmp: Path, rows_per_s) -> dict:
    """Each grid once more on an engine with the sink off (the sweep as
    it ran before the sink), rows/s by the host clock beside the sink-on
    run's (``rows_per_s``) from this call."""
    off = engine_with(engine, streaming_stats=False)
    out = {}
    for name, (prompts, perts) in grids.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = sweep.run_perturbation_sweep(off, SWEEP_MODEL, prompts, perts,
                                            tmp / f"{kind}_{name}_nosink.csv")
        torch.cuda.synchronize()
        out[name] = dict(rows_per_s_sink_off=len(rows)
                         / (time.perf_counter() - t0),
                         rows_per_s_sink_on=rows_per_s[name])
    if off.stream_sink is not None:
        raise AssertionError(f"{kind}: the sink ran with streaming_stats off")
    log(json.dumps({"phase": f"{kind}_sweep_sink_cost", **out}))
    return out


def stream_only_check(kind, engine, grids, tmp: Path, name, ref) -> dict:
    """Grid ``name`` once more with ``row_artifact=False``: no rows and
    no CSV, every cell marked in the manifest, and the lattice bitwise
    ``ref`` (the row-writing run's)."""
    eng = engine_with(engine, row_artifact=False)
    path = tmp / f"{kind}_{name}_stream_only.csv"
    ops.reset_launches()
    rows = sweep.run_perturbation_sweep(eng, SWEEP_MODEL, *grids[name], path)
    torch.cuda.synchronize()
    acc = eng.stream_sink.snapshot()
    same = all(np.array_equal(getattr(acc, f).view(np.int32),
                              getattr(ref, f).view(np.int32))
               for f in ("filled", "rel", "conf", "dec"))
    marked = len(SweepManifest(path.with_suffix(".manifest.jsonl"),
                               grid.RESUME_KEY_FIELDS))
    if rows or path.exists() or marked != ref.rows_folded or not same:
        raise AssertionError(f"{kind} stream-only {name}: {len(rows)} rows, "
                             f"CSV {path.exists()}, {marked} marked, "
                             f"lattice equal {same}")
    out = dict(rows_folded=acc.rows_folded, marked=marked,
               stream_fold_launches=ops.launch_counts()["stream_fold"],
               counters=eng.stream_sink.stats.summary())
    log(json.dumps({"phase": f"{kind}_sweep_stream_only_{name}", **out}))
    return out


def run_sweep_phase(kind, engine, rt, grids, tmp: Path,
                    trace_and_resume=False):
    """The sweep phase on one engine: the three grids, each into its own
    CSV under ``tmp``, the streaming sink on; with ``trace_and_resume``
    (the bf16 engine), the grouped grid profiled (tracing all three
    grids' 185,732 launches added ~90 s to the script on an H100, so only
    the grid with the fewest launches is traced), then once more on its
    results path, which must return no rows, dispatch nothing and leave
    the artifact as it was, then once more with ``row_artifact=False``
    (same lattice, bitwise), and each grid with the sink off (its
    cost)."""
    stats, lattices = {}, {}
    for name, (prompts, perts) in grids.items():
        stats[name], lattices[name] = run_sweep(
            f"{kind}_sweep_{name}", engine, prompts, perts,
            tmp / f"{kind}_{name}.csv", rt, name, kind,
            trace=trace_and_resume and name == "grouped")
    if trace_and_resume:
        path = tmp / f"{kind}_grouped.csv"
        before = path.read_bytes()
        casc0, spec0 = dict(engine.cascade_stats), dict(engine.spec_stats)
        torch.cuda.synchronize()
        ops.reset_launches()
        rows = sweep.run_perturbation_sweep(engine, SWEEP_MODEL,
                                            *grids["grouped"], path)
        torch.cuda.synchronize()
        launched = {k: n for k, n in ops.launch_counts().items() if n}
        if (rows or launched or path.read_bytes() != before
                or dict(engine.cascade_stats) != casc0
                or dict(engine.spec_stats) != spec0
                or engine.occupancy is not None):
            raise AssertionError(f"{kind} resume: {len(rows)} rows, "
                                 f"launches {launched}")
        stats["resume"] = dict(rows=0, launched=launched,
                               artifact_rows=len(schemas.read_results(path)))
        log(json.dumps({"phase": f"{kind}_sweep_resume", **stats["resume"]}))
        stats["stream_only"] = stream_only_check(kind, engine, grids, tmp,
                                                 "grouped",
                                                 lattices["grouped"])
        stats["sink_cost"] = sink_cost(
            kind, engine, grids, tmp,
            {name: stats[name]["rows_per_s"] for name in grids})
    return stats


# ---------------------------------------------------------------------------
# The prefix-cache phase: the sweep grids with the radix prefix cache on
# ---------------------------------------------------------------------------

# Each grid's paged route on a warm pass: the engine's paged_dispatches
# key and the kernels that run it, by engine.
PREFIX_ROUTES = {
    "bf16": {"grouped": ("grouped_paged", ("flash_decode",)),
             "trunk": ("cascade_paged", ("cascade_attention",
                                         "flash_decode_trunk")),
             "flat": ("shared_paged_spec", ("flash_decode_mq",))},
    "int8": {"trunk": ("cascade_paged", ("quantize_rows",
                                         "cascade_prefix_int8",
                                         "cascade_suffix_merge",
                                         "flash_decode_trunk"))},
}
D6_TEXT = ("Model Response", "Model Confidence Response", "Confidence Value")
D6_FLOATS = ("Token_1_Prob", "Token_2_Prob", "Weighted Confidence")
# The tight pool lacks this share of the pages its grid needs.
TIGHT_POOL_CUT = 0.1


def prefix_pages_needed(engine, grids: dict, rt: RuntimeConfig,
                        passes: int = 2) -> dict:
    """Pages the grids insert when each is swept ``passes`` times in turn
    on one engine: every pass's plan (made, as the sweep makes it,
    against the tree as it stands) replayed on the host into one tree
    over a pool that never runs out and holds no device memory — the
    group prefixes, the cascade trunks in their trunk namespace, the
    other shared rows' prefixes. Returns the pages each grid adds and
    the total."""
    tree = prefix_tree.RadixPrefixCache(
        paged.KVPagePool(1 << 20, rt.prefix_page_size))
    planner = copy.copy(engine)
    planner.prefix_cache = tree
    out = {}
    for name, (prompts, perts) in grids.items():
        before = tree.pool.pages_in_use
        for _ in range(passes):
            _, dispatches, _ = plan_sweep(planner, prompts, perts, rt)
            for d in dispatches:
                if d.kind == "grouped":
                    for g in d.groups:
                        tree.plan_insert(d.bucket,
                                         g.items[0].bin_ids[:g.plen])
                    continue
                rows = [it.bin_ids[:it.lcp] for it in d.items]
                trunk = engine.cascade_trunk_for(rows, len(rows), d.bucket)
                if trunk:
                    tree.plan_insert(trunk, rows[0][:trunk])
                else:
                    for ids in rows:
                        tree.plan_insert(d.bucket, ids)
        out[name] = tree.pool.pages_in_use - before
    out["total"] = tree.pool.pages_in_use
    return out


def d6_records(path: Path) -> dict:
    return {(r["Original Main Part"], r["Rephrased Main Part"]): r
            for r in schemas.read_results(path)}


def completion_ids(text: str) -> list:
    """The ids of a completion the FakeTokenizer decoded (one word an
    id: 'Yes', 'No' or '<id>'; the EOS and pads are dropped)."""
    return [FakeTokenizer.YES if w == "Yes" else FakeTokenizer.NO
            if w == "No" else int(w[1:-1]) for w in text.split()]


def field_bar(bars: dict, field: str, x: float) -> float:
    """The bar a D6 float ``x`` of ``field`` may move by between two
    routes: the script's ATOL + RTOL |x|, or the field's entry in
    ``bars`` (absolute) where that is larger."""
    return max(ATOL + RTOL * abs(x), bars.get(field, 0.0))


@torch.inference_mode()
def flip_gap(eng, prompt: str, text_a: str, text_b: str, bars: dict) -> dict:
    """Where two greedy completions of ``prompt`` part: the step, the
    two ids there (the EOS where one text ends), and their log-probs
    with the prompt and the common ids before the step forced through
    ``eng``'s cache-off prefill. ``near_tie``: the gap is within the
    two log-probs' bars summed (:func:`field_bar`), so either id may be
    the argmax under the float noise the bars allow."""
    a, b = completion_ids(text_a), completion_ids(text_b)
    j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
             min(len(a), len(b)))
    ids = [a[j] if j < len(a) else eng.eos_id,
           b[j] if j < len(b) else eng.eos_id]
    seq = list(eng.tokenizer(prompt).input_ids) + a[:j]
    tokens = torch.tensor([seq], dtype=torch.int32, device=DEV)
    logits, _, _ = decoder.prefill(eng.params, eng.cfg, tokens,
                                   torch.ones_like(tokens), len(seq))
    lp = torch.log_softmax(logits[0].float(), dim=-1)[ids].tolist()
    gap = abs(lp[0] - lp[1])
    bar = sum(field_bar(bars, "Log Probabilities", v) for v in lp)
    return dict(step=j, ids=ids, logprobs=lp, gap=gap, bar=bar,
                near_tie=gap <= bar)


def topk_diffs(la: dict, lb: dict, bars: dict) -> tuple:
    """Two top-k log-prob maps (id -> log-prob) of one readout: the
    largest difference of an id in both, and the ids that break the bar
    (:func:`field_bar`): an id in both that moved past it, or an id in
    one map only that sits higher than the other map's last value plus
    its bar (noise may move an id only that far past the edge). So ids
    may change order only among values within their bars, and
    membership only at the edge."""
    def tol(v):
        return field_bar(bars, "Log Probabilities", v)
    common = la.keys() & lb.keys()
    worst = max((abs(la[i] - lb[i]) for i in common), default=0.0)
    bad = [i for i in common if abs(la[i] - lb[i]) > tol(la[i])]
    for one, other in ((la, lb), (lb, la)):
        edge = min(other.values())
        bad += [i for i in one.keys() - other.keys()
                if one[i] > edge + tol(one[i])]
    return worst, bad


# The completions' prompts, by D6 text field; a Confidence Value is
# read from its completion.
D6_PROMPTS = {"Model Response": "Full Rephrased Prompt",
              "Model Confidence Response": "Full Confidence Prompt"}


def compare_d6(label: str, ref: dict, got: dict, eng, bars) -> dict:
    """D6 rows ``got`` against ``ref``, cell by cell (every cell of
    ``got`` must be in ``ref``). Model Response and Model Confidence
    Response exact, save a flip at a near tie (:func:`flip_gap` on
    ``eng``; every flip is reported); Confidence Value exact where its
    completion is; Token_1/2_Prob, Weighted Confidence and each top-20
    id's log-prob within its bar (:func:`field_bar`, :func:`topk_diffs`).
    ``bars`` None measures without holding (the control). Returns the
    largest differences, the flips, the rows whose top-20 order differs,
    the breaches, and whether every row is the reference's, byte for
    byte; fails on a breach unless ``bars`` is None."""
    held = bars is not None
    bars = bars or {}
    worst = {f: 0.0 for f in D6_FLOATS + ("Log Probabilities",)}
    flips, breaches = [], []
    swaps = 0
    for key, b in got.items():
        a = ref[key]
        cell = f"{key[1][:24]}...{key[1][-24:]}"
        for f, prompt in D6_PROMPTS.items():
            if a[f] != b[f]:
                flip = flip_gap(eng, a[prompt], a[f], b[f], bars)
                flips.append(dict(cell=cell, key=key, field=f, **flip))
                if not flip["near_tie"]:
                    breaches.append(flips[-1])
        if (a["Model Confidence Response"] == b["Model Confidence Response"]
                and a["Confidence Value"] != b["Confidence Value"]):
            breaches.append(dict(cell=cell, field="Confidence Value"))
        for f in D6_FLOATS:
            x, y = float(a[f]), float(b[f])
            worst[f] = max(worst[f], abs(x - y))
            if not abs(x - y) <= field_bar(bars, f, x):
                breaches.append(dict(cell=cell, field=f, values=[x, y]))
        la, lb = json.loads(a["Log Probabilities"]), json.loads(
            b["Log Probabilities"])
        diff, bad = topk_diffs(la, lb, bars)
        worst["Log Probabilities"] = max(worst["Log Probabilities"], diff)
        swaps += list(la) != list(lb)
        if bad:
            breaches.append(dict(cell=cell, field="Log Probabilities",
                                 ids=bad, ref=la, got=lb))
    out = dict(rows=len(got), max_abs_diff=worst, topk_order_differs=swaps,
               bitwise=all(got[k] == ref[k] for k in got),
               flips=len(flips), rows_flipped=len({f.pop("key") for f in flips}),
               max_flip_gap=max((f["gap"] for f in flips), default=None),
               flip_examples=flips[:4], breaches=len(breaches))
    if held and breaches:
        raise AssertionError(f"{label}: {len(breaches)} breaches of the "
                             f"bar {bars}, first {breaches[:3]}; {out}")
    return out


# The control's differences, times this, bound the differences of the
# cache's passes (a row-count change alone moves a bf16 row this far).
CONTROL_FACTOR = 2.0


def shape_control(kind, engine, grids: dict, tmp: Path, names) -> dict:
    """The bar's control: grids ``names`` swept cache-off again at half
    the batch (every product at other row counts, so other bits), each
    row against the full-batch cache-off sweep's in ``tmp``, measured
    only. Returns per grid the differences and flips, and ``bars``:
    CONTROL_FACTOR times each field's largest difference."""
    eng = engine_with(engine, batch_size=engine.rt.batch_size // 2,
                      piggyback_prefill=False)
    out = {}
    for name in names:
        path = tmp / f"{kind}_{name}_control.csv"
        sweep.run_perturbation_sweep(eng, SWEEP_MODEL, *grids[name], path)
        out[name] = compare_d6(f"{kind} control {name}",
                               d6_records(tmp / f"{kind}_{name}.csv"),
                               d6_records(path), eng, None)
    out["bars"] = {f: CONTROL_FACTOR * max(out[n]["max_abs_diff"][f]
                                           for n in names)
                   for f in D6_FLOATS + ("Log Probabilities",)}
    log(json.dumps({"phase": f"{kind}_prefix_control", **out}))
    del eng
    torch.cuda.empty_cache()
    return out


def prefix_pass(label, eng, prompts, perts, path: Path) -> dict:
    """One sweep through an engine with the prefix cache on: rows/s by
    the host clock around work that ends in a synchronize, the launch
    counts (reset just before, read just after), and the deltas of the
    cache's counters, the paged routes taken and the tree's drafts.
    Fails unless every page pin was released."""
    pc0 = eng.prefix_stats.summary()
    paged0 = dict(eng.paged_dispatches)
    spec0 = dict(eng.spec_stats)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    rows = sweep.run_perturbation_sweep(eng, SWEEP_MODEL, prompts, perts,
                                        path)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = ops.launch_counts()
    pc = eng.prefix_stats.summary()
    pool = eng.prefix_cache.pool
    if pool.refcount[1:].sum() != pool.pages_in_use:
        raise AssertionError(f"{label}: refcounts {pool.refcount[1:].sum()} "
                             f"for {pool.pages_in_use} pages in use")
    delta = {k: pc[k] - pc0[k] for k in
             ("lookups", "hits", "prefill_tokens_avoided",
              "prefill_tokens_total", "inserted_pages", "evicted_pages")}
    return dict(
        rows=len(rows), seconds=dt, rows_per_s=len(rows) / dt,
        hit_tokens=delta["prefill_tokens_avoided"],
        prefill_tokens_total=delta["prefill_tokens_total"],
        avoided_frac=(delta["prefill_tokens_avoided"]
                      / max(delta["prefill_tokens_total"], 1)),
        lookups=delta["lookups"], hits=delta["hits"],
        inserted_pages=delta["inserted_pages"],
        evicted_pages=delta["evicted_pages"],
        pages_in_use=pc["pages_in_use"],
        paged_dispatches={k: v - paged0.get(k, 0)
                          for k, v in eng.paged_dispatches.items()
                          if v != paged0.get(k, 0)},
        tree_drafted=eng.spec_stats["draft_tree"] - spec0.get("draft_tree", 0),
        tree_accepted=(eng.spec_stats["accepted_tree"]
                       - spec0.get("accepted_tree", 0)),
        launches=launches,
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated())


def prefix_grid(kind, eng, name, prompts, perts, tmp: Path, ref_path: Path,
                bars: dict, passes=("cold", "warm")) -> dict:
    """Grid ``name`` through ``eng`` once a pass into fresh CSVs under
    ``tmp``: every pass's rows against the cache-off sweep's
    (``ref_path``, which may hold more cells), the warm pass's against the
    cold pass's, each within ``bars`` (:func:`compare_d6`); the last pass
    must resume prefix tokens from the pool and take the grid's paged
    route on its kernels."""
    ref = d6_records(ref_path)
    n_cells = len(grid.build_grid(SWEEP_MODEL, prompts, perts))
    tmp.mkdir(parents=True, exist_ok=True)
    out, recs = {}, {}
    for which in passes:
        path = tmp / f"{kind}_{name}_prefix_{which}.csv"
        out[which] = prefix_pass(f"{kind}_prefix_{name}_{which}", eng,
                                 prompts, perts, path)
        recs[which] = d6_records(path)
        if len(recs[which]) != n_cells:
            raise AssertionError(f"{kind} prefix {name} {which}: "
                                 f"{len(recs[which])} rows, {n_cells} cells")
        out[which]["vs_cache_off"] = compare_d6(
            f"{kind} prefix {name} {which} vs cache off", ref, recs[which],
            eng, bars)
    if "warm" in recs:
        out["warm_vs_cold"] = compare_d6(f"{kind} prefix {name} warm vs cold",
                                         recs["cold"], recs["warm"], eng,
                                         bars)
    last = out[passes[-1]]
    route, kernels = PREFIX_ROUTES[kind][name]
    missing = [k for k in kernels if last["launches"][k] <= 0]
    if (last["hit_tokens"] <= 0 or last["paged_dispatches"].get(route, 0) <= 0
            or missing):
        raise AssertionError(f"{kind} prefix {name}: hit tokens "
                             f"{last['hit_tokens']}, paged routes "
                             f"{last['paged_dispatches']}, never launched "
                             f"{missing}")
    log(json.dumps({"phase": f"{kind}_prefix_cache_{name}", **out}))
    return out


def run_prefix_cache_phase(engine, rt, grids, tmp: Path, flat_peak) -> dict:
    """The bf16 engine's sweep grids with the prefix cache on, all on ONE
    engine with one pool sized from the grids' prefix pages
    (``prefix_pages_needed``; one page ``paged.kv_page_bytes`` = 8 MiB at
    llama-2-7b width): each grid twice in turn, cold (pages inserted,
    tails recorded; the flat grid's original cells already resume the
    grouped grid's pages) then warm (resumed from pages, drafted from the
    tree), each pass's rows against the cache-off sweep's in ``tmp`` and
    the warm pass's against the cold pass's, within the bars of
    :func:`shape_control` (a page holds the bits of the dispatch shape
    that made it, and the window runs at other row counts than the cold
    prefill: floats move, and a greedy text may flip at a near tie); then the grouped grid twice on a pool
    of nine tenths of the pages it needs, which must evict, resume on its
    second pass and still match. ``flat_peak``: the cache-off flat grid's
    peak memory, which with the pool must fit the card."""
    control = shape_control("bf16", engine, grids, tmp, list(grids))
    bars = control["bars"]
    page_bytes = paged.kv_page_bytes(engine.cfg, rt.prefix_page_size)
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    need = prefix_pages_needed(engine, grids, rt)
    pool_bytes = (need["total"] + 1) * page_bytes     # + the trash page
    if flat_peak + pool_bytes > card_bytes:
        raise AssertionError(f"prefix pool {pool_bytes} B + the flat grid's "
                             f"{flat_peak} B peak exceed {card_bytes} B")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = engine_with(engine, prefix_cache=True,
                      prefix_cache_pages=need["total"] + 1)
    pool = eng.prefix_cache.pool
    if pool.nbytes != pool_bytes:
        raise AssertionError(f"pool of {pool.nbytes} B, {pool_bytes} B "
                             f"planned")
    out = {"control": control}
    for name, (prompts, perts) in grids.items():
        out[name] = prefix_grid("bf16", eng, name, prompts, perts, tmp,
                                tmp / f"bf16_{name}.csv", bars)
        added = sum(out[name][p]["inserted_pages"] for p in ("cold", "warm"))
        if added != need[name]:
            raise AssertionError(f"{name}: {added} pages inserted, "
                                 f"{need[name]} planned")
    out["pool"] = dict(page_bytes=page_bytes, pages_needed=need,
                       n_pages=need["total"] + 1, pool_bytes=pool_bytes,
                       pages_in_use=pool.pages_in_use,
                       flat_cache_off_peak_bytes=flat_peak,
                       max_memory_allocated_bytes=(
                           torch.cuda.max_memory_allocated()))
    if pool.pages_in_use != need["total"] or eng.prefix_stats.evicted_pages:
        raise AssertionError(f"the pool holds {pool.pages_in_use} pages "
                             f"({eng.prefix_stats.evicted_pages} evicted), "
                             f"{need['total']} planned")
    del eng, pool
    torch.cuda.empty_cache()

    # A tight pool: the grouped grid twice on nine tenths of the pages
    # it needs. The first pass evicts; on the second the groups evicted
    # least recently are still cached, and resume.
    need_g = prefix_pages_needed(engine, {"grouped": grids["grouped"]}, rt)
    tight = engine_with(engine, prefix_cache=True, prefix_cache_pages=(
        need_g["total"] - int(need_g["total"] * TIGHT_POOL_CUT) + 1))
    tight_out = prefix_grid("bf16", tight, "grouped", *grids["grouped"],
                            tmp / "tight", tmp / "bf16_grouped.csv", bars)
    if tight.prefix_stats.evicted_pages <= 0:
        raise AssertionError("tight prefix pool: nothing evicted")
    out["tight_pool"] = dict(pages_needed=need_g["total"],
                             n_pages=tight.rt.prefix_cache_pages,
                             **tight_out)
    del tight
    torch.cuda.empty_cache()
    return out


def prefix_summary(prefix: dict) -> dict:
    """The phase's one-line record: per grid (bf16 cold and warm, the
    tight pool, the 8-bit trunk), rows/s, the prefill tokens resumed from
    the pool of those needed, pages inserted and evicted, tree-drafted
    and accepted tokens, and the largest difference from the cold rows
    with whether the rows are bitwise theirs."""
    def pass_line(st):
        return {k: st[k] for k in ("rows_per_s", "hit_tokens",
                                   "prefill_tokens_total", "avoided_frac",
                                   "inserted_pages", "evicted_pages",
                                   "tree_drafted", "tree_accepted",
                                   "paged_dispatches")}

    def grid_line(g):
        line = {p: pass_line(g[p]) for p in ("cold", "warm") if p in g}
        if "warm_vs_cold" in g:
            line["warm_vs_cold"] = g["warm_vs_cold"]
        for p in ("cold", "warm"):
            if p in g:
                line[f"{p}_vs_cache_off"] = g[p]["vs_cache_off"]
        return line

    out = {"pool": prefix["pool"], "bf16/control": prefix["control"]}
    for name in ("grouped", "trunk", "flat"):
        out[f"bf16/{name}"] = grid_line(prefix[name])
    out["bf16/grouped_tight_pool"] = dict(
        pages_needed=prefix["tight_pool"]["pages_needed"],
        n_pages=prefix["tight_pool"]["n_pages"],
        **grid_line(prefix["tight_pool"]))
    out["int8/trunk"] = dict(pages_needed=prefix["int8_trunk"]["pages_needed"],
                             control=prefix["int8_trunk"]["control"],
                             **grid_line(prefix["int8_trunk"]))
    return out


def run_prefix_int8_trunk(engine8, rt, grids, tmp: Path) -> dict:
    """The trunk grid once on the 8-bit engine with the prefix cache on:
    its later dispatches resume the trunk from the pages the first
    inserted, through the two-leg int8-QK^T cascade. Rows against the
    8-bit cache-off sweep's, within the bars of the 8-bit engine's own
    :func:`shape_control` on the trunk grid."""
    control = shape_control("int8", engine8, grids, tmp, ["trunk"])
    need = prefix_pages_needed(engine8, {"trunk": grids["trunk"]}, rt,
                               passes=1)["total"]
    eng = engine_with(engine8, prefix_cache=True,
                      prefix_cache_pages=need + 1)
    out = prefix_grid("int8", eng, "trunk", *grids["trunk"], tmp,
                      tmp / "int8_trunk.csv", control["bars"],
                      passes=("cold",))
    out["pages_needed"] = need
    out["control"] = control
    del eng
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# The chain phase (piggyback chains) and the int8-KV phase
# ---------------------------------------------------------------------------

# The chain grid: one legal prompt, its rephrasings opening differently
# (no trunk, no group), sized so that the plan is five dispatches of 32
# at one shape.
CHAIN_PROMPT = 2
CHAIN_CELLS = 160
# The chain must hold at least this many consecutive same-shape
# dispatches (one opening call, this many less one piggybacked steps).
CHAIN_MIN_RUN = 4
KV8_ROUTE = ("kv_int8_attention",)
FLOAT_DECODE = ("flash_decode", "flash_decode_trunk", "flash_decode_mq",
                "flash_decode_mq_trunk")
# The small float32 model with an int8 KV cache, card against CPU: a
# differing id is allowed where the two ids' log-probs under the int8
# cache (a forced decode on the CPU) are within this (one int8 level of a
# cached k/v moves a logit by about 1e-3 at this width), and the D6
# floats within KV8_SMALL_TOL (a level moves them by as much).
KV8_SMALL_TIE = 1e-2
KV8_SMALL_TOL = 1e-2


def chain_grid() -> tuple:
    """(prompts, perturbations) of the chain phase: CHAIN_PROMPT's text
    behind openings that differ ("Variation r:"), CHAIN_CELLS cells."""
    p = LEGAL_PROMPTS[CHAIN_PROMPT]
    words = p.main.split()

    def tail(r):
        return " ".join(words[r % 7: r % 7 + 10 + r % 13])

    return [p], [[f"Variation {r}: {p.main} {tail(r)}"
                  for r in range(CHAIN_CELLS - 1)]]


def chain_keys(engine, prompts, perts, rt) -> list:
    """Each planned dispatch's piggyback key as the sweep computes it
    (``sweep.chain_keys``: bucket, rows, suffix buckets; None for a
    grouped dispatch or one that takes the cascade)."""
    _, dispatches, _ = plan_sweep(engine, prompts, perts, rt)
    return sweep.chain_keys(engine, dispatches, rt.batch_size)


def longest_run(keys) -> int:
    best = run = 0
    for i, k in enumerate(keys):
        run = run + 1 if k is not None and i and keys[i - 1] == k else (
            1 if k is not None else 0)
        best = max(best, run)
    return best


def timed_sweep(eng, prompts, perts, path: Path) -> dict:
    """One sweep: rows/s by the host clock around work that ends in a
    synchronize, the launch counts (reset just before, read just after),
    the chain counters it added and the peak device memory."""
    chain0 = dict(eng.kernel_stats.counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    rows = sweep.run_perturbation_sweep(eng, SWEEP_MODEL, prompts, perts,
                                        path)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return dict(rows=len(rows), seconds=dt, rows_per_s=len(rows) / dt,
                chain={k: v - chain0.get(k, 0)
                       for k, v in eng.kernel_stats.counters.items()
                       if v != chain0.get(k, 0)},
                launches=ops.launch_counts(),
                max_memory_allocated_bytes=torch.cuda.max_memory_allocated())


def run_chain_phase(engine, rt, tmp: Path) -> dict:
    """The piggyback chain on the bf16 engine: the chain grid (its plan's
    keys printed; a run of at least CHAIN_MIN_RUN same-shape dispatches
    required) swept with chains on, then on an engine with them off.
    With chains on: ``piggybacked_steps`` at least CHAIN_MIN_RUN - 1,
    every opened chain drained, ``chain_fallbacks`` 0 (a fallback fails
    the run), ``flash_decode`` launched; off: no chain counter. The rows
    of the two runs: bitwise, or else within CONTROL_FACTOR times the
    movement of a control that changes the plain dispatch's attention
    extent alone (:func:`chain_control`; :func:`compare_d6`, flips only
    at near ties, each reported). A half-batch control, as the prefix
    phase takes, measures a row-count change; on this grid it moves a
    row by ~1e-5, where the chain changes something else: its
    extensions reduce over the chain's longer cache, and the confidence
    branch's keys sit in other slots."""
    prompts, perts = chain_grid()
    keys = chain_keys(engine, prompts, perts, rt)
    run = longest_run(keys)
    log(json.dumps({"phase": "chain_plan", "keys": keys,
                    "longest_same_key_run": run}))
    if run < CHAIN_MIN_RUN:
        raise AssertionError(f"chain grid: longest same-shape run {run}")
    on = timed_sweep(engine, prompts, perts, tmp / "bf16_chain_on.csv")
    ch = on["chain"]
    if (ch.get("piggybacked_steps", 0) < CHAIN_MIN_RUN - 1
            or ch.get("chains_drained", 0) != ch.get("chains_opened", 0)
            or ch.get("chain_fallbacks", 0)
            or on["launches"]["flash_decode"] <= 0):
        raise AssertionError(f"chain phase: counters {ch}, launches "
                             f"{on['launches']}")
    off_eng = engine_with(engine, piggyback_prefill=False)
    off = timed_sweep(off_eng, prompts, perts, tmp / "bf16_chain_off.csv")
    if off["chain"]:
        raise AssertionError(f"chain phase: chains with the flag off "
                             f"{off['chain']}")
    ref = d6_records(tmp / "bf16_chain_off.csv")
    got = d6_records(tmp / "bf16_chain_on.csv")
    out = dict(keys=keys, on=on, off=off, bitwise=got == ref)
    if not out["bitwise"]:
        out["control"] = chain_control(engine, rt, prompts, perts, ref, got,
                                       tmp)
        bars = {f: CONTROL_FACTOR * d
                for f, d in out["control"]["max_abs_diff"].items()}
        out["vs_off"] = compare_d6("bf16 chain on vs off", ref, got, engine,
                                   bars)
    del off_eng
    torch.cuda.empty_cache()
    log(json.dumps({"phase": "chain", **{k: v for k, v in out.items()
                                         if k != "keys"}}))
    return out


def d6_float_diffs(ref: dict, got: dict) -> dict:
    """The largest difference of each D6 float field, and of the top-20
    log-probs of ids in both maps, between two sweeps' rows."""
    worst = {f: 0.0 for f in D6_FLOATS + ("Log Probabilities",)}
    for key, b in got.items():
        a = ref[key]
        for f in D6_FLOATS:
            worst[f] = max(worst[f], abs(float(a[f]) - float(b[f])))
        la, lb = json.loads(a["Log Probabilities"]), json.loads(
            b["Log Probabilities"])
        worst["Log Probabilities"] = max(worst["Log Probabilities"], max(
            (abs(la[i] - lb[i]) for i in la.keys() & lb.keys()), default=0.0))
    return worst


def chain_control(engine, rt, prompts, perts, ref: dict, got: dict,
                  tmp: Path) -> dict:
    """The chain's control: the plain dispatches (chains off) with the
    confidence budget raised by the binary branch's suffix bucket and
    budget, so that both branches' suffix extensions reduce over the
    chain's cache extent (S + S2a + new_a + S2b + new_b) with their keys
    where the plain path puts them; each row's position-0 floats against
    the plain run's ``ref`` (measured, not held; its confidence texts are
    longer and not compared). The binary branch's readouts then
    reproduce the chain's own ``got`` (same extent, same slots; reported
    as ``binary_readouts_equal_chain``); the confidence branch's differ
    from the chain's by its slot shift."""
    _, dispatches, _ = plan_sweep(engine, prompts, perts, rt)
    sfx_a = max(d.sfx_bucket_a for d in dispatches)
    conf = rt.sweep_confidence_tokens + sfx_a + rt.sweep_decode_tokens
    eng = engine_with(engine, piggyback_prefill=False,
                      sweep_confidence_tokens=conf)
    path = tmp / "bf16_chain_control.csv"
    sweep.run_perturbation_sweep(eng, SWEEP_MODEL, prompts, perts, path)
    del eng
    rows = d6_records(path)
    binary = ("Token_1_Prob", "Token_2_Prob", "Log Probabilities")
    return dict(sweep_confidence_tokens=conf,
                max_abs_diff=d6_float_diffs(ref, rows),
                binary_readouts_equal_chain=all(
                    rows[k][f] == got[k][f] for k in got for f in binary))


def kv8_engine(engine):
    """An engine on ``engine``'s weights (no second load) whose config
    stores the KV cache in int8."""
    return ScoringEngine(engine.params,
                         dataclasses.replace(engine.cfg, kv_cache_int8=True),
                         engine.tokenizer, engine.rt,
                         cascade_config=engine.cascade_cfg,
                         spec_config=engine.spec_cfg, device=engine.device)


def d6_gaps(ref: dict, got: dict) -> dict:
    """Two sweeps' rows of one grid: the largest difference of each D6
    float (:func:`d6_float_diffs`) and the rows whose texts differ
    (measured, not held)."""
    return dict(max_abs_diff=d6_float_diffs(ref, got), rows=len(got),
                rows_text_differs=sum(
                    any(ref[k][f] != b[f] for f in D6_PROMPTS)
                    for k, b in got.items()))


def run_kv_int8_phase(engine, rt, grids, tmp: Path, flat_peak: int) -> dict:
    """The int8 KV cache at llama-2-7b width: an engine on the bf16
    weights with ``kv_cache_int8`` (its cascade gates off), the chain
    grid (chains on) and the flat grid (three speculative dispatches, the
    1,024-bucket tail among them) swept: rows/s, peak memory beside the
    bf16-KV engine's (``flat_peak`` for the flat grid, the chain phase's
    for the chain grid), ``kv_int8_attention`` launched and no float
    decode kernel, the chain's counters, PR 18's rows/s (its two calls)
    beside each grid's, and each grid's largest
    differences from the bf16-KV rows (reported, not held: the int8
    cache rounds every k/v)."""
    eng = kv8_engine(engine)
    if eng.cascade_supported() or eng.cascade_decode_supported():
        raise AssertionError("int8 KV engine: cascade gates on")
    out = {}
    for name, (prompts, perts), ref in (
            ("chain", chain_grid(), tmp / "bf16_chain_on.csv"),
            ("flat", grids["flat"], tmp / "bf16_flat.csv")):
        path = tmp / f"kv8_{name}.csv"
        st = timed_sweep(eng, prompts, perts, path)
        n = check_d6(f"kv8 {name}", path, st["rows"])
        lau = st["launches"]
        if (any(lau[k] <= 0 for k in KV8_ROUTE)
                or any(lau[k] for k in FLOAT_DECODE)):
            raise AssertionError(f"kv8 {name}: launches {lau}")
        if name == "chain" and (st["chain"].get("chain_fallbacks", 0)
                                or st["chain"].get("piggybacked_steps", 0)
                                < CHAIN_MIN_RUN - 1):
            raise AssertionError(f"kv8 chain: counters {st['chain']}")
        st["rows_on_disk"] = n
        st["pr18_rows_per_s"] = KV8_PR18_ROWS_PER_S[name]
        st["vs_bf16_kv"] = d6_gaps(d6_records(ref), d6_records(path))
        out[name] = st
    out["flat"]["bf16_kv_peak_bytes"] = flat_peak
    out["flat"]["peak_saving_bytes"] = (
        flat_peak - out["flat"]["max_memory_allocated_bytes"])
    # The flat grid's largest dispatch (the promoted tail): its cache at
    # the speculative extent, in both layouts.
    _, dispatches, _ = plan_sweep(engine, *grids["flat"], rt)
    d = max(dispatches, key=lambda d: d.bucket)
    T = generate.spec_total_len(d.bucket, d.sfx_bucket_a, d.sfx_bucket_b,
                                rt.sweep_decode_tokens,
                                rt.sweep_confidence_tokens, rt.spec_k)
    out["flat_tail_cache_bytes"] = dict(
        bucket=d.bucket, T=T,
        bf16=decoder.kv_cache_bytes(engine.cfg, rt.batch_size, T),
        int8=decoder.kv_cache_bytes(eng.cfg, rt.batch_size, T))
    log(json.dumps({"phase": "kv_int8", **out}))
    del eng
    torch.cuda.empty_cache()
    return out


@torch.inference_mode()
def kv8_flip_gap(eng, prompt: str, text_a: str, text_b: str) -> float:
    """|log p(a) - log p(b)| of the two ids where two completions of
    ``prompt`` part, under ``eng``'s int8 cache: the prompt prefilled,
    the common ids before that step decoded through the cache."""
    a, b = completion_ids(text_a), completion_ids(text_b)
    j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
             min(len(a), len(b)))
    ids = [a[j] if j < len(a) else eng.eos_id,
           b[j] if j < len(b) else eng.eos_id]
    toks = torch.tensor([eng.tokenizer(prompt).input_ids], dtype=torch.int32,
                        device=eng.device)
    n = toks.shape[1]
    logits, cache, pos = decoder.prefill(eng.params, eng.cfg, toks,
                                         torch.ones_like(toks), n + j)
    cm = torch.zeros((1, n + j), dtype=torch.int32, device=eng.device)
    cm[:, :n] = 1
    for t in range(j):
        cm[:, n + t] = 1
        logits, cache = decoder.decode_step(
            eng.params, eng.cfg, cache,
            torch.tensor([a[t]], dtype=torch.int32, device=eng.device),
            pos + t, n + t, cm)
    lp = torch.log_softmax(logits[0].float(), dim=-1)[ids].tolist()
    return abs(lp[0] - lp[1])


def kv8_small_check(cfg, params_cpu, params_gpu) -> dict:
    """The small float32 model with an int8 KV cache, card against CPU:
    the flat grid of sweep_grids(3) (chained and speculative dispatches
    at B = 4). Texts equal save flips where the two ids' log-probs under
    the CPU's int8 cache are within KV8_SMALL_TIE (each reported);
    Token_1/2_Prob, Weighted Confidence (over 100) and the common top-20
    log-probs within KV8_SMALL_TOL; the same chain counters on both."""
    cfg8 = dataclasses.replace(cfg, kv_cache_int8=True)
    prompts, perts = sweep_grids(3)["flat"]
    rt = RuntimeConfig(batch_size=4, max_new_tokens=12)
    recs, engines = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for side, params, dev in (("card", params_gpu, DEV),
                                  ("cpu", params_cpu, "cpu")):
            eng = ScoringEngine(params, cfg8, FakeTokenizer(), rt, device=dev)
            path = Path(tmp) / f"{side}.csv"
            ops.reset_launches()
            sweep.run_perturbation_sweep(eng, "smoke-tiny", prompts, perts,
                                         path)
            if (side == "card"
                    and ops.launch_counts()["kv_int8_attention"] <= 0):
                raise AssertionError("kv8 small: the kernel never launched")
            recs[side], engines[side] = d6_records(path), eng
    card, cpu = recs["card"], recs["cpu"]
    flips = []
    for key, a in cpu.items():
        b = card[key]
        for f, prompt in D6_PROMPTS.items():
            if a[f] != b[f]:
                gap = kv8_flip_gap(engines["cpu"], a[prompt], a[f], b[f])
                flips.append(dict(field=f, gap=gap))
                if gap > KV8_SMALL_TIE:
                    raise AssertionError(f"kv8 small: {f} differs card vs "
                                         f"CPU at a gap of {gap}")
    gaps = d6_gaps(cpu, card)
    worst = dict(gaps["max_abs_diff"])
    worst["Weighted Confidence"] /= 100.0
    if max(worst.values()) > KV8_SMALL_TOL or (
            engines["card"].kernel_stats.counters
            != engines["cpu"].kernel_stats.counters):
        raise AssertionError(f"kv8 small: card vs CPU {gaps}, chains "
                             f"{engines['card'].kernel_stats.counters} vs "
                             f"{engines['cpu'].kernel_stats.counters}")
    out = dict(rows=len(card), flips=flips, max_abs_diff=gaps["max_abs_diff"],
               chain=engines["card"].kernel_stats.counters)
    log(json.dumps({"phase": "kv_int8_small", **out}))
    return out


# ---------------------------------------------------------------------------
# The T5 phase: the encoder-decoder branch (models/encdec.py and the capture
# path) at a small size on the card against the CPU, then at T0_3B width in
# bf16 and in 8 bit.
# ---------------------------------------------------------------------------

# Card against CPU at the small size (float32).
T5_TOL = 1e-4
T5_MODEL = "bigscience/T0_3B"
# The bf16 first-position log-probs against the same weights in float32:
# fail above this factor times the gap a width-reduced twin of the model
# (T5_TWIN_WIDTH wide, 64-wide heads, the same depth and init rules, the
# same token rows) shows between bf16 and float32 on the CPU. The gap is
# the activations' bf16 rounding carried through the layers; with the
# init below it does not grow with width (hidden 256, 512 and 1024 gave
# the same gap on the CPU), so the twin measures it at this width, and
# the factor leaves room for cuBLAS's and the CPU's other summation
# orders.
T5_GAP_FACTOR = 4.0
T5_TWIN_WIDTH = 256
T5_GAP_ROWS = 4
# The small-size models: (name, T5Config fields, weight scale so that the
# tiny logits spread).
T5_SMALL = (
    ("gated_untied", dict(gated_mlp=True, tie_embeddings=False), 5.0),
    ("relu_tied", dict(gated_mlp=False, tie_embeddings=True,
                       activation="relu"), 12.0),
)


def t5_init_std(cfg) -> dict:
    """HF T5's init std of each leaf (``T5PreTrainedModel._init_weights``,
    initializer factor 1): q (d_model * d_kv)^-1/2, k and v d_model^-1/2,
    o (heads * d_kv)^-1/2, wi d_model^-1/2, wo d_ff^-1/2, the embedding
    1 and the relative-position tables d_model^-1/2; the untied head
    d_model^-1/2 (HF: 1), which gives logits of unit spread. The query's
    small scale is what stands in for the 1/sqrt(d) T5 leaves out: with
    encdec.init_params' 0.02 everywhere, the scores at T0_3B width have a
    spread of ~6.5 and the network is chaotic (bf16 and float32 agree on
    nothing after 48 layers)."""
    D, hd, H, F_ = (cfg.hidden_size, cfg.head_dim, cfg.n_heads,
                    cfg.intermediate_size)
    attn = {"q": (D * hd) ** -0.5, "k": D ** -0.5, "v": D ** -0.5,
            "o": (H * hd) ** -0.5}
    std = {f"w{n}": s for n, s in attn.items()}
    std.update({f"c{n}": s for n, s in attn.items()})
    std.update({"wi": D ** -0.5, "wi_0": D ** -0.5, "wi_1": D ** -0.5,
                "wo_mlp": F_ ** -0.5, "shared_embed": 1.0,
                "enc_rel_embed": D ** -0.5, "dec_rel_embed": D ** -0.5,
                "lm_head": D ** -0.5})
    return std


def t5_params(cfg, seed: int, device, dtype):
    """Seeded T5 weights on ``device`` at HF T5's init scales:
    ``encdec.init_params`` (0.02 normals, norms 1) rescaled leaf by leaf
    in place (:func:`t5_init_std`)."""
    params = encdec.init_params(cfg, seed=seed, device=device, dtype=dtype)
    std = t5_init_std(cfg)
    for path, leaf in leaves(params):
        name = path.split("/")[-1]
        if name in std:
            leaf.mul_(std[name] / 0.02)
    return params


def _float_tree(tree):
    return {k: (_float_tree(v) if isinstance(v, dict) else v.float())
            for k, v in tree.items()}


def first_logprobs(params, cfg, toks, mask) -> torch.Tensor:
    """The first decoded position's float32 log-probs of rows
    ``toks``/``mask``."""
    start = torch.full((toks.shape[0], 1), cfg.decoder_start_token_id,
                       dtype=torch.int32, device=toks.device)
    return torch.log_softmax(encdec.forward(params, cfg, toks, mask,
                                            start)[:, 0], dim=-1)


def t5_twin_gap(cfg, toks, mask, width: int = T5_TWIN_WIDTH,
                hf_init: bool = True):
    """(the largest |bf16 - float32| first-position log-prob, the rows
    whose top-1 agrees) of a twin of ``cfg`` ``width`` wide (64-wide
    heads, d_ff in proportion) on the CPU, on the same token rows, its
    weights at HF T5's init scales (:func:`t5_params`, whose products
    have the same spread at every width) or, with ``hf_init`` False,
    ``encdec.init_params``' 0.02 with each stack matrix and the head
    times sqrt(cfg width / width): the spread 0.02 gives ``cfg``."""
    twin = dataclasses.replace(
        cfg, name=f"{cfg.name}-twin", hidden_size=width,
        n_heads=width // cfg.head_dim,
        intermediate_size=cfg.intermediate_size * width // cfg.hidden_size)
    if hf_init:
        bf = t5_params(twin, seed=0, device="cpu", dtype=torch.bfloat16)
    else:
        bf = encdec.init_params(twin, seed=0, device="cpu",
                                dtype=torch.bfloat16)
        for path, leaf in leaves(bf):
            name = path.split("/")[-1]
            if name == "lm_head" or (path.startswith(("encoder/", "decoder/"))
                                     and not name.startswith("ln_")):
                leaf.mul_((cfg.hidden_size / width) ** 0.5)
    with torch.inference_mode():
        lp_bf = first_logprobs(bf, twin, toks, mask)
        lp_f32 = first_logprobs(_float_tree(bf), twin, toks, mask)
    return (float((lp_bf - lp_f32).abs().max()),
            int((lp_bf.argmax(-1) == lp_f32.argmax(-1)).sum()))


def t5_small_check() -> dict:
    """The T5 phase's part (a): two small float32 T5s (gated untied; ReLU
    tied, v1.0) through ``t5_greedy_decode`` (``decode_prompts``) and
    ``score_prompts`` on the card against the CPU: ids and texts exact,
    step logits and readouts within T5_TOL. Then the decoder half of the
    capture path, ``decode_prompts`` on the small decoder engine: the
    same against the CPU, its flash-decode launches counted."""
    prompts = [format_instruct_prompt(q) for q in WORD_MEANING_QUESTIONS[:8]]
    rt = RuntimeConfig(batch_size=8, max_new_tokens=12)
    out = {}

    def compare(label, a, b):
        (ga, la), (gb, lb) = a, b
        if not torch.equal(ga.cpu(), gb.cpu()):
            raise AssertionError(f"{label}: generated ids differ")
        err = float((la.cpu() - lb.cpu()).abs().max())
        if not err <= T5_TOL:
            raise AssertionError(f"{label}: step logits differ by {err}")
        return err

    for kind, kw, scale in T5_SMALL:
        cfg = registry.T5Config(name=f"smoke-t5-{kind}", vocab_size=1000,
                                hidden_size=64, n_layers=2, n_heads=4,
                                head_dim=16, intermediate_size=128, **kw)
        p_cpu = encdec.init_params(cfg, seed=2, device="cpu")
        for path, leaf in leaves(p_cpu):
            if not path.split("/")[-1].startswith(("ln_", "enc_final",
                                                   "dec_final")):
                leaf.mul_(scale)
        engs = {dev: ScoringEngine(p, cfg, FakeTokenizer(), rt, device=dev,
                                   encoder_decoder=True)
                for dev, p in (("cpu", p_cpu), (DEV, _to_device(p_cpu, DEV)))}
        err = compare(f"t5_small/{kind}", engs[DEV].decode_prompts(prompts),
                      engs["cpu"].decode_prompts(prompts))
        rows = {dev: e.score_prompts(prompts) for dev, e in engs.items()}
        worst = 0.0
        for a, b in zip(rows[DEV], rows["cpu"]):
            if (a.completion, a.position_found, a.yes_no_found) != (
                    b.completion, b.position_found, b.yes_no_found):
                raise AssertionError(f"t5_small/{kind}: {a} vs {b}")
            for f in ("yes_prob", "no_prob", "relative_prob"):
                worst = max(worst, abs(getattr(a, f) - getattr(b, f)))
        if not worst <= T5_TOL:
            raise AssertionError(f"t5_small/{kind}: readouts differ by {worst}")
        out[kind] = dict(step_logits_max_abs_err=err,
                         readout_max_abs_err=worst,
                         positions=[r.position_found for r in rows[DEV]])

    cfg, p_cpu, p_gpu = small_model()
    engs = {dev: ScoringEngine(p, cfg, FakeTokenizer(), rt, device=dev)
            for dev, p in (("cpu", p_cpu), (DEV, p_gpu))}
    torch.cuda.synchronize()
    ops.reset_launches()
    card = engs[DEV].decode_prompts(prompts)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    if launches["flash_decode"] <= 0:
        raise AssertionError("t5_small/decoder_capture: flash_decode never "
                             "launched")
    err = compare("t5_small/decoder_capture", card,
                  engs["cpu"].decode_prompts(prompts))
    out["decoder_capture"] = dict(step_logits_max_abs_err=err,
                                  launches=launches)
    log(json.dumps({"phase": "t5_small", **out}))
    return out


def t5_sweep(label, engine, questions, fmt) -> dict:
    """``run_word_meaning_sweep`` on a T5 engine: rows/s, seconds and the
    peak device memory; every readout in range, ``position_found`` in
    [0, scan_positions)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rows = sweep.run_word_meaning_sweep(engine, T5_MODEL, "instruct",
                                        questions, fmt)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if len(rows) != len(questions):
        raise AssertionError(f"{label}: {len(rows)} rows")
    check_scores(label, {"p_yes": [r.yes_prob for r in rows],
                         "p_no": [r.no_prob for r in rows]})
    scan = engine.rt.scan_positions
    if not all(0 <= r.position_found < scan for r in rows):
        raise AssertionError(f"{label}: position_found outside [0, {scan})")
    stats = dict(rows=len(rows), seconds=dt, rows_per_s=len(rows) / dt,
                 max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
                 yes_no_found=sum(r.yes_no_found for r in rows))
    log(json.dumps({"phase": label, **stats}))
    return stats


def check_t5_int8(q8, params, cfg) -> list:
    """The int8 payloads and scales of layers 0 and L - 1 of both stacks
    and of the head, bitwise the same quantization on the CPU."""
    checked = []
    for side in ("encoder", "decoder"):
        for name, leaf in q8[side].items():
            if not isinstance(leaf, quant.QuantTensor):
                continue
            for i in (0, cfg.n_layers - 1):
                ref = quant.quantize(params[side][name][i].cpu())
                if not (torch.equal(leaf.q[i].cpu(), ref.q)
                        and torch.equal(leaf.scale[i].cpu(), ref.scale)
                        and leaf.dynamic):
                    raise AssertionError(f"t5 int8: {side}/{name}[{i}]")
                checked.append(f"{side}/{name}[{i}]")
    ref = quant.quantize(params["lm_head"].cpu())
    head = q8["lm_head"]
    if head.dynamic or not (torch.equal(head.q.cpu(), ref.q)
                            and torch.equal(head.scale.cpu(), ref.scale)):
        raise AssertionError("t5 int8: lm_head")
    return checked + ["lm_head"]


def run_t5_phase(questions=WORD_MEANING_QUESTIONS) -> dict:
    """The T5 phase's parts (b) and (c): T0_3B (``registry.t0_3b()``)
    with seeded bf16 weights made on the card (:func:`t5_params`), the
    word-meaning questions at B = 32 and 50 new tokens through
    ``run_word_meaning_sweep`` on an ``encoder_decoder=True`` engine; the
    first decoded position's log-probs of T5_GAP_ROWS rows against the
    same weights upcast to float32 on the card, within T5_GAP_FACTOR
    times the twin's gap (:func:`t5_twin_gap`); then the tree quantized
    on the card (``quantize_encdec_params``, dynamic), checked bitwise
    against the CPU (:func:`check_t5_int8`), and the same sweep on it."""
    cfg = registry.t0_3b()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = t5_params(cfg, seed=0, device=DEV, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    stats = dict(init_seconds=time.perf_counter() - t0,
                 param_bytes=quant.param_bytes(params))
    tokenizer = FakeTokenizer(vocab=cfg.vocab_size)
    rt = RuntimeConfig(batch_size=BATCH)
    fmt = format_instruct_prompt
    engine = ScoringEngine(params, cfg, tokenizer, rt, device=DEV,
                           encoder_decoder=True)
    stats["bf16"] = t5_sweep("t5_bf16", engine, questions, fmt)

    prompts = [fmt(q) for q in questions[:BATCH]]
    gen, steps = engine.decode_prompts(prompts)
    toks, mask = engine._pad_batch(prompts)
    toks, mask = toks[:T5_GAP_ROWS], mask[:T5_GAP_ROWS]
    lp_bf16 = torch.log_softmax(steps[:T5_GAP_ROWS, 0], dim=-1)
    del gen, steps
    p32 = _float_tree(params)
    with torch.inference_mode():
        lp_f32 = first_logprobs(p32, cfg, toks, mask)
    del p32
    gap = float((lp_bf16 - lp_f32).abs().max())
    twin, _ = t5_twin_gap(cfg, toks.cpu(), mask.cpu())
    bar = T5_GAP_FACTOR * twin
    # Why the bar can rest on a narrower twin and on HF T5's init: the
    # twin's gap at twice its width, and at encdec.init_params' 0.02.
    wide = t5_twin_gap(cfg, toks.cpu(), mask.cpu(), width=2 * T5_TWIN_WIDTH)
    flat = t5_twin_gap(cfg, toks.cpu(), mask.cpu(), hf_init=False)
    stats["f32_check"] = dict(
        rows=T5_GAP_ROWS, max_abs_logprob_gap=gap, twin_gap=twin, bar=bar,
        top1_agree=int((lp_bf16.argmax(-1) == lp_f32.argmax(-1)).sum()),
        twin_2x_width=dict(gap=wide[0], top1_agree=wide[1]),
        twin_init_0_02=dict(gap=flat[0], top1_agree=flat[1]))
    log(json.dumps({"phase": "t5_f32_check", **stats["f32_check"]}))
    if not gap <= bar:
        raise AssertionError(f"t5: bf16 log-probs {gap} from float32, bar {bar}")
    del engine, lp_bf16, lp_f32
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    q8 = quant.quantize_encdec_params(params, dynamic=True)
    torch.cuda.synchronize()
    stats["int8_quantize_seconds"] = time.perf_counter() - t0
    stats["int8_checked"] = len(check_t5_int8(q8, params, cfg))
    stats["int8_param_bytes"] = quant.param_bytes(q8)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    engine8 = ScoringEngine(q8, cfg, tokenizer, rt, device=DEV,
                            encoder_decoder=True)
    stats["int8"] = t5_sweep("t5_int8", engine8, questions, fmt)
    del engine8, q8
    gc.collect()
    torch.cuda.empty_cache()
    if abs(torch.cuda.memory_allocated() - mem0) > LOADER_RELEASE_SLACK:
        raise AssertionError("t5: the phase's tensors were not released")
    log(json.dumps({
        "phase": "t5", "model": cfg.name,
        "rows_per_s": [stats["bf16"]["rows_per_s"],
                       stats["int8"]["rows_per_s"]],
        "max_memory_allocated_bytes": [
            stats["bf16"]["max_memory_allocated_bytes"],
            stats["int8"]["max_memory_allocated_bytes"]],
        "param_bytes": [stats["param_bytes"], stats["int8_param_bytes"]],
        "order": ["bf16", "int8"], "f32_check": stats["f32_check"],
        "int8_leaves_checked": stats["int8_checked"]}))
    return stats


# ---------------------------------------------------------------------------
# The loader phase's T5 checkpoint: google/t5-v1_1-base's width in fp16,
# HF T5 key names, flan-t5-base's published config.json fields.
# ---------------------------------------------------------------------------

LOADER_T5 = "google/t5-v1_1-base"
LOADER_FLAN = "google/flan-t5-base"


def hf_t5_tensors(params, cfg) -> dict:
    """A T5 param tree in HF ``T5ForConditionalGeneration`` layout (name ->
    view of the port's tensor; projections transposed back to torch's
    (out, in)); the embedding once, as ``shared.weight`` (safetensors
    holds no tied copies)."""
    out = {"shared.weight": params["shared_embed"]}
    attn = (("wq", "q"), ("wk", "k"), ("wv", "v"), ("wo", "o"))
    cross = (("cq", "q"), ("ck", "k"), ("cv", "v"), ("co", "o"))
    mlp = ((("wi_0", "wi_0"), ("wi_1", "wi_1")) if cfg.gated_mlp
           else (("wi", "wi"),)) + (("wo_mlp", "wo"),)
    for side, rel, final in (("encoder", "enc_rel_embed", "enc_final_ln"),
                             ("decoder", "dec_rel_embed", "dec_final_ln")):
        st = params[side]
        for i in range(cfg.n_layers):
            p = f"{side}.block.{i}.layer."
            for key, n in attn:
                out[f"{p}0.SelfAttention.{n}.weight"] = st[key][i].T
            if i == 0:
                out[f"{p}0.SelfAttention.relative_attention_bias.weight"] = (
                    params[rel])
            out[f"{p}0.layer_norm.weight"] = st["ln_attn"][i]
            m = 1
            if side == "decoder":
                for key, n in cross:
                    out[f"{p}1.EncDecAttention.{n}.weight"] = st[key][i].T
                out[f"{p}1.layer_norm.weight"] = st["ln_cross"][i]
                m = 2
            for key, n in mlp:
                out[f"{p}{m}.DenseReluDense.{n}.weight"] = st[key][i].T
            out[f"{p}{m}.layer_norm.weight"] = st["ln_mlp"][i]
        out[f"{side}.final_layer_norm.weight"] = params[final]
    if not cfg.tie_embeddings:
        out["lm_head.weight"] = params["lm_head"].T
    return out


def hf_t5_config(cfg) -> dict:
    """config.json with google/flan-t5-base's published fields, at
    ``cfg``'s sizes, in fp16."""
    return {"architectures": ["T5ForConditionalGeneration"],
            "d_ff": cfg.intermediate_size, "d_kv": cfg.head_dim,
            "d_model": cfg.hidden_size,
            "decoder_start_token_id": cfg.decoder_start_token_id,
            "dense_act_fn": "gelu_new" if cfg.gated_mlp else "relu",
            "dropout_rate": 0.1, "eos_token_id": 1,
            "feed_forward_proj": "gated-gelu" if cfg.gated_mlp else "relu",
            "initializer_factor": 1.0, "is_encoder_decoder": True,
            "is_gated_act": cfg.gated_mlp,
            "layer_norm_epsilon": cfg.norm_eps, "model_type": "t5",
            "n_positions": 512, "num_decoder_layers": cfg.n_layers,
            "num_heads": cfg.n_heads, "num_layers": cfg.n_layers,
            "output_past": True, "pad_token_id": 0,
            "relative_attention_max_distance":
                cfg.relative_attention_max_distance,
            "relative_attention_num_buckets":
                cfg.relative_attention_num_buckets,
            "tie_word_embeddings": cfg.tie_embeddings,
            "torch_dtype": "float16", "use_cache": True,
            "vocab_size": cfg.vocab_size}


def export_hf_t5(params, cfg, out_dir: Path) -> Path:
    """Write a T5 param tree as an fp16 HF checkpoint: one
    ``model.safetensors`` by this script's writer and ``config.json``."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "model.safetensors"
    write_safetensors(path, hf_t5_tensors(params, cfg))
    (out_dir / "config.json").write_text(json.dumps(hf_t5_config(cfg),
                                                    indent=2))
    return path


def check_loaded_t5(loaded, params, cfg_path: Path, ref_cfg):
    """The loaded bf16 T5 tree, leaf by leaf, bitwise the written fp16
    checkpoint widened back to bfloat16; its config ``ref_cfg``'s but
    the name."""
    cfg = loader.t5_config_from_hf(json.loads(cfg_path.read_text()))
    if dataclasses.replace(cfg, name=ref_cfg.name) != ref_cfg:
        raise AssertionError(f"loader t5: t5_config_from_hf gave {cfg}")
    check_half_leaves("loader t5", loaded, params)


# ---------------------------------------------------------------------------
# The loader phase: a full-width HF checkpoint written here, loaded by the
# port, and swept by run_model_comparison_sweep.
# ---------------------------------------------------------------------------

LOADER_BASE = "meta-llama/Llama-2-7b-hf"
LOADER_CHAT = "meta-llama/Llama-2-7b-chat-hf"
LOADER_ABSENT = "absent/model"
LOADER_MIN_FREE_BYTES = 32e9
# Device memory a released model may leave behind (allocator slack).
LOADER_RELEASE_SLACK = 64 * 2**20
# The loader phase's checkpoint: fp16 (the dtype meta-llama publishes
# Llama-2-7b-hf in), in two shards.
LOADER_SHARDS = 2


def leaves(tree, prefix=""):
    """(path, tensor) of every leaf of a param tree, in order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def hf_llama_tensors(params, cfg) -> dict:
    """A llama param tree in HF ``LlamaForCausalLM`` layout (name ->
    view of the port's tensor; projections transposed back to torch's
    (out, in)), in the order HF names them."""
    lay = params["layers"]
    out = {"model.embed_tokens.weight": params["tok_embed"]}
    hf = (("self_attn.q_proj", "wq"), ("self_attn.k_proj", "wk"),
          ("self_attn.v_proj", "wv"), ("self_attn.o_proj", "wo"),
          ("mlp.gate_proj", "w_gate"), ("mlp.up_proj", "w_up"),
          ("mlp.down_proj", "w_down"))
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        out[p + "input_layernorm.weight"] = lay["ln1"]["scale"][i]
        for name, key in hf:
            out[p + name + ".weight"] = lay[key][i].T
        out[p + "post_attention_layernorm.weight"] = lay["ln2"]["scale"][i]
    out["model.norm.weight"] = params["final_ln"]["scale"]
    out["lm_head.weight"] = params["lm_head"].T
    return out


def write_safetensors(path: Path, tensors: dict) -> None:
    """Write ``tensors`` (any device) to one safetensors file in fp16:
    the 8-byte little-endian header length, the JSON header (padded with
    spaces to 8 bytes), then each tensor's bytes. One tensor at a time
    is copied to the host."""
    header, offset = {"__metadata__": {"format": "pt"}}, 0
    for name, t in tensors.items():
        n = 2 * t.numel()
        header[name] = {"dtype": "F16", "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            host = t.to(torch.float16).contiguous().cpu().reshape(-1)
            f.write(memoryview(host.view(torch.uint8).numpy()))


def hf_llama_config(cfg) -> dict:
    """config.json of a llama ModelConfig in fp16, as ``LlamaConfig``
    writes it."""
    return {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size,
            "num_hidden_layers": cfg.n_layers,
            "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads,
            "max_position_embeddings": cfg.max_seq_len,
            "rms_norm_eps": cfg.norm_eps, "rope_theta": cfg.rope_theta,
            "hidden_act": "silu", "tie_word_embeddings": cfg.tie_embeddings,
            "bos_token_id": 1, "eos_token_id": 2, "torch_dtype": "float16"}


def export_hf_llama(params, cfg, out_dir: Path):
    """Write a llama param tree as an fp16 HF checkpoint:
    ``LOADER_SHARDS`` safetensors files split by bytes,
    ``model.safetensors.index.json`` and ``config.json``. Returns the
    shard paths."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    tensors = hf_llama_tensors(params, cfg)
    total = sum(t.numel() for t in tensors.values())
    n = LOADER_SHARDS
    groups, acc = [[] for _ in range(n)], 0
    for name, t in tensors.items():
        groups[min(n - 1, acc * n // total)].append(name)
        acc += t.numel()
    files, weight_map = [], {}
    for j, names in enumerate(groups):
        path = out_dir / f"model-{j + 1:05d}-of-{n:05d}.safetensors"
        write_safetensors(path, {k: tensors[k] for k in names})
        weight_map.update(dict.fromkeys(names, path.name))
        files.append(path)
    (out_dir / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": 2 * total}, "weight_map": weight_map},
        indent=2))
    (out_dir / "config.json").write_text(json.dumps(hf_llama_config(cfg),
                                                    indent=2))
    return files


class RssSampler:
    """The process's resident set (``VmRSS``) sampled every ``period``
    seconds on a thread while a ``with`` block runs: ``peak_bytes`` is
    the largest sample, ``before_bytes`` the first. ``ru_maxrss_bytes``
    beside them is ``resource.getrusage``'s peak since the start."""

    def __init__(self, period: float = 0.005):
        self.period = period
        self.samples = []
        self._stop = threading.Event()

    @staticmethod
    def rss_bytes() -> int:
        for line in Path("/proc/self/status").read_text().splitlines():
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
        raise RuntimeError("no VmRSS in /proc/self/status")

    def _run(self):
        while not self._stop.is_set():
            self.samples.append(self.rss_bytes())
            self._stop.wait(self.period)

    def __enter__(self):
        self.samples.append(self.rss_bytes())
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.samples.append(self.rss_bytes())

    def summary(self) -> dict:
        return {"before_bytes": self.samples[0],
                "peak_bytes": max(self.samples),
                "after_bytes": self.samples[-1],
                "samples": len(self.samples),
                "ru_maxrss_bytes": resource.getrusage(
                    resource.RUSAGE_SELF).ru_maxrss * 1024}


def check_loaded_tree(loaded, params, cfg_path: Path, ref_cfg):
    """The loaded bf16 tree, leaf by leaf, bitwise the written fp16
    checkpoint widened back to bfloat16; its config, field by field,
    ``ref_cfg``'s but the name."""
    cfg, family = loader.config_from_hf(json.loads(cfg_path.read_text()))
    if family != "llama" or dataclasses.replace(cfg, name=ref_cfg.name) != ref_cfg:
        raise AssertionError(f"loader: config_from_hf gave {cfg}, not {ref_cfg}")
    check_half_leaves("loader", loaded, params)


def check_half_leaves(label, loaded, params):
    """Every leaf of ``loaded`` bf16 and bitwise the same leaf of
    ``params`` written in fp16 and widened back to bfloat16."""
    want = dict(leaves(params))
    got = list(leaves(loaded))
    if sorted(p for p, _ in got) != sorted(want):
        raise AssertionError(f"{label}: leaves {[p for p, _ in got]}")
    for path, leaf in got:
        if leaf.dtype != torch.bfloat16 or not torch.equal(
                leaf, want[path].half().bfloat16()):
            raise AssertionError(f"{label}: {path} is not params.half().bfloat16()")


def check_int8_tree(loaded, params, matrices=quant.LAYER_MATRICES):
    """The 8-bit load against ``quantize_decoder_params`` (or, with
    ``matrices=quant.ENCDEC_MATRICES``, ``quantize_encdec_params``),
    dynamic, of the checkpoint's bf16 tree, a stacked leaf at a time as
    the engine quantizes it: the ``matrices`` and the head int8 (the
    head weight-only), each bitwise; every other leaf bitwise the bf16
    tree's."""
    want = dict(leaves(params))
    for path, leaf in leaves(loaded):
        ref = want[path].half().bfloat16()
        name = path.split("/")[-1]
        if name in matrices or name == "lm_head":
            q = quant.quantize(ref)
            ok = (isinstance(leaf, quant.QuantTensor)
                  and torch.equal(leaf.q, q.q)
                  and torch.equal(leaf.scale, q.scale)
                  and leaf.dynamic == (name != "lm_head"))
            del q
        else:
            ok = torch.equal(leaf, ref)
        if not ok:
            raise AssertionError(f"loader int8: {path} differs")


def run_comparison(label, factory, specs, out_dir: Path, questions,
                   kernels):
    """run_model_comparison_sweep with launch counts reset just before and
    read just after, and the device memory allocated before and after
    (the models must have been released). Returns (artifacts, stats)."""
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    art = run_model_comparison_sweep(specs, factory, out_dir,
                                     questions=questions)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = ops.launch_counts()
    mem1 = torch.cuda.memory_allocated()
    missing = [k for k in kernels if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched: {missing}")
    if abs(mem1 - mem0) > LOADER_RELEASE_SLACK:
        raise AssertionError(f"{label}: {mem1 - mem0} bytes still allocated "
                             f"after the sweep (models not released)")
    # No weight budget on the card: the sweep's own fleet drops each
    # model once its rows are in.
    st = art["fleet"]
    if st["resident_models"] or st["evictions"] != st["loads"]:
        raise AssertionError(f"{label}: models stayed cached {st}")
    stats = dict(seconds=dt, throughput=art["throughput"], fleet=st,
                 per_model=art["per_model"], launches=launches,
                 memory_allocated_before=mem0, memory_allocated_after=mem1,
                 max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    log(json.dumps({"phase": label, **stats}))
    return art, stats


def _check_model_rows(label, art, specs, questions, n_d1, n_d2):
    """ok models: their rows; a model with no checkpoint: error:model and
    NaN rows; D1 and D2 of the expected sizes, in memory and on disk."""
    n = len(questions)
    for spec in specs:
        st = art["per_model"][spec.name]
        rows = [r for r in art["model_comparison_csv"]
                if r["model"] == spec.name]
        nan = [r for r in rows if math.isnan(r["yes_prob"])]
        if spec.name == LOADER_ABSENT:
            ok = (str(st["status"]).startswith("error:model")
                  and "no local checkpoint" in str(st["status"])
                  and len(rows) == n and len(nan) == n)
        else:
            ok = st["status"] == "ok" and st["rows"] == n and not nan
            if ok:
                check_scores(f"{label}/{spec.name}", {
                    "p_yes": [r["yes_prob"] for r in rows],
                    "p_no": [r["no_prob"] for r in rows]})
        if not ok:
            raise AssertionError(f"{label}: {spec.name} {st}")
    d2 = art.get("instruct_comparison_csv", [])
    if len(art["model_comparison_csv"]) != n_d1 or len(d2) != n_d2:
        raise AssertionError(f"{label}: D1 {len(art['model_comparison_csv'])} "
                             f"rows, D2 {len(d2)}")


def run_loader_phase(params, cfg, questions=WORD_MEANING_QUESTIONS,
                     t5_cfg=None):
    """The loader phase (see the module docstring): ``params`` (a llama
    tree of ``cfg``) written as a two-shard fp16 HF checkpoint under a
    temporary directory, beside a T5 checkpoint of ``t5_cfg``
    (google/t5-v1_1-base's width by default; seeded weights, one fp16
    file), each loaded through ``models.factory.engine_factory`` (bf16,
    then 8-bit dynamic) and swept over ``questions`` by
    ``run_model_comparison_sweep``. Returns its stats, launches summed
    over both sweeps."""
    t5_cfg = t5_cfg or registry.t5_v1_1("base")
    tmp_root = Path(tempfile.gettempdir())
    free = shutil.disk_usage(tmp_root).free
    if free < LOADER_MIN_FREE_BYTES:
        raise AssertionError(
            f"loader phase: {free} bytes free under {tmp_root}; the fp16 "
            f"checkpoint and its parameter-cache entry need at least "
            f"{LOADER_MIN_FREE_BYTES:.0f}")
    tokenizer = FakeTokenizer(vocab=cfg.vocab_size)
    log("loader: tokenizer=FakeTokenizer passed to engine_factory explicitly "
        "(no transformers needed)")
    stats = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        ckpt = root / LOADER_BASE.replace("/", "__")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        files = export_hf_llama(params, cfg, ckpt)
        write_s = time.perf_counter() - t0
        nbytes_ckpt = sum(f.stat().st_size for f in files)
        (root / LOADER_CHAT.replace("/", "__")).symlink_to(
            ckpt, target_is_directory=True)
        stats["write"] = dict(seconds=write_s, bytes=nbytes_ckpt,
                              gb_per_s=nbytes_ckpt / write_s / 1e9,
                              shards=[f.name for f in files])

        rt = RuntimeConfig(batch_size=BATCH)
        factory = engine_factory(root, rt, tokenizer=tokenizer, device=DEV)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        with RssSampler() as rss:
            t0 = time.perf_counter()
            engine = factory(LOADER_BASE)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
        stats["load"] = dict(
            seconds=load_s, gb_per_s=nbytes_ckpt / load_s / 1e9,
            host_rss=rss.summary(),
            device_bytes_added=torch.cuda.memory_allocated() - mem0,
            max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
        check_loaded_tree(engine.params, params, ckpt / "config.json", cfg)
        log(json.dumps({"phase": "loader_write_and_load", **stats}))
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        stats["param_cache"] = param_cache_loads(root, rt, tokenizer)

        # The T5 pair: t5-v1_1-base and a flan-t5-base symlink to it.
        t5p = t5_params(t5_cfg, seed=3, device=DEV, dtype=torch.bfloat16)
        t5_dir = root / LOADER_T5.replace("/", "__")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t5_file = export_hf_t5(t5p, t5_cfg, t5_dir)
        t5_write = time.perf_counter() - t0
        (root / LOADER_FLAN.replace("/", "__")).symlink_to(
            t5_dir, target_is_directory=True)
        t0 = time.perf_counter()
        engine = factory(LOADER_T5)
        torch.cuda.synchronize()
        t5_load = time.perf_counter() - t0
        if not engine.encoder_decoder:
            raise AssertionError("loader t5: not an encoder-decoder engine")
        check_loaded_t5(engine.params, t5p, t5_dir / "config.json", t5_cfg)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        stats["t5"] = dict(bytes=t5_file.stat().st_size, write_seconds=t5_write,
                           load_seconds=t5_load)
        log(json.dumps({"phase": "loader_t5_write_and_load", **stats["t5"]}))

        specs = [ModelSpec(LOADER_BASE, "base"),
                 ModelSpec(LOADER_CHAT, "instruct"),
                 ModelSpec(LOADER_T5, "base"),
                 ModelSpec(LOADER_FLAN, "instruct"),
                 ModelSpec(LOADER_ABSENT, "instruct")]
        art, stats["bf16_sweep"] = run_comparison(
            "loader_bf16_comparison", factory, specs, root / "bf16", questions,
            ("flash_decode", "row_gemm", "row_norm", "row_add_norm"))
        n = len(questions)
        _check_model_rows("loader_bf16_comparison", art, specs, questions,
                          5 * n, 3 * n)
        d1_path = root / "bf16" / "model_comparison_results.csv"
        d2_path = root / "bf16" / "instruct_model_comparison_results.csv"
        d1 = schemas.read_results(d1_path)
        d2 = schemas.read_results(d2_path)
        if len(d1) != 5 * n or len(d2) != 3 * n:
            raise AssertionError(f"loader: D1/D2 on disk {len(d1)} / {len(d2)}")
        stats["analyze"] = analyze_loader_artifacts(root / "bf16", d1_path,
                                                    d2_path)
        log(json.dumps({"phase": "loader_analyze", **stats["analyze"]}))
        stats["survey"] = survey_loader_artifacts(root / "bf16", d1_path,
                                                  d2_path, questions)

        factory8 = engine_factory(root, rt, quantize_int8=True,
                                  int8_dynamic=True, tokenizer=tokenizer,
                                  device=DEV)

        def checked_factory8(name):
            eng = factory8(name)
            t0 = time.perf_counter()
            if name == LOADER_T5:
                check_int8_tree(eng.params, t5p, quant.ENCDEC_MATRICES)
            else:
                check_int8_tree(eng.params, params)
            stats[f"int8_check_seconds/{name}"] = time.perf_counter() - t0
            return eng

        specs8 = [specs[0], specs[2]]
        art8, stats["int8_sweep"] = run_comparison(
            "loader_int8_comparison", checked_factory8, specs8,
            root / "int8", questions,
            ("flash_decode", "row_norm", "row_add_norm"))
        _check_model_rows("loader_int8_comparison", art8, specs8, questions,
                          2 * n, 0)
        # The fleet phase's parts (a) and (b), on these checkpoints.
        llama_bytes = quant.param_bytes(params)
        stats["fleet"] = {"sweeps": fleet_sweeps(
            root, factory, specs, art, questions, llama_bytes)}
        stats["fleet"]["staging"] = fleet_staging(
            factory, questions, llama_bytes, quant.param_bytes(t5p))
        del t5p
    stats["launches"] = {k: stats["bf16_sweep"]["launches"][k]
                         + stats["int8_sweep"]["launches"][k]
                         + sum(stats["fleet"]["sweeps"][m]["launches"][k]
                               for m in ("prefetch", "no_prefetch"))
                         for k in ops.KERNELS}
    # D1 rows/s of the scoring alone (the sweep's ThroughputMeter: its
    # rows over the seconds inside run_word_meaning_sweep, loads apart).
    rows_per_s = {kind: stats[f"{kind}_sweep"]["throughput"]["prompts"]
                  / stats[f"{kind}_sweep"]["throughput"]["elapsed_s"]
                  for kind in ("bf16", "int8")}
    log(json.dumps({"phase": "loader_summary", "rows_per_s": rows_per_s,
                    "max_memory_allocated_bytes": {
                        kind: stats[f"{kind}_sweep"]["max_memory_allocated_bytes"]
                        for kind in ("bf16", "int8")},
                    "int8_check_seconds": {
                        k.split("/", 1)[1]: v for k, v in stats.items()
                        if k.startswith("int8_check_seconds/")}}))
    stats["rows_per_s"] = rows_per_s
    return stats


def param_cache_loads(root: Path, rt, tokenizer) -> dict:
    """The loader's llama-2-7b checkpoint through the converted-parameter
    cache (``engine_factory(cache_root=)``, the CLI's ``--param-cache``):
    once cold (converted and written) and once warm, the converter
    replaced by one that raises (nothing converted); the warm tree
    bitwise the cold one, leaf by leaf (dtype included). Seconds of each
    and the entry's bytes (the warm read comes from the page cache the
    cold write left: warm)."""
    factory = engine_factory(root, rt, tokenizer=tokenizer, device=DEV,
                             cache_root=root / "param_cache")
    convert = loader.convert_decoder
    seconds, trees = {}, {}
    for run in ("cold", "warm"):
        if run == "warm":
            loader.convert_decoder = _refuse_conversion
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng = factory(LOADER_BASE)
            torch.cuda.synchronize()
            seconds[run] = time.perf_counter() - t0
        finally:
            loader.convert_decoder = convert
        trees[run] = eng.params
        del eng
    cold, warm = dict(leaves(trees["cold"])), dict(leaves(trees["warm"]))
    differ = [k for k in cold if k not in warm
              or cold[k].dtype != warm[k].dtype
              or not torch.equal(cold[k], warm[k])]
    if differ or cold.keys() != warm.keys():
        raise AssertionError(f"param cache: warm leaves differ: {differ[:5]}")
    entry = root / "param_cache"
    stats = dict(cold_seconds=seconds["cold"], warm_seconds=seconds["warm"],
                 entry_bytes=sum(f.stat().st_size for f in entry.rglob("*")
                                 if f.is_file()),
                 leaves=len(cold), bitwise=True)
    del trees, cold, warm
    shutil.rmtree(entry)
    gc.collect()
    torch.cuda.empty_cache()
    log(json.dumps({"phase": "loader_param_cache", **stats}))
    return stats


def _refuse_conversion(*a, **kw):
    raise AssertionError("a warm --param-cache load converted the checkpoint")


# ---------------------------------------------------------------------------
# The fleet phase (engine/fleet.py, models/weights.py, engine/hbm.py):
# (a) and (b) inside the loader phase, on its checkpoints; (c) and (d)
# on phase 3's llama-2-7b engine.
# ---------------------------------------------------------------------------

# Part (a)'s weight-cache budget: 1.25 x llama-2-7b's bf16 bytes, one 7B
# model resident at a time.
FLEET_BUDGET_FACTOR = 1.25
FLEET_DRAFT_LAYERS = 4
FLEET_KERNELS = ("flash_decode", "row_gemm", "row_norm", "row_add_norm")
# Engagements of any governor's ladder since the last governor_check:
# filled by watch_governors' wrapper, emptied by each check.
GOVERNOR_ENGAGED: list = []


def watch_governors() -> None:
    """Record every rung any engine's governor engages (the ledger's
    route changes: no_piggyback, no_spec), so that governor_check can
    fail a phase whose routes it asserts."""
    engage = hbm.HbmGovernor._engage_locked

    def recorded(self, reason):
        GOVERNOR_ENGAGED.append((hbm.RUNGS[self._level]
                                 if self._level < len(hbm.RUNGS) else None,
                                 reason))
        return engage(self, reason)

    hbm.HbmGovernor._engage_locked = recorded


def governor_check(after: str, engine) -> dict:
    """Print phase 3's engine's ledger and level after a phase; fail if
    any governor engaged a rung during it (every phase before the
    squeeze asserts the routes it takes)."""
    gov = engine.governor
    row = {"phase": "governor", "after": after, "level": gov.level,
           "pressure": gov.pressure(), "budget_bytes": gov.budget_bytes,
           "ledger": gov.ledger(), "engaged_since_last": list(GOVERNOR_ENGAGED)}
    log(json.dumps(row))
    if GOVERNOR_ENGAGED or gov.level:
        raise AssertionError(f"{after}: the memory governor engaged "
                             f"{GOVERNOR_ENGAGED} (level {gov.level}) in a "
                             "phase that asserts its routes")
    return row


def _same_records(label, got, ref) -> None:
    """D1 records bitwise: text fields equal, floats equal (NaN = NaN)."""
    if len(got) != len(ref):
        raise AssertionError(f"{label}: {len(got)} rows, {len(ref)} expected")
    for a, b in zip(got, ref):
        for key, x in b.items():
            y = a[key]
            same = (x == y or (isinstance(x, float) and isinstance(y, float)
                               and math.isnan(x) and math.isnan(y)))
            if not same:
                raise AssertionError(f"{label}: {b['model']} {key} {y!r} != "
                                     f"{x!r} (the reference's)")


def standalone_sweep(root: Path, factory, specs, questions) -> tuple:
    """The reference with no fleet: each model built inline by the
    factory on the compute stream (no worker, no copy stream), scored by
    ``run_word_meaning_sweep`` and released before the next, as the
    sweep loop before the fleet did; the absent model's NaN rows. Its D1
    records, and the seconds and rows/s of the scoring alone (loads
    apart, as the sweep's ThroughputMeter counts them)."""
    rows, scored, score_s = [], 0, 0.0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for spec in specs:
        if spec.name == LOADER_ABSENT:
            rows.extend(nan_rows_for_model(spec, questions))
            continue
        engine = factory(spec.name)
        t1 = time.perf_counter()
        got = sweep.run_word_meaning_sweep(
            engine, spec.name, spec.base_or_instruct, questions,
            format_for(spec))
        score_s += time.perf_counter() - t1
        scored += len(got)
        rows.extend(got)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    stats = dict(seconds=time.perf_counter() - t0, scoring_seconds=score_s,
                 rows_per_s=scored / score_s,
                 max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    recs = schemas.write_model_comparison_csv(
        rows, root / "standalone_model_comparison_results.csv")
    log(json.dumps({"phase": "fleet_standalone_reference", **stats}))
    return recs, stats


def fleet_sweeps(root: Path, factory, specs, ref_art, questions,
                 model_bytes: int) -> dict:
    """Part (a): ``run_model_comparison_sweep`` through a ``ModelFleet``
    over the loader phase's five specs, the weight cache holding one 7B
    model (1.25 x its bytes), prefetch on and then off; the D1 rows
    bitwise a reference with no fleet (``standalone_sweep``), which is
    bitwise the loader phase's. FleetStats, seconds, rows/s of the
    scoring, peak memory and launches of each."""
    ref_recs, ref_stats = standalone_sweep(root, factory, specs, questions)
    _same_records("fleet_standalone_reference", ref_recs,
                  ref_art["model_comparison_csv"])
    out = {"standalone": ref_stats}
    for mode, prefetch in (("prefetch", True), ("no_prefetch", False)):
        fl = ModelFleet.from_factory(
            factory, [], prefetch=prefetch, stage_reloads=False,
            cache_budget_bytes=int(FLEET_BUDGET_FACTOR * model_bytes))
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        art = run_model_comparison_sweep(specs, factory, root / f"fleet_{mode}",
                                         questions=questions, fleet=fl)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        fl.shutdown()
        fl.drop_all()
        del fl
        gc.collect()
        torch.cuda.empty_cache()
        label = f"fleet_sweep_{mode}"
        _same_records(label, art["model_comparison_csv"], ref_recs)
        missing = [k for k in FLEET_KERNELS if launches[k] <= 0]
        if missing:
            raise AssertionError(f"{label}: kernels never launched: {missing}")
        st = art["fleet"]
        if st["loads"] != 4 or (prefetch and st["prefetch_hits"] != 3) or (
                not prefetch and st["swap_s_hidden"] != 0.0):
            raise AssertionError(f"{label}: fleet counters {st}")
        if st["evictions"] < 1:
            raise AssertionError(f"{label}: the budget evicted nothing {st}")
        tp = art["throughput"]
        out[mode] = dict(seconds=dt, fleet=st, launches=launches,
                         rows_per_s=tp["prompts"] / tp["elapsed_s"],
                         max_memory_allocated_bytes=peak,
                         memory_allocated_before=mem0,
                         memory_allocated_after=torch.cuda.memory_allocated(),
                         rows_bitwise_standalone=True)
        log(json.dumps({"phase": label, **out[mode]}))
    return out


def fleet_staging(factory, questions, model_bytes: int,
                  t5_bytes: int) -> dict:
    """Part (b): a fleet with pinned host staging under a budget that
    holds llama-2-7b alone: acquire llama (a checkpoint load, staged),
    score a word-meaning batch, acquire T5 (llama evicted), acquire llama
    again (streamed from pinned memory on the copy stream). Every
    re-streamed leaf bitwise its staged original, the batch bitwise the
    first one; the load's GB/s."""
    fl = ModelFleet.from_factory(factory, [LOADER_BASE, LOADER_T5],
                                 prefetch=False, stage_reloads=True,
                                 cache_budget_bytes=model_bytes + t5_bytes // 2)
    prompts = [format_base_prompt(q) for q in questions[:BATCH]]
    try:
        t0 = time.perf_counter()
        eng = fl.acquire(LOADER_BASE)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        staged = fl.staged(LOADER_BASE)
        pinned = all(t.is_pinned() for t in weights.tensors(staged))
        first = eng.score_prompts(prompts)
        fl.release(LOADER_BASE)
        eng5 = fl.acquire(LOADER_T5)
        fl.release(LOADER_T5)
        if fl.resident(LOADER_BASE) or not eng5.encoder_decoder:
            raise AssertionError("fleet staging: llama not evicted for T5")
        load0 = fl.stats.load_s
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng = fl.acquire(LOADER_BASE)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        load_s = fl.stats.load_s - load0
        streamed = weights.tree_bytes(staged)
        bad = [i for i, (d, h) in enumerate(zip(
            weights.tensors(eng.params), weights.tensors(staged)))
            if not torch.equal(d, h.to(d.device, non_blocking=True))]
        if bad or pinned != torch.cuda.is_available():
            raise AssertionError(f"fleet staging: leaves {bad} differ from "
                                 f"the staged tree (pinned {pinned})")
        again = eng.score_prompts(prompts)
        fl.release(LOADER_BASE)
        if again != first:
            raise AssertionError("fleet staging: the batch after the reload "
                                 "differs from the first")
        stats = dict(cold_load_s=cold_s, restream_load_s=load_s,
                     restream_wall_s=wall_s, bytes=streamed,
                     gb_per_s=streamed / load_s / 1e9, pinned=pinned,
                     leaves=len(weights.tensors(staged)), bitwise=True,
                     batch_bitwise=True, fleet=fl.stats.summary())
    finally:
        fl.shutdown()
        if fl.resident(LOADER_BASE) or fl.resident(LOADER_T5):
            fl.drop_all()
        del fl
        gc.collect()
        torch.cuda.empty_cache()
    log(json.dumps({"phase": "fleet_staging", **stats}))
    return stats


def fleet_drafts(engine, cells, rt) -> dict:
    """Part (c): on phase 3's llama-2-7b engine, over the flat cells, a
    fleet draft model armed through ``ModelFleet.acquire_spec_draft``: a
    seeded draft at llama-2-7b's widths and 4 layers, then the
    verifier's own weights (a perfect drafter). Both bitwise the
    sequential route; the perfect drafter accepts every draft."""
    seq_out, seq = run_dispatch(
        "fleet_draft_sequential", engine_with(engine, spec_decode=False),
        cells, rt, ("flash_decode",), ("dense_shared_dispatches",))
    dcfg = dataclasses.replace(engine.cfg, n_layers=FLEET_DRAFT_LAYERS,
                               name=f"llama-2-7b-{FLEET_DRAFT_LAYERS}l")
    dparams = decoder.init_params(dcfg, seed=7, device=DEV,
                                  dtype=torch.bfloat16)
    ver = engine_with(engine)
    fl = ModelFleet.from_engines(
        [("verifier", ver),
         ("draft", ScoringEngine(dparams, dcfg, engine.tokenizer,
                                 RuntimeConfig(batch_size=BATCH), device=DEV)),
         ("self", engine_with(engine))], stage_reloads=False)
    out = {"sequential": seq}
    try:
        for drafter in ("draft", "self"):
            ver.rt = dataclasses.replace(ver.rt, spec_draft_model=drafter)
            v = fl.acquire("verifier")
            did = fl.acquire_spec_draft(v, "verifier")
            try:
                if did != drafter:
                    raise AssertionError(f"fleet draft {drafter}: not armed")
                label = f"fleet_draft_{drafter}"
                outs, st = run_dispatch(
                    label, v, cells, rt,
                    ("flash_decode", "flash_decode_mq", "row_gemm",
                     "row_add_norm"), ("spec_dispatches",))
            finally:
                fl.release_spec_draft(v, did)
                fl.release("verifier")
            st["vs_sequential"] = compare_routes(label, outs, seq_out)
            sp = st["spec_stats"]
            if sp.get("draft_fleet", 0) <= 0 or sp.get("draft_ngram", 0):
                raise AssertionError(f"{label}: drafts {sp}")
            if drafter == "self" and sp["accepted_fleet"] != sp["draft_fleet"]:
                raise AssertionError(f"{label}: the perfect drafter accepted "
                                     f"{sp['accepted_fleet']} of "
                                     f"{sp['draft_fleet']}")
            out[drafter] = st
    finally:
        fl.shutdown()
        fl.drop_all()
        del fl, ver, dparams
        gc.collect()
        torch.cuda.empty_cache()
    return out


def squeeze_walk(engine, cells, rt) -> dict:
    """Part (d): a squeeze of phase 3's engine's governor. Each dispatch
    over the flat cells ticks it once, and ``sustain_ticks - 1`` more
    ticks follow it, so each level of the walk takes one dispatch: the
    rungs engage in the JAX package's order down to ``shed`` and release
    back to none; every dispatch's rows are bitwise the first
    (speculative) one's, taking the sequential route (one fallback)
    under ``no_spec``, and a piggyback chain is refused under
    ``no_piggyback``; after the release the speculative route and the
    chain are back."""
    gov = engine.governor
    sustain = gov.cfg.sustain_ticks
    call = _dispatch_call(engine, cells, rt)
    plan = plan_shared(engine, cells, rt)
    t = engine.tokenizer
    bins = [t(b).input_ids for b, _, _ in cells]
    confs = [t(c).input_ids for _, c, _ in cells]

    def piggy_refused() -> bool:
        try:
            engine.decode_fused_shared_piggy(
                bins, confs, rt.sweep_decode_tokens, rt.sweep_confidence_tokens,
                False, plan["bucket"], (8, 8))
        except PiggybackIneligible as err:
            if "memory governor" not in str(err):
                raise
            return True
        engine.piggy_abort()
        return False

    ref = call()
    engine.spec_flush()
    n_rungs = len(hbm.RUNGS)
    gov.squeeze(0.01, calls=sustain * n_rungs + 2)
    walk, rows = [[]], []
    t0 = time.perf_counter()
    while True:
        level = gov.level
        refused = piggy_refused() if level > hbm.RUNGS.index(
            "no_piggyback") else None
        before = dict(engine.spec_stats)
        outs = call()
        engine.spec_flush()
        route = ("sequential" if engine.spec_stats["fallbacks"]
                 > before.get("fallbacks", 0) else "speculative")
        if route != ("sequential" if level > hbm.RUNGS.index("no_spec")
                     else "speculative"):
            raise AssertionError(f"squeeze: level {level} took the {route} "
                                 "route")
        if refused is False:
            raise AssertionError(f"squeeze: level {level} opened a chain")
        compare_outs(f"squeeze_level{level}", outs, ref, "speculative")
        rows.append(dict(level=level, route=route, piggy_refused=refused))
        for _ in range(sustain - 1):
            gov.tick()
        engaged = gov.engaged_rungs()
        if not walk or walk[-1] != engaged:
            walk.append(engaged)
        if not engaged and len(walk) > 1:
            break
        if len(rows) > 4 * n_rungs + 4:
            raise AssertionError(f"squeeze: the ladder did not come back "
                                 f"({walk})")
    dt = time.perf_counter() - t0
    expect = ([list(hbm.RUNGS[:i]) for i in range(n_rungs + 1)]
              + [list(hbm.RUNGS[:i]) for i in range(n_rungs - 1, -1, -1)])
    if walk != expect:
        raise AssertionError(f"squeeze: ladder walked {walk}, not {expect}")
    summary = gov.summary()
    if (summary["rung_downs"] != {r: 1 for r in hbm.RUNGS}
            or summary["rung_ups"] != {r: 1 for r in hbm.RUNGS}):
        raise AssertionError(f"squeeze: counters {summary}")
    if piggy_refused() or not engine._piggyback_fits(len(cells), 1024):
        raise AssertionError("squeeze: piggyback chains not restored")
    stats = dict(dispatches=len(rows), seconds=dt, walk=walk, rows=rows,
                 governor=summary, routes_restored=True,
                 rows_bitwise=True)
    log(json.dumps({"phase": "fleet_squeeze", **stats}))
    GOVERNOR_ENGAGED.clear()
    return stats


# ---------------------------------------------------------------------------
# The stats phase: the finalize, the fit and the axis-2 statistics on the
# card against the same on the CPU.
# ---------------------------------------------------------------------------

STATS_SEED = 20261017


def seeded_lattice(P: int, R: int, seed: int) -> streaming.HostAccum:
    """A full (P, R) lattice as a sweep leaves it: every slot filled,
    relative probabilities from Beta draws, weighted confidences in
    [0, 100], 2 % of the slots invalid (NaN, decision -1)."""
    rng = np.random.default_rng(seed)
    acc = streaming.empty_accum(P, R, seed)
    acc.filled[:] = 1
    yes = rng.beta(2.0, 1.5, (P, R)).astype(np.float32)
    no = (rng.beta(1.5, 2.0, (P, R)) * (1 - yes)).astype(np.float32)
    ok = rng.random((P, R)) >= 0.02
    rel = yes / (yes + no)
    acc.rel[ok] = rel[ok]
    acc.dec[ok] = (yes > no)[ok]
    acc.conf[ok] = rng.uniform(0, 100, (P, R)).astype(np.float32)[ok]
    return acc


def timed(fn, device):
    """(result, seconds) of ``fn()`` after one warm call, ending in a
    synchronize on the card."""
    fn()
    if device == DEV:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if device == DEV:
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def near(a, b, tol) -> bool:
    return (math.isnan(a) and math.isnan(b)) or abs(a - b) <= tol * max(
        1.0, abs(b))


def run_stream_stats_phase() -> dict:
    """The statistics on the card against the CPU, with the time of each:

    - ``summarize(n_boot=1000)`` of a seeded (5, 2,000) lattice: the
      resample indices of every (prompt, field) identical on both devices
      (drawn on the CPU from ``generator_for(seed, prompt, salt)``),
      counts and kappa equal, CIs and standard errors within 1e-6
      relative to max(1, |value|) (float32 means of the same terms
      reduced in another order);
    - ``truncated_normal_mc_fit`` on prompt 0's relative probabilities at
      n_simulations = 100,000: the same iterations, mu and sigma within
      1e-5 (the loop's float32 means of 100,000 values in another order);
    - ``bootstrap_correlation_matrix`` (Pearson and Spearman) and
      ``aggregate_kappa`` on a seeded 50 x 18 matrix at n_boot = 1,000:
      CIs within 1e-5 (Pearson's cross-product form cancels, amplifying
      the float32 rounding of the reorder) and 1e-6."""
    acc = seeded_lattice(STREAM_P, STREAM_R, STATS_SEED)
    for p in range(STREAM_P):
        for salt in (0, streaming._CONF_SALT):
            a = resample_indices(generator_for(acc.seed, p, salt),
                                 STATS_N_BOOT, STREAM_R, DEV).cpu()
            b = resample_indices(generator_for(acc.seed, p, salt),
                                 STATS_N_BOOT, STREAM_R, "cpu")
            if not torch.equal(a, b):
                raise AssertionError("stats: resample indices differ")
    out = {}
    res = {}
    for dev in (DEV, "cpu"):
        res[dev], out[f"summarize_s_{dev}"] = timed(
            lambda: streaming.summarize(acc, STATS_N_BOOT, device=dev), dev)
    card, host = res[DEV], res["cpu"]
    if card["kappa"] != host["kappa"]:
        raise AssertionError("stats: kappa differs card vs CPU")
    for pc, ph in zip(card["per_prompt"], host["per_prompt"]):
        for field in ("relative_prob", "weighted_confidence"):
            for k in ("ci_lower", "ci_upper", "standard_error", "mean"):
                if not near(pc[field][k], ph[field][k], 1e-6):
                    raise AssertionError(f"stats: {field}.{k} card "
                                         f"{pc[field][k]} CPU {ph[field][k]}")
    out["kappa"] = card["kappa"]["kappa"]
    out["prompt0_relative_prob_ci"] = [card["per_prompt"][0]["relative_prob"]
                                       [k] for k in ("ci_lower", "ci_upper")]

    vals = streaming.prompt_values(acc, "rel", 0)
    fits = {}
    for dev in (DEV, "cpu"):
        (fits[dev], _), out[f"fit_s_{dev}"] = timed(
            lambda: truncated_normal_mc_fit(
                vals, generator_for(STATS_SEED, 0, 1), FIT_N_SIM,
                device=dev), dev)
    fc, fh = fits[DEV], fits["cpu"]
    if fc["Iterations"] != fh["Iterations"] or not all(
            near(fc[k], fh[k], 1e-5) for k in ("Underlying Normal Mean",
                                               "Underlying Normal Std Dev")):
        raise AssertionError(f"stats: fit differs card vs CPU: {fc} / {fh}")
    out["fit"] = {k: fc[k] for k in ("Iterations", "Underlying Normal Mean",
                                     "Underlying Normal Std Dev",
                                     "KS p-value")}

    rng = np.random.default_rng(STATS_SEED)
    base = rng.uniform(0, 1, AXIS2[0])
    pivot = base[:, None] * rng.uniform(0.5, 1.0, AXIS2[1]) + rng.normal(
        0, 0.2, AXIS2)
    pivot[rng.random(AXIS2) < 0.05] = np.nan
    binary = (np.nan_to_num(pivot, nan=0.0) > 0.5).astype(float)
    for method in ("pearson", "spearman"):
        mats = {}
        for dev in (DEV, "cpu"):
            g = lambda: generator_for(STATS_SEED, 2)  # noqa: E731
            mats[dev], out[f"corr_{method}_s_{dev}"] = timed(
                lambda: bootstrap_correlation_matrix(
                    pivot, g(), method, STATS_N_BOOT, device=dev), dev)
        for k in ("mean_ci", "median_ci", "std_ci"):
            if not all(near(x, y, 1e-5) for x, y in zip(mats[DEV][k],
                                                        mats["cpu"][k])):
                raise AssertionError(f"stats: {method} {k} card "
                                     f"{mats[DEV][k]} CPU {mats['cpu'][k]}")
        out[f"corr_{method}_mean_ci"] = list(mats[DEV]["mean_ci"])
    kap = {}
    for dev in (DEV, "cpu"):
        kap[dev], out[f"aggregate_kappa_s_{dev}"] = timed(
            lambda: aggregate_kappa(binary, generator_for(STATS_SEED, 3),
                                    STATS_N_BOOT, device=dev), dev)
    if not all(near(kap[DEV][k], kap["cpu"][k], 1e-6) for k in kap["cpu"]):
        raise AssertionError(f"stats: aggregate kappa differs {kap}")
    out["aggregate_kappa"] = [kap[DEV][k] for k in (
        "aggregate_kappa", "kappa_ci_lower", "kappa_ci_upper")]
    log(json.dumps({"phase": "stream_stats", **out}))
    return out


# ---------------------------------------------------------------------------
# The analysis phase: the analyze path (perturbation, base-vs-instruct,
# model graph, combined kappa) on the card against the CPU, against the
# executed reference's outputs, and at the paper's scale through the CLI.
# ---------------------------------------------------------------------------

GOLDEN_PATH = (Path(__file__).resolve().parent / "tests" / "golden"
               / "reference_executed.json")
ANALYSIS_SEED = 20261018
# The paper's scale: five legal prompts x 2,000 rephrasings (D6), 50
# questions x 18 models (D2), the same questions over 9 base/instruct
# families (D1).
PAPER_REPHRASINGS = 2000
PAPER_MODEL = "meta-llama/Llama-2-7b-chat-hf"
PAPER_FAMILIES = ("llama", "falcon", "mpt", "qwen", "gemma", "baichuan",
                  "internlm", "yi", "olmo")
# Card against CPU from the same draws: the fits' and the bootstraps'
# float32 reductions run in another order.
FIT_TOL = 1e-5
# The goodness-of-fit statistics of the fits' samples: a simulated value
# that the reorder moves past an observed one shifts an empirical CDF by
# 1/n; the adequacy flags are compared where the p-values sit farther
# than this from the 0.05 threshold.
GOF_TOL = 1e-3
GOF_FLAGS = {"Model Adequate (KS p>0.05)": ("KS p-value",),
             "Model Adequate (AD p>0.05)": ("AD p-value",),
             "Model Adequate (Combined)": ("KS p-value", "AD p-value")}
GOF_COLUMNS = ("KS Statistic", "KS p-value", "AD Statistic", "AD p-value")
ANALYSIS_DRIVERS = (
    ("perturbation", analysis_perturbation, "analyze_all_models"),
    ("base_vs_instruct", analysis_bvi, "run_base_vs_instruct_analysis"),
    ("model_graph", analysis_graph, "run_model_graph_analysis"),
    ("kappa", analysis_kappa, "run_kappa_analysis"),
)


def _same_cell(a, b, tol) -> bool:
    if table_mod.is_missing(a) or table_mod.is_missing(b):
        return table_mod.is_missing(a) and table_mod.is_missing(b)
    if isinstance(a, (bool, np.bool_, str)) or isinstance(b, (bool, np.bool_,
                                                              str)):
        return a == b
    return near(float(a), float(b), tol)


def compare_artifacts(label: str, card_dir: Path, cpu_dir: Path) -> int:
    """The card's analyze artifacts against the CPU's: the same files; the
    ``.tex`` files identical; each CSV the same header and rows, text and
    flags equal, numbers within FIT_TOL of max(1, |x|) (GOF_COLUMNS
    within GOF_TOL, and their flags only where the p-values sit farther
    than GOF_TOL from 0.05). Returns the number of files compared."""
    def files(root):
        return sorted(p.relative_to(root) for p in root.rglob("*")
                      if p.is_file())
    names = files(cpu_dir)
    if files(card_dir) != names or not names:
        raise AssertionError(f"{label}: files differ card {files(card_dir)} "
                             f"CPU {names}")
    for rel in names:
        a, b = card_dir / rel, cpu_dir / rel
        if rel.suffix == ".tex":
            if a.read_bytes() != b.read_bytes():
                raise AssertionError(f"{label}: {rel} differs card vs CPU")
            continue
        ta, tb = table_mod.read_table(a), table_mod.read_table(b)
        if ta.columns != tb.columns or len(ta) != len(tb):
            raise AssertionError(f"{label}: {rel} shape differs")
        p_values = {c: tb[c] for c in ("KS p-value", "AD p-value")
                    if c in tb}
        for col in tb.columns:
            tol = GOF_TOL if col in GOF_COLUMNS else FIT_TOL
            for i, (x, y) in enumerate(zip(ta[col], tb[col])):
                if col in GOF_FLAGS and any(
                        abs(float(p_values[p][i]) - 0.05) <= GOF_TOL
                        for p in GOF_FLAGS[col] if p in p_values):
                    continue
                if not _same_cell(x, y, tol):
                    raise AssertionError(f"{label}: {rel} {col}[{i}] card "
                                         f"{x} CPU {y}")
    return len(names)


def _golden_close(a, b, rel=0.0, abs_tol=0.0) -> bool:
    a, b = float(a), float(b)
    if math.isnan(a) or math.isnan(b):
        return math.isnan(a) and math.isnan(b)
    return abs(a - b) <= max(abs_tol, rel * abs(b))


def check_golden(label: str, result: dict, golden: dict) -> None:
    """One model's analyze_model tables against the executed reference's
    (``tests/golden/reference_executed.json``): text, flags and counts
    exact, floats to rel 1e-6 (abs 1e-9); the truncated-normal fit's
    rows matched by (Prompt, Column), its deterministic columns to 1e-6
    (inflation shares to 1e-12), its Monte Carlo columns (the reference
    ran its own draws) within rel 0.05 or 0.05 of the column's scale, KS
    within 0.08."""
    stems = {"summary": "summary_statistics",
             "normality": "normality_test_results",
             "kappa": "cohens_kappa_results",
             "compliance": "output_compliance_results",
             "confidence_compliance": "confidence_compliance_results"}
    for key, stem in stems.items():
        ours = result[key]
        for col, want in golden[stem].items():
            got = list(ours[col])
            ok = len(got) == len(want) and all(
                (g == w) if isinstance(w, (bool, str, int))
                else _golden_close(g, w, 1e-6, 1e-9)
                for g, w in zip(got, want))
            if not ok:
                raise AssertionError(f"{label}: {stem}.{col} {got} vs the "
                                     f"executed reference {want}")
    ref = golden["truncated_normal_test_results"]
    ours = result["truncated"]
    rows = {(p, c): i for i, (p, c) in enumerate(zip(ours["Prompt"],
                                                     ours["Column"]))}
    if len(rows) != len(ref["Prompt"]):
        raise AssertionError(f"{label}: truncated fit rows")
    for j, key in enumerate(zip(ref["Prompt"], ref["Column"])):
        i = rows[key]
        scale = 100.0 if float(ref["Observed Mean"][j]) > 1.5 else 1.0
        checks = [(c, 1e-6, 1e-9 * scale) for c in (
            "Observed Mean", "Observed Std Dev", "Interior Mean",
            "Interior Std Dev")]
        checks += [(c, 0.0, 1e-12) for c in ("Zero Proportion",
                                             "One Proportion")]
        checks += [(c, 0.05, 0.05 * scale) for c in (
            "Underlying Normal Mean", "Underlying Normal Std Dev",
            "Simulated Mean", "Simulated Std Dev")]
        checks += [("KS Statistic", 0.0, 0.08)]
        for col, rel, abs_tol in checks:
            if not _golden_close(ours[col][i], ref[col][j], rel, abs_tol):
                raise AssertionError(
                    f"{label}: truncated {key} {col} {ours[col][i]} vs the "
                    f"executed reference {ref[col][j]}")


def paper_scale_inputs(root: Path, seed: int = ANALYSIS_SEED):
    """Seeded artifacts at the paper's scale, written by the port's own
    writers: a D6 of the five legal prompts x PAPER_REPHRASINGS rows (a
    sweep's local top-20 id map as the log-probabilities, clipped
    relative probabilities with exact 0/1 mass, integer confidences), a
    D1 of the 50 questions over PAPER_FAMILIES' base and instruct models
    and the D2 of the same 18 models. Returns (d6, d1, d2, per-prompt
    relative probabilities as written)."""
    rng = np.random.default_rng(seed)
    rows, rel_by_prompt = [], []
    for p in LEGAL_PROMPTS:
        n = PAPER_REPHRASINGS
        rel = np.clip(rng.normal(rng.uniform(0.25, 0.75), 0.25, n), 0, 1)
        total = rng.uniform(0.5, 0.99, n)
        conf = np.clip(rng.normal(65.0, 20.0, n), 0, 100)
        ids = rng.integers(0, 32000, (n, STREAM_K))
        lps = -np.sort(rng.exponential(3.0, (n, STREAM_K)), axis=1)
        t1, t2 = rel * total, (1 - rel) * total
        rel_by_prompt.append(t1 / (t1 + t2))
        for i in range(n):
            main = f"[rephrasing {i}] {p.main}"
            c = int(round(conf[i]))
            rows.append(schemas.PerturbationRow(
                model=PAPER_MODEL, original_main=p.main,
                response_format=p.response_format,
                confidence_format=p.confidence_format, rephrased_main=main,
                full_rephrased_prompt=p.rephrased_binary(main),
                full_confidence_prompt=p.rephrased_confidence(main),
                model_response=p.target_tokens[0 if rel[i] > 0.5 else 1],
                model_confidence_response=str(c),
                log_probabilities=json.dumps(
                    {str(int(t)): float(v) for t, v in zip(ids[i], lps[i])}),
                token_1_prob=float(t1[i]), token_2_prob=float(t2[i]),
                confidence_value=float(c), weighted_confidence=float(conf[i])))
    d6 = root / "paper_d6.csv"
    schemas.write_perturbation_results(rows, d6, append=False)
    lean = rng.uniform(0.05, 0.95, len(WORD_MEANING_QUESTIONS))
    scores = []
    for fam in PAPER_FAMILIES:
        for kind, name in (("base", f"org-{fam}/{fam}-7b"),
                           ("instruct", f"org-{fam}/{fam}-7b-instruct")):
            rel = np.clip(lean + rng.normal(0, 0.2, lean.size), 0.01, 0.99)
            total = rng.uniform(0.2, 0.9, lean.size)
            for q, r, t in zip(WORD_MEANING_QUESTIONS, rel, total):
                scores.append(schemas.ScoreRow(
                    q, name, kind, "Yes" if r > 0.5 else "No",
                    float(r * t), float((1 - r) * t)))
    d1, d2 = root / "paper_d1.csv", root / "paper_d2.csv"
    schemas.write_model_comparison_csv(scores, d1)
    schemas.write_instruct_comparison_csv(scores, d2)
    return d6, d1, d2, rel_by_prompt


def timed_cli(command, argv, device, blocks) -> dict:
    """``python -m lir_tpu_torch <command>`` (``cli.main``) with the
    seconds of each (name, module, function) of ``blocks`` it calls
    (summed over its calls, each ending in a synchronize on the card) and
    of the whole command."""
    seconds = {}
    saved = []
    for name, module, attr in blocks:
        fn = getattr(module, attr)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            t0 = time.perf_counter()
            out = _fn(*a, **kw)
            if device == DEV:
                torch.cuda.synchronize()
            seconds[_name] = seconds.get(_name, 0.0) + (time.perf_counter()
                                                        - t0)
            return out
        setattr(module, attr, wrapped)
        saved.append((module, attr, fn))
    try:
        t0 = time.perf_counter()
        port_cli.main([command, *argv, "--device", device])
        seconds["command"] = time.perf_counter() - t0
    finally:
        for module, attr, fn in saved:
            setattr(module, attr, fn)
    return seconds


def check_paper_outputs(out: Path, rel_by_prompt) -> None:
    """What the paper-scale inputs fix: each prompt's summary mean is the
    mean of its written relative probabilities; every local-format row is
    first-token compliant and every integer confidence compliant; 9
    families, an 18 x 18 correlation matrix, finite CIs, a Baichuan
    anchor, and the combined kappa of at least one matched title."""
    pert = out / "perturbation" / analysis_perturbation.model_dir_name(
        PAPER_MODEL)
    summary = table_mod.read_table(pert / "summary_statistics.csv")
    for k, (p, want) in enumerate(zip(LEGAL_PROMPTS, rel_by_prompt)):
        got = summary[f'Mean Relative Probability of "{p.target_tokens[0]}"'][k]
        if not near(float(got), float(np.mean(want)), 1e-12):
            raise AssertionError(f"analysis: summary mean {got} vs "
                                 f"{np.mean(want)}")
    comp = table_mod.read_table(pert / "output_compliance_results.csv")
    conf = table_mod.read_table(pert / "confidence_compliance_results.csv")
    if (list(comp["First_Token_Compliant"]) != [PAPER_REPHRASINGS] * 5
            or list(conf["Confidence_Compliant"]) != [PAPER_REPHRASINGS] * 5):
        raise AssertionError("analysis: paper-scale compliance counts")
    fams = table_mod.read_table(out / "base_vs_instruct"
                                / "model_rel_prob_statistics.csv")
    if sorted(fams["Model_Family"]) != sorted(PAPER_FAMILIES) or not np.all(
            np.isfinite(fams["Correlation"])):
        raise AssertionError(f"analysis: families {list(fams['Model_Family'])}")
    corr = table_mod.read_table(out / "model_graph"
                                / "model_spearman_correlation_matrix.csv")
    agg = table_mod.read_table(out / "model_graph"
                               / "aggregate_kappa_results.csv")
    if (len(corr) != 18 or len(corr.columns) != 19 or not np.all(np.isfinite(
            np.stack([corr[c] for c in corr.columns[1:]])))
            or not np.isfinite(agg["kappa_ci_lower"][0])):
        raise AssertionError("analysis: model graph outputs")
    combined = table_mod.read_table(out / "kappa"
                                    / "combined_kappa_results.csv")
    if len(combined) < 1 or not np.all(np.isfinite(combined["Combined Mean Kappa"])):
        raise AssertionError("analysis: no combined kappa")


def run_analysis_phase() -> dict:
    """The analysis phase (see the module docstring). Returns its line."""
    golden = json.loads(GOLDEN_PATH.read_text())["analyze_perturbation_results"]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        d6 = synthetic.write_synthetic_d6(root / "synthetic_d6.csv")
        res = {}
        for dev in (DEV, "cpu"):
            t0 = time.perf_counter()
            res[dev] = analysis_perturbation.analyze_all_models(
                d6, root / f"synthetic_{dev}", make_figures=False, device=dev)
            if dev == DEV:
                torch.cuda.synchronize()
            out[f"synthetic_seconds_{dev}"] = time.perf_counter() - t0
        out["synthetic_files"] = compare_artifacts(
            "analysis/synthetic", root / f"synthetic_{DEV}",
            root / "synthetic_cpu")
        for dev, by_model in res.items():
            for model, section in golden.items():
                check_golden(f"analysis/synthetic/{dev}/{model}",
                             by_model[model], section)

        d6p, d1, d2, rel_by_prompt = paper_scale_inputs(root)
        argv = ["--perturbation-results", str(d6p), "--base-csv", str(d1),
                "--instruct-csv", str(d2), "--no-figures",
                "--n-simulations", str(FIT_N_SIM)]
        out["paper_d6_bytes"] = d6p.stat().st_size
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out[f"paper_seconds_{DEV}"] = timed_cli(
            "analyze", argv + ["--out", str(root / "paper_card")], DEV,
            ANALYSIS_DRIVERS)
        # The command's own peak: phase 3's llama-2-7b tree stays resident.
        out["paper_peak_bytes_above_resident"] = \
            torch.cuda.max_memory_allocated() - resident
        out["resident_bytes"] = resident
        out["paper_seconds_cpu"] = timed_cli(
            "analyze", argv + ["--out", str(root / "paper_cpu")], "cpu",
            ANALYSIS_DRIVERS)
        out["paper_files"] = compare_artifacts(
            "analysis/paper", root / "paper_card", root / "paper_cpu")
        check_paper_outputs(root / "paper_card", rel_by_prompt)
    log(json.dumps({"phase": "analysis", **out}))
    return out


def analyze_loader_artifacts(root: Path, d1: Path, d2: Path) -> dict:
    """The loader phase's own D1/D2 through ``analyze``: the base-vs-
    instruct deltas of the llama family (base and chat, 50 questions;
    the T5 pair's families, ``t5`` and ``flan``, hold one model each and
    are skipped); the D2, which holds the model with no checkpoint as NaN
    rows, stops the model graph with KeyError on that model, as the JAX
    package does (ROADMAP caveat R5); without those rows it runs to its
    end, over the llama chat model and flan-t5-base."""
    t0 = time.perf_counter()
    port_cli.main(["analyze", "--base-csv", str(d1), "--no-figures",
                   "--out", str(root / "analysis"), "--device", DEV])
    stats = table_mod.read_table(root / "analysis" / "base_vs_instruct"
                                 / "model_rel_prob_statistics.csv")
    if list(stats["Model_Family"]) != ["llama"] or not (
            0 < stats["Num_Samples"][0] <= len(WORD_MEANING_QUESTIONS)):
        raise AssertionError(f"loader analyze: {stats.columns} "
                             f"{list(stats['Model_Family'])}")
    try:
        port_cli.main(["analyze", "--instruct-csv", str(d2), "--no-figures",
                       "--out", str(root / "analysis"), "--device", DEV])
    except KeyError as exc:
        if exc.args != (LOADER_ABSENT,):
            raise
    else:
        raise AssertionError("loader analyze: the D2 with an error model's "
                             "NaN rows did not stop the model graph (R5)")
    d2_table = table_mod.read_table(d2)
    ok_rows = d2_table.take(d2_table["model"] != LOADER_ABSENT)
    ok_rows.to_csv(root / "d2_ok.csv")
    port_cli.main(["analyze", "--instruct-csv", str(root / "d2_ok.csv"),
                   "--no-figures", "--out", str(root / "analysis_ok"),
                   "--device", DEV])
    kappa = table_mod.read_table(root / "analysis_ok" / "model_graph"
                                 / "model_pairwise_kappa_matrix.csv")
    columns = list(kappa.columns)
    if columns[:1] != [""] or sorted(columns[1:]) != sorted([LOADER_CHAT,
                                                             LOADER_FLAN]):
        raise AssertionError(f"loader analyze: {kappa.columns}")
    return {"seconds": time.perf_counter() - t0,
            "llama_pairs": int(stats["Num_Samples"][0]),
            "llama_correlation": float(stats["Correlation"][0])}


# ---------------------------------------------------------------------------
# The survey phase: the human-survey pipeline (axis 3) through ``repro`` on
# the card against the CPU, the loader phase's swept D1/D2 through it, and
# the streaming accumulator's entry point on the sweep phase's lattices.
# ---------------------------------------------------------------------------

# Card against CPU from the same draws, as the analysis phase.
SURVEY_TOL = FIT_TOL
# A p-value counted over draws (the permutation test's |diff| >= |observed|)
# may move by one count where a float32 mean lands within an ulp of the
# observed difference: two counts of the 10,000 are allowed.
SURVEY_COUNT_TOL = 2e-4
# The printed report carries three decimals (four for p-values): a number
# may move by one unit of the last printed place.
REPORT_TOL = 1e-3
# Nine families at the paper's scale: the three whose names the family
# differences and the matched pairs look up, and six of PAPER_FAMILIES.
SURVEY_FAMILIES = tuple(synthetic.SURVEY_FAMILY_MODELS[:3]) + tuple(
    (f"org-{f}/{f}-7b", f"org-{f}/{f}-7b-instruct")
    for f in PAPER_FAMILIES if f != "falcon")[:6]
SURVEY_BLOCKS = (
    ("load", survey_loader, "load_survey"),
    ("exclusions", survey_loader, "apply_exclusions"),
    ("consolidated", survey_consolidated, "run_consolidated_analysis"),
    ("agreement_points", survey_human_llm, "analyze_all_models"),
    ("agreement_bootstrap", survey_human_llm, "bootstrap_all_models"),
    ("d9_payload", survey_human_llm, "bootstrap_results_payload"),
    ("family_differences", survey_family, "analyze_family_differences"),
    ("simulated", survey_simulated, "run_simulated_bootstrap"),
    ("pvalues", survey_pvalues, "run_pvalue_analysis"),
    ("proportions", survey_proportions, "run_proportion_analysis"),
    ("survey_pipeline", survey_run, "run_survey_pipeline"),
    ("base_vs_instruct", analysis_bvi, "run_base_vs_instruct_analysis"),
    ("model_graph", analysis_graph, "run_model_graph_analysis"),
)


def _survey_diffs(a, b, path, out, scale=1.0):
    """The differences of the card's JSON ``a`` from the CPU's ``b``: keys
    and their order, lengths, text, flags and integers exact; floats
    within SURVEY_TOL of max(scale, |b|), where ``scale`` is, under a
    comparison of two groups, the larger of their means (a difference of
    two float32 reductions carries their magnitude's rounding; a relative
    change that rounding over the base mean); counted p-values within
    SURVEY_COUNT_TOL."""
    if isinstance(b, dict):
        if not isinstance(a, dict) or list(a) != list(b):
            out.append((path, "keys"))
            return
        means = [b[k] for k in ("base_mean", "instruct_mean")
                 if isinstance(b.get(k), float) and math.isfinite(b[k])]
        if len(means) == 2:
            scale = max(scale, *map(abs, means))
        for k in b:
            sc = (scale * 100.0 / abs(b["base_mean"])
                  if k == "relative_change_pct" and len(means) == 2
                  and b["base_mean"] else scale)
            _survey_diffs(a[k], b[k], f"{path}.{k}", out, sc)
    elif isinstance(b, list):
        if not isinstance(a, list) or len(a) != len(b):
            out.append((path, "length"))
            return
        for i, (x, y) in enumerate(zip(a, b)):
            _survey_diffs(x, y, f"{path}[{i}]", out, scale)
    elif isinstance(b, float) and isinstance(a, float):
        tol = SURVEY_TOL * max(scale, abs(b))
        if path.endswith("p_value") and (".overall_comparison." in path
                                         or ".mc_difference." in path):
            tol = max(tol, SURVEY_COUNT_TOL)
        if not ((math.isnan(a) and math.isnan(b)) or abs(a - b) <= tol):
            out.append((path, a, b))
    elif a != b or type(a) is not type(b):
        out.append((path, a, b))


def _same_report(a: str, b: str) -> bool:
    """The consolidated report's text identical with its numbers taken
    out, the numbers within REPORT_TOL."""
    num = re.compile(r"-?\d+\.\d+")
    if num.sub("#", a) != num.sub("#", b):
        return False
    return all(abs(float(x) - float(y)) <= REPORT_TOL + 1e-12
               for x, y in zip(num.findall(a), num.findall(b)))


def compare_survey_artifacts(label: str, card_dir: Path, cpu_dir: Path) -> int:
    """The card's survey artifacts against the CPU's: the same files, each
    JSON as ``_survey_diffs`` says, the report as ``_same_report`` says.
    Returns the number of files compared."""
    names = sorted(p.name for p in cpu_dir.iterdir())
    if sorted(p.name for p in card_dir.iterdir()) != names or not names:
        raise AssertionError(f"{label}: files differ")
    for name in names:
        a, b = (card_dir / name).read_text(), (cpu_dir / name).read_text()
        if name.endswith(".json"):
            out = []
            _survey_diffs(json.loads(a), json.loads(b), name, out)
            if out:
                raise AssertionError(f"{label}: {out[:5]}")
        elif not _same_report(a, b):
            raise AssertionError(f"{label}: {name} differs card vs CPU")
    return len(names)


def check_survey_outputs(out: Path) -> dict:
    """What the paper-scale survey inputs fix: the fixture's exclusion
    counts (two short, two identical, one failed attention, two NaN
    durations in no count; 500 of 507 kept), 50 matched questions of 51
    LLM prompts, the three named families present with finite
    differences, every model's bootstraps at their full budgets, the
    simulated bootstrap's three named family comparisons; returns the
    headline numbers."""
    cons = json.loads((out / "consolidated_analysis_results.json").read_text())
    ex, match = cons["exclusion_stats"], cons["matching_stats"]
    if ((ex["duration_excluded"], ex["identical_excluded"],
         ex["attention_failed"], ex["final_count"], ex["total_excluded"])
            != (2, 2, 1, 500, 7)
            or (match["n_matched"], match["n_llm_prompts"]) != (50, 51)):
        raise AssertionError(f"survey: exclusions {ex} matching "
                             f"{match['n_matched']}/{match['n_llm_prompts']}")
    d9 = json.loads((out / "llm_human_agreement_bootstrap.json").read_text())
    fam = json.loads((out / "family_differences.json").read_text())
    sim = json.loads((out / "bootstrap_confidence_intervals.json").read_text())
    n_models = 2 * len(SURVEY_FAMILIES) + len(SURVEY_FAMILIES) + len(
        synthetic.SURVEY_EXTRA_INSTRUCT)
    if (len(d9["model_results"]) != n_models
            or any(r["n_bootstrap"] != 1000 for r in d9["model_results"])
            or set(d9["overall_comparison"]["metrics"]) != {"mae", "mse",
                                                            "mape"}):
        raise AssertionError(f"survey: D9 {len(d9['model_results'])} models")
    if (sorted(fam) != ["Falcon", "RedPajama", "StableLM"] or not all(
            math.isfinite(m["mc_difference"]["difference_mean"])
            for f in fam.values() for m in f.values())):
        raise AssertionError(f"survey: family differences {fam}")
    if (sim["n_bootstrap"] != 10_000
            or sorted(r["family"] for r in sim["family_comparisons"])
            != ["falcon", "redpajama", "stablelm"]):
        raise AssertionError(f"survey: simulated bootstrap {sim['n_bootstrap']}")
    hc = cons["human_llm_correlation"]
    return dict(human_llm_correlation=hc["correlation"],
                human_llm_ci=[hc["ci_lower"], hc["ci_upper"]],
                human_cross_prompt=cons["cross_prompt_correlations"]["human"][
                    "mean_correlation"],
                llm_cross_prompt=cons["cross_prompt_correlations"]["llm"][
                    "mean_correlation"],
                simulated_difference=sim["overall_results"]["difference"])


def run_survey_phase() -> dict:
    """The survey phase's part (a): ``python -m lir_tpu_torch repro
    --no-figures`` at the pipeline's default budgets on a data directory at
    the paper's scale (the seeded Qualtrics fixture at 507 respondents, a
    D1 of SURVEY_FAMILIES' 18 models and its D2 with two more instruct
    models), on the card and on the CPU: every artifact compared, the
    seconds of each block on each device, the card's peak memory above
    what is resident."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        data = root / "data"
        data.mkdir()
        synthetic.write_synthetic_survey(
            data / "word_meaning_survey_results.csv")
        synthetic.write_synthetic_comparison(
            data / "model_comparison_results.csv",
            data / "instruct_model_comparison_results.csv",
            error_model=False, families=SURVEY_FAMILIES)
        argv = ["--data", str(data), "--no-figures"]
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out[f"seconds_{DEV}"] = timed_cli(
            "repro", argv + ["--out", str(root / "card")], DEV, SURVEY_BLOCKS)
        out["peak_bytes_above_resident"] = \
            torch.cuda.max_memory_allocated() - resident
        out["resident_bytes"] = resident
        out["seconds_cpu"] = timed_cli(
            "repro", argv + ["--out", str(root / "cpu")], "cpu",
            SURVEY_BLOCKS)
        out["survey_files"] = compare_survey_artifacts(
            "survey/repro", root / "card" / "survey", root / "cpu" / "survey")
        out["analysis_files"] = sum(
            compare_artifacts(f"survey/repro/{sub}", root / "card" / sub,
                              root / "cpu" / sub)
            for sub in ("base_vs_instruct", "model_graph"))
        out["card"] = check_survey_outputs(root / "card" / "survey")
    return out


def survey_loader_artifacts(root: Path, d1: Path, d2: Path,
                            questions) -> dict:
    """The survey phase's part (b): the loader phase's swept D1/D2 (the
    llama base and chat models, the T5 pair, and the model with no
    checkpoint as NaN rows) through ``run_survey_pipeline`` on the card, with the seeded
    survey at 507 respondents, at the default budgets. The NaN rows are
    taken as the JAX package takes them (tests/test_torch_survey.py): no
    error; in the D1 their mass is NaN, so the agreement metrics see a
    constant 0.5 (a Pearson r of NaN), and the simulated bootstrap and
    the p-value pivot leave the model out."""
    survey_csv = synthetic.write_synthetic_survey(root / "survey.csv")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = survey_run.run_survey_pipeline(survey_csv, d2, d1, root / "survey",
                                         make_figures=False, device=DEV)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = len(questions)
    cons = res["consolidated"]
    hc = cons["human_llm_correlation"]
    if len(cons["matches"]) != n or (hc or {}).get("n_questions", n) != n:
        raise AssertionError(f"loader survey: {len(cons['matches'])} matched "
                             f"of {n}")
    points = sorted((r["model"], r["model_type"])
                    for r in res["agreement_points"])
    boot = {(r["model"], r["model_type"]): r
            for r in res["agreement_bootstrap"]["model_results"]}
    if n >= 10:
        want = sorted([(LOADER_ABSENT, "base"), (LOADER_BASE, "base"),
                       (LOADER_CHAT, "base"), (LOADER_CHAT, "instruct"),
                       (LOADER_T5, "base"), (LOADER_FLAN, "base"),
                       (LOADER_FLAN, "instruct")])
        if points != want or sorted(boot) != want or not math.isnan(
                boot[(LOADER_ABSENT, "base")]["pearson_r_mean"]):
            raise AssertionError(f"loader survey: models {points}")
    if LOADER_ABSENT in res["simulated_bootstrap"]["model_stats"] or any(
            LOADER_ABSENT in (r["model1"], r["model2"])
            for r in res["pvalues"]["llm_correlations"]):
        raise AssertionError("loader survey: the failed model was not left "
                             "out of the simulated bootstrap and the pivot")
    chat = [r for r in res["agreement_points"]
            if (r["model"], r["model_type"]) == (LOADER_CHAT, "instruct")]
    return dict(seconds=dt, n_matched=len(cons["matches"]),
                human_llm_correlation=hc["correlation"] if hc else None,
                models=points,
                chat_mae=chat[0]["mae"] if chat else None)


def accum_survey_estimates(label, acc, reload) -> dict:
    """The survey phase's part (c): ``llm_prompt_estimates_from_accum`` on
    a sweep's StreamSink snapshot (the lattice ``stream_fold`` wrote), on
    the card, against the same on the CPU replay of the D6 rows
    (``streaming.accum_from_rows``): the same prompts and counts, the
    estimates and CIs within FLOAT_TOL (float32 lattice values against
    the CSV's float64 recompute)."""
    t0 = time.perf_counter()
    card = survey_human_llm.llm_prompt_estimates_from_accum(acc, device=DEV)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    cpu = survey_human_llm.llm_prompt_estimates_from_accum(reload,
                                                           device="cpu")
    if list(card) != list(cpu) or not card:
        raise AssertionError(f"{label}: prompts {list(card)} vs {list(cpu)}")
    for p, want in cpu.items():
        got = card[p]
        if got["n"] != want["n"] or not all(
                near(got[k], want[k], streaming.FLOAT_TOL)
                for k in ("estimate", "ci_lower", "ci_upper",
                          "standard_error")):
            raise AssertionError(f"{label}: prompt {p} {got} vs {want}")
    return dict(prompts=len(card), seconds=dt,
                estimates=[card[p]["estimate"] for p in card])


# ---------------------------------------------------------------------------
# The sampling phase: sample_decode, the rephraser, the reasoning sweep
# ---------------------------------------------------------------------------

# A card-vs-CPU id flip is a near tie when the twin's scores of the two
# ids lie within this (the float32 small model's logits differ by ~1e-6
# between the devices).
SAMPLE_NEAR_TIE = 1e-3
SAMPLE_STEPS = 16
REPHRASE_SESSIONS = 8
REASONING_B = 8
REASONING_RUNS = 10


def recorded_sampling(fn):
    """(fn(), every step's sampler inputs on the CPU): ``ops.gumbel_argmax``
    wrapped for the call so that a flip can be measured afterwards."""
    record, kernel = [], ops.gumbel_argmax

    def rec(logits, keys, offsets, temperature):
        record.append((logits.float().cpu(), keys.cpu(), offsets.cpu(),
                       temperature))
        return kernel(logits, keys, offsets, temperature)

    ops.gumbel_argmax = rec
    try:
        return fn(), record
    finally:
        ops.gumbel_argmax = kernel


def compare_sampled(label, card, cpu, record) -> list:
    """Ids of the card against the CPU's, row by row up to the first
    difference (a flip changes everything after it). A flip is allowed at
    a near tie only: the twin's scores of the two ids, on the CPU's
    logits of that step, within SAMPLE_NEAR_TIE. Returns the flips."""
    flips = []
    for b in range(card.shape[0]):
        diff = np.flatnonzero(card[b] != cpu[b])
        if not diff.size:
            continue
        t = int(diff[0])
        logits, keys, offsets, temp = record[t]
        gap = twin_gaps(logits, keys, offsets, temp, [b], cpu[:, t],
                        card[:, t])[0]
        flips.append({"row": b, "step": t, "gap": gap})
        if not gap <= SAMPLE_NEAR_TIE:
            raise AssertionError(f"{label}: row {b} step {t} sampled "
                                 f"{card[b, t]} on the card, {cpu[b, t]} on "
                                 f"the CPU, twin gap {gap}")
    return flips


def sample_card_vs_cpu(cfg, params_cpu, params_gpu) -> dict:
    """(a) sample_decode on the small float32 model, on the card against
    the CPU (the same keys): both key modes with the EOS stop armed, ids
    equal save flips at near ties. Then the EOS probe: identical prompts
    at temperature 1e-4, eos = the id the unstopped run emits at step 3,
    so every row is done by then; the stopped ids equal the CPU's and the
    unstopped ones up to EOS, EOS after, and the forwards end at the first
    all-done check (``flash_decode`` launches)."""
    gen = np.random.default_rng(31)
    toks = torch.as_tensor(gen.integers(3, cfg.vocab_size, (4, 24)),
                           dtype=torch.int32)
    mask = torch.ones_like(toks)
    toks[0, :6], mask[0, :6] = 0, 0
    eos = FakeTokenizer.PAD
    out = {}
    for mode, key in (("per_row", prng.split(prng.prng_key(5), 4)),
                      ("one_key", prng.prng_key(5))):
        ids = {}
        for dev, params in ((DEV, params_gpu), ("cpu", params_cpu)):
            ids[dev], rec = recorded_sampling(lambda: generate.sample_decode(
                params, cfg, toks.to(dev), mask.to(dev), key,
                temperature=0.9, max_new_tokens=SAMPLE_STEPS, eos_id=eos))
            ids[dev] = ids[dev].cpu().numpy()
        out[mode] = {"flips": compare_sampled(f"sample_decode {mode}",
                                              ids[DEV], ids["cpu"], rec)}
    same = toks[1:2].repeat(4, 1)
    ones = torch.ones_like(same)
    runs, launches = {}, {}

    def probe_run(name, eos_id):
        for dev, params in ((DEV, params_gpu), ("cpu", params_cpu)):
            torch.cuda.synchronize()
            ops.reset_launches()
            runs[name, dev] = generate.sample_decode(
                params, cfg, same.to(dev), ones.to(dev), prng.prng_key(6),
                temperature=1e-4, max_new_tokens=SAMPLE_STEPS,
                eos_id=eos_id).cpu().numpy()
            torch.cuda.synchronize()
            if dev == DEV:
                launches[name] = ops.launch_counts()

    probe_run("free", None)
    free = runs["free", DEV]
    if not (free == free[0]).all():
        raise AssertionError("EOS probe: identical prompts sampled different "
                             "ids at temperature 1e-4")
    probe = int(free[0, 3])
    probe_run("stop", probe)
    first = int(np.argmax(runs["free", DEV][0] == probe))
    check_at = first + (-(first + 1) % generate.DONE_CHECK_EVERY)
    per_forward = launches["free"]["flash_decode"] // SAMPLE_STEPS
    want = per_forward * min(check_at, SAMPLE_STEPS)
    stop = runs["stop", DEV]
    if not (np.array_equal(stop, runs["stop", "cpu"])
            and np.array_equal(stop[:, :first + 1],
                               runs["free", DEV][:, :first + 1])
            and (stop[:, first:] == probe).all()
            and np.array_equal(runs["free", DEV], runs["free", "cpu"])):
        raise AssertionError(f"EOS probe: stopped ids {stop[0].tolist()} "
                             f"against free {runs['free', DEV][0].tolist()}")
    if launches["stop"]["flash_decode"] != want or \
            launches["stop"]["gumbel_argmax"] != min(check_at + 1,
                                                     SAMPLE_STEPS):
        raise AssertionError(f"EOS probe: forwards did not stop: "
                             f"{launches['stop']} (want flash_decode {want})")
    out["eos_probe"] = {"eos": probe, "first_eos_step": first,
                        "flash_decode": {k: launches[k]["flash_decode"]
                                         for k in launches},
                        "gumbel_argmax": {k: launches[k]["gumbel_argmax"]
                                          for k in launches}}
    out["launches"] = {k: launches["free"][k] + launches["stop"][k]
                       for k in ops.KERNELS}
    log(json.dumps({"phase": "sampling_small", **{
        k: v for k, v in out.items() if k != "launches"}}))
    return out


def run_rephrase_full(engine) -> dict:
    """(b) The rephraser at llama-2-7b width: ``generate_rephrasings`` of
    the first legal prompt, 8 sessions (one batch of 8 rows x 512 sampled
    tokens) through ``rephraser_from_engine``; a batch that raised fails
    the phase (``generate_rephrasings`` itself skips it, as the reference
    does). Seconds, steps/s, tokens/s, peak memory, the launches, the
    parsed rephrasings."""
    gen_text = rephrase.rephraser_from_engine(engine)
    failures = []

    def guarded(fn):
        def call(*args):
            try:
                return fn(*args)
            except Exception as exc:
                failures.append(repr(exc))
                raise
        return call

    gen_text.dispatch = guarded(gen_text.dispatch)
    gen_text.fetch = guarded(gen_text.fetch)
    steps = 512
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = rephrase.generate_rephrasings(
        gen_text, LEGAL_PROMPTS[:1], prng.prng_key(42),
        sessions_per_prompt=REPHRASE_SESSIONS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = ops.launch_counts()
    if failures:
        raise AssertionError(f"rephrase: batches raised: {failures}")
    reph = out[0][1]
    want = {"gumbel_argmax": steps,
            "flash_decode": steps * engine.cfg.n_layers}
    # A batch whose every row emits EOS stops early: fewer launches, never
    # more, and never none.
    if not all(0 < launches[k] <= n for k, n in want.items()) or not reph:
        raise AssertionError(f"rephrase: launches {launches} (at most "
                             f"{want}), {len(reph)} rephrasings")
    # Where a sampling step's time goes: 16 steps of the same batch
    # profiled (device-busy share against the host clock).
    toks, mask = engine._pad_batch(
        [rephrase_request(LEGAL_PROMPTS[0].main)] * REPHRASE_SESSIONS)

    def call():
        generate.sample_decode(engine.params, engine.cfg, toks, mask,
                               prng.prng_key(7), temperature=0.9,
                               max_new_tokens=16, eos_id=engine.eos_id)
        torch.cuda.synchronize()

    prof = profile_batch.profile(call)
    stats = dict(sessions=REPHRASE_SESSIONS, new_tokens=steps, seconds=dt,
                 steps_per_s=launches["gumbel_argmax"] / dt,
                 tokens_per_s=REPHRASE_SESSIONS
                 * launches["gumbel_argmax"] / dt,
                 max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
                 launches=launches, expected_launches=want,
                 rephrasings=len(reph),
                 first_rephrasings=[r[:120] for r in reph[:3]],
                 profile_16_steps=prof)
    log(json.dumps({"phase": "rephrase", **stats}))
    return stats


def reasoning_grid():
    """16 cells: two legal prompts, each with seven rephrasings."""
    prompts = LEGAL_PROMPTS[:2]
    perts = [[f"{p.main} (Variant {i}: read it as a court would.)"
              for i in range(7)] for p in prompts]
    return prompts, perts


def run_reasoning_full(engine, tmp: Path) -> dict:
    """(c) The reasoning sweep at llama-2-7b width: 16 cells at B = 8,
    10 sampled runs of 50 tokens a binary prompt and one of 50 a
    confidence prompt. The D6 rows: count fractions (multiples of 1/10),
    no log-prob map, the weighted confidence the parsed integer. Then the
    first 8 cells marked done: the other 8, one bucket of the shape they
    had, must come back bitwise the whole run's rows."""
    eng = engine_with(engine, batch_size=REASONING_B)
    prompts, perts = reasoning_grid()
    n_cells = sum(1 + len(p) for p in perts)
    stats, rows = {}, {}
    for name in ("whole", "resumed"):
        manifest = None
        if name == "resumed":
            manifest = SweepManifest(tmp / "reasoning_resumed.manifest.jsonl",
                                     grid.RESUME_KEY_FIELDS)
            manifest.mark_done_many([
                {"model": SWEEP_MODEL, "original_main": r.original_main,
                 "rephrased_main": r.rephrased_main}
                for r in rows["whole"][:REASONING_B]])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        rows[name] = sweep.run_perturbation_sweep(
            eng, SWEEP_MODEL, prompts, perts, tmp / f"reasoning_{name}.csv",
            manifest=manifest, reasoning=True, reasoning_runs=REASONING_RUNS)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        stats[name] = dict(
            rows=len(rows[name]), seconds=dt,
            rows_per_s=len(rows[name]) / dt, launches=ops.launch_counts(),
            max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    if len(rows["whole"]) != n_cells or \
            rows["resumed"] != rows["whole"][REASONING_B:]:
        raise AssertionError("reasoning sweep: the resumed rows are not the "
                             "whole run's")
    for r in rows["whole"]:
        fracs = [r.token_1_prob * REASONING_RUNS,
                 r.token_2_prob * REASONING_RUNS]
        if (any(abs(x - round(x)) > 1e-9 for x in fracs)
                or r.log_probabilities != ""
                or r.weighted_confidence != (
                    None if r.confidence_value is None
                    else float(r.confidence_value))):
            raise AssertionError(f"reasoning sweep: bad row {r}")
    for name, st in stats.items():
        if st["launches"]["gumbel_argmax"] <= 0 or \
                st["launches"]["flash_decode"] <= 0:
            raise AssertionError(f"reasoning sweep {name}: {st['launches']}")
    stats["confidence_values"] = [r.confidence_value for r in rows["whole"]]
    log(json.dumps({"phase": "reasoning_sweep", **stats}))
    return stats


def run_sampling_phase(engine, small) -> dict:
    """The sampling phase: (a) card against CPU on the small model, (b)
    the rephraser and (c) the reasoning sweep on the resident bf16
    llama-2-7b. Returns the stats and the launches of every part."""
    stats = {"small": sample_card_vs_cpu(*small),
             "rephrase": run_rephrase_full(engine)}
    with tempfile.TemporaryDirectory() as tmp:
        stats["reasoning"] = run_reasoning_full(engine, Path(tmp))
    parts = [stats["small"]["launches"], stats["rephrase"]["launches"],
             stats["reasoning"]["whole"]["launches"],
             stats["reasoning"]["resumed"]["launches"]]
    stats["launches"] = {k: sum(p[k] for p in parts) for k in ops.KERNELS}
    return stats


# ---------------------------------------------------------------------------
# The guard phase and the serve phase (guard/, faults/, serve/): phase 3's
# llama-2-7b params on engines of their own.
# ---------------------------------------------------------------------------

# Watchdog knobs of the guard and serve engines: a floor low enough that
# an injected hang a few times the deadline fits the script's time.
GUARD_WATCHDOG = dict(watchdog_multiple=2.0, watchdog_floor_s=0.5)
GUARD_GRID = "flat"
GUARD_NAN_ROWS = (0, 1)
# A hang lasts this many times the largest deadline of its dispatches.
HANG_FACTOR = 3.0
# The real out-of-memory drill leaves this much of the card free.
OOM_MARGIN_BYTES = 1 << 30


class Ballast:
    """A buffer that fills the card up to ``margin`` bytes short of its
    free memory, and gives it back through a governor rung's action
    (``release``: True when it freed anything)."""

    def __init__(self):
        self.buf = None
        self.bytes = 0
        self.releases = 0

    def fill(self, margin: int) -> None:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        free, _ = torch.cuda.mem_get_info()
        self.bytes = max(int(free) - int(margin), 0)
        self.buf = torch.empty(self.bytes, dtype=torch.uint8, device=DEV)

    def release(self) -> bool:
        if self.buf is None:
            return False
        self.buf = None
        torch.cuda.empty_cache()
        self.releases += 1
        return True


def exhaust_card() -> None:
    """Ask the caching allocator for twice the card's memory: a real
    ``torch.cuda.OutOfMemoryError``."""
    total = torch.cuda.get_device_properties(0).total_memory
    torch.empty(2 * total, dtype=torch.uint8, device=DEV)


def fill_at(engine, at: int, fill) -> dict:
    """Wrap ``engine.decode_fused_shared`` so that ``fill()`` runs just
    before its call ``at`` (0-based, counting the calls that reach it);
    returns the call counter."""
    inner = engine.decode_fused_shared
    calls = {"n": 0}

    def wrapped(*a, **kw):
        k = calls["n"]
        calls["n"] += 1
        if k == at:
            fill()
        return inner(*a, **kw)

    engine.decode_fused_shared = wrapped
    return calls


def guard_engine(engine, **rt):
    """An engine on ``engine``'s params with the guard's watchdog, no
    piggyback chain (the wrapped engine refuses chains anyway, so the
    clean reference runs as the faulted run does) and a governor that
    walks one rung a tick."""
    return ScoringEngine(
        engine.params, engine.cfg, engine.tokenizer,
        dataclasses.replace(engine.rt, piggyback_prefill=False,
                            **{**GUARD_WATCHDOG, **rt}),
        cascade_config=engine.cascade_cfg, spec_config=engine.spec_cfg,
        device=DEV, governor_config=GovernorConfig(sustain_ticks=1))


def grid_costs(engine, prompts, perts, rt) -> list:
    """The watchdog's price of each planned shared dispatch of a grid
    (``sweep._run_pipelined``'s ``_shared_cost``)."""
    _, dispatches, _ = plan_sweep(engine, prompts, perts, rt)
    B = rt.batch_size
    return [sched_mod.bucket_cost(len(d.items), d.bucket, B,
                                  rt.sweep_decode_tokens
                                  + rt.sweep_confidence_tokens,
                                  fused_decode=rt.fused_decode,
                                  spec_decode=engine.spec_supported())
            for d in dispatches]


def run_guard_phase(engine, rt, grids, tmp: Path) -> dict:
    """The sweep's dispatch recovery at llama-2-7b width, bf16. Two clean
    sweeps of GUARD_GRID on a guard engine (the second the reference;
    both calibrate the watchdog), then the same grid on the same engine
    fault-wrapped,
    in order: a dispatch fault (dispatch 0), a hang of HANG_FACTOR times
    its deadline on the retry (stalled by the watchdog), a corrupt draft
    (dispatch 0's plan), a budget squeeze at the first governor tick,
    NaN in rows GUARD_NAN_ROWS of dispatch 1, and a real allocator OOM
    at dispatch 2: a ballast fills the card, the dispatch raises
    ``torch.cuda.OutOfMemoryError``, the governor's ``evict_weights``
    action releases the ballast and the one retry passes. Every D6 row
    is the clean run's, byte for byte, save the quarantined ones. Then a
    fresh guard engine whose first dispatch needs more than the card
    (an irreducible OOM): the sweep raises ``HbmExhausted``."""
    prompts, perts = grids[GUARD_GRID]
    eng = guard_engine(engine)
    ballast = Ballast()
    eng.governor.set_action("evict_weights", engage=ballast.release)
    # Two clean sweeps: the second is the reference; together they
    # calibrate the watchdog past its first sample, which carries the
    # seed headroom (12x on a speculating cascade engine).
    for k in range(2):
        clean_path = tmp / f"guard_clean{k}.csv"
        t0 = time.perf_counter()
        sweep.run_perturbation_sweep(eng, SWEEP_MODEL, prompts, perts,
                                     clean_path)
        torch.cuda.synchronize()
        clean_s = time.perf_counter() - t0
    wd = eng.watchdog
    # The hang hits the first dispatch's retry: a few times its deadline.
    hang_s = HANG_FACTOR * wd.deadline_for(
        grid_costs(eng, prompts, perts, eng.rt)[0])
    fault_plan = faults.FaultPlan(0, {
        "dispatch": faults.SiteSchedule(fail_calls=(0,)),
        "draft": faults.SiteSchedule.draft_corrupt_at(0, rows=(0, 2)),
        "hbm": faults.SiteSchedule.hbm_squeeze_at(0, frac=0.1, calls=2)})
    hang_plan = faults.FaultPlan(0, {"dispatch": faults.SiteSchedule.hang_at(
        0, seconds=hang_s)})
    nan_plan = faults.FaultPlan(0, {"dispatch": faults.SiteSchedule.nan_at(
        1, rows=GUARD_NAN_ROWS)})
    # Innermost first: the ballast before the engine's call 2, then the
    # NaN rows, the hang and the fault, each counting the calls that
    # reach it.
    fill_at(eng, 2, lambda: ballast.fill(OOM_MARGIN_BYTES))
    faults.wrap_engine(eng, nan_plan)
    faults.wrap_engine(eng, hang_plan)
    faults.wrap_engine(eng, fault_plan)
    faults.wrap_governor(eng.governor, fault_plan)
    path = tmp / "guard_faulted.csv"
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    sweep.run_perturbation_sweep(eng, SWEEP_MODEL, prompts, perts, path)
    torch.cuda.synchronize()
    faulted_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    ref, got = schemas.read_results(clean_path), schemas.read_results(path)
    if len(ref) != len(got):
        raise AssertionError(f"guard: {len(got)} rows, {len(ref)} clean")
    quarantined = [g for g in got
                   if g["Model Response"] == numerics.NUMERICS_ERROR]
    differing = [g for r, g in zip(ref, got) if r != g]
    if (len(quarantined) != len(GUARD_NAN_ROWS)
            or differing != quarantined):
        raise AssertionError(f"guard: {len(differing)} rows differ from the "
                             f"clean run's, {len(quarantined)} quarantined")
    gst, fst, mst = eng.guard_stats, eng.fault_stats, eng.governor.stats
    expect = {"stalls": {"sweep": 1}, "recovered": 1,
              "injected": ({"dispatch": 1, "draft": 1, "hbm": 1},
                           {"dispatch": 1}, {"dispatch": 1}),
              "oom_events": {"sweep": 1}, "oom_reclaims": 1,
              "ballast_releases": 1, "quarantined": {"sweep": 2}}
    seen = {"stalls": dict(gst.stalls),
            "recovered": fst.recovered_dispatches,
            "injected": tuple(p.stats.injected for p in
                              (fault_plan, hang_plan, nan_plan)),
            "oom_events": dict(mst.oom_events),
            "oom_reclaims": mst.oom_reclaims,
            "ballast_releases": ballast.releases,
            "quarantined": dict(gst.quarantined)}
    if seen != expect:
        raise AssertionError(f"guard counters {seen}, expected {expect}")
    if not mst.rung_downs.get("evict_weights") or mst.squeezes != 1:
        raise AssertionError(f"guard: the squeeze walked no rung "
                             f"({mst.summary()})")
    stall_deadline, fired = wd.last_stall
    missing = [k for k in SWEEP_ROUTE_KERNELS["bf16"][GUARD_GRID]
               if launches[k] <= 0]
    if missing:
        raise AssertionError(f"guard: never launched {missing}")
    for _ in hbm.RECLAIM_RUNGS:
        eng.governor.tick()          # the reclaim rungs release
    stats = dict(
        grid=GUARD_GRID, cells=len(got), clean_seconds=clean_s,
        faulted_seconds=faulted_s, rows_bitwise_but_quarantined=True,
        quarantined_rows=len(quarantined), hang_seconds=hang_s,
        watchdog=dict(deadline_s=stall_deadline, fired_after_s=fired,
                      multiple=wd.multiple, floor_s=wd.floor_s),
        ballast_bytes=ballast.bytes, guard=gst.summary(),
        faults=fst.summary(), governor=eng.governor.summary(),
        spec_stats=dict(eng.spec_stats), launches=launches)
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # The irreducible OOM: the dispatch first asks for twice the card.
    eng = guard_engine(engine)
    spare = Ballast()
    eng.governor.set_action("evict_weights", engage=spare.release)
    card_bytes = torch.cuda.get_device_properties(0).total_memory

    def impossible():
        spare.fill(card_bytes // 2)      # something the reclaim can free
        exhaust_card()

    fill_at(eng, 0, impossible)
    fill_at(eng, 1, impossible)
    try:
        sweep.run_perturbation_sweep(eng, SWEEP_MODEL, prompts, perts,
                                     tmp / "guard_exhausted.csv")
    except hbm.HbmExhausted as err:
        stats["exhausted"] = dict(message=str(err)[:400],
                                  oom_events=dict(eng.governor.stats.oom_events),
                                  oom_exhausted=eng.governor.stats.oom_exhausted)
    else:
        raise AssertionError("guard: an irreducible OOM did not raise "
                             "HbmExhausted")
    if stats["exhausted"]["oom_exhausted"] != 1 or spare.releases != 1:
        raise AssertionError(f"guard: {stats['exhausted']}")
    spare.release()
    del eng, spare
    gc.collect()
    torch.cuda.empty_cache()
    GOVERNOR_ENGAGED.clear()
    log(json.dumps({"phase": "guard", "card": card_line(), **stats}))
    return stats


SERVE_REQUESTS = 128
SERVE_RATE = 24.0                      # requests a second, Poisson
SERVE_SEED = 20261019
SERVE_CLASSES = (("interactive", 120.0), ("batch", 600.0))
SERVE_LINGER_S = 0.05
PAYLOAD_FIELDS = ("model_response", "model_confidence_response",
                  "token_1_prob", "token_2_prob", "log_probabilities",
                  "confidence_value", "weighted_confidence")


def serve_requests(grids) -> list:
    """SERVE_REQUESTS distinct requests over the flat and grouped grids'
    cells, each of a seeded class."""
    rng = np.random.default_rng(SERVE_SEED)
    cells, seen = [], set()
    for name in ("flat", "grouped"):
        for c in grid.build_grid(SWEEP_MODEL, *grids[name]):
            # The grids share their original cells: one request each.
            if (c.binary_prompt, c.confidence_prompt) not in seen:
                seen.add((c.binary_prompt, c.confidence_prompt))
                cells.append(c)
    out = []
    for i, c in enumerate(cells[:SERVE_REQUESTS]):
        out.append(ServeRequest(
            binary_prompt=c.binary_prompt,
            confidence_prompt=c.confidence_prompt,
            targets=tuple(LEGAL_PROMPTS[c.prompt_idx].target_tokens),
            klass=SERVE_CLASSES[int(rng.integers(0, 2))][0],
            request_id=str(i)))
    return out


def record_dispatches(server) -> list:
    """Wrap ``server.batcher.score`` to log each dispatch's (bucket,
    rows); returns the log."""
    log_ = []
    inner = server.batcher.score

    def score(bucket, rows):
        log_.append((bucket, list(rows)))
        return inner(bucket, rows)

    server.batcher.score = score
    return log_


def serve_config(**kw) -> ServeConfig:
    return ServeConfig(**{**dict(classes=SERVE_CLASSES,
                                 linger_s=SERVE_LINGER_S), **kw})


def poisson_run(server, requests) -> tuple:
    """Submit ``requests`` at seeded Poisson arrivals (SERVE_RATE a
    second) on a client thread, wait for every result. Returns (results
    by request id, seconds from the first submit to the last result)."""
    gaps = np.random.default_rng(SERVE_SEED + 1).exponential(
        1.0 / SERVE_RATE, len(requests))
    futs = {}

    def client():
        for gap, req in zip(gaps, requests):
            time.sleep(float(gap))
            futs[req.request_id] = server.submit(req)

    t0 = time.perf_counter()
    th = threading.Thread(target=client)
    th.start()
    th.join()
    out = {rid: f.result(timeout=600) for rid, f in futs.items()}
    return out, time.perf_counter() - t0


def latency_by_class(results, requests) -> dict:
    klass = {r.request_id: r.klass for r in requests}
    out = {}
    for name, _ in SERVE_CLASSES:
        lat = sorted(r.latency_s for rid, r in results.items()
                     if klass[rid] == name)
        if lat:
            out[name] = {"n": len(lat),
                         "p50_s": float(np.percentile(lat, 50)),
                         "p99_s": float(np.percentile(lat, 99))}
    return out


def direct_payloads(engine, dispatch_log,
                    use_prefix_cache: bool = False) -> dict:
    """The logged dispatches' rows dispatched again directly on
    ``engine``, with no server, batcher or watchdog thread: for each
    logged (bucket, rows), this script tokenizes the requests, pads to
    the full batch with the last row (``pad_full``), picks the suffix
    buckets, calls ``decode_fused_shared`` (prefix cache off, or on with
    ``use_prefix_cache``: the engine's own pool) at the logged bucket, records the drafts as a serving engine does, reads
    position 0 with ``score.readout_from_fused`` and maps the readouts
    to payload fields itself. Payloads by request id."""
    rt, B = engine.rt, engine.rt.batch_size
    new = min(rt.sweep_decode_tokens, rt.max_new_tokens)
    conf = min(rt.sweep_confidence_tokens, rt.max_new_tokens)
    early = rt.sweep_early_stop and not rt.sweep_full_completions
    out = {}
    for bucket, rows in dispatch_log:
        reqs = [p.request for p in rows]
        n = len(reqs)
        full = reqs + [reqs[-1]] * (B - n)
        ids_a = [list(engine.tokenizer(r.binary_prompt).input_ids)
                 for r in full]
        ids_b = [list(engine.tokenizer(r.confidence_prompt).input_ids)
                 for r in full]
        lcp = [tok.shared_prefix_len(a, b) for a, b in zip(ids_a, ids_b)]
        sfx = tuple(tok.pick_bucket(
            [max(max(len(x) - k for x, k in zip(ids, lcp)), 1)],
            sched_mod.SUFFIX_BUCKETS) for ids in (ids_a, ids_b))
        targets = [tok.target_token_ids(engine.tokenizer, tuple(r.targets))
                   for r in full]
        t1 = np.asarray([int(t[0]) for t in targets], np.int32)
        t2 = np.asarray([int(t[1]) for t in targets], np.int32)
        fused, cfused = engine.decode_fused_shared(
            [r.binary_prompt for r in full],
            [r.confidence_prompt for r in full], t1, t2, new_tokens=new,
            conf_tokens=conf, early_stop=early, pretokenized_a=ids_a,
            pretokenized_b=ids_b, bucket=bucket, sfx_buckets_ab=sfx,
            reuse_cache=True, use_prefix_cache=use_prefix_cache,
            n_real=n)
        res = score_mod.readout_from_fused(
            fused, engine._t(t1), engine._t(t2), scan_positions=1)
        yes, no, lp_v, lp_i, gen, wconf, cgen = (t.cpu().numpy() for t in (
            res.yes_prob, res.no_prob, fused.topk_logprobs, fused.topk_ids,
            fused.generated, cfused.weighted_confidence, cfused.generated))
        if engine.spec_supported():
            engine.spec_record(bucket, ids_a, gen, n)
            engine.spec_record(bucket, ids_b, cgen, n)
            engine.spec_flush()
        for j, r in enumerate(reqs):
            conf_text = engine.decode_completion(cgen[j])
            out[r.request_id] = dict(
                model_response=engine.decode_completion(gen[j]),
                model_confidence_response=conf_text,
                token_1_prob=float(yes[j]), token_2_prob=float(no[j]),
                log_probabilities=json.dumps({
                    int(i): round(float(v), 6)
                    for i, v in zip(lp_i[j], lp_v[j])}),
                confidence_value=sweep._parse_confidence(
                    conf_text, sweep._decode_complete(cgen[j],
                                                      engine.eos_id)),
                weighted_confidence=float(wconf[j]))
    return out


def check_payloads_bitwise(label, results: dict, ref: dict) -> int:
    n = 0
    for rid, r in results.items():
        if r.status != "ok":
            continue
        want = ref[rid]
        got = {f: getattr(r, f) for f in PAYLOAD_FIELDS}
        if got != {f: want[f] for f in PAYLOAD_FIELDS}:
            raise AssertionError(f"{label}: request {rid} {got} is not the "
                                 f"direct dispatch's {want}")
        n += 1
    return n


def as_d6(results: dict, requests) -> dict:
    """Serve results as D6-like records for ``compare_d6`` (keyed by
    request id; the values as the CSV writer writes them)."""
    by_id = {r.request_id: r for r in requests}
    out = {}
    for rid, r in results.items():
        req = by_id[rid]
        out[(rid, rid)] = {
            "Full Rephrased Prompt": req.binary_prompt,
            "Full Confidence Prompt": req.confidence_prompt,
            "Model Response": r.model_response,
            "Model Confidence Response": r.model_confidence_response,
            "Confidence Value": str(r.confidence_value),
            "Token_1_Prob": str(r.token_1_prob),
            "Token_2_Prob": str(r.token_2_prob),
            "Weighted Confidence": str(r.weighted_confidence),
            "Log Probabilities": r.log_probabilities}
    return out


def serve_drills(engine, requests, ref_engine, tmp: Path) -> dict:
    """On a server over ``engine`` (its watchdog calibrated by the phase's
    run), one request at a time: a dispatch fault (recovered by the
    retry), a hang of HANG_FACTOR times the deadline (stalled by the
    watchdog, then served), a poison row beside three (isolated by the
    degradation ladder), a device outage (the breaker opens after one
    failed dispatch, a submit sheds, and after the cooldown a probe
    closes it), then a shutdown checkpoint of eight unserved requests
    and their resume on a fresh server, bitwise the same rows dispatched
    directly on ``ref_engine``."""
    cfg = serve_config(prefix_cache=False, max_consecutive_failures=1,
                       breaker_cooldown_s=1.0, cache_entries=0,
                       retry=RetryConfig(max_retries=1, initial_delay=0.01,
                                         max_delay=0.02, full_jitter=True,
                                         max_elapsed=120.0))
    server = ScoringServer(engine, SWEEP_MODEL, cfg)
    down = {"on": False}
    inner = server.batcher.score

    def flaky(bucket, rows):
        if down["on"]:
            raise RuntimeError("device outage (drill)")
        if any(p.request.request_id == "poison" for p in rows):
            raise RuntimeError("poison row (drill)")
        return inner(bucket, rows)

    server.batcher.score = flaky
    wd = engine.watchdog
    by_bucket = {}
    for i, r in enumerate(requests):
        b = tok.assign_bucket(max(tok.shared_prefix_len(
            engine.tokenizer(r.binary_prompt).input_ids,
            engine.tokenizer(r.confidence_prompt).input_ids), 1),
            engine.buckets)
        by_bucket.setdefault(b, []).append(i)
    hang_s = HANG_FACTOR * max(wd.deadline_for(sched_mod.bucket_cost(
        1, b, engine.rt.batch_size, server.batcher.decode_cost,
        fused_decode=engine.rt.fused_decode)) for b in by_bucket)
    fault_plan = faults.FaultPlan(0, {"dispatch": faults.SiteSchedule(
        fail_calls=(0,))})
    hang_plan = faults.FaultPlan(0, {"dispatch": faults.SiteSchedule.hang_at(
        1, seconds=hang_s)})
    faults.wrap_server(server, hang_plan)
    faults.wrap_server(server, fault_plan)
    server.start()
    out = {}
    try:
        def one(i, rid=None):
            r = requests[i]
            return server.submit(dataclasses.replace(
                r, request_id=rid or f"drill{i}")).result(timeout=600)

        fault = one(0)
        hang = one(1)
        stalls = engine.guard_stats.stalls.get("serve", 0)
        # A poison copy of a request and three requests of its bucket,
        # submitted together: one dispatch.
        mates = next(ix for ix in by_bucket.values() if len(ix) >= 4)[:4]
        poison = [server.submit(dataclasses.replace(
            requests[i], request_id=f"drill{i}" if k else "poison"))
            for k, i in enumerate(mates)]
        poison = [f.result(timeout=600) for f in poison]
        down["on"] = True
        broken = one(6)
        # The rows resolve before the supervisor tells the breaker and
        # drains the queue: wait for the dispatch to end.
        t_open = time.perf_counter()
        while ((server.healthy or server._inflight)
               and time.perf_counter() - t_open < 60):
            time.sleep(0.005)
        opened = not server.healthy
        shed = one(7)
        down["on"] = False
        time.sleep(cfg.breaker_cooldown_s)
        probe = one(8)
        out.update(
            fault=fault.status, hang=hang.status, hang_seconds=hang_s,
            stalls=stalls, poison=[r.status for r in poison],
            outage=broken.status, opened=opened, shed=shed.status,
            probe=probe.status, healthy_after=server.healthy,
            transitions=[f"{a}->{b}" for a, b in server.faults.transitions],
            faults=server.faults.summary(),
            watchdog=dict(zip(("deadline_s", "fired_after_s"),
                              wd.last_stall or (None, None))))
    finally:
        server.stop()
    want = dict(fault="ok", hang="ok", poison=["error", "ok", "ok", "ok"],
                outage="error", opened=True, shed="shed", probe="ok",
                healthy_after=True)
    if ({k: out[k] for k in want} != want or out["stalls"] < 1
            or out["transitions"] != ["closed->open", "open->half_open",
                                      "half_open->closed"]
            or out["faults"]["degraded_rows"] != 1):
        raise AssertionError(f"serve drills: {out}")

    # Checkpoint -> resume.
    ckpt = tmp / "serve_state.json"
    first = ScoringServer(engine, SWEEP_MODEL, serve_config(
        prefix_cache=False, cache_entries=0))
    futs = [first.submit(dataclasses.replace(r, request_id=f"ck{i}"))
            for i, r in enumerate(requests[16:24])]
    if first.shutdown_checkpoint(ckpt) != 8 or any(f.done() for f in futs):
        raise AssertionError("serve: the checkpoint lost or served requests")
    fresh = ScoringServer(engine, SWEEP_MODEL, serve_config(
        prefix_cache=False, cache_entries=0))
    dlog = record_dispatches(fresh)
    fresh.start()
    try:
        resumed = [f.result(timeout=600)
                   for f in fresh.resume_from_checkpoint(ckpt)]
    finally:
        fresh.stop()
    if [r.status for r in resumed] != ["ok"] * 8:
        raise AssertionError(f"serve resume: {[r.status for r in resumed]}")
    out["resumed_bitwise"] = check_payloads_bitwise(
        "serve resume", {r.request_id: r for r in resumed},
        direct_payloads(ref_engine, dlog))
    return out


def run_serve_phase(engine, rt, grids, tmp: Path, bars) -> dict:
    """``ScoringServer`` at llama-2-7b width, bf16: SERVE_REQUESTS
    requests of two classes at seeded Poisson arrivals, (a) prefix cache
    off with ``pad_full``: every payload bitwise the same rows dispatched
    directly at the same padded batch on a standalone engine (no server,
    no watchdog thread); (b) the serving default, prefix cache on (its
    pool ``RuntimeConfig.prefix_cache_pages`` pages beside the model in
    the governor's ledger, under its budget): the payloads within
    ``bars`` (the prefix phase's: twice its half-batch control) of (a)'s.
    Per class p50/p99 latency, requests/s, dispatches, shed and expired,
    peak memory and (a)'s kernel launches. Then the drills
    (:func:`serve_drills`) on (a)'s engine."""
    requests = serve_requests(grids)
    out = {}
    eng_off = engine_with(engine, **GUARD_WATCHDOG)
    ref_engine = engine_with(engine, watchdog_multiple=0.0)
    for mode in ("off", "on"):
        eng = eng_off if mode == "off" else engine_with(engine)
        server = ScoringServer(eng, SWEEP_MODEL,
                               serve_config(prefix_cache=mode == "on"))
        dlog = record_dispatches(server)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        server.start()
        try:
            results, wall = poisson_run(server, requests)
        finally:
            server.stop()
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        st = server.stats.summary()
        if st["completed"] != len(requests) or st["shed"] or st["expired"]:
            raise AssertionError(f"serve {mode}: {st}")
        gov = eng.governor
        row = dict(requests=len(requests), seconds=wall,
                   requests_per_s=len(requests) / wall,
                   latency=latency_by_class(results, requests),
                   dispatches=st["dispatches"], shed=st["shed"],
                   expired=st["expired"],
                   slot_occupancy_pct=st["slot_occupancy_pct"],
                   max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
                   ledger=gov.ledger(), budget_bytes=gov.budget_bytes,
                   pressure=gov.pressure(), launches=launches,
                   spec_stats=dict(eng.spec_stats),
                   paged_dispatches=dict(eng.paged_dispatches),
                   guard=eng.guard_stats.summary())
        if mode == "off":
            missing = [k for k in ("flash_decode_mq", "row_gemm",
                                   "row_add_norm") if launches[k] <= 0]
            if missing:
                raise AssertionError(f"serve: never launched {missing}")
            row["bitwise_rows"] = check_payloads_bitwise(
                "serve", results, direct_payloads(ref_engine, dlog))
            off = results
            out["off_results"] = results
        else:
            budget = gov.budget_bytes
            if (budget is None or "kv_pages:" + eng.cfg.name not in
                    gov.ledger()
                    or row["max_memory_allocated_bytes"] > budget):
                raise AssertionError(f"serve: the default pool and batch "
                                     f"do not fit beside the model: {row}")
            row["vs_prefix_off"] = compare_d6(
                "serve prefix on", as_d6(off, requests),
                as_d6(results, requests), engine, bars)
            del eng
        out[mode] = row
        log(json.dumps({"phase": f"serve_{mode}", "card": card_line(),
                        **row}))
    out["drills"] = serve_drills(eng_off, requests, ref_engine, tmp)
    log(json.dumps({"phase": "serve_drills", **out["drills"]}))
    del eng_off, ref_engine
    gc.collect()
    torch.cuda.empty_cache()
    GOVERNOR_ENGAGED.clear()
    return out


TRANSFORMERS_STUB = '''"""A stand-in for the transformers package, which the card's machine
lacks: AutoTokenizer gives the port's FakeTokenizer at the checkpoint's
vocabulary (the model's weights are seeded, so any tokenizer scores
them)."""
import json
from pathlib import Path


class AutoTokenizer:
    @staticmethod
    def from_pretrained(path, **kw):
        from lir_tpu_torch.backends.fake import FakeTokenizer

        vocab = json.loads((Path(path) / "config.json").read_text())
        return FakeTokenizer(vocab=vocab["vocab_size"])
'''


def serve_cli_check(small, tmp: Path) -> dict:
    """``python -m lir_tpu_torch serve --requests`` once on the small
    model, written as a fp16 llama checkpoint: eight requests and a
    ``{"op": "stats"}`` line in, one JSON line each out, every request
    ok with its probabilities in [0, 1]. The card's machine has no
    transformers: a stub whose AutoTokenizer gives FakeTokenizer is put
    on the subprocess's path."""
    cfg, _, params = small
    root = tmp / "serve_cli"
    name = "smoke/tiny-llama"
    export_hf_llama(params, cfg, root / name.replace("/", "__"))
    stub = tmp / "serve_cli_stub" / "transformers"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text(TRANSFORMERS_STUB)
    reqs = tmp / "serve_cli_requests.jsonl"
    lines = [{"id": f"c{i}", "prompt": f"{LEGAL_PROMPTS[i % 5].main[:200]}",
              "class": "interactive"} for i in range(8)]
    lines.insert(4, {"op": "stats"})
    reqs.write_text("\n".join(json.dumps(x) for x in lines) + "\n")
    repo = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(stub.parent), str(repo)]))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "lir_tpu_torch", "serve", "--checkpoints",
         str(root), "--model", name, "--requests", str(reqs),
         "--batch-size", "8", "--linger-ms", "0"],
        cwd=repo, env=env, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"serve CLI exit {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    out = [json.loads(x) for x in proc.stdout.strip().splitlines()]
    stats_lines = [o for o in out if o.get("op") == "stats"]
    results = [o for o in out if "request_id" in o]
    if (len(stats_lines) != 1
            or [r["request_id"] for r in results] != [f"c{i}"
                                                       for i in range(8)]
            or any(r["status"] != "ok" or not 0.0 <= r["token_1_prob"] <= 1.0
                   for r in results)):
        raise AssertionError(f"serve CLI output: {out}")
    stats = dict(seconds=seconds, results=len(results),
                 stats_line=stats_lines[0]["stats"])
    log(json.dumps({"phase": "serve_cli", **stats}))
    return stats


# ---------------------------------------------------------------------------
# The router phase (serve/router.py, faults.wrap_replica) and the
# fleet-serve phase (FleetScoringServer over a ModelFleet), on phase 3's
# llama-2-7b bf16 params at B = 32.
# ---------------------------------------------------------------------------

# The lag drill's router hedges a request within ROUTER_HEDGE_S of its
# deadline; its request's deadline is ROUTER_HEDGE_DEADLINE_S, so it is
# hedged once it has waited 1 s (a 7B dispatch takes under one).
ROUTER_HEDGE_S = 30.0
ROUTER_HEDGE_DEADLINE_S = 31.0
ROUTER_LAG_S = 4.0
ROUTER_COOLDOWN_S = 2.0
ROUTER_DRILL_REQUESTS = 32
ROUTER_PREFIX_REQUESTS = 6
ROUTER_KERNELS = ("flash_decode_mq", "row_gemm", "row_add_norm")
FAST_RETRY = RetryConfig(max_retries=1, initial_delay=0.01, max_delay=0.02,
                         full_jitter=True, max_elapsed=120.0)


def payload_of(r) -> dict:
    return {f: getattr(r, f) for f in PAYLOAD_FIELDS}


def check_routed_bitwise(label, results: dict, refs) -> int:
    """Every result ok, its payload bitwise the direct dispatch of one of
    the dispatches that carried its request (``refs``: one
    :func:`direct_payloads` a replica's dispatch log). Returns the rows
    checked."""
    for rid, r in results.items():
        if r.status != "ok":
            raise AssertionError(f"{label}: request {rid} {r.status}: "
                                 f"{r.note}")
        got = payload_of(r)
        if not any(rid in ref and got == {f: ref[rid][f]
                                          for f in PAYLOAD_FIELDS}
                   for ref in refs):
            raise AssertionError(f"{label}: request {rid} {got} is no "
                                 f"direct dispatch's")
    return len(results)


def wait_for(cond, seconds: float = 60.0) -> bool:
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > seconds:
            return False
        time.sleep(0.01)
    return True


def router_replicas(engine, prefix_cache: bool) -> tuple:
    """Two replica ScoringServers over engines on ``engine``'s params
    (one read-only tree, a pool each with the prefix cache on), and a
    dispatch log each."""
    servers = {rid: ScoringServer(engine_with(engine), SWEEP_MODEL,
                                  serve_config(prefix_cache=prefix_cache,
                                               cache_entries=0,
                                               retry=FAST_RETRY))
               for rid in ("r0", "r1")}
    return servers, {rid: record_dispatches(s) for rid, s in servers.items()}


def router_drills(router, servers, logs, requests, ref) -> dict:
    """(b) through ``faults.wrap_replica``, on the router of (a):

    - kill: ``replica_kill`` at r0's first dispatch of
      ROUTER_DRILL_REQUESTS Poisson requests: re-admitted >= 1, each
      request resolved once, the killed server's retried dispatch
      counted as zombie payloads, every payload bitwise a direct
      dispatch;
    - revive: ``revive_replica``, then after the cooldown a request
      lands on r0 as the half-open probe and closes its breaker;
    - lag: on a fresh router over the same servers with ``hedge_s``
      (its first pick of two idle replicas is r1), ``replica_lag`` of
      ROUTER_LAG_S on r1 and a request whose deadline is inside the
      whisker: hedged onto r0, the hedge wins, the straggler's payload
      dropped as a hedge loss;
    - fault (:func:`router_fault_drill`, last): every r1 dispatch
      faults: failovers, r1's router-side breaker opens, every request
      served by r0."""
    st = router.stats
    out = {}

    def idle():
        return wait_for(lambda: all(s.queue_depth == 0 and not s._inflight
                                    for s in servers.values()))

    drill = [dataclasses.replace(r, request_id=f"kill{i}")
             for i, r in enumerate(requests[:ROUTER_DRILL_REQUESTS])]
    plan = faults.FaultPlan(0, {"replica": faults.SiteSchedule.replica_kill_at(
        0, "r0")})
    faults.wrap_replica(router, "r0", plan)
    before = st.summary()
    n_logged = {rid: len(logs[rid]) for rid in logs}
    results, wall = poisson_run(router, drill)
    idle()
    after = st.summary()
    delta = {k: after[k] - before[k] for k in after if k != "per_replica"}
    refs = [direct_payloads(ref, logs[rid][n_logged[rid]:]) for rid in logs]
    out["kill"] = dict(
        requests=len(drill), seconds=wall, injected=plan.injected("replica"),
        resolved_once=len({r.request_id for r in results.values()}),
        bitwise_rows=check_routed_bitwise("router kill", results, refs),
        server_faults=servers["r0"].faults.summary(), **{
            k: delta[k] for k in ("re_admitted", "zombie_payloads", "kills",
                                  "completed", "errors")})
    if (out["kill"]["injected"] != 1 or delta["re_admitted"] < 1
            or delta["zombie_payloads"] < 1 or delta["kills"] != 1
            or delta["completed"] != len(drill)
            or out["kill"]["resolved_once"] != len(drill)
            or not servers["r0"].healthy):
        raise AssertionError(f"router kill drill: {out['kill']}")
    # Revive: the probe after the cooldown closes r0's breaker.
    router.revive_replica("r0")
    time.sleep(ROUTER_COOLDOWN_S + 0.1)
    probes = []
    for i, r in enumerate(requests[ROUTER_DRILL_REQUESTS:
                                   ROUTER_DRILL_REQUESTS + 4]):
        n0 = st.summary()["per_replica"].get("r0", 0)
        probes.append(router.submit(dataclasses.replace(
            r, request_id=f"probe{i}")).result(timeout=600).status)
        if st.summary()["per_replica"].get("r0", 0) > n0:
            break
    out["revive"] = dict(probes=probes, breaker=router.breaker_of(
        "r0").state, revives=st.revives)
    if out["revive"]["breaker"] != "closed" or set(probes) != {"ok"}:
        raise AssertionError(f"router revive: {out['revive']}")
    return out


def router_fault_drill(router, servers, logs, requests, ref) -> dict:
    """The fault drill of :func:`router_drills` (last: it leaves r1's
    server breaker open)."""
    st = router.stats
    plan = faults.FaultPlan(0, {"replica": faults.SiteSchedule(rate=1.0)})
    faults.wrap_replica(router, "r1", plan)
    wait_for(lambda: all(s.queue_depth == 0 and not s._inflight
                         for s in servers.values()))
    before = st.summary()
    n_logged = {rid: len(logs[rid]) for rid in logs}
    fres, states = {}, set()
    for i, r in enumerate(requests[48:56]):
        res = router.submit(dataclasses.replace(
            r, request_id=f"fault{i}")).result(timeout=600)
        fres[res.request_id] = res
        states.add(router.breaker_of("r1").state)
    after = st.summary()
    refs = [direct_payloads(ref, logs[rid][n_logged[rid]:]) for rid in logs]
    out = dict(
        requests=len(fres), injected=plan.injected("replica"),
        breaker_states=sorted(states),
        bitwise_rows=check_routed_bitwise("router fault", fres, refs),
        **{k: after[k] - before[k] for k in ("failovers", "replica_errors",
                                             "replica_sheds", "completed")})
    if (out["failovers"] < 1 or "open" not in states
            or out["completed"] != len(fres)):
        raise AssertionError(f"router fault drill: {out}")
    return out


def router_lag_drill(servers, requests) -> dict:
    """The lag drill of :func:`router_drills`, on its own router over the
    same servers, healthy and idle."""
    router = ReplicaRouter(list(servers.items()), config=RouterConfig(
        hedge_s=ROUTER_HEDGE_S, cache_entries=0)).start()
    try:
        plan = faults.FaultPlan(0, {
            "replica": faults.SiteSchedule.replica_lag_at(0, ROUTER_LAG_S,
                                                          "r1")})
        faults.wrap_replica(router, "r1", plan)
        st = router.stats
        t0 = time.perf_counter()
        res = router.submit(dataclasses.replace(
            requests[40], request_id="lag0",
            deadline_s=ROUTER_HEDGE_DEADLINE_S)).result(timeout=600)
        seconds = time.perf_counter() - t0
        wait_for(lambda: st.hedge_losses >= 1, ROUTER_LAG_S + 60)
        out = dict(status=res.status, seconds=seconds,
                   injected=plan.injected("replica"),
                   placements=dict(st.per_replica), **{
                       k: getattr(st, k) for k in (
                           "hedged", "hedge_wins", "hedge_losses",
                           "completed")})
    finally:
        router.stop()
    if (out["status"] != "ok" or out["injected"] != 1 or out["hedged"] != 1
            or out["hedge_wins"] != 1 or out["hedge_losses"] != 1
            or out["completed"] != 1 or seconds >= ROUTER_LAG_S):
        raise AssertionError(f"router lag drill: {out}")
    return out


def prefix_key(engine, r) -> tuple:
    """(bucket, shared prefix ids) of a request, as admission computes
    them."""
    t = engine.tokenizer
    a = list(t(r.binary_prompt).input_ids)
    lcp = tok.shared_prefix_len(a, t(r.confidence_prompt).input_ids)
    return tok.assign_bucket(max(lcp, 1), engine.buckets), tuple(a[:lcp])


def router_prefix(engine, serve_off, requests, bars) -> dict:
    """(c) Prefix on: ROUTER_PREFIX_REQUESTS requests of one bucket whose
    shared prefixes agree for their first 64 tokens, one at a time: after
    the first lands, the rest go to its replica by page residency (the
    tree's listener -> the cluster index -> ``_pick``'s page bonus);
    payloads within ``bars`` of the prefix-off serve run's."""
    servers, _ = router_replicas(engine, prefix_cache=True)
    router = ReplicaRouter(list(servers.items()),
                           config=RouterConfig(cache_entries=0))
    groups = {}
    for r in requests:
        bucket, ids = prefix_key(engine, r)
        if len(ids) >= 64:
            groups.setdefault((bucket, ids[:64]), []).append(r)
    group = max(groups.values(), key=len)[:ROUTER_PREFIX_REQUESTS]
    for s in servers.values():
        s.start()
    try:
        placed, results, pages = [], {}, []
        for r in group:
            pages.append(router.cluster_tree.match_pages(
                *prefix_key(engine, r)))
            before = dict(router.stats.per_replica)
            results[r.request_id] = router.submit(r).result(timeout=600)
            placed += [rid for rid, n in router.stats.per_replica.items()
                       if n > before.get(rid, 0)]
    finally:
        for s in servers.values():
            s.stop()
    out = dict(requests=len(group), placements=placed,
               cluster_pages_at_submit=pages,
               prefix_stats={rid: s.engine.prefix_stats.summary()
                             for rid, s in servers.items()},
               vs_prefix_off=compare_d6(
                   "router prefix on", as_d6(serve_off, requests),
                   as_d6(results, requests), engine, bars))
    if (len(group) < 2 or len(placed) != len(group)
            or set(placed) != {placed[0]}
            or not all(p.get(placed[0], 0) > 0 for p in pages[1:])):
        raise AssertionError(f"router prefix: not placed by page residency "
                             f"{out}")
    return out


def run_router_phase(engine, grids, serve_off, bars) -> dict:
    """``ReplicaRouter`` at llama-2-7b width, bf16, B = 32: two replica
    ScoringServers on one read-only parameter tree. (a) The serve phase's
    SERVE_REQUESTS Poisson requests, prefix off, ``pad_full``: every
    payload bitwise the direct dispatch of the dispatch that carried it
    (the serve phase's check), and within ``bars`` of the serve phase's
    payloads (other batch compositions: the first position's readout
    bitwise, later greedy ids may flip at near ties); placements per replica,
    requests/s, p50 / p99 a class, launches. (b) The drills
    (:func:`router_drills`, :func:`router_lag_drill`). (c) Prefix on
    (:func:`router_prefix`)."""
    requests = serve_requests(grids)
    ref = engine_with(engine, watchdog_multiple=0.0)
    servers, logs = router_replicas(engine, prefix_cache=False)
    router = ReplicaRouter(
        list(servers.items()),
        config=RouterConfig(replica_cooldown_s=ROUTER_COOLDOWN_S,
                            cache_entries=0))
    for s in servers.values():
        s.start()
    router.start()
    out = {}
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        results, wall = poisson_run(router, requests)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        st = router.stats.summary()
        missing = [k for k in ROUTER_KERNELS if launches[k] <= 0]
        if (missing or st["completed"] != len(requests)
                or len(st["per_replica"]) != 2):
            raise AssertionError(f"router: never launched {missing}, or not "
                                 f"every request served on two replicas: "
                                 f"{st}")
        refs = [direct_payloads(ref, logs[rid]) for rid in servers]
        row = dict(requests=len(requests), seconds=wall,
                   requests_per_s=len(requests) / wall,
                   latency=latency_by_class(results, requests),
                   placements=st["per_replica"],
                   dispatches={rid: len(logs[rid]) for rid in logs},
                   launches=launches,
                   max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
                   bitwise_rows=check_routed_bitwise("router", results,
                                                     refs),
                   vs_serve_phase=compare_d6(
                       "router vs serve phase", as_d6(serve_off, requests),
                       as_d6(results, requests), engine, bars))
        out["a"] = row
        log(json.dumps({"phase": "router_a", "card": card_line(), **row}))
        out["drills"] = router_drills(router, servers, logs, requests, ref)
        out["drills"]["lag"] = router_lag_drill(servers, requests)
        out["drills"]["fault"] = router_fault_drill(router, servers, logs,
                                                    requests, ref)
        out["summary"] = router.stats_summary()
    finally:
        router.stop()
        for s in servers.values():
            s.stop()
    log(json.dumps({"phase": "router_drills", **out["drills"]}))
    out["prefix"] = router_prefix(engine, serve_off, requests, bars)
    log(json.dumps({"phase": "router_prefix", **out["prefix"]}))
    del servers, router, ref
    gc.collect()
    torch.cuda.empty_cache()
    GOVERNOR_ENGAGED.clear()
    return out


# ---------------------------------------------------------------------------
# The migrate phase (serve/migrate.py, the router's chain,
# faults.wrap_migrator), on phase 3's llama-2-7b bf16 params at B = 32.
# ---------------------------------------------------------------------------

MIGRATE_MIN_PREFIX = 64
MIGRATE_CHAINS = 12
MIGRATE_PULLS = 4
MIGRATE_STALL_TIMEOUT_S = 1.5
MIGRATE_STALL_S = 4.0
MIGRATE_KILL_HOLD_S = 1.5
MIGRATE_KERNELS = ("flash_decode_mq", "row_gemm", "row_add_norm")


def host_pages(server, bucket, ids) -> list:
    """The pool pages of ``ids``' cached prefix on ``server``, copied to
    the host by a page op on its supervisor thread (every leaf, scales
    included on int8)."""
    def grab(eng):
        tree = eng.prefix_cache
        m = tree.lookup(bucket, ids, record=False)
        try:
            return [a.cpu() for a in decoder.cache_leaves(
                tree.pool.extract(list(m.pages)))], len(m.pages)
        finally:
            tree.release(m)

    leaves, n = server.submit_page_op(grab).result(timeout=600)
    return [a[:, :, :n] for a in leaves]


def pages_equal(label, src, dst, bucket, ids) -> int:
    """r1's pool pages for the prefix byte-equal to r0's (torch.equal,
    every leaf); returns the pages compared."""
    a, b = host_pages(src, bucket, ids), host_pages(dst, bucket, ids)
    n = min(x.shape[2] for x in a + b)
    if n == 0 or not all(torch.equal(x[:, :, :n], y[:, :, :n])
                         for x, y in zip(a, b)):
        raise AssertionError(f"{label}: destination pages are not the "
                             f"source's ({n} pages)")
    return n


def tree_state(server) -> tuple:
    def read(eng):
        tree = eng.prefix_cache
        return (len(tree), tree.pool.pages_in_use,
                int(tree.pool.refcount[1:].sum()))

    return server.submit_page_op(read).result(timeout=600)


def migrate_replicas(engine, kv8: bool = False) -> tuple:
    """(servers {r0, r1}, dispatch logs): two replica servers (prefix on)
    over engines on ``engine``'s params."""
    make = kv8_engine if kv8 else engine_with
    servers = {rid: ScoringServer(make(engine), SWEEP_MODEL,
                                  serve_config(prefix_cache=True,
                                               cache_entries=0,
                                               retry=FAST_RETRY))
               for rid in ("r0", "r1")}
    return servers, {rid: record_dispatches(s) for rid, s in servers.items()}


def replay_engine(engine, kv8: bool = False):
    """A third engine on ``engine``'s params, prefix on, that the checks
    import the chains' exports into (:func:`replay_chain`). Made after a
    phase's launches and peak memory are read, so its pool counts in
    neither."""
    replay = (kv8_engine if kv8 else engine_with)(engine)
    replay.enable_prefix_cache()
    return replay


def record_transfers(router) -> list:
    """Wrap the router's migrator: every export that crosses the wire
    hop (until :func:`chain_one` takes it), and the legs' seconds,
    checksum seconds and bytes of every accounted chain."""
    seen = {"exports": [], "accounted": []}
    inner, account = router.migrator.transfer, router.migrator.account

    def transfer(export):
        seen["exports"].append(export)
        return inner(export)

    def acc(export, imp):
        seen["accounted"].append(dict(
            export_s=export.wall_s, export_crc_s=export.crc_s,
            import_s=imp.wall_s, verify_crc_s=imp.crc_s, bytes=imp.nbytes))
        return account(export, imp)

    router.migrator.transfer = transfer
    router.migrator.account = acc
    return seen


def chain_one(label, router, logs, seen, r) -> tuple:
    """One request through the router. Returns (result, seconds, the
    chain's replay: its exports and r1's dispatches while it ran, for
    :func:`replay_chain` once the phase's launches are read). The
    exports' chunks are copied into pageable memory and the originals
    dropped, so the next chain reuses their pinned buffers."""
    k0, d0 = len(seen["exports"]), len(logs["r1"])
    t0 = time.perf_counter()
    res = router.submit(r).result(timeout=600)
    secs = time.perf_counter() - t0
    if res.status != "ok":
        raise AssertionError(f"{label}: {r.request_id} {res.status} "
                             f"{res.note}")
    exports = [dataclasses.replace(e, chunks=[
        (decoder.cache_map(lambda a: torch.empty(
            a.shape, dtype=a.dtype).copy_(a), host), n)
        for host, n in e.chunks]) for e in seen["exports"][k0:]]
    del seen["exports"][k0:]
    return res, secs, (exports, logs["r1"][d0:])


def replay_chain(replay, chain, refs) -> None:
    """A chain's exports imported into the replay engine, its carrying
    dispatches replayed over those pages; fills ``refs`` with the
    replay's payloads."""
    exports, dispatches = chain
    for e in exports:
        migrate.import_prefix(replay, e)
    refs.update(direct_payloads(replay, dispatches, use_prefix_cache=True))


def migrate_leg(servers, bucket, ids, cfg) -> dict:
    """One export from r0 and its import into r1 (whose pages of the
    prefix are forgotten first), each a page op timed between
    synchronizes; the export is dropped on return, so its pinned buffers
    go back to the host allocator's cache."""
    def export(eng):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e = migrate.export_prefix(eng, bucket, ids, config=cfg)
        torch.cuda.synchronize()
        return e, time.perf_counter() - t0

    e, t_exp = servers["r0"].submit_page_op(export).result(timeout=600)

    def land(eng):
        tree = eng.prefix_cache
        m = tree.lookup(bucket, ids, record=False)
        tree.release(m)
        gone = tree.forget_tail(bucket, ids, len(m.pages))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        imp = migrate.import_prefix(eng, e, config=cfg)
        torch.cuda.synchronize()
        return imp, time.perf_counter() - t0, gone

    imp, t_imp, gone = servers["r1"].submit_page_op(land).result(
        timeout=600)
    if imp.pages != e.n_pages or gone != e.n_pages:
        raise AssertionError(f"migrate leg: forgot {gone}, landed "
                             f"{imp.pages} of {e.n_pages}")
    return dict(
        pages=e.n_pages, chunks=len(e.chunks), bytes=e.nbytes,
        export_s=t_exp, export_crc_s=e.crc_s,
        d2h_gb_per_s=e.nbytes / max(t_exp - e.crc_s, 1e-9) / 1e9,
        verify_crc_s=imp.crc_s, import_s=t_imp,
        h2d_gb_per_s=e.nbytes / max(t_imp - imp.crc_s, 1e-9) / 1e9,
        crc_gb_per_s=e.nbytes / max(e.crc_s, 1e-9) / 1e9,
        exposed_s=e.wall_s + imp.wall_s,
        hidden_s=(max(e.serial_s - e.wall_s, 0.0)
                  + max(imp.serial_s - imp.wall_s, 0.0)))


def migrate_legs(servers, router, bucket, ids) -> dict:
    """The two legs alone on one prefix resident on r0
    (:func:`migrate_leg`), at the default chunking and at 2 pages a
    chunk (the in-flight window over several chunks), each twice: the
    first of a chunk size may allocate pinned buffers (cudaHostAlloc),
    the second reuses them."""
    chunk2 = dataclasses.replace(router.migrate_config, chunk_pages=2)
    return {label: migrate_leg(servers, bucket, ids, cfg)
            for label, cfg in (("default", router.migrate_config),
                               ("default_again", router.migrate_config),
                               ("chunk2", chunk2),
                               ("chunk2_again", chunk2))}


def migrate_drills(router, servers, logs, requests, off, bars,
                   engine) -> dict:
    """(c) Each drill a fresh request through ``faults.wrap_migrator`` on
    the chain router: a stall past a short deadline (the tick falls back;
    the stall holds r0's supervisor, whose queue wait is timed by a page
    op submitted during it), a corrupt chunk (refused; r1's tree at the
    refusal as before the request), a kill of r0 with the chain's prefill
    queued behind a held op. Every request resolves once, ok, through a
    local re-prefill, within ``bars`` of the prefix-off payloads: each
    drill places one attempt (``RouterStats.per_replica``) and takes one
    refetch fallback, and its request is a row of exactly one scoring
    dispatch across r0's and r1's dispatch logs."""
    st = router.migrate_stats
    out, results = {}, {}
    stall, corrupt, kill = requests
    n0 = {rid: len(lg) for rid, lg in logs.items()}

    def placed():
        return sum(router.stats.per_replica.values())

    # Stall.
    base, p0 = st.summary(), placed()
    router.migrator.config = router.migrate_config = dataclasses.replace(
        router.migrate_config, timeout_s=MIGRATE_STALL_TIMEOUT_S)
    plan = faults.FaultPlan(11, {"migrate": faults.SiteSchedule(
        fail_calls=(0,), kind="migration_stall", hang_s=MIGRATE_STALL_S)})
    wrapped = router.migrator.transfer
    faults.wrap_migrator(router.migrator, plan)
    t0 = time.perf_counter()
    fut = router.submit(stall)
    wait_for(lambda: plan.injected("migrate") >= 1, 600)
    t_q = time.perf_counter()
    servers["r0"].submit_page_op(lambda eng: None).result(timeout=600)
    queue_wait = time.perf_counter() - t_q
    res = fut.result(timeout=600)
    results[stall.request_id] = res
    out["stall"] = dict(status=res.status, seconds=time.perf_counter() - t0,
                        injected=plan.injected("migrate"),
                        source_queue_wait_s=queue_wait,
                        timeout_s=MIGRATE_STALL_TIMEOUT_S,
                        stall_s=MIGRATE_STALL_S)
    wait_for(lambda: st.summary()["stalls"] - base["stalls"] >= 2,
             MIGRATE_STALL_S + 60)
    out["stall"].update({k: st.summary()[k] - base[k]
                         for k in ("stalls", "refetch_fallbacks",
                                   "migrations")}, placements=placed() - p0)
    router.migrator.transfer = wrapped
    router.migrator.config = router.migrate_config = dataclasses.replace(
        router.migrate_config, timeout_s=MigrationConfig().timeout_s)
    # Corrupt.
    base, p0 = st.summary(), placed()
    plan = faults.FaultPlan(12, {"migrate": faults.SiteSchedule.
                                 migration_corrupt_at(0)})
    faults.wrap_migrator(router.migrator, plan)
    before = tree_state(servers["r1"])
    at_refusal = []
    inner_fallback = router._mig_fallback

    def fallback(mig, reason):
        if reason.startswith("import failed"):
            tree = mig.dst.server.engine.prefix_cache
            at_refusal.append((len(tree), tree.pool.pages_in_use,
                               int(tree.pool.refcount[1:].sum())))
        return inner_fallback(mig, reason)

    router._mig_fallback = fallback
    res = router.submit(corrupt).result(timeout=600)
    router._mig_fallback = inner_fallback
    router.migrator.transfer = wrapped
    results[corrupt.request_id] = res
    out["corrupt"] = dict(status=res.status, injected=plan.injected(
        "migrate"), r1_tree_before=before, r1_tree_at_refusal=at_refusal,
        placements=placed() - p0,
        **{k: st.summary()[k] - base[k]
           for k in ("corrupt_chunks", "refetch_fallbacks", "migrations")})
    # Kill r0 with the chain's prefill queued behind a held op.
    base, p0 = st.summary(), placed()
    hold = servers["r0"].submit_page_op(
        lambda eng: time.sleep(MIGRATE_KILL_HOLD_S))
    fut = router.submit(kill)
    router.kill_replica("r0")
    res = fut.result(timeout=600)
    hold.result(timeout=600)
    results[kill.request_id] = res
    # Every op queued on either supervisor (r0's late prefill too) has
    # run once this one has.
    for s in servers.values():
        s.submit_page_op(lambda eng: None).result(timeout=600)
    out["kill"] = dict(status=res.status, placements=placed() - p0, **{
        k: st.summary()[k] - base[k]
        for k in ("refetch_fallbacks", "prefill_ops", "migrations")})
    out["dispatch_rows"] = {
        r.request_id: sum(p.request.request_id == r.request_id
                          for rid, lg in logs.items()
                          for _, rows in lg[n0[rid]:] for p in rows)
        for r in requests}
    ok = (out["stall"]["status"] == out["corrupt"]["status"]
          == out["kill"]["status"] == "ok"
          and out["stall"]["injected"] == 1
          and out["stall"]["refetch_fallbacks"] == 1
          and out["stall"]["stalls"] >= 1
          and out["stall"]["source_queue_wait_s"] > 0.5
          and out["corrupt"]["injected"] == 1
          and out["corrupt"]["corrupt_chunks"] == 1
          and out["corrupt"]["refetch_fallbacks"] == 1
          and at_refusal == [before]
          and out["kill"]["refetch_fallbacks"] == 1
          and out["kill"]["migrations"] == 0
          and all(out[k]["placements"] == 1
                  for k in ("stall", "corrupt", "kill"))
          and list(out["dispatch_rows"].values()) == [1, 1, 1])
    out["vs_prefix_off"] = compare_d6(
        "migrate drills vs prefix off",
        as_d6({rid: off[rid] for rid in results}, requests),
        as_d6(results, requests), engine, bars)
    if not ok:
        raise AssertionError(f"migrate drills: {out}")
    return out


def migrate_kv8_chain(engine, request) -> dict:
    """(d) One chain on int8-KV replicas: r1's pages byte-equal to r0's,
    int8 payloads and float32 scales, and the payload bitwise the replay
    over the same imported pages."""
    servers, logs = migrate_replicas(engine, kv8=True)
    router = ReplicaRouter(list(servers.items()),
                           config=RouterConfig(cache_entries=0),
                           roles={"r0": "prefill", "r1": "decode"})
    seen = record_transfers(router)
    for s in servers.values():
        s.start()
    router.start()
    try:
        refs = {}
        res, secs, chain = chain_one("migrate kv8", router, logs, seen,
                                     request)
        replay = replay_engine(engine, kv8=True)
        replay_chain(replay, chain, refs)
        bucket, ids = prefix_key(engine, request)
        leaves = host_pages(servers["r1"], bucket, ids)
        pages = pages_equal("migrate kv8", servers["r0"], servers["r1"],
                            bucket, ids)
        st = router.migrate_stats.summary()
        bitwise = check_routed_bitwise("migrate kv8", {res.request_id: res},
                                       [refs])
    finally:
        router.stop()
        for s in servers.values():
            s.stop()
    out = dict(seconds=secs, pages_equal=pages, bitwise_rows=bitwise,
               leaf_dtypes=[str(a.dtype) for a in leaves], migrate=st)
    if (len(leaves) != 4 or st["migrations"] != 1
            or [str(a.dtype) for a in leaves] != ["torch.int8",
                                                  "torch.float32"] * 2):
        raise AssertionError(f"migrate kv8: {out}")
    del servers, router, replay
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_migrate_phase(engine, grids, serve_off, bars) -> dict:
    """Page migration and disaggregated prefill / decode at llama-2-7b
    width, bf16, B = 32, prefix on: r0 prefill-role, r1 decode-role, on
    the one parameter tree (see the module docstring's migrate phase).
    The serve phase's requests whose shared prefix is at least
    MIGRATE_MIN_PREFIX tokens, one at a time (each chain's pages and
    payload checked before the next)."""
    requests = serve_requests(grids)
    eligible = [r for r in requests
                if len(prefix_key(engine, r)[1]) >= MIGRATE_MIN_PREFIX]
    need = MIGRATE_CHAINS + MIGRATE_PULLS + 4
    if len(eligible) < need:
        raise AssertionError(f"migrate: {len(eligible)} requests with a "
                             f"{MIGRATE_MIN_PREFIX}-token prefix, {need} "
                             f"needed")
    chains = eligible[:MIGRATE_CHAINS]
    pulls = eligible[MIGRATE_CHAINS:MIGRATE_CHAINS + MIGRATE_PULLS]
    drills = eligible[MIGRATE_CHAINS + MIGRATE_PULLS:need - 1]
    kv8_req = eligible[need - 1]
    servers, logs = migrate_replicas(engine)
    router = ReplicaRouter(list(servers.items()),
                           config=RouterConfig(cache_entries=0),
                           roles={"r0": "prefill", "r1": "decode"})
    seen = record_transfers(router)
    for s in servers.values():
        s.start()
    router.start()
    out = {}
    try:
        # (a) Chains.
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        results, refs, lat, pages, replays = {}, {}, [], 0, []
        t0 = time.perf_counter()
        for r in chains:
            res, secs, chain = chain_one("migrate chain", router, logs,
                                         seen, r)
            results[r.request_id] = res
            lat.append(secs)
            replays.append(chain)
            pages += pages_equal("migrate chain", servers["r0"],
                                 servers["r1"], *prefix_key(engine, r))
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        # The checks' replays, after the chains' launches and peak.
        replay = replay_engine(engine)
        for chain in replays:
            replay_chain(replay, chain, refs)
        del replays
        st = router.migrate_stats.summary()
        missing = [k for k in MIGRATE_KERNELS if launches[k] <= 0]
        if (missing or st["migrations"] < 1 or st["refetch_fallbacks"]
                or st["prefill_ops"] != len(chains)
                or router.stats.per_replica.get("r0", 0)):
            raise AssertionError(f"migrate chains: never launched "
                                 f"{missing}, or {st}, placements "
                                 f"{router.stats.per_replica}")
        acc = seen["accounted"]
        row = dict(
            requests=len(chains), chain_seconds=sum(lat),
            loop_seconds_with_checks=wall,
            requests_per_s=len(chains) / sum(lat),
            p50_s=float(np.percentile(lat, 50)),
            p99_s=float(np.percentile(lat, 99)),
            migrate=st, pages_compared_equal=pages,
            legs_in_chains={k: sum(a[k] for a in acc)
                            for k in ("export_s", "export_crc_s",
                                      "import_s", "verify_crc_s", "bytes")},
            bitwise_rows=check_routed_bitwise("migrate chain", results,
                                              [refs]),
            vs_prefix_off=compare_d6(
                "migrate chains vs prefix off", as_d6(serve_off, requests),
                as_d6(results, requests), engine, bars),
            launches=launches, max_memory_allocated_bytes=peak)
        out["a"] = row
        log(json.dumps({"phase": "migrate_a", "card": card_line(), **row}))
        bucket, ids = max((prefix_key(engine, r) for r in chains),
                          key=lambda k: len(k[1]))
        out["legs"] = migrate_legs(servers, router, bucket, ids)
        log(json.dumps({"phase": "migrate_legs", **out["legs"]}))
        # (b) Pure pulls: each prefix scored on r0 first.
        base = router.migrate_stats.summary()
        presults, prefs = {}, {}
        for r in pulls:
            servers["r0"].submit(dataclasses.replace(
                r, request_id=f"warm{r.request_id}")).result(timeout=600)
            res, _, chain = chain_one("migrate pull", router, logs, seen, r)
            replay_chain(replay, chain, prefs)
            presults[r.request_id] = res
            pages_equal("migrate pull", servers["r0"], servers["r1"],
                        *prefix_key(engine, r))
        st = router.migrate_stats.summary()
        out["b"] = dict(
            requests=len(pulls), **{k: st[k] - base[k] for k in (
                "migrations", "prefill_ops", "pages_migrated",
                "refetch_fallbacks")},
            bitwise_rows=check_routed_bitwise("migrate pull", presults,
                                              [prefs]),
            vs_prefix_off=compare_d6(
                "migrate pulls vs prefix off", as_d6(serve_off, requests),
                as_d6(presults, requests), engine, bars))
        if (out["b"]["migrations"] != len(pulls) or out["b"]["prefill_ops"]
                or out["b"]["refetch_fallbacks"]):
            raise AssertionError(f"migrate pulls: {out['b']}")
        log(json.dumps({"phase": "migrate_b", **out["b"]}))
        # (c) Drills.
        out["drills"] = migrate_drills(router, servers, logs, drills,
                                       serve_off, bars, engine)
        log(json.dumps({"phase": "migrate_drills", **out["drills"]}))
        out["summary"] = router.stats_summary()
    finally:
        router.stop()
        for s in servers.values():
            s.stop()
    leftover = {rid: [k for k in s.engine.governor.ledger()
                      if k.startswith("migrate_buf:")]
                for rid, s in servers.items()}
    if any(leftover.values()):
        raise AssertionError(f"migrate: ledger entries left {leftover}")
    del servers, router, replay
    gc.collect()
    torch.cuda.empty_cache()
    out["kv8"] = migrate_kv8_chain(engine, kv8_req)
    log(json.dumps({"phase": "migrate_kv8", **out["kv8"]}))
    return out


def serve_cli_migrate(small, tmp: Path) -> dict:
    """(e) ``serve --replicas 2 --migrate-prefill-replicas 1`` on the
    small model: four requests sharing a long prompt and a stats line;
    every request ok, r0 the prefill role, the stats line's "migrate"
    block with the chains under way."""
    cfg, _, params = small
    root = tmp / "serve_cli"
    name = "smoke/tiny-llama"
    if not (root / name.replace("/", "__")).exists():
        export_hf_llama(params, cfg, root / name.replace("/", "__"))
    lines = [{"id": f"m{i}", "prompt": f"{LEGAL_PROMPTS[0].main[:300]} "
                                       f"(case {i})",
              "class": "interactive"} for i in range(4)]
    got, secs = serve_cli_run(
        tmp, root, "migrate", ["--model", name, "--replicas", "2",
                               "--migrate-prefill-replicas", "1",
                               "--migrate-min-prefix", "16"],
        lines + [{"op": "stats"}])
    stats = [o for o in got if o.get("op") == "stats"]
    results = [o for o in got if "request_id" in o]
    if (len(stats) != 1 or stats[0]["replicas"]["r0"]["role"] != "prefill"
            or stats[0]["replicas"]["r1"]["role"] != "decode"
            or stats[0]["migrate"]["prefill_ops"] < 1
            or [r["request_id"] for r in results] != [x["id"] for x in lines]
            or any(r["status"] != "ok" or not 0.0 <= r["token_1_prob"] <= 1.0
                   for r in results)):
        raise AssertionError(f"serve --migrate-prefill-replicas output: "
                             f"{got}")
    out = dict(seconds=secs, results=len(results),
               migrate=stats[0]["migrate"],
               placements=stats[0]["router"]["per_replica"])
    log(json.dumps({"phase": "serve_cli_migrate", **out}))
    return out


FLEET_SERVE_WAVES = 4
FLEET_SERVE_WAVE = 8
FLEET_SQUEEZE_REQUESTS = 24


def fleet_serve_requests(engine, grids) -> list:
    """FLEET_SERVE_WAVES x FLEET_SERVE_WAVE requests of one bucket (so a
    model's wave is one dispatch, whatever server forms it)."""
    by_bucket = {}
    for r in serve_requests(grids):
        by_bucket.setdefault(prefix_key(engine, r)[0], []).append(r)
    group = max(by_bucket.values(), key=len)
    n = FLEET_SERVE_WAVES * FLEET_SERVE_WAVE
    if len(group) < n:
        raise AssertionError(f"fleet serve: {len(group)} requests share a "
                             f"bucket, {n} needed")
    return [dataclasses.replace(r, request_id=f"f{i}", klass="batch")
            for i, r in enumerate(group[:n])]


def fleet_kappa_check(res) -> dict:
    """A fan-out's kappa and disagreement against the CPU recomputation
    from its probabilities (the fold's decision rule, then
    ``stats.kappa.within_group_kappa``), exactly."""
    from lir_tpu_torch.stats.kappa import within_group_kappa

    decs = [fleet_decision(m["token_1_prob"], m["token_2_prob"])
            for m in res["per_model"].values()]
    decs = [d for d in decs if d is not None]
    ref = within_group_kappa(np.asarray(decs, int),
                             np.zeros(len(decs), int))
    want = {k: float(ref[k]) for k in ("kappa", "observed_agreement",
                                       "expected_agreement")}
    dis = 1.0 - want["observed_agreement"] if len(decs) > 1 else math.nan

    def same(a, b):
        return a == b or (math.isnan(a) and math.isnan(b))

    if not (all(same(res["kappa"][k], v) for k, v in want.items())
            and same(res["disagreement"], dis)):
        raise AssertionError(f"fleet kappa {res['kappa']} / "
                             f"{res['disagreement']} != CPU {want} / {dis}")
    return dict(decisions=decs, **want)


def record_payloads(server) -> dict:
    """Wrap each model batcher's score of a fleet server: payloads by
    sub-request id (``"<id>#<model>"``) and the dispatches' row counts."""
    rec = {"payloads": {}, "rows": []}
    for b in server.batcher.batchers.values():
        inner = b.score

        def score(bucket, rows, inner=inner):
            out = inner(bucket, rows)
            rec["rows"].append(len(rows))
            for p, payload in zip(rows, out):
                rec["payloads"][p.request.request_id] = payload
            return out

        b.score = score
    return rec


def fleet_single_replays(fleet, waves, payloads) -> int:
    """Each wave's per-model payloads against a single-model ScoringServer
    (prefix off) on the same engine, the wave's sub-requests submitted
    together (one dispatch, as in the fleet): bitwise, every field.
    Returns the rows held."""
    n = 0
    for mid in fleet.model_ids:
        eng = fleet.acquire(mid)
        try:
            for wave in waves:
                server = ScoringServer(eng, mid, serve_config(
                    prefix_cache=False, cache_entries=0))
                futs = [server.submit(dataclasses.replace(
                    r, request_id=f"{r.request_id}#{mid}")) for r in wave]
                server.start()
                try:
                    got = [f.result(timeout=600) for f in futs]
                finally:
                    server.stop()
                for single in got:
                    want = payloads[single.request_id]
                    if single.status != "ok" or payload_of(single) != want:
                        raise AssertionError(
                            f"fleet {single.request_id}: {want} is not the "
                            f"single-model server's {single}")
                    n += 1
        finally:
            fleet.release(mid)
    return n


def fleet_squeeze(server, fleet, requests, rec, bars) -> dict:
    """The shared governor squeezed (its budget to 1 %, a ballast of 5 %
    of it held under the ledger): ticked (no dispatch) until
    ``batch_down`` engages, FLEET_SQUEEZE_REQUESTS fan-outs served with
    every dispatch at most half the batch, each row within ``bars`` of
    its full-batch payload (``rec``'s); ticked on until ``shed`` engages,
    when a single-model ScoringServer on a fleet engine (the same
    governor) refuses a submit; then the squeeze ends, the ladder walks
    back to none, and a fan-out is served."""
    gov = fleet.governor

    def tick_to(level: int) -> None:
        for _ in range(8 * len(hbm.RUNGS)):
            if gov.level >= level:
                return
            gov.tick()
        raise AssertionError(f"fleet squeeze: level {gov.level}, {level} "
                             f"wanted")

    # A ballast on the card under the ledger keeps the pressure up once
    # the evict_weights rung has dropped the idle model (the fleet's
    # ledger is otherwise its evictable weights).
    ballast = torch.empty(int(0.05 * gov.budget_bytes), dtype=torch.uint8,
                          device=DEV)
    gov.register("ballast:fleet_squeeze", ballast.numel())
    gov.squeeze(0.01, calls=100_000)
    tick_to(hbm.RUNGS.index("batch_down") + 1)
    cap = gov.batch_cap(BATCH)
    n_rows = len(rec["rows"])
    squeezed = [dataclasses.replace(r, request_id=f"sq{i}")
                for i, r in enumerate(requests[:FLEET_SQUEEZE_REQUESTS])]
    got = [f.result(timeout=600)
           for f in [server.submit_fleet(r) for r in squeezed]]
    rows = rec["rows"][n_rows:]
    keyed, ref, got_rows = [], {}, {}
    for r, q in zip(requests, squeezed):
        for mid in fleet.model_ids:
            key = f"{r.request_id}#{mid}"
            keyed.append(dataclasses.replace(r, request_id=key))
            ref[key] = types.SimpleNamespace(
                **rec["payloads"][key])
            got_rows[key] = types.SimpleNamespace(
                **rec["payloads"][f"{q.request_id}#{mid}"])
    vs_full = compare_d6("fleet batch_down", as_d6(ref, keyed),
                         as_d6(got_rows, keyed),
                         fleet.engine(fleet.model_ids[0]), bars)
    tick_to(hbm.RUNGS.index("shed") + 1)
    mid = fleet.model_ids[0]
    eng = fleet.acquire(mid)
    try:
        shed = ScoringServer(eng, mid, serve_config(
            prefix_cache=False, cache_entries=0)).submit(
            requests[0]).result(timeout=60)
    finally:
        fleet.release(mid)
    gov.unregister("ballast:fleet_squeeze")
    del ballast
    gov.squeeze(1.0, calls=1)
    for _ in range(8 * len(hbm.RUNGS)):
        if gov.level == 0:
            break
        gov.tick()
    after = server.submit_fleet(dataclasses.replace(
        requests[0], request_id="sq_after")).result(timeout=600)
    out = dict(batch_cap=cap, dispatch_rows=rows,
               statuses=sorted({r["status"] for r in got}),
               vs_full_batch=vs_full, shed=shed.status, shed_note=shed.note,
               level_after=gov.level, after=after["status"],
               governor=gov.summary())
    if (cap != BATCH // 2 or not rows or max(rows) > cap
            or out["statuses"] != ["ok"] or shed.status != "shed"
            or gov.level != 0 or after["status"] != "ok"):
        raise AssertionError(f"fleet squeeze: {out}")
    GOVERNOR_ENGAGED.clear()
    return out


def run_fleet_serve_phase(engine, grids, bars) -> dict:
    """``FleetScoringServer`` at llama-2-7b width, bf16, B = 32: a
    ModelFleet of phase 3's tree and a second llama-2-7b tree seeded on
    the card, under a weight budget of one model (FLEET_BUDGET_FACTOR x
    its bytes: a switch evicts one and streams the other back from
    pinned staging). FLEET_SERVE_WAVES waves of FLEET_SERVE_WAVE
    ``fleet_score`` requests: each per-model payload bitwise a
    single-model ScoringServer on the same engine, each kappa and
    disagreement the CPU recomputation's; swaps with the seconds hidden
    and exposed, peak memory, launches. Then the governor squeeze
    (:func:`fleet_squeeze`)."""
    cfg = engine.cfg
    second = decoder.init_params(cfg, seed=1, device=DEV,
                                 dtype=torch.bfloat16)
    nbytes = quant.param_bytes(engine.params)
    fleet = ModelFleet.from_engines(
        [("llama-2-7b/a", engine_with(engine)),
         ("llama-2-7b/b", ScoringEngine(second, cfg, engine.tokenizer,
                                        engine.rt, device=DEV))],
        cache_budget_bytes=int(FLEET_BUDGET_FACTOR * nbytes))
    del second
    requests = fleet_serve_requests(engine, grids)
    waves = [requests[i:i + FLEET_SERVE_WAVE]
             for i in range(0, len(requests), FLEET_SERVE_WAVE)]
    server = FleetScoringServer(fleet, serve_config(cache_entries=0),
                                fleet_deadline_s=600.0)
    rec = record_payloads(server)
    server.start()
    out = {}
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        results = {}
        for wave in waves:
            futs = [server.submit_fleet(r) for r in wave]
            for r, f in zip(wave, futs):
                results[r.request_id] = f.result(timeout=600)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        missing = [k for k in ROUTER_KERNELS if launches[k] <= 0]
        if missing or {r["status"] for r in results.values()} != {"ok"}:
            raise AssertionError(f"fleet serve: never launched {missing} or "
                                 f"not all ok")
        kappas = {rid: fleet_kappa_check(r) for rid, r in results.items()}
        fst = fleet.stats.summary()
        if fst["evictions"] < 1 or fst["loads"] < 1:
            raise AssertionError(f"fleet serve: no swap under a one-model "
                                 f"budget {fst}")
        row = dict(requests=len(requests), rows=len(requests) * 2,
                   seconds=wall, requests_per_s=len(requests) / wall,
                   dispatch_rows=list(rec["rows"]), launches=launches,
                   fleet=fst, serve=server.stats.summary(),
                   max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
                   kappa_equal_cpu=len(kappas),
                   models_agree=sum(k["observed_agreement"] == 1.0
                                    for k in kappas.values()),
                   bitwise_rows=fleet_single_replays(fleet, waves,
                                                     rec["payloads"]))
        out["serve"] = row
        log(json.dumps({"phase": "fleet_serve", "card": card_line(), **row}))
        out["squeeze"] = fleet_squeeze(server, fleet, requests, rec, bars)
        log(json.dumps({"phase": "fleet_serve_squeeze", **out["squeeze"]}))
    finally:
        server.stop()
        fleet.shutdown()
    del fleet, server
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serve_cli_run(tmp: Path, root: Path, label: str, args: list,
                  lines: list) -> tuple:
    """``python -m lir_tpu_torch serve`` as a subprocess on checkpoints
    under ``root``, with the stub ``transformers`` on its path: (output
    objects, seconds). Fails on a non-zero exit."""
    stub = tmp / "serve_cli_stub" / "transformers"
    if not stub.exists():
        stub.mkdir(parents=True)
        (stub / "__init__.py").write_text(TRANSFORMERS_STUB)
    reqs = tmp / f"serve_cli_{label}.jsonl"
    reqs.write_text("\n".join(json.dumps(x) for x in lines) + "\n")
    repo = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(stub.parent), str(repo)]))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "lir_tpu_torch", "serve", "--checkpoints",
         str(root), "--requests", str(reqs), "--batch-size", "8",
         "--linger-ms", "0"] + args,
        cwd=repo, env=env, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"serve CLI ({label}) exit {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    return [json.loads(x) for x in proc.stdout.strip().splitlines()], seconds


def serve_cli_router_fleet(small, tmp: Path) -> dict:
    """``serve --replicas 2`` and ``serve --fleet-models a,b`` on the
    small model (two exported copies): eight requests and a stats line
    each; every request ok, probabilities in [0, 1], the router's stats
    line its two replicas, the fleet's answers fan-outs of two models
    and a single-model line."""
    cfg, _, params = small
    root = tmp / "serve_cli"
    names = ["smoke/tiny-llama", "smoke/tiny-llama-b"]
    for name in names:
        if not (root / name.replace("/", "__")).exists():
            export_hf_llama(params, cfg, root / name.replace("/", "__"))
    lines = [{"id": f"c{i}", "prompt": f"{LEGAL_PROMPTS[i % 5].main[:200]}",
              "class": "interactive"} for i in range(8)]
    out = {}
    got, secs = serve_cli_run(
        tmp, root, "replicas", ["--model", names[0], "--replicas", "2"],
        lines[:4] + [{"op": "stats"}] + lines[4:])
    stats = [o for o in got if o.get("op") == "stats"]
    results = [o for o in got if "request_id" in o]
    if (len(stats) != 1 or set(stats[0]["replicas"]) != {"r0", "r1"}
            or [r["request_id"] for r in results] != [x["id"] for x in lines]
            or any(r["status"] != "ok" or not 0.0 <= r["token_1_prob"] <= 1.0
                   for r in results)):
        raise AssertionError(f"serve --replicas output: {got}")
    out["replicas"] = dict(seconds=secs, results=len(results),
                           placements=stats[0]["router"]["per_replica"])
    fleet_lines = lines[:4] + [dict(lines[4], model=names[1]),
                               {"op": "stats"}]
    got, secs = serve_cli_run(
        tmp, root, "fleet", ["--fleet-models", ",".join(names)], fleet_lines)
    stats = [o for o in got if o.get("op") == "stats"]
    fans = [o for o in got if "per_model" in o]
    single = [o for o in got if "request_id" in o and "per_model" not in o]
    if (len(stats) != 1 or len(fans) != 4 or len(single) != 1
            or any(f["status"] != "ok" or f["n_models"] != 2 for f in fans)
            or single[0]["status"] != "ok"):
        raise AssertionError(f"serve --fleet-models output: {got}")
    out["fleet"] = dict(seconds=secs, fan_outs=len(fans),
                        fleet=stats[0]["fleet"])
    log(json.dumps({"phase": "serve_cli_router_fleet", **out}))
    return out


def kernel_label(mangled: str) -> str:
    """A kernel's name and raw template arguments from its mangled name,
    e.g. ``prefix_wgmma_kernel<Li128>``."""
    # Every start of a digit run: a length prefix may follow other digits
    # (an anonymous namespace's hash ends in digits). Digits inside that
    # hash can also read as a length that ends at the kernel's name, so
    # the shortest such name is the kernel's own.
    found = []
    for m in re.finditer(r"(?=(\d+))", mangled):
        for n in range(len(m.group(1)), 0, -1):
            end = m.start() + n
            name = mangled[end:end + int(m.group(1)[:n])]
            if name.endswith("kernel") and name.isidentifier():
                found.append((len(name), end, name))
    if not found:
        return mangled
    _, end, name = min(found)
    args = re.match(r"I(.*?)EE", mangled[end + len(name):])
    return f"{name}<{args.group(1)}>" if args else name


def ptxas_report(name: str, text: str):
    """The register, shared-memory and spill lines of one build's ptxas
    report, each with the kernel it belongs to."""
    kernel = "?"
    for line in text.splitlines():
        found = re.search(r"(?:entry function|Function properties for) '?(\w+)", line)
        if found:
            kernel = kernel_label(found.group(1))
        elif "registers" in line or "smem" in line or "spill" in line:
            log(f"ptxas[{name}] {kernel}: {line.strip()}")


def tensor_core_counts(name: str, kernels, op: str = "HMMA") -> dict:
    """Tensor-core instructions in each instantiation of ``kernels`` in
    the built library of ``csrc/<name>.cu``, counted in its
    ``cuobjdump -sass``: ``op`` HMMA (bf16; HGMMA for wgmma counts too),
    HGMMA (wgmma only) or IMMA (s8). Fails if any has none."""
    pattern = r"\bH(G)?MMA\b" if op == "HMMA" else rf"\b{op}\b"
    counts, fn = {}, None
    for line in _build.sass(name).splitlines():
        found = re.search(r"Function : (\w+)", line)
        if found:
            fn = kernel_label(found.group(1))
            if any(k in fn for k in kernels):
                counts[fn] = 0
        elif fn in counts and re.search(pattern, line):
            counts[fn] += 1
    log(json.dumps({"phase": "sass", "source": f"{name}.cu", "op": op,
                    "tensor_core_instructions": counts}))
    missing = [k for k in kernels if not any(k in fn for fn in counts)]
    if missing or min(counts.values()) == 0:
        raise AssertionError(f"{name}: no {op} instructions in some "
                             f"of {kernels}: {counts}")
    return counts


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    def elapsed(after: str) -> None:
        """Seconds since the start, after each part: where the script's
        time goes as it grows."""
        log(json.dumps({"phase": "elapsed", "after": after,
                        "seconds": time.perf_counter() - t_start}))

    card = card_line()
    log("card:", card, "| torch", torch.__version__, "cuda", torch.version.cuda)
    watch_governors()

    # Phase 1: build.
    t0 = time.perf_counter()
    secs = _build.build()
    log(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0,
                    "per_source_seconds": secs}))
    for name, text in _build.BUILD_LOGS.items():
        ptxas_report(name, text)
    # The bf16 kernels run on tensor cores: HMMA in their SASS; the
    # projections, the trunk leg, the fused kernel's trunk walk and the
    # suffix merge on wgmma (HGMMA); the bf16 int8 trunk leg's QK^T on
    # IMMA.
    tensor_core_counts("cascade_prefill",
                       ("cascade_mma_kernel", "prefix_wgmma_kernel",
                        "prefix_imma_kernel", "suffix_merge_kernel"))
    tensor_core_counts("cascade_prefill", ("prefix_wgmma_kernel",) + tuple(
        f"{k}<Li{hd}>" for k in ("cascade_mma_kernel", "suffix_merge_kernel")
        for hd in _build.TILE_HEAD_DIMS), op="HGMMA")
    tensor_core_counts("cascade_prefill", ("prefix_imma_kernel",), op="IMMA")
    tensor_core_counts("flash_attention", ("flash_mma_kernel",))
    tensor_core_counts("flash_attention", tuple(
        f"flash_wgmma_kernel<Li{hd}ELi{wg}>" for hd in (64, 128) for wg in (1, 2)),
        op="HGMMA")
    tensor_core_counts("row_gemm", ("row_gemm_kernel",), op="HGMMA")
    # The int8-KV attention's blocks of 8 rows or more: both products on
    # IMMA, at every head dim and query dtype.
    tensor_core_counts("kv_int8_attention", tuple(
        f"kv_int8_attention_kernel<Li{hd}E{t}Lb1>" for hd in KV8_HEAD_DIMS
        for t in ("f", "13__nv_bfloat16")), op="IMMA")
    elapsed("build")

    # Phase 3's shapes, planned up front.
    cfg = registry.llama2_7b()
    rt = RuntimeConfig(batch_size=BATCH)
    t0 = time.perf_counter()
    params = decoder.init_params(cfg, seed=0, device="cuda",
                                 dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(json.dumps({"phase": "init_params", "seconds": time.perf_counter() - t0,
                    "param_bytes": quant.param_bytes(params)}))
    tokenizer = FakeTokenizer(vocab=cfg.vocab_size)
    engine = ScoringEngine(params, cfg, tokenizer, rt, device="cuda")
    cells_trunk, cells_flat = legal_cells(True), legal_cells(False)
    plan_t = plan_shared(engine, cells_trunk, rt)
    plan_f = plan_shared(engine, cells_flat, rt)
    dtrunk = engine.decode_trunk_for(plan_t["prefix_rows"], BATCH,
                                     plan_t["bucket"])
    wm_len = max(len(tokenizer(format_base_prompt(q)).input_ids)
                 for q in WORD_MEANING_QUESTIONS)
    wm_T = tok.pick_bucket([wm_len], engine.buckets) + rt.max_new_tokens
    keys = ("bucket", "trunk", "T0", "T_spec")
    grids = sweep_grids(15)
    m_g, T_g = grouped_shape(engine, grids, rt)
    log(json.dumps({"phase": "plan", "cascade": {k: plan_t[k] for k in keys},
                    "dense": {k: plan_f[k] for k in keys},
                    "spec_decode_trunk": dtrunk, "word_meaning_T": wm_T,
                    "grouped_dispatch": {"member_rows": m_g, "T": T_g}}))
    if not plan_t["trunk"] or plan_f["trunk"] or dtrunk != plan_t["trunk"]:
        raise AssertionError(f"unexpected trunk plan {plan_t} / {plan_f}")

    # Phase 2: each kernel against its plain version on the card.
    warm_up()
    floor_ms = time_ms(empty_kernel)
    log(json.dumps({"phase": "timing_floor", "empty_kernel_ms": floor_ms}))
    gen = torch.Generator(device=DEV)
    gen.manual_seed(1234)
    results = []
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    T0, trunk = plan_t["T0"], plan_t["trunk"]
    check_decode(gen, "llama2-7b/cascade-dispatch", BATCH, H, K, hd, T0, trunk,
                 False, results)
    check_decode(gen, "llama2-7b/word-meaning", BATCH, H, K, hd, wm_T, 0,
                 False, results)
    check_decode(gen, "llama2-7b/dense-dispatch", BATCH, H, K, hd,
                 plan_f["T0"], 0, False, results)
    check_decode(gen, "llama2-7b/grouped-dispatch", m_g, H, K, hd, T_g, 0,
                 False, results)
    check_decode(gen, "mistral-7b/gqa", BATCH, 32, 8, 128, T0, trunk, False,
                 results)
    check_decode(gen, "falcon-7b/mqa", BATCH, 71, 1, 64, T0, trunk, False,
                 results)
    check_decode(gen, "bloom-7b1/alibi", BATCH, 32, 32, 128, T0, trunk, True,
                 results)
    S, Ts, Tf = rt.spec_k, plan_t["T_spec"], plan_f["T_spec"]
    # The untrunked spec dispatch has no trunk; its shape checks the trunk
    # kernel against the flat one at half its extent.
    check_decode_mq(gen, "llama2-7b/spec-dispatch", BATCH, S, H, K, hd, Tf,
                    DECODE_SPLIT * max(1, Tf // 2 // DECODE_SPLIT), False,
                    results)
    check_decode_mq(gen, "llama2-7b/spec-trunk-dispatch", BATCH, S, H, K, hd,
                    Ts, dtrunk, False, results)
    check_decode_mq(gen, "mistral-7b/gqa", BATCH, S, 32, 8, 128, Ts, dtrunk,
                    False, results)
    check_decode_mq(gen, "falcon-7b/mqa", BATCH, S, 71, 1, 64, Ts, dtrunk,
                    False, results)
    check_decode_mq(gen, "bloom-7b1/alibi", BATCH, S, 32, 32, 128, Ts, dtrunk,
                    True, results)
    R = plan_t["bucket"] - trunk
    check_cascade(gen, "llama2-7b/cascade-dispatch", BATCH, R, H, K, hd, trunk,
                  False, results)
    check_cascade(gen, "mistral-7b/gqa", BATCH, R, 32, 8, 128, trunk, False,
                  results)
    check_cascade(gen, "falcon-7b/mqa", BATCH, R, 71, 1, 64, trunk, False,
                  results)
    check_cascade(gen, "bloom-7b1/alibi", BATCH, R, 32, 32, 128, trunk, True,
                  results)
    check_prefix(gen, "llama2-7b/cascade-dispatch", BATCH, R, H, K, hd, trunk,
                 False, cfg.n_layers, results)
    check_prefix(gen, "mistral-7b/gqa", BATCH, R, 32, 8, 128, trunk, False,
                 32, results)
    check_prefix(gen, "falcon-7b/mqa", BATCH, R, 71, 1, 64, trunk, False,
                 32, results)
    check_prefix(gen, "bloom-7b1/alibi", BATCH, R, 32, 32, 128, trunk, True,
                 30, results)
    Sf = plan_f["bucket"]
    for label, S in (("word-meaning", wm_T - rt.max_new_tokens),
                     ("spec-dispatch", Sf), ("bucket-512", 512)):
        check_flash_attention(gen, f"llama2-7b/{label}", BATCH, S, H, K, hd,
                              False, results)
    check_flash_attention(gen, "mistral-7b/gqa", BATCH, Sf, 32, 8, 128, False,
                          results)
    check_flash_attention(gen, "falcon-7b/mqa", BATCH, Sf, 71, 1, 64, False,
                          results)
    check_flash_attention(gen, "bloom-7b1/alibi", BATCH, Sf, 32, 32, 128, True,
                          results)
    D, F_ = cfg.hidden_size, cfg.intermediate_size
    for M in sorted({BATCH, m_g, BATCH * rt.spec_k}):
        for name, K_, N_ in (("wq", D, H * hd), ("wk", D, K * hd),
                             ("wv", D, K * hd), ("wo", H * hd, D),
                             ("w_up", D, F_), ("w_gate", D, F_),
                             ("w_down", F_, D)):
            check_row_gemm(gen, f"llama2-7b/{name}/M{M}", M, K_, N_, results)
        check_row_norm(gen, f"llama2-7b/M{M}", M, D, floor_ms, results)
        check_row_add_norm(gen, f"llama2-7b/M{M}", M, D, floor_ms, results)
    check_row_add_norm(gen, "falcon-7b/M32", BATCH, 4544, floor_ms, results)
    check_stream_fold(gen, floor_ms, results)
    check_gumbel_argmax(gen, floor_ms, results)
    # The int8-KV attention at the cascade dispatch's extent: the decode
    # step, a verify window, a 16-token extension, GQA and ALiBi; at the
    # chain's extent and the flat grid's promoted tail, a decode step and
    # a verify window each; a GQA verify window (S * G > 16 rows a pair).
    Sv = rt.spec_k + 1
    for label, S_, H_, K_, T_, alibi in (
            ("llama2-7b/decode", 1, H, K, T0, False),
            ("llama2-7b/verify", Sv, H, K, T0, False),
            ("llama2-7b/extend16", 16, H, K, T0, False),
            ("mistral-7b/gqa", 1, 32, 8, T0, False),
            ("bloom-7b1/alibi", 1, 32, 32, T0, True),
            ("llama2-7b/chain-decode", 1, H, K, KV8_CHAIN_T, False),
            ("llama2-7b/chain-verify", Sv, H, K, KV8_CHAIN_T, False),
            ("llama2-7b/flat-tail-decode", 1, H, K, KV8_FLAT_TAIL_T, False),
            ("llama2-7b/flat-tail-verify", Sv, H, K, KV8_FLAT_TAIL_T, False),
            ("mistral-7b/gqa-verify", Sv, 32, 8, T0, False)):
        check_kv_int8_attention(gen, label, BATCH, S_, H_, K_, hd, T_, alibi,
                                results)
    check_kv_int8_row_invariance(gen, "llama2-7b/verify", H, K, hd, T0, Sv)
    check_kv_int8_row_invariance(gen, "mistral-7b/gqa-verify", 32, 8, 128,
                                 T0, Sv)
    elapsed("kernels_vs_plain")
    small = small_model()
    small_slice_check(*small)
    elapsed("small_slice")
    small_sweep_check(*small)
    elapsed("small_sweep")
    kv8_small_check(*small)
    elapsed("kv_int8_small")
    t5_small = t5_small_check()
    elapsed("t5_small")
    run_stream_stats_phase()
    elapsed("stream_stats")
    run_analysis_phase()
    elapsed("analysis")
    survey = run_survey_phase()
    elapsed("survey")
    verify_step_check(params, engine.cfg, rt.spec_k, "bf16",
                      measure_library=True)

    # Phase 3: the slice at full width through the engines.
    torch.cuda.reset_peak_memory_stats()
    stats, launches = run_slice(params, cfg, tokenizer, engine, cells_trunk,
                                cells_flat, rt)
    bf16_peak = torch.cuda.max_memory_allocated()
    log(json.dumps({"phase": "slice", "launches": launches,
                    "max_memory_allocated_bytes": bf16_peak}))
    for name, n in t5_small["decoder_capture"]["launches"].items():
        launches[name] += n
    profile_scoring(engine, rt)
    governor_check("bf16_slice", engine)
    elapsed("bf16_slice")
    # The sampling phase on the resident bf16 tree.
    sampling = run_sampling_phase(engine, small)
    for name, n in sampling["launches"].items():
        launches[name] += n
    governor_check("sampling", engine)
    elapsed("sampling")
    # The sweep phase: the three grids through run_perturbation_sweep.
    with tempfile.TemporaryDirectory() as tmp:
        sweeps = {"bf16": run_sweep_phase("bf16", engine, rt, grids,
                                          Path(tmp),
                                          trace_and_resume=True)}
        governor_check("bf16_sweep", engine)
        elapsed("bf16_sweep")
        # The prefix-cache phase, its rows held to the cache-off sweep's.
        prefix = run_prefix_cache_phase(
            engine, rt, grids, Path(tmp),
            sweeps["bf16"]["flat"]["max_memory_allocated_bytes"])
        governor_check("prefix_cache", engine)
        elapsed("prefix_cache")
        # Piggyback chains, then the int8 KV cache on the same weights.
        chain = run_chain_phase(engine, rt, Path(tmp))
        governor_check("chain", engine)
        elapsed("chain")
        kv8 = run_kv_int8_phase(
            engine, rt, grids, Path(tmp),
            sweeps["bf16"]["flat"]["max_memory_allocated_bytes"])
        governor_check("kv_int8", engine)
        elapsed("kv_int8")
    for st in (chain["on"], kv8["chain"], kv8["flat"]):
        for name, n in st["launches"].items():
            launches[name] += n
    # The loader phase, while phase 3's llama-2-7b params are resident.
    loader_stats = run_loader_phase(params, cfg)
    for name, n in loader_stats["launches"].items():
        launches[name] += n
    governor_check("loader_phase", engine)
    elapsed("loader_phase")
    # The fleet phase's parts (c) and (d) on phase 3's engine ((a) and (b)
    # ran inside the loader phase, on its checkpoints).
    fleet = loader_stats["fleet"]
    fleet["drafts"] = fleet_drafts(engine, cells_flat, rt)
    for st in fleet["drafts"].values():
        for name, n in st["launches"].items():
            launches[name] += n
    governor_check("fleet_drafts", engine)
    fleet["squeeze"] = squeeze_walk(engine, cells_flat, rt)
    log(json.dumps({"phase": "fleet", "card": card, **{
        f"sweep_{mode}": {k: st[k] for k in ("seconds", "rows_per_s",
                                             "max_memory_allocated_bytes")}
        | {k: st["fleet"][k] for k in ("swap_s_hidden", "swap_s_exposed",
                                        "loads", "prefetch_hits",
                                        "evictions")}
        for mode, st in fleet["sweeps"].items() if mode != "standalone"},
        "standalone": fleet["sweeps"]["standalone"],
        "staging_gb_per_s": fleet["staging"]["gb_per_s"],
        "drafts": {d: {"ms_per_dispatch": st["ms_per_dispatch"],
                       "draft_fleet": st["spec_stats"].get("draft_fleet", 0),
                       "accepted_fleet": st["spec_stats"].get(
                           "accepted_fleet", 0),
                       "flash_decode": st["launches"]["flash_decode"],
                       "flash_decode_mq": st["launches"]["flash_decode_mq"]}
                   for d, st in fleet["drafts"].items()},
        "squeeze_walk": fleet["squeeze"]["walk"]}))
    elapsed("fleet")
    # The guard phase and the serve phase on phase 3's params.
    with tempfile.TemporaryDirectory() as tmp:
        guard = run_guard_phase(engine, rt, grids, Path(tmp))
        for name, n in guard["launches"].items():
            launches[name] += n
        governor_check("guard", engine)
        elapsed("guard")
        serve = run_serve_phase(engine, rt, grids, Path(tmp),
                                prefix["control"]["bars"])
        for name, n in serve["off"]["launches"].items():
            launches[name] += n
        serve["cli"] = serve_cli_check(small, Path(tmp))
        governor_check("serve", engine)
        elapsed("serve")
        # The router phase and the fleet-serve phase on phase 3's params.
        serve_off = serve.pop("off_results")
        router = run_router_phase(engine, grids, serve_off,
                                  prefix["control"]["bars"])
        for name, n in router["a"]["launches"].items():
            launches[name] += n
        governor_check("router", engine)
        elapsed("router")
        # The migrate phase: disaggregated prefill and decode.
        migrate_stats = run_migrate_phase(engine, grids, serve_off,
                                          prefix["control"]["bars"])
        for name, n in migrate_stats["a"]["launches"].items():
            launches[name] += n
        migrate_stats["cli"] = serve_cli_migrate(small, Path(tmp))
        del serve_off
        governor_check("migrate", engine)
        elapsed("migrate")
        fleet_serve = run_fleet_serve_phase(engine, grids,
                                            prefix["control"]["bars"])
        for name, n in fleet_serve["serve"]["launches"].items():
            launches[name] += n
        fleet_serve["cli"] = serve_cli_router_fleet(small, Path(tmp))
        governor_check("fleet_serve", engine)
        elapsed("fleet_serve")
    survey["loader"] = loader_stats["survey"]
    survey["stream_accum"] = {name: sweeps["bf16"][name]["stream"][
        "survey_estimates"] for name in grids}
    log(json.dumps({"phase": "survey", **survey}))
    stats8, bytes8, peak8, sweeps["int8"] = run_int8_slice(
        cfg, tokenizer, cells_trunk, cells_flat, rt, grids)
    governor_check("int8_slice_and_sweep", engine)
    elapsed("int8_slice_and_sweep")
    run_t5_phase()
    governor_check("t5", engine)
    elapsed("t5")
    prefix["int8_trunk"] = sweeps["int8"].pop("prefix_cache_trunk")
    prefix_launches = [st["launches"] for name in grids
                       for st in (prefix[name]["cold"], prefix[name]["warm"])]
    prefix_launches += [prefix["tight_pool"][p]["launches"]
                        for p in ("cold", "warm")]
    prefix_launches.append(prefix["int8_trunk"]["cold"]["launches"])
    phase_launches = {}
    for counts in prefix_launches:
        for name, n in counts.items():
            launches[name] += n
            phase_launches[name] = phase_launches.get(name, 0) + n
    log(json.dumps({"phase": "prefix_cache", **prefix_summary(prefix),
                    "launches": phase_launches}))
    for st in list(stats8.values()) + [
            st for kind in sweeps.values() for st in kind.values()]:
        for name, n in st.get("launches", {}).items():
            launches[name] += n
    log(json.dumps({"phase": "sweep_summary", **{
        f"{kind}/{name}": {k: st[k] for k in ("cells", "rows_per_s", "plan",
                                              "occupancy_pct",
                                              "max_memory_allocated_bytes")}
        for kind, by_grid in sweeps.items()
        for name, st in by_grid.items() if name in grids}}))
    log(json.dumps({
        "phase": "int8_vs_bf16",
        "param_bytes": {"bf16": quant.param_bytes(params),
                        "int8": bytes8},
        "max_memory_allocated_bytes": {"bf16_phases": bf16_peak,
                                       "int8_phases_both_param_sets": peak8},
        "rows_per_s": {
            "word_meaning": [stats["word_meaning"]["rows_per_s"],
                             stats8["int8_word_meaning"]["rows_per_s"]],
            "cascade_dispatch": [stats["cascade_dispatch"]["rows_per_s"],
                                 stats8["int8_cascade_dispatch"]["rows_per_s"]],
            "spec_dispatch": [stats["spec_dispatch"]["rows_per_s"],
                              stats8["int8_spec_dispatch"]["rows_per_s"]]},
        "ms_per_dispatch": {
            "cascade_dispatch": [stats["cascade_dispatch"]["ms_per_dispatch"],
                                 stats8["int8_cascade_dispatch"]["ms_per_dispatch"]],
            "spec_dispatch": [stats["spec_dispatch"]["ms_per_dispatch"],
                              stats8["int8_spec_dispatch"]["ms_per_dispatch"]]},
        "order": ["bf16", "int8"]}))
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")

    # Summary: each kernel at its main-path shape.
    kernels = []
    for name, (source, replaces, case) in SOURCES.items():
        rows = [r for r in results if r["kernel"] == name]
        main_row = next(r for r in rows if r["case"] == case)
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=main_row["kernel_ms"], plain_ms=main_row["plain_ms"],
            bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
            library_ms=main_row["library_ms"]))
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, quant.QuantTensor):
        return quant.QuantTensor(q=tree.q.to(device),
                                 scale=tree.scale.to(device),
                                 dynamic=tree.dynamic)
    return tree.to(device)


if __name__ == "__main__":
    sys.exit(main())
