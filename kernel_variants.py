"""Time source variants of a kernel in one process on one card: what holds
it back, and the design choices its source note states.

    python3 kernel_variants.py [--variants base,loads_only,...]
    python3 kernel_variants.py --kernel suffix_merge_template --csrc DIR
    python3 kernel_variants.py --kernel kv_int8
    python3 kernel_variants.py --kernel gumbel_argmax [--csrc DIR]
    python3 kernel_variants.py --kernel stream_fold [--csrc DIR]

Each variant is a copy of a ``csrc`` directory with one or more text
substitutions (the tables below), built with the flags of
``lir_tpu_torch/ops/_build.py`` into ``build/kernel_variants/`` (one nvcc
each, all at once) and called in bf16 through its C entry at B = 32.

- ``flash`` (the default; the checkout's sources): the prefill flash
  kernel's wgmma route, ``flash_wgmma_kernel``. The products skipped
  (loads, barriers and stores alone), the items taken head-fastest one
  by one instead of by (batch row, head) group, and one or two consumer
  warpgroups a block at every length instead of the split at four query
  tiles; at llama-2-7b buckets 64, 128 and 512, mistral-7b (GQA) and
  falcon-7b (MQA, head dim 64) at bucket 128 (rows left-padded as
  chip_smoke pads them). SDPA with the same mask is timed beside them.
- ``suffix_merge_template`` (``--csrc``: a copy of the sources with the suffix
  merge as ``cascade_mma_kernel<HD, false>``, e.g. an earlier commit's
  ``lir_tpu_torch/csrc`` unpacked with ``git archive``): the two-leg
  suffix leg + merge in pieces. The trunk partials' read skipped, the
  window products skipped (the window loads alone), and the Q load alone
  (no window walk, no partials: the Q tile, the row statistics and the
  output store); at the cascade dispatch's shape (llama-2-7b, R = 80,
  ragged windows as chip_smoke makes them), mistral-7b (GQA) and
  falcon-7b (MQA).
- ``kv_int8``: the int8-KV cached attention (B-1,
  ``kv_int8_attention_kernel``; bf16 queries, the cache
  quantized per vector as ``chip_smoke.kv8_inputs`` makes it): IMMA from
  2 query rows a block instead of 8, and three IMMA blocks an SM (no
  register spills) instead of four; and the base library launched with
  T split into 1, 2, 3, 4 or 8 blocks a cluster instead of the plan's
  (``split<n>``; the split moves the sum's order, within ``tie_bar``); at
  llama-2-7b's decode step, verify window and 16-token extension at 552
  slots, mistral-7b's GQA step and verify window, and the chain's (156)
  and the flat tail's (1,088) extents.

- ``gumbel_argmax``: the sampler (N7, ``gumbel_argmax_kernel``) at V =
  32,000, B = 1, 8, 32 and 64 (one key; B = 8 also a key a row): a
  cluster launch of the grid alone, the scores alone (no warp, cluster or
  id reduction), the reduction alone (made-up scores, no loads, no
  threefry), the warps' slots by plain remote stores and a cluster
  barrier instead of ``st.async`` on an mbarrier, 1, 2 and 8 entries a
  thread instead of 4, four scalar loads instead of one 16-byte load,
  512 and 1,024 threads a block instead of 256, and each of the base,
  512- and 1,024-thread libraries launched in clusters of 2, 4, 8 and 16
  blocks instead of the plan's (``<variant>/cluster<n>``). With ``--csrc
  DIR`` (an earlier copy of the sources, e.g. PR 17's
  ``lir_tpu_torch/csrc`` unpacked with ``git archive``) its last-block
  ticket design runs beside them (``earlier``), through a copy of that
  commit's wrapper (two scratch tensors and the per-device tickets).
  Each variant's ids against the plain twin's (rows that differ: the
  three that skip work differ by design), the empty kernel's time, and
  the host microseconds of a wrapper call (``chip_smoke.host_us``) of
  the port's wrapper and of the earlier one.
- ``stream_fold``: the fold (N6, ``stream_fold_kernel``, one warp a
  row) at a (5, 2,000) lattice, K = 20, B = 32 and 64, contiguous and
  strided readouts; with ``--csrc DIR`` the earlier source's kernel (one
  thread a row) beside it (``earlier``). Lattices bitwise the plain
  twin's or not.

Timed by ``chip_smoke.time_ms`` (L2 flushed, device time) in turns (the
variants, then in reverse). Each variant's largest difference against
the plain version is printed (the variants that skip work are wrong by
design). Ends with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

import chip_smoke as cs
from lir_tpu_torch import ops
from lir_tpu_torch.engine import stream_stats
from lir_tpu_torch.ops import _build
from lir_tpu_torch.ops import sample as sample_mod
from lir_tpu_torch.ops.kv_int8_attention import kv_int8_attention_plain
from lir_tpu_torch.ops.kv_int8_attention import plan as kv8_plan

FA = "flash_attention.cu"
CP = "cascade_prefill.cu"
KV = "kv_int8_attention.cu"
SA = "sample.cu"
_BY_LENGTH = ("return a.S > 3 * am::kKeys ? launch_wgmma<HD, 2>(a, st) : "
              "launch_wgmma<HD, 1>(a, st);")
# name -> [(file, old text, new text), ...] in the variant's csrc copy.
FLASH_VARIANTS = {
    "base": [],
    # The products skipped: loads, the walk's barriers, stores.
    "loads_only": [(FA, "        aw::tile_step<HD, false>(q, kt,",
                    "        if (p.S < 0) aw::tile_step<HD, false>(q, kt,")],
    # Items of the list taken one by one, the head fastest (no group reuse).
    "head_fastest": [(FA, """  const int g = blockIdx.x + (j / per) * gridDim.x;
  if (g >= p.B * p.H) return false;
  it = {g / p.H, g % p.H, (per - 1 - j % per) * kWG * am::kKeys};""",
                      """  const int i = blockIdx.x + j * gridDim.x;
  if (i >= per * p.B * p.H) return false;
  const int r = i / p.H;
  it = {r % p.B, i - r * p.H, (per - 1 - r / p.B) * kWG * am::kKeys};""")],
    "one_wg_everywhere": [(FA, _BY_LENGTH, "return launch_wgmma<HD, 1>(a, st);")],
    "two_wg_everywhere": [(FA, _BY_LENGTH, "return launch_wgmma<HD, 2>(a, st);")],
}
_TEMPLATE_PARTIALS = ("        if (ot_row[h] != nullptr) o_t = *reinterpret_cast<const float2*>"
                 "(ot_row[h] + 8 * j);")
_TEMPLATE_WALK = ("  am::key_loop<HD, true, kSt>(ring, (n_win + am::kKeys - 1) / am::kKeys, "
             "active, key, fix,")
# The variants that skip work keep one of the two partials of the merge
# nonzero: with both zero every division of the merge would take the
# slow path of __fdiv_rn (a zero dividend), which the real inputs never do.
SUFFIX_MERGE_TEMPLATE_VARIANTS = {
    "base": [],
    # The trunk partials (o_t) never read: o_t = 0 in the merge.
    "no_partials": [(CP, _TEMPLATE_PARTIALS, "")],
    # The window walk's products skipped: its loads and barriers alone.
    "no_products": [("attn_mma.cuh", """    if (active) {
      float s[8][4];
      qk_tile<HD>""", """    if (active && n_tiles < 0) {
      float s[8][4];
      qk_tile<HD>""")],
    # No window walk: the Q tile's load, the row statistics, the partials'
    # read, the merge and the output store.
    "no_walk": [(CP, _TEMPLATE_WALK, "  am::key_loop<HD, true, kSt>(ring, 0, active, key, fix,")],
}
_STAGED = "      // The warp's 16 rows staged as bf16 over their own stash rows (read"
_OWN_READ = " " * 23 + "return *reinterpret_cast<const float2*>(own + 8 * h"
SUFFIX_MERGE_VARIANTS = {
    "base": [],
    # The trunk partials never copied nor read: o_t = 0 in the merge.
    "no_partials": [(CP, "uint32_t(min(64, N - n0)) * HD * 4);",
                     "uint32_t(min(64, N - n0)) * 0);"),
                    (CP, "      for (int r = lane; r < 64 && n0 + r < N; r += 32)\n"
                         "        hp::bulk_load",
                     "      for (int r = lane; r < 0; r += 32)\n        hp::bulk_load"),
                    (CP, _OWN_READ, " " * 23 + "return make_float2(0.f, 0.f);\n" + _OWN_READ)],
    # The window products skipped: the tiles' loads and barriers alone.
    "no_products": [(CP, "      aw::tile_step<HD, true>(qs, kt, kt + W::kTile,",
                     "      if (n0 < 0) aw::tile_step<HD, true>(qs, kt, kt + W::kTile,")],
    # No window tiles: the Q tiles' loads, the row statistics, the
    # partials' copies, the merge and the output store.
    "no_walk": [(CP, "      const int n_tiles = (window_rows(a, n0, b_lo) + am::kKeys - 1)"
                     " / am::kKeys;",
                 "      const int n_tiles = 0 * window_rows(a, n0, b_lo);"),
                (CP, "    const int n_tiles = (n_win + am::kKeys - 1) / am::kKeys;\n"
                     "    const WindowFix",
                 "    const int n_tiles = 0;\n    const WindowFix")],
    # The output by each lane's stores instead of bulk copies of staged rows.
    "lane_stores": [(CP, _STAGED,
                     "      store_out<HD>(a, lr, kh, acc);\n      if (N < 0)\n" + _STAGED)],
    # One block an SM (hd >= 80: two at hd <= 64), two slots and three stages:
    # the next item's Q and partials loaded a whole item ahead.
    "two_slots": [(CP, "  static constexpr int kSlots = 1;\n  static constexpr int kStages = 2;\n"
                       "  static constexpr int kBlocksPerSM = HD <= 64 ? 3 : 2;",
                   "  static constexpr int kSlots = 2;\n  static constexpr int kStages = 3;\n"
                   "  static constexpr int kBlocksPerSM = HD <= 64 ? 2 : 1;")],
    # Items taken tile-fastest (each kv head's row tiles in turn) instead of
    # kv-head-fastest.
    "tile_fastest": [(CP, "  kh = i % wa.a.K;\n  n0 = (i / wa.a.K) * 64;",
                      "  const int tiles = wa.n_items / wa.a.K;\n  kh = i / tiles;\n"
                      "  n0 = (i % tiles) * 64;")],
    # One item a block (grid = items) instead of as many blocks as fit.
    "one_item_a_block": [(CP, "  const int grid = items < grid_max ? int(items) : grid_max;",
                          "  const int grid = int(items);")],
}
KV8_VARIANTS = {
    "base": [],
    # Both products on IMMA from 2 query rows a block (padded to 16).
    "imma_from_2": [(KV, "constexpr int kMmaRows = 8;", "constexpr int kMmaRows = 2;")],
    # Three IMMA blocks an SM (85 registers) instead of four (64, spills).
    "imma_3_an_sm": [(KV, "MMA ? 4 : 8)", "MMA ? 3 : 8)")],
}
# The base library's launches with T split into this many blocks.
KV8_SPLITS = (1, 2, 3, 4, 8)
# (case, S, query heads, kv heads, T) at B = 32, head dim 128.
KV8_SHAPES = [("llama-2-7b/decode", 1, 32, 32, 552), ("llama-2-7b/verify", 5, 32, 32, 552),
              ("llama-2-7b/extend16", 16, 32, 32, 552), ("mistral-7b/gqa", 1, 32, 8, 552),
              ("mistral-7b/gqa-verify", 5, 32, 8, 552),
              ("llama-2-7b/chain-decode", 1, 32, 32, 156),
              ("llama-2-7b/flat-tail-decode", 1, 32, 32, 1088),
              ("llama-2-7b/flat-tail-verify", 5, 32, 32, 1088)]
_SCAN = "  scan_units(row, head, u0, min(units, u0 + per), temp, k0, k1, off, bv, bi);"
_REDUCE = "  cluster_best(bv, bi, rank, sl, ids + b);"
SAMPLE_VARIANTS = {
    "base": [],
    # A cluster launch of the grid and nothing else.
    "launch_only": [(SA, "  __shared__ Slots sl;\n", "  if (V > 0) return;\n  __shared__ Slots sl;\n")],
    # The scores and each thread's best, no reduction and no barrier.
    "compute_only": [(SA, _REDUCE, "  if (bi == -2) ids[b] = __float_as_int(bv);"),
                     (SA, "  hp::cluster_arrive_relaxed();\n  const int b", "  const int b")],
    # The warp and cluster reduction of made-up scores: no loads, no threefry.
    "reduction_only": [(SA, _SCAN, "  bv = (float)((threadIdx.x * 37 + rank) % 101);\n"
                                   "  bi = u0 * kPerThread + threadIdx.x;"),
                       (SA, "  if (rank == 0 && t < head)", "  if (rank < 0)"),
                       (SA, "  if (rank == 0 && t < tail) {", "  if (rank < 0) {")],
    # The slots by plain remote stores and a cluster barrier.
    "sync_slots": [(SA, "constexpr bool kAsyncSlots = true;", "constexpr bool kAsyncSlots = false;")],
    "entries1": [(SA, "constexpr int kPerThread = 4;", "constexpr int kPerThread = 1;")],
    "entries2": [(SA, "constexpr int kPerThread = 4;", "constexpr int kPerThread = 2;")],
    "entries8": [(SA, "constexpr int kPerThread = 4;", "constexpr int kPerThread = 8;")],
    "scalar_loads": [(SA, "constexpr bool kVectorLoads = true;",
                      "constexpr bool kVectorLoads = false;")],
    "threads512": [(SA, "constexpr int kThreads = 256;", "constexpr int kThreads = 512;")],
    "threads1024": [(SA, "constexpr int kThreads = 256;", "constexpr int kThreads = 1024;")],
}
# These variants' launches in clusters of this many blocks.
SAMPLE_CLUSTERS = (2, 4, 8, 16)
SAMPLE_CLUSTER_VARIANTS = ("base", "threads512", "threads1024")
# (B, V, a key a row) of the sampler's shapes.
SAMPLE_SHAPES = [(1, 32000, False), (8, 32000, False), (8, 32000, True),
                 (32, 32000, False), (64, 32000, False)]
FOLD_VARIANTS = {"base": []}
# (B, strided) of the fold's shapes, on chip_smoke's (5, 2,000) lattice, K = 20.
FOLD_SHAPES = [(32, False), (32, True), (64, False), (64, True)]
# The kernels whose --csrc is an earlier copy built beside the variants,
# under this name.
EARLIER_KERNELS = ("gumbel_argmax", "stream_fold")
EARLIER = "earlier"
# kernel -> (library, variant table, default sources)
KERNELS = {"flash": ("flash_attention", FLASH_VARIANTS, _build.CSRC),
           "suffix_merge": ("cascade_prefill", SUFFIX_MERGE_VARIANTS, _build.CSRC),
           "suffix_merge_template": ("cascade_prefill", SUFFIX_MERGE_TEMPLATE_VARIANTS, None),
           "kv_int8": ("kv_int8_attention", KV8_VARIANTS, _build.CSRC),
           "gumbel_argmax": ("sample", SAMPLE_VARIANTS, _build.CSRC),
           "stream_fold": ("stream_fold", FOLD_VARIANTS, _build.CSRC)}
_ARGTYPES = {
    "flash_attention": {"lir_flash_attention": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                        + [ctypes.c_void_p]},
    "cascade_prefill": {"lir_cascade_suffix_merge": [ctypes.c_void_p] * 10
                        + [ctypes.c_int] * 6 + [ctypes.c_void_p]},
    "kv_int8_attention": {"lir_kv_int8_attention": [
        ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p, ctypes.c_int64] * 4
        + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_float]
        + [ctypes.c_void_p] * 3},
    "stream_fold": {"lir_stream_fold": [
        ctypes.c_void_p, ctypes.c_int64] * 3 + [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                                                 ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                                 ctypes.c_int] + [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]},
    # The sampler's two C entries (this source's and PR 17's) differ: set per call.
    "sample": {},
}
# (model, query heads, kv heads, head dim, buckets) of the flash shapes at
# B = 32: llama-2-7b at the three buckets, GQA and MQA at bucket 128.
SHAPES = [("llama-2-7b", 32, 32, 128, (64, 128, 512)), ("mistral-7b", 32, 8, 128, (128,)),
          ("falcon-7b", 71, 1, 64, (128,))]
# (model, query heads, kv heads, head dim) of the suffix-merge shapes at
# B = 32, R = 80 (the cascade dispatch's remainder window).
CASCADE_SHAPES = [("llama-2-7b", 32, 32, 128), ("mistral-7b", 32, 8, 128),
                  ("falcon-7b", 71, 1, 64)]


def build(kernel, names, csrc: Path, earlier: Path = None):
    """Each variant's library of ``kernel``, loaded; with ``earlier``,
    also that copy's library as it is, under ``EARLIER``."""
    lib_name, table, _ = KERNELS[kernel]
    root = Path(_build.BUILD_DIR).parent / "kernel_variants" / kernel
    jobs = {name: (csrc, table[name]) for name in names}
    if earlier is not None:
        jobs[EARLIER] = (earlier, [])
    names = list(jobs)
    for name in names:  # every copy made before any compile starts
        d = root / name
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(jobs[name][0], d)
        for file, old, new in jobs[name][1]:
            text = (d / file).read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old[:60]!r} not found once in {file}")
            (d / file).write_text(text.replace(old, new))
    procs = {}
    for name in names:
        d = root / name
        out = d / f"lib{lib_name}.so"
        procs[name] = (out, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(d / f"{lib_name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        lib = ctypes.CDLL(str(out))
        for fn, types in _ARGTYPES[lib_name].items():
            getattr(lib, fn).argtypes = types
        libs[name] = lib
    return libs


def in_turns(row, names, run, out, ref):
    """Each variant's error against ``ref`` and its times, the variants
    in order and then in reverse."""
    for name in names + names[::-1]:
        run(name)
        torch.cuda.synchronize()
        row["max_abs_err"][name] = float((out.float() - ref.float()).abs().max())
        row["ms"].setdefault(name, []).append(cs.time_ms(lambda: run(name), iters=20))


def flash_shapes(gen, libs, names, summary):
    B = cs.BATCH
    for model, H, K, hd, S in [(m, h, k, d, S) for m, h, k, d, ss in SHAPES for S in ss]:
        q = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn((B, S, K, hd), generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        mask = torch.ones((B, S), dtype=torch.int32, device="cuda")
        for b in range(B):
            mask[b, :(b * 7) % max(S // 2, 1)] = 0
        out = torch.empty_like(q)
        ref = ops.flash_attention_plain(q, k, v, mask)

        def run(name):
            _build.check(libs[name].lir_flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), None, None,
                out.data_ptr(), B, S, H, K, hd, 1, torch.cuda.current_stream().cuda_stream),
                "flash_attention")

        idx = torch.arange(S, device="cuda")
        allowed = (mask[:, None, :] > 0) & (idx[None, None, :] <= idx[None, :, None])
        bias = torch.where(allowed[:, None], 0.0, float("-inf")).to(torch.bfloat16)
        qh = q.permute(0, 2, 1, 3)
        kh, vh = cs._sdpa_kv(k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3), H // K)

        def sdpa():
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias,
                                                  **cs._gqa(K != H))

        row = {"model": model, "S": S, "sdpa_ms": cs.time_ms(sdpa, iters=20), "ms": {},
               "max_abs_err": {}}
        in_turns(row, names, run, out, ref)
        print(json.dumps(row), flush=True)
        key = f"{model}/S{S}"
        summary[key] = {n: sum(m) / len(m) for n, m in row["ms"].items()}
        summary[key]["sdpa"] = row["sdpa_ms"]


def suffix_merge_shapes(gen, libs, names, summary, R=80, Tt=432):
    B = cs.BATCH
    bf = torch.bfloat16
    for model, H, K, hd in CASCADE_SHAPES:
        rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(bf)
        q, sk, sv = rnd(B, R, H, hd), rnd(B, R, K, hd), rnd(B, R, K, hd)
        tk, tv = rnd(K, Tt, hd), rnd(K, Tt, hd)
        mask = torch.ones((B, R), dtype=torch.int32, device="cuda")
        for b in range(B):
            mask[b, R - (b * 5) % R:] = 0       # ragged right-padded windows
        qpos = (Tt + torch.clamp_min(torch.cumsum(mask, -1, dtype=torch.int32) - 1,
                                     0)).to(torch.int32)
        o_t, m_t, l_t = ops.cascade_prefix(q, tk, tv)
        out = torch.empty_like(q)
        ref = ops.suffix_merge_plain(q, sk, sv, o_t, m_t, l_t, mask, qpos)

        def run(name):
            _build.check(libs[name].lir_cascade_suffix_merge(
                q.data_ptr(), sk.data_ptr(), sv.data_ptr(), o_t.data_ptr(), m_t.data_ptr(),
                l_t.data_ptr(), mask.data_ptr(), qpos.data_ptr(), None, out.data_ptr(),
                B, R, H, K, hd, 1, torch.cuda.current_stream().cuda_stream),
                "cascade_suffix_merge")

        row = {"model": model, "R": R, "ms": {}, "max_abs_err": {}}
        in_turns(row, names, run, out, ref)
        print(json.dumps(row), flush=True)
        summary[f"{model}/R{R}"] = {n: sum(m) / len(m) for n, m in row["ms"].items()}


def kv8_shapes(gen, libs, names, summary):
    B, hd = cs.BATCH, 128
    for label, S, H, K, T in KV8_SHAPES:
        args, _ = cs.kv8_inputs(gen, B, S, H, K, hd, T, False)
        q, kq, ks, vq, vs, qpos, mask, kpos = args
        out = torch.empty((B, S, H * hd), dtype=q.dtype, device="cuda")
        ref = kv_int8_attention_plain(*args)
        plan = kv8_plan(T, hd, S * (H // K))

        def run(name):
            lib, pl = libs.get(name, libs.get("base")), plan
            if name.startswith("split"):
                splits = int(name[5:])
                pl = plan._replace(splits=splits, slice=-(-(-(-T // splits)) // 8) * 8)
            _build.check(lib.lir_kv_int8_attention(
                q.data_ptr(), 1, kq.data_ptr(), kq.stride(0), ks.data_ptr(), ks.stride(0),
                vq.data_ptr(), vq.stride(0), vs.data_ptr(), vs.stride(0), qpos.data_ptr(),
                mask.data_ptr(), kpos.data_ptr(), None, B, S, H, K, T, hd, pl.rows,
                pl.splits, pl.slice, math.sqrt(hd), out.data_ptr(), None,
                torch.cuda.current_stream().cuda_stream), "kv_int8_attention")

        row = {"case": label, "T": T, "plan_splits": plan.splits, "ms": {},
               "max_abs_err": {}}
        in_turns(row, names + [f"split{n}" for n in KV8_SPLITS if "base" in libs], run,
                 out, ref)
        print(json.dumps(row), flush=True)
        summary[label] = {n: sum(m) / len(m) for n, m in row["ms"].items()}


def _earlier_sample(lib, sms):
    """PR 17's wrapper over its library (``--csrc``): its chunk plan, two
    scratch tensors a call and the per-device ticket counters."""
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.lir_gumbel_argmax.argtypes = [p, q, i, i, p, p, ctypes.c_float, i, i, p, p, p, p, p]
    lib.lir_sample_threads.restype = i
    threads = lib.lir_sample_threads()
    tickets = torch.zeros(64, dtype=torch.int32, device="cuda")

    def call(logits, keys, offsets, temperature, ids):
        B, V = logits.shape
        want = max(1, -(-2 * sms // B))
        chunks = max(1, min(want, -(-V // threads)))
        chunk = -(-V // chunks)
        nchunks = -(-V // chunk)
        part_v = torch.empty(B * nchunks, dtype=torch.float32, device="cuda")
        part_i = torch.empty(B * nchunks, dtype=torch.int32, device="cuda")
        _build.check(lib.lir_gumbel_argmax(
            logits.data_ptr(), logits.stride(0), B, V, keys.data_ptr(), offsets.data_ptr(),
            sample_mod.temperature32(temperature), nchunks, chunk, part_v.data_ptr(),
            part_i.data_ptr(), tickets.data_ptr(), ids.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "gumbel_argmax (earlier)")

    return call


def sample_shapes(gen, libs, names, summary):
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    runs = {}
    for name, lib in libs.items():
        if name == EARLIER:
            runs[name] = _earlier_sample(lib, sms)
            continue
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.lir_gumbel_argmax.argtypes = [p, q, i, i, p, p, ctypes.c_float, i, i, p, p]

        def call(logits, keys, offsets, temperature, ids, _lib=lib, _name=name,
                 cluster=None):
            B, V = logits.shape
            pl = sample_mod.plan(B, V, sms)
            if cluster is not None:
                al = sample_mod.SLICE_ALIGN
                pl = sample_mod.Plan(cluster, -(-(-(-V // cluster)) // al) * al, B * cluster)
            _build.check(_lib.lir_gumbel_argmax(
                logits.data_ptr(), logits.stride(0), B, V, keys.data_ptr(), offsets.data_ptr(),
                sample_mod.temperature32(temperature), pl.cluster, pl.slice, ids.data_ptr(),
                torch.cuda.current_stream().cuda_stream), f"gumbel_argmax ({_name})")

        runs[name] = call
    for name in [n for n in SAMPLE_CLUSTER_VARIANTS if n in runs]:
        for n in SAMPLE_CLUSTERS:
            runs[f"{name}/cluster{n}"] = functools.partial(runs[name], cluster=n)
    order = list(runs)
    for B, V, per_row in SAMPLE_SHAPES:
        logits, keys, offsets = cs.sample_inputs(gen, B, V, per_row)
        ref = sample_mod.gumbel_argmax_plain(logits, keys, offsets, 0.9)
        ids = torch.empty(B, dtype=torch.int32, device="cuda")
        label = f"B{B}/V{V}/{'per_row' if per_row else 'one_key'}"
        row = {"case": label, "plan": sample_mod.plan(B, V, sms)._asdict(), "ms": {},
               "rows_differing": {}}
        for name in order + order[::-1]:
            run = functools.partial(runs[name], logits, keys, offsets, 0.9, ids)
            ids.fill_(-1)
            run()
            torch.cuda.synchronize()
            row["rows_differing"][name] = int((ids != ref).sum())
            row["ms"].setdefault(name, []).append(cs.time_ms(run, iters=20))
        row["floor_ms"] = cs.time_ms(cs.empty_kernel, iters=20)
        row["host_us"] = {"port_wrapper": cs.host_us(
            lambda: ops.gumbel_argmax(logits, keys, offsets, 0.9))}
        if EARLIER in runs:
            row["host_us"]["earlier_wrapper"] = cs.host_us(functools.partial(
                runs[EARLIER], logits, keys, offsets, 0.9, ids))
        print(json.dumps(row), flush=True)
        summary[label] = {n: sum(m) / len(m) for n, m in row["ms"].items()}
        summary[label]["floor"] = row["floor_ms"]


def fold_shapes(gen, libs, names, summary):
    P, R, K = cs.STREAM_P, cs.STREAM_R, cs.STREAM_K
    for B, strided in FOLD_SHAPES:
        yes, no, wc, lp, pidx, ridx = cs.fold_inputs(gen, B, K, P, R)
        if strided:
            yes, no, wc = (torch.stack([t, t], 1)[:, 0] for t in (yes, no, wc))
            lp = torch.stack([lp, lp], 1)[:, 0]
        ref = stream_stats.new_accum(P, R, "cuda")
        ops.stream_fold_plain(ref, yes, no, wc, lp, pidx, ridx, True)
        label = f"{P}x{R}/B{B}/{'strided' if strided else 'contiguous'}"
        row = {"case": label, "ms": {}, "bitwise": {}}
        for name in list(libs) + list(libs)[::-1]:
            acc = stream_stats.new_accum(P, R, "cuda")

            def run(lib=libs[name], acc=acc):
                _build.check(lib.lir_stream_fold(
                    yes.data_ptr(), yes.stride(0), no.data_ptr(), no.stride(0), wc.data_ptr(),
                    wc.stride(0), lp.data_ptr(), lp.stride(0), lp.stride(1), K,
                    pidx.data_ptr(), ridx.data_ptr(), B, acc["filled"].data_ptr(),
                    acc["rel"].data_ptr(), acc["conf"].data_ptr(), acc["dec"].data_ptr(), P, R,
                    1, torch.cuda.current_stream().cuda_stream), f"stream_fold ({name})")

            run()
            torch.cuda.synchronize()
            got, want = cs.lattice_bits(acc), cs.lattice_bits(ref)
            row["bitwise"][name] = all(torch.equal(got[k], want[k]) for k in got)
            row["ms"].setdefault(name, []).append(cs.time_ms(run, iters=20))
        row["floor_ms"] = cs.time_ms(cs.empty_kernel, iters=20)
        print(json.dumps(row), flush=True)
        summary[label] = {n: sum(m) / len(m) for n, m in row["ms"].items()}
        summary[label]["floor"] = row["floor_ms"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="flash")
    ap.add_argument("--csrc", type=Path, default=None,
                    help="the sources the variants are made from (gumbel_argmax, "
                         "stream_fold: an earlier copy timed beside them)")
    ap.add_argument("--variants", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device; nothing measured", file=sys.stderr)
        return 1
    _, table, default_csrc = KERNELS[args.kernel]
    names = args.variants.split(",") if args.variants else list(table)
    if args.kernel in EARLIER_KERNELS:  # the variants from the checkout, --csrc beside
        libs = build(args.kernel, names, default_csrc, earlier=args.csrc)
    else:
        csrc = args.csrc or default_csrc
        if csrc is None:
            ap.error(f"--kernel {args.kernel} needs --csrc")
        libs = build(args.kernel, names, csrc)
    cs.warm_up()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    summary = {}
    if args.kernel == "flash":
        flash_shapes(gen, libs, names, summary)
    elif args.kernel == "kv_int8":
        kv8_shapes(gen, libs, names, summary)
    elif args.kernel == "gumbel_argmax":
        sample_shapes(gen, libs, names, summary)
    elif args.kernel == "stream_fold":
        fold_shapes(gen, libs, names, summary)
    else:
        suffix_merge_shapes(gen, libs, names, summary)
    print(json.dumps({"mean_ms": summary}), flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
