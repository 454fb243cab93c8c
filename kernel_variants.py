"""Time source variants of the prefill flash kernel's wgmma route in one
process on one card: what holds ``flash_wgmma_kernel`` back, and the two
design choices its source note states.

    python3 kernel_variants.py [--variants base,loads_only,...]

Each variant is a copy of ``lir_tpu_torch/csrc`` with one text
substitution (VARIANTS below): the products skipped (loads, barriers and
stores alone), the items taken head-fastest one by one instead of by
(batch row, head) group, and one or two consumer warpgroups a block at
every length instead of the split at four query tiles. Each is built with
the flags of ``lir_tpu_torch/ops/_build.py`` into
``build/kernel_variants/`` (one nvcc each, all at once) and called in
bf16 through its C entry at B = 32: llama-2-7b at buckets 64, 128 and 512,
mistral-7b (GQA) and falcon-7b (MQA, head dim 64) at bucket 128 (rows
left-padded as chip_smoke pads them). Timed by ``chip_smoke.time_ms`` (L2
flushed, device time) in turns (the variants, then in reverse); SDPA with
the same mask is timed beside them. Each variant's largest difference
against the plain version is printed (loads_only is wrong by design).
Ends with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

import chip_smoke as cs
from lir_tpu_torch import ops
from lir_tpu_torch.ops import _build

FA = "flash_attention.cu"
_BY_LENGTH = ("return a.S > 3 * am::kKeys ? launch_wgmma<HD, 2>(a, st) : "
              "launch_wgmma<HD, 1>(a, st);")
# name -> (old text, new text) in flash_attention.cu
VARIANTS = {
    "base": None,
    # The products skipped: loads, the walk's barriers, stores.
    "loads_only": ("        aw::tile_step<HD, false>(q, kt,",
                   "        if (p.S < 0) aw::tile_step<HD, false>(q, kt,"),
    # Items of the list taken one by one, the head fastest (no group reuse).
    "head_fastest": ("""  const int g = blockIdx.x + (j / per) * gridDim.x;
  if (g >= p.B * p.H) return false;
  it = {g / p.H, g % p.H, (per - 1 - j % per) * kWG * am::kKeys};""",
                     """  const int i = blockIdx.x + j * gridDim.x;
  if (i >= per * p.B * p.H) return false;
  const int r = i / p.H;
  it = {r % p.B, i - r * p.H, (per - 1 - r / p.B) * kWG * am::kKeys};"""),
    "one_wg_everywhere": (_BY_LENGTH, "return launch_wgmma<HD, 1>(a, st);"),
    "two_wg_everywhere": (_BY_LENGTH, "return launch_wgmma<HD, 2>(a, st);"),
}
# (model, query heads, kv heads, head dim, buckets) of the timed shapes at
# B = 32: llama-2-7b at the three buckets, GQA and MQA at bucket 128.
SHAPES = [("llama-2-7b", 32, 32, 128, (64, 128, 512)), ("mistral-7b", 32, 8, 128, (128,)),
          ("falcon-7b", 71, 1, 64, (128,))]


def build(names):
    """Each variant's libflash_attention, loaded."""
    root = Path(_build.BUILD_DIR).parent / "kernel_variants"
    procs = {}
    for name in names:
        d = root / name
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(_build.CSRC, d)
        if VARIANTS[name]:
            old, new = VARIANTS[name]
            text = (d / FA).read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old[:60]!r} not found once in {FA}")
            (d / FA).write_text(text.replace(old, new))
        out = d / "libflash_attention.so"
        procs[name] = (out, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(d / FA)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        lib = ctypes.CDLL(str(out))
        lib.lir_flash_attention.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device; nothing measured", file=sys.stderr)
        return 1
    names = args.variants.split(",")
    libs = build(names)
    cs.warm_up()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    B = cs.BATCH
    summary = {}
    for model, H, K, hd, S in [(m, h, k, d, S) for m, h, k, d, ss in SHAPES for S in ss]:
        q = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn((B, S, K, hd), generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        mask = torch.ones((B, S), dtype=torch.int32, device="cuda")
        for b in range(B):
            mask[b, :(b * 7) % max(S // 2, 1)] = 0
        out = torch.empty_like(q)
        ref = ops.flash_attention_plain(q, k, v, mask)

        def run(lib):
            _build.check(lib.lir_flash_attention(
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
        for name in names + names[::-1]:
            run(libs[name])
            torch.cuda.synchronize()
            row["max_abs_err"][name] = float((out.float() - ref.float()).abs().max())
            row["ms"].setdefault(name, []).append(cs.time_ms(lambda: run(libs[name]), iters=20))
        print(json.dumps(row), flush=True)
        key = f"{model}/S{S}"
        summary[key] = {n: sum(m) / len(m) for n, m in row["ms"].items()}
        summary[key]["sdpa"] = row["sdpa_ms"]
    print(json.dumps({"mean_ms": summary}), flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
