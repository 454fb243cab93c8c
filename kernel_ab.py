"""Time the port's kernels against another copy of their sources, in
one process on one card.

    python3 kernel_ab.py OTHER_CSRC [--rounds 2]

OTHER_CSRC is a directory holding ``flash_decode.cu``,
``flash_attention.cu``, ``cascade_prefill.cu`` and ``row_gemm.cu`` (with
the headers they include): for example the sources of an earlier commit,
unpacked with ``git archive``. The decode and flash sources must have the
C entry points of ``lir_tpu_torch/csrc``; ``cascade_prefill.cu``'s int8
trunk leg is called through either entry it has had (with the trunk keys'
quantization pass, ``lir_quantize_rows``, or quantizing inside the
kernel), and ``row_gemm.cu``'s projection through either entry it has had
(adding the splits in the launch, or with float32 scratch for a second
launch that adds them, then with the split rule it had). Both copies are
built with the flags of
``lir_tpu_torch/ops/_build.py`` into ``build/kernel_ab/``, then timed in
turns (other, this, this, other in each round), by ``chip_smoke.time_ms``
(L2 flushed, device time; the cases called through a copy's C entry time
their launches alone, not the copies of their outputs), at the main
path's shapes of ``chip_smoke.py``
at llama-2-7b width, B = 32: the decode step at T = 552 (flat and with a
432-slot trunk) and T = 114, the verify window (S = 4) at T = 192 and at
T = 576 with a 432-slot trunk (its two legs and the merge also timed
apart), prefill flash attention at buckets 64, 128 and 512 (bf16 through
the copy's C entry: the kernel it takes at head dim 128), the
bf16 trunk leg (float and int8 QK^T; with the quantization pass where the
copy has one), the fused cascade and the suffix leg + merge at the
cascade dispatch's shape (R = 80, Tt = 432), the int8 trunk keys'
quantization of a whole dispatch (llama-2-7b: 32 layers of (32 * 432,
128) rows) as 32 launches, one a layer, and as one launch over every
layer's rows (both through ``lir_quantize_rows``), the row-invariant
projection at wq, w_up and w_down
with M = 32 and 128 rows, and the RMSNorm of 32 and 128 rows alone and
with the residual add before it (the copy's ``lir_row_add_norm``, or for
a copy without one torch's bf16 add then its ``lir_row_norm``), beside
the device time of an empty kernel timed the same way (the floor of
``time_ms``). Whether the two copies' outputs are bitwise equal is
printed per case (with the largest difference; for the trunk leg, whether
the row max is), and for the cases whose bits may move between copies
each copy's largest difference against the float32 product or the plain
version. Prints one JSON line per reading, a summary line per case, then
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from lir_tpu_torch import ops
from lir_tpu_torch.ops import _build

# The modules behind ops' wrappers (ops re-exports functions of the same
# names), whose _LIB each copy's library replaces in turn.
_FD = sys.modules["lir_tpu_torch.ops.flash_decode"]
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "flash_decode": {"lir_flash_decode_splits": [_P] * 10 + [_I] * 10 + [_P],
                     "lir_flash_decode_trunk_splits": [_P] * 10 + [_I] * 10 + [_P],
                     "lir_flash_decode_merge": [_P] * 4 + [_I] * 7 + [_P]},
    "flash_attention": {"lir_flash_attention": [_P] * 7 + [_I] * 6 + [_P]},
    # The trunk leg's entry with the quantization pass; without it (the
    # older entry) lir_cascade_prefix takes no scales pointer.
    "cascade_prefill": {"lir_quantize_rows": [_P] * 3 + [_I] * 2 + [_P],
                        "lir_cascade_prefix": [_P] * 8 + [_I] * 8 + [_P],
                        "lir_cascade_attention": [_P] * 9 + [_I] * 7 + [_P],
                        "lir_cascade_suffix_merge": [_P] * 10 + [_I] * 6 + [_P]},
    # The projection's entry that adds the splits in the launch; the older
    # one (a second launch adding them) takes their float32 scratch too.
    "row_gemm": {"lir_row_gemm": [_P] * 3 + [_I] * 4 + [_P],
                 "lir_row_norm": [_P] * 4 + [_I] * 2 + [ctypes.c_float, _P],
                 "lir_row_add_norm": [_P] * 6 + [_I] * 2 + [ctypes.c_float, _P]},
}
_OLD_PREFIX_ARGTYPES = [_P] * 7 + [_I] * 8 + [_P]
_OLD_GEMM_ARGTYPES = [_P] * 4 + [_I] * 4 + [_P]
# The copy whose libraries the cases run now.
_CURRENT = {}
# (label, S, T, trunk_len): S = 1 is the decode step.
# (label, K, N) of the projection cases at llama-2-7b width.
GEMM_CASES = [("wq", 4096, 4096), ("w_up", 4096, 11008), ("w_down", 11008, 4096)]
DECODE_CASES = [("flash_decode/T552", 1, 552, 0),
                ("flash_decode_trunk/T552/trunk432", 1, 552, 432),
                ("flash_decode/T114", 1, 114, 0),
                ("flash_decode_mq/S4/T192", 4, 192, 0),
                ("flash_decode_mq_trunk/S4/T576/trunk432", 4, 576, 432)]
FLASH_BUCKETS = (64, 128, 512)


def build(tag: str, csrc: Path) -> dict:
    """The libraries of one copy of the sources, loaded."""
    out_dir = Path(_build.BUILD_DIR).parent / "kernel_ab" / tag
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in _ARGTYPES:
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out_dir / f"lib{name}.so"),
               str(csrc / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {csrc / name}.cu:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        for fn, types in _ARGTYPES[name].items():
            if not hasattr(lib, fn):
                continue
            getattr(lib, fn).argtypes = types
            getattr(lib, fn).restype = _I
        if name == "cascade_prefill" and not hasattr(lib, "lir_quantize_rows"):
            lib.lir_cascade_prefix.argtypes = _OLD_PREFIX_ARGTYPES
        if name == "row_gemm":
            lib.scratch = "void* part" in (csrc / "row_gemm.cu").read_text()
            if lib.scratch:
                lib.lir_row_gemm.argtypes = _OLD_GEMM_ARGTYPES
        libs[name] = lib
    return libs


def use(libs: dict) -> None:
    _FD._LIB = libs["flash_decode"]
    _CURRENT.update(libs)


def prefix_int8_case(gen, R=80, Tt=432):
    """The bf16 int8-QK^T trunk leg at the cascade dispatch's shape through
    the current copy's C entry: (o, m, l)."""
    B, H, K, hd = cs.BATCH, 32, 32, 128
    bf = torch.bfloat16
    q = torch.randn((B, R, H, hd), generator=gen, device="cuda").to(bf)
    tk = torch.randn((K, Tt, hd), generator=gen, device="cuda").to(bf)
    tv = torch.randn((K, Tt, hd), generator=gen, device="cuda").to(bf)
    f32 = dict(dtype=torch.float32, device="cuda")
    o = torch.empty((B, K, R, H // K, hd), **f32)
    m = torch.empty((B, K, R, H // K), **f32)
    l = torch.empty_like(m)
    k8 = torch.empty(tk.shape, dtype=torch.int8, device="cuda")
    ks = torch.empty((K, Tt), **f32)

    def run():
        lib = _CURRENT["cascade_prefill"]
        st = torch.cuda.current_stream().cuda_stream
        dims = (B, R, H, K, Tt, hd, 1, 1, st)
        if hasattr(lib, "lir_quantize_rows"):
            _build.check(lib.lir_quantize_rows(tk.data_ptr(), k8.data_ptr(),
                                               ks.data_ptr(), K * Tt, hd, st),
                         "quantize_rows")
            err = lib.lir_cascade_prefix(q.data_ptr(), k8.data_ptr(), ks.data_ptr(),
                                         tv.data_ptr(), None, o.data_ptr(),
                                         m.data_ptr(), l.data_ptr(), *dims)
        else:
            err = lib.lir_cascade_prefix(q.data_ptr(), tk.data_ptr(), tv.data_ptr(),
                                         None, o.data_ptr(), m.data_ptr(),
                                         l.data_ptr(), *dims)
        _build.check(err, "cascade_prefix_int8")

    return _with_result(run, lambda: (o.clone(), m.clone(), l.clone()))


def suffix_merge_case(gen, R=80, Tt=432):
    """The bf16 suffix leg + merge at the cascade dispatch's shape (ragged
    windows as chip_smoke makes them) through the current copy's C entry,
    over trunk partials made once by this checkout's trunk leg."""
    B, H, K, hd = cs.BATCH, 32, 32, 128
    bf = torch.bfloat16
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(bf)
    q, sk, sv = rnd(B, R, H, hd), rnd(B, R, K, hd), rnd(B, R, K, hd)
    mask = torch.ones((B, R), dtype=torch.int32, device="cuda")
    for b in range(B):
        mask[b, R - (b * 5) % R:] = 0
    qpos = (Tt + torch.clamp_min(torch.cumsum(mask, -1, dtype=torch.int32) - 1,
                                 0)).to(torch.int32)
    o_t, m_t, l_t = ops.cascade_prefix(q, rnd(K, Tt, hd), rnd(K, Tt, hd))
    out = torch.empty_like(q)

    def run():
        lib = _CURRENT["cascade_prefill"]
        err = lib.lir_cascade_suffix_merge(
            q.data_ptr(), sk.data_ptr(), sv.data_ptr(), o_t.data_ptr(), m_t.data_ptr(),
            l_t.data_ptr(), mask.data_ptr(), qpos.data_ptr(), None, out.data_ptr(),
            B, R, H, K, hd, 1, torch.cuda.current_stream().cuda_stream)
        _build.check(err, "cascade_suffix_merge")

    return _with_result(run, out.clone)


def quantize_case(gen, layers, L=32, K=32, Tt=432, hd=128):
    """The int8 trunk keys' quantization of a dispatch at llama-2-7b's
    shape through the current copy's ``lir_quantize_rows``: one launch a
    layer (``layers``, over each layer's (K * Tt, hd) rows in turn) or one
    launch over every layer's (L * K * Tt, hd) rows."""
    x = torch.randn((L * K * Tt, hd), generator=gen, device="cuda").to(torch.bfloat16)
    q8 = torch.empty(x.shape, dtype=torch.int8, device="cuda")
    sc = torch.empty(x.shape[:1], dtype=torch.float32, device="cuda")
    rows = K * Tt
    spans = [(i * rows, rows) for i in range(L)] if layers else [(0, L * rows)]

    def run():
        lib = _CURRENT["cascade_prefill"]
        st = torch.cuda.current_stream().cuda_stream
        for r0, n in spans:
            _build.check(lib.lir_quantize_rows(x[r0].data_ptr(), q8[r0].data_ptr(),
                                               sc[r0:].data_ptr(), n, hd, st),
                         "quantize_rows")

    return _with_result(run, lambda: (q8.clone(), sc.clone()))


def _split_sum_splits(n: int, k: int) -> int:
    """The split count of the entry with float32 scratch (a second launch
    adds the splits): powers of two up to 4, each split at least 8
    chunks of 64, until 264 blocks of 64 columns."""
    n_tiles, chunks, s = -(-n // 64), -(-k // 64), 1
    while n_tiles * s < 264 and 2 * s <= 4 and chunks // (2 * s) >= 8:
        s *= 2
    cps = -(-chunks // s)
    return -(-chunks // cps)


def gemm_case(gen, M, K, N):
    """The row-invariant projection through the current copy's C entry:
    Y (M, N); its float32 product for the error."""
    x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((K, N), generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
    out = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")
    part = torch.empty((4, M, N), dtype=torch.float32, device="cuda")

    def run():
        lib = _CURRENT["row_gemm"]
        st = torch.cuda.current_stream().cuda_stream
        if lib.scratch:
            err = lib.lir_row_gemm(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                   part.data_ptr(), M, N, K, _split_sum_splits(N, K), st)
        else:
            err = lib.lir_row_gemm(x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K,
                                   ops.gemm_splits(N, K), st)
        _build.check(err, "row_gemm")

    return _with_result(run, out.clone), lambda: x.float() @ w.float()


def cascade_case(gen, fused, R=80, Tt=432):
    """The bf16 trunk leg (float QK^T; (o, m, l)) or the fused cascade
    (its output) at the cascade dispatch's shape through the current
    copy's C entry; the plain version for the error."""
    B, H, K, hd = cs.BATCH, 32, 32, 128
    bf = torch.bfloat16
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(bf)
    q, tk, tv = rnd(B, R, H, hd), rnd(K, Tt, hd), rnd(K, Tt, hd)
    sk, sv = rnd(B, R, K, hd), rnd(B, R, K, hd)
    mask = torch.ones((B, R), dtype=torch.int32, device="cuda")
    qpos = (Tt + torch.arange(R, dtype=torch.int32, device="cuda"))[None].expand(B, -1)
    qpos = qpos.contiguous()
    f32 = dict(dtype=torch.float32, device="cuda")
    o = torch.empty((B, K, R, H // K, hd), **f32)
    m = torch.empty((B, K, R, H // K), **f32)
    l = torch.empty_like(m)
    out = torch.empty_like(q)

    def run():
        lib = _CURRENT["cascade_prefill"]
        st = torch.cuda.current_stream().cuda_stream
        if fused:
            err = lib.lir_cascade_attention(
                q.data_ptr(), sk.data_ptr(), sv.data_ptr(), tk.data_ptr(), tv.data_ptr(),
                mask.data_ptr(), qpos.data_ptr(), None, out.data_ptr(), B, R, H, K, Tt,
                hd, 1, st)
            _build.check(err, "cascade_attention")
            return
        if hasattr(lib, "lir_quantize_rows"):
            err = lib.lir_cascade_prefix(q.data_ptr(), tk.data_ptr(), None, tv.data_ptr(),
                                         None, o.data_ptr(), m.data_ptr(), l.data_ptr(),
                                         B, R, H, K, Tt, hd, 1, 0, st)
        else:
            err = lib.lir_cascade_prefix(q.data_ptr(), tk.data_ptr(), tv.data_ptr(), None,
                                         o.data_ptr(), m.data_ptr(), l.data_ptr(),
                                         B, R, H, K, Tt, hd, 1, 0, st)
        _build.check(err, "cascade_prefix")

    def plain():
        if fused:
            return ops.cascade_attention_plain(q, sk, sv, tk, tv, mask, qpos)
        return ops.prefix_partials(q, tk, tv, None)

    result = out.clone if fused else (lambda: (o.clone(), m.clone(), l.clone()))
    return _with_result(run, result), plain


def _with_result(launch, result):
    """A case of launches through a copy's C entry: calling it launches
    and returns copies of the outputs; its ``launch`` only launches, and
    is what is timed."""
    def case():
        launch()
        return result()
    case.launch = launch
    return case


def _err(got, ref) -> float:
    if isinstance(got, tuple):
        return max(float((g.float() - r.float()).abs().max()) for g, r in zip(got, ref))
    return float((got.float() - ref.float()).abs().max())


def decode_case(gen, S, T, trunk):
    """The wrapper call of one decode case, and for the trunk-aware verify
    window a maker of its separate launches."""
    q, k, v, qpos, mask, kpos = cs.decode_inputs(gen, cs.BATCH, 32, 32, 128, T, trunk,
                                                 S=None if S == 1 else S)
    args = (q, k, v, qpos, mask)
    kw = dict(key_positions=kpos, **({"trunk_len": trunk} if trunk else {}))
    if S == 1:
        fn = ops.flash_decode_trunk if trunk else ops.flash_decode
    else:
        fn = ops.flash_decode_mq_trunk if trunk else ops.flash_decode_mq
    legs = None
    if S > 1 and trunk:
        def legs():
            return _FD.decode_legs(*args, **kw)[1]
    return (lambda: fn(*args, **kw)), legs


def flash_case(gen, S):
    """Prefill flash attention at a bucket through the current copy's C
    entry in bf16 (the kernel the copy takes at head dim 128: wgmma, or
    mma.sync in a copy before it); the plain version for the error."""
    B, H, hd = cs.BATCH, 32, 128
    shape = (B, S, H, hd)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    mask = torch.ones((B, S), dtype=torch.int32, device="cuda")
    for b in range(B):
        mask[b, :(b * 7) % max(S // 2, 1)] = 0
    out = torch.empty_like(q)

    def run():
        lib = _CURRENT["flash_attention"]
        err = lib.lir_flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                      mask.data_ptr(), None, None, out.data_ptr(),
                                      B, S, H, H, hd, 1,
                                      torch.cuda.current_stream().cuda_stream)
        _build.check(err, "flash_attention")

    return _with_result(run, out.clone), lambda: ops.flash_attention_plain(q, k, v, mask)


def norm_case(gen, M, D=4096, add=False):
    """The RMSNorm of M rows through the current copy's C entry, with the
    residual add before it where ``add`` (the copy's row_add_norm, or for
    a copy without one, torch's bf16 add then its row_norm); the plain
    version for the error."""
    x = (torch.randn((M, D), generator=gen, device="cuda") * 2).to(torch.bfloat16)
    d = torch.randn((M, D), generator=gen, device="cuda").to(torch.bfloat16)
    scale = torch.randn((D,), generator=gen, device="cuda").to(torch.bfloat16)
    s, h = torch.empty_like(x), torch.empty_like(x)

    def run():
        lib = _CURRENT["row_gemm"]
        st = torch.cuda.current_stream().cuda_stream
        if not add:
            err = lib.lir_row_norm(x.data_ptr(), scale.data_ptr(), None, h.data_ptr(),
                                   M, D, 1e-5, st)
        elif hasattr(lib, "lir_row_add_norm"):
            err = lib.lir_row_add_norm(x.data_ptr(), d.data_ptr(), scale.data_ptr(), None,
                                       s.data_ptr(), h.data_ptr(), M, D, 1e-5, st)
        else:
            torch.add(x, d, out=s)
            err = lib.lir_row_norm(s.data_ptr(), scale.data_ptr(), None, h.data_ptr(),
                                   M, D, 1e-5, st)
        _build.check(err, "row_norm")

    if add:
        return (_with_result(run, lambda: (s.clone(), h.clone())),
                lambda: ops.row_add_norm_plain(x, d, scale, None, 1e-5))
    return _with_result(run, h.clone), lambda: ops.row_norm_plain(x, scale, None, 1e-5)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other_csrc", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device; nothing measured", file=sys.stderr)
        return 1
    copies = {"other": build("other", args.other_csrc), "this": build("this", _build.CSRC)}
    cs.warm_up()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    cases = [(label, *decode_case(gen, S, T, trunk)) for label, S, T, trunk in DECODE_CASES]
    cases.append(("cascade_prefix_int8/R80/Tt432", prefix_int8_case(gen), None))
    # Cases whose bits may move between the copies: each copy's largest
    # difference against the float32 product or the plain version.
    refs = {}
    for S in FLASH_BUCKETS:
        label = f"flash_attention/S{S}"
        fn, refs[label] = flash_case(gen, S)
        cases.append((label, fn, None))
    for M in (cs.BATCH, 4 * cs.BATCH):
        for add in (False, True):
            label = f"{'row_add_norm' if add else 'row_norm'}/M{M}"
            fn, refs[label] = norm_case(gen, M, add=add)
            cases.append((label, fn, None))
    floor = [cs.time_ms(cs.empty_kernel, iters=20) for _ in range(2)]
    print(json.dumps({"case": "empty_kernel", "copy": "this", "ms": floor}), flush=True)
    for fused, label in ((False, "cascade_prefix/R80/Tt432"),
                         (True, "cascade_attention/R80/Tt432")):
        fn, refs[label] = cascade_case(gen, fused)
        cases.append((label, fn, None))
    cases.append(("cascade_suffix_merge/R80", suffix_merge_case(gen), None))
    cases.append(("quantize_rows/32x(13824,128)", quantize_case(gen, layers=True), None))
    cases.append(("quantize_rows/1x(442368,128)", quantize_case(gen, layers=False), None))
    for name, K, N in GEMM_CASES:
        for M in (cs.BATCH, 4 * cs.BATCH):
            label = f"row_gemm/{name}/M{M}"
            fn, refs[label] = gemm_case(gen, M, K, N)
            cases.append((label, fn, None))
    order = ["other", "this", "this", "other"] * args.rounds
    summary = {}
    for label, fn, legs in cases:
        outs = {}
        for tag in order:
            use(copies[tag])
            outs.setdefault(tag, fn())
            row = {"case": label, "copy": tag,
                   "ms": cs.time_ms(getattr(fn, "launch", fn), iters=20)}
            if legs is not None:
                row["legs_ms"] = {name: cs.time_ms(leg, iters=20)
                                  for name, leg in legs().items()}
            summary.setdefault((label, tag), []).append(row["ms"])
            print(json.dumps(row), flush=True)
        if label in refs:
            ref = refs[label]()
            errs = {tag: _err(outs[tag], ref) for tag in ("other", "this")}
            print(json.dumps({"case": label, "max_abs_err_vs_reference": errs,
                              "bitwise_equal": _err(outs["other"], outs["this"]) == 0.0}),
                  flush=True)
            continue
        if label.startswith("quantize_rows"):
            same = {"bitwise_equal": all(torch.equal(a, b)
                                         for a, b in zip(outs["other"], outs["this"]))}
        elif isinstance(outs["other"], tuple):
            (oa, ma, la), (ob, mb, lb) = outs["other"], outs["this"]
            same = {"row_max_bitwise_equal": bool(torch.equal(ma, mb)),
                    "o_max_abs_diff": float((oa - ob).abs().max()),
                    "l_max_abs_diff": float((la - lb).abs().max())}
        else:
            same = {"bitwise_equal": bool(torch.equal(outs["other"], outs["this"]))}
        print(json.dumps({"case": label, **same}), flush=True)
    for (label, tag), ms in summary.items():
        print(json.dumps({"summary": label, "copy": tag, "ms": ms,
                          "mean_ms": sum(ms) / len(ms)}), flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
