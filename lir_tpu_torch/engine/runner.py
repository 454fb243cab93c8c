"""Batched scoring engine on PyTorch: the cold, unpaged main path.

Port of ``lir_tpu/engine/runner.py``'s ``ScoringEngine`` (the part the
word-meaning sweep and the shared-prefix dispatch run): prompts are
packed into fixed-shape padded batches bucketed by token length, one
greedy decode with the readouts fused into the loop runs per batch, and
the C13 readout applies vectorised over the batch.

Routing is the JAX engine's default: a shared dispatch whose rows share
a trunk takes the cascade prefill and the trunk-aware decode kernel; any
other shared dispatch of the ragged sweep takes the dense shared prefill
and then the speculative verify loop (engine/spec.py, the multi-query
decode kernels, trunk-aware where its rows share a trunk), or with
``spec_decode`` off the sequential loop on the single-query kernels. A
grouped dispatch of the ragged sweep (``decode_fused_grouped``) prefills
one row per prefix group, gathers it out to the member rows and runs the
sequential loop on the single-query kernel. The
kernels run on CUDA tensors and their plain PyTorch versions on CPU
tensors, so the engine routes the same way on both; the JAX engine
routes to its kernels only on a TPU (or under its interpreter hooks).

The 8-bit path is the same engine with int8 params
(``models.quant.quantize_decoder_params`` or ``init_quantized_params``),
``ModelConfig.use_flash_attention`` (prefill flash kernel),
``RuntimeConfig.cascade_fused_suffix=False`` and
``CascadeConfig(int8_qk=True)`` (the two-leg cascade, int8 QK^T in its
trunk leg).
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import threading
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import CascadeConfig, RuntimeConfig, SpecConfig
from ..device import resolve_device
from ..utils.profiling import GuardStats
from . import generate, score, spec as spec_mod, tokens as tok

log = logging.getLogger(__name__)

# Suffix buckets of the shared path (the JAX engine's).
SFX_BUCKETS = (8, 16, 32, 64, 128, 256)


def _tail_batch(n: int, cap: int) -> int:
    """Smallest power of two >= n, capped at the configured batch size."""
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


@dataclasses.dataclass
class PromptScore:
    """One prompt's raw measurement. Sweep drivers wrap this into
    data/schemas.py records."""

    prompt: str
    completion: str
    yes_prob: float
    no_prob: float
    yes_logprob: float
    no_logprob: float
    odds_ratio: float
    relative_prob: float
    position_found: int
    yes_no_found: bool


class ScoringEngine:
    """Holds (params, cfg, tokenizer) on one device and runs the scoring
    path. ``device`` defaults to CUDA and raises without a card; the CPU
    must be asked for."""

    def __init__(self, params: Any, cfg: Any, tokenizer: Any,
                 runtime: Optional[RuntimeConfig] = None,
                 cascade_config: Optional[CascadeConfig] = None,
                 spec_config: Optional[SpecConfig] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        first = params["tok_embed"]
        if first.device.type != self.device.type:
            raise ValueError(f"params live on {first.device}, the engine on "
                             f"{self.device}")
        self.params = params
        self.tokenizer = tokenizer
        self.rt = runtime or RuntimeConfig()
        self.cascade_cfg = cascade_config or CascadeConfig()
        self.spec_cfg = spec_config or SpecConfig()
        # Kernel choices are runtime flags mirrored into the model config,
        # as in the JAX engine.
        self.cfg = dataclasses.replace(
            cfg, fused_decode=self.rt.fused_decode,
            cascade_decode=self.rt.cascade_decode,
            cascade_fused_suffix=self.rt.cascade_fused_suffix)
        # Routing counters: cascade_dispatches, dense_shared_dispatches
        # (dense shared prefill + the sequential loop), dense_fallbacks,
        # cascade_decode_dispatches.
        self.cascade_stats = collections.Counter()
        # Speculative-decode counters, the JAX SpecStats field names:
        # spec_dispatches, spec_rows (counted at dispatch); drafted_tokens,
        # accepted_tokens, draft_ngram, accepted_ngram, decode_forwards,
        # seq_forwards (folded from the pending SpecOuts by spec_flush).
        self.spec_stats = collections.Counter()
        self._spec_pending: List[Tuple[Any, Any]] = []
        # The perturbation sweep's writer thread decodes completion text
        # while the main thread tokenizes: tokenizer calls take this lock.
        self._tok_lock = threading.Lock()
        # The last ragged sweep's scheduler counters
        # (utils.profiling.OccupancyStats; None outside a ragged sweep).
        self.occupancy = None
        # The numerics guard's counters (the perturbation sweep checks
        # every row's readouts when RuntimeConfig.numerics_guard is on),
        # and the last perturbation sweep's streaming-statistics sink
        # (engine/stream_stats.StreamSink; None with the sink off).
        self.guard_stats = GuardStats()
        self.stream_sink = None
        self.yes_id, self.no_id = tok.yes_no_ids(tokenizer)
        self.eos_id = getattr(tokenizer, "eos_token_id", None)
        if self.rt.ragged_scheduler:
            self.buckets = list(tok.bucket_ladder(self.rt.max_seq_len))
        else:
            self.buckets = [b for b in (64, 128, 256, 512, 1024)
                            if b <= self.rt.max_seq_len] or [self.rt.max_seq_len]
        if getattr(cfg, "pos_embedding", None) == "learned":
            # A bucket + generation budget past the learned-position table
            # would read beyond pos_embed: trim such buckets.
            limit = cfg.max_seq_len - self.rt.max_new_tokens
            fitting = [b for b in self.buckets if b <= limit]
            if not fitting:
                raise ValueError(
                    f"{cfg.name}: no length bucket fits the learned-"
                    f"position table ({cfg.max_seq_len} rows) minus the "
                    f"generation budget ({self.rt.max_new_tokens})")
            self.buckets = fitting
        self._digit_table: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._digit_stop_mask: Any = False  # False = not resolved yet
        self._eos_stop_mask: Optional[torch.Tensor] = None

    # -- kernel gates -------------------------------------------------------

    def cascade_supported(self) -> bool:
        """Engine-level gate of the cascade prefill. The kernels always
        run on the engine's device (the CUDA kernels on a card, their
        plain versions on the CPU), so the gate is the flag alone; the
        JAX engine also asks for a TPU there. Per-dispatch eligibility is
        :meth:`cascade_trunk_for`'s."""
        return self.rt.cascade_prefill

    def cascade_trunk_for(self, prefix_ids: Sequence[Sequence[int]],
                          n_real: Optional[int] = None,
                          bucket: Optional[int] = None) -> int:
        """The dispatch's shared-trunk extent, or 0 for the dense path:
        the all-rows longest common prefix snapped down to the trunk
        quantum, strictly inside the bucket, floored at min_trunk."""
        if not self.cascade_supported() or not prefix_ids:
            return 0
        return self._lcp_trunk(prefix_ids, n_real, bucket)

    def _lcp_trunk(self, prefix_ids: Sequence[Sequence[int]],
                   n_real: Optional[int], bucket: Optional[int]) -> int:
        cc = self.cascade_cfg
        rows_real = len(prefix_ids) if n_real is None else n_real
        if rows_real < max(cc.min_rows, 2):
            return 0
        q = max(int(cc.trunk_quantum), 1)
        trunk = (tok.common_prefix_len(prefix_ids) // q) * q
        if bucket is not None and trunk >= bucket:
            trunk = ((bucket - 1) // q) * q
        if trunk < max(int(cc.min_trunk), q):
            return 0
        return trunk

    def cascade_decode_supported(self) -> bool:
        """Gate of the trunk-aware decode kernel: on by config, with the
        flash-decode route on."""
        return self.rt.cascade_decode and self.cfg.fused_decode

    def decode_trunk_for(self, prefix_ids: Sequence[Sequence[int]],
                         n_real: Optional[int] = None,
                         bucket: Optional[int] = None) -> int:
        """The dispatch's shared-trunk extent for the decode-phase dedup,
        or 0 for the flat kernel (same LCP rule as the prefill's)."""
        if not self.cascade_decode_supported() or not prefix_ids:
            return 0
        return self._lcp_trunk(prefix_ids, n_real, bucket)

    def spec_supported(self) -> bool:
        """Engine-level gate of speculative decode: on by config with a
        verify window of at least 2."""
        return self.rt.spec_decode and self.rt.spec_k >= 2

    def spec_flush(self) -> None:
        """Fold the pending device-side SpecOut counters into spec_stats
        (one copy to the host for all of them; spec.flush_pending)."""
        spec_mod.flush_pending(self)

    # -- token tables -------------------------------------------------------

    @property
    def digit_stop_mask(self) -> Optional[torch.Tensor]:
        """(V,) int32 surface-class table for the confidence early stop,
        or None when the tokenizer has no per-token strings or no EOS."""
        if self._digit_stop_mask is False:
            mask = None
            if self.eos_id is not None:
                with self._tok_lock:
                    m = tok.digit_stop_classes(self.tokenizer,
                                               self.cfg.vocab_size)
                if m is not None:
                    mask = torch.as_tensor(m, device=self.device)
            self._digit_stop_mask = mask
        return self._digit_stop_mask

    @property
    def eos_stop_mask(self) -> Optional[torch.Tensor]:
        """(V,) all-transparent class table: a pure all-rows-emitted-EOS
        stop for the binary branch, armed with :attr:`digit_stop_mask`."""
        if self.digit_stop_mask is None:
            return None
        if self._eos_stop_mask is None:
            self._eos_stop_mask = torch.as_tensor(
                tok.eos_only_stop_classes(self.cfg.vocab_size),
                device=self.device)
        return self._eos_stop_mask

    @property
    def digit_table(self) -> Tuple[np.ndarray, np.ndarray]:
        """(token ids, values) of single-token integers 0..100."""
        if self._digit_table is None:
            with self._tok_lock:
                self._digit_table = tok.integer_token_table(self.tokenizer)
        return self._digit_table

    def _t(self, a, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # -- decode paths -------------------------------------------------------

    def decode_fused(self, prompts: Sequence[str], yes_ids: np.ndarray,
                     no_ids: np.ndarray, with_digits: bool = False,
                     max_new_tokens: Optional[int] = None,
                     pretokenized: Optional[Sequence[Sequence[int]]] = None,
                     early_stop: bool = False, eos_stop: bool = False):
        """The plain scoring path: left-padded prompts, one prefill, the
        fused greedy loop. Returns a FusedDecodeOut on the device."""
        assert not (early_stop and eos_stop), "pick one stop rule"
        toks, mask = self._pad_batch(prompts, pretokenized)
        if with_digits:
            digit_ids, digit_vals = self.digit_table
        else:
            digit_ids = np.zeros((0,), np.int32)
            digit_vals = np.zeros((0,), np.float32)
        stop_mask = (self.digit_stop_mask if early_stop
                     else self.eos_stop_mask if eos_stop else None)
        return generate.greedy_decode_fused(
            self.params, self.cfg, toks, mask, self._t(yes_ids),
            self._t(no_ids), self._t(digit_ids),
            self._t(digit_vals, torch.float32),
            max_new_tokens=(self.rt.max_new_tokens if max_new_tokens is None
                            else max_new_tokens),
            stop_mask=stop_mask,
            eos_id=None if stop_mask is None else int(self.eos_id))

    def decode_fused_shared(self, binary_prompts: Sequence[str],
                            confidence_prompts: Sequence[str],
                            yes_ids: np.ndarray, no_ids: np.ndarray,
                            new_tokens: int, conf_tokens: int,
                            early_stop: bool = False,
                            pretokenized_a: Optional[Sequence[Sequence[int]]] = None,
                            pretokenized_b: Optional[Sequence[Sequence[int]]] = None,
                            bucket: Optional[int] = None,
                            sfx_buckets_ab: Optional[Tuple[int, int]] = None,
                            reuse_cache: bool = False,
                            n_real: Optional[int] = None):
        """Score BOTH sweep formats with ONE shared-prefix prefill.

        Each row's binary and confidence prompts split at their longest
        common TOKEN prefix; prefixes right-pad into the length bucket and
        each format's suffix into a small suffix bucket. ``reuse_cache``
        marks a dispatch of the ragged sweep (the JAX engine threads its
        cache buffer through the dispatch chain there): it is where the
        cascade and speculative routing applies — a dispatch whose rows
        share a trunk takes the cascade prefill and the trunk-aware
        decode; any other the dense shared prefill, then the speculative
        verify loop (the sequential loop with ``spec_decode`` off), both
        with the decode trunk of its rows' LCP. Returns (binary
        FusedDecodeOut, confidence FusedDecodeOut)."""
        if pretokenized_a is not None:
            bin_ids = [list(i) for i in pretokenized_a]
            conf_ids = [list(i) for i in pretokenized_b]
        else:
            with self._tok_lock:
                bin_ids = [self.tokenizer(p).input_ids
                           for p in binary_prompts]
                conf_ids = [self.tokenizer(p).input_ids
                            for p in confidence_prompts]
        lcp = [tok.shared_prefix_len(a, b) for a, b in zip(bin_ids, conf_ids)]
        pad_id = tok.pad_token_id(self.tokenizer)
        sfx_a_ids = [a[n:] for a, n in zip(bin_ids, lcp)]
        sfx_b_ids = [b[n:] for b, n in zip(conf_ids, lcp)]
        max_sfx = max(len(s) for s in sfx_a_ids + sfx_b_ids)
        max_total = max(len(r) for r in bin_ids + conf_ids)
        if bucket is None or bucket < max(max(n, 1) for n in lcp):
            bucket = tok.pick_bucket([max(n, 1) for n in lcp], self.buckets)
        ba = tok.pick_bucket([len(s) for s in sfx_a_ids], SFX_BUCKETS)
        bb = tok.pick_bucket([len(s) for s in sfx_b_ids], SFX_BUCKETS)
        if sfx_buckets_ab is not None:
            ba, bb = max(sfx_buckets_ab[0], ba), max(sfx_buckets_ab[1], bb)
        fallback_reason = None
        if max_sfx > max(SFX_BUCKETS):
            fallback_reason = (
                f"a prompt pair diverges {max_sfx} tokens before its end "
                f"(> {max(SFX_BUCKETS)} suffix bucket)")
        elif max_total > max(self.buckets):
            fallback_reason = (
                f"a prompt ({max_total} tokens) exceeds the largest "
                f"bucket ({max(self.buckets)})")
        elif (getattr(self.cfg, "pos_embedding", None) == "learned"
              and bucket + max(ba + new_tokens, bb + conf_tokens)
              > self.cfg.max_seq_len):
            fallback_reason = (
                f"prefix bucket {bucket} + suffix/new-token budget "
                f"{max(ba + new_tokens, bb + conf_tokens)} would overrun "
                f"the {self.cfg.max_seq_len}-row learned-position table")
        if fallback_reason is not None:
            log.info("shared-prefix fallback: %s — scoring this batch with "
                     "two full prefills", fallback_reason)
            fused = self.decode_fused(binary_prompts, yes_ids, no_ids,
                                      max_new_tokens=new_tokens,
                                      pretokenized=bin_ids,
                                      eos_stop=early_stop)
            cfused = self.decode_fused(confidence_prompts, yes_ids, no_ids,
                                       with_digits=True,
                                       max_new_tokens=conf_tokens,
                                       pretokenized=conf_ids,
                                       early_stop=early_stop)
            return fused, cfused
        prefix_rows = [a[:n] for a, n in zip(bin_ids, lcp)]
        prefix, prefix_mask = tok.right_pad_ids(prefix_rows, bucket, pad_id)
        sfx_a, sfx_a_mask = tok.right_pad_ids(sfx_a_ids, ba, pad_id)
        sfx_b, sfx_b_mask = tok.right_pad_ids(sfx_b_ids, bb, pad_id)
        digit_ids, digit_vals = self.digit_table
        stop_mask = self.digit_stop_mask if early_stop else None
        stops = dict(
            stop_mask_b=stop_mask,
            stop_mask_a=None if stop_mask is None else self.eos_stop_mask,
            eos_id=None if stop_mask is None else int(self.eos_id))
        args = (self.params, self.cfg, self._t(prefix), self._t(prefix_mask),
                self._t(sfx_a), self._t(sfx_a_mask), self._t(sfx_b),
                self._t(sfx_b_mask), self._t(yes_ids), self._t(no_ids),
                self._t(digit_ids), self._t(digit_vals, torch.float32))
        dtrunk = 0
        if reuse_cache:
            trunk = self.cascade_trunk_for(prefix_rows, n_real, bucket)
            if trunk:
                return self._dispatch_shared_cascade(
                    trunk, args, new_tokens, conf_tokens, stops)
            if self.cascade_supported():
                self.cascade_stats["dense_fallbacks"] += 1
            dtrunk = self.decode_trunk_for(prefix_rows, n_real, bucket)
            if dtrunk:
                self.cascade_stats["cascade_decode_dispatches"] += 1
            splan = spec_mod.build_plan(self, bin_ids, conf_ids, bucket, ba,
                                        bb, new_tokens, conf_tokens)
            if splan is not None:
                return self._dispatch_shared_spec(
                    splan, args, new_tokens, conf_tokens, stops, dtrunk,
                    len(bin_ids) if n_real is None else n_real)
        self.cascade_stats["dense_shared_dispatches"] += 1
        return generate.greedy_decode_fused_shared(
            *args, max_new_a=new_tokens, max_new_b=conf_tokens,
            decode_trunk=dtrunk, **stops)

    def _dispatch_shared_spec(self, splan, args, new_tokens: int,
                              conf_tokens: int, stops: dict, dtrunk: int,
                              rows: int):
        """One SPECULATIVE shared dispatch, cold and unpaged: the dense
        shared prefill, then both branches' draft-and-verify loops
        (generate.greedy_decode_fused_shared_spec), every verify window
        on the multi-query kernel — trunk-aware when ``dtrunk`` > 0. The
        dispatch's SpecOuts stay on the device until spec_flush()."""
        spec_args = tuple(self._t(a) for a in splan.dyn_args())
        fused, cfused, spec_a, spec_b = generate.greedy_decode_fused_shared_spec(
            *args, *spec_args, max_new_a=new_tokens, max_new_b=conf_tokens,
            spec_k=splan.k, ngram=splan.ngram, decode_trunk=dtrunk, **stops)
        self._spec_pending.append((spec_a, spec_b))
        self.spec_stats["spec_dispatches"] += 1
        self.spec_stats["spec_rows"] += rows
        return fused, cfused

    def _dispatch_shared_cascade(self, trunk: int, args, new_tokens: int,
                                 conf_tokens: int, stops: dict):
        """One CASCADE shared dispatch, cold: the batch-1 trunk prefill,
        the per-row cascade remainder extension (its trunk leg in int8
        QK^T with ``cascade_cfg.int8_qk``) and both branches' fused loops
        on the trunk-aware decode kernel
        (generate.greedy_decode_fused_shared_cascade)."""
        self.cascade_stats["cascade_dispatches"] += 1
        if self.cascade_decode_supported():
            self.cascade_stats["cascade_decode_dispatches"] += 1
        return generate.greedy_decode_fused_shared_cascade(
            *args, max_new_a=new_tokens, max_new_b=conf_tokens,
            trunk_len=trunk, int8_qk=bool(self.cascade_cfg.int8_qk), **stops)

    def decode_fused_grouped(self, groups, yes_ids: np.ndarray,
                             no_ids: np.ndarray, new_tokens: int,
                             conf_tokens: int, early_stop: bool,
                             bucket: int, sfx_bucket: int):
        """Cross-cell prefix reuse: score every member prompt of
        ``groups`` (scheduler.PrefixGroup: ``.items`` with
        ``.bin_ids``/``.conf_ids``, shared ``.plen``) with ONE prefill per
        group. Member rows are laid out [bin, conf] per cell, cells in
        group order; ``yes_ids``/``no_ids`` are per CELL in that order.

        Returns (FusedDecodeOut over the padded member batch, real member
        row count): callers slice even rows for the binary readout and
        odd rows for the confidence readout. Both formats run one shared
        decode budget max(new_tokens, conf_tokens); with ``early_stop``
        the binary rows take the EOS-only stop table and the confidence
        rows the digit stop (per-row selection, generate._fused_tail).
        The JAX engine's cold, unpaged branch: the port has no prefix
        cache and no cache handoff."""
        pad_id = tok.pad_token_id(self.tokenizer)
        prefix_ids, sfx_ids, group_idx = [], [], []
        for g in groups:
            gi = len(prefix_ids)
            prefix_ids.append(list(g.items[0].bin_ids[:g.plen]))
            for it in g.items:
                sfx_ids.append(list(it.bin_ids[g.plen:]))
                sfx_ids.append(list(it.conf_ids[g.plen:]))
                group_idx += [gi, gi]
        m = len(sfx_ids)
        g_pad = _tail_batch(len(prefix_ids), self.rt.batch_size)
        m_pad = _tail_batch(m, 2 * self.rt.batch_size)
        prefix_ids += [prefix_ids[-1]] * (g_pad - len(prefix_ids))
        sfx_ids += [sfx_ids[-1]] * (m_pad - m)
        group_idx += [group_idx[-1]] * (m_pad - m)
        if max(len(p) for p in prefix_ids) > bucket:
            raise ValueError("scheduler planned a group prefix longer than "
                             "its bucket")  # planning bug, never truncate
        if (getattr(self.cfg, "pos_embedding", None) == "learned"
                and bucket + sfx_bucket + max(new_tokens, conf_tokens)
                > self.cfg.max_seq_len):
            raise ValueError("scheduler planned a grouped dispatch past the "
                             "learned-position table")
        # RIGHT-padded group prefixes: the slot == position layout of the
        # shared paths.
        prefix, prefix_mask = tok.right_pad_ids(prefix_ids, bucket, pad_id)
        sfx, sfx_mask = tok.right_pad_ids(sfx_ids, sfx_bucket, pad_id)
        yes2 = np.repeat(np.asarray(yes_ids, np.int32), 2)
        no2 = np.repeat(np.asarray(no_ids, np.int32), 2)
        yes2 = np.concatenate([yes2, np.repeat(yes2[-1:], m_pad - m)])
        no2 = np.concatenate([no2, np.repeat(no2[-1:], m_pad - m)])
        digit_ids, digit_vals = self.digit_table
        stop_mask = self.digit_stop_mask if early_stop else None
        out = generate.greedy_decode_fused_grouped(
            self.params, self.cfg, self._t(prefix), self._t(prefix_mask),
            self._t(sfx), self._t(sfx_mask), self._t(group_idx),
            self._t(yes2), self._t(no2), self._t(digit_ids),
            self._t(digit_vals, torch.float32),
            max_new=max(new_tokens, conf_tokens),
            stop_mask=None if stop_mask is None else self.eos_stop_mask,
            stop_mask2=stop_mask,
            stop_sel=(None if stop_mask is None
                      else self._t(np.arange(m_pad) % 2 == 1, torch.bool)),
            eos_id=None if stop_mask is None else int(self.eos_id))
        return out, m

    # -- prompts -> rows ----------------------------------------------------

    def decode_completion(self, generated_ids) -> str:
        """Token ids -> text, stopping at the first EOS (HF generate
        parity: tokens after EOS must not leak into the response text)."""
        trimmed = tok.trim_at_eos(np.asarray(generated_ids).tolist(),
                                  self.eos_id)
        with self._tok_lock:
            return self.tokenizer.decode(
                trimmed, skip_special_tokens=True).strip()

    def _pad_batch(self, prompts: Sequence[str],
                   pretokenized: Optional[Sequence[Sequence[int]]] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Tokenize + left-pad into the smallest fitting bucket."""
        if pretokenized is not None:
            ids_list = list(pretokenized)
        else:
            with self._tok_lock:
                ids_list = [self.tokenizer(p).input_ids for p in prompts]
        bucket = tok.pick_bucket([len(i) for i in ids_list], self.buckets)
        toks_arr, mask = tok.left_pad_ids(ids_list, bucket,
                                          tok.pad_token_id(self.tokenizer))
        return self._t(toks_arr), self._t(mask)

    def score_prompts(self, prompts: Sequence[str]) -> List[PromptScore]:
        """Score every prompt; one decode per full batch."""
        order = np.argsort([len(p) for p in prompts], kind="stable")
        rows: List[Optional[PromptScore]] = [None] * len(prompts)
        B = self.rt.batch_size
        for start in range(0, len(order), B):
            idx = order[start:start + B]
            rows_out = self._score_batch([prompts[i] for i in idx])
            for i, r in zip(idx, rows_out):
                rows[i] = r
        return rows  # type: ignore[return-value]

    def _score_batch(self, batch_prompts: List[str]) -> List[PromptScore]:
        n = len(batch_prompts)
        B = self.rt.batch_size
        # Tail batch: pad to the next power of two, not the full B.
        bsz = B if n == B else _tail_batch(n, B)
        padded = batch_prompts + [batch_prompts[-1]] * (bsz - n)
        yes_ids = np.full((bsz,), self.yes_id, np.int32)
        no_ids = np.full((bsz,), self.no_id, np.int32)
        fused = self.decode_fused(padded, yes_ids, no_ids)
        res = score.readout_from_fused(
            fused, self._t(yes_ids), self._t(no_ids),
            scan_positions=self.rt.scan_positions).cpu()
        out = []
        for j in range(n):
            out.append(PromptScore(
                prompt=batch_prompts[j],
                completion=self.decode_completion(res.generated[j]),
                yes_prob=float(res.yes_prob[j]),
                no_prob=float(res.no_prob[j]),
                yes_logprob=float(res.yes_logprob[j]),
                no_logprob=float(res.no_logprob[j]),
                odds_ratio=float(res.odds_ratio[j]),
                relative_prob=float(res.relative_prob[j]),
                position_found=int(res.position_found[j]),
                yes_no_found=bool(res.yes_no_found[j]),
            ))
        return out
