"""Greedy decoding with the per-step readouts fused into the decode loop.

Port of the main-path subset of ``lir_tpu/engine/generate.py``: the
reference's measurement is ``model.generate(max_new_tokens=50,
output_scores=True)`` followed by a scan of the first 10 score tensors
(compare_base_vs_instruct.py:251-278). Here one prefill fills the cache,
then a Python loop on the device runs the greedy steps, capturing only
what the sweeps read (no (B, T_new, V) logit stack). The JAX package's
``lax.scan`` is this loop; its all-rows-done ``lax.cond`` is a host check
once per step when an early stop is armed.

The capture paths keep every step's logits instead (the JAX engine's
``decode_prompts``): :func:`greedy_decode` on a decoder and
:func:`t5_greedy_decode` on a T5 encoder-decoder. :func:`sample_decode`
is the temperature sampler of the rephraser and the reasoning sweep: the
same loop with ``ops.gumbel_argmax`` (JAX's threefry draws) in place of
the argmax.

The piggyback chain (:func:`shared_piggyback_prefill`,
:func:`shared_piggyback_step`, :func:`shared_piggyback_drain`) runs a
shared dispatch's prefill and suffix extensions in one call and parks its
two decode loops in a :class:`PiggybackCarry`; the next call runs them
before its own prefill, on one stream with no host sync between them,
and refills the spent carry's cache buffers (the JAX package donates
them). Its two branches keep disjoint cache regions.

The speculative variant (:func:`greedy_decode_fused_shared_spec`)
replaces each branch's sequential loop by a loop over verify WINDOWS of
``spec_k`` teacher-forced positions (:func:`_spec_tail`); its
``lax.cond`` skip of the spent windows is a host check once per window
that ends the loop. One departure from the JAX package: each row's
window starts at the row's next free cache slot instead of a fixed
``spec_k`` slots a window, so the cache holds each row's keys where the
sequential loop holds them and the two routes agree bitwise on the card
(:func:`_spec_tail`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from .. import ops
from ..models import decoder, encdec
from ..models.registry import ModelConfig, T5Config
from . import prng
from . import tokens as _tok


@dataclasses.dataclass
class FusedDecodeOut:
    """Per-step readout captured inside the decode loop — everything the
    sweeps consume."""

    generated: torch.Tensor      # (B, T_new) int32
    p_yes: torch.Tensor          # (B, T_new) float32 softmax prob of the yes id
    p_no: torch.Tensor           # (B, T_new) float32
    top2_ids: torch.Tensor       # (B, T_new, 2) int32 — the top-2 match rule
    topk_logprobs: torch.Tensor  # (B, K) float32 at position 0
    topk_ids: torch.Tensor       # (B, K) int32
    weighted_confidence: torch.Tensor  # (B,) float32 E[v] over digit ids at pos 0


def _small_readout(logits: torch.Tensor, yes_ids: torch.Tensor,
                   no_ids: torch.Tensor):
    """(B, V) float32 logits -> (p_yes, p_no, top2_ids)."""
    lse = torch.logsumexp(logits, dim=-1)
    l_yes = torch.gather(logits, 1, yes_ids.long()[:, None])[:, 0]
    l_no = torch.gather(logits, 1, no_ids.long()[:, None])[:, 0]
    top2 = torch.topk(logits, 2, dim=-1).indices.to(torch.int32)
    return torch.exp(l_yes - lse), torch.exp(l_no - lse), top2


def _position0(logits0: torch.Tensor, digit_ids: torch.Tensor,
               digit_vals: torch.Tensor, topk: int):
    """The readouts taken at the first generated position only: the
    top-k log-prob map and the weighted confidence over the digit ids.
    Shared by the sequential and the speculative loop, so the two compute
    them with the same operations."""
    logp0 = logits0 - torch.logsumexp(logits0, dim=-1, keepdim=True)
    tk = torch.topk(logp0, topk, dim=-1)
    p_digits = torch.exp(logp0[:, digit_ids.long()])          # (B, K)
    mass = torch.clamp_min(p_digits.sum(dim=-1), 1e-10)
    wconf = (p_digits * digit_vals[None, :]).sum(dim=-1) / mass
    return tk.values, tk.indices.to(torch.int32), wconf


def _stop_transition(emit, done, digit_run, prev_ew, stop_mask, eos_id: int,
                     stop_mask2=None, stop_sel=None):
    """One emission's stop-state transition: a row is DONE once it emits
    EOS, or once a standalone digit run is followed by a non-gluing
    token. Rows where ``stop_sel`` is True read the emitted token's class
    from ``stop_mask2`` instead of ``stop_mask``. Shared by the
    sequential and the speculative loop, so their done/digit-run
    evolution cannot drift."""
    cls = stop_mask[emit.long()]
    if stop_mask2 is not None:
        cls = torch.where(stop_sel, stop_mask2[emit.long()], cls)
    pure = (cls & _tok.STOP_PURE) != 0
    prefix = (cls & _tok.STOP_PREFIX) != 0
    glue = (cls & _tok.STOP_STARTS_WORD) != 0
    ends_w = (cls & _tok.STOP_ENDS_WORD) != 0
    transp = (cls & _tok.STOP_TRANSPARENT) != 0
    new_done = done | (emit == int(eos_id)) | (digit_run & ~glue & ~transp)
    new_run = torch.where(
        transp, digit_run,
        (pure & (prefix | ~prev_ew)) | (digit_run & pure & ~prefix))
    new_ew = torch.where(transp, prev_ew, ends_w)
    return new_done, new_run, new_ew


def _fused_tail(params, cfg: ModelConfig, logits0: torch.Tensor, cache,
                cache_mask0: torch.Tensor, pos0: torch.Tensor, slot0: int,
                yes_ids: torch.Tensor, no_ids: torch.Tensor,
                digit_ids: torch.Tensor, digit_vals: torch.Tensor,
                max_new_tokens: int, topk: int,
                stop_mask: Optional[torch.Tensor] = None,
                eos_id: Optional[int] = None,
                decode_trunk: int = 0,
                stop_mask2: Optional[torch.Tensor] = None,
                stop_sel: Optional[torch.Tensor] = None):
    """The fused greedy loop shared by the full-prompt, shared-prefix and
    grouped paths: start from ``logits0`` (the first generated position), write
    generated k/v at cache slots ``slot0 + t``, capture the C13/D6
    readouts. Returns (FusedDecodeOut, final cache).

    ``decode_trunk`` marks the cache's leading shared-trunk slots: every
    decode step then runs the trunk-aware flash-decode kernel.

    ``stop_mask`` ((V,) int32 surface-class bitmask from
    tokens.digit_stop_classes) + ``eos_id`` enable the confidence early
    stop: a row is DONE once it emits EOS, or once a standalone digit run
    is followed by a non-gluing token. Done rows emit EOS from the next
    step, and once EVERY row is done the remaining steps skip the model
    forward. That all-done test reads the device once per step on the
    host (the JAX package keeps it on the device in a ``lax.cond``).

    ``stop_mask2`` + ``stop_sel`` ((B,) bool) select a SECOND class table
    per row (:func:`_stop_transition`): the grouped decode mixes both
    sweep formats in one batch, its binary rows on the EOS-only table and
    its confidence rows on the digit stop.
    """
    early_stop = stop_mask is not None and eos_id is not None
    tk_vals, tk_ids, wconf = _position0(logits0, digit_ids, digit_vals, topk)

    B = logits0.shape[0]
    dev = logits0.device
    logits = logits0
    cache_mask = cache_mask0.clone()
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    digit_run = torch.zeros_like(done)
    prev_ew = torch.zeros_like(done)
    gens, p_yess, p_nos, top2s = [], [], [], []
    for t in range(max_new_tokens):
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        p_yes, p_no, top2 = _small_readout(logits, yes_ids, no_ids)
        if early_stop:
            emit = torch.where(done, torch.full_like(nxt, int(eos_id)), nxt)
            done, digit_run, prev_ew = _stop_transition(
                emit, done, digit_run, prev_ew, stop_mask, eos_id,
                stop_mask2, stop_sel)
            # Host check of the all-rows-done stop (one sync per step).
            if not bool(done.all()):
                cache_mask[:, slot0 + t] = 1
                logits, cache = decoder.decode_step(
                    params, cfg, cache, emit, pos0 + t, slot0 + t, cache_mask,
                    trunk_len=decode_trunk)
        else:
            emit = nxt
            cache_mask[:, slot0 + t] = 1
            logits, cache = decoder.decode_step(
                params, cfg, cache, emit, pos0 + t, slot0 + t, cache_mask,
                trunk_len=decode_trunk)
        gens.append(emit)
        p_yess.append(p_yes)
        p_nos.append(p_no)
        top2s.append(top2)

    return FusedDecodeOut(
        generated=torch.stack(gens, dim=1),
        p_yes=torch.stack(p_yess, dim=1),
        p_no=torch.stack(p_nos, dim=1),
        top2_ids=torch.stack(top2s, dim=1),
        topk_logprobs=tk_vals,
        topk_ids=tk_ids,
        weighted_confidence=wconf,
    ), cache


@torch.inference_mode()
def greedy_decode_fused(params, cfg: ModelConfig, tokens: torch.Tensor,
                        attn_mask: torch.Tensor, yes_ids: torch.Tensor,
                        no_ids: torch.Tensor, digit_ids: torch.Tensor,
                        digit_vals: torch.Tensor, max_new_tokens: int = 50,
                        topk: int = 20, stop_mask=None,
                        eos_id=None) -> FusedDecodeOut:
    """Greedy decode with the C13/D6 readouts fused into the loop.

    yes_ids/no_ids: (B,) per-row target token ids. digit_ids/vals: the
    integer-token table for the weighted-confidence readout (empty to
    skip). stop_mask/eos_id enable the confidence early stop."""
    B, S = tokens.shape
    T = S + max_new_tokens
    logits0, cache, pos0 = decoder.prefill(params, cfg, tokens, attn_mask, T)
    cache_mask0 = F.pad(attn_mask, (0, max_new_tokens))
    out, _ = _fused_tail(params, cfg, logits0, cache, cache_mask0, pos0, S,
                         yes_ids, no_ids, digit_ids, digit_vals,
                         max_new_tokens, topk, stop_mask=stop_mask,
                         eos_id=eos_id)
    return out


@torch.inference_mode()
def greedy_decode_fused_grouped(params, cfg: ModelConfig, prefix, prefix_mask,
                                sfx, sfx_mask, group_idx, yes_ids, no_ids,
                                digit_ids, digit_vals, max_new: int,
                                topk: int = 20, stop_mask=None,
                                stop_mask2=None, stop_sel=None,
                                eos_id=None, return_cache: bool = False):
    """M fused greedy decodes sharing G <= M prefix prefills (cross-cell
    prefix reuse).

    Generalizes :func:`greedy_decode_fused_shared` from "two formats of
    one row share that row's prefill" to "any member rows whose prompts
    share a token prefix share ONE prefill": the distinct prefixes
    prefill once as a (G, S) RIGHT-padded batch (slot == position), the
    cache is gathered out to the M member rows (``group_idx`` (M,) maps
    each member to its prefix, decoder.gather_rows), the member suffixes
    (M, S2) RIGHT-padded run one teacher-forced extension, then the
    fused loop. ``stop_mask``/``stop_mask2``/``stop_sel`` give per-row
    stop tables (see :func:`_fused_tail`). The pairwise special case (G
    rows, 2 members each, ``group_idx = [0, 0, 1, 1, ...]``) scores as
    greedy_decode_fused_shared does. ``return_cache`` also returns the
    final (M-row) cache, from which the engine inserts prefix pages (the
    JAX package's donated scratch buffer has no counterpart here)."""
    S = prefix.shape[1]
    T0 = S + sfx.shape[1] + max_new
    _, gcache, _ = decoder.prefill(params, cfg, prefix, prefix_mask, T0)
    out, cache = _grouped_members(params, cfg, gcache, prefix_mask, sfx,
                                  sfx_mask, group_idx, yes_ids, no_ids,
                                  digit_ids, digit_vals, max_new, topk,
                                  stop_mask, stop_mask2, stop_sel, eos_id)
    return (out, cache) if return_cache else out


def _grouped_members(params, cfg: ModelConfig, gcache, prefix_mask, sfx,
                     sfx_mask, group_idx, yes_ids, no_ids, digit_ids,
                     digit_vals, max_new: int, topk: int, stop_mask,
                     stop_mask2, stop_sel, eos_id):
    """The grouped decode after its (G, S) prefix front, cold or paged:
    gather the G-row cache out to the M member rows, extend the member
    suffixes, run the fused loop. Returns (FusedDecodeOut, final cache)."""
    S = prefix_mask.shape[1]
    M, S2 = sfx.shape
    cache = decoder.gather_rows(gcache, group_idx)
    del gcache
    pm = prefix_mask.index_select(0, group_idx.long())               # (M, S)
    cm = torch.cat([pm, sfx_mask,
                    torch.zeros((M, max_new), dtype=pm.dtype,
                                device=pm.device)], dim=1)
    logits_l, cache, pos = decoder.extend(params, cfg, cache, sfx, sfx_mask,
                                          cm, S)
    return _fused_tail(params, cfg, logits_l, cache, cm, pos, S + S2,
                       yes_ids, no_ids, digit_ids, digit_vals, max_new,
                       topk, stop_mask=stop_mask, eos_id=eos_id,
                       stop_mask2=stop_mask2, stop_sel=stop_sel)


def _branches(params, cfg: ModelConfig, cache, T0: int, prefix_mask,
              sfx_a, sfx_a_mask, sfx_b, sfx_b_mask, yes_ids, no_ids,
              digit_ids, digit_vals, max_new_a: int, max_new_b: int,
              topk: int, stop_mask_b, stop_mask_a, eos_id,
              decode_trunk: int):
    """The two format branches over one prefilled cache: each extends its
    suffix at the prefix edge and runs the fused loop. Branch B reuses
    branch A's cache (A's suffix and generated slots are overwritten or
    masked out of B's cache mask). Returns (binary out, confidence out,
    final cache); the prefix slots [0, S) of the final cache are the
    front's, untouched by either branch."""
    B, S = prefix_mask.shape
    empty_ids = torch.zeros((0,), dtype=torch.int32, device=prefix_mask.device)
    empty_vals = torch.zeros((0,), dtype=torch.float32,
                             device=prefix_mask.device)

    def branch(cache_in, sfx, sfx_mask, new_tokens, d_ids, d_vals,
               stop_mask=None):
        S2 = sfx.shape[1]
        cm = torch.cat([prefix_mask, sfx_mask,
                        torch.zeros((B, T0 - S - S2), dtype=prefix_mask.dtype,
                                    device=prefix_mask.device)], dim=1)
        logits_l, cache2, pos = decoder.extend(params, cfg, cache_in, sfx,
                                               sfx_mask, cm, S)
        return _fused_tail(params, cfg, logits_l, cache2, cm, pos, S + S2,
                           yes_ids, no_ids, d_ids, d_vals, new_tokens, topk,
                           stop_mask=stop_mask, eos_id=eos_id,
                           decode_trunk=decode_trunk)

    # The binary branch (A) takes the EOS-only stop when armed; the
    # confidence branch (B) the digit table and the digit early stop.
    out_a, cache_a = branch(cache, sfx_a, sfx_a_mask, max_new_a,
                            empty_ids, empty_vals, stop_mask=stop_mask_a)
    out_b, cache_b = branch(cache_a, sfx_b, sfx_b_mask, max_new_b,
                            digit_ids, digit_vals, stop_mask=stop_mask_b)
    return out_a, out_b, cache_b


@torch.inference_mode()
def greedy_decode_fused_shared(params, cfg: ModelConfig, prefix, prefix_mask,
                               sfx_a, sfx_a_mask, sfx_b, sfx_b_mask, yes_ids,
                               no_ids, digit_ids, digit_vals, max_new_a: int,
                               max_new_b: int, topk: int = 20,
                               stop_mask_b=None, stop_mask_a=None,
                               eos_id=None, decode_trunk: int = 0,
                               return_cache: bool = False):
    """TWO fused greedy decodes sharing ONE prefill over a common prefix.

    The perturbation sweep scores every cell under two formats whose
    prompts differ only in a short trailing instruction. The shared
    prefix (B, S) RIGHT-padded (slot == token position) is prefilled
    once, then each format's suffix (B, S2*) RIGHT-padded runs one
    teacher-forced extension followed by the fused loop. Returns
    (binary FusedDecodeOut, confidence FusedDecodeOut), with the final
    cache third when ``return_cache`` (the engine inserts prefix pages
    from it)."""
    B, S = prefix.shape
    S2a, S2b = sfx_a.shape[1], sfx_b.shape[1]
    T0 = S + max(S2a + max_new_a, S2b + max_new_b)
    _, cache, _ = decoder.prefill(params, cfg, prefix, prefix_mask, T0)
    out = _branches(params, cfg, cache, T0, prefix_mask, sfx_a, sfx_a_mask,
                    sfx_b, sfx_b_mask, yes_ids, no_ids, digit_ids,
                    digit_vals, max_new_a, max_new_b, topk, stop_mask_b,
                    stop_mask_a, eos_id, decode_trunk)
    return out if return_cache else out[:2]


# ---------------------------------------------------------------------------
# Piggyback chains: a parked dispatch's decode loops ride the next prefill
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PiggybackCarry:
    """One shared dispatch parked between engine calls with its decode
    loops still to run: its prefill and both suffix extensions have run,
    and the next call of the chain runs its two loops before that call's
    own prefill (:func:`shared_piggyback_step`), one engine call a
    dispatch.

    A parked cache must keep BOTH branches alive, so its layout gives
    each branch a region of its own: slots [S, S + S2a + max_new_a) for
    branch A, then branch B's suffix and decode slots after it. Slots are
    physical only (positions, masks and causality are mask-aware), so a
    row's results are the plain dispatch's."""

    logits_a: torch.Tensor   # (B, V) float32, branch A's first position
    logits_b: torch.Tensor
    cache: object            # the KV cache, the branches' regions disjoint
    cm_a: torch.Tensor       # (B, T) branch A's cache mask (B's region 0)
    cm_b: torch.Tensor
    pos_a: torch.Tensor      # (B,) next mask-aware decode positions
    pos_b: torch.Tensor


def piggyback_total_len(S: int, S2a: int, S2b: int, max_new_a: int,
                        max_new_b: int) -> int:
    """Cache extent of a chained dispatch: both branch regions after the
    prefix, S + S2a + max_new_a + S2b + max_new_b."""
    return S + S2a + max_new_a + S2b + max_new_b


def _piggyback_extend(params, cfg: ModelConfig, prefix, prefix_mask, sfx_a,
                      sfx_a_mask, sfx_b, sfx_b_mask, max_new_a: int,
                      max_new_b: int, cache=None) -> PiggybackCarry:
    """Prefill + both suffix extensions WITHOUT the decode loops, into
    the disjoint-region layout (see PiggybackCarry). ``cache``: a spent
    carry's buffers of this layout to fill instead of new ones."""
    B, S = prefix.shape
    S2a, S2b = sfx_a.shape[1], sfx_b.shape[1]
    T = piggyback_total_len(S, S2a, S2b, max_new_a, max_new_b)
    _, cache, _ = decoder.prefill(params, cfg, prefix, prefix_mask, T,
                                  cache=cache)

    def zeros(n):
        return torch.zeros((B, n), dtype=prefix_mask.dtype,
                           device=prefix_mask.device)

    cm_a = torch.cat([prefix_mask, sfx_a_mask, zeros(T - S - S2a)], dim=1)
    logits_a, cache, pos_a = decoder.extend(params, cfg, cache, sfx_a,
                                            sfx_a_mask, cm_a, S)
    off_b = S + S2a + max_new_a
    cm_b = torch.cat([prefix_mask, zeros(S2a + max_new_a), sfx_b_mask,
                      zeros(max_new_b)], dim=1)
    logits_b, cache, pos_b = decoder.extend(params, cfg, cache, sfx_b,
                                            sfx_b_mask, cm_b, off_b)
    return PiggybackCarry(logits_a=logits_a, logits_b=logits_b, cache=cache,
                          cm_a=cm_a, cm_b=cm_b, pos_a=pos_a, pos_b=pos_b)


def _piggyback_scan(params, cfg: ModelConfig, carry: PiggybackCarry,
                    yes_ids, no_ids, digit_ids, digit_vals, slot0_a: int,
                    slot0_b: int, max_new_a: int, max_new_b: int, topk: int,
                    stop_mask_a, stop_mask_b, eos_id):
    """The parked dispatch's two fused decode loops (branch A, then B,
    over the one carried cache; B's mask leaves out A's region, so each
    row's results are the plain dispatch's). Returns (binary out,
    confidence out)."""
    dev = carry.logits_a.device
    empty_ids = torch.zeros((0,), dtype=torch.int32, device=dev)
    empty_vals = torch.zeros((0,), dtype=torch.float32, device=dev)
    out_a, cache = _fused_tail(params, cfg, carry.logits_a, carry.cache,
                               carry.cm_a, carry.pos_a, slot0_a, yes_ids,
                               no_ids, empty_ids, empty_vals, max_new_a, topk,
                               stop_mask=stop_mask_a, eos_id=eos_id)
    out_b, _ = _fused_tail(params, cfg, carry.logits_b, cache, carry.cm_b,
                           carry.pos_b, slot0_b, yes_ids, no_ids, digit_ids,
                           digit_vals, max_new_b, topk,
                           stop_mask=stop_mask_b, eos_id=eos_id)
    return out_a, out_b


@torch.inference_mode()
def shared_piggyback_prefill(params, cfg: ModelConfig, prefix, prefix_mask,
                             sfx_a, sfx_a_mask, sfx_b, sfx_b_mask,
                             max_new_a: int, max_new_b: int
                             ) -> PiggybackCarry:
    """Open a piggyback chain: the first dispatch's prefill and suffix
    extensions; its decode loops are parked in the returned carry."""
    return _piggyback_extend(params, cfg, prefix, prefix_mask, sfx_a,
                             sfx_a_mask, sfx_b, sfx_b_mask, max_new_a,
                             max_new_b)


@torch.inference_mode()
def shared_piggyback_step(params, cfg: ModelConfig, carry: PiggybackCarry,
                          prefix, prefix_mask, sfx_a, sfx_a_mask, sfx_b,
                          sfx_b_mask, yes_ids, no_ids, digit_ids, digit_vals,
                          max_new_a: int, max_new_b: int, topk: int = 20,
                          stop_mask_a=None, stop_mask_b=None, eos_id=None):
    """One piggybacked call: the PARKED dispatch's decode loops, then the
    NEXT dispatch's prefill and suffix extensions, queued on one stream
    with no host sync between them. ``yes_ids``/``no_ids`` and the stop
    tables belong to the parked dispatch; the chain's shapes and budgets
    are the same by construction (the sweep chains same-shape dispatches
    only), so the new carry fills the old carry's cache buffers, which
    the parked loops have read by then in stream order (the JAX package
    donates the old carry). Returns (parked binary out, parked confidence
    out, new carry)."""
    S = prefix.shape[1]
    S2a, S2b = sfx_a.shape[1], sfx_b.shape[1]
    out_a, out_b = _piggyback_scan(
        params, cfg, carry, yes_ids, no_ids, digit_ids, digit_vals, S + S2a,
        S + S2a + max_new_a + S2b, max_new_a, max_new_b, topk, stop_mask_a,
        stop_mask_b, eos_id)
    new_carry = _piggyback_extend(params, cfg, prefix, prefix_mask, sfx_a,
                                  sfx_a_mask, sfx_b, sfx_b_mask, max_new_a,
                                  max_new_b, cache=carry.cache)
    return out_a, out_b, new_carry


@torch.inference_mode()
def shared_piggyback_drain(params, cfg: ModelConfig, carry: PiggybackCarry,
                           yes_ids, no_ids, digit_ids, digit_vals,
                           slot0_a: int, slot0_b: int, max_new_a: int,
                           max_new_b: int, topk: int = 20, stop_mask_a=None,
                           stop_mask_b=None, eos_id=None):
    """Close a piggyback chain: the last parked dispatch's decode loops
    alone. Returns (binary out, confidence out)."""
    return _piggyback_scan(params, cfg, carry, yes_ids, no_ids, digit_ids,
                           digit_vals, slot0_a, slot0_b, max_new_a,
                           max_new_b, topk, stop_mask_a, stop_mask_b, eos_id)


def _paged_prefix(params, cfg: ModelConfig, pool, slot_src: torch.Tensor,
                  win_start: int, prefix_mask: torch.Tensor,
                  rem: torch.Tensor, rem_mask: torch.Tensor, total_len: int):
    """The paged replacement for the shared-prefill step: assemble the
    cached prefix KV from the page pool (``paged.gather_slots`` over
    ``slot_src`` (B, S)) and teacher-force the recompute WINDOW — slots
    [w0, w0 + R), each row's prefix tokens in that range RIGHT-padded
    into ``rem``/``rem_mask`` (B, R) — through one chunked extension
    over the S-slot view of the cache (``decoder.extend`` at
    ``start_index = win_start``; the window is anchored at the
    dispatch's longest real row, so rows shorter than the bucket pay no
    recompute for pad slots). The cache is allocated at ``total_len``
    slots, [S, total_len) zeros, as the cold prefill allocates it.

    ``prefix_mask`` is the right-pad mask (B, S) the unpaged path
    computes (slot == token position), so a page produced under any row
    length backs any later row sharing the prefix. Unfilled slots read
    the trash page; they are masked, and a masked key adds an exact zero
    to the softmax.

    The window's bits are not the cold prefill's: its projections run
    at B * R rows and its attention through the cached route, where the
    cold prefill runs B * S rows through the prefill route, and the
    products round by their shapes. Its floats agree within float
    tolerance, and greedy ids may flip where the top two are near tied.
    Returns the (ck, cv) cache."""
    S = prefix_mask.shape[1]
    from ..models import paged

    cache = paged.gather_slots(pool, slot_src, total_len)
    view = decoder.cache_map(lambda c: c[:, :, :S], cache)   # S-slot view
    decoder.extend(params, cfg, view, rem, rem_mask, prefix_mask,
                   int(win_start))
    return cache


@torch.inference_mode()
def greedy_decode_fused_shared_paged(params, cfg: ModelConfig, pool,
                                     slot_src, win_start: int, prefix_mask,
                                     rem, rem_mask, sfx_a, sfx_a_mask, sfx_b,
                                     sfx_b_mask, yes_ids, no_ids, digit_ids,
                                     digit_vals, max_new_a: int,
                                     max_new_b: int, topk: int = 20,
                                     stop_mask_b=None, stop_mask_a=None,
                                     eos_id=None, decode_trunk: int = 0):
    """:func:`greedy_decode_fused_shared` resuming from the cross-request
    radix prefix cache: the prefill over each row's shared prefix is a
    page-pool slot gather plus one chunked extension over the per-row
    remainder window (:func:`_paged_prefix`); the two format branches
    and the fused loops are the unpaged path's own code at its shapes.
    Returns (binary out, confidence out, final cache)."""
    B, S = prefix_mask.shape
    T0 = S + max(sfx_a.shape[1] + max_new_a, sfx_b.shape[1] + max_new_b)
    cache = _paged_prefix(params, cfg, pool, slot_src, win_start,
                          prefix_mask, rem, rem_mask, T0)
    return _branches(params, cfg, cache, T0, prefix_mask, sfx_a, sfx_a_mask,
                     sfx_b, sfx_b_mask, yes_ids, no_ids, digit_ids,
                     digit_vals, max_new_a, max_new_b, topk, stop_mask_b,
                     stop_mask_a, eos_id, decode_trunk)


def _cascade_branches(params, cfg: ModelConfig, tcache, trunk_len: int,
                      prefix, prefix_mask, sfx_a, sfx_a_mask, sfx_b,
                      sfx_b_mask, yes_ids, no_ids, digit_ids, digit_vals,
                      max_new_a: int, max_new_b: int, topk: int,
                      stop_mask_b, stop_mask_a, eos_id, int8_qk: bool = False):
    """Cascade-extend the per-row remainders over the (L, K, trunk_len,
    1, hd) trunk cache (``int8_qk``: the trunk leg's QK^T in int8), then
    run the two format branches as the dense shared path's own code,
    their decode steps on the trunk kernel. Shared by the cold and the
    paged cascade. Returns (binary out, confidence out, final cache),
    whose every row holds the trunk at slots [0, trunk_len)."""
    B, S = prefix.shape
    S2a, S2b = sfx_a.shape[1], sfx_b.shape[1]
    T0 = S + max(S2a + max_new_a, S2b + max_new_b)
    rem = prefix[:, trunk_len:]
    rem_mask = prefix_mask[:, trunk_len:]
    cache = decoder.cascade_extend(params, cfg, tcache, rem, rem_mask,
                                   trunk_len, T0, int8_qk=int8_qk)
    return _branches(params, cfg, cache, T0, prefix_mask, sfx_a, sfx_a_mask,
                     sfx_b, sfx_b_mask, yes_ids, no_ids, digit_ids,
                     digit_vals, max_new_a, max_new_b, topk, stop_mask_b,
                     stop_mask_a, eos_id, trunk_len)


@torch.inference_mode()
def greedy_decode_fused_shared_cascade(params, cfg: ModelConfig, prefix,
                                       prefix_mask, sfx_a, sfx_a_mask, sfx_b,
                                       sfx_b_mask, yes_ids, no_ids,
                                       digit_ids, digit_vals, max_new_a: int,
                                       max_new_b: int, trunk_len: int,
                                       topk: int = 20, int8_qk: bool = False,
                                       stop_mask_b=None, stop_mask_a=None,
                                       eos_id=None, return_cache: bool = False):
    """:func:`greedy_decode_fused_shared` with the SHARED-TRUNK prefill
    decomposed: every row shares its first ``trunk_len`` tokens, so the
    trunk prefill runs ONCE at batch 1 (mask all ones, slot t is position
    t), the per-row remainders extend over it through the cascade
    kernels (``int8_qk``: int8 QK^T in the trunk leg), and the two format
    branches are the dense path's own code. ``return_cache`` also
    returns the final cache."""
    ones = torch.ones((1, trunk_len), dtype=prefix_mask.dtype,
                      device=prefix_mask.device)
    _, tcache, _ = decoder.prefill(params, cfg, prefix[:1, :trunk_len], ones,
                                   trunk_len)
    out = _cascade_branches(params, cfg, tcache, trunk_len, prefix,
                            prefix_mask, sfx_a, sfx_a_mask, sfx_b,
                            sfx_b_mask, yes_ids, no_ids, digit_ids,
                            digit_vals, max_new_a, max_new_b, topk,
                            stop_mask_b, stop_mask_a, eos_id, int8_qk)
    return out if return_cache else out[:2]


@torch.inference_mode()
def greedy_decode_fused_shared_cascade_paged(
        params, cfg: ModelConfig, pool, slot_src, win_start: int,
        trunk_mask, trunk_rem, trunk_rem_mask, prefix, prefix_mask, sfx_a,
        sfx_a_mask, sfx_b, sfx_b_mask, yes_ids, no_ids, digit_ids,
        digit_vals, max_new_a: int, max_new_b: int, trunk_len: int,
        topk: int = 20, int8_qk: bool = False, stop_mask_b=None,
        stop_mask_a=None, eos_id=None):
    """:func:`greedy_decode_fused_shared_cascade` with the TRUNK resumed
    from the cross-request radix prefix cache: the batch-1 trunk prefill
    is a page-pool slot gather plus one recompute-window extension
    (:func:`_paged_prefix` at one row, ``total_len == trunk_len``, so no
    tail pad); everything from the cascade extension on is the cold
    cascade's code. Returns (binary out, confidence out, final cache)."""
    tcache = _paged_prefix(params, cfg, pool, slot_src, win_start,
                           trunk_mask, trunk_rem, trunk_rem_mask, trunk_len)
    return _cascade_branches(params, cfg, tcache, trunk_len, prefix,
                             prefix_mask, sfx_a, sfx_a_mask, sfx_b,
                             sfx_b_mask, yes_ids, no_ids, digit_ids,
                             digit_vals, max_new_a, max_new_b, topk,
                             stop_mask_b, stop_mask_a, eos_id, int8_qk)


@torch.inference_mode()
def greedy_decode_fused_grouped_paged(params, cfg: ModelConfig, pool,
                                      slot_src, win_start: int, prefix_mask,
                                      rem, rem_mask, sfx, sfx_mask, group_idx,
                                      yes_ids, no_ids, digit_ids, digit_vals,
                                      max_new: int, topk: int = 20,
                                      stop_mask=None, stop_mask2=None,
                                      stop_sel=None, eos_id=None):
    """:func:`greedy_decode_fused_grouped` resuming the group prefixes
    from the radix prefix cache: the (G, S) group prefill is a page-pool
    slot gather plus one remainder-window extension
    (:func:`_paged_prefix` at G rows), then the member-row gather, the
    suffix extension and the fused loop run as the unpaged grouped
    path's own code. Returns (FusedDecodeOut, final M-row cache)."""
    S = prefix_mask.shape[1]
    T0 = S + sfx.shape[1] + max_new
    gcache = _paged_prefix(params, cfg, pool, slot_src, win_start,
                           prefix_mask, rem, rem_mask, T0)
    return _grouped_members(params, cfg, gcache, prefix_mask, sfx, sfx_mask,
                            group_idx, yes_ids, no_ids, digit_ids,
                            digit_vals, max_new, topk, stop_mask, stop_mask2,
                            stop_sel, eos_id)


# ---------------------------------------------------------------------------
# Speculative scoring decode (n-gram drafting, one fused verify a window)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SpecOut:
    """Per-branch speculative-decode accounting, folded into the engine's
    ``spec_stats`` at flush time (engine/spec.flush_pending).
    ``drafted``/``accepted`` are (3,) int32 token counts by draft source,
    the JAX package's lanes: 0 = radix-tree continuation (the given
    drafts), 1 = n-gram prompt lookup (including the zero filler), 2 =
    fleet draft model. ``chunks`` counts the verify
    forwards run; ``seq_steps`` the forwards the sequential loop would
    have run on the same rows (its all-done early exit included)."""

    drafted: torch.Tensor    # (3,) int32
    accepted: torch.Tensor   # (3,) int32
    chunks: torch.Tensor     # () int32
    seq_steps: torch.Tensor  # () int32


def _spec_tail(params, cfg: ModelConfig, logits0: torch.Tensor, cache,
               cache_mask0: torch.Tensor, slot0: int,
               yes_ids: torch.Tensor, no_ids: torch.Tensor,
               digit_ids: torch.Tensor, digit_vals: torch.Tensor,
               max_new_tokens: int, topk: int, spec_k: int,
               ctx0: torch.Tensor, ctx0_len: torch.Tensor,
               draft_tokens: torch.Tensor, draft_len: torch.Tensor,
               stop_mask: Optional[torch.Tensor] = None,
               eos_id: Optional[int] = None, ngram: int = 2,
               decode_trunk: int = 0, draft_params=None, draft_cfg=None,
               dcache=None):
    """The speculative counterpart of :func:`_fused_tail`: instead of T
    sequential decode steps, run up to T verify WINDOWS of ``spec_k``
    teacher-forced positions each — [pending emission, draft, draft, ...]
    — through ONE multi-query forward (decoder.verify_extend), then
    greedily accept the draft prefix the verifier's own argmax confirms.
    A window emits between 1 and spec_k tokens.

    Slots are COMPACTED per row, where the JAX package gives window c the
    fixed slots slot0 + c * spec_k: row b's window starts at its next free
    slot, slot0 + filled_b, so its accepted tokens land exactly where the
    sequential loop puts them, the slots past its new fill go back to
    mask 0, and the next window overwrites the rejected tail. The JAX
    package keeps spec_k slots a window because XLA needs static shapes
    (and accepts regrouped keys); the port runs eagerly. With the same
    valid keys at the same slots, the decode kernels' fixed 64-slot
    splits group them as the sequential step does, and a trailing split
    that holds no valid key adds exact zeros in the split-order merge, so
    the cache's larger extent (``spec_total_len``, which still bounds
    every window) moves no bit.

    Every consumed result is the sequential loop's: an accepted draft is
    accepted BECAUSE it equals the verifier's argmax at its position, so
    the emitted tokens and the top-2 stream match, and the position-0
    readouts are computed from the same logits by the same operations.
    On the kernel route the interior per-step readouts are bitwise too:
    with compacted slots and the decoder's row-invariant norms and
    projections, window position j gives decode_step's logits (on the
    dense route they match within float tolerance). Done rows advance on
    forced-EOS drafts, reproducing the sequential loop's EOS-fed
    evolution, and once every row is done the positions past the global
    stop step are rewritten with the stop step's values — the sequential
    loop's all-done freeze.

    Drafts come from ``draft_tokens`` (B, T), valid below ``draft_len``
    (the engine's radix-tree continuations; zero length without a prefix
    cache), else from
    an ``ngram``-gram lookup over ``ctx0`` (each row's compacted prompt,
    right-padded to a width >= prompt + T) extended with the accepted
    emissions. With ``draft_params`` a fleet draft model drafts instead:
    spec_k sequential ``decoder.decode_step`` calls a window over its own
    ``dcache`` (written in place), at the window's own slots (each row's
    next free slot, the verifier's compacted layout) under the
    verifier's mask, so its cache holds every window token's k/v where
    the verifier's does; the last step only writes the last draft's k/v.
    Its tokens count in lane 2 of ``drafted``/``accepted``. The JAX package's ``lax.scan`` over
    the windows is a Python loop; its ``lax.cond`` skip of spent windows
    is one host test a window that ends the loop (once false it stays
    false: nothing changes in a skipped window). Returns (FusedDecodeOut,
    cache, SpecOut)."""
    assert spec_k >= 2, "speculation needs a draft window of >= 2"
    early = stop_mask is not None and eos_id is not None
    fleet = draft_params is not None
    T = max_new_tokens
    B = logits0.shape[0]
    W = ctx0.shape[1]
    dev = logits0.device
    i32 = torch.int32
    tk_vals, tk_ids, wconf = _position0(logits0, digit_ids, digit_vals, topk)

    rows = torch.arange(B, device=dev)
    eos = (torch.full((B,), int(eos_id), dtype=i32, device=dev)
           if early else None)
    logits = logits0
    cache_mask = cache_mask0.clone()
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    digit_run = torch.zeros_like(done)
    prev_ew = torch.zeros_like(done)
    filled = torch.zeros((B,), dtype=i32, device=dev)
    done_step = torch.full((B,), T, dtype=i32, device=dev)
    # Each buffer carries one trash column (index T, or W for ctx) that
    # the writes of rows not taking part land in (the JAX mode="drop").
    ctx = torch.zeros((B, W + 1), dtype=i32, device=dev)
    ctx[:, :W] = ctx0
    ctx_n = ctx0_len.to(i32)
    gen = torch.zeros((B, T + 1), dtype=i32, device=dev)
    p_yes = torch.zeros((B, T + 1), dtype=torch.float32, device=dev)
    p_no = torch.zeros_like(p_yes)
    top2 = torch.zeros((B, T + 1, 2), dtype=i32, device=dev)
    drafted = torch.zeros((3,), dtype=i32, device=dev)
    accepted = torch.zeros((3,), dtype=i32, device=dev)
    chunks = 0

    def put(buf, idx, val, ok, trash: int):
        buf[rows, torch.where(ok, idx, trash).long()] = val

    def ctx_at(idx):
        return ctx[rows, idx.clamp(0, W - 1).long()]

    n_pos = W - ngram + 1
    pidx = torch.arange(n_pos, device=dev)
    offs = torch.arange(spec_k, device=dev)
    for c in range(T):
        # The window runs while some live row still has positions to
        # fill (up to the global stop step once every row is done).
        needed = torch.where(done.all(),
                             torch.clamp_max(done_step.max() + 1, T), T)
        if not bool(filled.min() < needed):
            break
        base = slot0 + filled                              # (B,) start slots
        wslots = base.long()[:, None] + offs[None, :]      # (B, spec_k)
        live0 = filled < T
        done0 = done

        # -- emission 0: the pending token, from the carried logits.
        nxt = torch.argmax(logits, dim=-1).to(i32)
        e0 = torch.where(done, eos, nxt) if early else nxt
        py0, pn0, t20 = _small_readout(logits, yes_ids, no_ids)
        put(gen, filled, e0, live0, T)
        put(p_yes, filled, py0, live0, T)
        put(p_no, filled, pn0, live0, T)
        put(top2, filled, t20, live0, T)
        if early:
            nd, nr, ne = _stop_transition(e0, done, digit_run, prev_ew,
                                          stop_mask, eos_id)
            done_step = torch.where(live0 & nd & ~done, filled, done_step)
            done = torch.where(live0, nd, done)
            digit_run = torch.where(live0, nr, digit_run)
            prev_ew = torch.where(live0, ne, prev_ew)
        put(ctx, ctx_n.clamp(0, W - 1), e0, live0, W)
        ctx_n = ctx_n + live0.to(i32)

        drafts, src_tree = [], []
        if fleet:
            # -- the fleet draft model: spec_k small steps, token j at
            # slot base + j, the mask grown one slot a step.
            dm = cache_mask.clone()
            d = e0
            for j in range(spec_k):
                slot_j = wslots[:, j]
                dm[rows, slot_j] = 1
                pos_j = decoder.mask_positions(dm).gather(
                    1, slot_j[:, None])[:, 0]
                dl, dcache = decoder.decode_step(draft_params, draft_cfg,
                                                 dcache, d, pos_j, slot_j,
                                                 dm)
                if j < spec_k - 1:
                    d = torch.argmax(dl, dim=-1).to(i32)
                    if early:
                        d = torch.where(done, eos, d)
                    drafts.append(d)
                    src_tree.append(torch.zeros_like(done))
        else:
            # -- drafts for window positions 1..spec_k-1: the given draft
            # where valid, else the tokens that followed the latest
            # earlier occurrence of the last `ngram` context tokens (e0
            # included).
            eq = torch.ones((B, n_pos), dtype=torch.bool, device=dev)
            for m in range(ngram):
                pat = ctx_at(ctx_n - ngram + m)
                eq &= ctx[:, m:m + n_pos] == pat[:, None]
            ok_pos = ((pidx[None, :] + ngram <= ctx_n[:, None] - 1)
                      & (ctx_n >= ngram)[:, None])
            best = torch.where(eq & ok_pos, pidx[None, :], -1).amax(dim=1)
            for j in range(1, spec_k):
                t_idx = filled + j
                tval = draft_tokens.gather(
                    1, t_idx.clamp(0, T - 1).long()[:, None])[:, 0]
                t_ok = t_idx < draft_len
                ng_idx = best + ngram + (j - 1)
                ng_ok = (best >= 0) & (ng_idx < ctx_n)
                d = torch.where(t_ok, tval,
                                torch.where(ng_ok, ctx_at(ng_idx), 0))
                if early:
                    d = torch.where(done, eos, d)
                drafts.append(d.to(i32))
                src_tree.append(t_ok & ~done)

        # -- ONE fused verify over [e0, drafts...]
        X = torch.stack([e0] + drafts, dim=1)              # (B, spec_k)
        cm_run = cache_mask.clone()
        cm_run.scatter_(1, wslots, 1)
        V, cache = decoder.verify_extend(params, cfg, cache, X, cm_run, base,
                                         trunk_len=decode_trunk)

        # -- greedy acceptance + per-position emissions
        acc = live0
        n_new = live0.to(i32)
        d_state, r_state, e_state = done, digit_run, prev_ew
        for j in range(1, spec_k):
            Vj = V[:, j - 1]
            rj = torch.argmax(Vj, dim=-1).to(i32)
            if early:
                rj = torch.where(d_state, eos, rj)
            can = acc & (filled + j < T)
            ok = can & (X[:, j] == rj)
            pyj, pnj, t2j = _small_readout(Vj, yes_ids, no_ids)
            put(gen, filled + j, rj, ok, T)
            put(p_yes, filled + j, pyj, ok, T)
            put(p_no, filled + j, pnj, ok, T)
            put(top2, filled + j, t2j, ok, T)
            put(ctx, (ctx_n - 1 + j).clamp(0, W - 1), rj, ok, W)
            if early:
                nd, nr, ne = _stop_transition(rj, d_state, r_state, e_state,
                                              stop_mask, eos_id)
                done_step = torch.where(ok & nd & ~d_state, filled + j,
                                        done_step)
                d_state = torch.where(ok, nd, d_state)
                r_state = torch.where(ok, nr, r_state)
                e_state = torch.where(ok, ne, e_state)
            counted = can & ~done0
            zero = torch.zeros((), dtype=torch.int64, device=dev)
            if fleet:
                drafted += torch.stack([zero, zero, counted.sum()]).to(i32)
                accepted += torch.stack([zero, zero,
                                         (ok & ~done0).sum()]).to(i32)
            else:
                tr = src_tree[j - 1]
                drafted += torch.stack([(counted & tr).sum(),
                                        (counted & ~tr).sum(), zero]).to(i32)
                accepted += torch.stack([(ok & ~done0 & tr).sum(),
                                         (ok & ~done0 & ~tr).sum(),
                                         zero]).to(i32)
            n_new = n_new + ok.to(i32)
            acc = ok

        # Next pending logits: after the LAST emitted token. The window's
        # validity shrinks to the emitted prefix.
        last = torch.clamp(n_new - 1, 0, spec_k - 1).long()
        logits = torch.where(live0[:, None], V[rows, last], logits)
        cm_run.scatter_(1, wslots, (offs[None, :] < n_new[:, None])
                        .to(cm_run.dtype))
        cache_mask = cm_run
        done, digit_run, prev_ew = d_state, r_state, e_state
        filled = filled + n_new
        ctx_n = ctx_n + (n_new - live0.to(i32))
        chunks += 1

    gen, p_yes = gen[:, :T], p_yes[:, :T]
    p_no, top2 = p_no[:, :T], top2[:, :T]
    if early:
        # The sequential loop's all-done freeze: once EVERY row is done
        # (global stop step t*), it skips the model forward and repeats
        # the t*-step values to the end of the budget.
        all_done = done.all()
        tstar = done_step.max()
        fr = torch.clamp(tstar, 0, T - 1).long().reshape(1)
        tail = all_done & (torch.arange(T, device=dev)[None, :] > tstar)
        gen = torch.where(tail, int(eos_id), gen)
        p_yes = torch.where(tail, p_yes.index_select(1, fr), p_yes)
        p_no = torch.where(tail, p_no.index_select(1, fr), p_no)
        top2 = torch.where(tail[..., None], top2.index_select(1, fr), top2)
        seq_steps = torch.where(all_done, torch.clamp_max(tstar, T), T)
    else:
        seq_steps = torch.tensor(T, device=dev)

    out = FusedDecodeOut(
        generated=gen.contiguous(), p_yes=p_yes.contiguous(),
        p_no=p_no.contiguous(), top2_ids=top2.contiguous(),
        topk_logprobs=tk_vals, topk_ids=tk_ids, weighted_confidence=wconf)
    spec = SpecOut(drafted=drafted, accepted=accepted,
                   chunks=torch.tensor(chunks, dtype=i32, device=dev),
                   seq_steps=seq_steps.to(i32))
    return out, cache, spec


def _shared_spec_branches(params, cfg: ModelConfig, cache, prefix_mask,
                          sfx_a, sfx_a_mask, sfx_b, sfx_b_mask, yes_ids,
                          no_ids, digit_ids, digit_vals, ctx_a, ctx_a_len,
                          draft_a, draft_a_len, ctx_b, ctx_b_len, draft_b,
                          draft_b_len, T0: int, max_new_a: int,
                          max_new_b: int, spec_k: int, ngram: int, topk: int,
                          stop_mask_a, stop_mask_b, eos_id,
                          decode_trunk: int = 0, draft_params=None,
                          draft_cfg=None, dcache=None):
    """Both format branches of a shared-prefix dispatch through the
    speculative tail; branch B reuses branch A's cache, as the sequential
    path does (masks keep the branches disjoint). With a fleet draft
    model (``draft_params``, ``draft_cfg`` and its prefilled ``dcache``)
    the draft model's cache takes the same suffix extensions and carries
    from branch A to branch B the same way.

    The suffix extension that produces each branch's position-0 logits
    runs over a view of the cache cut to the SEQUENTIAL path's extent
    (``T0_seq``): the dense products reduce over the attention extent,
    so extending at the longer speculative extent would move the low
    bits of the position-0 readouts. The view shares the cache's storage
    and the extension writes only the suffix slots, so those are the only
    slots written back. Returns (binary out, confidence out, binary
    SpecOut, confidence SpecOut, final cache)."""
    B, S = prefix_mask.shape
    dev = prefix_mask.device
    empty_ids = torch.zeros((0,), dtype=torch.int32, device=dev)
    empty_vals = torch.zeros((0,), dtype=torch.float32, device=dev)
    T0_seq = S + max(sfx_a.shape[1] + max_new_a, sfx_b.shape[1] + max_new_b)

    def cache_mask(sfx_mask, extent):
        S2 = sfx_mask.shape[1]
        return torch.cat([prefix_mask, sfx_mask,
                          torch.zeros((B, extent - S - S2),
                                      dtype=prefix_mask.dtype, device=dev)],
                         dim=1)

    def extend_seq_extent(ext_params, ext_cfg, cache_in, sfx, sfx_mask):
        view = decoder.cache_map(lambda c: c[:, :, :T0_seq], cache_in)
        logits_l, _, _ = decoder.extend(ext_params, ext_cfg, view, sfx,
                                        sfx_mask,
                                        cache_mask(sfx_mask, T0_seq), S)
        return logits_l

    def branch(cache_in, dcache_in, sfx, sfx_mask, new_tokens, d_ids,
               d_vals, ctx, ctx_len, dr, dr_len, stop_mask):
        S2 = sfx.shape[1]
        logits_l = extend_seq_extent(params, cfg, cache_in, sfx, sfx_mask)
        if dcache_in is not None:
            extend_seq_extent(draft_params, draft_cfg, dcache_in, sfx,
                              sfx_mask)
        return _spec_tail(
            params, cfg, logits_l, cache_in, cache_mask(sfx_mask, T0),
            S + S2, yes_ids, no_ids, d_ids, d_vals, new_tokens, topk, spec_k,
            ctx, ctx_len, dr, dr_len, stop_mask=stop_mask, eos_id=eos_id,
            ngram=ngram, decode_trunk=decode_trunk,
            draft_params=draft_params, draft_cfg=draft_cfg, dcache=dcache_in)

    # Both caches are written in place: branch B extends what branch A
    # left in each.
    out_a, cache_a, spec_a = branch(
        cache, dcache, sfx_a, sfx_a_mask, max_new_a, empty_ids, empty_vals,
        ctx_a, ctx_a_len, draft_a, draft_a_len, stop_mask_a)
    out_b, cache_b, spec_b = branch(
        cache_a, dcache, sfx_b, sfx_b_mask, max_new_b, digit_ids,
        digit_vals, ctx_b, ctx_b_len, draft_b, draft_b_len, stop_mask_b)
    return out_a, out_b, spec_a, spec_b, cache_b


def spec_total_len(bucket: int, sfx_a: int, sfx_b: int, max_new_a: int,
                   max_new_b: int, spec_k: int) -> int:
    """Cache length a speculative shared dispatch allocates: the JAX
    package's, where each of the T decode windows owns spec_k slots, so
    the decode region is budget * spec_k instead of budget. The port's
    compacted windows need at most budget + spec_k - 1 of them; the extent
    stays the reference's, and its trailing splits are all masked."""
    return bucket + max(sfx_a + max_new_a * spec_k,
                        sfx_b + max_new_b * spec_k)


@torch.inference_mode()
def greedy_decode_fused_shared_spec(
        params, cfg: ModelConfig, prefix, prefix_mask, sfx_a, sfx_a_mask,
        sfx_b, sfx_b_mask, yes_ids, no_ids, digit_ids, digit_vals, ctx_a,
        ctx_a_len, draft_a, draft_a_len, ctx_b, ctx_b_len, draft_b,
        draft_b_len, max_new_a: int, max_new_b: int, spec_k: int,
        ngram: int = 2, topk: int = 20, stop_mask_b=None, stop_mask_a=None,
        eos_id=None, decode_trunk: int = 0, return_cache: bool = False,
        draft_params=None, draft_cfg=None):
    """:func:`greedy_decode_fused_shared` with SPECULATIVE decode tails:
    one shared-prefix prefill, two suffix extensions, then each branch's
    sequential greedy loop is replaced by the draft-and-verify window
    loop (:func:`_spec_tail`). ``ctx_*`` carry each branch's compacted
    prompt tokens for the n-gram drafter, ``draft_*`` given drafts
    (radix-tree continuations from the engine's prefix cache);
    ``draft_params`` / ``draft_cfg`` arm a fleet draft model instead (its
    own prefill of the prefix into a cache of the same extent; same
    vocabulary as the verifier, which the engine checks).
    ``decode_trunk`` > 0 runs every verify window's trunk splits through
    the trunk-aware kernel. Returns (binary out, confidence out, binary
    SpecOut, confidence SpecOut), with the final cache fifth when
    ``return_cache``."""
    B, S = prefix.shape
    T0 = spec_total_len(S, sfx_a.shape[1], sfx_b.shape[1], max_new_a,
                        max_new_b, spec_k)
    _, cache, _ = decoder.prefill(params, cfg, prefix, prefix_mask, T0)
    dcache = None
    if draft_params is not None:
        _, dcache, _ = decoder.prefill(draft_params, draft_cfg, prefix,
                                       prefix_mask, T0)
    out = _shared_spec_branches(
        params, cfg, cache, prefix_mask, sfx_a, sfx_a_mask, sfx_b,
        sfx_b_mask, yes_ids, no_ids, digit_ids, digit_vals, ctx_a, ctx_a_len,
        draft_a, draft_a_len, ctx_b, ctx_b_len, draft_b, draft_b_len, T0,
        max_new_a, max_new_b, spec_k, ngram, topk, stop_mask_a, stop_mask_b,
        eos_id, decode_trunk=decode_trunk, draft_params=draft_params,
        draft_cfg=draft_cfg, dcache=dcache)
    return out if return_cache else out[:4]


@torch.inference_mode()
def greedy_decode_fused_shared_paged_spec(
        params, cfg: ModelConfig, pool, slot_src, win_start: int,
        prefix_mask, rem, rem_mask, sfx_a, sfx_a_mask, sfx_b, sfx_b_mask,
        yes_ids, no_ids, digit_ids, digit_vals, ctx_a, ctx_a_len, draft_a,
        draft_a_len, ctx_b, ctx_b_len, draft_b, draft_b_len, max_new_a: int,
        max_new_b: int, spec_k: int, ngram: int = 2, topk: int = 20,
        stop_mask_b=None, stop_mask_a=None, eos_id=None,
        decode_trunk: int = 0):
    """Speculative decode over the radix-paged prefill front: cached
    prefix pages gather from the pool and only the remainder window
    recomputes (:func:`_paged_prefix`), then both branches run the
    speculative tail with its compacted verify windows — prefill savings
    and decode savings on one warm dispatch. Returns (binary out,
    confidence out, binary SpecOut, confidence SpecOut, final cache)."""
    B, S = prefix_mask.shape
    T0 = spec_total_len(S, sfx_a.shape[1], sfx_b.shape[1], max_new_a,
                        max_new_b, spec_k)
    cache = _paged_prefix(params, cfg, pool, slot_src, win_start,
                          prefix_mask, rem, rem_mask, T0)
    return _shared_spec_branches(
        params, cfg, cache, prefix_mask, sfx_a, sfx_a_mask, sfx_b,
        sfx_b_mask, yes_ids, no_ids, digit_ids, digit_vals, ctx_a, ctx_a_len,
        draft_a, draft_a_len, ctx_b, ctx_b_len, draft_b, draft_b_len, T0,
        max_new_a, max_new_b, spec_k, ngram, topk, stop_mask_a, stop_mask_b,
        eos_id, decode_trunk=decode_trunk)


@torch.inference_mode()
def greedy_decode(params, cfg: ModelConfig, tokens: torch.Tensor,
                  attn_mask: torch.Tensor, max_new_tokens: int = 50):
    """The decoder capture path: one prefill, then ``max_new_tokens``
    greedy steps (each a ``decoder.decode_step``, on the flash-decode
    kernel), keeping every step's logits.

    tokens/attn_mask: (B, S) LEFT-padded int32. Returns (generated
    (B, max_new_tokens) int32, step_logits (B, max_new_tokens, V)
    float32)."""
    B, S = tokens.shape
    logits, cache, pos0 = decoder.prefill(params, cfg, tokens, attn_mask,
                                          S + max_new_tokens)
    cache_mask = F.pad(attn_mask, (0, max_new_tokens))
    gens, steps = [], []
    for t in range(max_new_tokens):
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        gens.append(nxt)
        steps.append(logits)
        cache_mask[:, S + t] = 1
        logits, cache = decoder.decode_step(params, cfg, cache, nxt, pos0 + t,
                                            S + t, cache_mask)
    return torch.stack(gens, dim=1), torch.stack(steps, dim=1)


# The sampler's all-rows-done check reads ``done`` on the host, which
# waits for the device: once every this many steps, not every step.
DONE_CHECK_EVERY = 8


def sample_keys(key, B: int, V: int, max_new_tokens: int, device):
    """Every step's keys and counter offsets, made once before the loop
    (the JAX sampler's vmapped keys): per-row keys (B, 2) give row b at
    step t ``fold_in(key[b], t)`` and offset 0; one key (2,) gives every
    row ``split(key, max_new_tokens)[t]`` and row b the offset ``b * V``
    (its flat index over (B, V)). Returns ((T, B, 2) int64 keys, (B,)
    int64 offsets) on ``device``."""
    key = prng.as_key(key, device)
    steps = torch.arange(max_new_tokens, dtype=torch.int64, device=device)
    if prng.is_per_row_keys(key):
        if key.shape[0] != B:
            raise ValueError(f"{key.shape[0]} keys for {B} rows")
        keys = prng.fold_in(key[None, :, :], steps[:, None])
        offsets = torch.zeros(B, dtype=torch.int64, device=device)
    else:
        keys = prng.split(key, max_new_tokens)[:, None, :].expand(
            max_new_tokens, B, 2)
        offsets = torch.arange(B, dtype=torch.int64, device=device) * V
    return keys.contiguous(), offsets


@torch.inference_mode()
def sample_decode(params, cfg: ModelConfig, tokens: torch.Tensor,
                  attn_mask: torch.Tensor, key, temperature: float = 0.9,
                  max_new_tokens: int = 50, eos_id: Optional[int] = None
                  ) -> torch.Tensor:
    """Temperature sampling with the prefill + decode-step structure of
    :func:`greedy_decode`, each step's token drawn by ``ops.gumbel_argmax``
    on JAX's threefry draws (the JAX sampler's ``jax.random.categorical``),
    so a seed samples the JAX package's ids.

    ``key`` is one threefry key (2,) (a fresh subkey a step; a row's
    draws then depend on its batch position) or per-row keys (B, 2) (each
    row its own stream folded a step: a row's sample depends only on its
    key). ``eos_id`` arms the HF-generate stop: a row emits EOS fill after
    its first EOS, and a non-done row's draws are bitwise the unstopped
    sampler's (the step keys never depend on doneness). The JAX sampler
    skips every forward once all rows are done; here that test waits for
    the device, so it is made every ``DONE_CHECK_EVERY`` steps. The ids
    are the same for any interval: a done row emits EOS whatever its
    logits, so the forwards run between the last row's EOS and the check
    change nothing that is emitted.

    Returns generated (B, max_new_tokens) int32; no logits are kept."""
    B, S = tokens.shape
    logits, cache, pos0 = decoder.prefill(params, cfg, tokens, attn_mask,
                                          S + max_new_tokens)
    step_keys, offsets = sample_keys(key, B, logits.shape[-1],
                                     max_new_tokens, logits.device)
    cache_mask = F.pad(attn_mask, (0, max_new_tokens))
    done = torch.zeros(B, dtype=torch.bool, device=logits.device)
    gen = torch.empty((B, max_new_tokens), dtype=torch.int32,
                      device=logits.device)
    for t in range(max_new_tokens):
        emit = ops.gumbel_argmax(logits, step_keys[t], offsets, temperature)
        if eos_id is not None:
            emit = torch.where(done, torch.full_like(emit, eos_id), emit)
            done = done | (emit == eos_id)
        gen[:, t] = emit
        if (eos_id is not None and (t + 1) % DONE_CHECK_EVERY == 0
                and bool(done.all())):
            gen[:, t + 1:] = eos_id
            break
        cache_mask[:, S + t] = 1
        logits, cache = decoder.decode_step(params, cfg, cache, emit,
                                            pos0 + t, S + t, cache_mask)
    return gen


@torch.inference_mode()
def t5_greedy_decode(params, cfg: T5Config, enc_tokens: torch.Tensor,
                     enc_mask: torch.Tensor, max_new_tokens: int = 50):
    """Encoder-decoder greedy decode (the reference's Seq2Seq branch,
    compare_base_vs_instruct.py:203-241), as the JAX package runs it: one
    encoder pass, then every step re-runs the decoder over the fixed
    (B, max_new_tokens + 1) buffer and takes the logits at position t. No
    KV cache, as in the JAX package.

    Returns (generated (B, max_new_tokens) int32, step_logits
    (B, max_new_tokens, V) float32)."""
    B = enc_tokens.shape[0]
    dev = enc_tokens.device
    enc_out = encdec.encode(params, cfg, enc_tokens, enc_mask)
    dec_buf = torch.full((B, max_new_tokens + 1), cfg.decoder_start_token_id,
                         dtype=torch.int32, device=dev)
    mask = torch.zeros((B, max_new_tokens + 1), dtype=torch.int32, device=dev)
    mask[:, 0] = 1
    step_logits = torch.empty((B, max_new_tokens, cfg.vocab_size),
                              dtype=torch.float32, device=dev)
    for t in range(max_new_tokens):
        logits = encdec.decode(params, cfg, enc_out, enc_mask, dec_buf, mask)
        step_logits[:, t] = logits[:, t]
        del logits          # the (B, max_new_tokens + 1, V) stack of step t
        dec_buf[:, t + 1] = torch.argmax(step_logits[:, t], dim=-1).to(
            torch.int32)
        mask[:, t + 1] = 1
    return dec_buf[:, 1:].clone(), step_logits
