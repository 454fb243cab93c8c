"""Speculative scoring decode: the host half.

Port of ``lir_tpu/engine/spec.py``. The device half is
``generate.greedy_decode_fused_shared_spec`` (and its paged twin): draft
up to ``spec_k - 1`` tokens a window, verify the window in one
multi-query forward, accept greedily, so every emitted token is the
sequential loop's. The drafts come from a fleet draft model when the
engine has one armed (``ScoringEngine.set_spec_draft``; the plan's
``fleet`` flag), else from the tree and the n-gram lookup.

This module builds one dispatch's :class:`SpecPlan` — each branch's
compacted prompt for the in-loop n-gram drafter, and the radix-tree
continuation drafts (:func:`_tree_drafts`: ``prefix_tree.continuation``
predicts each row's whole continuation from longer cached prompts and
recorded completion tails; length 0 without a prefix cache, so the
n-gram drafter drafts alone) — records observed completions back into
the tree (:func:`record_tails`) so a repeat visit drafts the whole
reply, and folds the dispatches' device-side ``SpecOut`` counters into
the engine's ``spec_stats`` at flush time (:func:`flush_pending`), with
one device-to-host copy for all of them. A fault plan on the engine
(``spec_fault_plan``, faults.wrap_engine) corrupts the plan's drafts at
its "draft" site: a bad draft only costs re-verification, every emitted
token stays the sequential loop's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import tokens as tok


@dataclasses.dataclass
class SpecPlan:
    """One shared dispatch's drafting inputs. Arrays are host numpy; the
    runner lifts them to the device with the dispatch. ``ctx_*`` are each
    branch's compacted full prompts right-padded to bucket + suffix
    bucket + decode budget; ``draft_*`` the tree-probed continuations,
    padded to the decode budget (length 0 where the tree has none)."""

    k: int
    ngram: int
    ctx_a: np.ndarray
    ctx_a_len: np.ndarray
    draft_a: np.ndarray
    draft_a_len: np.ndarray
    ctx_b: np.ndarray
    ctx_b_len: np.ndarray
    draft_b: np.ndarray
    draft_b_len: np.ndarray
    fleet: bool = False

    def dyn_args(self) -> Tuple[np.ndarray, ...]:
        """The eight drafting arrays in generate.*_spec argument order."""
        return (self.ctx_a, self.ctx_a_len, self.draft_a, self.draft_a_len,
                self.ctx_b, self.ctx_b_len, self.draft_b, self.draft_b_len)


def _ctx_arrays(ids_rows: Sequence[Sequence[int]], width: int,
                pad_id: int) -> Tuple[np.ndarray, np.ndarray]:
    B = len(ids_rows)
    ctx = np.full((B, width), pad_id, np.int32)
    lens = np.zeros((B,), np.int32)
    for r, ids in enumerate(ids_rows):
        n = min(len(ids), width)
        ctx[r, :n] = np.asarray(ids[:n], np.int32)
        lens[r] = n
    return ctx, lens


def _tree_drafts(tree, bucket: int, ids_rows: Sequence[Sequence[int]],
                 budget: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """Each row's radix-tree continuation, up to ``budget`` tokens:
    (tokens (B, budget), lengths (B,), rows with a continuation)."""
    B = len(ids_rows)
    toks = np.zeros((B, budget), np.int32)
    lens = np.zeros((B,), np.int32)
    hit_rows = 0
    for r, ids in enumerate(ids_rows):
        cont = tree.continuation(bucket, ids, budget)
        if cont:
            n = min(len(cont), budget)
            toks[r, :n] = np.asarray(cont[:n], np.int32)
            lens[r] = n
            hit_rows += 1
    return toks, lens, hit_rows


def build_plan(engine, bin_ids: Sequence[Sequence[int]],
               conf_ids: Sequence[Sequence[int]], bucket: int, ba: int,
               bb: int, new_tokens: int,
               conf_tokens: int) -> Optional[SpecPlan]:
    """One shared dispatch's SpecPlan, or None when speculation is off
    for this engine (the runner then runs the sequential loop). With a
    fleet draft model armed on the engine the plan's ``fleet`` flag is
    set and the tree probe is off (the draft model drafts every
    position); otherwise, with the engine's prefix cache built and
    ``spec_cfg.tree_probe`` on, each branch drafts from the radix tree's
    token history."""
    if not engine.spec_supported():
        return None
    spec_cfg = engine.spec_cfg
    pad_id = tok.pad_token_id(engine.tokenizer)
    ctx_a, len_a = _ctx_arrays(bin_ids, bucket + ba + new_tokens, pad_id)
    ctx_b, len_b = _ctx_arrays(conf_ids, bucket + bb + conf_tokens, pad_id)
    B = len(bin_ids)
    draft_a = np.zeros((B, new_tokens), np.int32)
    dlen_a = np.zeros((B,), np.int32)
    draft_b = np.zeros((B, conf_tokens), np.int32)
    dlen_b = np.zeros((B,), np.int32)
    fleet = engine._spec_draft is not None
    if (not fleet and spec_cfg.tree_probe
            and engine.prefix_cache is not None):
        draft_a, dlen_a, _ = _tree_drafts(engine.prefix_cache, bucket,
                                          bin_ids, new_tokens)
        draft_b, dlen_b, _ = _tree_drafts(engine.prefix_cache, bucket,
                                          conf_ids, conf_tokens)
    fault = engine.spec_fault_plan
    if fault is not None:
        fault.corrupt_draft([(draft_a, dlen_a), (draft_b, dlen_b)],
                            int(engine.cfg.vocab_size))
    return SpecPlan(k=int(engine.rt.spec_k), ngram=int(spec_cfg.ngram),
                    ctx_a=ctx_a, ctx_a_len=len_a,
                    draft_a=draft_a, draft_a_len=dlen_a,
                    ctx_b=ctx_b, ctx_b_len=len_b,
                    draft_b=draft_b, draft_b_len=dlen_b, fleet=fleet)


def record_tails(engine, bucket: int, prompt_ids: Sequence[Sequence[int]],
                 gen_rows, n_real: int, max_tails: int = 32) -> int:
    """Record each real row's observed continuation (its raw generated
    ids) into the radix tree's token history, so a repeat visit of the
    same prompt drafts the whole reply. No-op without a tree, without
    speculation or with the tree probe off. Returns rows recorded."""
    tree = engine.prefix_cache
    if tree is None or not engine.spec_supported():
        return 0
    if not engine.spec_cfg.tree_probe:
        return 0
    gen = np.asarray(gen_rows)
    done = 0
    for r in range(min(n_real, gen.shape[0], len(prompt_ids))):
        if tree.record_tail(bucket, prompt_ids[r], gen[r].tolist(),
                            max_tails=max_tails):
            done += 1
    return done


def flush_pending(engine) -> None:
    """Fold every pending (binary, confidence) SpecOut pair into
    ``engine.spec_stats``. Deferred off the dispatch path on purpose: a
    copy to the host at dispatch time would wait for the dispatch's
    device work. All pending counters come over in one copy."""
    pending = engine._spec_pending
    if not pending:
        return
    engine._spec_pending = []
    host = torch.stack([
        torch.cat([so.drafted, so.accepted, so.chunks.reshape(1),
                   so.seq_steps.reshape(1)])
        for pair in pending for so in pair]).cpu().numpy()
    st = engine.spec_stats
    for drafted0, drafted1, drafted2, acc0, acc1, acc2, chunks, seq in host:
        st["drafted_tokens"] += int(drafted0 + drafted1 + drafted2)
        st["accepted_tokens"] += int(acc0 + acc1 + acc2)
        st["draft_tree"] += int(drafted0)
        st["accepted_tree"] += int(acc0)
        st["draft_ngram"] += int(drafted1)
        st["accepted_ngram"] += int(acc1)
        st["draft_fleet"] += int(drafted2)
        st["accepted_fleet"] += int(acc2)
        st["decode_forwards"] += int(chunks)
        st["seq_forwards"] += int(seq)
