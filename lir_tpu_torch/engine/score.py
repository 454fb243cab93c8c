"""The core measurement primitive: yes/no token-probability readout.

C13 parity (SURVEY.md §2.1): the reference generates up to 50 tokens with
scores, scans the first MAX_LOOK_AHEAD=10 generated positions, and at the
FIRST position where the Yes or No token id appears in the top-2 reads
P(yes)/P(no) from that position's softmax, falling back to position 0
(compare_base_vs_instruct.py:185-305). One primitive returns both
readouts the reference scripts drifted between (odds ratio and relative
probability). Port of ``lir_tpu/engine/score.py:26-137`` (with the
reasoning mode's answer-count averaging).
"""

from __future__ import annotations

import dataclasses

import torch

MAX_LOOK_AHEAD = 10   # compare_base_vs_instruct.py:187
TOPK_MATCH = 2        # top-2 rule, :270-273


@dataclasses.dataclass
class YesNoScores:
    """Batched scorer output (all tensors shaped (B,) unless noted)."""

    yes_prob: torch.Tensor
    no_prob: torch.Tensor
    yes_logprob: torch.Tensor
    no_logprob: torch.Tensor
    odds_ratio: torch.Tensor        # yes/no  (compare_base_vs_instruct.py:293)
    relative_prob: torch.Tensor     # yes/(yes+no) (compare_instruct_models.py:281)
    position_found: torch.Tensor    # int32; first top-2 match, else 0
    yes_no_found: torch.Tensor      # bool
    generated: torch.Tensor         # (B, max_new) int32 token ids

    def cpu(self) -> "YesNoScores":
        return YesNoScores(**{f.name: getattr(self, f.name).cpu()
                              for f in dataclasses.fields(self)})


def _first_match(top2: torch.Tensor, yes_ids: torch.Tensor,
                 no_ids: torch.Tensor):
    """The scan-position rule on (B, P, 2) top-2 ids: (position, found),
    the first position whose top-2 holds the yes or the no id, else 0."""
    is_target = ((top2 == yes_ids[:, None, None])
                 | (top2 == no_ids[:, None, None]))
    found_at = is_target.any(dim=-1)                          # (B, P)
    any_found = found_at.any(dim=-1)
    # First True (argmax over int: torch returns the first maximal index).
    first_pos = torch.argmax(found_at.to(torch.int32), dim=-1)
    position = torch.where(any_found, first_pos,
                           torch.zeros_like(first_pos)).to(torch.int32)
    return position, any_found


def _scores(yes_prob, no_prob, position, any_found, generated) -> YesNoScores:
    """Both readouts from P(yes), P(no) at the chosen positions."""
    eps = 1e-10
    denom = yes_prob + no_prob
    return YesNoScores(
        yes_prob=yes_prob,
        no_prob=no_prob,
        yes_logprob=torch.log(yes_prob + eps),
        no_logprob=torch.log(no_prob + eps),
        odds_ratio=yes_prob / (no_prob + eps),
        relative_prob=torch.where(denom > 0, yes_prob / (denom + eps),
                                  torch.full_like(denom, float("nan"))),
        position_found=position,
        yes_no_found=any_found,
        generated=generated,
    )


def readout_from_step_logits(step_logits: torch.Tensor,
                             generated: torch.Tensor, yes_id, no_id,
                             scan_positions: int = MAX_LOOK_AHEAD
                             ) -> YesNoScores:
    """The scan-position rule on captured per-step logits (the capture
    path, ``ScoringEngine.decode_prompts``).

    step_logits: (B, T_new, V) float32; generated: (B, T_new) int32;
    yes_id/no_id: the target ids, scalars or (B,) per row."""
    B, T, V = step_logits.shape
    dev = step_logits.device
    yes_ids = torch.as_tensor(yes_id, dtype=torch.int32, device=dev).expand(B)
    no_ids = torch.as_tensor(no_id, dtype=torch.int32, device=dev).expand(B)
    window = step_logits[:, :scan_positions, :]               # (B, P, V)
    probs = torch.softmax(window, dim=-1)
    top2 = torch.topk(window, TOPK_MATCH, dim=-1).indices.to(torch.int32)
    position, any_found = _first_match(top2, yes_ids, no_ids)
    sel = probs[torch.arange(B, device=dev), position.long()]  # (B, V)
    yes_prob = torch.gather(sel, 1, yes_ids.long()[:, None])[:, 0]
    no_prob = torch.gather(sel, 1, no_ids.long()[:, None])[:, 0]
    return _scores(yes_prob, no_prob, position, any_found, generated)


def readout_from_fused(fused, yes_ids: torch.Tensor, no_ids: torch.Tensor,
                       scan_positions: int = MAX_LOOK_AHEAD) -> YesNoScores:
    """The C13 scan-position rule applied to a FusedDecodeOut (per-step
    p_yes/p_no/top-2 captured in the decode loop).

    yes_ids/no_ids: (B,) per-row target ids — the ids the decode ran with."""
    position, any_found = _first_match(fused.top2_ids[:, :scan_positions, :],
                                       yes_ids, no_ids)
    idx = position.long()[:, None]
    yes_prob = torch.gather(fused.p_yes, 1, idx)[:, 0]
    no_prob = torch.gather(fused.p_no, 1, idx)[:, 0]
    return _scores(yes_prob, no_prob, position, any_found, fused.generated)


def count_averaged_responses(runs, target_1: str, target_2: str):
    """Reasoning-model answer-count averaging (perturb_prompts.py:412-446),
    port of ``lir_tpu/engine/score.py:116-137``.

    The if/elif order is the reference's (:423-426): a response holding
    BOTH targets ("Not Covered" holds "Covered") counts toward target 1
    only. Returns (p1, p2, most_common_response); the most common pick is
    the first seen among equals (``Counter.most_common`` keeps insertion
    order), so it never depends on string hashing."""
    from collections import Counter

    n = len(runs)
    c1 = c2 = 0
    for r in runs:
        if target_1 in r:
            c1 += 1
        elif target_2 in r:
            c2 += 1
    most_common = Counter(runs).most_common(1)[0][0] if runs else ""
    return (c1 / n if n else 0.0, c2 / n if n else 0.0, most_common)
