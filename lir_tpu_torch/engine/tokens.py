"""Tokenizer adapters: target-token-id resolution + ragged batch packing.

SURVEY.md §7 ranks tokenizer semantics parity as hard part #1: the decoder
branch of the reference uses the first sub-token of the LEADING-SPACE
variants '" Yes"/" No"' (compare_base_vs_instruct.py:244-247, fallback to
bare "Yes"/"No" at compare_instruct_models.py:232-233), while the
encoder-decoder branch uses bare ``tokenizer("Yes").input_ids[0]``
(compare_base_vs_instruct.py:208-209). Mis-resolving these ids silently
corrupts every downstream statistic, so this module is the one place that
rule lives, and tests pin it per family.

A copy of the JAX package's ``engine/tokens.py`` (the part the port's
engine reads), so that the port imports nothing of that package.
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

import numpy as np


def first_token_id(tokenizer, text: str) -> int:
    ids = tokenizer(text, add_special_tokens=False).input_ids
    if len(ids) == 0:
        raise ValueError(f"tokenizer produced no ids for {text!r}")
    return int(ids[0])


def yes_no_ids(tokenizer, *, encoder_decoder: bool = False,
               yes_text: str = "Yes", no_text: str = "No") -> Tuple[int, int]:
    """Resolve the two target token ids under the reference's rules."""
    if encoder_decoder:
        return first_token_id(tokenizer, yes_text), first_token_id(tokenizer, no_text)
    try:
        return (first_token_id(tokenizer, " " + yes_text),
                first_token_id(tokenizer, " " + no_text))
    except ValueError:
        return first_token_id(tokenizer, yes_text), first_token_id(tokenizer, no_text)


def target_token_ids(tokenizer, targets: Sequence[str],
                     *, encoder_decoder: bool = False) -> List[int]:
    """First-token ids for arbitrary target strings (legal prompts use e.g.
    'Covered'/'Not' — perturb_prompts.py target_tokens)."""
    out = []
    for t in targets:
        if encoder_decoder:
            out.append(first_token_id(tokenizer, t))
        else:
            try:
                out.append(first_token_id(tokenizer, " " + t))
            except ValueError:
                out.append(first_token_id(tokenizer, t))
    return out


def integer_token_table(tokenizer, lo: int = 0, hi: int = 100
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """(token_ids, values) for every single-token rendering of an integer in
    [lo, hi] — with and without leading space. Feeds
    engine.score.weighted_confidence (reference E[v] readout,
    perturb_prompts.py:504-526, which scans top_logprobs for integer-parsable
    token strings)."""
    ids, vals = [], []
    seen = set()
    for v in range(lo, hi + 1):
        for text in (str(v), " " + str(v)):
            toks = tokenizer(text, add_special_tokens=False).input_ids
            if len(toks) == 1 and toks[0] not in seen:
                seen.add(toks[0])
                ids.append(int(toks[0]))
                vals.append(float(v))
    return np.asarray(ids, np.int32), np.asarray(vals, np.float32)


# Bit flags of digit_stop_classes (the confidence early stop's per-token
# surface classification; consumed by generate._fused_tail).
STOP_PURE = 1         # surface (after any space prefix) is digits only
STOP_PREFIX = 2       # surface begins with a word-boundary prefix (▁/Ġ/ws)
STOP_STARTS_WORD = 4  # glues onto the previous token (first char is a word
                      # char with NO space prefix — "st" after "1" = "1st")
STOP_ENDS_WORD = 8    # last decoded char is a word char
STOP_TRANSPARENT = 16  # decodes to nothing (bracketed specials): invisible
                       # to the text, so it must not start/stop anything

def eos_only_stop_classes(vocab_size: int) -> np.ndarray:
    """(vocab_size,) all-STOP_TRANSPARENT class table: under
    generate._fused_tail's rule a transparent token freezes every piece
    of text state (no digit run ever opens), so the only remaining done
    condition is ``emit == eos_id`` — a pure all-rows-emitted-EOS stop
    with exactly the trim-at-EOS semantics the host applies to response
    text anyway (runner.decode_completion / HF generate parity). Used for
    the sweep's BINARY branch, whose numeric readout consumes position 0
    only (perturb_prompts.py:474-526): skipped trailing steps can never
    change a recorded value, they are pure EOS fill."""
    return np.full((vocab_size,), STOP_TRANSPARENT, np.int32)


_SPACE_PREFIX = ("▁", "Ġ", "Ċ", " ", "\t", "\n", "\r")
_BYTE_FORM = re.compile(r"<0[xX]([0-9A-Fa-f]{2})>")
_SPECIAL_FORM = re.compile(r"<[^<>]*>")


def _is_word(c: str) -> bool:
    """Unicode word character, matching the ``\\b`` semantics of the
    confidence parse's ``\\b\\d+\\b`` ('è' is a word char: '2ème' has no
    boundary after the 2, so it must read as glue here too)."""
    return c.isalnum() or c == "_"


def digit_stop_classes(tokenizer, vocab_size: int) -> Optional[np.ndarray]:
    """(vocab_size,) int32 bitmask classifying every token's DECODED
    surface for the confidence early stop (generate._fused_tail): the scan
    may halt a row only once its text provably contains a complete
    standalone integer — the exact ``\\b(\\d+)\\b`` ``_parse_confidence``
    reads (perturb_prompts.py:500-502). "contains a digit" alone is wrong
    both ways: '<0x0A>' has a surface digit but decodes to a newline, and
    '1'+'st' shows a digit the parse can never match ("1st" has no word
    boundary after the 1).

    Needs real per-token strings (``convert_ids_to_tokens``); returns None
    otherwise (e.g. the test FakeTokenizer) and callers disable the stop.
    """
    convert = getattr(tokenizer, "convert_ids_to_tokens", None)
    if convert is None:
        return None
    # Model vocab may be padded past the tokenizer's (multiple-of-128
    # embedding tables): padding rows class 0 (never argmax in a trained
    # model anyway).
    try:
        n = min(vocab_size, len(tokenizer))
    except TypeError:
        n = vocab_size
    try:
        toks = convert(list(range(n)))
    except Exception:  # noqa: BLE001 — added-token gaps
        return None

    # Transparency comes from the tokenizer's own metadata, not surface
    # form: ordinary vocab pieces can fullmatch <...> yet decode to literal
    # text (<div>, <br> in code-trained vocabs) — those must be classified
    # by their surface like any other token (ADVICE r4).
    special_ids: set = set()
    for i in (getattr(tokenizer, "all_special_ids", None) or ()):
        special_ids.add(int(i))
    added = getattr(tokenizer, "added_tokens_decoder", None)
    if added:
        try:
            for tid, tok in added.items():
                if getattr(tok, "special", False):
                    special_ids.add(int(tid))
        except Exception:  # noqa: BLE001 — non-dict implementations
            pass
    to_string = getattr(tokenizer, "convert_tokens_to_string", None)

    def _classify(i: int, t) -> int:
        if t is None:
            return 0
        m = _BYTE_FORM.fullmatch(t)
        if m:
            t = chr(int(m.group(1), 16))   # the byte's actual character
        elif i in special_ids:
            return STOP_TRANSPARENT
        elif _SPECIAL_FORM.fullmatch(t):
            # Looks special but isn't registered: either a raw-tokenizer
            # special invisible to metadata (decodes to "") or a literal
            # vocab piece like <div> — ask the tokenizer which.
            if to_string is not None:
                try:
                    surface = to_string([t])
                except Exception:  # noqa: BLE001
                    surface = t
                if surface == "":
                    return STOP_TRANSPARENT
                t = surface
        stripped = t.lstrip("".join(_SPACE_PREFIX))
        prefix = len(stripped) < len(t)
        cls = STOP_PREFIX if prefix else 0
        if stripped and all(c in "0123456789" for c in stripped):
            cls |= STOP_PURE
        if stripped and not prefix and _is_word(stripped[0]):
            cls |= STOP_STARTS_WORD
        # ENDS_WORD reads the DECODED tail: a prefix-only token ('Ġ' is a
        # letter codepoint but decodes to a space) ends at a boundary.
        if stripped and _is_word(stripped[-1]):
            cls |= STOP_ENDS_WORD
        return cls

    mask = np.zeros((vocab_size,), dtype=np.int32)
    mask[:n] = [_classify(i, t) for i, t in enumerate(toks)]
    return mask


def pad_token_id(tokenizer) -> int:
    pid = getattr(tokenizer, "pad_token_id", None)
    if pid is None:
        pid = getattr(tokenizer, "eos_token_id", 0) or 0
    return int(pid)


def left_pad_ids(ids_list: Sequence[Sequence[int]], max_len: int,
                 pad_id: int) -> Tuple[np.ndarray, np.ndarray]:
    """LEFT-pad pre-tokenized prompts to (B, max_len) int32 (tokens, mask).

    Left padding keeps the prompt end at position max_len-1 for every row, so
    one jitted prefill serves ragged prompts (decoder.mask_positions gives
    pads position 0 and the bias masks them out). Truncates from the left if
    a prompt exceeds max_len (reference prompts are ≲700 tokens, SURVEY §5).
    """
    B = len(ids_list)
    tokens = np.full((B, max_len), pad_id, np.int32)
    mask = np.zeros((B, max_len), np.int32)
    for i, ids in enumerate(ids_list):
        ids = list(ids)[-max_len:]
        tokens[i, max_len - len(ids):] = ids
        mask[i, max_len - len(ids):] = 1
    return tokens, mask


def trim_at_eos(ids: Sequence[int], eos_id: Optional[int]) -> List[int]:
    """Drop the first EOS and everything after it — parity with HF
    ``generate`` stopping at EOS (the jitted decode runs a fixed number of
    steps, so post-EOS garbage must not leak into decoded completions or the
    confidence-integer parse)."""
    ids = [int(i) for i in ids]
    if eos_id is None:
        return ids
    try:
        return ids[: ids.index(int(eos_id))]
    except ValueError:
        return ids


def right_pad_ids(ids_list: Sequence[Sequence[int]], max_len: int,
                  pad_id: int) -> Tuple[np.ndarray, np.ndarray]:
    """RIGHT-pad pre-tokenized suffixes to (B, max_len) int32 (tokens, mask).

    Format suffixes in the shared-prefix sweep path sit AFTER a left-padded
    prefix in the KV cache, so their real tokens must start at the first
    suffix slot; the decoder reads per-row validity from the mask
    (decoder.extend). Truncates from the right if a suffix exceeds max_len.
    """
    B = len(ids_list)
    tokens = np.full((B, max_len), pad_id, np.int32)
    mask = np.zeros((B, max_len), np.int32)
    for i, ids in enumerate(ids_list):
        ids = list(ids)[:max_len]
        tokens[i, :len(ids)] = ids
        mask[i, :len(ids)] = 1
    return tokens, mask


def shared_prefix_len(a: Sequence[int], b: Sequence[int]) -> int:
    """Longest common token prefix of two prompts, capped so BOTH suffixes
    keep at least one real token (decoder.extend reads its branch logits
    from the last real suffix position — an empty suffix has none).

    Splitting at the common-token boundary (instead of at a string
    boundary) is tokenizer-agnostic: BPE merges that cross the text split
    point simply shorten the shared prefix by a token or two."""
    cap = min(len(a), len(b)) - 1
    n = 0
    while n < cap and a[n] == b[n]:
        n += 1
    return max(n, 0)


def common_prefix_len(rows: Sequence[Sequence[int]]) -> int:
    """Longest common token prefix across ALL rows — the shared-trunk
    extent of a dispatch (runner.cascade_trunk_for snaps it to the
    trunk-quantum grid). Unlike :func:`shared_prefix_len` there is no
    keep-a-suffix cap: a row whose whole prefix IS the trunk simply
    contributes zero remainder tokens to the cascade extension (its
    remainder slots are masked, the standard pad-slot discipline)."""
    if not rows:
        return 0
    n = min(len(r) for r in rows)
    first = rows[0]
    for i in range(n):
        t = first[i]
        for r in rows[1:]:
            if r[i] != t:
                return i
    return n


def pick_bucket(lengths: Sequence[int], buckets: Sequence[int]) -> int:
    """Smallest bucket that fits the longest prompt (static-shape discipline:
    one compile per bucket instead of one per length)."""
    m = max(lengths)
    for b in sorted(buckets):
        if b >= m:
            return b
    return max(buckets)


# Bucket edges above this width are whole multiples of it (the JAX
# package's prefill flash block); kept so that both engines bucket a
# prompt alike.
FLASH_BLOCK = 128


def bucket_ladder(max_len: int, min_bucket: int = 64,
                  align: int = FLASH_BLOCK) -> Tuple[int, ...]:
    """Prompt-length bucket edges for the ragged sweep scheduler.

    A geometric ~sqrt(2) ladder instead of the old powers-of-two set: each
    step pays at most ~41% padding waste in the worst case (vs 100% for
    x2 steps), and every edge stays flash-eligible — edges <= ``align``
    are free-form (the kernel shrinks its block to S), edges above it are
    rounded UP to a multiple of ``align``. Rounding collapses near-equal
    steps, so the ladder is strictly increasing and ends exactly at a
    cap >= ``max_len``'s covering edge, clipped to max_len when max_len
    itself is not on the grid (the engine's truncation semantics need a
    bucket that equals the configured ceiling).

    One XLA compile per (bucket, batch) pair is the cost of each extra
    edge; ~9 edges at 1024 keeps that bounded while cutting the padded
    FLOPs the single-bucket path burns on short prompts.
    """
    if max_len < min_bucket:
        return (max_len,)
    edges: List[int] = []
    x = float(min_bucket)
    while True:
        e = int(round(x))
        # Edges at or under one flash block stay lane-friendly (x16);
        # above it they must be whole blocks (see FLASH_BLOCK).
        step = 16 if e <= align else align
        e = ((e + step - 1) // step) * step
        if e >= max_len:
            break
        if not edges or e > edges[-1]:
            edges.append(e)
        x *= 2 ** 0.5
    edges.append(max_len)
    return tuple(edges)


def assign_bucket(length: int, buckets: Sequence[int]) -> int:
    """Smallest bucket edge >= ``length``; over-long prompts land in the
    largest bucket (left-truncation semantics, same as pick_bucket). Total
    and deterministic: every length maps to exactly one edge."""
    for b in sorted(buckets):
        if b >= length:
            return b
    return max(buckets)
