"""Length-aware ragged sweep scheduler: bucket ladder + slot refill +
cross-cell prefix reuse.

A copy of the JAX package's ``engine/scheduler.py``: the plan is the
JAX scheduler's, with or without the prefix cache's probe
(``cached_probe``): the same dispatches, kinds, buckets, item order,
suffix buckets and refilled counts.

The perturbation grid is a *ragged* workload: rephrasings of a legal
prompt vary in tokenized length while each dispatch is padded to one
shape. The scheduler plans the whole sweep's dispatches up front (the
grid is fully known):

1. **Bucket ladder** (tokens.bucket_ladder): cells are sorted into
   ~sqrt(2)-spaced prompt-length buckets by their real tokenized prefix
   length, so a 90-token rephrasing prefills 96 slots, not 1024.
2. **Slot refill**: batches are drained per bucket queue; when a
   bucket's queue can no longer fill a batch, its tail is promoted into
   the next bucket's queue whenever the cost model says the promoted
   rows are cheaper than a padded tail dispatch.
3. **Cross-cell prefix reuse**: cells whose tokenized prompts agree on a
   long prefix are grouped; each group's prefix is prefilled ONCE and
   every member row extends from a row-gathered copy of that cache
   (generate.greedy_decode_fused_grouped).

Pure host-side planning — deterministic, total (every cell lands in
exactly one dispatch), and engine-agnostic (items carry an opaque
payload).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..utils.profiling import OccupancyStats
from . import tokens as tok

SUFFIX_BUCKETS = (8, 16, 32, 64, 128, 256)

# Decode-floor price constants: how many prefill row-tokens one
# decode-step token is worth (the JAX package's calibration, kept so
# that both packages plan alike): 1.0 with the fused decode kernels,
# 3.0 on the dense decode path, 0.5 for a speculating dispatch.
DECODE_TOKEN_COST_FUSED = 1.0
DECODE_TOKEN_COST_UNFUSED = 3.0
DECODE_TOKEN_COST_SPEC = 0.5

# Cascade DECODE discount: the share of a fused decode step's cost that
# is KV-cache streaming — the only term the trunk dedup removes.
CASCADE_DECODE_KV_SHARE = 0.3


def decode_token_cost(fused_decode: bool = True,
                      spec_decode: bool = False) -> float:
    """The decode-floor constant for a kernel mode (see above)."""
    if spec_decode:
        return DECODE_TOKEN_COST_SPEC
    return (DECODE_TOKEN_COST_FUSED if fused_decode
            else DECODE_TOKEN_COST_UNFUSED)


# Cascade-prefill spread of the watchdog's seed headroom: a cascade
# engine's deadlines calibrate on trunk-discounted dispatches, and an
# ineligible dispatch falls back to the full dense prefill, at most
# about twice the discounted price.
CASCADE_PREFILL_SPREAD = 2.0


def watchdog_seed_headroom(spec_decode: bool = False,
                           cascade: bool = False) -> float:
    """Seed headroom of the dispatch watchdog (guard/watchdog.py): the
    first calibration sample is inflated by the spread between the
    decode pricing a deadline calibrates on and the slowest mode a
    dispatch may fall back to (the dense decode path): UNFUSED / SPEC on
    a speculating engine, UNFUSED / FUSED otherwise, times
    CASCADE_PREFILL_SPREAD on a cascade engine. The JAX package's rule."""
    seed = (DECODE_TOKEN_COST_UNFUSED / DECODE_TOKEN_COST_SPEC
            if spec_decode
            else DECODE_TOKEN_COST_UNFUSED / DECODE_TOKEN_COST_FUSED)
    if cascade:
        seed *= CASCADE_PREFILL_SPREAD
    return seed


def _tail_batch(n: int, cap: int) -> int:
    """Smallest power of two >= n, capped (mirrors runner._tail_batch)."""
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


def decode_floor(n_rows: int, batch_size: int, decode_cost: int,
                 fused_decode: bool = True,
                 spec_decode: bool = False,
                 decode_trunk_frac: float = 0.0) -> float:
    """The decode floor of a dispatch's price: every padded slot runs the
    full decode budget whether it carries work or padding, priced at the
    kernel mode's constant. ``decode_trunk_frac`` (trunk tokens / cache
    extent, 0..1) prices the cascade-decode dedup: CASCADE_DECODE_KV_SHARE
    x trunk fraction x deduped-row fraction comes off the floor."""
    slots = _tail_batch(n_rows, batch_size)
    floor = (slots * decode_cost
             * decode_token_cost(fused_decode, spec_decode))
    if decode_trunk_frac > 0.0 and slots > 1:
        frac = min(max(float(decode_trunk_frac), 0.0), 1.0)
        floor *= 1.0 - CASCADE_DECODE_KV_SHARE * frac * (slots - 1) / slots
    return floor


def bucket_cost(n_rows: int, bucket_edge: int, batch_size: int,
                decode_cost: int, cached_tokens: int = 0,
                fused_decode: bool = True,
                spec_decode: bool = False, cascade: bool = False,
                trunk_tokens: int = 0,
                decode_trunk_frac: float = 0.0) -> float:
    """Row-token cost of dispatching ``n_rows`` cells at ``bucket_edge``:
    a padded power-of-two batch prefilled at the edge, plus the fixed
    decode floor (:func:`decode_floor`). ``cached_tokens`` are prefix
    tokens the cross-request radix cache (engine/prefix_tree.py) already
    holds for the rows: free prefill, gathered from the page pool, so
    they come off the prefill term; the decode steps are the floor.
    ``cascade``/``trunk_tokens`` price the shared-trunk cascade: the
    trunk is prefilled once instead of once per slot, so ``(slots - 1) *
    trunk_tokens`` comes off the prefill term too (the max(0) clamp
    keeps a warm trunk, discounted both ways, from going negative)."""
    slots = _tail_batch(n_rows, batch_size)
    prefill = slots * bucket_edge - int(cached_tokens)
    if cascade and trunk_tokens > 0:
        prefill -= (slots - 1) * int(trunk_tokens)
    prefill = max(prefill, 0)
    return prefill + decode_floor(n_rows, batch_size, decode_cost,
                                  fused_decode, spec_decode,
                                  decode_trunk_frac=decode_trunk_frac)


@dataclasses.dataclass(frozen=True)
class SweepItem:
    """One grid cell, tokenized. ``lcp`` is the binary/confidence shared
    token prefix (tokens.shared_prefix_len) — the row's prefill length."""

    cell: Any
    bin_ids: Tuple[int, ...]
    conf_ids: Tuple[int, ...]
    lcp: int

    @property
    def prefix_len(self) -> int:
        return max(self.lcp, 1)


@dataclasses.dataclass(frozen=True)
class PrefixGroup:
    """Cells sharing ``plen`` leading tokens; prefilled once as one row."""

    items: Tuple[SweepItem, ...]
    plen: int


@dataclasses.dataclass
class Dispatch:
    """One engine call. ``kind`` is "shared" (pairwise prefix sharing,
    decode_fused_shared) or "grouped" (cross-cell prefix reuse,
    decode_fused_grouped). ``refilled`` counts cells promoted here from a
    smaller bucket's ragged tail. Suffix-bucket edges are planned per
    PREFIX bucket (not per dispatch) so every dispatch in a bucket shares
    one shape."""

    kind: str
    bucket: int
    items: List[SweepItem]
    refilled: int = 0
    groups: Optional[List[PrefixGroup]] = None
    sfx_bucket_a: int = 0
    sfx_bucket_b: int = 0

    @property
    def cells(self) -> List[Any]:
        return [it.cell for it in self.items]

    def padded_rows(self, batch_size: int) -> Tuple[int, int]:
        """(prefill rows, member rows) after the runner's power-of-two
        tail padding. Shared dispatches prefill and decode the same padded
        batch; grouped dispatches prefill one row per group and decode
        two member rows ([bin, conf]) per cell."""
        n = len(self.items)
        if self.kind == "shared":
            b = batch_size if n == batch_size else _tail_batch(n, batch_size)
            return b, b
        return (_tail_batch(len(self.groups), batch_size),
                _tail_batch(2 * n, 2 * batch_size))


def build_items(bin_ids: Sequence[Sequence[int]],
                conf_ids: Sequence[Sequence[int]],
                cells: Sequence[Any]) -> List[SweepItem]:
    """Pair pre-tokenized prompt ids with their cells (total: one item per
    cell, in input order)."""
    items = []
    for c, b, f in zip(cells, bin_ids, conf_ids):
        b, f = tuple(int(i) for i in b), tuple(int(i) for i in f)
        items.append(SweepItem(cell=c, bin_ids=b, conf_ids=f,
                               lcp=tok.shared_prefix_len(b, f)))
    return items


def _lcp(a: Sequence[int], b: Sequence[int]) -> int:
    n, cap = 0, min(len(a), len(b))
    while n < cap and a[n] == b[n]:
        n += 1
    return n


class RaggedScheduler:
    """Plans a sweep's dispatches from tokenized items.

    Parameters
    ----------
    buckets: prefix bucket ladder (tokens.bucket_ladder edges).
    batch_size: cells per dispatch (member rows are 2x this in grouped
        dispatches — one binary + one confidence row per cell).
    new_budget: max decode tokens any row runs (bounds the cache extent
        the learned-position check reasons about).
    decode_cost: per-slot decode tokens a dispatch pays regardless of
        prompt length (the sweep passes new_tokens + conf_tokens).
        Defaults to new_budget.
    suffix_buckets: right-pad edges for format suffixes.
    max_extent: position ceiling (learned-position tables); None = no cap.
    min_group_prefix / min_group_cells: cross-cell grouping engages only
        for >= min_group_cells cells agreeing on >= min_group_prefix
        tokens AND on at least half of each member's prefill.
    group_cells: False disables cross-cell grouping entirely.
    cached_probe: optional ``(item, bucket_edge) -> cached tokens`` hook
        into the cross-request radix prefix cache (prefix_tree.
        match_len). The slot-refill rule then prices cached-prefix
        tokens as free prefill; since the radix namespaces are
        per-bucket, promoting a tail into the next bucket loses this
        bucket's cached pages, which the probe reflects.
    """

    def __init__(self, buckets: Sequence[int], batch_size: int, *,
                 new_budget: int = 8, decode_cost: Optional[int] = None,
                 suffix_buckets: Sequence[int] = SUFFIX_BUCKETS,
                 max_extent: Optional[int] = None,
                 min_group_prefix: int = 16, min_group_cells: int = 4,
                 group_cells: bool = True,
                 cached_probe=None,
                 fused_decode: bool = True,
                 stats: Optional[OccupancyStats] = None):
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.batch = int(batch_size)
        self.new_budget = int(new_budget)
        self.decode_cost = int(new_budget if decode_cost is None
                               else decode_cost)
        self.fused_decode = bool(fused_decode)
        self.suffix_buckets = tuple(sorted(suffix_buckets))
        self.max_extent = max_extent
        self.min_group_prefix = int(min_group_prefix)
        self.min_group_cells = int(min_group_cells)
        self.group_cells = group_cells
        self.cached_probe = cached_probe
        self.stats = stats if stats is not None else OccupancyStats()

    def _cached_tokens(self, items: Sequence[Tuple[SweepItem, bool]],
                       edge: int) -> int:
        """Radix-cached prefix tokens across ``items`` in ``edge``'s
        namespace (0 without a probe)."""
        if self.cached_probe is None:
            return 0
        return sum(self.cached_probe(it, edge) for it, _ in items)

    # -- cross-cell prefix grouping -----------------------------------------

    def _fits_grouped(self, plen: int, items: Sequence[SweepItem]) -> bool:
        """A candidate group must keep every member's suffix inside the
        suffix ladder, leave >= 1 real suffix token per member row, and
        (learned positions) keep bucket + suffix + decode inside the
        table."""
        max_sfx = max(max(len(it.bin_ids), len(it.conf_ids)) - plen
                      for it in items)
        min_sfx = min(min(len(it.bin_ids), len(it.conf_ids)) - plen
                      for it in items)
        if min_sfx < 1 or max_sfx > self.suffix_buckets[-1]:
            return False
        bucket = tok.assign_bucket(plen, self.buckets)
        if bucket < plen:           # prefix exceeds the largest bucket
            return False
        if self.max_extent is not None:
            sfx_bucket = tok.pick_bucket([max_sfx], self.suffix_buckets)
            if bucket + sfx_bucket + self.new_budget > self.max_extent:
                return False
        return True

    def _form_groups(self, items: List[SweepItem]
                     ) -> Tuple[List[PrefixGroup], List[SweepItem]]:
        """Greedy grouping over sort order: sorting by token sequence puts
        shared-prefix cells adjacent, so one linear merge pass finds every
        maximal run agreeing on a long-enough prefix. Deterministic (sort
        key is the token tuple; ties broken by input order via stable
        sort) and total (non-grouped items pass through untouched)."""
        order = sorted(range(len(items)), key=lambda i: items[i].bin_ids)
        groups: List[PrefixGroup] = []
        rest: List[SweepItem] = []
        run: List[SweepItem] = []
        run_plen = 0

        def flush():
            nonlocal run, run_plen
            if len(run) >= self.min_group_cells:
                groups.append(PrefixGroup(items=tuple(run), plen=run_plen))
            else:
                rest.extend(run)
            run, run_plen = [], 0

        for i in order:
            it = items[i]
            if not run:
                run, run_plen = [it], it.prefix_len
                continue
            # Joint prefix if `it` joins: common tokens with the run,
            # capped by each side's own binary/confidence split point.
            p = min(run_plen, _lcp(run[-1].bin_ids, it.bin_ids), it.lcp)
            ok = (p >= self.min_group_prefix
                  and len(run) < self.batch
                  # the shared prefix must carry at least half of every
                  # member's prefill or grouping re-pays it in suffixes
                  and all(2 * p >= m.prefix_len for m in run + [it])
                  and self._fits_grouped(p, run + [it]))
            if ok:
                run.append(it)
                run_plen = p
            else:
                flush()
                run, run_plen = [it], it.prefix_len
        flush()
        # Restore input order among non-grouped items (stable downstream
        # bucket queues).
        pos = {id(it): i for i, it in enumerate(items)}
        rest.sort(key=lambda it: pos[id(it)])
        return groups, rest

    # -- bucket queues + slot refill ----------------------------------------

    def _plan_shared(self, items: List[SweepItem]) -> List[Dispatch]:
        queues: Dict[int, List[Tuple[SweepItem, bool]]] = {
            b: [] for b in self.buckets}
        for it in items:
            queues[tok.assign_bucket(it.prefix_len, self.buckets)].append(
                (it, False))

        out: List[Dispatch] = []
        B = self.batch
        for bi, edge in enumerate(self.buckets):
            q = queues[edge]
            while len(q) >= B:
                chunk, q = q[:B], q[B:]
                out.append(Dispatch(
                    kind="shared", bucket=edge,
                    items=[it for it, _ in chunk],
                    refilled=sum(1 for _, r in chunk if r)))
            if not q:
                continue
            nxt = self.buckets[bi + 1] if bi + 1 < len(self.buckets) else None
            # Slot refill under the shared price model (bucket_cost).
            # Keeping the tail pays a WHOLE extra dispatch: a padded
            # power-of-two batch prefilled at this edge plus its fixed
            # decode steps. Promoting pays len(tail) rows at the next
            # edge, where they fill slots of dispatches that run anyway.
            # With a prefix-cache probe, cached tokens discount each
            # side: a tail warm in THIS bucket's namespace is cheap to
            # keep and dear to promote.
            if (nxt is not None
                    and len(q) * nxt - self._cached_tokens(q, nxt)
                    < bucket_cost(len(q), edge, B, self.decode_cost,
                                  cached_tokens=self._cached_tokens(q, edge),
                                  fused_decode=self.fused_decode)):
                queues[nxt] = [(it, True) for it, _ in q] + queues[nxt]
            else:
                out.append(Dispatch(
                    kind="shared", bucket=edge,
                    items=[it for it, _ in q],
                    refilled=sum(1 for _, r in q if r)))
        return out

    def _plan_grouped(self, groups: List[PrefixGroup]) -> List[Dispatch]:
        """Pack prefix groups into dispatches: groups sharing a prefix
        bucket ride together until the member-row capacity (2 rows per
        cell, capped at 2*batch) fills."""
        by_bucket: Dict[int, List[PrefixGroup]] = {}
        for g in groups:
            by_bucket.setdefault(
                tok.assign_bucket(g.plen, self.buckets), []).append(g)
        out: List[Dispatch] = []
        cap = 2 * self.batch
        for edge in sorted(by_bucket):
            cur: List[PrefixGroup] = []
            rows = 0
            for g in by_bucket[edge]:
                if cur and rows + 2 * len(g.items) > cap:
                    out.append(self._grouped_dispatch(edge, cur))
                    cur, rows = [], 0
                cur.append(g)
                rows += 2 * len(g.items)
            if cur:
                out.append(self._grouped_dispatch(edge, cur))
        return out

    def _grouped_dispatch(self, edge: int,
                          groups: List[PrefixGroup]) -> Dispatch:
        return Dispatch(
            kind="grouped", bucket=edge,
            items=[it for g in groups for it in g.items], groups=groups)

    # -- public entry --------------------------------------------------------

    def schedule(self, items: Sequence[SweepItem]) -> List[Dispatch]:
        """Plan every dispatch for ``items``. Total and deterministic:
        each item appears in exactly one dispatch; identical inputs plan
        identical schedules."""
        items = list(items)
        if self.group_cells and self.min_group_cells > 1:
            groups, rest = self._form_groups(items)
        else:
            groups, rest = [], items
        dispatches = self._plan_shared(rest) + self._plan_grouped(groups)

        # Plan suffix buckets PER PREFIX BUCKET (shape stability).
        sfx_a: Dict[Tuple[str, int], int] = {}
        sfx_b: Dict[Tuple[str, int], int] = {}
        for d in dispatches:
            key = (d.kind, d.bucket)
            if d.kind == "shared":
                la = max(len(it.bin_ids) - it.lcp for it in d.items)
                lb = max(len(it.conf_ids) - it.lcp for it in d.items)
            else:
                la = lb = max(
                    max(len(it.bin_ids), len(it.conf_ids)) - g.plen
                    for g in d.groups for it in g.items)
            sfx_a[key] = max(sfx_a.get(key, 1), la)
            sfx_b[key] = max(sfx_b.get(key, 1), lb)
        for d in dispatches:
            key = (d.kind, d.bucket)
            d.sfx_bucket_a = tok.pick_bucket([sfx_a[key]], self.suffix_buckets)
            d.sfx_bucket_b = tok.pick_bucket([sfx_b[key]], self.suffix_buckets)

        self._account(dispatches)
        return dispatches

    def _account(self, dispatches: List[Dispatch]) -> None:
        for d in dispatches:
            n = len(d.items)
            if d.kind == "shared":
                slots = _tail_batch(n, self.batch)
                real = sum(it.prefix_len for it in d.items)
                self.stats.add_dispatch(d.bucket, n, slots, real,
                                        refilled=d.refilled)
            else:
                g_pad = _tail_batch(len(d.groups), self.batch)
                m_pad = _tail_batch(2 * n, 2 * self.batch)
                real = sum(grp.plen for grp in d.groups)
                self.stats.add_dispatch(d.bucket, n, m_pad, real,
                                        used_slots=2 * n,
                                        prefill_slots=g_pad)
                self.stats.grouped_cells += n
                self.stats.grouped_prefill_rows += g_pad
