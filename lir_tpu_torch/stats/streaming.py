"""Finalize path for the streaming-statistics accumulator: grid -> CIs
without reloading the results CSV.

Port of ``lir_tpu/stats/streaming.py``. The sweep's sink
(``engine/stream_stats.py``) writes per-cell values into a (P, R)
lattice; this module reduces that lattice, in one canonical prompt-major
order, into the quantities the host-side pipeline computes from the CSV:

- per-prompt moments + 2.5/97.5 percentiles of the relative probability
  and weighted confidence (float64, pandas ddof=1 std);
- the within-prompt Cohen's kappa from the binarized decisions, through
  ``stats.kappa.within_group_kappa`` fed from the integer contingency
  counts (n_g, s_g per prompt are sufficient), so it is bitwise the
  CSV path's;
- seeded bootstrap CIs on the per-prompt means. The resample indices
  come from a CPU ``torch.Generator`` seeded by ``core.generator_for(
  seed, prompt_idx, salt)`` with the seed recorded in the sweep
  manifest, so the CIs reproduce bitwise across resume, across devices'
  draws and across ``--no-streaming-stats`` re-runs within the port.
  (They are not the JAX package's CIs: its indices come from
  ``jax.random``; the tests feed its indices to the same reduction.)

:func:`accum_from_rows` builds the same lattice from D6 rows (the port's
``PerturbationRow``s, or the row dicts ``data.schemas.read_results``
reads back); :func:`assert_parity` holds the two together: counts and
kappa bitwise, moments and CIs within :data:`FLOAT_TOL` (the lattice
stores float32 device values where the CSV path recomputes relative
probabilities in float64).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Mapping, Sequence, Tuple

import numpy as np

from ..device import resolve_device
from .bootstrap import _resampled_means
from .core import as_f32, generator_for, percentile_ci, resample_indices

# Documented float tolerance between streaming (float32 lattice values,
# f32 on-device division) and the CSV-reload pipeline (float64 recompute
# from the same stored readouts). Decisions/counts carry NO tolerance.
FLOAT_TOL = 5e-5


@dataclasses.dataclass
class HostAccum:
    """Host copy of the device lattice (read at checkpoint / finalize
    cadence, never per row)."""

    filled: np.ndarray   # (P, R) int32 0/1
    rel: np.ndarray      # (P, R) float32, NaN when invalid
    conf: np.ndarray     # (P, R) float32, NaN when invalid
    dec: np.ndarray      # (P, R) int32 1/0/-1
    seed: int

    @property
    def rows_folded(self) -> int:
        return int(self.filled.sum())


def empty_accum(n_prompts: int, n_rephrase: int, seed: int) -> HostAccum:
    P, R = int(n_prompts), int(n_rephrase)
    return HostAccum(
        filled=np.zeros((P, R), np.int32),
        rel=np.full((P, R), np.nan, np.float32),
        conf=np.full((P, R), np.nan, np.float32),
        dec=np.full((P, R), -1, np.int32),
        seed=int(seed))


def merge_accums(accs: Sequence[HostAccum],
                 allow_identical_overlap: bool = False) -> HostAccum:
    """Slot-wise, order-free union of lattices (resumed runs, shards).

    Two lattices that both filled a slot are an error (two runs scored
    one cell), unless ``allow_identical_overlap`` and the values are
    bitwise the same (a deterministic re-score); divergent duplicates
    always raise."""
    assert accs, "merge_accums needs at least one accumulator"
    out = empty_accum(*accs[0].filled.shape, seed=accs[0].seed)
    for acc in accs:
        overlap = (out.filled > 0) & (acc.filled > 0)
        if overlap.any():
            if not allow_identical_overlap:
                raise ValueError(
                    f"accumulator merge overlap on {int(overlap.sum())} "
                    "cells — two hosts folded the same grid cell")
            same = (
                np.array_equal(out.rel[overlap], acc.rel[overlap],
                               equal_nan=True)
                and np.array_equal(out.conf[overlap], acc.conf[overlap],
                                   equal_nan=True)
                and np.array_equal(out.dec[overlap], acc.dec[overlap]))
            if not same:
                raise ValueError(
                    f"accumulator merge overlap on {int(overlap.sum())} "
                    "cells with DIVERGENT values — two holders scored "
                    "one cell differently (non-deterministic scoring); "
                    "refusing to merge")
        m = acc.filled > 0
        out.filled[m] = acc.filled[m]
        out.rel[m] = acc.rel[m]
        out.conf[m] = acc.conf[m]
        out.dec[m] = acc.dec[m]
    return out


# ---------------------------------------------------------------------------
# Contingency counts and kappa (exact, integer-derived)
# ---------------------------------------------------------------------------


def contingency(acc: HostAccum) -> Dict[str, np.ndarray]:
    """Per-prompt integer contingency/agreement counts — the kappa
    sufficient statistic. Bitwise comparable across streaming and
    CSV-reload paths."""
    filled = acc.filled > 0
    valid = filled & (acc.dec >= 0)
    return {
        "n_folded": filled.sum(axis=1).astype(np.int64),
        "n_valid": valid.sum(axis=1).astype(np.int64),
        "n_yes": ((acc.dec == 1) & filled).sum(axis=1).astype(np.int64),
        "n_conf": (filled & np.isfinite(acc.conf)).sum(axis=1)
                  .astype(np.int64),
    }


def group_counts(group_ids: np.ndarray, decisions: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(n_g, s_g) per group from flat (group, decision) vectors."""
    group_ids = np.asarray(group_ids)
    decisions = np.asarray(decisions)
    uniq = np.unique(group_ids) if group_ids.size else np.empty(0, int)
    n_g = np.asarray([(group_ids == g).sum() for g in uniq], np.int64)
    s_g = np.asarray([decisions[group_ids == g].sum() for g in uniq],
                     np.int64)
    return n_g, s_g


def kappa_from_counts(n_g: np.ndarray, s_g: np.ndarray
                      ) -> Dict[str, float]:
    """Within-group kappa from per-group (n, s) counts, through the same
    ``stats.kappa.within_group_kappa`` the CSV pipeline calls — the counts
    are sufficient, so the result is bitwise, not tolerance-close."""
    from .kappa import within_group_kappa

    n_g = np.asarray(n_g, np.int64)
    s_g = np.asarray(s_g, np.int64)
    decisions: List[int] = []
    groups: List[int] = []
    for g, (n, s) in enumerate(zip(n_g, s_g)):
        decisions.extend([1] * int(s) + [0] * int(n - s))
        groups.extend([g] * int(n))
    return within_group_kappa(np.asarray(decisions, int),
                              np.asarray(groups, int))


def kappa(acc: HostAccum) -> Dict[str, float]:
    """The D6 within-prompt kappa straight from the accumulator."""
    c = contingency(acc)
    return kappa_from_counts(c["n_valid"], c["n_yes"])


# ---------------------------------------------------------------------------
# Moments / percentiles / bootstrap CIs (canonical-order reductions)
# ---------------------------------------------------------------------------


def prompt_values(acc: HostAccum, field: str, p: int) -> np.ndarray:
    """One prompt's valid values in canonical slot order (float64)."""
    arr = getattr(acc, field)[p].astype(np.float64)
    mask = (acc.filled[p] > 0) & np.isfinite(arr)
    return arr[mask]


def _moments(values: np.ndarray) -> Dict[str, float]:
    """prompt_summary_stats' numeric columns: mean, pandas-style ddof=1
    std, min/max, 2.5/97.5 percentiles, interval width (float64)."""
    if values.size == 0:
        return {k: float("nan") for k in
                ("n", "mean", "std", "min", "max", "p2_5", "p97_5",
                 "ci95_width")} | {"n": 0}
    lo, hi = np.percentile(values, [2.5, 97.5])
    return {
        "n": int(values.size),
        "mean": float(values.mean()),
        "std": float(values.std(ddof=1)) if values.size > 1
               else float("nan"),
        "min": float(values.min()),
        "max": float(values.max()),
        "p2_5": float(lo),
        "p97_5": float(hi),
        "ci95_width": float(hi - lo),
    }


def bootstrap_mean_ci_seeded(values: np.ndarray, seed: int,
                             prompt_idx: int, n_boot: int,
                             confidence: float = 0.95,
                             salt: int = 0, device="cuda"
                             ) -> Dict[str, float]:
    """Percentile bootstrap CI on the mean, resample indices drawn from
    ``core.generator_for(seed, prompt_idx, salt)`` on the CPU and reduced
    on ``device`` in float32: the same values in the same canonical order
    give the same indices on every run, resumed or not, card or CPU."""
    if values.size == 0 or n_boot <= 0:
        return {"ci_lower": float("nan"), "ci_upper": float("nan"),
                "standard_error": float("nan")}
    dev = resolve_device(device)
    idx = resample_indices(generator_for(seed, prompt_idx, salt),
                           int(n_boot), int(values.size), dev)
    samples = _resampled_means(as_f32(values, dev), idx)
    lo, hi = percentile_ci(samples, confidence)
    return {"ci_lower": float(lo), "ci_upper": float(hi),
            "standard_error": float(np.nanstd(samples.cpu().numpy()))}


_CONF_SALT = 10_000  # confidence bootstrap draws never collide with rel's


def summarize(acc: HostAccum, n_boot: int = 1000,
              confidence: float = 0.95, device="cuda") -> Dict[str, object]:
    """The full finalize: per-prompt moments/percentiles/bootstrap CIs
    for relative probability and weighted confidence, the within-prompt
    kappa, and the integer contingency counts. ``n_boot=0`` skips the
    bootstrap (cheap live mid-run estimates) and touches no device."""
    if n_boot > 0:
        device = resolve_device(device)
    counts = contingency(acc)
    per_prompt: List[Dict[str, object]] = []
    for p in range(acc.filled.shape[0]):
        rel = prompt_values(acc, "rel", p)
        conf = prompt_values(acc, "conf", p)
        entry: Dict[str, object] = {
            "prompt_idx": p,
            "n_folded": int(counts["n_folded"][p]),
            "n_valid": int(counts["n_valid"][p]),
            "n_yes": int(counts["n_yes"][p]),
            "n_no": int(counts["n_valid"][p] - counts["n_yes"][p]),
            "relative_prob": _moments(rel),
            "weighted_confidence": _moments(conf),
        }
        if n_boot > 0:
            entry["relative_prob"].update(bootstrap_mean_ci_seeded(
                rel, acc.seed, p, n_boot, confidence, device=device))
            entry["weighted_confidence"].update(bootstrap_mean_ci_seeded(
                conf, acc.seed, p, n_boot, confidence,
                salt=_CONF_SALT, device=device))
        per_prompt.append(entry)
    return {
        "rows_folded": acc.rows_folded,
        "seed": int(acc.seed),
        "n_boot": int(n_boot),
        "per_prompt": per_prompt,
        "kappa": kappa(acc),
    }


# ---------------------------------------------------------------------------
# CSV-reload parity path (kept alongside streaming)
# ---------------------------------------------------------------------------


def slot_map_from_cells(cells: Iterable) -> Dict[Tuple[str, str],
                                                 Tuple[int, int]]:
    """(original_main, rephrased_main) -> (prompt_idx, rephrase_idx)
    from the sweep's own grid cells — how D6 rows map back onto lattice
    slots."""
    return {(c.original_main, c.rephrased_main):
            (c.prompt_idx, c.rephrase_idx) for c in cells}


# Row-dict column of each PerturbationRow field accum_from_rows reads.
_ROW_COLUMNS = (("original_main", "Original Main Part"),
                ("rephrased_main", "Rephrased Main Part"),
                ("token_1_prob", "Token_1_Prob"),
                ("token_2_prob", "Token_2_Prob"),
                ("weighted_confidence", "Weighted Confidence"))


def _as_float(v) -> float:
    """A D6 measurement as float64: None / '' (a null) -> NaN."""
    if v is None or v == "":
        return float("nan")
    return float(v)


def _row_fields(row) -> Tuple[str, str, float, float, float]:
    if isinstance(row, Mapping):
        vals = [row.get(col) for _, col in _ROW_COLUMNS]
    else:
        vals = [getattr(row, attr) for attr, _ in _ROW_COLUMNS]
    return (vals[0], vals[1], _as_float(vals[2]), _as_float(vals[3]),
            _as_float(vals[4]))


def accum_from_rows(rows: Iterable, slot_map: Mapping[Tuple[str, str],
                                                      Tuple[int, int]],
                    n_prompts: int, n_rephrase: int,
                    seed: int) -> HostAccum:
    """Rebuild the lattice from D6 rows (the CSV-reload parity path):
    relative probability recomputed in float64 as the analysis layer's
    add_relative_prob does, decision as Relative_Prob > 0.5, quarantined
    rows (null token probs) invalid. ``rows`` are ``PerturbationRow``s
    or the row dicts ``schemas.read_results`` returns. With the
    manifest-recorded ``seed`` this reproduces the streaming CIs from a
    ``--no-streaming-stats`` re-run's artifact."""
    acc = empty_accum(n_prompts, n_rephrase, seed)
    for row in rows:
        orig, reph, t1, t2, wc = _row_fields(row)
        slot = slot_map.get((orig, reph))
        if slot is None:
            continue
        p, r = slot
        acc.filled[p, r] = 1
        total = t1 + t2
        if np.isfinite(total) and total > 0:
            rel = t1 / total
            acc.rel[p, r] = np.float32(rel)
            acc.dec[p, r] = 1 if rel > 0.5 else 0
        if np.isfinite(wc):
            acc.conf[p, r] = np.float32(wc)
    return acc


def assert_parity(streamed: Dict[str, object],
                  reloaded: Dict[str, object],
                  tol: float = FLOAT_TOL) -> None:
    """The acceptance gate: counts and kappa bitwise, moments and CIs
    within the documented float tolerance. Raises AssertionError with
    the first divergence."""
    assert streamed["rows_folded"] == reloaded["rows_folded"], (
        streamed["rows_folded"], reloaded["rows_folded"])
    ks, kr = streamed["kappa"], reloaded["kappa"]
    for k in ("kappa", "observed_agreement", "expected_agreement"):
        a, b = ks[k], kr[k]
        assert (np.isnan(a) and np.isnan(b)) or a == b, (k, a, b)
    for es, er in zip(streamed["per_prompt"], reloaded["per_prompt"]):
        for k in ("n_folded", "n_valid", "n_yes", "n_no"):
            assert es[k] == er[k], (k, es[k], er[k])
        for field in ("relative_prob", "weighted_confidence"):
            ms, mr = es[field], er[field]
            assert ms["n"] == mr["n"], (field, ms["n"], mr["n"])
            for k in ("mean", "std", "min", "max", "p2_5", "p97_5",
                      "ci_lower", "ci_upper"):
                if k not in ms and k not in mr:
                    continue
                a, b = ms.get(k, float("nan")), mr.get(k, float("nan"))
                if np.isnan(a) and np.isnan(b):
                    continue
                assert abs(a - b) <= tol, (
                    f"prompt {es['prompt_idx']} {field}.{k}: "
                    f"{a} vs {b} (tol {tol})")
