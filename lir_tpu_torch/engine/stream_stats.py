"""Device-resident streaming statistics: the sweep's grid -> CIs with no
per-row host round-trip.

Port of the sweep sink of ``lir_tpu/engine/stream_stats.py``. The sink
holds a (P, R) lattice on the device, 16 bytes a grid cell:

- ``filled`` (P, R) int32 — which cells have folded;
- ``rel``    (P, R) float32 — P(yes) / (P(yes) + P(no)), NaN for a
  zero-mass or guard-invalid cell;
- ``conf``   (P, R) float32 — the weighted confidence, NaN likewise;
- ``dec``    (P, R) int32 — 1 = yes > no, 0 = no, -1 = invalid; yes > no
  in float32 is exactly the CSV path's float64 Relative_Prob > 0.5, so
  contingency counts match it bitwise.

Every scoring dispatch folds into it with one launch of
``ops.stream_fold`` on the dispatch's stream (the plain twin on a CPU
lattice), pad rows dropped on the device by an out-of-range slot. Writes
are per slot, so folds are idempotent and commutative: a resumed sweep
that re-folds rows dispatched but not checkpointed lands bitwise on the
same lattice. Moments are reduced only at finalize, in canonical order
(``stats.streaming``).

The sweep folds on its main thread and checkpoints on its writer
thread; a lock orders the two (on the card it only orders their
enqueueing, and stream order makes each checkpoint a superset of the
rows it precedes).

The serve loop's ring (:class:`ServeStreamSink`) is host-side: serving
copies every payload to the host anyway, so it folds resolved payloads,
once each, keyed by content address.

The device-side validity predicate is the numerics guard's
(``guard/numerics.check_values``), so a row the guard quarantines as
``error:numerics`` is invalid in the lattice too. ``save_accum`` writes
the JAX package's ``.npz`` keys: either package reads the other's
accumulator.
"""

from __future__ import annotations

import collections
import os
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import ops
from ..device import resolve_device
from ..ops.stream_fold import LATTICE
from ..stats import streaming
from ..utils.logging import get_logger
from ..utils.profiling import StreamStats

log = get_logger(__name__)

ACCUM_SUFFIX = ".accum.npz"


def new_accum(n_prompts: int, n_rephrase: int,
              device="cuda") -> Dict[str, torch.Tensor]:
    """Fresh lattice for a (P, R) grid on ``device``."""
    dev = resolve_device(device)
    shape = (int(n_prompts), int(n_rephrase))
    return {
        "filled": torch.zeros(shape, dtype=torch.int32, device=dev),
        "rel": torch.full(shape, float("nan"), dtype=torch.float32,
                          device=dev),
        "conf": torch.full(shape, float("nan"), dtype=torch.float32,
                           device=dev),
        "dec": torch.full(shape, -1, dtype=torch.int32, device=dev),
    }


def fold_update(acc: Dict[str, torch.Tensor], yes: torch.Tensor,
                no: torch.Tensor, wconf: torch.Tensor, lp: torch.Tensor,
                pidx: torch.Tensor, ridx: torch.Tensor,
                guard: bool = True) -> Dict[str, torch.Tensor]:
    """One dispatch's fold into ``acc``, in place (the JAX package
    donates its lattice). ``yes`` / ``no`` / ``wconf`` are the (B,)
    position-0 readouts, ``lp`` the (B, K) top-K log-probs, ``pidx`` /
    ``ridx`` the (B,) int32 grid coordinates, a pad row's ``ridx`` = R.
    A card lattice launches ``ops.stream_fold``; a CPU lattice runs its
    plain twin. ``guard=False`` accepts every row verbatim."""
    ops.stream_fold(acc, yes, no, wconf, lp, pidx, ridx, guard)
    return acc


class StreamSink:
    """One sweep's streaming sink: the device lattice, the fold, and the
    checkpoint save/load and finalize around it."""

    def __init__(self, n_prompts: int, n_rephrase: int, seed: int,
                 guard: bool = True, stats: Optional[StreamStats] = None,
                 device="cuda"):
        self.n_prompts = int(n_prompts)
        self.n_rephrase = int(n_rephrase)
        self.seed = int(seed)
        self.guard = bool(guard)
        self.device = resolve_device(device)
        self.stats = stats if stats is not None else StreamStats()
        self._lock = threading.Lock()
        self._acc = new_accum(self.n_prompts, self.n_rephrase, self.device)
        self.stats.gauge("accum_bytes", self.accum_bytes)

    @property
    def accum_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self._acc.values())

    def fold(self, yes: torch.Tensor, no: torch.Tensor, wconf: torch.Tensor,
             lp: torch.Tensor, cells: Sequence) -> None:
        """Fold one dispatch's readouts. ``cells`` are the dispatch's real
        grid cells in row order; rows past them are padding and fold to
        the out-of-range slot ridx = R. The coordinates go to the device
        in one non-blocking copy (from pinned memory on the card);
        nothing is read back."""
        bsz = int(yes.shape[0])
        coords = np.empty((2, bsz), np.int32)
        coords[0] = 0
        coords[1] = self.n_rephrase
        for j, c in enumerate(cells):
            coords[0, j] = c.prompt_idx
            coords[1, j] = c.rephrase_idx
        host = torch.from_numpy(coords)
        if self.device.type == "cuda":
            host = host.pin_memory()
        dev_coords = host.to(self.device, non_blocking=True)
        with self._lock:
            fold_update(self._acc, yes, no, wconf, lp, dev_coords[0],
                        dev_coords[1], guard=self.guard)
        self.stats.count("rows_folded", len(cells))
        self.stats.count("dispatch_folds")

    def note_bytes_avoided(self, tensors: Sequence[torch.Tensor]) -> None:
        """Count the per-row payload bytes the CSV path would have copied
        to the host for this dispatch (shapes only, no sync)."""
        self.stats.count("host_bytes_avoided", sum(
            t.numel() * t.element_size() for t in tensors))

    def snapshot(self) -> streaming.HostAccum:
        """The lattice on the host (the one sanctioned device -> host
        copy: a few bytes a cell, at checkpoint / finalize cadence)."""
        with self._lock:
            host = {k: v.to("cpu", copy=True) for k, v in self._acc.items()}
        return streaming.HostAccum(
            filled=host["filled"].numpy(), rel=host["rel"].numpy(),
            conf=host["conf"].numpy(), dec=host["dec"].numpy(),
            seed=self.seed)

    def checkpoint(self, path: Path) -> None:
        """Atomic snapshot beside the results artifact (tmp + fsync +
        rename: a kill mid-checkpoint leaves the previous snapshot)."""
        save_accum(self.snapshot(), path)
        self.stats.count("checkpoints")

    def load(self, path: Path) -> bool:
        """Seed the lattice from a prior checkpoint; a missing file or
        another grid's shape starts fresh instead."""
        acc = load_accum(path)
        if acc is None:
            return False
        if acc.filled.shape != (self.n_prompts, self.n_rephrase):
            log.warning("stream accum %s has shape %s != grid (%d, %d); "
                        "starting fresh", path, acc.filled.shape,
                        self.n_prompts, self.n_rephrase)
            return False
        self.seed = int(acc.seed)
        with self._lock:
            for name in LATTICE:
                self._acc[name].copy_(torch.from_numpy(
                    np.ascontiguousarray(getattr(acc, name))))
        return True

    def finalize(self, n_boot: int = 1000, confidence: float = 0.95):
        """Grid -> CIs straight from the lattice (no CSV reload); also
        the live mid-run estimate."""
        t0 = time.perf_counter()
        out = streaming.summarize(self.snapshot(), n_boot=n_boot,
                                  confidence=confidence, device=self.device)
        self.stats.count("finalize_s", time.perf_counter() - t0)
        return out


def save_accum(acc: streaming.HostAccum, path: Path) -> None:
    """Crash-safe accumulator write (tmp + fsync + rename), the JAX
    package's keys: ``filled``, ``rel``, ``conf``, ``dec``, ``seed``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=str(path.parent),
                               prefix=path.name + ".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, filled=acc.filled, rel=acc.rel, conf=acc.conf,
                     dec=acc.dec, seed=np.int64(acc.seed))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_accum(path: Path) -> Optional[streaming.HostAccum]:
    """Read a checkpointed accumulator; None when missing or unreadable
    (resume then re-folds from the manifest's pending set alone)."""
    path = Path(path)
    if not path.exists():
        return None
    try:
        with np.load(path) as z:
            return streaming.HostAccum(
                filled=z["filled"], rel=z["rel"], conf=z["conf"],
                dec=z["dec"], seed=int(z["seed"]))
    except (OSError, ValueError, KeyError) as err:
        # A torn or foreign file only costs re-folding; never fails the
        # resume.
        log.warning("stream accum %s unreadable (%r); starting fresh",
                    path, err)
        return None


class ServeStreamSink:
    """Online streaming sink (the JAX package's): live percentile and
    kappa estimates over the last ``window`` served rows, grouped by
    target pair.

    Folds consume resolved payloads on the host, which makes the
    accounting idempotent across a shutdown checkpoint: a row folds iff
    its future resolved ok, exactly once, keyed by content address. A
    row cancelled in flight never folds; re-submitted after a resume it
    folds on its fresh score, once."""

    def __init__(self, window: int = 4096, max_groups: int = 64,
                 stats: Optional[StreamStats] = None):
        self.window = max(int(window), 1)
        self.max_groups = int(max_groups)
        self.stats = stats if stats is not None else StreamStats()
        self._lock = threading.Lock()
        # The ring and the idempotence set, guarded by _lock (the
        # supervisor folds while the stats endpoint reads).
        self._group_ids: Dict[Tuple[str, str], int] = {}
        self._group = np.full(self.window, -1, np.int32)
        self._rel = np.full(self.window, np.nan, np.float64)
        self._conf = np.full(self.window, np.nan, np.float64)
        self._dec = np.full(self.window, -1, np.int32)
        self._head = 0
        self._folded: "collections.OrderedDict[str, None]" = (
            collections.OrderedDict())
        self._folded_cap = max(8 * self.window, 65536)

    def _group_id(self, targets: Tuple[str, str]) -> int:  # guarded-by: _lock
        gid = self._group_ids.get(targets)
        if gid is None:
            if len(self._group_ids) >= self.max_groups:
                return self.max_groups - 1  # overflow bucket
            gid = len(self._group_ids)
            self._group_ids[targets] = gid
        return gid

    def fold_payload(self, key, targets: Tuple[str, str],
                     payload: Dict) -> bool:
        """Fold one resolved payload; False when its content address
        already folded (a dedup hit, a resume, a re-submitted row)."""
        key = str(key)
        t1p = payload.get("token_1_prob")
        t2p = payload.get("token_2_prob")
        wc = payload.get("weighted_confidence")
        with self._lock:
            if key in self._folded:
                return False
            self._folded[key] = None
            while len(self._folded) > self._folded_cap:
                self._folded.popitem(last=False)
            i = self._head % self.window
            self._head += 1
            self._group[i] = self._group_id(tuple(targets))
            if (t1p is not None and t2p is not None
                    and np.isfinite(t1p) and np.isfinite(t2p)
                    and t1p + t2p > 0):
                self._rel[i] = t1p / (t1p + t2p)
                self._dec[i] = 1 if t1p > t2p else 0
            else:
                self._rel[i] = np.nan
                self._dec[i] = -1
            self._conf[i] = (float(wc) if wc is not None
                             and np.isfinite(wc) else np.nan)
        self.stats.count("rows_folded")
        return True

    def summary(self) -> Dict[str, object]:
        """Live estimates over the ring: per group n, mean and 2.5/97.5
        percentiles of the relative probability, the confidence mean,
        and the within-group kappa of the decisions
        (stats/streaming's closed form)."""
        self.stats.count("live_queries")
        with self._lock:
            used = self._group >= 0
            group = self._group[used].copy()
            rel = self._rel[used].copy()
            conf = self._conf[used].copy()
            dec = self._dec[used].copy()
            names = {gid: list(t) for t, gid in self._group_ids.items()}
            head = self._head
        per_group: Dict[str, object] = {}
        for gid in sorted(set(group.tolist())):
            m = group == gid
            r = rel[m]
            r = r[np.isfinite(r)]
            entry: Dict[str, object] = {
                "targets": names.get(gid, ["?", "?"]),
                "rows": int(m.sum()), "n_valid": int(r.size),
            }
            if r.size:
                entry.update({
                    "mean_relative_prob": float(r.mean()),
                    "p2_5": float(np.percentile(r, 2.5)),
                    "p97_5": float(np.percentile(r, 97.5)),
                })
            c = conf[m]
            c = c[np.isfinite(c)]
            if c.size:
                entry["mean_weighted_confidence"] = float(c.mean())
            per_group[str(gid)] = entry
        valid = dec >= 0
        kap = streaming.kappa_from_counts(
            *streaming.group_counts(group[valid], dec[valid]))
        return {"rows_folded": int(head),
                "window": int(min(head, self.window)),
                "per_group": per_group, "kappa": kap}

    def state(self) -> Dict[str, object]:
        """JSON-serializable snapshot for the serve shutdown checkpoint:
        the ring AND the folded-key set."""
        with self._lock:
            return {
                "window": self.window,
                "head": self._head,
                "groups": [[list(t), gid]
                           for t, gid in self._group_ids.items()],
                "group": self._group.tolist(),
                "rel": [None if not np.isfinite(v) else float(v)
                        for v in self._rel],
                "conf": [None if not np.isfinite(v) else float(v)
                         for v in self._conf],
                "dec": self._dec.tolist(),
                "folded": list(self._folded.keys()),
            }

    def restore(self, state: Optional[Dict[str, object]]) -> None:
        """Reload a :meth:`state` snapshot (ignored when absent or of
        another window size)."""
        if not state or int(state.get("window", 0)) != self.window:
            return
        with self._lock:
            self._head = int(state["head"])
            self._group_ids = {tuple(t): int(g)
                               for t, g in state["groups"]}
            self._group = np.asarray(state["group"], np.int32)
            self._rel = np.asarray(
                [np.nan if v is None else v for v in state["rel"]],
                np.float64)
            self._conf = np.asarray(
                [np.nan if v is None else v for v in state["conf"]],
                np.float64)
            self._dec = np.asarray(state["dec"], np.int32)
            self._folded = collections.OrderedDict(
                (k, None) for k in state.get("folded", ()))
