"""Resume-idempotent sweep manifest.

The reference achieves preemption safety by (a) a done-set of
(Model, Original Main Part, Rephrased Main Part) keys read from the output
Excel (perturb_prompts.py:161-188), (b) checkpoint files every 100 rows
(:975-984), and (c) a validated perturbation cache (:739-777). This module
keeps those exact semantics but as an append-only JSONL manifest with atomic
line writes, so a killed sweep resumes without duplicate rows (SURVEY.md
§7 hard part 7).

A copy of the JAX package's ``utils/manifest.py``. The on-disk JSONL
format is the same, so either package resumes the other's manifest;
``from_existing_results`` reads the CSV results artifact with the
stdlib ``csv`` module instead of pandas.
"""

from __future__ import annotations

import csv
import json
import os
import tempfile
from pathlib import Path
from typing import Dict, Iterable, Iterator, Optional, Set, Tuple

Key = Tuple[str, ...]


class SweepManifest:
    """Append-only record of completed grid cells, keyed by string tuples.

    Crash-consistent by construction: appends are a single fsync'd write
    (plus a parent-directory fsync so the file itself survives a host
    crash right after creation), and loading TOLERATES a torn trailing
    line — the exact artifact the crash this manifest exists to survive
    leaves behind. A torn (non-JSON or key-incomplete) tail is skipped
    on load and truncated away by the next append; a malformed line
    anywhere ELSE still raises, because that is corruption no crash of
    ours produces."""

    def __init__(self, path: Path, key_fields: Tuple[str, ...]):
        self.path = Path(path)
        self.key_fields = key_fields
        self._done: Set[Key] = set()
        # Sweep-scoped metadata records ({"__meta__": {...}} lines):
        # run parameters that must survive a resume — e.g. the
        # streaming-statistics bootstrap key ("stream_seed"), so a
        # resumed sweep's CIs are drawn from the SAME resample indices
        # as an uninterrupted one (engine/stream_stats.py).
        self.meta: Dict[str, object] = {}
        # Byte offset to truncate to before the next append (a torn
        # trailing line from a mid-append crash); None = file is clean.
        self._truncate_to: Optional[int] = None
        if self.path.exists():
            raw = self.path.read_bytes()
            pos = 0
            chunks = raw.split(b"\n")
            for i, chunk in enumerate(chunks):
                start = pos
                pos += len(chunk) + 1
                if not chunk.strip():
                    continue
                try:
                    rec = json.loads(chunk.decode("utf-8"))
                    if isinstance(rec, dict) and "__meta__" in rec:
                        if isinstance(rec["__meta__"], dict):
                            self.meta.update(rec["__meta__"])
                        continue
                    key = tuple(str(rec[f]) for f in key_fields)
                except (UnicodeDecodeError, json.JSONDecodeError, KeyError,
                        TypeError):
                    if all(not c.strip() for c in chunks[i + 1:]):
                        # Torn tail: the crash happened mid-append. The
                        # rows it named were NOT marked done, so a
                        # resumed sweep re-scores them (write-ahead
                        # order: results first, manifest second).
                        self._truncate_to = start
                        break
                    raise
                self._done.add(key)

    def __len__(self) -> int:
        return len(self._done)

    def key_of(self, record: Dict[str, object]) -> Key:
        return tuple(str(record[f]) for f in self.key_fields)

    def is_done(self, record: Dict[str, object]) -> bool:
        return self.key_of(record) in self._done

    def mark_done(self, record: Dict[str, object]) -> None:
        self.mark_done_many([record])

    def set_meta(self, key: str, value) -> None:
        """Record (or re-record) one metadata value as a durable
        ``{"__meta__": ...}`` line. Idempotent: an unchanged value
        appends nothing, and a resumed manifest returns the recorded
        value via ``self.meta`` before any caller re-derives it."""
        if self.meta.get(key) == value:
            return
        self.meta[key] = value
        self._append_lines([json.dumps({"__meta__": {key: value}})])

    def mark_done_many(self, records: Iterable[Dict[str, object]]) -> None:
        """Append all not-yet-done keys in one open + single fsync."""
        lines = []
        for record in records:
            key = self.key_of(record)
            if key in self._done:
                continue
            self._done.add(key)
            lines.append(json.dumps(dict(zip(self.key_fields, key))))
        self._append_lines(lines)

    def _append_lines(self, lines) -> None:
        if not lines:
            return
        self.path.parent.mkdir(parents=True, exist_ok=True)
        created = not self.path.exists()
        if self._truncate_to is not None and not created:
            # Drop the torn tail found at load time BEFORE appending —
            # otherwise the new first line glues onto the fragment and
            # becomes unparseable itself.
            with self.path.open("r+b") as f:
                f.truncate(self._truncate_to)
        self._truncate_to = None
        with self.path.open("a") as f:
            f.write("\n".join(lines) + "\n")
            f.flush()
            os.fsync(f.fileno())
        if created:
            _fsync_dir(self.path.parent)

    def pending(self, records: Iterable[Dict[str, object]]) -> Iterator[Dict[str, object]]:
        for rec in records:
            if not self.is_done(rec):
                yield rec

    @classmethod
    def from_existing_results(
        cls,
        manifest_path: Path,
        results_path: Optional[Path],
        key_fields: Tuple[str, ...],
        column_map: Optional[Dict[str, str]] = None,
    ) -> "SweepManifest":
        """Seed the done-set from a prior results file, mirroring
        load_existing_results (perturb_prompts.py:161-188).

        This is the crash-consistency half the manifest alone cannot
        give: the flush order is results-append THEN manifest-mark, so a
        kill between the two leaves rows in the results file that the
        manifest does not know about — a manifest-only resume would
        re-score and DUPLICATE them. Seeding the union makes the done
        set exactly "whatever reached the results artifact".

        ``column_map`` maps manifest key fields to results-file column
        names (the D6 workbook uses 'Model'/'Original Main Part'/... for
        the manifest's 'model'/'original_main'/...). An unreadable or
        torn prior file degrades to manifest-only seeding instead of
        failing the resume — losing the seed only re-scores rows, never
        loses or duplicates them (write-ahead order + this union)."""
        m = cls(manifest_path, key_fields)
        if results_path is None or not Path(results_path).exists():
            return m
        cols = {f: (column_map or {}).get(f, f) for f in key_fields}
        try:
            with open(results_path, newline="", encoding="utf-8") as f:
                reader = csv.reader(f, strict=True)
                header = next(reader, None)
                body = list(reader)
        except (OSError, UnicodeDecodeError, csv.Error):
            return m
        if header is None or not all(c in header for c in cols.values()):
            return m
        at = {f: header.index(c) for f, c in cols.items()}
        # Rows with more fields than the header are skipped, and rows
        # missing a key field do not count as done (pandas'
        # on_bad_lines="skip" and dropna in the JAX package).
        m.mark_done_many(
            {f: row[i] for f, i in at.items()}
            for row in body
            if len(row) <= len(header)
            and all(i < len(row) and row[i] != "" for i in at.values()))
        return m


def _fsync_dir(path: Path) -> None:
    """fsync a directory so a just-created file's entry is durable (a
    crash after file-fsync but before dir-fsync can lose the whole
    file on some filesystems). Best-effort: not every platform allows
    opening directories."""
    try:
        fd = os.open(str(path), os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_text(path: Path, text: str) -> None:
    """Crash-safe file replacement: write a temporary file beside ``path``,
    fsync it, then rename it over ``path``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), prefix=path.name + ".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def atomic_write_json(path: Path, obj) -> None:
    atomic_write_text(path, json.dumps(obj, ensure_ascii=False, indent=2))
