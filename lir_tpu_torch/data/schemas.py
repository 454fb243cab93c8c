"""Result records of the sweeps, their writers and the perturbation
cache (a copy of the part of the JAX package's ``data/schemas.py`` that
the sweeps write and read).

Every artifact is CSV, written and read with the stdlib ``csv`` module
(no pandas): D1 ``model_comparison_results.csv`` and D2
``instruct_model_comparison_results.csv`` of the model-comparison sweep,
and D6 of the perturbation sweep. Each parses under pandas to the frame
the JAX package's writer writes (NaN and None as an empty field, floats
by ``repr``); D6's append, backup and torn-tail recovery follow that
writer. D5 ``perturbations.json`` is the JAX cache format.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import math
import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple


# D1: model_comparison_results.csv (base vs instruct sweep)
MODEL_COMPARISON_COLUMNS = (
    "prompt",
    "model",
    "model_family",
    "base_or_instruct",
    "model_output",
    "yes_prob",
    "no_prob",
    "odds_ratio",
)

# D2: instruct_model_comparison_results.csv
INSTRUCT_COMPARISON_COLUMNS = (
    "prompt",
    "model",
    "model_family",
    "model_output",
    "yes_prob",
    "no_prob",
    "relative_prob",
)


def model_family(model_name: str) -> str:
    """Family tag parsed from an HF repo id (compare_base_vs_instruct.py:96)."""
    base = model_name.split("/")[-1]
    return base.split("-")[0].lower()


@dataclasses.dataclass
class ScoreRow:
    """One scored (model, prompt) measurement — the unified D1/D2 record.

    The reference drifts between ``odds_ratio`` (= yes/no,
    compare_base_vs_instruct.py:293) and ``relative_prob`` (= yes/(yes+no),
    compare_instruct_models.py:281); this record carries both readouts from one
    scoring primitive.
    """

    prompt: str
    model: str
    base_or_instruct: str          # "base" | "instruct"
    model_output: str
    yes_prob: float
    no_prob: float
    position_found: int = 0
    yes_no_found: bool = True

    @property
    def odds_ratio(self) -> float:
        # Reference semantics (compare_base_vs_instruct.py:293): inf whenever
        # no_prob is zero, even if yes_prob is also zero.
        return self.yes_prob / self.no_prob if self.no_prob > 0 else math.inf

    @property
    def relative_prob(self) -> float:
        denom = self.yes_prob + self.no_prob
        return self.yes_prob / denom if denom > 0 else float("nan")

    @property
    def model_family(self) -> str:
        return model_family(self.model)


def _write_comparison_csv(records: List[Dict[str, object]], columns,
                          path: Path) -> List[Dict[str, object]]:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    _write_csv(path, [[_cell(r[c]) for c in columns] for r in records],
               columns=columns)
    return records


def write_model_comparison_csv(rows: Sequence[ScoreRow],
                               path: Path) -> List[Dict[str, object]]:
    """D1 writer — schema parity with compare_base_vs_instruct.py:101-110.
    Returns the records written, one dict a row."""
    return _write_comparison_csv([
        {"prompt": r.prompt, "model": r.model, "model_family": r.model_family,
         "base_or_instruct": r.base_or_instruct,
         "model_output": r.model_output, "yes_prob": r.yes_prob,
         "no_prob": r.no_prob, "odds_ratio": r.odds_ratio}
        for r in rows], MODEL_COMPARISON_COLUMNS, path)


def write_instruct_comparison_csv(rows: Sequence[ScoreRow],
                                  path: Path) -> List[Dict[str, object]]:
    """D2 writer — schema parity with compare_instruct_models.py:112-120.
    Returns the records written, one dict a row."""
    return _write_comparison_csv([
        {"prompt": r.prompt, "model": r.model, "model_family": r.model_family,
         "model_output": r.model_output, "yes_prob": r.yes_prob,
         "no_prob": r.no_prob, "relative_prob": r.relative_prob}
        for r in rows], INSTRUCT_COMPARISON_COLUMNS, path)


# ---------------------------------------------------------------------------
# D6: the perturbation results artifact, 15 columns (perturb_prompts.py:965-969)
# ---------------------------------------------------------------------------

PERTURBATION_COLUMNS = (
    "Model",
    "Original Main Part",
    "Response Format",
    "Confidence Format",
    "Rephrased Main Part",
    "Full Rephrased Prompt",
    "Full Confidence Prompt",
    "Model Response",
    "Model Confidence Response",
    "Log Probabilities",
    "Token_1_Prob",
    "Token_2_Prob",
    "Odds_Ratio",
    "Confidence Value",
    "Weighted Confidence",
)


@dataclasses.dataclass
class PerturbationRow:
    """One perturbation-grid measurement — the D6 record."""

    model: str
    original_main: str
    response_format: str
    confidence_format: str
    rephrased_main: str
    full_rephrased_prompt: str
    full_confidence_prompt: str
    model_response: str
    model_confidence_response: str
    log_probabilities: str          # stringified token->logprob mapping
    token_1_prob: Optional[float]
    token_2_prob: Optional[float]
    confidence_value: Optional[float]
    weighted_confidence: Optional[float]

    @property
    def odds_ratio(self) -> float:
        if self.token_1_prob is None or self.token_2_prob is None:
            return math.nan
        if self.token_2_prob > 0:
            return self.token_1_prob / self.token_2_prob
        return math.inf

    def to_record(self) -> Dict[str, object]:
        return {
            "Model": self.model,
            "Original Main Part": self.original_main,
            "Response Format": self.response_format,
            "Confidence Format": self.confidence_format,
            "Rephrased Main Part": self.rephrased_main,
            "Full Rephrased Prompt": self.full_rephrased_prompt,
            "Full Confidence Prompt": self.full_confidence_prompt,
            "Model Response": self.model_response,
            "Model Confidence Response": self.model_confidence_response,
            "Log Probabilities": self.log_probabilities,
            "Token_1_Prob": self.token_1_prob,
            "Token_2_Prob": self.token_2_prob,
            "Odds_Ratio": self.odds_ratio,
            "Confidence Value": self.confidence_value,
            "Weighted Confidence": self.weighted_confidence,
        }


def resolve_results_path(path: Path) -> Path:
    """The path the D6 writer uses: CSV, with an ``.xlsx`` request moved
    to ``.csv`` beside it (the JAX package does the same wherever no
    Excel engine is installed; columns, not the container, are the D6
    contract). Resolve ONCE at sweep start so manifests, readers and
    writers agree on the artifact name."""
    path = Path(path)
    return path.with_suffix(".csv") if path.suffix == ".xlsx" else path


def _cell(value) -> object:
    """A record value as pandas' ``to_csv`` writes it: None and NaN as an
    empty field, floats in their shortest round-trip form."""
    if value is None or (isinstance(value, float) and math.isnan(value)):
        return ""
    return value


def _csv_rows(records: Sequence[Dict[str, object]]) -> List[List[object]]:
    return [[_cell(r[c]) for c in PERTURBATION_COLUMNS] for r in records]


def _write_csv(path: Path, rows: Sequence[Sequence[object]],
               mode: str = "w", header: bool = True,
               columns: Sequence[str] = PERTURBATION_COLUMNS) -> None:
    with path.open(mode, newline="", encoding="utf-8") as f:
        w = csv.writer(f, lineterminator="\n")
        if header:
            w.writerow(columns)
        w.writerows(rows)


def _parse_csv(path: Path) -> Tuple[List[str], List[List[str]]]:
    """(header, rows) of a CSV artifact, strictly: raises ValueError (or
    csv.Error) on an empty file, a field left open at the end, or a row
    with more fields than the header — the inputs pandas' reader refuses.
    Short rows pass, as pandas pads them."""
    with path.open(newline="", encoding="utf-8") as f:
        reader = csv.reader(f, strict=True)
        header = next(reader, None)
        if header is None:
            raise ValueError(f"{path} is empty")
        rows = list(reader)
    for i, row in enumerate(rows):
        if len(row) > len(header):
            raise ValueError(f"{path}: row {i + 1} has {len(row)} fields, "
                             f"the header {len(header)}")
    return header, rows


def _read_header(path: Path) -> Optional[List[str]]:
    try:
        with path.open(newline="", encoding="utf-8") as f:
            return next(csv.reader(f, strict=True), None)
    except (OSError, UnicodeDecodeError, csv.Error):
        return None


def write_perturbation_results(
    rows: Sequence[PerturbationRow], path: Path, append: bool = True
) -> List[Dict[str, object]]:
    """D6 writer with the reference's append-with-schema-check semantics
    (perturb_prompts.py:987-1016), CSV only. Returns the records written by
    THIS call.

    - Appending to a file whose header matches is O(new rows): nothing
      but the header is read.
    - A file whose header differs is moved to ``<stem>_backup`` and a
      fresh one written, never silently merged.
    - Torn-write recovery uses a KNOWN-GOOD-OFFSET sidecar (``.offset``):
      every successful write records the file size, and anything past it
      is a torn tail, truncated before the next append. D6 fields hold
      newlines and quotes, so the bytes alone cannot tell a torn tail.
      Dropping the fragment loses nothing: rows are marked done only
      after they are written (sweep._flush), so torn rows are re-scored.
    - A file that cannot be trusted for appending (no sidecar and it
      does not parse) is kept in place, and the new rows go to
      ``<stem>_new`` beside it (appended there by later flushes).
    """
    records = [r.to_record() for r in rows]
    path = resolve_results_path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if append and path.exists():
        existing_cols = _read_header(path)
        if existing_cols == list(PERTURBATION_COLUMNS):
            if _recover_known_good(path):
                _write_csv(path, _csv_rows(records), mode="a", header=False)
                _record_known_good(path)
                return records
        elif existing_cols is not None:
            path.rename(path.with_name(path.stem + "_backup" + path.suffix))
            _offset_sidecar(path).unlink(missing_ok=True)
            _write_csv(path, _csv_rows(records))
            _record_known_good(path)
            return records
        # Corrupt or truncated prior file (a kill mid-write): keep it and
        # save the rows beside it, as the reference does
        # (perturb_prompts.py:1007-1011) — never lose computed results.
        new_path = path.with_name(path.stem + "_new" + path.suffix)
        prev: List[List[str]] = []
        if new_path.exists():
            try:
                header, body = _parse_csv(new_path)
                if header == list(PERTURBATION_COLUMNS):
                    prev = body
            except (OSError, UnicodeDecodeError, ValueError, csv.Error):
                pass
        _write_csv(new_path, prev + _csv_rows(records))
        return records
    _write_csv(path, _csv_rows(records))
    _record_known_good(path)
    return records


def _offset_sidecar(path: Path) -> Path:
    return path.with_name(path.name + ".offset")


def _record_known_good(path: Path) -> None:
    """Atomically record the artifact's current size as known-good (every
    byte up to it was written by a completed flush)."""
    side = _offset_sidecar(path)
    tmp = side.with_name(side.name + ".tmp")
    tmp.write_text(str(path.stat().st_size))
    os.replace(tmp, side)


def _recover_known_good(path: Path) -> bool:
    """Prepare ``path`` for a fast append: truncate any torn tail past the
    recorded known-good offset. Returns False when the artifact cannot be
    trusted for appending (no or invalid sidecar, and the file does not
    parse cleanly).

    A file without a sidecar is validated ONCE by a full parse; every
    later flush is O(new rows)."""
    side = _offset_sidecar(path)
    try:
        known = int(side.read_text())
    except (OSError, ValueError):
        known = None
    size = path.stat().st_size
    if known is not None and 0 < known <= size:
        if size > known:
            with path.open("rb+") as f:
                f.truncate(known)
        return True
    # No sidecar: a torn PLAIN tail (no trailing newline) would pass the
    # parse as a short row and then poison the next append — drop it
    # before validating. A tail torn inside a QUOTED field fails the
    # parse instead, and the caller takes the corrupt-file path.
    with path.open("rb") as f:
        end = f.seek(0, 2)
        last = b"\n"
        if end > 0:
            f.seek(end - 1)
            last = f.read(1)
    if last != b"\n":
        _truncate_after_last_newline(path)
    try:
        _parse_csv(path)
    except (OSError, UnicodeDecodeError, ValueError, csv.Error):
        return False
    _record_known_good(path)
    return True


def _truncate_after_last_newline(path: Path) -> None:
    """Drop a partial last line: scan backward in blocks for the final
    newline and truncate just after it (empty file if none)."""
    with path.open("rb+") as f:
        pos = f.seek(0, 2)
        block = 4096
        while pos > 0:
            start = max(0, pos - block)
            f.seek(start)
            chunk = f.read(pos - start)
            nl = chunk.rfind(b"\n")
            if nl >= 0:
                f.truncate(start + nl + 1)
                return
            pos = start
        f.truncate(0)


def read_results(path: Path) -> List[Dict[str, str]]:
    """The records of a CSV artifact, D6 or D1/D2 (the stdlib
    counterpart of the JAX package's ``read_results_frame``): one dict a
    row, column name -> the field's text ("" for an empty field; short
    rows padded)."""
    header, rows = _parse_csv(resolve_results_path(path))
    return [dict(zip(header, row + [""] * (len(header) - len(row))))
            for row in rows]


def read_results_frame(path: Path):
    """A results artifact as the JAX package's ``read_results_frame``
    reads it (``pandas.read_csv``; an ``.xlsx`` path is read from its
    ``.csv``), as a pandas-free :class:`~lir_tpu_torch.data.table.Table`
    with pandas' column types."""
    from .table import read_table

    return read_table(resolve_results_path(path))


# ---------------------------------------------------------------------------
# D5: perturbations.json cache
# ---------------------------------------------------------------------------

PerturbationEntry = Tuple[Tuple[str, str, Tuple[str, str], str], List[str]]


def save_perturbations(path: Path,
                       entries: Sequence[PerturbationEntry]) -> None:
    """Cache format parity with perturb_prompts.py:851-866."""
    payload = [
        {
            "original_main": parts[0],
            "response_format": parts[1],
            "target_tokens": list(parts[2]),
            "confidence_format": parts[3],
            "rephrasings": rephrasings,
        }
        for parts, rephrasings in entries
    ]
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(payload, ensure_ascii=False, indent=2))


def load_perturbations(path: Path) -> List[PerturbationEntry]:
    data = json.loads(Path(path).read_text())
    return [
        (
            (
                item["original_main"],
                item["response_format"],
                tuple(item["target_tokens"]),
                item["confidence_format"],
            ),
            list(item["rephrasings"]),
        )
        for item in data
    ]


def validate_perturbation_cache(entries: Sequence[PerturbationEntry],
                                prompts) -> bool:
    """Cache-consistency rule (perturb_prompts.py:757-772): entry count and
    every prompt tuple must match the in-code prompt list, else regenerate."""
    if len(entries) != len(prompts):
        return False
    for (loaded_parts, _), p in zip(entries, prompts):
        expected = (p.main, p.response_format, tuple(p.target_tokens),
                    p.confidence_format)
        if tuple(loaded_parts) != expected:
            return False
    return True
