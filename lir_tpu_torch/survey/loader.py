"""Survey loading, cleaning, exclusion, and question matching (L2/L3 glue).

Port of ``lir_tpu/survey/loader.py`` on the pandas-free
:class:`~lir_tpu_torch.data.table.Table`. Parity targets in the reference:
  - load_and_clean_survey_data   survey_analysis/survey_analysis_consolidated.py:9-29
  - apply_exclusion_criteria     survey_analysis/survey_analysis_consolidated.py:36-85
  - extract_question_text        survey_analysis/survey_analysis_consolidated.py:87-103
  - match_survey_to_llm_questions survey_analysis/survey_analysis_consolidated.py:105-126

Where pandas decides a result, this copies pandas: ``read_csv`` types
every column of the export as text (its two descriptive header rows are
text), the rows after them are numeric-coerced as ``to_numeric(errors=
"coerce")`` does; the median skips NaN; a NaN duration is neither below
nor at/above the threshold, so its row is dropped without being counted;
"all identical" is one distinct answered value (``nunique(axis=1)``)
with more than one answer; D7's std is numpy's population std.

The three exclusion criteria apply in the reference's order (duration
-> identical -> attention), each on the survivors of the previous.

This module also owns the D7 artifact ``survey_analysis_detailed.json``:
four survey scripts consume it but its producer is missing from the
reference tree (SURVEY.md §2.4 D7), so ``survey_detailed`` is the
in-tree replacement producer.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from ..data.prompts import QUALTRICS_TO_QUESTION
from ..data.table import Table, is_missing, read_table, to_numeric

# 5 groups x 11 sliders; column 8 is the attention check ("set slider to 100").
GROUPS = tuple(range(1, 6))
DURATION = "Duration (in seconds)"


def group_question_ids(group: int) -> List[str]:
    """Substantive question columns of one survey group (attention Q*_8
    excluded) — the group structure shared by every survey script
    (e.g. bootstrap_confidence_intervals.py:46-52)."""
    return [f"Q{group}_{i}" for i in range(1, 12) if i != 8]


def all_question_cols(df: Table) -> List[str]:
    """Every Q{g}_{i} column present, attention checks included — the
    ``question_cols`` list of the reference loader."""
    return [f"Q{g}_{q}" for g in GROUPS for q in range(1, 12)
            if f"Q{g}_{q}" in df]


def numeric_matrix(df: Table, cols: List[str]) -> np.ndarray:
    """(rows, len(cols)) float64 of numeric columns."""
    if not cols:
        return np.zeros((len(df), 0))
    return np.stack([np.asarray(df[c], dtype=float) for c in cols], axis=1)


def load_survey(path: Path) -> Tuple[Table, List[str]]:
    """Load the Qualtrics export, drop its two descriptive header rows, and
    numeric-coerce Duration plus every slider column."""
    df = read_table(Path(path))
    df = df.take(np.arange(2, max(len(df), 2)))
    df = df.assign(DURATION, to_numeric(df[DURATION]))
    question_cols = all_question_cols(df)
    for col in question_cols:
        df = df.assign(col, to_numeric(df[col]))
    return df, question_cols


def apply_exclusions(
    df: Table, question_cols: List[str]
) -> Tuple[Table, Dict[str, float]]:
    """Three exclusion criteria, applied in the reference's order.

    1. Duration < 20% of the (pre-filter) median completion time.
    2. All substantive sliders identical (attention Q*_8 not counted),
       among respondents who answered more than one substantive question.
    3. Any answered attention check != 100.
    """
    initial_count = len(df)
    stats: Dict[str, float] = {}

    duration = np.asarray(df[DURATION], dtype=float)
    finite = duration[~np.isnan(duration)]
    median_duration = float(np.median(finite)) if finite.size else float("nan")
    min_duration = 0.2 * median_duration
    with np.errstate(invalid="ignore"):
        stats["duration_excluded"] = int((duration < min_duration).sum())
        keep = duration >= min_duration
    stats["median_duration"] = float(median_duration)
    stats["min_duration_threshold"] = float(min_duration)
    df = df.take(keep)

    substantive = [c for c in question_cols if not c.endswith("_8")]
    vals = numeric_matrix(df, substantive)
    answered = (~np.isnan(vals)).sum(axis=1)
    # "All identical": nunique over answered sliders == 1, with > 1 answered.
    distinct = np.array([np.unique(row[~np.isnan(row)]).size for row in vals],
                        dtype=np.int64)
    identical = (distinct == 1) & (answered > 1)
    stats["identical_excluded"] = int(identical.sum())
    df = df.take(~identical)

    attention_cols = [f"Q{g}_8" for g in GROUPS if f"Q{g}_8" in df]
    att = numeric_matrix(df, attention_cols)
    failed = (~np.isnan(att) & (att != 100)).any(axis=1)
    stats["attention_failed"] = int(failed.sum())
    df = df.take(~failed)

    stats["final_count"] = len(df)
    stats["total_excluded"] = initial_count - len(df)
    return df, stats


def extract_question_text(raw_path: Path) -> Dict[str, str]:
    """Column id -> question text, parsed from the Qualtrics header row
    (the text after the last " - " separator)."""
    df_raw = read_table(Path(raw_path))
    mapping: Dict[str, str] = {}
    if not len(df_raw):
        return mapping
    for col in df_raw.columns:
        if col.startswith("Q") and "_" in col:
            text = df_raw[col][0]
            if (not is_missing(text) and isinstance(text, str)
                    and " - " in text):
                mapping[col] = text.split(" - ")[-1].strip()
    return mapping


def match_survey_to_llm_questions(
    llm_df: Table, question_mapping: Dict[str, str]
) -> Dict[str, str]:
    """LLM prompt text -> Qualtrics question id, for prompts whose text
    matches a survey question exactly (attention checks excluded)."""
    prompt_to_question = {
        text: qid
        for qid, text in question_mapping.items()
        if not qid.endswith("_8")
    }
    return {
        prompt: prompt_to_question[prompt]
        for prompt in llm_df.unique("prompt")
        if isinstance(prompt, str) and prompt in prompt_to_question
    }


def canonical_question_mapping() -> Dict[str, str]:
    """The static 50-question -> Qualtrics-id mapping (the dict copy-pasted
    across four reference survey scripts, e.g.
    analyze_llm_human_agreement.py:31-82) from the single prompt asset."""
    return {q: qid for qid, q in QUALTRICS_TO_QUESTION.items()}


def survey_detailed(
    clean_df: Table, question_cols: List[str]
) -> Dict[str, object]:
    """Produce the D7 ``survey_analysis_detailed.json`` payload.

    Schema (as consumed at analyze_llm_human_agreement.py:86-89 and
    bootstrap_confidence_intervals.py:82-89):
    ``results.by_question[Qx_y] = {mean_response, std_response,
    proportion_yes, n_responses}`` with mean/std on the 0-100 slider scale.
    ``proportion_yes`` is the fraction of respondents above the slider
    midpoint (> 50); the upstream producer is absent from the reference
    tree, so this definition is the JAX package's, documented there.
    """
    by_question: Dict[str, Dict[str, float]] = {}
    for col in question_cols:
        if col.endswith("_8"):
            continue
        responses = np.asarray(clean_df[col], dtype=float)
        responses = responses[~np.isnan(responses)]
        if responses.size == 0:
            continue
        by_question[col] = {
            "mean_response": float(np.mean(responses)),
            "std_response": float(np.std(responses)),
            "proportion_yes": float(np.mean(responses > 50.0)),
            "n_responses": int(responses.size),
        }
    return {"results": {"by_question": by_question}}


def write_survey_detailed(
    clean_df: Table, question_cols: List[str], path: Path
) -> Dict[str, object]:
    payload = survey_detailed(clean_df, question_cols)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(payload, indent=2))
    return payload


def load_survey_detailed(path: Path) -> Dict[str, object]:
    return json.loads(Path(path).read_text())
