"""Deterministic synthetic D6 fixture for differential-parity testing.

A copy of ``lir_tpu/data/synthetic.py`` without pandas: the same records
from the same seeds (``np.random.default_rng(20260730)`` for the scorer
model, ``20260731`` for the edge model) in the same draw order, so the
port's analyses can be held against the JAX package's and against the
executed reference's outputs on this fixture
(``tests/golden/reference_executed.json``, section
``analyze_perturbation_results``).

The rows use the five real legal prompts with per-prompt yes-lean levels
spanning the kappa interpretation bands. A second model,
``synthetic-edge-v1``, hits every edge branch of the analyzer:
zero/one-inflated relative probabilities, non-finite rows, non-compliant
first tokens and full responses, unparseable and Python-literal log
probabilities, and every confidence non-compliance category.

The survey fixture (no JAX counterpart: the tests give the same files to
both packages) is a seeded Qualtrics export of the word-meaning survey
(:func:`write_synthetic_survey`) with a D1/D2 pair scored around the same
per-question leans (:func:`write_synthetic_comparison`); each holds the
cases that decide the survey pipeline's counts (:data:`SURVEY_CASES`,
:func:`synthetic_comparison_rows`).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from .prompts import LEGAL_PROMPTS, QUALTRICS_TO_QUESTION
from .schemas import (PERTURBATION_COLUMNS, ScoreRow, _cell, _write_csv,
                      resolve_results_path, write_instruct_comparison_csv,
                      write_model_comparison_csv)
from .table import Table, write_csv

SYNTH_SEED = 20260730
N_REPHRASINGS = 200          # per prompt (reference scale ~2000; 200 keeps
                             # the fixture fast while self-kappa stays stable)
SYNTH_MODEL = "synthetic-scorer-v1"

# Edge-case model: a second model whose rows hit every hairy
# branch of the reference analyzer (analyze_perturbation_results.py) —
# zero/one-inflated Relative_Prob (exact 0/1 mass for the truncated-normal
# MC fit's inflation accounting, :150-156), non-finite rows (Token probs
# both 0), non-compliant first tokens and full responses (:1330-1372),
# unparseable / ast-literal Log Probabilities (:1301-1322), and every
# confidence non-compliance category (float / text / out-of-range / other,
# :1564-1600).
SYNTH_EDGE_MODEL = "synthetic-edge-v1"
N_EDGE_ROWS = 60             # per prompt (>= 100/model so the analyzer's
                             # small-data guard does not trip, :1724)

# Per-prompt P(token_1 wins): spans near-coin-flip to near-unanimous.
_YES_LEAN = (0.55, 0.72, 0.38, 0.9, 0.65)

# Canonical full responses per prompt (the reference's expected_tokens
# table, analyze_perturbation_results.py:1206-1246), pre-split into OpenAI
# content-style token pieces so compliant rows re-join exactly.
_FULL_RESPONSE_TOKENS = (
    {"Covered": ("Covered",), "Not": ("Not", " Covered")},
    {"Ultimate": ("Ultimate", " Petition"), "First": ("First", " Petition")},
    {"Existing": ("Existing", " Affiliates"),
     "Future": ("Future", " Affiliates")},
    {"Monthly": ("Monthly", " Installment", " Payments"),
     "Payment": ("Payment", " Upon", " Completion")},
    {"Covered": ("Covered",), "Not": ("Not", " Covered")},
)


def _content_logprobs(tokens, logprob: float) -> str:
    """OpenAI chat-completions style 'Log Probabilities' payload — the ONLY
    format the reference compliance checker parses (:1313-1326)."""
    return json.dumps(
        {"content": [{"token": t, "logprob": logprob} for t in tokens]})


def synthetic_records() -> List[dict]:
    """The deterministic D6 rows, one dict a row in D6 column order: the
    scorer model's 5 x 200 rows, then the edge model's 5 x 60."""
    rng = np.random.default_rng(SYNTH_SEED)
    records: List[dict] = []
    for pi, (prompt, lean) in enumerate(zip(LEGAL_PROMPTS, _YES_LEAN)):
        for i in range(N_REPHRASINGS):
            # Relative prob drawn around the lean with clipping to (0, 1).
            rel = float(np.clip(rng.normal(lean, 0.18), 1e-3, 1 - 1e-3))
            total = float(rng.uniform(0.7, 0.99))
            t1, t2 = rel * total, (1 - rel) * total
            conf = float(np.clip(rng.normal(70, 15), 0, 100))
            target = (prompt.target_tokens[0] if rel > 0.5
                      else prompt.target_tokens[1])
            pieces = _FULL_RESPONSE_TOKENS[pi][target]
            records.append({
                "Model": SYNTH_MODEL,
                "Original Main Part": prompt.main,
                "Response Format": prompt.response_format,
                "Confidence Format": prompt.confidence_format,
                "Rephrased Main Part": f"[rephrasing {i}] {prompt.main}",
                "Full Rephrased Prompt": prompt.rephrased_binary(
                    f"[rephrasing {i}] {prompt.main}"),
                "Full Confidence Prompt": prompt.rephrased_confidence(
                    f"[rephrasing {i}] {prompt.main}"),
                "Model Response": target,
                "Model Confidence Response": str(int(round(conf))),
                "Log Probabilities": _content_logprobs(
                    pieces, float(np.log(max(t1, t2)))),
                "Token_1_Prob": t1,
                "Token_2_Prob": t2,
                "Odds_Ratio": t1 / t2,
                "Confidence Value": float(int(round(conf))),
                "Weighted Confidence": conf,
            })
    records.extend(_edge_model_records())
    return records


def synthetic_perturbation_frame() -> Table:
    """The D6 fixture as the table ``pd.DataFrame(records, columns=D6)``
    makes of it."""
    return Table.from_records(synthetic_records(), PERTURBATION_COLUMNS)


def _edge_model_records() -> List[dict]:
    """synthetic-edge-v1 rows: every analyzer edge branch, deterministic."""
    rng = np.random.default_rng(SYNTH_SEED + 1)
    records: List[dict] = []
    for pi, prompt in enumerate(LEGAL_PROMPTS):
        fulls = _FULL_RESPONSE_TOKENS[pi]
        tok1, tok2 = prompt.target_tokens
        for i in range(N_EDGE_ROWS):
            kind = i % 10
            # Interior draw with HARD clipping to [0, 1]: the clip mass
            # lands exactly on the bounds -> natural zero/one inflation on
            # top of the explicit inflated rows below.
            rel = float(np.clip(rng.normal(0.5, 0.3), 0.0, 1.0))
            total = float(rng.uniform(0.6, 0.95))
            wconf = float(np.clip(rng.normal(55.0, 30.0), 0.0, 100.0))
            target = tok1 if rel > 0.5 else tok2
            compliant_lp = _content_logprobs(fulls[target], -0.3)
            conf: object = str(int(round(wconf)))
            conf_val: float = float(int(round(wconf)))
            lp = compliant_lp
            if kind == 0:          # zero-inflated: P(token_1) exactly 0
                rel, target = 0.0, tok2
                lp = _content_logprobs(fulls[tok2], -0.2)
                conf, conf_val, wconf = "0", 0.0, 0.0
            elif kind == 1:        # one-inflated: P(token_2) exactly 0
                rel, target = 1.0, tok1
                lp = _content_logprobs(fulls[tok1], -0.1)
                conf, conf_val, wconf = "100", 100.0, 100.0
            elif kind == 2:        # non-finite: both token probs zero
                rel, total = float("nan"), 0.0
                conf, conf_val, wconf = None, float("nan"), float("nan")
            elif kind == 3:        # non-compliant FIRST token + float conf
                lp = _content_logprobs(("I", " think", " " + target), -1.0)
                conf, conf_val = "85.5", float("nan")
            elif kind == 4:        # compliant first, non-compliant full +
                lp = _content_logprobs((target, " maybe"), -0.8)
                conf, conf_val = "150", float("nan")   # out-of-range conf
            elif kind == 5:        # unparseable payload (no 'content') +
                lp = json.dumps({tok1: -0.5, tok2: -1.5})
                conf, conf_val = "high", float("nan")  # text conf
            elif kind == 6:        # python-literal payload (ast branch) +
                lp = str({"content": [{"token": t, "logprob": -0.4}
                                      for t in fulls[target]]})
                conf, conf_val = "?", float("nan")     # 'other' conf
            t1 = rel * total if np.isfinite(rel) else 0.0
            t2 = (1.0 - rel) * total if np.isfinite(rel) else 0.0
            odds = (float("inf") if t2 == 0.0 and t1 > 0.0
                    else (t1 / t2 if t2 > 0.0 else float("nan")))
            records.append({
                "Model": SYNTH_EDGE_MODEL,
                "Original Main Part": prompt.main,
                "Response Format": prompt.response_format,
                "Confidence Format": prompt.confidence_format,
                "Rephrased Main Part": f"[edge {i}] {prompt.main}",
                "Full Rephrased Prompt": prompt.rephrased_binary(
                    f"[edge {i}] {prompt.main}"),
                "Full Confidence Prompt": prompt.rephrased_confidence(
                    f"[edge {i}] {prompt.main}"),
                "Model Response": target,
                "Model Confidence Response": conf,
                "Log Probabilities": lp,
                "Token_1_Prob": t1,
                "Token_2_Prob": t2,
                "Odds_Ratio": odds,
                "Confidence Value": conf_val,
                "Weighted Confidence": wconf,
            })
    return records


def write_synthetic_d6(path: Path) -> Path:
    """Write the fixture as CSV with the port's D6 writer (an ``.xlsx``
    path becomes its ``.csv``); returns the path written."""
    path = resolve_results_path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    _write_csv(path, [[_cell(r[c]) for c in PERTURBATION_COLUMNS]
                      for r in synthetic_records()])
    return path


# ---------------------------------------------------------------------------
# The human survey (D3) and a D1/D2 pair to go with it
# ---------------------------------------------------------------------------

SURVEY_SEED = 20261019
SURVEY_BLOCK = "How well does the second word describe the first"
ATTENTION_TEXT = "Please move this slider to 100"
# Qualtrics' own columns before the sliders, with their header texts and
# ImportId cells (the first has a comma and quotes: it needs quoting).
_SURVEY_META = (
    ("StartDate", "Start Date",
     '{"ImportId":"startDate","timeZone":"America/Denver"}'),
    ("Duration (in seconds)", "Duration (in seconds)",
     '{"ImportId":"duration"}'),
    ("Finished", "Finished", '{"ImportId":"finished"}'),
    ("ResponseId", "Response ID", '{"ImportId":"_recordId"}'),
)
# Respondents whose rows decide a count of the loader's exclusions, by
# row; every other respondent passes all three.
SURVEY_CASES = {
    0: "short_duration",            # under 20 % of the median: excluded
    1: "missing_duration",          # empty: dropped, in no count
    2: "non_numeric_duration",      # coerced to NaN: dropped, in no count
    3: "identical_sliders",         # ten equal answers: excluded
    4: "one_answer",                # one answer only: not identical
    5: "attention_failed",          # attention slider 80: excluded
    6: "attention_unanswered",      # attention left empty: kept
    7: "non_numeric_slider",        # "fifty" coerced to NaN: kept
    8: "identical_and_attention",   # counted as identical (applied first)
    9: "short_and_attention",       # counted as short (applied first)
}


def question_leans(seed: int = SURVEY_SEED) -> Dict[str, float]:
    """The synthetic population's mean answer (0-1) to each of the 50
    word-meaning questions, keyed by question text: what both the survey
    and the models' probabilities are drawn around."""
    rng = np.random.default_rng(seed)
    leans = rng.uniform(0.1, 0.9, len(QUALTRICS_TO_QUESTION))
    return {q: float(v) for q, v in zip(QUALTRICS_TO_QUESTION.values(),
                                       leans)}


def synthetic_survey(seed: int = SURVEY_SEED, n_respondents: int = 507
                     ) -> Tuple[List[str], List[List[str]]]:
    """(header, rows) of a Qualtrics export as ``survey.loader.load_survey``
    reads it: the column ids; row 0 the header texts, each slider's
    ``"<block> - <question>"``; row 1 the ImportIds; then one row a
    respondent, who answers one group's eleven sliders (``Q{g}_8`` is the
    attention check, to be set to 100), the groups in turn (Qualtrics'
    evenly presented randomizer). The rows of :data:`SURVEY_CASES` hold
    the cases that decide the exclusion counts; every twelfth respondent
    leaves the group's last slider empty."""
    rng = np.random.default_rng(seed + 1)
    leans = question_leans(seed)
    qcols = [f"Q{g}_{i}" for g in range(1, 6) for i in range(1, 12)]
    header = [c for c, _, _ in _SURVEY_META] + qcols
    texts = [t for _, t, _ in _SURVEY_META] + [
        f"{SURVEY_BLOCK} - "
        + (ATTENTION_TEXT if c.endswith("_8") else QUALTRICS_TO_QUESTION[c])
        for c in qcols]
    imports = [i for _, _, i in _SURVEY_META] + [
        '{"ImportId":"QID%s"}' % c[1:] for c in qcols]
    rows = [texts, imports]
    for r in range(n_respondents):
        group = r % 5 + 1
        duration = int(round(float(rng.lognormal(np.log(420.0), 0.45))))
        cells = {}
        for i in range(1, 12):
            col = f"Q{group}_{i}"
            if i == 8:
                cells[col] = "100"
                continue
            mean = 100.0 * leans[QUALTRICS_TO_QUESTION[col]]
            value = int(np.clip(round(float(rng.normal(mean, 22.0))), 0, 100))
            cells[col] = "" if i == 11 and r % 12 == 11 else str(value)
        case = SURVEY_CASES.get(r)
        substantive = [f"Q{group}_{i}" for i in range(1, 12) if i != 8]
        if case in ("short_duration", "short_and_attention"):
            duration = 10
        if case in ("identical_sliders", "identical_and_attention"):
            cells.update({c: "50" for c in substantive})
        if case in ("attention_failed", "identical_and_attention",
                    "short_and_attention"):
            cells[f"Q{group}_8"] = "80"
        if case == "attention_unanswered":
            cells[f"Q{group}_8"] = ""
        if case == "one_answer":
            cells.update({c: "" for c in substantive[1:]})
            cells[substantive[0]] = "64"
        if case == "non_numeric_slider":
            cells[substantive[2]] = "fifty"
        dur_cell = {"missing_duration": "",
                    "non_numeric_duration": "unknown"}.get(case,
                                                          str(duration))
        rows.append([f"2024-03-{1 + r % 28:02d} 10:{r % 60:02d}:00",
                     dur_cell, "True", f"R_{seed % 100000:05d}{r:05d}"]
                    + [cells.get(c, "") for c in qcols])
    return header, rows


def write_synthetic_survey(path: Path, seed: int = SURVEY_SEED,
                           n_respondents: int = 507) -> Path:
    """Write :func:`synthetic_survey` as CSV (minimal quoting); returns
    the path written."""
    header, rows = synthetic_survey(seed, n_respondents)
    write_csv(Path(path), header, rows)
    return Path(path)


# D1 holds every model of the survey's family lists (base and instruct),
# D2 the instruct ones and two more; both hold a model whose checkpoint
# failed to load (its rows NaN, as a model-comparison sweep writes them).
SURVEY_FAMILY_MODELS = (
    ("tiiuae/falcon-7b", "tiiuae/falcon-7b-instruct"),
    ("stabilityai/stablelm-base-alpha-7b",
     "stabilityai/stablelm-tuned-alpha-7b"),
    ("togethercomputer/RedPajama-INCITE-7B-Base",
     "togethercomputer/RedPajama-INCITE-7B-Instruct"),
    ("google/t5-v1_1-base", "google/flan-t5-base"),
    ("bigscience/bloom-7b1", "bigscience/bloomz-7b1"),
    ("EleutherAI/pythia-6.9b", "databricks/dolly-v2-7b"),
)
SURVEY_EXTRA_INSTRUCT = ("mosaicml/mpt-7b-instruct", "lmsys/vicuna-7b-v1.5")
SURVEY_ERROR_MODEL = "absent/model"
UNMATCHED_PROMPT = 'Is a "hot dog" a "sandwich", in ordinary usage?'


def synthetic_comparison_rows(seed: int = SURVEY_SEED,
                              error_model: bool = True,
                              families=SURVEY_FAMILY_MODELS):
    """(D1 rows, D2 rows) as ``ScoreRow``s, probabilities drawn around
    :func:`question_leans`: the D1 holds each (base, instruct) pair of
    ``families``, the D2 their instruct models and
    :data:`SURVEY_EXTRA_INSTRUCT`.
    The cases they hold: EleutherAI/pythia-6.9b
    lacks three questions of group 2 (under the simulated bootstrap's
    eight-matched gate there); tiiuae/falcon-7b has one zero-mass row
    (relative probability 0.5 for the agreement metrics, NaN for the
    simulated bootstrap); the D2 has a prompt that matches no survey
    question (mosaicml/mpt-7b-instruct) and a row whose relative
    probability is NaN (zero mass, lmsys/vicuna-7b-v1.5);
    with ``error_model``, both have the NaN rows of a model that failed
    to load."""
    rng = np.random.default_rng(seed + 2)
    leans = question_leans(seed)
    questions = list(leans)
    skipped = {QUALTRICS_TO_QUESTION[f"Q2_{i}"] for i in (1, 2, 3)}

    def scored(model, kind, lean_of, prompts):
        out = []
        for q in prompts:
            rel = float(np.clip(lean_of(q) + rng.normal(0.0, 0.18),
                                0.01, 0.99))
            total = float(rng.uniform(0.3, 0.95))
            out.append(ScoreRow(q, model, kind, "Yes" if rel > 0.5 else "No",
                                rel * total, (1.0 - rel) * total))
        return out

    def error_rows(kind):
        return [ScoreRow(q, SURVEY_ERROR_MODEL, kind, "ERROR", float("nan"),
                         float("nan"), yes_no_found=False)
                for q in questions] if error_model else []

    d1 = []
    for base, instruct in families:
        for model, kind in ((base, "base"), (instruct, "instruct")):
            prompts = [q for q in questions
                       if not (model == "EleutherAI/pythia-6.9b"
                               and q in skipped)]
            rows = scored(model, kind, leans.get, prompts)
            if model == "tiiuae/falcon-7b":
                r = rows[4]
                rows[4] = ScoreRow(r.prompt, r.model, r.base_or_instruct,
                                   "No", 0.0, 0.0)
            d1 += rows
    d1 += error_rows("instruct")
    d2 = []
    for model in [i for _, i in families] + list(SURVEY_EXTRA_INSTRUCT):
        prompts = questions + ([UNMATCHED_PROMPT]
                               if model == SURVEY_EXTRA_INSTRUCT[0] else [])
        rows = scored(model, "instruct", lambda q: leans.get(q, 0.5),
                      prompts)
        if model == SURVEY_EXTRA_INSTRUCT[1]:
            r = rows[7]
            rows[7] = ScoreRow(r.prompt, r.model, "instruct", "No", 0.0, 0.0)
        d2 += rows
    d2 += error_rows("instruct")
    return d1, d2


def write_synthetic_comparison(d1_path: Path, d2_path: Path,
                               seed: int = SURVEY_SEED,
                               error_model: bool = True,
                               families=SURVEY_FAMILY_MODELS
                               ) -> Tuple[Path, Path]:
    """Write :func:`synthetic_comparison_rows` with the D1 and D2 writers;
    returns the two paths."""
    d1, d2 = synthetic_comparison_rows(seed, error_model, families)
    write_model_comparison_csv(d1, d1_path)
    write_instruct_comparison_csv(d2, d2_path)
    return Path(d1_path), Path(d2_path)
