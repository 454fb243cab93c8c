"""LaTeX artifact generators for the perturbation analysis.

A copy of ``lir_tpu/report/latex.py`` on the port's pandas-free
:class:`~lir_tpu_torch.data.table.Table`. The text is the JAX package's,
character for character: the representative-rephrasing tables take one
row from each of 20 percentile chunks, drawn from the same
``np.random.Generator`` in the same order, over the same sort (numpy's
default quicksort, as ``DataFrame.sort_values``); rows are formatted with
the types ``DataFrame.iterrows`` gives them (an all-numeric table's
integers as floats).

Parity targets in the reference:
  - create_latex_table                analysis/analyze_perturbation_results.py:722-864
  - create_standalone_latex_document  :866-909
  - create_compliance_latex_table     :1453-1499
  - create_confidence_compliance_latex_table :1677-1716
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..data.table import Table, is_missing

PROMPT_DESCRIPTIONS = (
    "Insurance Policy Water Damage Exclusion",
    "Prenuptial Agreement Petition Filing Date",
    "Contract Term Affiliate Interpretation",
    "Construction Payment Terms Interpretation",
    "Insurance Policy Burglary Coverage",
)


def _escape(text) -> str:
    return (
        str(text).replace("_", "\\_").replace("%", "\\%").replace("&", "\\&")
    )


def _stratified_rows(order: np.ndarray, rng: np.random.Generator,
                     num_chunks: int = 20) -> np.ndarray:
    """Of the row positions ``order`` (sorted by the value), one random
    position from each of ``num_chunks`` percentile chunks (:777-795)."""
    n = len(order)
    chunk_size = n // num_chunks
    if chunk_size == 0:
        return order
    picks = []
    for i in range(num_chunks):
        start = i * chunk_size
        end = (i + 1) * chunk_size if i < num_chunks - 1 else n
        if start < end:
            picks.append(order[int(rng.integers(start, end))])
    return np.array(picks, dtype=np.int64)


def _iterrows(table: Table) -> Iterator[Dict[str, object]]:
    """Rows as ``DataFrame.iterrows`` gives them: in a table whose columns
    are all integers or floats, every value a float."""
    kinds = {table[c].dtype.kind for c in table.columns}
    as_float = kinds <= {"i", "f"} and "f" in kinds
    for row in table.records():
        yield ({k: np.float64(v) for k, v in row.items()} if as_float
               else row)


def _representative_lines(data: Table, rows: np.ndarray, column: str,
                          text_column: str, fmt: str,
                          rng: np.random.Generator) -> List[str]:
    """One line a stratified row of ``data.take(rows)`` sorted by
    ``column``: its text, value and percentile."""
    vals = data[column][rows]
    order = rows[np.argsort(vals, kind="quicksort")]
    sorted_vals = data[column][order]
    lines = []
    for r in _stratified_rows(order, rng):
        value = float(data[column][r])
        percentile = 100 * float(np.mean(sorted_vals <= value))
        lines.append(f"{_escape(data[text_column][r])} & {value:{fmt}} & "
                     f"{percentile:.1f}\\% \\\\")
    return lines


def perturbation_latex_table(
    data: Table,
    prompt_idx: int,
    prompt_main: str,
    token_options: Sequence[str],
    rng: Optional[np.random.Generator] = None,
) -> str:
    """Longtable of 20 representative rephrasings with relative probability
    and percentile; confidence table appended when data exists (:722-864)."""
    rng = rng or np.random.default_rng(42)
    first_token, second_token = token_options[0], token_options[1]
    description = (
        PROMPT_DESCRIPTIONS[prompt_idx]
        if prompt_idx < len(PROMPT_DESCRIPTIONS)
        else f"Prompt {prompt_idx + 1}"
    )
    has_confidence = (
        "Weighted Confidence" in data
        and not np.isnan(data["Weighted Confidence"].astype(float)).all()
    )

    out: List[str] = [
        f"\\subsection*{{Prompt {prompt_idx + 1}: {description}}}",
        "",
        f"\\textbf{{Original Prompt:}} {prompt_main}",
        "",
        "\\subsubsection*{Next-Token Distribution Table}",
        "",
        "\\begin{longtable}{p{0.65\\textwidth}cc}",
        f"\\caption{{Representative Relative Probabilities for {description}: "
        f'"{first_token}" vs "{second_token}" (Prompt {prompt_idx + 1})}} \\\\',
        "\\hline",
        "Prompt Variation & \\makecell{Relative\\\\Probability} & Percentile \\\\",
        "\\hline",
        "\\endhead",
        "\\hline",
        "\\endfoot",
    ]

    finite = np.flatnonzero(np.isfinite(data["Relative_Prob"]))
    if len(finite) == 0:
        out += [
            "No valid data available for this prompt. & - & - \\\\",
            "\\end{longtable}",
            "",
        ]
        return "\n".join(out)

    out += _representative_lines(data, finite, "Relative_Prob",
                                 "Full Rephrased Prompt", ".3f", rng)
    out += ["\\end{longtable}", ""]

    if has_confidence:
        out += [
            "\\subsubsection*{Confidence Estimates Table}",
            "",
            "\\begin{longtable}{p{0.65\\textwidth}cc}",
            f"\\caption{{Representative Weighted Confidence for {description}: "
            f'"{first_token}" (Prompt {prompt_idx + 1})}} \\\\',
            "\\hline",
            "Prompt Variation & \\makecell{Weighted\\\\Confidence} & Percentile \\\\",
            "\\hline",
            "\\endhead",
            "\\hline",
            "\\endfoot",
        ]
        present = np.flatnonzero(~np.isnan(
            data["Weighted Confidence"].astype(float)))
        if len(present) > 0:
            out += _representative_lines(data, present, "Weighted Confidence",
                                         "Full Confidence Prompt", ".1f", rng)
        else:
            out.append("No confidence data available for this prompt. & - & - \\\\")
        out += ["\\end{longtable}", ""]
    return "\n".join(out)


STANDALONE_PREAMBLE = r"""\documentclass[12pt]{article}
\usepackage{amsfonts}
\usepackage[utf8]{inputenc}
\usepackage{hyperref}
\usepackage[margin=1.25in]{geometry}
\usepackage{natbib}
\usepackage{longtable}
\usepackage{subcaption}
\usepackage{graphicx}
\usepackage{makecell}
\usepackage{float}
\usepackage{amsmath}
\usepackage{setspace}
\usepackage{comment}
\usepackage[font=normal,labelfont=bf,skip=6pt]{caption}

\setlength{\parskip}{0.5em}

\title{Prompt Perturbation Analysis Appendix}
\author{}
\date{\today}

\begin{document}
\maketitle

\section*{Prompt Perturbation Analysis}

This appendix presents the detailed results of the prompt perturbation
analysis. For each legal interpretation prompt, the original prompt is shown
in plain text followed by a table of 20 representative prompt variations
selected from different percentile ranges of the distribution, with each
rephrasing's relative probability and its percentile rank.

"""


def standalone_latex_document(tables: Sequence[str]) -> str:
    """Complete compilable document wrapping the per-prompt tables
    (:866-909)."""
    return STANDALONE_PREAMBLE + "\n".join(tables) + "\n\\end{document}"


def compliance_latex_table(compliance: Table) -> str:
    """Output-instruction compliance summary table (:1453-1499)."""
    lines = [
        "\\begin{table}[h]",
        "\\centering",
        "\\caption{Output Instruction Compliance Analysis}",
        "\\begin{tabular}{lccc}",
        "\\hline",
        "Prompt & \\makecell{First Token\\\\Non-Compliance (\\%)} & "
        "\\makecell{Conditional Subsequent\\\\Non-Compliance (\\%)} & "
        "\\makecell{Total\\\\Samples} \\\\",
        "\\hline",
    ]
    for row in _iterrows(compliance):
        sub = row.get("Conditional_Subsequent_Non_Compliance_Rate")
        sub_str = f"{sub:.3f}" if not is_missing(sub) else "N/A"
        lines.append(
            f"{row['Prompt']} & {row['First_Token_Non_Compliance_Rate']:.3f} & "
            f"{sub_str} & {row['Total_Samples']} \\\\"
        )
    lines.append("\\hline")

    overall_first = (
        np.sum(compliance["First_Token_Non_Compliant"])
        / np.sum(compliance["Total_Samples"])
        * 100
    )
    total_all = np.sum(compliance["Total_Samples"])
    sub_col = "Conditional_Subsequent_Non_Compliance_Rate"
    overall_sub_str = "N/A"
    if sub_col in compliance:
        valid = compliance.take(~np.isnan(compliance[sub_col].astype(float)))
        if len(valid) > 0 and np.sum(valid["First_Token_Compliant"]) > 0:
            w = valid["First_Token_Compliant"]
            overall_sub = np.sum(w * valid[sub_col]) / np.sum(w)
            overall_sub_str = f"\\textbf{{{overall_sub:.3f}}}"
    lines += [
        f"\\textbf{{Overall}} & \\textbf{{{overall_first:.3f}}} & "
        f"{overall_sub_str} & \\textbf{{{total_all}}} \\\\",
        "\\hline",
        "\\end{tabular}",
        "\\end{table}",
    ]
    return "\n".join(lines)


def confidence_compliance_latex_table(confidence: Table) -> str:
    """Integer-confidence compliance summary table (:1677-1716)."""
    lines = [
        "\\begin{table}[h]",
        "\\centering",
        "\\caption{Confidence Output Compliance Analysis (Integer Requirement)}",
        "\\begin{tabular}{lcccccc}",
        "\\hline",
        "Prompt & \\makecell{Non-Compliance\\\\Rate (\\%)} & "
        "\\makecell{Total\\\\Samples} & \\makecell{Float\\\\Errors} & "
        "\\makecell{Text\\\\Errors} & \\makecell{Out of\\\\Range} & "
        "\\makecell{Other\\\\Errors} \\\\",
        "\\hline",
    ]
    for row in _iterrows(confidence):
        lines.append(
            f"{row['Prompt']} & {row['Confidence_Non_Compliance_Rate']:.3f} & "
            f"{row['Total_Confidence_Samples']} & {row['Float_Errors']} & "
            f"{row['Text_Errors']} & {row['Out_Of_Range_Errors']} & "
            f"{row['Other_Errors']} \\\\"
        )
    lines.append("\\hline")
    overall = (
        np.sum(confidence["Confidence_Non_Compliant"])
        / np.sum(confidence["Total_Confidence_Samples"])
        * 100
    )
    total = {c: np.sum(confidence[c]) for c in (
        "Total_Confidence_Samples", "Float_Errors", "Text_Errors",
        "Out_Of_Range_Errors", "Other_Errors")}
    lines += [
        f"\\textbf{{Overall}} & \\textbf{{{overall:.3f}}} & "
        f"\\textbf{{{total['Total_Confidence_Samples']}}} & "
        f"\\textbf{{{total['Float_Errors']}}} & "
        f"\\textbf{{{total['Text_Errors']}}} & "
        f"\\textbf{{{total['Out_Of_Range_Errors']}}} & "
        f"\\textbf{{{total['Other_Errors']}}} \\\\",
        "\\hline",
        "\\end{tabular}",
        "\\end{table}",
    ]
    return "\n".join(lines)
