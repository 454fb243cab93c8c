"""Per-model perturbation-distribution analysis (C20-C27).

Port of ``lir_tpu/analysis/perturbation.py`` on the pandas-free
:class:`~lir_tpu_torch.data.table.Table`, with its statistics on
``device``. Parity target: analysis/analyze_perturbation_results.py — for
each model in the D6 results artifact: relative probabilities, per-prompt
summary stats with 2.5/97.5 percentiles, normality tests (KS +
Anderson-Darling), truncated-normal Monte-Carlo fits, within-prompt
Cohen's kappa, instruction and confidence compliance audits,
QQ/histogram/violin figures, and LaTeX appendix tables. Artifact names
match the reference exactly:

  summary_statistics.csv, normality_test_results.csv,
  truncated_normal_test_results.csv, cohens_kappa_results.csv,
  output_compliance_results.csv, confidence_compliance_results.csv,
  prompt_perturbation_tables.tex, prompt_perturbation_standalone.tex,
  compliance_summary.tex, confidence_compliance_summary.tex, figures/*.png

Random draws: each truncated-normal fit and each QQ band draws from its
own CPU generator, ``generator_for(seed, 1, model_idx, prompt_idx,
column, statistic)`` (column 0 Relative_Prob, 1 Weighted Confidence;
statistic 0 the fit, 1 the QQ band), where the JAX package splits one
``jax.random`` key in turn. The LaTeX strata and the combined violins'
jitter draw from ``np.random.default_rng(42)`` in the JAX package's
order, so the ``.tex`` files are the JAX package's, character for
character.

Compliance checks double as pipeline assertions: call
``assert_compliance`` to gate a sweep on minimum compliance rates instead
of only reporting them.
"""

from __future__ import annotations

import argparse
import ast
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.prompts import LEGAL_PROMPTS, LegalPrompt
from ..data.schemas import read_results_frame
from ..data.table import Table, is_missing, series_std
from ..device import resolve_device
from ..report import figures
from ..report.latex import (
    compliance_latex_table,
    confidence_compliance_latex_table,
    perturbation_latex_table,
    standalone_latex_document,
)
from ..stats.core import generator_for
from ..stats.fits import truncated_normal_mc_fit
from ..stats.kappa import interpret_kappa, within_group_kappa
from ..stats.normality import normality_tests
from ..utils.logging import get_logger

log = get_logger(__name__)

MIN_ROWS_FOR_ANALYSIS = 100  # reference :1724

# The generator words of this module's draws (see the module docstring).
_WORD = 1
COLUMN_WORDS = {"Relative_Prob": 0, "Weighted Confidence": 1}
FIT, QQ = 0, 1


def draw_generator(seed: int, model_idx: int, prompt_idx: int, column: str,
                   statistic: int):
    """The CPU generator of one (model, prompt, column, statistic) draw."""
    return generator_for(seed, _WORD, model_idx, prompt_idx,
                         COLUMN_WORDS[column], statistic)


def add_relative_prob(df: Table) -> Table:
    """Relative_Prob = Token_1/(Token_1+Token_2), NaN on zero mass
    (:1738-1746)."""
    t1 = df["Token_1_Prob"]
    total = t1 + df["Token_2_Prob"]
    with np.errstate(invalid="ignore", divide="ignore"):
        return df.assign("Relative_Prob",
                         np.where(total > 0, t1 / total, np.nan))


def _present(values: np.ndarray) -> np.ndarray:
    """``Series.notna()``."""
    return np.array([not is_missing(v) for v in values], dtype=bool)


# ---------------------------------------------------------------------------
# Per-prompt summary statistics (:1789-1845)
# ---------------------------------------------------------------------------


def prompt_summary_stats(
    prompt_data: Table, prompt_idx: int, token_options: Sequence[str]
) -> Dict[str, object]:
    first_token, second_token = token_options[0], token_options[1]
    rp = prompt_data["Relative_Prob"]
    rp = rp[np.isfinite(rp)]
    if len(rp) > 0:
        lo, hi = np.percentile(rp, [2.5, 97.5])
        stats = {
            "Prompt Number": prompt_idx + 1,
            "First Token": first_token,
            "Second Token": second_token,
            f'Mean Relative Probability of "{first_token}"': rp.mean(),
            "Std Dev": series_std(rp),
            "Min": rp.min(),
            "Max": rp.max(),
            "2.5th Percentile": lo,
            "97.5th Percentile": hi,
            "95% Interval Width": hi - lo,
        }
    else:
        stats = {
            "Prompt Number": prompt_idx + 1,
            "First Token": first_token,
            "Second Token": second_token,
            f'Mean Relative Probability of "{first_token}"': np.nan,
            "Std Dev": np.nan,
            "Min": np.nan,
            "Max": np.nan,
            "2.5th Percentile": np.nan,
            "97.5th Percentile": np.nan,
            "95% Interval Width": np.nan,
        }

    if "Weighted Confidence" in prompt_data:
        conf = prompt_data["Weighted Confidence"]
        conf = conf[_present(conf)].astype(float)
        if len(conf) > 0:
            clo, chi = np.percentile(conf, [2.5, 97.5])
            stats.update(
                {
                    f'Mean Weighted Confidence for "{first_token}"': conf.mean(),
                    "Confidence Std Dev": series_std(conf),
                    "Confidence Min": conf.min(),
                    "Confidence Max": conf.max(),
                    "Confidence 2.5th Percentile": clo,
                    "Confidence 97.5th Percentile": chi,
                    "Confidence 95% Interval Width": chi - clo,
                }
            )
    return stats


# ---------------------------------------------------------------------------
# Within-prompt Cohen's kappa (C24, :1094-1188)
# ---------------------------------------------------------------------------


def perturbation_kappa(df: Table) -> Tuple[float, float, float]:
    """Binarize Relative_Prob > 0.5 and compute the same-prompt-pairs kappa
    via the closed form."""
    finite = df.take(np.isfinite(df["Relative_Prob"]))
    if len(finite) == 0:
        return float("nan"), float("nan"), float("nan")
    decisions = (finite["Relative_Prob"] > 0.5).astype(int)
    res = within_group_kappa(decisions, finite.codes("Original Main Part"))
    return res["kappa"], res["observed_agreement"], res["expected_agreement"]


# ---------------------------------------------------------------------------
# Compliance audits (C25/C26, :1191-1675)
# ---------------------------------------------------------------------------

# Expected-token tables per canonical prompt (:1207-1248). Derived from the
# prompt assets: first tokens are the target tokens; accepted full responses
# cover the casing variants the reference allows. The reference additionally
# accepts two truncated variants for prompt 4 (:1236-1237) that cannot be
# derived from the instruction text.
EXTRA_FULL_RESPONSES: Dict[int, Dict[str, List[str]]] = {
    3: {
        "Monthly": ["Monthly Installment Payment"],
        "Payment": ["Payment Upon"],
    },
}


def expected_compliance_tokens(
    prompt: LegalPrompt, prompt_idx: Optional[int] = None
) -> Dict[str, object]:
    t1, t2 = prompt.target_tokens
    # The reference's expected-token table (:1207-1248) lists first tokens
    # in the RESPONSE FORMAT's presentation order ('First, Ultimate'), not
    # the readout's token_1/token_2 order ('Ultimate, First') — order the
    # report identically (membership semantics are unaffected).
    order = (t1, t2)
    fmt = prompt.response_format
    pos = {t: fmt.find(f"'{t}") for t in order}
    if all(p >= 0 for p in pos.values()):
        order = tuple(sorted(order, key=lambda t: pos[t]))
    full: Dict[str, List[str]] = {}
    for token in (t1, t2):
        # Reconstruct the allowed answer phrases from the response format:
        # every quoted alternative in the instruction that starts with the
        # token, plus lower-cased tail variants.
        phrases = []
        for part in fmt.split("'")[1::2]:  # quoted alternatives
            if part.startswith(token):
                phrases.append(part)
                if " " in part:
                    head, tail = part.split(" ", 1)
                    phrases.append(f"{head} {tail.lower()}")
        if prompt_idx is not None:
            phrases.extend(EXTRA_FULL_RESPONSES.get(prompt_idx, {}).get(token, []))
        full[token] = phrases or [token]
    return {"first_tokens": list(order), "full_responses": full}


def _load_payload(raw):
    """Parse a stored Log Probabilities value (json -> ast fallback,
    :1301-1322); None when unparseable."""
    if not isinstance(raw, str):
        return raw
    try:
        return json.loads(raw)
    except (json.JSONDecodeError, ValueError):
        try:
            return ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            return None


def parse_logprob_content(raw) -> Optional[Tuple[str, str]]:
    """(first token, full response) from a stored Log Probabilities value
    (json -> ast fallback, :1301-1322)."""
    obj = _load_payload(raw)
    if not isinstance(obj, dict) or "content" not in obj or not obj["content"]:
        return None
    tokens = [t.get("token", "") for t in obj["content"]]
    return tokens[0], "".join(tokens).strip()


def _is_local_logprob_map(obj) -> bool:
    """True for the local sweep's 'Log Probabilities' payload (already
    parsed by _load_payload): a flat {token_id: logprob} top-20 map whose
    keys are all integer strings (the D6 writer). The reference's API
    payloads are content-style dicts, and word-keyed maps stay False, so
    reference data keeps the executed reference's skip semantics while
    locally produced artifacts get classified instead of silently
    skipped."""
    return (isinstance(obj, dict) and bool(obj)
            and "content" not in obj
            and all(isinstance(k, str) and k.lstrip("-").isdigit()
                    for k in obj))


def check_output_compliance(
    df: Table,
    prompts: Sequence[LegalPrompt],
) -> Table:
    """First-token and conditional full-response compliance per prompt
    (:1191-1451)."""
    results = []
    for idx, original_prompt in enumerate(df.unique("Original Main Part")):
        if idx >= len(prompts):
            break
        expected = expected_compliance_tokens(prompts[idx], idx)
        pdata = df.where("Original Main Part", original_prompt)
        valid = pdata.take(np.isfinite(pdata["Relative_Prob"]))
        total = len(valid)
        if total == 0:
            continue

        first_ok = first_bad = sub_ok = sub_bad = 0
        responses = (valid["Model Response"] if "Model Response" in valid
                     else [None] * total)
        for raw, resp in zip(valid["Log Probabilities"], responses):
            payload = _load_payload(raw)
            parsed = parse_logprob_content(payload)
            if parsed is None:
                # Local-format rows (top-20 id map) carry the decoded text
                # in 'Model Response': classify from it — first word plays
                # the reference's whole-word first token. API/reference
                # rows with unparseable payloads keep the reference's skip
                # behavior (:1313-1326).
                if (_is_local_logprob_map(payload) and isinstance(resp, str)
                        and resp.strip()):
                    full_response = resp.strip()
                    first_token = full_response.split()[0]
                else:
                    continue
            else:
                first_token, full_response = parsed

            # Longest-matching expected token wins, so a target that is a
            # string prefix of another cannot steal the other's bucket by
            # iteration order.
            matched = None
            for exp in expected["first_tokens"]:
                if first_token == exp or first_token.startswith(exp):
                    if matched is None or len(exp) > len(matched):
                        matched = exp
            if matched is None:
                first_bad += 1
                continue
            first_ok += 1

            norm_resp = full_response.replace(" ", "")
            is_full = False
            for exp_full in expected["full_responses"].get(matched, []):
                norm_exp = exp_full.replace(" ", "")
                if (
                    full_response == exp_full
                    or norm_resp == norm_exp
                    or norm_resp.startswith(norm_exp)
                ):
                    is_full = True
                    break
            if is_full:
                sub_ok += 1
            else:
                sub_bad += 1

        row: Dict[str, object] = {
            "Prompt": idx + 1,
            "Expected_First_Tokens": ", ".join(expected["first_tokens"]),
            "Total_Samples": total,
            "First_Token_Compliant": first_ok,
            "First_Token_Non_Compliant": first_bad,
            "First_Token_Compliance_Rate": first_ok / total * 100,
            "First_Token_Non_Compliance_Rate": first_bad / total * 100,
        }
        if first_ok > 0:
            row.update(
                {
                    "Conditional_Subsequent_Compliant": sub_ok,
                    "Conditional_Subsequent_Non_Compliant": sub_bad,
                    "Conditional_Subsequent_Compliance_Rate": sub_ok / first_ok * 100,
                    "Conditional_Subsequent_Non_Compliance_Rate": sub_bad
                    / first_ok
                    * 100,
                }
            )
        results.append(row)
    return Table.from_records(results)


def check_confidence_compliance(
    df: Table, prompts: Sequence[LegalPrompt]
) -> Table:
    """Integer-in-[0,100] confidence compliance per prompt (:1501-1675).
    Each answer is classified by its text as the column holds it: a column
    that read as floats renders its integers as ``"85.0"`` (caveat R4)."""
    if "Model Confidence Response" not in df:
        return Table()
    results = []
    for idx, original_prompt in enumerate(df.unique("Original Main Part")):
        if idx >= len(prompts):
            break
        pdata = df.where("Original Main Part", original_prompt)
        answers = pdata["Model Confidence Response"]
        answers = answers[_present(answers)]
        total = len(answers)
        if total == 0:
            continue

        compliant = 0
        kinds = {"float": 0, "text": 0, "out_of_range": 0, "other": 0}
        for raw in answers:
            s = str(raw).strip()
            try:
                v = int(s)
                if 0 <= v <= 100:
                    compliant += 1
                else:
                    kinds["out_of_range"] += 1
            except ValueError:
                try:
                    float(s)
                    kinds["float"] += 1
                except ValueError:
                    if any(c.isalpha() for c in s):
                        kinds["text"] += 1
                    else:
                        kinds["other"] += 1
        non_compliant = total - compliant
        results.append(
            {
                "Prompt": idx + 1,
                "Total_Confidence_Samples": total,
                "Confidence_Compliant": compliant,
                "Confidence_Non_Compliant": non_compliant,
                "Confidence_Compliance_Rate": compliant / total * 100,
                "Confidence_Non_Compliance_Rate": non_compliant / total * 100,
                "Float_Errors": kinds["float"],
                "Text_Errors": kinds["text"],
                "Out_Of_Range_Errors": kinds["out_of_range"],
                "Other_Errors": kinds["other"],
            }
        )
    return Table.from_records(results)


def assert_compliance(
    compliance: Table,
    min_first_token_rate: float = 50.0,
) -> None:
    """Turn the compliance report into a pipeline assertion ('compliance
    checks become assertions, not just reports')."""
    if len(compliance) == 0:
        return
    overall = (
        np.sum(compliance["First_Token_Compliant"])
        / np.sum(compliance["Total_Samples"])
        * 100
    )
    if overall < min_first_token_rate:
        raise AssertionError(
            f"First-token compliance {overall:.1f}% below the "
            f"{min_first_token_rate:.1f}% gate — measurement likely invalid "
            "(wrong target tokens or prompt formatting)."
        )


# ---------------------------------------------------------------------------
# Per-model orchestration (:1719-1960)
# ---------------------------------------------------------------------------

_SCALED_FIELDS = (
    "Underlying Normal Mean", "Underlying Normal Std Dev",
    "Observed Mean", "Observed Std Dev", "Simulated Mean",
    "Simulated Std Dev", "Interior Mean", "Interior Std Dev",
)


def analyze_model(
    df: Table,
    model_name: str,
    output_dir: Path,
    prompts: Sequence[LegalPrompt] = LEGAL_PROMPTS,
    seed: int = 42,
    model_idx: int = 0,
    n_simulations: int = 100_000,
    make_figures: bool = True,
    device="cuda",
) -> Dict[str, object]:
    """Full single-model analysis; writes every reference artifact into
    `output_dir` and returns the result tables. The draws are those of
    ``draw_generator(seed, model_idx, ...)``."""
    dev = resolve_device(device)
    if make_figures:
        figures.require_matplotlib()
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    figures_dir = output_dir / "figures"

    if len(df) < MIN_ROWS_FOR_ANALYSIS:
        log.warning(
            "Only %d rows for %s; skipping detailed analysis", len(df), model_name
        )
        summary = Table.from_records(
            [
                {
                    "Model": model_name,
                    "Total Rows": len(df),
                    "Status": "Insufficient data for analysis",
                }
            ]
        )
        summary.to_csv(output_dir / "summary_statistics.csv")
        return {"summary": summary, "status": "insufficient_data"}

    df = add_relative_prob(df)
    non_finite = int((~np.isfinite(df["Relative_Prob"])).sum())
    if non_finite:
        log.warning(
            "%d non-finite relative probabilities for %s", non_finite, model_name
        )

    summary_rows, normality_rows, truncated_rows, tables = [], [], [], []
    rng = np.random.default_rng(42)

    for idx, original_prompt in enumerate(df.unique("Original Main Part")):
        pdata = df.where("Original Main Part", original_prompt)
        token_options = (
            prompts[idx].target_tokens if idx < len(prompts) else ("A", "B")
        )

        def gen(column: str, statistic: int):
            return draw_generator(seed, model_idx, idx, column, statistic)

        if make_figures:
            figures.probability_histogram(pdata, idx, token_options, figures_dir)
            figures.confidence_histogram(pdata, idx, token_options, figures_dir)

        tables.append(
            perturbation_latex_table(
                pdata, idx,
                prompts[idx].main if idx < len(prompts) else original_prompt,
                token_options, rng,
            )
        )
        summary_rows.append(prompt_summary_stats(pdata, idx, token_options))

        rp = pdata["Relative_Prob"].astype(float)
        nres = normality_tests(rp, prompt_idx=idx)
        nres["Column"] = "Relative_Prob"
        normality_rows.append(nres)

        if make_figures:
            figures.qq_plot(pdata, "Relative_Prob", idx, token_options,
                            figures_dir, gen("Relative_Prob", QQ),
                            device=dev)

        tres, sample = truncated_normal_mc_fit(
            rp, gen("Relative_Prob", FIT), n_simulations=n_simulations,
            prompt_idx=idx, column_name="Relative_Prob", device=dev,
        )
        truncated_rows.append(tres)
        if make_figures and sample.size:
            figures.truncated_model_plot(
                pdata, "Relative_Prob", idx, token_options, sample,
                figures_dir, tres["KS Statistic"],
            )

        has_conf = "Weighted Confidence" in pdata and _present(
            pdata["Weighted Confidence"]).any()
        if has_conf:
            conf_data = pdata.take(_present(pdata["Weighted Confidence"]))
            conf = conf_data["Weighted Confidence"].astype(float)
            cres = normality_tests(conf, prompt_idx=idx)
            cres["Column"] = "Weighted_Confidence"
            normality_rows.append(cres)
            if make_figures:
                figures.qq_plot(conf_data, "Weighted Confidence", idx,
                                token_options, figures_dir,
                                gen("Weighted Confidence", QQ), device=dev)

            # Rescale 0-100 confidence to [0,1] for the truncated fit, then
            # report on the original scale (:1880-1900).
            scale = 100.0 if conf.max() > 1 else 1.0
            ctres, csample = truncated_normal_mc_fit(
                conf / scale, gen("Weighted Confidence", FIT),
                n_simulations=n_simulations, prompt_idx=idx,
                column_name="Weighted Confidence", device=dev,
            )
            if csample.size:
                csample = csample * scale
                for field in _SCALED_FIELDS:
                    if field in ctres and np.isfinite(ctres[field]):
                        ctres[field] *= scale
            truncated_rows.append(ctres)
            if make_figures and csample.size:
                figures.truncated_model_plot(
                    conf_data, "Weighted Confidence", idx, token_options,
                    csample, figures_dir, ctres["KS Statistic"],
                )

    # LaTeX artifacts.
    (output_dir / "prompt_perturbation_tables.tex").write_text(
        "\n".join(tables), encoding="utf-8"
    )
    (output_dir / "prompt_perturbation_standalone.tex").write_text(
        standalone_latex_document(tables), encoding="utf-8"
    )

    summary = Table.from_records(summary_rows)
    summary.to_csv(output_dir / "summary_statistics.csv")

    if make_figures:
        figures.combined_visualization(df, prompts, output_dir, rng)
        figures.combined_confidence_visualization(df, prompts, output_dir, rng)

    normality = Table.from_records(normality_rows)
    normality.to_csv(output_dir / "normality_test_results.csv")
    truncated = Table.from_records(truncated_rows)
    truncated.to_csv(output_dir / "truncated_normal_test_results.csv")

    kappa, observed, expected = perturbation_kappa(df)
    kappa_table = Table.from_records(
        [
            {
                "Model": model_name,
                "Cohen's Kappa": kappa,
                "Observed Agreement": observed,
                "Expected Agreement": expected,
            }
        ]
    )
    kappa_table.to_csv(output_dir / "cohens_kappa_results.csv")
    log.info(
        "%s: kappa=%.4f (%s)", model_name, kappa, interpret_kappa(kappa)
    )

    compliance = check_output_compliance(df, prompts)
    if len(compliance):
        compliance.to_csv(output_dir / "output_compliance_results.csv")
        (output_dir / "compliance_summary.tex").write_text(
            compliance_latex_table(compliance), encoding="utf-8"
        )
    confidence = check_confidence_compliance(df, prompts)
    if len(confidence):
        confidence.to_csv(output_dir / "confidence_compliance_results.csv")
        (output_dir / "confidence_compliance_summary.tex").write_text(
            confidence_compliance_latex_table(confidence), encoding="utf-8"
        )

    return {
        "summary": summary,
        "normality": normality,
        "truncated": truncated,
        "kappa": kappa_table,
        "compliance": compliance,
        "confidence_compliance": confidence,
        "status": "ok",
    }


def model_dir_name(model_name: str) -> str:
    """One model's output directory under the root (:614)."""
    return model_name.replace(".", "_").replace("-", "_")


def analyze_all_models(
    results_path: Path,
    output_root: Path,
    prompts: Sequence[LegalPrompt] = LEGAL_PROMPTS,
    seed: int = 42,
    n_simulations: int = 100_000,
    make_figures: bool = True,
    device="cuda",
) -> Dict[str, Dict[str, object]]:
    """The reference's __main__ loop (:1963-2026): one output directory per
    model (dots/dashes replaced); model i draws with ``model_idx=i``."""
    dev = resolve_device(device)
    df = read_results_frame(Path(results_path))
    out: Dict[str, Dict[str, object]] = {}
    if "Model" in df:
        for model_idx, model_name in enumerate(df.unique("Model")):
            out[model_name] = analyze_model(
                df.where("Model", model_name), model_name,
                Path(output_root) / model_dir_name(model_name), prompts,
                seed, model_idx, n_simulations=n_simulations,
                make_figures=make_figures, device=dev,
            )
    else:
        out["Single Model"] = analyze_model(
            df, "Single Model", Path(output_root), prompts, seed, 0,
            n_simulations=n_simulations, make_figures=make_figures,
            device=dev,
        )
    return out


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        description="Per-model perturbation analysis (C20-C27 parity)."
    )
    parser.add_argument("--results", type=Path, required=True,
                        help="D6 results artifact (an .xlsx path is read "
                             "from its .csv)")
    parser.add_argument("--out", type=Path, default=Path("results/perturbation"))
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--n-simulations", type=int, default=100_000)
    parser.add_argument("--no-figures", action="store_true")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    analyze_all_models(
        args.results, args.out, seed=args.seed,
        n_simulations=args.n_simulations, make_figures=not args.no_figures,
        device=args.device,
    )


if __name__ == "__main__":
    main()
