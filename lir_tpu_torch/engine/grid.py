"""Perturbation-grid construction, subset sampling, and resume keys.

C4/C5/C6 parity (SURVEY.md §2.1): the reference expands
(prompt x rephrasing x format) into OpenAI batch requests with custom_id
metadata (perturb_prompts.py:190-269), skips (Model, Original Main Part,
Rephrased Main Part) triples already present in the output Excel (:161-188),
and supports a seeded random subset for cost estimation (:109-159). Here the
grid is a deterministic list of cells; "requests" are just batched local
forward passes, and resume runs through utils/manifest.SweepManifest with the
same key triple.

A copy of the JAX package's ``engine/grid.py``: the same cells, subsets
and resume keys, so either package resumes the other's sweep.
"""

from __future__ import annotations

import dataclasses
import functools
import random
from typing import Dict, List, Optional, Sequence, Tuple

from ..data.prompts import LegalPrompt

RESUME_KEY_FIELDS = ("model", "original_main", "rephrased_main")

# Manifest key field -> D6 results-workbook column. Seeding the resume
# done-set from the results artifact (SweepManifest.from_existing_results)
# needs this mapping: the workbook keeps the reference's column names
# while the manifest keys stay snake_case.
RESUME_COLUMN_MAP = {
    "model": "Model",
    "original_main": "Original Main Part",
    "rephrased_main": "Rephrased Main Part",
}


@dataclasses.dataclass(frozen=True)
class GridCell:
    """One (model, prompt, rephrasing) measurement unit.

    Each cell scores TWO prompts (binary + confidence format) — the
    reference's two request dicts per rephrasing (perturb_prompts.py:208-252).
    """

    model: str
    prompt_idx: int
    rephrase_idx: int
    original_main: str
    rephrased_main: str
    response_format: str
    confidence_format: str
    target_tokens: Tuple[str, str]

    # cached: the ragged scheduler touches each prompt string several
    # times per sweep (tokenize at plan time, dispatch, row build) — a
    # 20k-cell grid re-concatenating ~1 KB strings per access is pure
    # waste. cached_property writes instance __dict__ directly, which a
    # frozen dataclass permits.
    @functools.cached_property
    def binary_prompt(self) -> str:
        return f"{self.rephrased_main} {self.response_format}"

    @functools.cached_property
    def confidence_prompt(self) -> str:
        return f"{self.rephrased_main} {self.confidence_format}"

    def resume_record(self) -> Dict[str, str]:
        return {"model": self.model, "original_main": self.original_main,
                "rephrased_main": self.rephrased_main}


def build_grid(model: str, prompts: Sequence[LegalPrompt],
               perturbations: Sequence[Sequence[str]],
               include_original: bool = True) -> List[GridCell]:
    """Expand the full grid for one model.

    ``perturbations[i]`` is the rephrasing list for ``prompts[i]``. The
    EXECUTED reference grid contains only the rephrasings
    (create_batch_requests iterates the rephrasing lists alone,
    perturb_prompts.py:200-213 — pinned by tools/reference_perturb_oracle.py);
    ``include_original=True`` (the local-pipeline default) additionally
    scores the unperturbed original as rephrase_idx 0, a lir_tpu
    extension that anchors each prompt's perturbation distribution. Pass
    ``include_original=False`` for reference-exact grids (the API-backend
    oracle differential does)."""
    cells: List[GridCell] = []
    for pi, (prompt, rephrasings) in enumerate(zip(prompts, perturbations)):
        variants = ([prompt.main, *rephrasings] if include_original
                    else list(rephrasings))
        for ri, rephrased in enumerate(variants):
            cells.append(GridCell(
                model=model, prompt_idx=pi, rephrase_idx=ri,
                original_main=prompt.main, rephrased_main=rephrased,
                response_format=prompt.response_format,
                confidence_format=prompt.confidence_format,
                target_tokens=prompt.target_tokens))
    return cells


def random_subset(cells: Sequence[GridCell], size: Optional[int],
                  seed: int = 42) -> List[GridCell]:
    """Seeded subset sampling, regrouped by prompt (perturb_prompts.py:109-159)."""
    if size is None or size >= len(cells):
        return list(cells)
    rng = random.Random(seed)
    picked = rng.sample(list(cells), size)
    picked.sort(key=lambda c: (c.prompt_idx, c.rephrase_idx))
    return picked


def pending_cells(cells: Sequence[GridCell], manifest) -> List[GridCell]:
    """Drop cells whose resume key is already in the manifest (C5 dedup)."""
    return [c for c in cells if not manifest.is_done(c.resume_record())]
