"""The perturbation cache (C3): load ``perturbations.json`` or refuse.

The part of ``lir_tpu/engine/rephrase.py`` the perturbation sweep needs:
:func:`load_or_generate_perturbations` with the reference's cache rule
(perturb_prompts.py:739-777): a reloaded cache must match the in-code
prompt list element by element, or it is not used. The JAX package then
generates the rephrasings with a local model; the port cannot yet
(``generate.sample_decode`` waits, ROADMAP "Also open"), so an unusable
cache raises.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, List, Optional, Sequence

from ..data import schemas
from ..data.prompts import LegalPrompt
from ..utils.logging import get_logger

log = get_logger(__name__)


def load_or_generate_perturbations(
    cache_path: Path,
    prompts: Sequence[LegalPrompt],
    generate_text: Optional[Callable] = None,
) -> List[schemas.PerturbationEntry]:
    """The cached entries at ``cache_path`` when they match ``prompts``.

    Without a valid cache: ``generate_text=None`` raises the JAX
    function's RuntimeError; a rephraser raises NotImplementedError (the
    port has no sampling decode yet)."""
    cache_path = Path(cache_path)
    if cache_path.exists():
        try:
            entries = schemas.load_perturbations(cache_path)
        except Exception as exc:
            log.warning("Perturbation cache unreadable (%s); regenerating", exc)
            entries = []
        if entries and schemas.validate_perturbation_cache(entries, prompts):
            log.info("Loaded %d cached perturbation sets from %s",
                     len(entries), cache_path)
            return entries
        if entries:
            log.warning(
                "Perturbation cache at %s does not match the prompt list; "
                "regenerating", cache_path)

    if generate_text is None:
        raise RuntimeError(
            f"No valid perturbation cache at {cache_path} and no rephraser "
            "model supplied. Provide generate_text (a local sampling model) "
            "or a cached perturbations.json.")
    raise NotImplementedError(
        "generating rephrasings needs the port's sampling decode "
        "(generate.sample_decode, ROADMAP 'Also open'); supply a cached "
        "perturbations.json")
