"""On-card perturbation generation (C3): no external API call.

Port of ``lir_tpu/engine/rephrase.py``. The reference asks a hosted
model through its API (temperature 0.9) for 100 sessions x 20 numbered
rephrasings per legal prompt, parses the numbered list (continuation
lines included), caches everything to ``perturbations.json`` and
validates the cache against the in-code prompt list on reload
(perturb_prompts.py:727-870). Here the
generator is any local instruct model run through the sampling decoder
(``generate.sample_decode``, JAX's threefry draws, so a key samples what
the JAX package samples); the parser, the cache format and the
validation rule are the JAX package's, and a cached
``perturbations.json`` from either package can be dropped in.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..data import schemas
from ..data.prompts import LegalPrompt, rephrase_request
from ..utils.logging import get_logger
from . import prng

log = get_logger(__name__)

PromptParts = Tuple[str, str, Tuple[str, str], str]


def parse_numbered_rephrasings(text: str) -> List[str]:
    """Parse a numbered-list response into rephrasings.

    Rule parity (perturb_prompts.py:812-835): skip blanks and "here are"
    preambles; "N. text" splits at the first dot; "N text" strips leading
    digits and ' .-\\t'; unnumbered lines continue the previous rephrasing.
    """
    out: List[str] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.lower().startswith("here are"):
            continue
        if line[0].isdigit():
            parts = line.split(".", 1)
            if len(parts) > 1:
                out.append(parts[1].strip())
            else:
                out.append(line.lstrip("0123456789").strip(" .-\t"))
        elif out:
            out[-1] += " " + line
        else:
            out.append(line)
    return out


def prompt_parts(prompt: LegalPrompt) -> PromptParts:
    return (
        prompt.main,
        prompt.response_format,
        tuple(prompt.target_tokens),
        prompt.confidence_format,
    )


def generate_rephrasings(
    generate_text: Callable,
    prompts: Sequence[LegalPrompt],
    key,
    sessions_per_prompt: int = 100,
    rephrasings_per_session: int = 20,
    sessions_per_batch: int = 8,
) -> List[Tuple[PromptParts, List[str]]]:
    """Generate the full perturbation set with a local model.

    ``generate_text`` maps (prompt texts, threefry key) -> decoded texts;
    :func:`rephraser_from_engine` builds one over a loaded model.
    Sessions are batched: the reference's 100 sequential API calls per
    prompt become ceil(100 / B) batched sampling calls, each with
    ``key, sub = split(key)``. A batch that raises is skipped with a
    warning (the reference's session skip, perturb_prompts.py:841-843).
    """
    # A closure with ``dispatch`` / ``fetch`` (rephraser_from_engine)
    # pipelines the loop: batch N + 1 is dispatched before batch N's ids
    # are fetched, so batch N's copy to the host and text decode follow
    # the queued sampling instead of the device waiting for them. Plain
    # callables keep the synchronous path.
    dispatch = getattr(generate_text, "dispatch", None)
    fetch = getattr(generate_text, "fetch", None)
    pipelined = dispatch is not None and fetch is not None
    key = prng.as_key(key)

    results: List[Tuple[PromptParts, List[str]]] = []
    for prompt in prompts:
        request = rephrase_request(prompt.main, n=rephrasings_per_session)
        all_rephrasings: List[str] = []
        remaining = sessions_per_prompt
        pending = None  # the batch in flight (pipelined mode)

        def drain(handle) -> None:
            try:
                for text in fetch(handle):
                    all_rephrasings.extend(parse_numbered_rephrasings(text))
            except Exception as exc:  # session-skip parity (:841-843)
                log.warning("rephrase batch failed (%s); skipping", exc)

        while remaining > 0:
            n = min(sessions_per_batch, remaining)
            remaining -= n
            key, sub = prng.split(key)
            if pipelined:
                try:
                    handle = dispatch([request] * n, sub)
                except Exception as exc:
                    log.warning("rephrase batch failed (%s); skipping", exc)
                    handle = None
                if pending is not None:
                    drain(pending)
                pending = handle
                continue
            try:
                texts = generate_text([request] * n, sub)
            except Exception as exc:  # session-skip parity (:841-843)
                log.warning("rephrase batch failed (%s); skipping", exc)
                continue
            for text in texts:
                all_rephrasings.extend(parse_numbered_rephrasings(text))
        if pending is not None:
            drain(pending)
        log.info("Generated %d rephrasings for prompt %r",
                 len(all_rephrasings), prompt.main[:50])
        results.append((prompt_parts(prompt), all_rephrasings))
    return results


def load_or_generate_perturbations(
    cache_path: Path,
    prompts: Sequence[LegalPrompt],
    generate_text: Optional[Callable] = None,
    key=None,
    sessions_per_prompt: int = 100,
    rephrasings_per_session: int = 20,
) -> List[schemas.PerturbationEntry]:
    """Cache-or-generate with the reference's validation rule
    (perturb_prompts.py:739-777): a reloaded cache must match the in-code
    prompt list element by element, or it is regenerated with
    ``generate_text`` (default key ``prng_key(42)``) and saved. Without
    a valid cache and without a rephraser it raises the JAX function's
    RuntimeError."""
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
    key = key if key is not None else prng.prng_key(42)
    results = generate_rephrasings(
        generate_text, prompts, key,
        sessions_per_prompt=sessions_per_prompt,
        rephrasings_per_session=rephrasings_per_session)
    schemas.save_perturbations(cache_path, results)
    log.info("Saved perturbations to %s", cache_path)
    return results


def rephraser_from_engine(engine, temperature: float = 0.9,
                          max_new_tokens: int = 512):
    """A ``generate_text`` closure over a ScoringEngine's model: the
    sampling decoder at temperature 0.9 (perturb_prompts.py:802), with
    the EOS stop armed from the engine's tokenizer (post-EOS tokens are
    trimmed from the text either way, so the stop only saves steps).

    The closure carries ``dispatch`` / ``fetch``, the call split at its
    sync point: ``dispatch`` tokenizes and runs the sampling decode,
    whose kernels the host queues ahead of the device, and returns the
    ids on the device; ``fetch`` copies them to the host (waiting for the
    device) and decodes the texts. Calling the closure is the two in
    turn."""
    from . import generate as gen_mod
    from . import tokens as tok

    engine._decoder_only("rephraser_from_engine")

    def dispatch(texts: Sequence[str], key):
        ids_list = [engine.tokenizer(t).input_ids for t in texts]
        bucket = tok.pick_bucket([len(i) for i in ids_list], engine.buckets)
        toks_arr, mask = tok.left_pad_ids(
            ids_list, bucket, tok.pad_token_id(engine.tokenizer))
        return gen_mod.sample_decode(
            engine.params, engine.cfg, engine._t(toks_arr), engine._t(mask),
            key, temperature=temperature, max_new_tokens=max_new_tokens,
            eos_id=None if engine.eos_id is None else int(engine.eos_id))

    def fetch(gen) -> List[str]:
        gen_host = np.asarray(gen.cpu())
        return [engine.decode_completion(row) for row in gen_host]

    def generate_text(texts: Sequence[str], key) -> List[str]:
        return fetch(dispatch(texts, key))

    generate_text.dispatch = dispatch
    generate_text.fetch = fetch
    return generate_text
