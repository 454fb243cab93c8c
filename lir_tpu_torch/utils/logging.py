"""Session logging: a structured logger plus a captured session transcript.

A copy of ``lir_tpu/utils/logging.py`` under this package's logger name.
The reference tees stdout into a list and dumps it to a txt file at the
end (``log_print``/``save_captured_output``,
compare_base_vs_instruct.py:9-31, 548-550); here the same capability is
standard logging with an attachable capture handler.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import List, Optional

_LOGGER_NAME = "lir_tpu_torch"


class CaptureHandler(logging.Handler):
    def __init__(self) -> None:
        super().__init__()
        self.lines: List[str] = []

    def emit(self, record: logging.LogRecord) -> None:
        self.lines.append(self.format(record))


def get_logger(name: Optional[str] = None) -> logging.Logger:
    if name is None:
        qualified = _LOGGER_NAME
    elif name.startswith(_LOGGER_NAME + ".") or name == _LOGGER_NAME:
        qualified = name  # already package-qualified (callers pass __name__)
    else:
        qualified = f"{_LOGGER_NAME}.{name}"
    logger = logging.getLogger(qualified)
    root = logging.getLogger(_LOGGER_NAME)
    # Install the console handler exactly once. CaptureHandler derives from
    # logging.Handler (not StreamHandler), so capture handlers attached first
    # never satisfy this check.
    if not any(isinstance(h, logging.StreamHandler) for h in root.handlers):
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        root.addHandler(handler)
        root.setLevel(logging.INFO)
    return logger


def start_capture() -> CaptureHandler:
    handler = CaptureHandler()
    handler.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
    logging.getLogger(_LOGGER_NAME).addHandler(handler)
    return handler


def save_captured_output(handler: CaptureHandler, path: Path) -> None:
    """Write the captured session transcript
    (parity: compare_base_vs_instruct.py:27-31)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(handler.lines) + "\n")
    logging.getLogger(_LOGGER_NAME).removeHandler(handler)
