"""Logging and serving utilities: a copy of ``vcoder_tpu/utils.py:15-158``.

``StreamToLogger``, ``build_logger``, ``server_error_msg``,
``moderation_msg``, ``violates_moderation`` and ``pretty_print_semaphore``
are copied unchanged (keep them in step); ``disable_torch_init`` is a
documented no-op. A daily-rotating file log shared by every serve process,
capture of raw ``print``/traceback output into that log, the server
error-message constants, and a moderation hook that is a no-op without an
``OPENAI_API_KEY``.

The gradio demo (``serve/gradio_app.py``) calls ``violates_moderation``;
``moderation_msg`` and ``pretty_print_semaphore`` are kept for parity with
the JAX package's API.

``build_logger`` points ``sys.stdout``/``sys.stderr`` at the log, so the
port's serving modules call it from their ``main()`` only, never at import.
"""

from __future__ import annotations

import io
import logging
import logging.handlers
import os
import sys
from typing import Optional

LOGDIR = "."

server_error_msg = (
    "**NETWORK ERROR DUE TO HIGH TRAFFIC. PLEASE REGENERATE OR REFRESH THIS"
    " PAGE.**"
)
moderation_msg = (
    "YOUR INPUT VIOLATES OUR CONTENT MODERATION GUIDELINES. PLEASE TRY"
    " AGAIN."
)

_LOG_FORMAT = logging.Formatter(
    fmt="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
    datefmt="%Y-%m-%d %H:%M:%S",
)
_file_handler: Optional[logging.Handler] = None


class StreamToLogger(io.TextIOBase):
    """File-like writer that forwards complete lines to a logger.

    Installed over ``sys.stdout``/``sys.stderr`` so stray prints and
    tracebacks land in the rotating log. Partial lines are buffered until
    their newline arrives (or ``flush``). Unknown attributes fall through
    to the real terminal stream so code poking at ``encoding``/``isatty``
    keeps working.
    """

    def __init__(self, logger: logging.Logger, log_level: int = logging.INFO):
        self.terminal = sys.stdout
        self.logger = logger
        self.log_level = log_level
        self._pending = ""

    def __getattr__(self, attr):
        return getattr(self.terminal, attr)

    def write(self, buf: str) -> int:
        text = self._pending + buf
        self._pending = ""
        while True:
            line, sep, rest = text.partition("\n")
            if not sep:
                self._pending = line
                break
            clean = line.encode("utf-8", "ignore").decode("utf-8")
            self.logger.log(self.log_level, clean.rstrip())
            text = rest
        return len(buf)

    def flush(self) -> None:
        if self._pending:
            clean = self._pending.encode("utf-8", "ignore").decode("utf-8")
            self.logger.log(self.log_level, clean.rstrip())
            self._pending = ""


def _ensure_file_handler(filename: str) -> None:
    """Attach ONE daily-rotating file handler to the root logger; every
    named logger propagates to root, so this captures them all without
    touching individual loggers."""
    global _file_handler
    if _file_handler is not None:
        return
    os.makedirs(LOGDIR, exist_ok=True)
    _file_handler = logging.handlers.TimedRotatingFileHandler(
        os.path.join(LOGDIR, filename), when="D", utc=True, encoding="utf-8"
    )
    _file_handler.setFormatter(_LOG_FORMAT)
    logging.getLogger().addHandler(_file_handler)


def build_logger(logger_name: str, logger_filename: str) -> logging.Logger:
    """Named logger wired into the shared rotating file log; also points
    ``sys.stdout``/``sys.stderr`` at capture loggers (once)."""
    root = logging.getLogger()
    if not root.handlers:
        console = logging.StreamHandler(sys.__stdout__)
        console.setFormatter(_LOG_FORMAT)
        root.addHandler(console)
        root.setLevel(logging.INFO)
    else:
        root.handlers[0].setFormatter(_LOG_FORMAT)

    if not isinstance(sys.stdout, StreamToLogger):
        out_logger = logging.getLogger("stdout")
        out_logger.setLevel(logging.INFO)
        sys.stdout = StreamToLogger(out_logger, logging.INFO)
    if not isinstance(sys.stderr, StreamToLogger):
        err_logger = logging.getLogger("stderr")
        err_logger.setLevel(logging.ERROR)
        sys.stderr = StreamToLogger(err_logger, logging.ERROR)

    _ensure_file_handler(logger_filename)

    logger = logging.getLogger(logger_name)
    logger.setLevel(logging.INFO)
    return logger


def disable_torch_init():
    """API-parity no-op (reference: utils.py:93-99 skips torch's default
    layer init for load speed). The port builds its parameter tensors
    directly from the checkpoint's state, so there is no layer init to
    skip."""


def violates_moderation(text: str) -> bool:
    """Moderation hook. Mirrors the reference's OpenAI-endpoint check
    (reference: utils.py:102-120); returns False when no OPENAI_API_KEY
    is configured or the endpoint is unreachable."""
    key = os.environ.get("OPENAI_API_KEY")
    if not key:
        return False
    try:
        import requests

        resp = requests.post(
            "https://api.openai.com/v1/moderations",
            headers={
                "Content-Type": "application/json",
                "Authorization": f"Bearer {key}",
            },
            json={"input": text.replace("\n", "")},
            timeout=5,
        )
        return bool(resp.json()["results"][0]["flagged"])
    except Exception:
        return False


def pretty_print_semaphore(semaphore) -> str:
    if semaphore is None:
        return "None"
    return (
        f"Semaphore(value={semaphore._value},"
        f" locked={semaphore.locked()})"
    )
