"""Structured logging setup.

Reference parity: ``internal/logger/logger.go:16-76`` — slog text/json
handlers with source-path trimming and a package-level log level. Python
idiom: stdlib ``logging`` with a compact text formatter or a JSON formatter.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import IO

_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "error": logging.ERROR,
}


class JSONFormatter(logging.Formatter):
    """RFC3339 UTC timestamps with millisecond precision, plus the
    thread name — a JSON log line must be correlatable with the
    telemetry plane's traces (/debug/traces anchors are wall-clock) and
    with logs from other nodes, which second-granularity localtime with
    no offset made impossible."""

    def format(self, record: logging.LogRecord) -> str:
        payload = {
            "time": "%s.%03dZ" % (
                time.strftime("%Y-%m-%dT%H:%M:%S",
                              time.gmtime(record.created)),
                int(record.msecs),
            ),
            "level": record.levelname,
            "logger": record.name,
            "thread": record.threadName,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            payload["exc"] = self.formatException(record.exc_info)
        return json.dumps(payload)


class TextFormatter(logging.Formatter):
    def __init__(self) -> None:
        super().__init__(
            fmt="%(asctime)s %(levelname)-5s %(name)s %(message)s",
            datefmt="%H:%M:%S",
        )


def new_logger(
    level: str = "info",
    fmt: str = "text",
    stream: IO[str] | None = None,
) -> logging.Logger:
    """Configure and return the root ``kepler`` logger.

    ``stream`` defaults to stdout; the stdout exporter reroutes logs to stderr
    (reference ``cmd/kepler/main.go:34-38``).
    """
    if level not in _LEVELS:
        raise ValueError(f"invalid log level {level!r}")
    if fmt not in ("text", "json"):
        raise ValueError(f"invalid log format {fmt!r}")
    logger = logging.getLogger("kepler")
    logger.setLevel(_LEVELS[level])
    logger.handlers.clear()
    handler = logging.StreamHandler(stream or sys.stdout)
    handler.setFormatter(JSONFormatter() if fmt == "json" else TextFormatter())
    logger.addHandler(handler)
    logger.propagate = False
    return logger
