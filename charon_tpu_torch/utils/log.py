"""Structured logging with topics, levels, and error/warn counters: the
port's copy of charon_tpu/utils/log.py (the reference's app/log,
log/log.go:78-150). Loggers are bound to a "topic" (component name), emit
structured key=value fields in console, logfmt or json format, and count
errors and warnings by topic (app/log/metrics.go).
"""

from __future__ import annotations

import json
import sys
import threading
import time
from typing import Any, TextIO

from .errors import CharonError

DEBUG, INFO, WARN, ERROR = 10, 20, 30, 40
_LEVEL_NAMES = {DEBUG: "DEBG", INFO: "INFO", WARN: "WARN", ERROR: "ERRO"}

# Error/warn counters by topic (reference app/log/metrics.go).
_counters_lock = threading.Lock()
log_error_total: dict[str, int] = {}
log_warn_total: dict[str, int] = {}

# registry metric mirroring the dicts so the metrics registry sees
# log error/warn rates (lazy import avoids a module cycle at import time)
_log_counter = None


def _count_metric(level_name: str, topic: str) -> None:
    global _log_counter
    if _log_counter is None:
        from . import metrics as _metrics

        _log_counter = _metrics.counter(
            "log_messages_total", "Warn/error log lines", ("level", "topic"))
    _log_counter.inc(level_name, topic)


class _Config:
    level: int = INFO
    fmt: str = "console"  # console | logfmt | json
    out: TextIO = sys.stderr
    topic_filter: set[str] | None = None  # None = all topics


_config = _Config()


def init(level: int = INFO, fmt: str = "console", out: TextIO | None = None,
         topics: list[str] | None = None) -> None:
    """Initialise global logging config (reference app/log/config.go)."""
    _config.level = level
    _config.fmt = fmt
    if out is not None:
        _config.out = out
    _config.topic_filter = set(topics) if topics else None


class Logger:
    """A topic-bound structured logger (reference log.WithTopic, log.go:43)."""

    def __init__(self, topic: str, **fields: Any):
        self.topic = topic
        self.fields = fields

    def with_fields(self, **fields: Any) -> "Logger":
        merged = dict(self.fields)
        merged.update(fields)
        return Logger(self.topic, **merged)

    def debug(self, msg: str, **fields: Any) -> None:
        self._emit(DEBUG, msg, None, fields)

    def info(self, msg: str, **fields: Any) -> None:
        self._emit(INFO, msg, None, fields)

    def warn(self, msg: str, err: BaseException | None = None, **fields: Any) -> None:
        with _counters_lock:
            log_warn_total[self.topic] = log_warn_total.get(self.topic, 0) + 1
        _count_metric("warn", self.topic)
        self._emit(WARN, msg, err, fields)

    def error(self, msg: str, err: BaseException | None = None, **fields: Any) -> None:
        with _counters_lock:
            log_error_total[self.topic] = log_error_total.get(self.topic, 0) + 1
        _count_metric("error", self.topic)
        self._emit(ERROR, msg, err, fields)

    def _emit(self, level: int, msg: str, err: BaseException | None,
              fields: dict[str, Any]) -> None:
        if level < _config.level:
            return
        if _config.topic_filter is not None and self.topic not in _config.topic_filter:
            return
        all_fields = dict(self.fields)
        all_fields.update(fields)
        if err is not None:
            all_fields["err"] = str(err)
            if isinstance(err, CharonError):
                all_fields.update(err.fields)
        ts = time.time()
        if _config.fmt == "json":
            rec = {"ts": ts, "level": _LEVEL_NAMES[level].strip().lower(),
                   "topic": self.topic, "msg": msg, **{k: repr(v) for k, v in all_fields.items()}}
            line = json.dumps(rec, default=str)
        elif _config.fmt == "logfmt":
            kv = " ".join(f"{k}={v!r}" for k, v in all_fields.items())
            line = f'ts={ts:.3f} level={_LEVEL_NAMES[level].strip().lower()} topic={self.topic} msg="{msg}" {kv}'.rstrip()
        else:  # console
            tstr = time.strftime("%H:%M:%S", time.localtime(ts))
            kv = " ".join(f"{{{k}: {v}}}" for k, v in all_fields.items())
            line = f"{tstr} {_LEVEL_NAMES[level]} {self.topic:<12} {msg} {kv}".rstrip()
        try:
            print(line, file=_config.out, flush=True)
        except ValueError:
            pass  # closed stream during interpreter shutdown
        for sink in _sinks:
            try:
                sink(line)
            except Exception:  # noqa: BLE001 — sinks must never break logging
                pass


# Extra line sinks. Each receives the
# fully formatted line; failures are swallowed.
_sinks: list = []


def add_sink(sink) -> None:
    _sinks.append(sink)


def remove_sink(sink) -> None:
    if sink in _sinks:
        _sinks.remove(sink)


def with_topic(topic: str, **fields: Any) -> Logger:
    return Logger(topic, **fields)
