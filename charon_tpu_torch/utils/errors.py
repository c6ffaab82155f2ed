"""Structured errors with context fields: the port's copy of
charon_tpu/utils/errors.py's CharonError and `new` (the reference's
app/errors package, errors/errors.go). An error carries its message, its
key=value context fields and an optional cause, and prints as the
reference's does: "msg: k1=v1 k2=v2: cause: ..."."""

from __future__ import annotations

from typing import Any


class CharonError(Exception):
    """Error with structured context fields and an optional wrapped cause;
    a CharonError cause's fields merge in, its values winning (closest to
    the origin)."""

    def __init__(self, msg: str, cause: BaseException | None = None, **fields: Any):
        super().__init__(msg)
        self.msg = msg
        self.cause = cause
        self.fields = dict(fields)
        if isinstance(cause, CharonError):
            self.fields.update(cause.fields)

    def __str__(self) -> str:
        parts = [self.msg]
        if self.fields:
            parts.append(" ".join(f"{k}={v!r}" for k, v in sorted(self.fields.items())))
        if self.cause is not None:
            parts.append(f"cause: {self.cause}")
        return ": ".join(parts)


def new(msg: str, **fields: Any) -> CharonError:
    return CharonError(msg, **fields)
