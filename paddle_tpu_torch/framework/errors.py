"""Typed errors — counterpart of ``paddle_tpu/framework/errors.py`` (the
reference's platform/enforce.h:427 ``PADDLE_ENFORCE*`` and
error_codes.proto).

Plain Python exception classes carrying an error code, and
``enforce`` / ``enforce_eq`` / ``enforce_gt`` / ``enforce_shape`` helpers
that build the reference-style message (expected against actual, a
hint); the Python traceback is the stack.  Same classes, codes and
messages as the JAX package's.  Imports neither torch nor numpy at
module level.
"""
from __future__ import annotations

from typing import Any

__all__ = ["EnforceNotMet", "InvalidArgumentError", "NotFoundError", "check_shape",
           "OutOfRangeError", "AlreadyExistsError", "PermissionDeniedError",
           "UnimplementedError", "UnavailableError", "ResourceExhaustedError",
           "PreconditionNotMetError", "ExecutionTimeoutError", "FatalError",
           "enforce", "enforce_eq", "enforce_gt", "enforce_shape"]


class EnforceNotMet(RuntimeError):
    """Base of all typed framework errors (enforce.h EnforceNotMet)."""

    code = "LEGACY"

    def __init__(self, msg: str, hint: str = ""):
        self.hint = hint
        full = f"[{self.code}] {msg}"
        if hint:
            full += f"\n  [Hint: {hint}]"
        super().__init__(full)


class InvalidArgumentError(EnforceNotMet):
    code = "INVALID_ARGUMENT"


class NotFoundError(EnforceNotMet):
    code = "NOT_FOUND"


class OutOfRangeError(EnforceNotMet):
    code = "OUT_OF_RANGE"


class AlreadyExistsError(EnforceNotMet):
    code = "ALREADY_EXISTS"


class ResourceExhaustedError(EnforceNotMet):
    code = "RESOURCE_EXHAUSTED"


class PreconditionNotMetError(EnforceNotMet):
    code = "PRECONDITION_NOT_MET"


class PermissionDeniedError(EnforceNotMet):
    code = "PERMISSION_DENIED"


class ExecutionTimeoutError(EnforceNotMet):
    code = "EXECUTION_TIMEOUT"


class UnimplementedError(EnforceNotMet):
    code = "UNIMPLEMENTED"


class UnavailableError(EnforceNotMet):
    code = "UNAVAILABLE"


class FatalError(EnforceNotMet):
    code = "FATAL"


def enforce(cond: Any, msg: str, exc: type = InvalidArgumentError,
            hint: str = ""):
    """PADDLE_ENFORCE analog: raise ``exc`` with an enriched message when
    ``cond`` is falsy."""
    if not cond:
        raise exc(msg, hint)


def enforce_eq(a, b, what: str = "value", exc: type = InvalidArgumentError):
    """PADDLE_ENFORCE_EQ analog with expected-vs-actual in the message."""
    if a != b:
        raise exc(f"{what} mismatch: expected {b!r}, got {a!r}")


def enforce_gt(a, b, what: str = "value", exc: type = InvalidArgumentError):
    if not a > b:
        raise exc(f"{what} must be > {b!r}, got {a!r}")


def enforce_shape(x, shape, what: str = "tensor",
                  exc: type = InvalidArgumentError):
    """Shape check tolerating None wildcards in ``shape``."""
    import numpy as np

    actual = tuple(np.shape(x))
    if len(actual) != len(shape) or any(
            s is not None and s != a for s, a in zip(shape, actual)):
        raise exc(f"{what} shape mismatch: expected "
                  f"{tuple(shape)!r}, got {actual!r}")


def check_shape(shape, op_name: str = "op"):
    """Validate a shape ARGUMENT before an op consumes it (reference
    data_feeder.py:142 check_shape): a list/tuple of python ints (or
    integer arrays / tensors for runtime dims), or a 1-D integer array or
    tensor.  Raises TypeError with the op name.  An array or tensor
    counts as an integer one by its ``dtype`` attribute alone (read
    without moving the value to the host)."""

    def _is_int_tensor(v):
        dt = getattr(v, "dtype", None)
        if dt is None:
            return False
        if getattr(dt, "is_floating_point", None) is not None:  # torch
            return not (dt.is_floating_point or dt.is_complex
                        or str(dt) == "torch.bool")
        import numpy as np

        return np.issubdtype(dt, np.integer)

    if hasattr(shape, "dtype"):
        if not _is_int_tensor(shape):
            raise TypeError(
                f"The data type of 'shape' in {op_name} must be int32 or "
                f"int64 when shape is a Tensor")
        return
    if not isinstance(shape, (list, tuple)):
        raise TypeError(
            f"The type of 'shape' in {op_name} must be list, tuple or "
            f"Tensor, but received {type(shape).__name__}")
    for item in shape:
        if isinstance(item, bool) or not (
                isinstance(item, int) or _is_int_tensor(item)):
            raise TypeError(
                f"The type of element of 'shape' in {op_name} must be int "
                f"or integer Tensor, but received {type(item).__name__}")
