"""Errors of the Cypher layer, and the errors the port raises where the
reference would run a part that has not been ported yet. Each of the
latter names what is missing, so a store or a query that needs that part
fails loudly instead of running with it ignored."""

from __future__ import annotations


class CypherSyntaxError(Exception):
    """A Cypher query failed to parse."""


class CypherRuntimeError(Exception):
    """A Cypher query failed during execution."""


class ConstraintViolationError(Exception):
    """A write that breaks a schema constraint (``storage/schema.py``)."""


class NotPortedError(NotImplementedError):
    """A feature of the reference that the port does not have yet."""



class DeadlineExceeded(RuntimeError):
    """The request's deadline budget expired before (or while) it
    queued for dispatch — failed fast instead of occupying a device
    slot it can no longer use (``admission.DeadlineExceeded``: the
    class lives here so the sites below can test for it without
    importing the admission layer)."""

    status = 504


class EmbedHTTPError(RuntimeError):
    """A remote embedding or generation backend's request failed after
    its retries (the reference's ``embed/http_providers.EmbedHTTPError``)."""


def is_device_fault(exc: BaseException) -> bool:
    """True for an error the port never hides behind a fallback, a count
    or a fail-open (ROADMAP C29-C31): a ``RuntimeError`` — CUDA errors,
    ``torch.OutOfMemoryError``, ``NotPortedError`` — other than a
    ``DeadlineExceeded``, which is a request's budget running out, and an
    ``EmbedHTTPError``, which is a remote backend failing; both are
    counted, swallowed or failed open wherever the reference does."""
    return isinstance(exc, RuntimeError) and not isinstance(
        exc, (DeadlineExceeded, EmbedHTTPError))
