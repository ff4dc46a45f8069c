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


class EncryptedStoreError(NotPortedError):
    """A store or record encrypted at rest (the reference's ``NKE1``
    records and its native store's sentinel): at-rest encryption is not
    ported."""

