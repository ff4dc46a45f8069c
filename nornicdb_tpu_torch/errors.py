"""Errors the port raises where the reference would run a part that has
not been ported yet. Each names what is missing, so a store written with
that part fails loudly instead of opening with it ignored."""

from __future__ import annotations


class NotPortedError(NotImplementedError):
    """A feature of the reference that the port does not have yet."""


class EncryptedStoreError(NotPortedError):
    """A store or record encrypted at rest (the reference's ``NKE1``
    records and its native store's sentinel): at-rest encryption is not
    ported."""


class TemporalValueError(NotPortedError):
    """A tagged temporal, duration or point value (``__nornic_value__``)
    that the reference would revive into a typed value: those types are
    not ported."""
