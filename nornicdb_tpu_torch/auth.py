"""Authentication & authorization: users, roles, privileges, JWTs,
per-database access control (counterpart of ``nornicdb_tpu/auth.py``;
the same tokens byte for byte, the same hashes and verdicts).

Reference: pkg/auth (auth.go JWT auth; roles.go users/roles/privileges/
entitlements; database_access.go per-database access control; auth
cache). JWTs are HS256, implemented over stdlib hmac/hashlib — no
external jwt dependency.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import secrets
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set


class AuthError(Exception):
    pass


class PermissionDenied(AuthError):
    pass


# -- password hashing (PBKDF2, matching the reference's KDF choice) ---------

PBKDF2_ITERS = 600_000  # reference: pkg/encryption PBKDF2 600k iters


def hash_password(password: str, salt: Optional[bytes] = None,
                  iterations: int = PBKDF2_ITERS) -> str:
    salt = salt or secrets.token_bytes(16)
    dk = hashlib.pbkdf2_hmac("sha256", password.encode(), salt, iterations)
    return f"pbkdf2${iterations}${salt.hex()}${dk.hex()}"


def check_password(password: str, stored: str) -> bool:
    try:
        _, iters, salt_hex, dk_hex = stored.split("$")
        dk = hashlib.pbkdf2_hmac("sha256", password.encode(),
                                 bytes.fromhex(salt_hex), int(iters))
        return hmac.compare_digest(dk.hex(), dk_hex)
    except (ValueError, TypeError):
        return False


# -- JWT (HS256) ------------------------------------------------------------


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64url(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def jwt_encode(claims: Dict[str, Any], secret: str) -> str:
    header = _b64url(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    payload = _b64url(json.dumps(claims, separators=(",", ":")).encode())
    signing_input = f"{header}.{payload}".encode()
    sig = hmac.new(secret.encode(), signing_input, hashlib.sha256).digest()
    return f"{header}.{payload}.{_b64url(sig)}"


def jwt_decode(token: str, secret: str, verify_exp: bool = True) -> Dict[str, Any]:
    try:
        header, payload, sig = token.split(".")
    except ValueError:
        raise AuthError("malformed token")
    signing_input = f"{header}.{payload}".encode()
    want = hmac.new(secret.encode(), signing_input, hashlib.sha256).digest()
    if not hmac.compare_digest(want, _unb64url(sig)):
        raise AuthError("bad signature")
    claims = json.loads(_unb64url(payload))
    if verify_exp and "exp" in claims and time.time() > claims["exp"]:
        raise AuthError("token expired")
    return claims


# -- roles & privileges ------------------------------------------------------

# privilege verbs (reference: roles.go privileges/entitlements)
READ = "read"
WRITE = "write"
ADMIN = "admin"
SCHEMA = "schema"

BUILTIN_ROLES: Dict[str, Set[str]] = {
    "admin": {READ, WRITE, ADMIN, SCHEMA},
    "architect": {READ, WRITE, SCHEMA},
    "editor": {READ, WRITE},
    "publisher": {READ, WRITE},
    "reader": {READ},
}


@dataclass
class User:
    username: str
    password_hash: str
    roles: List[str] = field(default_factory=lambda: ["reader"])
    # per-database grants: db -> set of privileges; "*" db = all
    database_access: Dict[str, Set[str]] = field(default_factory=dict)
    suspended: bool = False

    def privileges(self, custom_roles: Dict[str, Set[str]]) -> Set[str]:
        out: Set[str] = set()
        for r in self.roles:
            out |= custom_roles.get(r, BUILTIN_ROLES.get(r, set()))
        return out


class Authenticator:
    """User store + token issuing + per-database RBAC checks."""

    def __init__(self, jwt_secret: Optional[str] = None,
                 token_ttl_seconds: int = 3600,
                 allow_anonymous_reads: bool = False):
        self.jwt_secret = jwt_secret or secrets.token_hex(32)
        self.token_ttl = token_ttl_seconds
        self.allow_anonymous_reads = allow_anonymous_reads
        self._users: Dict[str, User] = {}
        self._roles: Dict[str, Set[str]] = {}
        self._lock = threading.Lock()
        # auth cache: token -> (claims, expiry) (reference: auth cache)
        self._cache: Dict[str, Dict[str, Any]] = {}

    # -- user management -------------------------------------------------

    def create_user(self, username: str, password: str,
                    roles: Optional[List[str]] = None) -> User:
        with self._lock:
            if username in self._users:
                raise AuthError(f"user exists: {username}")
            u = User(username=username, password_hash=hash_password(password),
                     roles=list(roles or ["reader"]))
            self._users[username] = u
            return u

    def delete_user(self, username: str) -> bool:
        with self._lock:
            return self._users.pop(username, None) is not None

    def set_password(self, username: str, password: str) -> None:
        u = self._get_user(username)
        u.password_hash = hash_password(password)

    def suspend_user(self, username: str, suspended: bool = True) -> None:
        self._get_user(username).suspended = suspended

    def _get_user(self, username: str) -> User:
        with self._lock:
            u = self._users.get(username)
        if u is None:
            raise AuthError(f"user not found: {username}")
        return u

    def list_users(self) -> List[str]:
        with self._lock:
            return sorted(self._users)

    # -- roles -----------------------------------------------------------

    def create_role(self, name: str, privileges: Set[str]) -> None:
        with self._lock:
            self._roles[name] = set(privileges)

    def grant_role(self, username: str, role: str) -> None:
        u = self._get_user(username)
        if role not in u.roles:
            u.roles.append(role)

    def revoke_role(self, username: str, role: str) -> None:
        u = self._get_user(username)
        if role in u.roles:
            u.roles.remove(role)

    def grant_database_access(self, username: str, database: str,
                              privileges: Set[str]) -> None:
        u = self._get_user(username)
        u.database_access.setdefault(database, set()).update(privileges)

    def revoke_database_access(self, username: str, database: str) -> None:
        u = self._get_user(username)
        u.database_access.pop(database, None)

    # -- authentication --------------------------------------------------

    def login(self, username: str, password: str) -> str:
        """Verify credentials, return a JWT."""
        u = self._get_user(username)
        if u.suspended:
            raise AuthError("user suspended")
        if not check_password(password, u.password_hash):
            raise AuthError("invalid credentials")
        now = int(time.time())
        claims = {"sub": username, "roles": u.roles, "iat": now,
                  "exp": now + self.token_ttl, "jti": secrets.token_hex(8)}
        return jwt_encode(claims, self.jwt_secret)

    def verify_token(self, token: str) -> Dict[str, Any]:
        cached = self._cache.get(token)
        if cached is not None and time.time() < cached.get("exp", 0):
            claims = cached  # signature/exp already checked
        else:
            claims = jwt_decode(token, self.jwt_secret)
            with self._lock:
                if len(self._cache) > 10_000:
                    self._cache.clear()
                self._cache[token] = claims
        # user status is always re-checked — a cached token must not
        # outlive suspension or deletion
        u = self._get_user(claims.get("sub", ""))
        if u.suspended:
            raise AuthError("user suspended")
        return claims

    # -- authorization ---------------------------------------------------

    def check(self, username: Optional[str], database: str, privilege: str) -> None:
        """Raise PermissionDenied unless the user may do ``privilege`` on
        ``database`` (reference: database_access.go AllowDatabaseAccess)."""
        if username is None:
            if self.allow_anonymous_reads and privilege == READ:
                return
            raise PermissionDenied("authentication required")
        u = self._get_user(username)
        if u.suspended:
            raise PermissionDenied("user suspended")
        with self._lock:
            roles = dict(self._roles)
        privs = u.privileges(roles)
        if ADMIN in privs:
            return
        if u.database_access:
            # per-db grants are authoritative: a listed database allows
            # exactly its granted privileges (a READ-only grant really is
            # read-only even for a WRITE-capable role), and unlisted
            # databases are fenced off entirely
            if database in u.database_access:
                if privilege in u.database_access[database]:
                    return
                raise PermissionDenied(
                    f"privilege {privilege!r} not granted on {database!r}")
            if "*" in u.database_access:
                if privilege in u.database_access["*"]:
                    return
                raise PermissionDenied(
                    f"privilege {privilege!r} not granted on {database!r}")
            raise PermissionDenied(f"no access to database {database!r}")
        if privilege in privs:
            return
        raise PermissionDenied(f"privilege {privilege!r} required")

    def allowed(self, username: Optional[str], database: str, privilege: str) -> bool:
        try:
            self.check(username, database, privilege)
            return True
        except (PermissionDenied, AuthError):
            # unknown/deleted user is a denial, not a crash
            return False


def bootstrap_admin(auth: Authenticator, username: str = "neo4j",
                    password: str = "") -> str:
    """Create the initial admin user (reference: default neo4j admin).
    Returns the password (generated when empty)."""
    password = password or secrets.token_urlsafe(12)
    auth.create_user(username, password, roles=["admin"])
    return password
