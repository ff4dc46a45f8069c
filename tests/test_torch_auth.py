"""The port's authentication and authorization (``nornicdb_tpu_torch/auth.py``)
against the JAX package's: JWTs are deterministic HMAC-SHA256, so a token
either package mints from the same claims and secret is byte for byte the
other's and verifies in it; password hashes with a given salt are equal;
and the privilege checks give the same verdicts for every user, database
and privilege."""

import itertools
import types

import pytest

import nornicdb_tpu.auth as j_auth
import nornicdb_tpu_torch.auth as t_auth

JAX = types.SimpleNamespace(name="jax", auth=j_auth)
PORT = types.SimpleNamespace(name="port", auth=t_auth)

CLAIMS = [
    {"sub": "ada", "roles": ["admin"], "iat": 1_700_000_000, "exp": 4_000_000_000, "jti": "ab12"},
    {"sub": "bob"},
    {"sub": "ünïcode", "nested": {"a": [1, 2.5, None, True]}, "exp": 4_000_000_000},
]


@pytest.mark.parametrize("claims", CLAIMS)
@pytest.mark.parametrize("secret", ["s3cret", "", "x" * 64])
def test_tokens_are_byte_equal_and_verify_across_packages(claims, secret):
    tj = j_auth.jwt_encode(claims, secret)
    tt = t_auth.jwt_encode(claims, secret)
    assert tt == tj
    assert t_auth.jwt_decode(tj, secret) == j_auth.jwt_decode(tt, secret) == claims


def _decode_error(mod, token, secret, **kw):
    with pytest.raises(mod.AuthError) as info:
        mod.jwt_decode(token, secret, **kw)
    return str(info.value)


def test_token_errors_match():
    good = j_auth.jwt_encode({"sub": "a", "exp": 1}, "k")
    cases = [("not.a", "k", {}), (good, "other", {}), (good, "k", {}),
             (good[:-2] + "xx", "k", {})]
    for token, secret, kw in cases:
        assert _decode_error(t_auth, token, secret, **kw) == _decode_error(j_auth, token, secret, **kw)
    # an expired token still decodes without the expiry check
    assert t_auth.jwt_decode(good, "k", verify_exp=False) == {"sub": "a", "exp": 1}


@pytest.mark.parametrize("password,salt,iters", [
    ("pw", bytes(16), 1000), ("hunter2", b"0123456789abcdef", 600_000), ("", b"\x01" * 16, 7)])
def test_password_hashes_with_a_salt_are_equal(password, salt, iters):
    hj = j_auth.hash_password(password, salt, iters)
    ht = t_auth.hash_password(password, salt, iters)
    assert ht == hj
    assert t_auth.check_password(password, hj) and j_auth.check_password(password, ht)
    assert not t_auth.check_password(password + "x", hj)
    assert t_auth.check_password("x", "garbage") is j_auth.check_password("x", "garbage") is False


def _authenticator(side):
    a = side.auth.Authenticator(jwt_secret="fixed")
    side.auth.bootstrap_admin(a, "root", "rootpw")
    a.create_user("reader", "r", roles=["reader"])
    a.create_user("editor", "e", roles=["editor"])
    a.create_user("scoped", "s", roles=["editor"])
    a.grant_database_access("scoped", "tenant1", {side.auth.READ})
    a.grant_database_access("scoped", "*", {side.auth.READ, side.auth.WRITE})
    a.create_user("fenced", "f", roles=["editor"])
    a.grant_database_access("fenced", "tenant1", {side.auth.WRITE})
    a.create_role("auditor", {side.auth.READ, side.auth.SCHEMA})
    a.create_user("aud", "a", roles=["auditor"])
    a.create_user("gone", "g")
    a.suspend_user("gone")
    return a


def _verdicts(side, anonymous_reads):
    a = _authenticator(side)
    a.allow_anonymous_reads = anonymous_reads
    users = [None, "root", "reader", "editor", "scoped", "fenced", "aud", "gone", "nobody"]
    out = {}
    for user, db, priv in itertools.product(
            users, ["neo4j", "tenant1", "system"],
            [side.auth.READ, side.auth.WRITE, side.auth.ADMIN, side.auth.SCHEMA]):
        try:
            a.check(user, db, priv)
            out[(user, db, priv)] = "ok"
        except side.auth.AuthError as exc:
            out[(user, db, priv)] = f"{type(exc).__name__}: {exc}"
        assert a.allowed(user, db, priv) == (out[(user, db, priv)] == "ok")
    return out


@pytest.mark.parametrize("anonymous_reads", [False, True])
def test_privilege_verdicts_match(anonymous_reads):
    j, t = _verdicts(JAX, anonymous_reads), _verdicts(PORT, anonymous_reads)
    assert t == j
    assert t[("root", "system", "admin")] == "ok"
    assert t[("scoped", "tenant1", "write")].startswith("PermissionDenied")
    assert (t[(None, "neo4j", "read")] == "ok") is anonymous_reads


def _session(side):
    a = _authenticator(side)
    out = []
    token = a.login("reader", "r")
    claims = a.verify_token(token)
    out.append({k: claims[k] for k in ("sub", "roles")})
    out.append(sorted(a.list_users()))
    for user, pw in [("reader", "bad"), ("gone", "g"), ("nobody", "x")]:
        try:
            a.login(user, pw)
            out.append("ok")
        except side.auth.AuthError as exc:
            out.append(str(exc))
    a.suspend_user("reader")
    try:
        a.verify_token(token)  # a cached token does not outlive suspension
        out.append("ok")
    except side.auth.AuthError as exc:
        out.append(str(exc))
    a.suspend_user("reader", False)
    a.set_password("reader", "new")
    out.append(a.login("reader", "new").count("."))
    a.grant_role("reader", "editor")
    a.revoke_role("reader", "reader")
    out.append(a._users["reader"].roles)
    out.append(a.delete_user("reader"))
    out.append(a.delete_user("reader"))
    try:
        a.create_user("root", "x")
    except side.auth.AuthError as exc:
        out.append(str(exc))
    return out


def test_user_lifecycle_matches():
    assert _session(PORT) == _session(JAX)


def test_a_port_login_token_verifies_in_the_reference():
    aj, at = _authenticator(JAX), _authenticator(PORT)
    token = at.login("editor", "e")
    assert aj.verify_token(token)["sub"] == "editor"
    assert at.verify_token(aj.login("root", "rootpw"))["roles"] == ["admin"]
