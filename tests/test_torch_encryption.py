"""At-rest and field encryption of the port (``nornicdb_tpu_torch/encryption.py``
and its hooks in ``storage/wal.py``, ``storage/disk.py`` and ``db.py``)
against the JAX package's. AES-GCM nonces are random, so parity is a data
dir that one package writes under a passphrase and the other opens and
reads, on the WAL engine (``python``) and the KV engine (``native``); a
wrong or missing passphrase raises ``EncryptionError`` in both at the same
point. The key derivation is bitwise. Without the ``cryptography``
package a passphrase raises and a store without one still opens."""

import os
import sys

import pytest

import nornicdb_tpu
import nornicdb_tpu.encryption as j_enc
import nornicdb_tpu_torch
import nornicdb_tpu_torch.encryption as t_enc
from nornicdb_tpu.embed.embedder import HashEmbedder as JHash
from nornicdb_tpu_torch.embed.embedder import HashEmbedder

PASS = "correct horse battery staple"
ENGINES = ("python", "native")


def _open(pkg, d, engine, **kw):
    if pkg == "jax":
        return nornicdb_tpu.open(d, engine=engine, auto_embed=False, embedder=JHash(), **kw)
    return nornicdb_tpu_torch.open(d, device="cpu", engine=engine, auto_embed=False,
                                   embedder=HashEmbedder(), **kw)


def _write(db):
    db.store("the capital of norway is oslo", labels=["Fact"], node_id="a",
             properties={"n": 1, "tags": ["x", "y"]})
    db.store("bergen is rainy", labels=["Fact"], node_id="b")
    db.link("a", "b", "NEAR", properties={"km": 463})
    db.forget("b")
    db.store("trondheim", node_id="c")


def _read(db):
    nodes = sorted((n.id, sorted(n.labels), n.properties) for n in db.storage.all_nodes())
    edges = sorted((e.start_node, e.end_node, e.type, e.properties)
                   for e in db.storage.all_edges())
    rows = db.cypher("MATCH (n:Fact) RETURN n.content, n.n ORDER BY n.content").rows
    return nodes, edges, [list(r) for r in rows]


# -- keys ----------------------------------------------------------------------


@pytest.mark.parametrize("passphrase,salt,iters", [
    ("secret", bytes(16), 1000), (PASS, bytes(range(16)), 600_000),
    ("", b"\xff" * 16, 1), ("héllo wörld", b"saltsaltsaltsalt", 4096)])
def test_derive_key_is_bitwise_the_reference(passphrase, salt, iters):
    want = j_enc.derive_key(passphrase, salt, iters)
    got = t_enc.derive_key(passphrase, salt, iters)
    assert got == want and len(got) == 32


@pytest.mark.parametrize("maker", ["jax", "port"])
def test_salt_file_is_shared(maker, tmp_path):
    first, second = (j_enc, t_enc) if maker == "jax" else (t_enc, j_enc)
    salt = first.load_or_create_salt(str(tmp_path))
    assert second.load_or_create_salt(str(tmp_path)) == salt and len(salt) == 16
    assert t_enc.SALT_FILE == j_enc.SALT_FILE and t_enc.PBKDF2_ITERS == j_enc.PBKDF2_ITERS


# -- data dirs across packages -------------------------------------------------


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_encrypted_data_dir_opens_in_the_other_package(writer, engine, tmp_path):
    reader = "port" if writer == "jax" else "jax"
    d = str(tmp_path)
    db = _open(writer, d, engine, passphrase=PASS)
    _write(db)
    want = _read(db)
    db.close()
    # nothing readable lies on disk: the content is behind NKE1 records
    blob = b"".join(open(os.path.join(root, f), "rb").read()
                    for root, _, files in os.walk(d) for f in files)
    assert b"oslo" not in blob and b"NKE1" in blob
    db = _open(reader, d, engine, passphrase=PASS)
    try:
        assert _read(db) == want
        db.store("stavanger", node_id="s")  # the reader appends under the same key
    finally:
        db.close()
    db = _open(writer, d, engine, passphrase=PASS)
    try:
        assert db.storage.get_node("s").properties["content"] == "stavanger"
    finally:
        db.close()


def _raised(pkg, d, engine, passphrase):
    try:
        _open(pkg, d, engine, passphrase=passphrase).close()
    except Exception as exc:  # noqa: BLE001 -- the class and message are compared
        return type(exc).__name__, str(exc)
    return None


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("passphrase", ["wrong passphrase", None])
def test_wrong_or_missing_passphrase_raises_in_both(engine, passphrase, tmp_path):
    d = str(tmp_path)
    db = _open("jax", d, engine, passphrase=PASS)
    _write(db)
    db.close()
    j, t = _raised("jax", d, engine, passphrase), _raised("port", d, engine, passphrase)
    assert j is not None and j == t and j[0] == "EncryptionError"


@pytest.mark.parametrize("engine", ENGINES)
def test_replay_decrypts_the_reference_records_without_a_close(engine, tmp_path):
    """A store killed before its close snapshot: the port replays the
    encrypted log (or reads the encrypted KV records) the reference wrote."""
    d = str(tmp_path)
    db = _open("jax", d, engine, passphrase=PASS)
    _write(db)
    want = _read(db)
    db.storage.flush()
    if engine == "native":
        db.close()
    else:
        db._base.wal.close()  # no snapshot: the log alone holds the writes
    db = _open("port", d, engine, passphrase=PASS)
    try:
        assert _read(db) == want
    finally:
        db.close()


def test_encrypting_an_existing_plain_native_store_raises_in_both(tmp_path):
    d = str(tmp_path)
    db = _open("port", d, "native")
    _write(db)
    db.close()
    j, t = _raised("jax", d, "native", PASS), _raised("port", d, "native", PASS)
    assert j is not None and j == t and "unencrypted" in j[1]


# -- field encryption ----------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_field_encryption_across_packages(writer):
    key = j_enc.derive_key(PASS, bytes(16), 1000)
    a, b = j_enc.Encryptor(key), t_enc.Encryptor(key)
    enc, dec = (a, b) if writer == "jax" else (b, a)
    props = {"ssn": "123-45-6789", "name": "ada", "age": 36}
    sealed = enc.encrypt_properties(props, ["ssn", "age", "missing"])
    assert sealed["name"] == "ada" and sealed["age"] == 36
    assert t_enc.Encryptor.is_encrypted_field(sealed["ssn"])
    assert j_enc.Encryptor.is_encrypted_field(sealed["ssn"])
    assert dec.decrypt_properties(sealed) == props
    assert dec.decrypt(enc.encrypt(b"bytes", aad=b"ctx"), aad=b"ctx") == b"bytes"
    other = t_enc.Encryptor(t_enc.derive_key("other", bytes(16), 1000))
    assert other.decrypt_properties(sealed)["ssn"] == sealed["ssn"]  # wrong key: left sealed
    for e in (a, b):
        with pytest.raises(Exception) as info:
            e.decrypt_field("enc:v1:!!not base64!!")
        assert type(info.value).__name__ == "EncryptionError"


def test_encryptor_errors_match():
    for mod in (j_enc, t_enc):
        with pytest.raises(mod.EncryptionError, match="32 bytes"):
            mod.Encryptor(b"short")
        e = mod.Encryptor(bytes(32))
        with pytest.raises(mod.EncryptionError, match="too short"):
            e.decrypt(b"123")
        with pytest.raises(mod.EncryptionError, match="decryption failed"):
            e.decrypt(bytes(40))
        assert mod.make_encryptor(None, "/nonexistent") is None
        assert mod.make_encryptor("", "/nonexistent") is None


# -- without the cryptography package ------------------------------------------


def _hide_cryptography(monkeypatch):
    for name in list(sys.modules):
        if name == "cryptography" or name.startswith("cryptography."):
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "cryptography", None)
    monkeypatch.setattr(j_enc, "AESGCM", None)


@pytest.mark.parametrize("engine", ENGINES)
def test_passphrase_without_cryptography_raises_the_reference_error(engine, monkeypatch, tmp_path):
    _hide_cryptography(monkeypatch)
    j = _raised("jax", str(tmp_path / "j"), engine, PASS)
    t = _raised("port", str(tmp_path / "t"), engine, PASS)
    assert j is not None and j == t and j[0] == "EncryptionError" and "cryptography" in j[1]


def test_no_passphrase_without_cryptography_still_opens(monkeypatch, tmp_path):
    _hide_cryptography(monkeypatch)
    for engine in ENGINES:
        d = str(tmp_path / engine)
        db = _open("port", d, engine)
        _write(db)
        db.close()
        db = _open("port", d, engine)
        try:
            assert db.storage.get_node("a").properties["n"] == 1
        finally:
            db.close()
