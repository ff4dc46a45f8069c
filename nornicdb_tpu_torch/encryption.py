"""At-rest and field-level encryption (counterpart of
``nornicdb_tpu/encryption.py``; the same keys, salt file and record
bytes, so a store either package encrypts opens in the other).

AES-256-GCM with PBKDF2-SHA256 keys (600,000 iterations, a random salt
kept beside the data dir), and field-level property encryption. The
``cryptography`` package is imported only when an ``Encryptor`` is
built, that is only under a passphrase: every store without one opens
on a build that lacks it, and a passphrase there raises
``EncryptionError``.
"""

from __future__ import annotations

import base64
import binascii
import hashlib
import os
import secrets
from typing import Any, Dict, Iterable, Optional

PBKDF2_ITERS = 600_000
SALT_FILE = "encryption.salt"
_PREFIX = "enc:v1:"


class EncryptionError(Exception):
    pass


def derive_key(passphrase: str, salt: bytes,
               iterations: int = PBKDF2_ITERS) -> bytes:
    """PBKDF2-SHA256 -> 32-byte AES-256 key."""
    return hashlib.pbkdf2_hmac("sha256", passphrase.encode(), salt, iterations, 32)


def load_or_create_salt(data_dir: str) -> bytes:
    """The salt file kept in the data dir, made on first use."""
    os.makedirs(data_dir, exist_ok=True)
    path = os.path.join(data_dir, SALT_FILE)
    if os.path.exists(path):
        with open(path, "rb") as f:
            salt = f.read()
        if len(salt) != 16:
            raise EncryptionError(f"corrupt salt file: {path}")
        return salt
    salt = secrets.token_bytes(16)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(salt)
    os.replace(tmp, path)
    return salt


class Encryptor:
    """AES-256-GCM encrypt/decrypt for byte payloads and node property
    fields."""

    def __init__(self, key: bytes):
        if len(key) != 32:
            raise EncryptionError("key must be 32 bytes (AES-256)")
        try:
            from cryptography.hazmat.primitives.ciphers.aead import AESGCM
        except ImportError:
            raise EncryptionError(
                "the 'cryptography' package is not available in this "
                "build; encrypted stores cannot be opened") from None
        self._aead = AESGCM(key)

    @classmethod
    def from_passphrase(cls, passphrase: str, data_dir: str,
                        iterations: int = PBKDF2_ITERS) -> "Encryptor":
        salt = load_or_create_salt(data_dir)
        return cls(derive_key(passphrase, salt, iterations))

    # -- bytes -----------------------------------------------------------

    def encrypt(self, plaintext: bytes, aad: bytes = b"") -> bytes:
        nonce = secrets.token_bytes(12)
        return nonce + self._aead.encrypt(nonce, plaintext, aad or None)

    def decrypt(self, blob: bytes, aad: bytes = b"") -> bytes:
        if len(blob) < 13:
            raise EncryptionError("ciphertext too short")
        try:
            return self._aead.decrypt(blob[:12], blob[12:], aad or None)
        except Exception as e:
            raise EncryptionError("decryption failed") from e

    # -- field-level -----------------------------------------------------

    def encrypt_field(self, value: str) -> str:
        blob = self.encrypt(value.encode())
        return _PREFIX + base64.b64encode(blob).decode()

    def decrypt_field(self, value: str) -> str:
        if not value.startswith(_PREFIX):
            return value
        try:
            blob = base64.b64decode(value[len(_PREFIX):], validate=True)
        except (ValueError, binascii.Error) as e:
            raise EncryptionError("malformed ciphertext encoding") from e
        return self.decrypt(blob).decode("utf-8", errors="replace")

    @staticmethod
    def is_encrypted_field(value: Any) -> bool:
        return isinstance(value, str) and value.startswith(_PREFIX)

    def encrypt_properties(self, props: Dict[str, Any],
                           fields: Iterable[str]) -> Dict[str, Any]:
        """Encrypt the named string fields in-place-style (returns a new
        dict); non-string/missing fields pass through untouched."""
        out = dict(props)
        for f in fields:
            v = out.get(f)
            if isinstance(v, str) and not self.is_encrypted_field(v):
                out[f] = self.encrypt_field(v)
        return out

    def decrypt_properties(self, props: Dict[str, Any]) -> Dict[str, Any]:
        out = dict(props)
        for k, v in out.items():
            if self.is_encrypted_field(v):
                try:
                    out[k] = self.decrypt_field(v)
                except EncryptionError:
                    pass  # wrong key: leave ciphertext visible, don't crash
        return out


def make_encryptor(passphrase: Optional[str], data_dir: str,
                   iterations: int = PBKDF2_ITERS) -> Optional[Encryptor]:
    if not passphrase:
        return None
    return Encryptor.from_passphrase(passphrase, data_dir, iterations)
