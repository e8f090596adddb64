"""Chainable authenticators — the ``emqx_authn`` analog.

The port's own copy of the reference's ``emqx_tpu/auth/authn.py``
(nothing here imports the JAX package).

Behavioral reference: ``apps/emqx_authn`` [U] (SURVEY.md §2.3): an
ordered chain where each authenticator returns **ok** (authenticated,
possibly with attrs like ``is_superuser``), **deny**, or **ignore**
(not my user — next in chain).  An empty/ignoring chain falls back to
the ``allow_anonymous`` policy.

Password hashing mirrors the reference's built-in-database options:
``plain``, ``sha256``/``sha512`` with configurable salt position,
``pbkdf2`` (sha256, configurable iterations), and ``bcrypt`` when the
optional C library is importable (gated, never required — SURVEY.md §2.4
native-dep substitution note).

JWT is HS256/HS384/HS512 compact JWS verified with :mod:`hmac` — no
external dependency — checking ``exp``/``nbf`` and optional required
claims (``%c``/``%u`` placeholder matching like the reference).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "Credentials", "AuthResult", "AuthChain",
    "BuiltinDbAuthenticator", "JwtAuthenticator", "hash_password",
]


@dataclass
class Credentials:
    clientid: str
    username: Optional[str] = None
    password: Optional[bytes] = None
    peerhost: Optional[str] = None


@dataclass
class AuthResult:
    outcome: str                      # 'ok' | 'deny' | 'ignore'
    is_superuser: bool = False
    attrs: Dict[str, Any] = field(default_factory=dict)


OK = AuthResult("ok")
DENY = AuthResult("deny")
IGNORE = AuthResult("ignore")


# ---------------------------------------------------------------------------
# password hashing (built-in database)

def hash_password(
    password: bytes,
    algo: str = "sha256",
    salt: bytes = b"",
    salt_position: str = "prefix",      # prefix | suffix | disable
    iterations: int = 4096,
) -> str:
    """Hex digest in the reference's built-in-db format."""
    if algo == "plain":
        return password.decode("utf-8", "surrogateescape")
    if algo in ("sha256", "sha512", "md5", "sha"):
        name = {"sha": "sha1"}.get(algo, algo)
        if salt_position == "prefix":
            data = salt + password
        elif salt_position == "suffix":
            data = password + salt
        else:
            data = password
        return hashlib.new(name, data).hexdigest()
    if algo == "pbkdf2":
        return hashlib.pbkdf2_hmac("sha256", password, salt, iterations).hex()
    if algo == "bcrypt":
        try:
            import bcrypt  # optional C dep; gated per SURVEY.md §2.4
        except ImportError as e:
            raise RuntimeError("bcrypt not available in this build") from e
        return bcrypt.hashpw(password, salt or bcrypt.gensalt()).decode()
    raise ValueError(f"unknown hash algo {algo!r}")


def _verify_password(
    stored: str, given: bytes, algo: str, salt: bytes,
    salt_position: str, iterations: int,
) -> bool:
    if algo == "bcrypt":
        try:
            import bcrypt
        except ImportError:
            return False
        try:
            return bcrypt.checkpw(given, stored.encode())
        except ValueError:
            return False
    calc = hash_password(given, algo, salt, salt_position, iterations)
    return hmac.compare_digest(calc, stored)


@dataclass
class _UserRecord:
    password_hash: str
    salt: bytes = b""
    is_superuser: bool = False


class BuiltinDbAuthenticator:
    """The mnesia built-in-database authenticator analog: user records
    keyed by username or clientid."""

    def __init__(
        self,
        user_id_type: str = "username",        # username | clientid
        algo: str = "sha256",
        salt_position: str = "prefix",
        iterations: int = 4096,
    ) -> None:
        if user_id_type not in ("username", "clientid"):
            raise ValueError(user_id_type)
        self.user_id_type = user_id_type
        self.algo = algo
        self.salt_position = salt_position
        self.iterations = iterations
        self._users: Dict[str, _UserRecord] = {}

    def add_user(
        self, user_id: str, password: bytes,
        is_superuser: bool = False, salt: Optional[bytes] = None,
    ) -> None:
        if salt is None:
            # bcrypt embeds its own salt (gensalt inside hash_password);
            # a random byte salt would be rejected by bcrypt.hashpw
            salt = b"" if self.algo == "bcrypt" else os.urandom(8)
        self._users[user_id] = _UserRecord(
            hash_password(password, self.algo, salt, self.salt_position,
                          self.iterations),
            salt, is_superuser,
        )

    def add_user_hashed(self, user_id: str, password_hash: str,
                        salt: str = "", is_superuser: bool = False) -> None:
        """Restore a user from its stored (hash, salt) — backup/import
        round-trips records without ever persisting the plaintext.
        Salt strings use latin-1 (the byte-transparent codec
        export_user encodes with — UTF-8 would mangle bytes >= 0x80)."""
        s = salt.encode("latin-1") if isinstance(salt, str) else (salt
                                                                  or b"")
        self._users[user_id] = _UserRecord(password_hash, s, is_superuser)

    def export_user(self, user_id: str) -> Optional[Dict[str, Any]]:
        rec = self._users.get(user_id)
        if rec is None:
            return None
        return {"user_id": user_id, "password_hash": rec.password_hash,
                "salt": rec.salt.decode("latin-1"),
                "is_superuser": rec.is_superuser}

    def delete_user(self, user_id: str) -> bool:
        return self._users.pop(user_id, None) is not None

    def users(self) -> List[str]:
        return list(self._users)

    def authenticate(self, creds: Credentials) -> AuthResult:
        uid = creds.username if self.user_id_type == "username" else creds.clientid
        if uid is None:
            return IGNORE
        rec = self._users.get(uid)
        if rec is None:
            return IGNORE   # not my user — next authenticator decides
        if creds.password is None:
            return DENY
        if _verify_password(
            rec.password_hash, creds.password, self.algo, rec.salt,
            self.salt_position, self.iterations,
        ):
            return AuthResult("ok", is_superuser=rec.is_superuser)
        return DENY


# ---------------------------------------------------------------------------
# JWT (HS*)

def _b64url_decode(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


class JwtAuthenticator:
    """HS256/384/512 JWT in the password field (the reference's default
    ``from: password``)."""

    _ALGOS = {"HS256": "sha256", "HS384": "sha384", "HS512": "sha512"}

    def __init__(
        self,
        secret: bytes,
        verify_claims: Optional[Dict[str, str]] = None,  # claim -> expected ('%c','%u' ok)
        acl_claim_name: str = "acl",
    ) -> None:
        self.secret = secret
        self.verify_claims = verify_claims or {}
        self.acl_claim_name = acl_claim_name

    def authenticate(self, creds: Credentials) -> AuthResult:
        token = (creds.password or b"").decode("ascii", "ignore")
        if token.count(".") != 2:
            return IGNORE
        head_b64, body_b64, sig_b64 = token.split(".")
        try:
            header = json.loads(_b64url_decode(head_b64))
            claims = json.loads(_b64url_decode(body_b64))
            sig = _b64url_decode(sig_b64)
        except (ValueError, json.JSONDecodeError):
            return IGNORE
        if not isinstance(header, dict) or not isinstance(claims, dict):
            return IGNORE  # JWT spec requires JSON objects; don't crash
        digest = self._ALGOS.get(header.get("alg"))
        if digest is None:
            return IGNORE
        want = hmac.new(
            self.secret, f"{head_b64}.{body_b64}".encode(), digest
        ).digest()
        if not hmac.compare_digest(want, sig):
            return DENY
        now = time.time()
        if "exp" in claims and now >= float(claims["exp"]):
            return DENY
        if "nbf" in claims and now < float(claims["nbf"]):
            return DENY
        for claim, expect in self.verify_claims.items():
            expect = expect.replace("%c", creds.clientid).replace(
                "%u", creds.username or ""
            )
            if str(claims.get(claim)) != expect:
                return DENY
        attrs: Dict[str, Any] = {}
        if self.acl_claim_name in claims:
            attrs["acl"] = claims[self.acl_claim_name]
        return AuthResult(
            "ok", is_superuser=bool(claims.get("is_superuser")), attrs=attrs
        )


# ---------------------------------------------------------------------------
# the chain

class AuthChain:
    """Ordered authenticator chain.

    ``allow_anonymous=None`` (the default) is *auto*: an empty chain
    admits everyone (an unconfigured broker is open, matching the
    reference's out-of-the-box behavior), but the moment the chain has
    at least one authenticator, exhausting it without a verdict DENIES.
    The reference rejects a client when a configured chain yields no
    verdict; admitting unknown users — and everyone during a backend
    outage, since network authenticators return *ignore* on outage —
    would silently void the operator's auth config.  An explicit
    ``allow_anonymous=True`` (conf key ``authn.allow_anonymous``)
    remains the opt-out.
    """

    def __init__(self, allow_anonymous: Optional[bool] = None) -> None:
        self.allow_anonymous = allow_anonymous
        self._chain: List[Any] = []

    def add(self, authenticator: Any) -> "AuthChain":
        self._chain.append(authenticator)
        return self

    def remove(self, authenticator: Any) -> bool:
        try:
            self._chain.remove(authenticator)
            return True
        except ValueError:
            return False

    def authenticate(self, creds: Credentials) -> AuthResult:
        for a in self._chain:
            res = a.authenticate(creds)
            if res.outcome != "ignore":
                return res
        allow = self.allow_anonymous
        if allow is None:  # auto: open only while no authenticator exists
            allow = not self._chain
        if allow:
            return AuthResult("ok", attrs={"anonymous": not self._chain})
        return DENY
