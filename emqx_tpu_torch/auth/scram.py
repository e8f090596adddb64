"""SCRAM-SHA-256 enhanced authentication (MQTT 5 AUTH exchange).

The port's own copy of the reference's ``emqx_tpu/auth/scram.py``
(nothing here imports the JAX package).

Behavioral reference: the reference's SCRAM authenticator
(``apps/emqx_authn/.../scram`` [U], SURVEY.md §2.3) rides MQTT 5
enhanced auth: CONNECT carries ``Authentication-Method =
"SCRAM-SHA-256"`` + the RFC 5802 client-first message, the server
challenges with AUTH (0x18 Continue) carrying server-first, the client
answers with client-final, and CONNACK carries server-final (the server
signature, so the CLIENT authenticates the server too).

Wire messages are RFC 5802/7677; the user store keeps only
``(salt, StoredKey, ServerKey, iterations)`` — never the password.
Channel binding is ``n`` (none) — MQTT's TLS layer is independent.
Usernames and passwords go through RFC 4013 SASLprep (round 5) on
both sides, so visually-identical Unicode credentials hash the same
bytes everywhere (Mongo/PostgreSQL clients share these helpers).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import os
import secrets
from typing import Any, Dict, Optional, Tuple

__all__ = ["ScramAuthenticator", "saslprep", "saslprep_bytes",
           "saslprep_or_raw", "scram_client_first", "scram_client_final"]


def saslprep(s: str) -> str:
    """RFC 4013 SASLprep (stored-string profile of stringprep): the
    normalization RFC 5802 requires for SCRAM usernames and passwords.
    Pure stdlib (``stringprep`` tables + NFKC).  Raises ``ValueError``
    on prohibited output — better a loud auth failure than two peers
    silently hashing different bytes for the same visible string."""
    import stringprep
    import unicodedata

    if not s:
        return s
    # 2.1 mapping: map-to-space for non-ASCII spaces, map-to-nothing
    out = []
    for ch in s:
        if stringprep.in_table_c12(ch):
            out.append(" ")
        elif not stringprep.in_table_b1(ch):
            out.append(ch)
    s = unicodedata.normalize("NFKC", "".join(out))    # 2.2 NFKC
    if not s:
        return s
    # 2.3 prohibited output + 2.5 unassigned code points (table A.1:
    # a later Unicode version could give them NFKC mappings, silently
    # changing stored lookup keys across upgrades)
    for ch in s:
        if (stringprep.in_table_c12(ch) or stringprep.in_table_c21_c22(ch)
                or stringprep.in_table_c3(ch) or stringprep.in_table_c4(ch)
                or stringprep.in_table_c5(ch) or stringprep.in_table_c6(ch)
                or stringprep.in_table_c7(ch) or stringprep.in_table_c8(ch)
                or stringprep.in_table_c9(ch)
                or stringprep.in_table_a1(ch)):
            raise ValueError(f"saslprep: prohibited character {ch!r}")
    # 2.4 bidi: if any RandALCat, no LCat allowed and first+last RandAL
    if any(stringprep.in_table_d1(ch) for ch in s):
        if any(stringprep.in_table_d2(ch) for ch in s):
            raise ValueError("saslprep: mixed RandAL and L characters")
        if not (stringprep.in_table_d1(s[0])
                and stringprep.in_table_d1(s[-1])):
            raise ValueError("saslprep: RandAL string must start and "
                             "end with RandAL characters")
    return s


def saslprep_or_raw(s: str) -> str:
    """SASLprep with the libpq-style fallback: on prohibited output the
    ORIGINAL string is used as opaque data (a pre-SASLprep deployment's
    control-character credential keeps authenticating; a prepped peer
    simply won't match it)."""
    try:
        return saslprep(s)
    except ValueError:
        return s


def saslprep_bytes(b: bytes) -> bytes:
    """SASLprep over UTF-8 bytes (password surfaces carry bytes);
    non-UTF-8 input — and prohibited output, libpq-style — passes
    through unchanged as an opaque octet string."""
    try:
        return saslprep_or_raw(b.decode("utf-8")).encode("utf-8")
    except UnicodeDecodeError:
        return b


def _hi(password: bytes, salt: bytes, iterations: int) -> bytes:
    return hashlib.pbkdf2_hmac("sha256", password, salt, iterations)


def _hmac(key: bytes, msg: bytes) -> bytes:
    return hmac.new(key, msg, "sha256").digest()


def _h(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def _parse_attrs(msg: str) -> Dict[str, str]:
    out = {}
    for part in msg.split(","):
        if len(part) >= 2 and part[1] == "=":
            out[part[0]] = part[2:]
    return out


class ScramAuthenticator:
    """Server side; registers as an enhanced-auth provider under
    ``method`` ("SCRAM-SHA-256")."""

    method = "SCRAM-SHA-256"

    def __init__(self, iterations: int = 4096) -> None:
        self.iterations = iterations
        # username -> (salt, stored_key, server_key, iterations, superuser)
        self._users: Dict[str, Tuple[bytes, bytes, bytes, int, bool]] = {}

    def add_user(self, username: str, password: bytes,
                 is_superuser: bool = False,
                 iterations: Optional[int] = None) -> None:
        it = iterations or self.iterations
        salt = os.urandom(16)
        username = saslprep_or_raw(username)   # RFC 5802 §2.2
        salted = _hi(saslprep_bytes(password), salt, it)
        client_key = _hmac(salted, b"Client Key")
        stored_key = _h(client_key)
        server_key = _hmac(salted, b"Server Key")
        self._users[username] = (salt, stored_key, server_key, it,
                                 is_superuser)

    def delete_user(self, username: str) -> bool:
        # same normalization as add_user, or a user created under a
        # non-NFKC form could never be deleted with the same string
        return self._users.pop(saslprep_or_raw(username),
                               None) is not None

    # -- enhanced-auth provider contract -----------------------------------
    #
    # start(clientid, username, data)        -> ("continue", bytes, state)
    #                                         | ("deny", reason)
    # continue_auth(state, data) -> ("ok", username, is_superuser, bytes)
    #                             | ("deny", reason)

    def start(self, clientid: str, username: Optional[str],
              data: bytes) -> Tuple:
        try:
            first = data.decode("utf-8")
            gs2, _, bare = first.partition(",,")
            if gs2 not in ("n", "y"):       # no channel binding
                return ("deny", "channel binding unsupported")
            attrs = _parse_attrs(bare)
            user = attrs.get("n") or username
            cnonce = attrs["r"]
        except (UnicodeDecodeError, KeyError, ValueError):
            return ("deny", "malformed client-first")
        user = saslprep_or_raw(user or "")
        rec = self._users.get(user)
        if rec is None:
            return ("deny", "unknown user")
        salt, stored_key, server_key, it, superuser = rec
        snonce = cnonce + secrets.token_urlsafe(18)
        server_first = (
            f"r={snonce},s={base64.b64encode(salt).decode()},i={it}"
        )
        state = {
            "user": user,
            "nonce": snonce,
            "auth_base": f"{bare},{server_first}",
            "stored_key": stored_key,
            "server_key": server_key,
            "superuser": superuser,
        }
        return ("continue", server_first.encode(), state)

    def continue_auth(self, state: Dict[str, Any], data: bytes) -> Tuple:
        try:
            final = data.decode("utf-8")
            attrs = _parse_attrs(final)
            if attrs["r"] != state["nonce"]:
                return ("deny", "nonce mismatch")
            proof = base64.b64decode(attrs["p"])
            without_proof = final.rsplit(",p=", 1)[0]
        except (UnicodeDecodeError, KeyError, ValueError):
            return ("deny", "malformed client-final")
        auth_message = f"{state['auth_base']},{without_proof}".encode()
        client_signature = _hmac(state["stored_key"], auth_message)
        client_key = bytes(a ^ b for a, b in zip(proof, client_signature))
        if not hmac.compare_digest(_h(client_key), state["stored_key"]):
            return ("deny", "bad proof")
        server_sig = _hmac(state["server_key"], auth_message)
        server_final = b"v=" + base64.b64encode(server_sig)
        return ("ok", state["user"], state["superuser"], server_final)


# ---------------------------------------------------------------------------
# client-side helpers (the in-repo MQTT client + tests use these)
# ---------------------------------------------------------------------------

def scram_client_first(username: str,
                       cnonce: Optional[str] = None) -> Tuple[bytes, Dict]:
    cnonce = cnonce or secrets.token_urlsafe(18)
    username = saslprep_or_raw(username)
    bare = f"n={username},r={cnonce}"
    return f"n,,{bare}".encode(), {"bare": bare, "cnonce": cnonce,
                                   "username": username}


def scram_client_final(ctx: Dict, password: bytes,
                       server_first: bytes) -> Tuple[bytes, Dict]:
    """Returns (client-final bytes, ctx') — ctx' carries the expected
    server signature for CONNACK verification."""
    sf = server_first.decode("utf-8")
    attrs = _parse_attrs(sf)
    snonce, salt_b64, it = attrs["r"], attrs["s"], int(attrs["i"])
    if not snonce.startswith(ctx["cnonce"]):
        raise ValueError("server nonce does not extend client nonce")
    salt = base64.b64decode(salt_b64)
    salted = _hi(saslprep_bytes(password), salt, it)
    client_key = _hmac(salted, b"Client Key")
    stored_key = _h(client_key)
    without_proof = f"c={base64.b64encode(b'n,,').decode()},r={snonce}"
    auth_message = f"{ctx['bare']},{sf},{without_proof}".encode()
    client_sig = _hmac(stored_key, auth_message)
    proof = bytes(a ^ b for a, b in zip(client_key, client_sig))
    final = f"{without_proof},p={base64.b64encode(proof).decode()}"
    server_key = _hmac(salted, b"Server Key")
    expect = b"v=" + base64.b64encode(_hmac(server_key, auth_message))
    return final.encode(), {**ctx, "expect_server_final": expect}
