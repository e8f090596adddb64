"""Config-driven construction of authenticators / authz sources — the
``emqx_authn``/``emqx_authz`` config-schema analog [U] (SURVEY.md §2.3):
the reference manages both as ordered lists of typed JSON configs over
REST; this factory maps those configs onto the library classes so the
management API (and data import) can create backends at runtime.

The port's own copy of the reference's ``emqx_tpu/auth/factory.py``
(nothing here imports the JAX package).

Construction is signature-driven: conf keys that match the backend's
constructor parameters pass through; unknown keys error (typos must not
silently produce a default-configured authenticator).

The port has the in-process types only.  The network-backed ones (JWKS,
HTTP, Redis, PostgreSQL, MySQL, MongoDB, LDAP), each a client of an
outside service, are not ported: their type names raise
NotImplementedError naming the type (:data:`UNPORTED_AUTHN_TYPES`,
:data:`UNPORTED_AUTHZ_TYPES`), where an unknown name raises ValueError.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, List, Tuple

from .authn import BuiltinDbAuthenticator, JwtAuthenticator
from .authz import AclRule, BuiltinDbSource, FileSource
from .scram import ScramAuthenticator

__all__ = ["make_authenticator", "make_authz_source", "describe",
           "AUTHN_TYPES", "AUTHZ_TYPES", "UNPORTED_AUTHN_TYPES",
           "UNPORTED_AUTHZ_TYPES"]

AUTHN_TYPES: Dict[str, Any] = {
    "built_in_database": BuiltinDbAuthenticator,
    "jwt": JwtAuthenticator,
    "scram": ScramAuthenticator,
}

AUTHZ_TYPES: Dict[str, Any] = {
    "built_in_database": BuiltinDbSource,
    "file": FileSource,
}

#: the reference's network-backed types, which the port has not
UNPORTED_AUTHN_TYPES = ("http", "jwks", "ldap", "mongodb", "mysql",
                        "postgresql", "redis")
UNPORTED_AUTHZ_TYPES = ("http", "mongodb", "mysql", "postgresql", "redis")


def _unported(kind: str, t: str) -> NotImplementedError:
    return NotImplementedError(
        f"{kind} type {t!r} is network-backed and not ported (ported: "
        f"{sorted(AUTHN_TYPES if kind == 'authenticator' else AUTHZ_TYPES)})")


_SECRET_KEYS = ("password", "secret", "token")


def _build(cls: Any, conf: Dict[str, Any]) -> Any:
    sig = inspect.signature(cls.__init__)
    params = {p for p in sig.parameters if p not in ("self",)}
    kwargs = {}
    unknown = []
    for k, v in conf.items():
        if k in ("type", "backend", "mechanism", "enable", "users",
                 "rules", "allow_anonymous"):
            continue   # factory/chain-level keys, not constructor args
        if k not in params:
            unknown.append(k)
            continue
        if k in ("secret", "password", "service_password") and \
                isinstance(v, str) and \
                "bytes" in str(sig.parameters[k].annotation):
            v = v.encode()
        kwargs[k] = v
    if unknown:
        raise ValueError(
            f"unknown {cls.__name__} config keys: {sorted(unknown)} "
            f"(accepted: {sorted(params)})")
    return cls(**kwargs)


def make_authenticator(conf: Dict[str, Any]) -> Tuple[Any, Dict[str, Any]]:
    """conf {"type"|"backend": <name>, ...} -> (authenticator, conf)."""
    # reference-shaped SCRAM configs arrive as {mechanism: "scram",
    # backend: "built_in_database"} — mechanism wins over backend
    t = (conf.get("mechanism") if conf.get("mechanism") == "scram"
         else None) or conf.get("type") or conf.get("backend") or ""
    cls = AUTHN_TYPES.get(t)
    if cls is None and t in UNPORTED_AUTHN_TYPES:
        raise _unported("authenticator", t)
    if cls is None:
        raise ValueError(
            f"unknown authenticator type {t!r} "
            f"(one of {sorted(AUTHN_TYPES)})")
    auth = _build(cls, conf)
    # seed users for the user-store types; hashed records (the form
    # the REST add-user path persists for built-in db) restore without
    # ever having stored the plaintext
    for u in conf.get("users", []) if t in ("built_in_database",
                                            "scram") else []:
        uid = u.get("user_id") or u.get("username")
        if "password_hash" in u and hasattr(auth, "add_user_hashed"):
            auth.add_user_hashed(
                uid, u["password_hash"], u.get("salt", ""),
                is_superuser=bool(u.get("is_superuser")))
        else:
            auth.add_user(
                uid,
                u["password"].encode()
                if isinstance(u.get("password"), str)
                else u.get("password", b""),
                is_superuser=bool(u.get("is_superuser")))
    return auth, conf


def make_authz_source(conf: Dict[str, Any]) -> Tuple[Any, Dict[str, Any]]:
    t = conf.get("type") or ""
    cls = AUTHZ_TYPES.get(t)
    if cls is None and t in UNPORTED_AUTHZ_TYPES:
        raise _unported("authz source", t)
    if cls is None:
        raise ValueError(
            f"unknown authz source type {t!r} "
            f"(one of {sorted(AUTHZ_TYPES)})")
    if cls is FileSource:
        # same typo discipline as _build: unknown keys must error, not
        # silently install an empty (never-matching) rule source
        bad = [k for k in conf if k not in ("type", "rules", "enable")]
        if bad:
            raise ValueError(
                f"unknown file-source config keys: {sorted(bad)} "
                "(accepted: ['rules'])")
        rules = []
        for r in conf.get("rules", []):
            bad = [k for k in r if k not in
                   ("permission", "action", "topics", "who", "retain",
                    "qos")]
            if bad:
                raise ValueError(f"unknown rule keys: {sorted(bad)}")
            rules.append(AclRule(
                permission=r["permission"],
                action=r.get("action", "all"),
                topics=r.get("topics", ()),
                who=r.get("who", "all"),
                retain=r.get("retain"),
                qos=r.get("qos")))
        return FileSource(rules), conf
    src = _build(cls, {k: v for k, v in conf.items() if k != "rules"})
    return src, conf


def describe(conf: Dict[str, Any]) -> Dict[str, Any]:
    """Redacted config for REST responses."""
    out = {}
    for k, v in conf.items():
        if any(s in k.lower() for s in _SECRET_KEYS):
            out[k] = "******"
        elif k == "users":
            # REST-added users are stored as password_hash+salt via
            # export_user(); those are secrets too — only the backup
            # archive path (which must round-trip them) keeps them.
            out[k] = [
                {uk: ("******" if uk in ("password", "password_hash",
                                         "salt") else uv)
                 for uk, uv in u.items()}
                for u in v
            ]
        else:
            out[k] = v
    return out
