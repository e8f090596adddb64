"""Authentication & authorization (SURVEY.md §2.3: ``apps/emqx_authn``,
``apps/emqx_authz``, ``emqx_access_control.erl`` [U]).

The port's own copy of the reference's ``emqx_tpu/auth/__init__.py``
(nothing here imports the JAX package).

* :mod:`~emqx_tpu_torch.auth.authn` — chainable authenticators (built-in
  db with salted sha256/pbkdf2/bcrypt, JWT HS256/384/512, anonymous
  policy); :mod:`~emqx_tpu_torch.auth.scram` — SCRAM-SHA-256 for MQTT 5
  enhanced auth.
* :mod:`~emqx_tpu_torch.auth.authz` — ordered ACL sources (file rules,
  built-in db) with ``%c``/``%u`` topic placeholders, result cache, and
  an NFA-compiled batch path: static ACL patterns run through the port's
  hash walk on the card (``batch_authorize``).
* :func:`~emqx_tpu_torch.auth.access_control.attach_auth` — wires both
  onto a Broker's ``client.authenticate`` / ``client.authorize`` hooks.
* :mod:`~emqx_tpu_torch.auth.factory` — config-driven construction of
  the ported types.

The network-backed backends (HTTP, JWKS, Redis, PostgreSQL, MySQL,
MongoDB, LDAP) are not ported; the factory raises NotImplementedError
for their types.
"""

from .authn import (
    AuthChain, AuthResult, BuiltinDbAuthenticator, JwtAuthenticator,
    Credentials, hash_password,
)
from .authz import (AclRule, Authz, BuiltinDbSource, FileSource,
                    acl_filter_matches, batch_authorize, compile_acl_batch)
from .access_control import AccessControl, attach_auth
from .factory import describe, make_authenticator, make_authz_source
from .scram import ScramAuthenticator

__all__ = [
    "AuthChain", "AuthResult", "BuiltinDbAuthenticator", "JwtAuthenticator",
    "Credentials", "hash_password",
    "AclRule", "Authz", "BuiltinDbSource", "FileSource",
    "acl_filter_matches", "batch_authorize", "compile_acl_batch",
    "AccessControl", "attach_auth",
    "describe", "make_authenticator", "make_authz_source",
    "ScramAuthenticator",
]
