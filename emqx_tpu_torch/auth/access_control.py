"""Access-control wiring — the ``emqx_access_control`` analog.

The port's own copy of the reference's ``emqx_tpu/auth/access_control.py``
(nothing here imports the JAX package).

Behavioral reference: ``apps/emqx/src/emqx_access_control.erl`` [U]
(SURVEY.md §2.1): ``authenticate/1`` runs the authn chain during
CONNECT; ``authorize/3`` runs the authz pipeline per publish/subscribe.
Here both ride the hook bus the channel already calls:

* ``client.authenticate`` fold — maps the chain verdict onto the
  accumulator the channel understands (True, or a CONNACK reason code);
* ``client.authorize`` fold — True/False per (clientid, action, topic).

Superuser status from authn is remembered per clientid for the
authorize fast path, and dropped when the session terminates.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..broker.broker import Broker
from ..broker.hooks import STOP
from ..mqtt.packet import RC
from .authn import AuthChain, Credentials
from .authz import Authz

__all__ = ["attach_auth", "AccessControl"]


class AccessControl:
    def __init__(self, chain: AuthChain, authz: Authz) -> None:
        self.chain = chain
        self.authz = authz
        self._superusers: Dict[str, bool] = {}
        self._usernames: Dict[str, Optional[str]] = {}
        self._peerhosts: Dict[str, Optional[str]] = {}

    # hook: client.authenticate (clientid, username, password, conninfo) acc
    def on_authenticate(self, clientid, username, password, conninfo, acc):
        if acc is not True:
            return acc  # an earlier hook (banned) already decided
        peer = conninfo.get("peerhost") if isinstance(conninfo, dict) else None
        res = self.chain.authenticate(
            Credentials(clientid, username, password, peer)
        )
        if res.outcome == "ok":
            self._superusers[clientid] = res.is_superuser
            self._usernames[clientid] = username
            self._peerhosts[clientid] = peer
            return True
        return (STOP, RC.BAD_USER_NAME_OR_PASSWORD if password else RC.NOT_AUTHORIZED)

    # hook: client.authorize (clientid, action, topic, ctx) acc
    # ctx carries per-request conditions (qos, retain) for rules that
    # constrain on them (emqx_authz rule qos/retain fields)
    def on_authorize(self, clientid, action, topic, ctx=None, acc=None):
        if acc is None:  # called with 4-arg legacy shape
            ctx, acc = None, ctx
        if acc is not True:
            return acc
        ctx = ctx or {}
        ok = self.authz.authorize(
            clientid, action, topic,
            username=self._usernames.get(clientid),
            peerhost=self._peerhosts.get(clientid),
            is_superuser=self._superusers.get(clientid, False),
            qos=ctx.get("qos"),
            retain=ctx.get("retain"),
        )
        return True if ok else (STOP, False)

    # hook: client.enhanced_authenticated (clientid, username, superuser)
    # — enhanced auth (SCRAM) bypasses the authn chain, but the authorize
    # fast path still needs the superuser/username record
    def on_enhanced(self, clientid, username, is_superuser,
                    peerhost=None):
        self._superusers[clientid] = bool(is_superuser)
        self._usernames[clientid] = username
        self._peerhosts[clientid] = peerhost

    def on_terminated(self, clientid):
        self._superusers.pop(clientid, None)
        self._usernames.pop(clientid, None)
        self._peerhosts.pop(clientid, None)

    # -- async pre-resolution (external HTTP/JWKS backends) ----------------
    #
    # The hook folds above are synchronous; network-backed authn/authz
    # resolve here first (node packet intercept, async per-connection)
    # and park their verdicts for the fold to consume.

    def needs_async(self) -> bool:
        """Cached: the chain/source set is fixed after wiring (runtime
        mutations must call :meth:`invalidate_async_cache`), and this
        runs per packet on the intercept path."""
        cached = getattr(self, "_needs_async", None)
        if cached is None:
            cached = self._needs_async = any(
                hasattr(a, "authenticate_async") for a in self.chain._chain
            ) or any(
                hasattr(s, "prefetch_async") for s in self.authz.sources
            )
        return cached

    def invalidate_async_cache(self) -> None:
        self._needs_async = None

    async def preauthenticate(self, channel, pkt) -> None:
        creds = Credentials(
            pkt.clientid, pkt.username, pkt.password,
            (channel.conninfo or {}).get("peerhost")
            if isinstance(getattr(channel, "conninfo", None), dict) else None,
        )
        for a in self.chain._chain:
            if hasattr(a, "authenticate_async"):
                res = await a.authenticate_async(creds)
            else:
                res = a.authenticate(creds)
            if res.outcome != "ignore":
                return  # the sync walk stops here too

    async def preauthorize(self, clientid, action, topic, qos=0) -> None:
        if clientid is None or self._superusers.get(clientid, False):
            return
        username = self._usernames.get(clientid)
        peerhost = self._peerhosts.get(clientid)
        for src in self.authz.sources:
            if hasattr(src, "prefetch_async"):
                v = await src.prefetch_async(
                    clientid, username, peerhost, action, topic)
            else:
                try:
                    v = src.authorize(clientid, username, peerhost, action,
                                      topic, qos=qos)
                except Exception:
                    v = "nomatch"
            if v != "nomatch":
                return


def attach_auth(broker: Broker, chain: AuthChain, authz: Authz) -> AccessControl:
    ac = AccessControl(chain, authz)
    broker.hooks.add("client.authenticate", ac.on_authenticate, priority=0,
                     name="authn.chain")
    broker.hooks.add("client.enhanced_authenticated", ac.on_enhanced,
                     priority=0, name="authn.enhanced")
    broker.hooks.add("client.authorize", ac.on_authorize, priority=0,
                     name="authz.sources")
    broker.hooks.add("session.terminated", ac.on_terminated,
                     name="authn.cleanup")
    return ac
