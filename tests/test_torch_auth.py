"""The port's access control (``emqx_tpu_torch/auth``) against the
reference's (``emqx_tpu/auth``), exactly.

Each case of ``tests/test_auth.py`` runs on both packages and returns a
transcript (verdicts, outcomes, metrics, CONNACK and PUBACK codes); the
two must be equal.  Beside them: seeded builtin-DB and JWT chains, a
seeded ACL pipeline (order, ``who``, ``eq``, ``%c``/``%u`` placeholders,
retain and QoS conditions, the cache), the RFC 7677 SCRAM-SHA-256
exchange, the factory and ``describe`` redaction, and
``compile_acl_batch`` + ``batch_authorize`` (the port's walk on the CPU)
against the reference's and against host ``Authz``.

Intended divergence, asserted as such: the network-backed authenticator
and source types (HTTP, JWKS, Redis, PostgreSQL, MySQL, MongoDB, LDAP)
are not ported, and the port's factory raises NotImplementedError for
them where the reference builds a client of the outside service.
"""

import base64
import hashlib
import hmac
import json
import os
import random
import secrets
import time
from types import SimpleNamespace

import pytest

import emqx_tpu.auth as ref_auth
import emqx_tpu.auth.authn as ref_authn
import emqx_tpu.auth.authz as ref_authz
import emqx_tpu.auth.factory as ref_factory
import emqx_tpu.auth.scram as ref_scram
import emqx_tpu_torch.auth as port_auth
import emqx_tpu_torch.auth.authn as port_authn
import emqx_tpu_torch.auth.authz as port_authz
import emqx_tpu_torch.auth.factory as port_factory
import emqx_tpu_torch.auth.scram as port_scram
from emqx_tpu.broker import Broker as RefBroker
from emqx_tpu.broker.channel import Channel as RefChannel
from emqx_tpu.broker.cm import ConnectionManager as RefCM
from emqx_tpu.mqtt import packet as RefP
from emqx_tpu_torch.broker.broker import Broker
from emqx_tpu_torch.broker.channel import Channel
from emqx_tpu_torch.broker.cm import ConnectionManager
from emqx_tpu_torch.mqtt import packet as P


def _side(auth, authn, authz, factory, scram, broker, channel, cm, pkt,
          **kw):
    return SimpleNamespace(
        AclRule=auth.AclRule, AuthChain=auth.AuthChain, Authz=auth.Authz,
        BuiltinDbAuthenticator=auth.BuiltinDbAuthenticator,
        BuiltinDbSource=auth.BuiltinDbSource, Credentials=auth.Credentials,
        FileSource=auth.FileSource, JwtAuthenticator=auth.JwtAuthenticator,
        attach_auth=auth.attach_auth, hash_password=auth.hash_password,
        batch_authorize=authz.batch_authorize,
        compile_acl_batch=authz.compile_acl_batch,
        acl_filter_matches=authz.acl_filter_matches,
        IGNORE=authn.IGNORE, factory=factory, scram=scram, Broker=broker,
        Channel=channel, ConnectionManager=cm, P=pkt, **kw)


REF = _side(ref_auth, ref_authn, ref_authz, ref_factory, ref_scram,
            RefBroker, RefChannel, RefCM, RefP, batch_kw={})
PORT = _side(port_auth, port_authn, port_authz, port_factory, port_scram,
             Broker, Channel, ConnectionManager, P,
             batch_kw={"device": "cpu"})


def play(case, *args):
    want = case(REF, *args)
    got = case(PORT, *args)
    assert got == want
    return want


def result(res):
    return (res.outcome, res.is_superuser, sorted(res.attrs.items()))


# -- tests/test_auth.py: authn --------------------------------------------------

def builtin_db_sha256_chain(s):
    a = s.BuiltinDbAuthenticator(algo="sha256", salt_position="prefix")
    a.add_user("alice", b"secret", is_superuser=True)
    chain = s.AuthChain(allow_anonymous=False).add(a)
    return [result(chain.authenticate(s.Credentials("c1", "alice", b"secret"))),
            result(chain.authenticate(s.Credentials("c1", "alice", b"wrong"))),
            result(chain.authenticate(s.Credentials("c1", "bob", b"x"))),
            result(s.AuthChain(allow_anonymous=True).authenticate(
                s.Credentials("c1")))]


def builtin_db_pbkdf2_and_clientid_type(s):
    a = s.BuiltinDbAuthenticator(user_id_type="clientid", algo="pbkdf2")
    a.add_user("dev1", b"pw")
    return [result(a.authenticate(s.Credentials("dev1", None, b"pw"))),
            result(a.authenticate(s.Credentials("dev2", None, b"pw")))]


def make_jwt(secret: bytes, claims: dict, alg="HS256") -> bytes:
    def enc(d):
        return base64.urlsafe_b64encode(json.dumps(d).encode()).rstrip(b"=")

    h = enc({"alg": alg, "typ": "JWT"})
    b = enc(claims)
    digest = {"HS256": "sha256", "HS384": "sha384", "HS512": "sha512"}[alg]
    sig = base64.urlsafe_b64encode(
        hmac.new(secret, h + b"." + b, digest).digest()).rstrip(b"=")
    return h + b"." + b + b"." + sig


def jwt_authenticator(s):
    now = time.time()
    j = s.JwtAuthenticator(b"topsecret", verify_claims={"sub": "%c"})
    good = make_jwt(b"topsecret", {"sub": "c1", "exp": now + 60})
    old = make_jwt(b"topsecret", {"sub": "c1", "exp": now - 1})
    forged = make_jwt(b"wrong", {"sub": "c1"})
    su = make_jwt(b"topsecret", {"sub": "c1", "is_superuser": True,
                                 "acl": ["t/#"]})
    return [result(j.authenticate(s.Credentials(c, password=p)))
            for c, p in (("c1", good), ("c2", good), ("c1", old),
                         ("c1", forged), ("c1", b"plain"), ("c1", su))]


def auto_anonymous_denies_once_chain_populated(s):
    chain = s.AuthChain()
    out = [result(chain.authenticate(s.Credentials(clientid="c")))]

    class IgnoringBackend:
        def authenticate(self, creds):
            return s.IGNORE

    chain.add(IgnoringBackend())
    out.append(result(chain.authenticate(s.Credentials(clientid="c"))))
    chain.allow_anonymous = True
    out.append(result(chain.authenticate(s.Credentials(clientid="c"))))
    return out


# -- tests/test_auth.py: authz --------------------------------------------------

def _authz(s, rules, **kw):
    return s.Authz([s.FileSource(rules)], **kw)


def acl_first_match_wins_and_no_match_policy(s):
    R = s.AclRule
    az = _authz(s, [R("deny", "publish", ["forbidden/#"]),
                    R("allow", "all", ["#"])])
    az2 = _authz(s, [R("allow", "subscribe", ["a/b"])], no_match="deny")
    return [az.authorize("c", "publish", "forbidden/x"),
            az.authorize("c", "publish", "ok/x"),
            az2.authorize("c", "publish", "a/b"),
            az2.authorize("c", "subscribe", "a/b"), az.metrics, az2.metrics]


def acl_placeholders_and_eq(s):
    R = s.AclRule
    az = _authz(s, [R("allow", "all", ["own/%c/#"]),
                    R("allow", "subscribe", ["eq priv/+/x"]),
                    R("deny", "all", ["#"])], cache_enable=False)
    return [az.authorize("c1", "publish", "own/c1/data"),
            az.authorize("c1", "publish", "own/c2/data"),
            az.authorize("c1", "subscribe", "priv/+/x"),
            az.authorize("c1", "subscribe", "priv/a/x")]


def acl_who_dimensions(s):
    R = s.AclRule
    az = _authz(s, [R("deny", "all", ["#"], who="user:mallory"),
                    R("deny", "all", ["#"], who="ip:10.0.0.0/8"),
                    R("allow", "all", ["#"])], cache_enable=False)
    return [az.authorize("c", "publish", "t", username="mallory"),
            az.authorize("c", "publish", "t", peerhost="10.1.2.3"),
            az.authorize("c", "publish", "t", username="alice",
                         peerhost="192.168.0.1")]


def authz_cache_and_superuser(s):
    az = _authz(s, [s.AclRule("deny", "all", ["#"])], no_match="deny")
    out = [az.authorize("root", "publish", "t", is_superuser=True),
           az.authorize("c", "publish", "t", now=100.0),
           az.authorize("c", "publish", "t", now=101.0),
           dict(az.metrics),
           az.authorize("c", "publish", "t", now=1000.0), dict(az.metrics)]
    az.clear_cache()
    out.append(az.authorize("c", "publish", "t", now=1000.5))
    return out + [dict(az.metrics)]


def builtin_db_source_precedence(s):
    src = s.BuiltinDbSource()
    src.set_rules([s.AclRule("allow", "all", ["a/#"])], clientid="c1")
    src.set_rules([s.AclRule("deny", "all", ["a/#"])], username="u1")
    az = s.Authz([src], no_match="deny", cache_enable=False)
    return [az.authorize("c1", "publish", "a/x", username="u1"),
            az.authorize("c2", "publish", "a/x", username="u1")]


def acl_device_batch_matches_host(s):
    R = s.AclRule
    rules = [R("deny", "publish", ["secret/#"]),
             R("allow", "publish", ["s/+/temp", "pub/#"]),
             R("deny", "all", ["#"])]
    src = s.FileSource(rules)
    table, idx = s.compile_acl_batch([src])
    topics = ["secret/a", "s/1/temp", "pub/x/y", "other/t", "s/1/hum"]
    got = s.batch_authorize(table, idx, topics, "publish", no_match="allow",
                            **s.batch_kw)
    az = s.Authz([src], cache_enable=False)
    want = [az.authorize("cX", "publish", t) for t in topics]
    assert got == want == [False, True, True, False, False]
    return [got, idx, table.accept_filters, table.node_tab.tolist(),
            table.edge_tab.tolist()]


def acl_device_batch_refuses_non_static_rules(s):
    R = s.AclRule
    out = []
    for bad in (R("allow", "all", ["own/%c/#"]),
                R("deny", "all", ["#"], who="user:m"),
                R("deny", "publish", ["t"], retain=True),
                R("deny", "publish", ["t"], qos=[1, 2]),
                R("allow", "all", ["eq a/+"])):
        out.append(s.compile_acl_batch(
            [s.FileSource([R("allow", "all", ["ok/#"]), bad])]))
    src = s.BuiltinDbSource()
    src.set_rules([R("allow", "all", ["x"])], clientid="c1")
    out.append(s.compile_acl_batch([src]))
    out.append(s.compile_acl_batch([object()]))
    out.append(s.compile_acl_batch([s.FileSource([])]))
    assert all(o == (None, {}) for o in out)
    return len(out)


def acl_placeholder_wildcard_injection_blocked(s):
    R = s.AclRule
    az = _authz(s, [R("allow", "all", ["own/%c/#"]), R("deny", "all", ["#"])],
                no_match="deny", cache_enable=False)
    return [az.authorize("+", "publish", "own/alice/data"),
            az.authorize("a/b", "publish", "own/a/b"),
            az.authorize("alice", "publish", "own/alice/data")]


# -- tests/test_auth.py: through the channel -----------------------------------

def _sent(acts):
    out = []
    for a in acts:
        if a[0] == "send":
            pkt = a[1]
            out.append((type(pkt).__name__, getattr(pkt, "reason_code", None),
                        getattr(pkt, "reason_codes", None)))
    return out


def ip_acl_enforced_through_channel_hook(s):
    broker = s.Broker()
    cm = s.ConnectionManager(broker)
    s.attach_auth(broker, s.AuthChain(allow_anonymous=True), s.Authz([
        s.FileSource([s.AclRule("deny", "all", ["#"], who="ip:10.0.0.0/8"),
                      s.AclRule("allow", "all", ["#"])])]))
    ch = s.Channel(broker, cm, conninfo={"peerhost": "10.1.2.3"})
    out = [_sent(ch.handle_in(s.P.Connect(proto_ver=5, clientid="c1")))]
    out.append(_sent(ch.handle_in(s.P.Publish(qos=1, topic="t", packet_id=1,
                                              payload=b"x"))))
    assert out[1][0][1] == s.P.RC.NOT_AUTHORIZED
    return out


def connect_auth_and_publish_acl_through_channel(s):
    broker = s.Broker()
    cm = s.ConnectionManager(broker)
    a = s.BuiltinDbAuthenticator()
    a.add_user("alice", b"pw")
    chain = s.AuthChain(allow_anonymous=False).add(a)
    authz = s.Authz([s.FileSource([s.AclRule("allow", "all", ["ok/#"]),
                                   s.AclRule("deny", "all", ["#"])])],
                    no_match="deny")
    ac = s.attach_auth(broker, chain, authz)
    ch = s.Channel(broker, cm)
    out = [_sent(ch.handle_in(s.P.Connect(
        proto_ver=5, clientid="c1", username="alice", password=b"no")))]
    ch2 = s.Channel(broker, cm)
    out.append(_sent(ch2.handle_in(s.P.Connect(
        proto_ver=5, clientid="c1", username="alice", password=b"pw"))))
    out.append(_sent(ch2.handle_in(s.P.Publish(
        qos=1, topic="denied/t", packet_id=1, payload=b"x"))))
    out.append(_sent(ch2.handle_in(s.P.Subscribe(
        packet_id=2, topic_filters=[("ok/#", {"qos": 0}),
                                    ("denied/#", {"qos": 0})]))))
    out.append(_sent(ch2.handle_in(s.P.Publish(
        qos=1, topic="ok/t", packet_id=3, payload=b"x"))))
    out.append(sorted(broker.hooks.callbacks("client.authorize")))
    out.append((dict(authz.metrics), ac.needs_async(),
                dict(ac._usernames), dict(ac._superusers)))
    broker.hooks.run("session.terminated", ("c1",))
    out.append((dict(ac._usernames), dict(ac._superusers)))
    return out


def describe_redacts_password_hash_and_salt(s):
    return [s.factory.describe({
        "type": "built_in_database", "password": "x", "secret": "y",
        "api_token": "z", "name": "n",
        "users": [{"username": "u", "password_hash": "deadbeef",
                   "salt": "s3cr3t", "is_superuser": False,
                   "password": "p"}]})]


def saslprep_rfc4013_vectors(s):
    out = [s.scram.saslprep(v) for v in
           ("I­X", "user", "USER", "ª", "Ⅸ", "a b")]
    for bad in ("\x07", "ا\x31"):
        try:
            s.scram.saslprep(bad)
            out.append("accepted")
        except ValueError as e:
            out.append(str(e))
    return out


AUTH_CASES = [builtin_db_sha256_chain, builtin_db_pbkdf2_and_clientid_type,
              jwt_authenticator, auto_anonymous_denies_once_chain_populated,
              acl_first_match_wins_and_no_match_policy,
              acl_placeholders_and_eq, acl_who_dimensions,
              authz_cache_and_superuser, builtin_db_source_precedence,
              acl_device_batch_matches_host,
              acl_device_batch_refuses_non_static_rules,
              acl_placeholder_wildcard_injection_blocked,
              ip_acl_enforced_through_channel_hook,
              connect_auth_and_publish_acl_through_channel,
              describe_redacts_password_hash_and_salt,
              saslprep_rfc4013_vectors]


@pytest.mark.parametrize("case", AUTH_CASES, ids=lambda c: c.__name__)
def test_auth_case_equals_the_reference(case):
    play(case)


# -- seeded chains and pipelines -------------------------------------------------

ALGOS = [("plain", "disable"), ("sha256", "prefix"), ("sha256", "suffix"),
         ("sha512", "disable"), ("md5", "prefix"), ("sha", "suffix"),
         ("pbkdf2", "prefix")]


@pytest.mark.parametrize("algo,pos", ALGOS)
def test_hash_password_equals_the_reference(algo, pos):
    rng = random.Random(algo + pos)
    for _ in range(8):
        pw = bytes(rng.randrange(256) for _ in range(rng.randint(0, 12)))
        salt = bytes(rng.randrange(256) for _ in range(rng.randint(0, 8)))
        if algo == "plain":
            pw = pw.decode("latin-1").encode()
        kw = {"iterations": 64} if algo == "pbkdf2" else {}
        assert port_auth.hash_password(pw, algo, salt, pos, **kw) == \
            ref_auth.hash_password(pw, algo, salt, pos, **kw)
    for bad in ("nope", "bcrypt"):
        got = _outcome(port_auth.hash_password, b"x", bad)
        assert got == _outcome(ref_auth.hash_password, b"x", bad)


def _outcome(fn, *a, **kw):
    try:
        return ("ok", fn(*a, **kw))
    except Exception as e:  # noqa: BLE001 — the exception is the outcome
        return ("raise", type(e).__name__, str(e))


def seeded_chain(s, seed):
    """A chain of a builtin-DB authenticator (salts pinned), a clientid
    one and a JWT one, over seeded credentials."""
    rng = random.Random(seed)
    a = s.BuiltinDbAuthenticator(algo=rng.choice(["sha256", "pbkdf2"]),
                                 salt_position="suffix", iterations=32)
    b = s.BuiltinDbAuthenticator(user_id_type="clientid", algo="sha512")
    users = [f"u{i}" for i in range(5)]
    for i, u in enumerate(users):
        a.add_user(u, f"pw{i}".encode(), is_superuser=i == 0,
                   salt=bytes([i, 7]))
        b.add_user(f"c{i}", f"cpw{i}".encode(), salt=b"s")
    j = s.JwtAuthenticator(b"k", verify_claims={"sub": "%u"})
    chain = s.AuthChain(allow_anonymous=rng.choice([None, True, False]))
    for x in rng.sample([a, b, j], 3):
        chain.add(x)
    out = [a.export_user("u0"), a.users(), a.delete_user("u4"),
           a.delete_user("zz")]
    for _ in range(30):
        cid = rng.choice(["c0", "c1", "c9", ""])
        user = rng.choice(users + [None, "ghost"])
        pw = rng.choice([b"pw0", b"pw1", b"cpw0", b"cpw1", None, b"",
                         make_jwt(b"k", {"sub": user or ""}),
                         make_jwt(b"k", {"sub": "x"}, "HS512")])
        out.append(result(chain.authenticate(s.Credentials(cid, user, pw))))
    a.add_user_hashed("h", hashlib.sha256(b"pw" + b"\xff").hexdigest(),
                      "\xff")
    out.append(result(a.authenticate(s.Credentials("c", "h", b"pw"))))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_seeded_chain_equals_the_reference(seed):
    play(seeded_chain, seed)


def seeded_authz(s, seed):
    rng = random.Random(seed)
    R = s.AclRule
    pats = ["a/#", "a/+/x", "eq a/+/x", "own/%c/#", "u/%u", "#", "b/c",
            "$SYS/#", "+/+", "eq b/c"]
    rules = []
    for _ in range(12):
        rules.append(R(rng.choice(["allow", "deny"]),
                       rng.choice(["publish", "subscribe", "all"]),
                       rng.sample(pats, rng.randint(1, 2)),
                       who=rng.choice(["all", "all", "user:u*", "client:c1",
                                       "ip:10.0.0.0/8", "bogus:x"]),
                       retain=rng.choice([None, None, True]),
                       qos=rng.choice([None, None, [1, 2]])))
    src = s.BuiltinDbSource()
    src.set_rules(rules[8:], clientid="c2")
    src.set_rules(rules[6:9], username="u1")
    src.set_rules(rules[10:])
    az = s.Authz([s.FileSource(rules[:6]), src],
                 no_match=rng.choice(["allow", "deny"]),
                 cache_max_size=4, cache_ttl=5.0)
    out = []
    now = 1000.0
    for _ in range(60):
        now += rng.random() * 2
        out.append(az.authorize(
            rng.choice(["c1", "c2", "+", "a/b"]),
            rng.choice(["publish", "subscribe"]),
            rng.choice(["a/b/x", "a/+/x", "own/c1/x", "own/+/x", "u/u1",
                        "b/c", "$SYS/x", "q"]),
            username=rng.choice([None, "u1", "u2", "#"]),
            peerhost=rng.choice([None, "10.2.3.4", "1.2.3.4", "bad"]),
            is_superuser=rng.random() < 0.05, now=now,
            retain=rng.choice([None, True, False]),
            qos=rng.choice([None, 0, 1])))
    return [out, dict(az.metrics), len(az._cache)]


@pytest.mark.parametrize("seed", range(4))
def test_seeded_authz_equals_the_reference(seed):
    play(seeded_authz, seed)


# -- SCRAM-SHA-256 (RFC 7677 vector) ----------------------------------------

RFC7677 = {
    "client_first": b"n,,n=user,r=rOprNGfwEbeRWgbNEkqO",
    "server_first": b"r=rOprNGfwEbeRWgbNEkqO%hvYDpWUa2RaTCAfuxFIlj)hNlF$k0,"
                    b"s=W22ZaJ0SNY7soEsUEjb6gQ==,i=4096",
    "client_final": b"c=biws,r=rOprNGfwEbeRWgbNEkqO%hvYDpWUa2RaTCAfuxFIlj)"
                    b"hNlF$k0,p=dHzbZapWIk4jUhN+Ute9ytag9zjfMHgsqmmiz7AndVQ=",
    "server_final": b"v=6rriTRBi23WpRR/wtup+mMhUZUn/dB5nLTJRsjl95G4=",
}


def scram_rfc7677(s, monkeypatch):
    salt = base64.b64decode("W22ZaJ0SNY7soEsUEjb6gQ==")
    monkeypatch.setattr(os, "urandom", lambda n: salt)
    monkeypatch.setattr(secrets, "token_urlsafe",
                        lambda n=None: "%hvYDpWUa2RaTCAfuxFIlj)hNlF$k0")
    auth = s.scram.ScramAuthenticator(iterations=4096)
    auth.add_user("user", b"pencil", is_superuser=True)
    first, ctx = s.scram.scram_client_first("user",
                                            cnonce="rOprNGfwEbeRWgbNEkqO")
    assert first == RFC7677["client_first"]
    r = auth.start("c", None, first)
    assert r[0] == "continue" and r[1] == RFC7677["server_first"]
    final, ctx = s.scram.scram_client_final(ctx, b"pencil", r[1])
    assert final == RFC7677["client_final"]
    assert ctx["expect_server_final"] == RFC7677["server_final"]
    ok = auth.continue_auth(r[2], final)
    assert ok == ("ok", "user", True, RFC7677["server_final"])
    bad, _ = s.scram.scram_client_final(ctx, b"pencil!", r[1])
    out = [ok, auth.continue_auth(r[2], bad),
           auth.continue_auth(r[2], b"r=other,p=AAAA"),
           auth.continue_auth(r[2], b"\xff"),
           auth.start("c", None, b"p=tls,,n=user,r=x"),
           auth.start("c", None, b"n,,n=nobody,r=x"),
           auth.start("c", None, b"n,,n=user"),
           auth.delete_user("user"), auth.delete_user("user")]
    return out


def test_scram_rfc7677_vector_on_both(monkeypatch):
    want = scram_rfc7677(REF, monkeypatch)
    got = scram_rfc7677(PORT, monkeypatch)
    assert got == want


def test_scram_unicode_credentials_normalize_on_both():
    for s in (REF, PORT):
        auth = s.scram.ScramAuthenticator(iterations=256)
        auth.add_user("rené", "paⅨs".encode())
        first, ctx = s.scram.scram_client_first("rené")
        r = auth.start("c", None, first)
        assert r[0] == "continue", r
        final, ctx = s.scram.scram_client_final(ctx, b"paIXs", r[1])
        assert auth.continue_auth(r[2], final)[0] == "ok"


def test_scram_through_the_channel_equals_the_reference():
    """MQTT 5 enhanced auth: CONNECT with SCRAM, AUTH continue, CONNACK
    with the server-final, on each package's Channel with the provider
    registered as the reference's node does."""
    def run(s):
        broker = s.Broker()
        cm = s.ConnectionManager(broker)
        auth = s.scram.ScramAuthenticator(iterations=64)
        auth.add_user("alice", b"pw")
        broker.enhanced_auth[auth.method] = auth
        ac = s.attach_auth(broker, s.AuthChain(allow_anonymous=False),
                           s.Authz(no_match="allow"))
        ch = s.Channel(broker, cm)
        first, ctx = s.scram.scram_client_first("alice")
        acts = ch.handle_in(s.P.Connect(
            proto_ver=5, clientid="c1", username="alice",
            properties={"Authentication-Method": auth.method,
                        "Authentication-Data": first}))
        auth_pkt = [a[1] for a in acts if a[0] == "send"][0]
        data = auth_pkt.properties["Authentication-Data"]
        final, ctx = s.scram.scram_client_final(ctx, b"pw", data)
        acts = ch.handle_in(s.P.Auth(reason_code=0x18, properties={
            "Authentication-Method": auth.method,
            "Authentication-Data": final}))
        connack = [a[1] for a in acts if a[0] == "send"][0]
        assert connack.properties["Authentication-Data"] == \
            ctx["expect_server_final"]
        return [type(auth_pkt).__name__, auth_pkt.reason_code,
                type(connack).__name__, connack.reason_code,
                ch.state, dict(ac._usernames), dict(ac._superusers)]

    assert run(PORT) == run(REF)


# -- the factory ---------------------------------------------------------------

FACTORY_CONFS = [
    {"type": "built_in_database", "user_id_type": "clientid",
     "users": [{"user_id": "c1", "password": "pw", "is_superuser": True},
               {"user_id": "c2", "password_hash":
                hashlib.sha256(b"s" + b"pw2").hexdigest(), "salt": "s"}]},
    {"backend": "built_in_database", "algo": "plain",
     "users": [{"username": "u", "password": "p"}]},
    {"type": "jwt", "secret": "k", "verify_claims": {"sub": "%c"}},
    {"mechanism": "scram", "backend": "built_in_database",
     "iterations": 64, "users": [{"username": "u", "password": "p"}]},
    {"type": "jwt", "secret": "k", "typo": 1},
    {"type": "nosuch"}, {},
]


def _factory_authn(s, conf):
    res = _outcome(s.factory.make_authenticator, dict(conf))
    if res[0] != "ok":
        return res
    auth, c = res[1]
    out = [type(auth).__name__, c]
    if hasattr(auth, "users"):
        out.append(sorted(auth.users()))
    for cred in (s.Credentials("c1", None, b"pw"),
                 s.Credentials("c2", None, b"pw2"),
                 s.Credentials("x", "u", b"p")):
        if hasattr(auth, "authenticate"):
            out.append(result(auth.authenticate(cred)))
    return out


AUTHZ_CONFS = [
    {"type": "file", "rules": [
        {"permission": "deny", "action": "publish", "topics": ["a/#"]},
        {"permission": "allow", "topics": ["#"], "who": "client:c*",
         "qos": [0, 1], "retain": False}]},
    {"type": "file", "rules": [{"permission": "allow", "bad": 1}]},
    {"type": "file", "oops": 1}, {"type": "built_in_database"},
    {"type": "built_in_database", "rules": []}, {"type": "nosuch"},
]


def _factory_authz(s, conf):
    res = _outcome(s.factory.make_authz_source, dict(conf))
    if res[0] != "ok":
        return res
    src, c = res[1]
    return [type(src).__name__, c, [
        src.authorize(cid, None, None, act, t, qos=0, retain=False)
        for cid in ("c1", "x") for act in ("publish", "subscribe")
        for t in ("a/b", "z")]]


@pytest.mark.parametrize("i", range(len(FACTORY_CONFS)))
def test_factory_authenticator_equals_the_reference(i):
    want = _factory_authn(REF, FACTORY_CONFS[i])
    got = _factory_authn(PORT, FACTORY_CONFS[i])
    if want[0] == "raise":
        # the unknown-type message lists the package's types
        assert got[:2] == want[:2]
    else:
        assert got == want


@pytest.mark.parametrize("i", range(len(AUTHZ_CONFS)))
def test_factory_authz_source_equals_the_reference(i):
    want = _factory_authz(REF, AUTHZ_CONFS[i])
    got = _factory_authz(PORT, AUTHZ_CONFS[i])
    if want[0] == "raise":
        assert got[:2] == want[:2]
    else:
        assert got == want


@pytest.mark.parametrize("kind,t", [
    ("authn", t) for t in port_factory.UNPORTED_AUTHN_TYPES] + [
    ("authz", t) for t in port_factory.UNPORTED_AUTHZ_TYPES])
def test_network_backed_types_raise(kind, t):
    """Intended divergence: the reference builds these (clients of an
    outside service); the port has not ported them and says so."""
    ref_types = (ref_factory.AUTHN_TYPES if kind == "authn"
                 else ref_factory.AUTHZ_TYPES)
    assert t in ref_types
    make = (port_factory.make_authenticator if kind == "authn"
            else port_factory.make_authz_source)
    with pytest.raises(NotImplementedError, match=repr(t)):
        make({"type": t})
    ported = set(port_factory.AUTHN_TYPES if kind == "authn"
                 else port_factory.AUTHZ_TYPES)
    assert ported | set(port_factory.UNPORTED_AUTHN_TYPES if kind == "authn"
                        else port_factory.UNPORTED_AUTHZ_TYPES) == \
        set(ref_types)


# -- the device batch path ---------------------------------------------------

def seeded_acl_batch(s, seed):
    """Seeded static ACL rules in a FileSource and a BuiltinDbSource with
    global rules only; every topic's batch verdict against host Authz."""
    rng = random.Random(seed)
    words = ["a", "b", "c", "d", "$SYS"]
    rules = []
    for _ in range(40):
        n = rng.randint(1, 4)
        ws = [rng.choice(words[:4] if i else words) for i in range(n)]
        k = rng.random()
        if k < 0.35:
            ws[rng.randrange(n)] = "+"
        elif k < 0.6:
            ws[-1] = "#"
        pat = "/".join(ws)
        if k >= 0.9 and "+" not in ws and "#" not in ws:
            pat = "eq " + pat
        rules.append(s.AclRule(rng.choice(["allow", "deny"]),
                               rng.choice(["publish", "subscribe", "all"]),
                               [pat]))
    file_src = s.FileSource(rules[:30])
    db = s.BuiltinDbSource()
    db.set_rules(rules[30:])
    table, idx = s.compile_acl_batch([file_src, db])
    topics = ["/".join(rng.choice(words[:4] if i else words)
                       for i in range(rng.randint(1, 5)))
              for _ in range(64)]
    out = [idx, table.accept_filters]
    for action in ("publish", "subscribe"):
        for no_match in ("allow", "deny"):
            got = s.batch_authorize(table, idx, topics, action,
                                    no_match=no_match, **s.batch_kw)
            az = s.Authz([file_src, db], no_match=no_match,
                         cache_enable=False)
            want = [az.authorize("cX", action, t) for t in topics]
            assert got == want
            out.append(got)
    return out


@pytest.mark.parametrize("seed", range(4))
def test_seeded_acl_batch_equals_the_reference_and_host_authz(seed):
    play(seeded_acl_batch, seed)
