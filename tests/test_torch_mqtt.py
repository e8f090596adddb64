"""The port's MQTT codec and configuration against the reference's.

Seeded packets of every type, in MQTT 3.1.1 and 5 (with properties),
serialize to the same bytes on both sides, and each side parses the
other's bytes to equal packets, also fed to the incremental ``Parser``
in random chunks.  Malformed frames raise ``FrameError`` with the same
reason on both.  ``Config`` gives the same value for every schema key at
its defaults, from a file and from the ``EMQX_*`` environment layer, and
the same error type for invalid values.  Exact equality throughout.
"""

import dataclasses
import random

import pytest

from emqx_tpu import config as RC
from emqx_tpu.mqtt import frame as RF
from emqx_tpu.mqtt import packet as RP
from emqx_tpu_torch import config as PC
from emqx_tpu_torch.mqtt import frame as PF
from emqx_tpu_torch.mqtt import packet as PP

# -- seeded packets -------------------------------------------------------

_WORDS = ["a", "b", "dev", "room", "x7", "sensor", "$SYS", "ü", ""]


def _topic(rng, wild=False):
    ws = [rng.choice(_WORDS[:-1]) for _ in range(rng.randint(1, 5))]
    if wild and rng.random() < 0.5:
        ws[rng.randrange(len(ws))] = "+"
    if wild and rng.random() < 0.3:
        ws.append("#")
    return "/".join(ws)


def _props(rng, kinds):
    """v5 properties: a seeded subset of ``kinds`` (name -> value maker)."""
    out = {}
    for name, make in kinds.items():
        if rng.random() < 0.5:
            out[name] = make(rng)
    if rng.random() < 0.4:
        out["User-Property"] = [(f"k{i}", f"v{rng.randrange(99)}")
                                for i in range(rng.randint(1, 3))]
    return out


_PUB_PROPS = {
    "Payload-Format-Indicator": lambda r: r.randint(0, 1),
    "Message-Expiry-Interval": lambda r: r.randrange(1 << 32),
    "Content-Type": lambda r: r.choice(["text/plain", "application/json"]),
    "Response-Topic": lambda r: _topic(r),
    "Correlation-Data": lambda r: bytes(r.randrange(256) for _ in range(5)),
    "Topic-Alias": lambda r: r.randint(1, 100),
}
_CONNECT_PROPS = {
    "Session-Expiry-Interval": lambda r: r.randrange(1 << 32),
    "Receive-Maximum": lambda r: r.randint(1, 65535),
    "Maximum-Packet-Size": lambda r: r.randint(1, 1 << 20),
    "Topic-Alias-Maximum": lambda r: r.randint(0, 65535),
    "Request-Problem-Information": lambda r: r.randint(0, 1),
}
_CONNACK_PROPS = {
    "Assigned-Client-Identifier": lambda r: f"id{r.randrange(999)}",
    "Server-Keep-Alive": lambda r: r.randint(0, 65535),
    "Maximum-QoS": lambda r: r.randint(0, 1),
    "Retain-Available": lambda r: r.randint(0, 1),
    "Wildcard-Subscription-Available": lambda r: r.randint(0, 1),
    "Shared-Subscription-Available": lambda r: r.randint(0, 1),
}
_REASON = {"Reason-String": lambda r: f"why {r.randrange(9)}"}


def _packets(P, seed, ver):
    """One seeded packet of every type, built from the module ``P`` (the
    reference's or the port's ``packet``), for protocol version ``ver``."""
    rng = random.Random(seed * 10 + ver)
    v5 = ver == 5

    def props(kinds):
        return _props(rng, kinds) if v5 else {}

    will = None
    if rng.random() < 0.6:
        will = P.Will(_topic(rng), bytes(rng.randrange(256) for _ in range(4)),
                      qos=rng.randint(0, 2), retain=rng.random() < 0.5,
                      properties=props({"Will-Delay-Interval":
                                        lambda r: r.randrange(99)}))
    user = rng.random() < 0.5
    qos = rng.randint(0, 2)
    return [
        P.Connect(proto_ver=ver, clean_start=rng.random() < 0.5,
                  keepalive=rng.randint(0, 65535),
                  clientid=f"c{rng.randrange(10**6)}", will=will,
                  username="user" if user else None,
                  password=b"pw" if user else None,
                  properties=props(_CONNECT_PROPS)),
        P.Connack(session_present=rng.random() < 0.5,
                  reason_code=rng.choice([0, 0x80, 0x87] if v5 else [0, 5]),
                  properties=props(_CONNACK_PROPS)),
        P.Publish(dup=qos > 0 and rng.random() < 0.3, qos=qos,
                  retain=rng.random() < 0.5, topic=_topic(rng),
                  packet_id=rng.randint(1, 65535) if qos else None,
                  payload=bytes(rng.randrange(256)
                                for _ in range(rng.randint(0, 64))),
                  properties=props(_PUB_PROPS)),
        P.PubAck(P.PUBACK, rng.randint(1, 65535)),
        P.PubAck(P.PUBREC, rng.randint(1, 65535),
                 reason_code=rng.choice([0, 0x10]) if v5 else 0,
                 properties=props(_REASON)),
        P.PubAck(P.PUBREL, rng.randint(1, 65535)),
        P.PubAck(P.PUBCOMP, rng.randint(1, 65535)),
        P.Subscribe(packet_id=rng.randint(1, 65535),
                    topic_filters=[
                        (_topic(rng, wild=True),
                         {"qos": rng.randint(0, 2),
                          **({"nl": rng.randint(0, 1),
                              "rap": rng.randint(0, 1),
                              "rh": rng.randint(0, 2)} if v5 else {})})
                        for _ in range(rng.randint(1, 4))],
                    properties=props({"Subscription-Identifier":
                                      lambda r: r.randint(1, 1 << 20)})),
        P.Suback(packet_id=rng.randint(1, 65535),
                 reason_codes=[rng.choice([0, 1, 2, 0x80])
                               for _ in range(rng.randint(1, 4))],
                 properties=props(_REASON)),
        P.Unsubscribe(packet_id=rng.randint(1, 65535),
                      topic_filters=[_topic(rng, wild=True)
                                     for _ in range(rng.randint(1, 3))],
                      properties=props({})),
        P.Unsuback(packet_id=rng.randint(1, 65535),
                   reason_codes=([rng.choice([0, 0x11])
                                  for _ in range(rng.randint(1, 3))]
                                 if v5 else []),
                   properties=props(_REASON)),
        P.PingReq(),
        P.PingResp(),
        P.Disconnect(reason_code=rng.choice([0, 4, 0x8E]) if v5 else 0,
                     properties=props({**_REASON,
                                       "Session-Expiry-Interval":
                                       lambda r: r.randrange(99)})),
    ] + ([P.Auth(reason_code=0x18,
                 properties={"Authentication-Method": "SCRAM-SHA-1",
                             "Authentication-Data": b"\x01\x02"})]
         if v5 else [])


def _norm(pkt):
    """A packet as plain data: its class name and its fields."""
    if isinstance(pkt, (RP.AckRun, PP.AckRun)):
        return ("AckRun", pkt.type, list(pkt.pids))
    if isinstance(pkt, (RP.PublishRun, PP.PublishRun)):
        return ("PublishRun", pkt.qos, [_norm(p) for p in pkt.pkts])
    return (type(pkt).__name__, dataclasses.asdict(pkt))


SEEDS = range(6)


@pytest.mark.parametrize("ver", [4, 5])
@pytest.mark.parametrize("seed", SEEDS)
def test_packets_serialize_and_parse_as_the_reference(seed, ver):
    ref, port = _packets(RP, seed, ver), _packets(PP, seed, ver)
    assert [_norm(p) for p in ref] == [_norm(p) for p in port]
    for rp, pp in zip(ref, port):
        rb, pb = RF.serialize(rp, ver), PF.serialize(pp, ver)
        assert pb == rb, type(rp).__name__
        # each parses the other's bytes (a CONNECT carries its version)
        assert _norm(PF.parse_one(rb, ver)) == _norm(RF.parse_one(pb, ver))
        assert _norm(PF.parse_one(rb, ver)) == _norm(rp)


@pytest.mark.parametrize("runs", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_incremental_parser_in_random_chunks(seed, runs):
    """A v5 session's bytes (CONNECT first, so the parser switches to v5)
    with runs of acks and QoS1 publishes, fed in seeded random chunks:
    the same packets (with the ack-run and publish-run fast paths on, the
    same packed runs) from the port's parser as from the reference's."""
    rng = random.Random(seed)
    stream = b"".join(RF.serialize(p, 5) for p in _packets(RP, seed, 5))
    stream += b"".join(RF.serialize(RP.PubAck(RP.PUBACK, i), 5)
                       for i in range(1, 6))
    stream += b"".join(RF.serialize(RP.Publish(
        qos=1, topic=f"t/{i}", packet_id=i, payload=b"p"), 5)
        for i in range(1, 5))
    outs = []
    chunk_seed = rng.random()
    for F in (RF, PF):
        parser = F.Parser(ack_runs=runs, publish_runs=runs)
        got = []
        chunk_rng = random.Random(chunk_seed)
        i = 0
        while i < len(stream):
            n = chunk_rng.randint(1, 40)
            got += parser.feed(stream[i:i + n])
            i += n
        outs.append([_norm(p) for p in got])
    assert outs[1] == outs[0]
    assert len(outs[0]) >= 14


MALFORMED = [
    bytes([0x30, 0x80, 0x80, 0x80, 0x80, 0x01]),      # 5-byte varint
    bytes([0x36, 0x05, 0x00, 0x01, 0x61, 0x00, 0x01]),  # QoS 3
    bytes([0x82, 0x03, 0x00, 0x01, 0x00]),            # SUBSCRIBE, no filter
    bytes([0x82, 0x06, 0x00, 0x01, 0x00, 0x01, 0x61, 0x03]),  # sub QoS 3
    bytes([0x80, 0x02, 0x00, 0x01]),                  # bad SUBSCRIBE flags
    bytes([0x32, 0x02, 0x00, 0x00]),                  # QoS1, no packet id
    bytes([0x30, 0x03, 0x00, 0x02, 0xC3]),            # truncated utf8
    bytes([0x30, 0x04, 0x00, 0x02, 0xC3, 0x28]),      # invalid utf8
    bytes([0x00, 0x00]),                              # reserved type 0
    bytes([0xF0, 0x00]),                              # AUTH in 3.1.1
    bytes([0x10, 0x0A, 0x00, 0x04]) + b"MQTX" + bytes([4, 2, 0, 60]),
    bytes([0x10, 0x0A, 0x00, 0x04]) + b"MQTT" + bytes([9, 2, 0, 60]),
    bytes([0xE0, 0x01, 0x00]),                        # DISCONNECT 3.1.1 body
    bytes([0xA2, 0x02, 0x00, 0x01]),                  # UNSUBSCRIBE, empty
    bytes([0x62, 0x01, 0x00]),                        # PUBREL too short
]


def _error(F, data, ver, max_size=1 << 28):
    try:
        F.Parser(max_packet_size=max_size, proto_ver=ver).feed(data)
    except F.FrameError as e:
        return ("FrameError", str(e), e.reason_code)
    except Exception as e:  # noqa: BLE001 - compared, not swallowed
        return (type(e).__name__, str(e))
    return None


@pytest.mark.parametrize("ver", [4, 5])
def test_malformed_frames_raise_the_same_reason(ver):
    got = [_error(PF, d, ver) for d in MALFORMED]
    want = [_error(RF, d, ver) for d in MALFORMED]
    assert got == want
    assert sum(g is not None and g[0] == "FrameError" for g in got) >= 8
    big = RF.serialize(RP.Publish(topic="t", payload=b"x" * 300), ver)
    assert _error(PF, big, ver, 64) == _error(RF, big, ver, 64)
    assert _error(PF, big, ver, 64)[2] == RP.RC.PACKET_TOO_LARGE


# -- the configuration -------------------------------------------------------

def _values(cfg):
    return {k: cfg.get(k) for k in cfg.schema}


def test_schema_keys_and_defaults_equal_the_reference():
    assert list(PC.SCHEMA) == list(RC.SCHEMA)
    assert _values(PC.Config(env={})) == _values(RC.Config(env={}))


FILE = """
node.name = "n1@10.0.0.1"
mqtt {
  max_packet_size = 2MB
  max_inflight = 64
  session_expiry_interval = 2h
  retain_available = false
}
broker.fanout.enable = true
broker.fanout.window = 2ms
broker.shared_subscription_strategy = round_robin
tpu.table = python
tpu.batch_deadline = 500ms
match.backend = join
match.readback.mode = ragged
obs.hist.e2e_per_leg_sample = 8
listeners.tcp.default.bind = "127.0.0.1:0"
retainer.max_payload_size = 64KB
zones.edge.mqtt.max_inflight = 8
"""


def test_file_layer_equals_the_reference():
    r, p = RC.Config(file_text=FILE, env={}), PC.Config(file_text=FILE, env={})
    assert _values(p) == _values(r)
    assert p.zone("edge").get("mqtt.max_inflight") == \
        r.zone("edge").get("mqtt.max_inflight") == 8
    assert p.get("mqtt.max_packet_size") == 2 << 20


def test_env_layer_equals_the_reference():
    env = {"EMQX_TPU__ENABLE": "false", "EMQX_MQTT__MAX_INFLIGHT": "7",
           "EMQX_BROKER__FANOUT__ENABLE": "on",
           "EMQX_TPU__PREFETCH_TIMEOUT": "250ms",
           "EMQX_MATCH__PIPELINE__DEPTH": "3",
           "EMQX_NOT__A__KEY": "1", "OTHER": "x"}
    r = RC.Config(file_text=FILE, env=env)
    p = PC.Config(file_text=FILE, env=env)
    assert _values(p) == _values(r)
    assert p.get("tpu.enable") is False and p.get("mqtt.max_inflight") == 7
    for cfg in (r, p):
        cfg.put("limiter.max_conn_rate", "12.5")
    assert _values(p) == _values(r)
    assert p.runtime_overrides() == r.runtime_overrides()


@pytest.mark.parametrize("text", [
    "mqtt.max_inflight = 0",
    "mqtt.max_qos_allowed = 3",
    "tpu.table = gpu",
    "broker.fanout.window = soon",
    "mqtt.max_packet_size = lots",
    "retainer.enable = maybe",
    "no.such.key = 1",
    "mqtt { max_inflight = ",
])
def test_invalid_values_raise_the_same_error(text):
    errs = []
    for C in (RC, PC):
        try:
            C.Config(file_text=text, env={})
            errs.append(None)
        except Exception as e:  # noqa: BLE001 - compared, not swallowed
            errs.append((type(e).__name__, str(e)))
    assert errs[0] is not None
    assert errs[1] == errs[0]
