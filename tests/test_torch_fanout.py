"""The port's batched fanout pipeline (``emqx_tpu_torch/broker/fanout.py``)
against the reference's (``emqx_tpu/broker/fanout.py``).

Each case of the reference's node-free fanout tests
(``tests/test_fanout.py``) runs here as one scenario, written once over a
kit of classes (Broker, FanoutPipeline, SubOpts, make_message, Metrics,
the fault injector), and is played on the reference's kit and on the
port's: the observations (what each client was sent, in order, with its
QoS and packet id; what was dropped and why; the pipeline's counters)
must be equal, and the reference test's own assertions must hold on the
port's.  A numpy-seeded script of subscriptions (exact, ``+``, ``#``,
``$share`` groups, No-Local, granted QoS) and bursts of offers is played
the same way, and once more with the port's match service (plain walks
on the CPU) feeding ``prefetch_many``.  ``SharedSub.pick_batch`` is held
to the per-message ``pick`` sequence and to the reference's, strategy by
strategy.
"""

import asyncio
import gc
import random
from types import SimpleNamespace

import numpy as np
import pytest

from emqx_tpu import faultinject as ref_fi
from emqx_tpu.broker import Broker as RefBroker
from emqx_tpu.broker import FanoutPipeline as RefFanout
from emqx_tpu.broker import SharedSub as RefSharedSub
from emqx_tpu.broker import SubOpts as RefSubOpts
from emqx_tpu.broker import make_message as ref_make_message
from emqx_tpu.observe.metrics import Metrics as RefMetrics
from emqx_tpu_torch import faultinject as port_fi
from emqx_tpu_torch.broker.broker import Broker
from emqx_tpu_torch.broker.fanout import FanoutPipeline
from emqx_tpu_torch.broker.match_service import MatchService
from emqx_tpu_torch.broker.session import SubOpts
from emqx_tpu_torch.broker.message import make_message
from emqx_tpu_torch.broker.shared_sub import STRATEGIES, SharedSub
from emqx_tpu_torch.observe import Metrics

REF = SimpleNamespace(name="ref", Broker=RefBroker, Fanout=RefFanout,
                      SubOpts=RefSubOpts, make_message=ref_make_message,
                      Metrics=RefMetrics, SharedSub=RefSharedSub, fi=ref_fi)
PORT = SimpleNamespace(name="port", Broker=Broker, Fanout=FanoutPipeline,
                       SubOpts=SubOpts, make_message=make_message,
                       Metrics=Metrics, SharedSub=SharedSub, fi=port_fi)
#: the pipeline counters both sides must agree on (batch sizes and the
#: flush time follow the wall clock's arrival rate, so they are not here)
COUNTERS = ("broker.fanout.msgs", "broker.fanout.bypass",
            "broker.fanout.overflow", "broker.fanout.fallback",
            "broker.fanout.errors", "broker.fanout.shape_bypass")


def run(coro):
    return asyncio.run(coro)


def msg(kit, topic="t", qos=0, payload=b"x", sender="pub", **kw):
    return kit.make_message(sender, topic, payload, qos=qos, **kw)


async def start_pipeline(kit, broker, **kw):
    kw.setdefault("window_s", 0.0)  # flush on the next loop tick
    p = kit.Fanout(broker, **kw)
    await p.start()
    broker.fanout = p
    return p


async def settle(p, timeout=5.0):
    """Wait until the pipeline's queue is drained and idle."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while (p._q or p._busy) and loop.time() < deadline:
        await asyncio.sleep(0.002)
    await asyncio.sleep(0.01)


class Recorder:
    """``on_deliver`` and the ``message.dropped`` tap of one broker: the
    sends of each emit, and the drops with their reasons."""

    def __init__(self, broker) -> None:
        self.emits = []
        self.drops = []
        broker.on_deliver = lambda cid, pubs: self.emits.append(
            (cid, list(pubs)))
        broker.hooks.add("message.dropped",
                         lambda m, r: self.drops.append((m.payload, r)))

    def sent(self):
        """client -> [(payload, qos, pid is set, topic)] in send order."""
        out = {}
        for cid, pubs in self.emits:
            out.setdefault(cid, []).extend(
                (p.msg.payload, p.msg.qos, p.pid is not None, p.msg.topic)
                for p in pubs)
        return out


def counters(m):
    return {k: m.get(k) for k in COUNTERS}


def both(scenario, *args):
    """``scenario`` on the reference's kit and on the port's; the two
    observations must be equal.  Returns the port's."""
    want = run(scenario(REF, *args))
    got = run(scenario(PORT, *args))
    assert got == want
    return got


# -- delivery parity and grouping (tests/test_fanout.py:44-122) ------------

async def _parity_with_publish(kit):
    b = kit.Broker()
    rec = Recorder(b)
    b.open_session("s1")
    b.open_session("s2")
    b.subscribe("s1", "sensors/+/temp", kit.SubOpts(qos=1))
    b.subscribe("s2", "sensors/#", kit.SubOpts(qos=0))
    p = await start_pipeline(kit, b)
    assert p.offer(msg(kit, topic="sensors/kitchen/temp", qos=1))
    await settle(p)
    await p.stop()
    return rec.sent(), rec.drops


def test_fanout_delivery_parity_with_publish():
    sent, _drops = both(_parity_with_publish)
    assert sent["s1"][0][1:3] == (1, True)      # QoS1 kept at 1
    assert sent["s2"][0][1:3] == (0, False)     # capped to granted 0
    assert sent["s1"][0][0] == b"x"


async def _groups_and_emits_once(kit):
    b = kit.Broker()
    rec = Recorder(b)
    b.open_session("sub")
    b.subscribe("sub", "bench/#", kit.SubOpts(qos=0))
    p = await start_pipeline(kit, b)
    for i in range(50):
        assert p.offer(msg(kit, topic=f"bench/{i}",
                           payload=str(i).encode()))
    await settle(p)
    emits, msgs = len(rec.emits), p.msgs
    await p.stop()
    return rec.sent(), emits < 50, msgs, p.batches >= 1


def test_fanout_groups_session_deliveries_and_emits_once():
    sent, fewer_emits, msgs, batched = both(_groups_and_emits_once)
    assert len(sent["sub"]) == 50
    assert fewer_emits and msgs == 50 and batched


async def _ordering(kit):
    b = kit.Broker()
    rec = Recorder(b)
    b.open_session("sub")
    b.subscribe("sub", "t", kit.SubOpts(qos=0))
    p = await start_pipeline(kit, b)
    for i in range(200):
        assert p.offer(msg(kit, topic="t", payload=str(i).encode()))
        if i % 37 == 0:
            await asyncio.sleep(0)  # interleave with the drain loop
    await settle(p)
    await p.stop()
    return [int(x[0]) for x in rec.sent()["sub"]]


def test_fanout_ordering_per_client_topic_preserved():
    assert both(_ordering) == list(range(200))


async def _zero_copy(kit):
    b = kit.Broker()
    rec = Recorder(b)
    for c in ("a", "b", "c"):
        b.open_session(c)
        b.subscribe(c, "t/#", kit.SubOpts(qos=0))
    p = await start_pipeline(kit, b)
    m = msg(kit, topic="t/1", qos=0)
    assert p.offer(m)
    await settle(p)
    await p.stop()
    got = {cid: pubs[0].msg for cid, pubs in rec.emits}
    return got["a"] is got["b"] is got["c"] is m


def test_fanout_zero_copy_shares_message_across_subscribers():
    assert both(_zero_copy) is True


def test_fanout_leaves_no_message_publish_cycle():
    """The QoS0 fan-out shares one Publish cached on the message; the
    port drops that cache after the batch, so that the message and its
    Publish die by refcount (the reference keeps the cycle)."""
    async def main():
        b = Broker()
        b.on_deliver = lambda cid, pubs: None
        for c in ("a", "b"):
            b.open_session(c)
            b.subscribe(c, "t/#")
        b.open_session("q")
        b.subscribe("q", "t/#", SubOpts(qos=1))
        p = await start_pipeline(PORT, b)
        ms = [msg(PORT, topic=f"t/{i}", qos=i % 2) for i in range(6)]
        for m in ms:
            assert p.offer(m)
        await settle(p)
        await p.stop()
        assert all("_pub0" not in m.__dict__ for m in ms)
    run(main())


# -- semantics under batching (:129-202) ------------------------------------

async def _shared_round_robin(kit):
    b = kit.Broker(shared_strategy="round_robin")
    rec = Recorder(b)
    for c in ("c1", "c2"):
        b.open_session(c)
        b.subscribe(c, "$share/g/t/#", kit.SubOpts(qos=1))
    p = await start_pipeline(kit, b)
    for i in range(4):
        assert p.offer(msg(kit, topic="t/x", payload=str(i).encode()))
    await settle(p)
    await p.stop()
    return sorted((cid, x[0]) for cid, xs in rec.sent().items() for x in xs)


def test_fanout_shared_round_robin_unchanged():
    assert both(_shared_round_robin) == [
        ("c1", b"0"), ("c1", b"2"), ("c2", b"1"), ("c2", b"3")]


async def _no_local_veto_no_subscribers(kit):
    b = kit.Broker()
    rec = Recorder(b)
    b.open_session("c1")
    b.subscribe("c1", "t", kit.SubOpts(nl=True))
    p = await start_pipeline(kit, b)
    assert p.offer(msg(kit, topic="t", sender="c1", payload=b"nl"))
    assert p.offer(msg(kit, topic="nobody/listens", payload=b"none"))
    vetoed = msg(kit, topic="t", sender="other", payload=b"veto")
    vetoed.headers["allow_publish"] = False        # upstream veto
    assert p.offer(vetoed)
    assert p.offer(msg(kit, topic="t", sender="other", payload=b"lands"))
    await settle(p)
    await p.stop()
    senders = [p_.msg.sender for _cid, pubs in rec.emits for p_ in pubs]
    return senders, rec.drops


def test_fanout_no_local_and_veto_and_no_subscribers():
    senders, drops = both(_no_local_veto_no_subscribers)
    assert senders == ["other"]
    assert (b"none", "no_subscribers") in drops


async def _qos1_window(kit):
    b = kit.Broker()
    sess, _ = b.open_session("sub", max_inflight=2)
    b.subscribe("sub", "t", kit.SubOpts(qos=1))
    p = await start_pipeline(kit, b)
    for i in range(5):
        assert p.offer(msg(kit, topic="t", qos=1, payload=str(i).encode()))
    await settle(p)
    sends = b.take_outbox("sub")
    queued = len(sess.mqueue)
    _, more = sess.puback(sends[0].pid)
    await p.stop()
    return ([(s.pid, s.msg.payload) for s in sends], queued,
            [(s.pid, s.msg.payload) for s in more])


def test_fanout_qos1_inflight_window_and_queue():
    sends, queued, more = both(_qos1_window)
    assert len(sends) == 2 and queued == 3       # window 2, rest queued
    assert len(more) == 1                        # the queue drains on ack


async def _invalid_topic(kit):
    b = kit.Broker()
    p = await start_pipeline(kit, b)
    try:
        with pytest.raises(ValueError):
            p.offer(msg(kit, topic="bad/+/wildcard-in-name"))
    finally:
        await p.stop()
    return True


def test_fanout_invalid_topic_raises_at_offer():
    assert both(_invalid_topic)


# -- fallback paths (:209-399) ----------------------------------------------

def test_fanout_refuses_when_not_running():
    for kit in (REF, PORT):
        b = kit.Broker()
        p = kit.Fanout(b)  # never started
        assert p.offer(msg(kit)) is False
        assert b.fanout is None


async def _low_rate_bypass(kit):
    b = kit.Broker()
    rec = Recorder(b)
    b.open_session("sub")
    b.subscribe("sub", "t", kit.SubOpts())
    m = kit.Metrics()
    p = await start_pipeline(kit, b, bypass_rate=1e9, metrics=m)
    first = p.offer(msg(kit, topic="t"))     # idle + low rate: refused
    bypassed = m.get("broker.fanout.bypass")
    p.bypass_rate = 0.0
    second = p.offer(msg(kit, topic="t", payload=b"2"))
    p.bypass_rate = 1e9
    third = p.offer(msg(kit, topic="t", payload=b"3"))  # queued behind
    await settle(p)
    await p.stop()
    return first, bypassed, second, third, rec.sent(), counters(m)


def test_fanout_low_rate_bypass_refuses_only_when_idle():
    first, bypassed, second, third, sent, _c = both(_low_rate_bypass)
    assert first is False and bypassed == 1
    assert second and third
    assert [x[0] for x in sent["sub"]] == [b"2", b"3"]


async def _overflow(kit):
    b = kit.Broker()
    b.open_session("sub")
    b.subscribe("sub", "t", kit.SubOpts())
    m = kit.Metrics()
    p = kit.Fanout(b, queue_cap=4, metrics=m)
    p._running = True  # no drain task: the queue can only fill
    accepted = [p.offer(msg(kit, topic="t")) for _ in range(5)]
    p._running = False
    return accepted, counters(m)


def test_fanout_overflow_sheds_to_sync_path():
    accepted, c = both(_overflow)
    assert accepted == [True] * 4 + [False]
    assert c["broker.fanout.overflow"] == 1


async def _stop_drains(kit):
    b = kit.Broker()
    rec = Recorder(b)
    b.open_session("sub")
    b.subscribe("sub", "t", kit.SubOpts())
    p = kit.Fanout(b, window_s=60.0)  # the batch never flushes itself
    await p.start()
    for i in range(3):
        assert p.offer(msg(kit, topic="t", payload=str(i).encode()))
    await p.stop()
    return [int(x[0]) for x in rec.sent()["sub"]]


def test_fanout_stop_drains_queue_via_sync_publish():
    assert both(_stop_drains) == [0, 1, 2]


async def _raising_hook(kit):
    b = kit.Broker()
    rec = Recorder(b)
    b.open_session("sub")
    b.subscribe("sub", "t", kit.SubOpts(qos=0))

    def bomb(cid, m):
        if m.payload == b"boom":
            raise RuntimeError("hook exploded")

    b.hooks.add("message.delivered", bomb)
    m = kit.Metrics()
    p = await start_pipeline(kit, b, metrics=m)
    assert p.offer(msg(kit, topic="t", payload=b"boom"))
    await settle(p)
    assert p.offer(msg(kit, topic="t", payload=b"after"))
    await settle(p)
    alive = not p._task.done()
    await p.stop()
    return alive, [x[0] for x in rec.sent()["sub"]], counters(m)


def test_fanout_drain_loop_survives_raising_hook():
    alive, payloads, c = both(_raising_hook)
    assert alive
    assert b"after" in payloads
    assert c["broker.fanout.fallback"] >= 1


async def _plan_failure(kit):
    b = kit.Broker()
    rec = Recorder(b)
    b.open_session("sub")
    b.subscribe("sub", "t", kit.SubOpts(qos=0))
    folds = []
    b.hooks.add("message.publish", lambda m: folds.append(m.payload))
    calls = {"n": 0}

    def flaky_device_match(topic):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("device fell over")
        return None                          # the host trie serves

    b.device_match = flaky_device_match
    p = await start_pipeline(kit, b)
    assert p.offer(msg(kit, topic="t", payload=b"0"))
    assert p.offer(msg(kit, topic="t", payload=b"1"))
    await settle(p)
    await p.stop()
    return sorted(x[0] for x in rec.sent()["sub"]), sorted(folds)


def test_fanout_plan_failure_falls_back_without_double_fold():
    sent, folds = both(_plan_failure)
    assert sent == [b"0", b"1"]
    assert folds == [b"0", b"1"]             # one fold per message


class RecordingMatchService:
    def __init__(self):
        self.calls = []

    async def prefetch_many(self, topics):
        self.calls.append(dict(topics))


async def _prefetch_one_call(kit):
    b = kit.Broker()
    b.open_session("sub")
    b.subscribe("sub", "a/#", kit.SubOpts(qos=0))
    ms = RecordingMatchService()
    p = await start_pipeline(kit, b, match_service=ms)
    for t, q in (("a/1", 0), ("a/2", 1), ("a/3", 0), ("a/2", 0)):
        assert p.offer(msg(kit, topic=t, qos=q))
    await settle(p)
    await p.stop()
    return ms.calls


def test_fanout_batch_prefetches_topics_in_one_call():
    calls = both(_prefetch_one_call)
    # one call for the batch, a {topic: max qos} mapping
    assert calls == [{"a/1": 0, "a/2": 1, "a/3": 0}]


async def _stop_requeues(kit):
    class StalledMatchService:
        async def prefetch_many(self, topics):
            await asyncio.Event().wait()     # never returns

    b = kit.Broker()
    rec = Recorder(b)
    b.open_session("sub")
    b.subscribe("sub", "t", kit.SubOpts(qos=0))
    p = await start_pipeline(kit, b, match_service=StalledMatchService())
    for i in range(5):
        assert p.offer(msg(kit, topic="t", payload=str(i).encode()))
    await asyncio.sleep(0.02)                # the batch pops, then stalls
    in_flight = p._busy and not p._q
    await p.stop()
    return in_flight, [int(x[0]) for x in rec.sent()["sub"]]


def test_fanout_stop_requeues_inflight_batch():
    assert both(_stop_requeues) == (True, [0, 1, 2, 3, 4])


async def _metrics(kit):
    b = kit.Broker()
    b.open_session("sub")
    b.subscribe("sub", "t", kit.SubOpts())
    m = kit.Metrics()
    p = await start_pipeline(kit, b, metrics=m)
    for _ in range(10):
        p.offer(msg(kit, topic="t"))
    await settle(p)
    await p.stop()
    return (counters(m), m.get("broker.fanout.batches") >= 1,
            m.get("broker.fanout.batch_size") >= 1,
            m.get("broker.fanout.flush_us") >= 0,
            m.get("broker.fanout.depth"))


def test_fanout_metrics_accounting():
    c, batches, size, flush, depth = both(_metrics)
    assert c["broker.fanout.msgs"] == 10
    assert batches and size and flush and depth == 0


def test_fanout_adaptive_batch_bound_tracks_rate():
    for kit in (REF, PORT):
        p = kit.Fanout(kit.Broker(), max_batch=2048, min_batch=8,
                       adapt_window_s=0.05)
        bounds = []
        for rate in (0.0, 10_000.0, 1e9):
            p._last_rate = rate
            bounds.append(p._batch_bound())
        assert bounds == [8, 500, 2048]     # floor, 50 ms of 10k/s, cap


# -- batched shared dispatch (:459-519) -------------------------------------

@pytest.mark.parametrize("strategy", STRATEGIES)
def test_shared_pick_batch_matches_pick_sequence(strategy):
    """pick_batch assigns what the same sequence of picks would, leaves
    the strategy's state where they would, and equals the reference's,
    over several calls with several senders."""
    subs = [SharedSub(strategy, seed=7), SharedSub(strategy, seed=7),
            RefSharedSub(strategy, seed=7)]
    for s in subs:
        for cid, node in (("c1", "local"), ("c2", "n2"), ("c3", "local"),
                          ("c4", "local")):
            s.subscribe("g", "t/#", cid, node)
    serial, batched, ref = subs
    rng = np.random.default_rng(11)
    for call in range(4):
        keys = [(f"t/{rng.integers(50)}", f"snd{rng.integers(5)}")
                for _ in range(int(rng.integers(1, 12)))]
        want = [serial.pick("g", "t/#", t, snd) for t, snd in keys]
        assert batched.pick_batch("g", "t/#", keys) == want, call
        assert ref.pick_batch("g", "t/#", keys) == want, call
        if call == 1:
            for s in subs:        # a member leaves between calls
                s.unsubscribe("g", "t/#", "c3", "local")
    assert batched.pick("g", "t/#", "t/x", "snd") == \
        serial.pick("g", "t/#", "t/x", "snd")
    assert batched.pick_batch("g", "none", [("t/x", None)]) == [None]


async def _shared_sticky(kit):
    b = kit.Broker(shared_strategy="sticky")
    b.shared._rng = random.Random(5)
    rec = Recorder(b)
    for c in ("c1", "c2"):
        b.open_session(c)
        b.subscribe(c, "$share/g/t/#", kit.SubOpts(qos=1))
    p = await start_pipeline(kit, b)
    for i in range(6):
        assert p.offer(msg(kit, topic="t/x", payload=str(i).encode()))
    await settle(p)
    await p.stop()
    return [(cid, int(x[0])) for cid, xs in rec.sent().items() for x in xs]


def test_fanout_shared_sticky_unchanged():
    got = both(_shared_sticky)
    assert len({cid for cid, _ in got}) == 1   # one member takes the batch
    assert [pl for _, pl in got] == list(range(6))


async def _shared_nack(kit):
    b = kit.Broker(shared_strategy="round_robin")
    rec = Recorder(b)
    for c in ("c1", "c2"):
        b.open_session(c)
        b.subscribe(c, "$share/g/t/#", kit.SubOpts(qos=0))
    del b.sessions["c2"]          # a member gone without an unsubscribe
    p = await start_pipeline(kit, b)
    for i in range(4):
        assert p.offer(msg(kit, topic="t/x", payload=str(i).encode()))
    await settle(p)
    await p.stop()
    return [(cid, int(x[0])) for cid, xs in rec.sent().items()
            for x in xs], rec.drops


def test_shared_batch_nack_redispatches_to_other_member():
    sent, drops = both(_shared_nack)
    assert [cid for cid, _ in sent] == ["c1"] * 4
    assert sorted(pl for _, pl in sent) == [0, 1, 2, 3]
    assert drops == []


async def _shared_queue_full(kit):
    """A member whose queue refuses messages of the batch: those go to
    the other member through the ack-aware redispatch."""
    b = kit.Broker(shared_strategy="round_robin")
    rec = Recorder(b)
    b.open_session("c1", max_inflight=1, max_mqueue_len=1)
    b.open_session("c2")
    for c in ("c1", "c2"):
        b.subscribe(c, "$share/g/t/#", kit.SubOpts(qos=1))
    p = await start_pipeline(kit, b)
    for i in range(8):
        assert p.offer(msg(kit, topic="t/x", qos=1,
                           payload=str(i).encode()))
    await settle(p)
    await p.stop()
    return rec.sent(), sorted(rec.drops)


def test_shared_batch_queue_full_redispatches():
    sent, _drops = both(_shared_queue_full)
    assert sum(len(v) for v in sent.values()) >= 4


# -- the shape gate (:526-569) ----------------------------------------------

async def _shape_gate(kit):
    b = kit.Broker()
    b.open_session("sub")
    b.subscribe("sub", "t", kit.SubOpts())
    m = kit.Metrics()
    p = await start_pipeline(kit, b, shape_routes=1.25, shape_probe_s=60.0,
                             metrics=m)
    obs = [p.offer(msg(kit, topic="t"))]     # no estimate yet: accepted
    await settle(p)
    obs.append(p._avg_routes)                # measured 1 leg a message
    obs.append(p.offer(msg(kit, topic="t")))  # the first gated: a probe
    await settle(p)
    obs.append(p.offer(msg(kit, topic="t")))  # within the probe window
    obs.append(m.get("broker.fanout.shape_bypass"))
    for c in ("s2", "s3", "s4"):             # the fan-out grows
        b.open_session(c)
        b.subscribe(c, "t", kit.SubOpts())
    p._shape_probe_at = 0.0                  # a probe is due
    obs.append(p.offer(msg(kit, topic="t")))
    await settle(p)
    obs.append(p._avg_routes > 1.25)         # the EWMA pulled up
    obs.append(p.offer(msg(kit, topic="t")))  # the gate released
    obs.append(p.will_accept())
    await settle(p)
    await p.stop()
    return obs


def test_fanout_shape_gate_bypasses_1to1_and_releases_on_fanout():
    obs = both(_shape_gate)
    assert obs == [True, 1.0, True, False, 1, True, True, True, True]


async def _shape_gate_off(kit):
    b = kit.Broker()
    b.open_session("sub")
    b.subscribe("sub", "t", kit.SubOpts())
    p = await start_pipeline(kit, b)         # shape_routes=0 default
    accepted = []
    for i in range(20):
        accepted.append(p.offer(msg(kit, topic="t")))
        if i % 5 == 0:
            await settle(p)
    await settle(p)
    await p.stop()
    return accepted


def test_fanout_shape_gate_disabled_by_default_in_direct_use():
    assert both(_shape_gate_off) == [True] * 20


# -- the fanout.drain chaos seam ----------------------------------------------

async def _drain_fault(kit):
    """A raise at the seam kills the drain task before a batch pops (no
    supervisor here): the queue keeps the message, and stop() republishes
    it through the per-message path."""
    b = kit.Broker()
    rec = Recorder(b)
    b.open_session("sub")
    b.subscribe("sub", "t", kit.SubOpts())
    kit.fi.install(kit.fi.FaultInjector([
        {"point": "fanout.drain", "action": "raise", "times": 1}]))
    try:
        p = await start_pipeline(kit, b)
        assert p.offer(msg(kit, topic="t", payload=b"kept"))
        await asyncio.sleep(0.02)
        died = p._task.done() and isinstance(p._task.exception(),
                                             kit.fi.InjectedFault)
        queued = len(p._q)
        await p.stop()
    finally:
        kit.fi.uninstall()
    return died, queued, rec.sent()


def test_fanout_drain_seam_raise_kills_task_and_stop_redelivers():
    died, queued, sent = both(_drain_fault)
    assert died and queued == 1
    assert [x[0] for x in sent["sub"]] == [b"kept"]


# -- a seeded script ------------------------------------------------------------

FILTERS = ["a/b", "a/+", "a/#", "+/b", "#", "s/+/u", "$share/g/a/+",
           "$share/g/s/#", "$share/h/+/b", "$SYS/#", "x/y/z"]
TOPICS = ["a/b", "a/c", "s/t/u", "q/b", "$SYS/x", "x/y/z", "none", "a"]


def _script(seed):
    rng = np.random.default_rng(seed)
    subs = []
    for c in range(6):
        for f in rng.choice(len(FILTERS), 4, replace=False).tolist():
            subs.append((f"c{c}", FILTERS[f], int(rng.integers(3)),
                         bool(rng.random() < 0.3)))
    bursts = []
    for _ in range(6):
        bursts.append([(TOPICS[int(rng.integers(len(TOPICS)))],
                        int(rng.integers(3)), f"c{rng.integers(8)}")
                       for _ in range(int(rng.integers(1, 40)))])
    return subs, bursts


async def _scripted(kit, seed, with_service=False):
    b = kit.Broker(shared_strategy="round_robin")
    rec = Recorder(b)
    m = kit.Metrics()
    subs, bursts = _script(seed)
    for cid, flt, qos, nl in subs:
        if cid not in b.sessions:
            b.open_session(cid, max_inflight=8)
        b.subscribe(cid, flt, kit.SubOpts(qos=qos, nl=nl))
    ms = None
    if with_service:
        ms = MatchService(b, m, device="cpu", table="python", depth=8,
                          bypass_rate=0, debounce_s=0.01)
        await ms.start()
        for _ in range(2000):
            if ms.ready and ms._synced_epoch == b.router.epoch:
                break
            await asyncio.sleep(0.005)
        assert ms.ready
        b.device_match = ms.hint_routes
    # a fixed batch bound (each burst is one batch): the adaptive bound
    # follows the wall clock's arrival rate, and with it where the
    # batches split, which orders a client's legs from its shared and
    # its own subscriptions
    p = await start_pipeline(kit, b, metrics=m, match_service=ms,
                             min_batch=64, max_batch=64)
    k = 0
    for burst in bursts:
        for topic, qos, sender in burst:
            assert p.offer(msg(kit, topic=topic, qos=qos, sender=sender,
                               payload=str(k).encode()))
            k += 1
        await settle(p)
    await p.stop()
    served = None
    if ms is not None:
        served = m.get("tpu.match.hint_served")
        await ms.stop()
        gc.unfreeze()       # the service froze the started heap
    return rec.sent(), sorted(rec.drops), counters(m), served


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fanout_seeded_script_equals_reference(seed):
    sent, _drops, c, _ = both(_scripted, seed)
    assert c["broker.fanout.msgs"] == sum(map(len, _script(seed)[1]))
    assert sum(len(v) for v in sent.values()) > 0


def test_fanout_with_port_match_service_delivers_as_the_reference():
    """The port's fanout fed by the port's match service (plain walks on
    the CPU): the same sends to each client and the same drops as the
    reference's fanout on the host trie, with hints serving the planned
    topics.  A hint lists a topic's routes in another order than the
    trie, so a client's legs of one batch from several of its
    subscriptions may come in another order: each client's sends are
    compared as a multiset."""
    want = run(_scripted(REF, 4))
    got = run(_scripted(PORT, 4, with_service=True))
    assert {c: sorted(v) for c, v in got[0].items()} == \
        {c: sorted(v) for c, v in want[0].items()}
    assert got[1:3] == want[1:3]
    assert got[3] > 0


def test_fanout_unported_parameters_raise():
    """The node's seams (supervisor, olp with deferred_cap, hists with
    e2e_per_leg_sample, flightrec) are ported and taken as given; an
    unknown parameter raises TypeError, and the broker's admission shed,
    still unported, raises NotImplementedError."""
    from emqx_tpu_torch.broker.olp import Olp
    from emqx_tpu_torch.observe.flightrec import FlightRecorder
    from emqx_tpu_torch.observe.hist import HistSet
    from emqx_tpu_torch.supervise import Supervisor

    b = Broker()
    sup, olp = Supervisor(), Olp()
    hists, rec = HistSet("main"), FlightRecorder("trace")
    fp = FanoutPipeline(b, supervisor=sup, olp=olp, deferred_cap=8,
                        hists=hists, e2e_per_leg_sample=4, flightrec=rec)
    assert (fp.supervisor, fp.olp, fp.deferred_cap, fp.hists,
            fp.e2e_per_leg_sample, fp.flightrec) == (sup, olp, 8, hists, 4,
                                                     rec)
    assert fp._h_e2e_leg is hists.hist("obs.e2e.publish_deliver_leg")
    FanoutPipeline(b, supervisor=None, e2e_per_leg_sample=0)
    with pytest.raises(TypeError, match="no_such_knob"):
        FanoutPipeline(b, no_such_knob=1)
    b.admission = object()
    with pytest.raises(NotImplementedError, match="admission"):
        FanoutPipeline(b)
