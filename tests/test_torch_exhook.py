"""The port's exhook boundary against the reference's.

The generated messages and the hand-written stubs: the port's
``exhook_pb2`` carries the reference's serialized descriptor byte for
byte (so both modules import in one process and give one set of
classes), and every stub method path is the reference's.

The match sidecar: each sidecar case of ``tests/test_exhook.py`` and
seeded churn scripts (subscribe, unsubscribe, ``InstallSnapshot``,
``ApplyDeltas``, ``MatchBatch`` over workload filters and filters deeper
than the table, at A = 4 and K = 8 so that rows spill) run on one RPC
script against the reference's sidecar (JAX on the CPU) and the port's
(``device="cpu"``).  The mirror syncs only where the script says so:
both sidecars' ``_dirty`` event is wrapped in a gate that the script
opens, so each sync covers the same mutations on both sides and the
upload and delta counts are the reference's, not the machine's timing.
The transcripts (accept ids bit for bit, ``FilterTable``, acks,
``ValuedResponse``, ``Stats`` but its latencies, ``spill_fallbacks``,
uploads and delta applies) must be equal, and every row after a sync
equal to a ``FilterTrie`` of the live filters.

The broker side: each node case of ``tests/test_exhook.py`` runs with
one ``DemoProvider`` against the reference's ``BrokerNode`` and the
port's (``device="cpu"``), both driven by the reference's client, and
the clients' transcripts and the provider's event logs must be equal;
the chaos case of a notification sender killed mid-stream runs on the
port's manager.  End to end, the port's node feeds the port's sidecar,
and the reference's node feeds the port's sidecar.

The checkpoint: ``IncrementalNfa.snapshot()`` equals the reference's
after the same mutations, and a checkpoint written by either package's
sidecar restores into the other's and answers alike.  The CLI runs in a
subprocess with ``--device cpu``; without it, on a machine with no card,
it raises.  The intended divergence: a fault in the port's
``DeviceNfa.match`` makes ``MatchBatch`` and ``OnMessagePublish`` fail as
RPCs where the reference answers from the host.  A fault the port
copies: a ``MatchBatch`` of more than ``max_batch`` topics fails as an
RPC on both.
"""

import asyncio
import os
import random
import socket
import subprocess
import sys
import types

import grpc
import grpc.aio
import numpy as np
import pytest
import torch

import emqx_tpu.exhook.exhook_pb2 as ref_pb2
import emqx_tpu.exhook.rpc as ref_rpc
import emqx_tpu.exhook.server as ref_server
import emqx_tpu_torch.exhook.exhook_pb2 as port_pb2
import emqx_tpu_torch.exhook.rpc as port_rpc
import emqx_tpu_torch.exhook.server as port_server
from emqx_tpu.client import Client
from emqx_tpu.config import Config as RefConfig
from emqx_tpu.mqtt import packet as P
from emqx_tpu.node import BrokerNode as RefNode
from emqx_tpu.ops import IncrementalNfa as RefInc
from emqx_tpu.storage import checkpoint as ref_ckpt
from emqx_tpu_torch import topic as T
from emqx_tpu_torch.broker.trie import FilterTrie
from emqx_tpu_torch.config import Config as PortConfig
from emqx_tpu_torch.node import BrokerNode as PortNode
from emqx_tpu_torch.ops import IncrementalNfa as PortInc
from emqx_tpu_torch.storage import checkpoint as port_ckpt
from emqx_tpu_torch.workload import build_workload
from test_exhook import DemoProvider

REF, PORT = "ref", "port"
SIDES = {REF: (ref_rpc, ref_server), PORT: (port_rpc, port_server)}
pb = port_rpc.pb
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(coro):
    return asyncio.run(coro)


async def settle(pred, timeout=30.0, interval=0.01):
    deadline = asyncio.get_running_loop().time() + timeout
    while asyncio.get_running_loop().time() < deadline:
        if pred():
            return True
        await asyncio.sleep(interval)
    return pred()


# ---------------------------------------------------------------------------
# generated messages and stubs
# ---------------------------------------------------------------------------


def test_descriptor_is_the_references_byte_for_byte():
    assert port_pb2.DESCRIPTOR.serialized_pb == ref_pb2.DESCRIPTOR.serialized_pb
    assert port_pb2.DESCRIPTOR.name == "exhook.proto"
    assert port_pb2.DESCRIPTOR.package == "emqx.exhook.v2"
    # one pool entry: both modules hand out the same classes
    for name in ("Message", "MatchBatchRequest", "StatsResponse",
                 "SnapshotChunk", "ValuedResponse"):
        assert getattr(port_pb2, name) is getattr(ref_pb2, name)


class _RecChannel:
    """A channel stand-in that records every method path a stub binds."""

    def __init__(self):
        self.paths = []

    def _bind(self, kind):
        def bind(path, request_serializer, response_deserializer):
            self.paths.append((kind, path, request_serializer,
                               response_deserializer))
            return path
        return bind

    def __getattr__(self, kind):
        if kind in ("unary_unary", "stream_unary"):
            return self._bind(kind)
        raise AttributeError(kind)


class _RecServer:
    def __init__(self):
        self.services = []

    def add_generic_rpc_handlers(self, handlers):
        for h in handlers:
            self.services.append(h)


@pytest.mark.parametrize("stub", ["HookProviderStub", "MirrorSyncStub"])
def test_stub_method_paths_equal(stub):
    got = {}
    for side, (rpc, _) in SIDES.items():
        chan = _RecChannel()
        getattr(rpc, stub)(chan)
        got[side] = chan.paths
    assert got[PORT] == got[REF]
    assert len(got[PORT]) == (21 if stub == "HookProviderStub" else 5)
    assert all(p[1].startswith("/emqx.exhook.v2.") for p in got[PORT])


def test_server_registration_equal():
    class Full:
        async def InstallSnapshot(self, it, ctx):
            return None

    for name in list(ref_rpc.HOOK_METHODS) + ["MatchBatch", "Stats"]:
        setattr(Full, name, lambda self, req, ctx: None)
    got = {}
    for side, (rpc, _) in SIDES.items():
        srv = _RecServer()
        rpc.add_hook_provider_to_server(Full(), srv)
        rpc.add_mirror_sync_to_server(Full(), srv)
        got[side] = [h.service_name() for h in srv.services]
    assert got[PORT] == got[REF] == ["emqx.exhook.v2.HookProvider",
                                     "emqx.exhook.v2.MirrorSync"]
    assert port_rpc.HOOK_METHODS == ref_rpc.HOOK_METHODS
    assert port_rpc._MIRROR_UNARY == ref_rpc._MIRROR_UNARY


# ---------------------------------------------------------------------------
# the sidecar on one RPC script
# ---------------------------------------------------------------------------


class _Gate:
    """Wraps a sidecar's ``_dirty`` event: its sync loop passes ``wait``
    only when the mirror is dirty and the script opened the gate."""

    def __init__(self, ev: asyncio.Event):
        self.ev = ev
        self.go = asyncio.Event()

    def set(self):
        self.ev.set()

    def clear(self):
        self.ev.clear()

    def is_set(self):
        return self.ev.is_set()

    async def wait(self):
        await self.ev.wait()
        await self.go.wait()
        self.go.clear()


def synced(sc) -> bool:
    return (sc._engine is not None and not sc._dirty.is_set()
            and sc._eng.dev.epoch == sc._eng.inc.epoch)


def make_sidecar(side, **kw):
    if side == REF:
        return ref_server.TpuMatchSidecar(**kw)
    return port_server.TpuMatchSidecar(device="cpu", **kw)


class Harness:
    """One side's sidecar behind a local gRPC server, with its stubs."""

    def __init__(self, side, gate=True, **kw):
        self.side = side
        kw.setdefault("rebuild_debounce_s", 0.0)
        self.sc = make_sidecar(side, **kw)
        self.gate = None
        if gate:
            self.gate = self.sc._dirty = _Gate(self.sc._dirty)

    async def __aenter__(self):
        rpc = SIDES[self.side][0]
        self.server = grpc.aio.server()
        rpc.add_hook_provider_to_server(self.sc, self.server)
        rpc.add_mirror_sync_to_server(self.sc, self.server)
        self.port = self.server.add_insecure_port("127.0.0.1:0")
        await self.sc.start()
        await self.server.start()
        self.chan = grpc.aio.insecure_channel(f"127.0.0.1:{self.port}")
        self.hooks = rpc.HookProviderStub(self.chan)
        self.mirror = rpc.MirrorSyncStub(self.chan)
        return self

    async def __aexit__(self, *exc):
        await self.chan.close()
        await self.sc.stop()
        await self.server.stop(None)

    async def sync(self):
        """Open the gate for one sync when the mirror is dirty, and wait
        for it; returns whether one ran."""
        if not self.sc._dirty.is_set():
            return False
        self.gate.go.set()
        assert await settle(lambda: synced(self.sc)), self.side
        return True

    # -- steps: each returns what the transcript records ---------------

    async def loaded(self):
        resp = await self.hooks.OnProviderLoaded(
            pb.ProviderLoadedRequest(meta=pb.RequestMeta(node="n1")))
        return [h.name for h in resp.hooks]

    async def sub(self, flt, cid="c"):
        await self.hooks.OnSessionSubscribed(pb.SessionSubscribedRequest(
            clientinfo=pb.ClientInfo(clientid=cid), topic=flt))
        return None

    async def unsub(self, flt, cid="c"):
        await self.hooks.OnSessionUnsubscribed(pb.SessionUnsubscribedRequest(
            clientinfo=pb.ClientInfo(clientid=cid), topic=flt))
        return None

    async def snapshot(self, epoch, items, chunk=1024):
        async def chunks():
            if not items:
                yield pb.SnapshotChunk(epoch=epoch, last=True)
            for i in range(0, len(items), chunk):
                part = items[i:i + chunk]
                yield pb.SnapshotChunk(
                    epoch=epoch, filters=[f for f, _ in part],
                    refcounts=[c for _, c in part],
                    last=i + chunk >= len(items))

        ack = await self.mirror.InstallSnapshot(chunks())
        return (ack.epoch, ack.n_filters, ack.rebuilt)

    async def deltas(self, ops, to_epoch):
        req = pb.DeltaBatch(from_epoch=0, to_epoch=to_epoch)
        for op, flt in ops:
            req.deltas.add(op=pb.DeltaBatch.Delta.ADD if op == "add"
                           else pb.DeltaBatch.Delta.DEL, filter=flt)
        ack = await self.mirror.ApplyDeltas(req)
        return (ack.epoch, ack.n_filters, ack.rebuilt)

    async def match(self, topics):
        """Accept ids of each row, and each row's filters resolved over
        the wire through ``FilterTable``."""
        resp = await self.mirror.MatchBatch(pb.MatchBatchRequest(
            topics=topics))
        ft = await self.mirror.FilterTable(pb.FilterTableRequest())
        assert ft.table_version == resp.table_version
        table = list(ft.filters)
        ids = [list(r.filter_ids) for r in resp.results]
        return (resp.epoch, resp.table_version, ids,
                [sorted(table[i] for i in row) for row in ids])

    async def publish(self, topic):
        resp = await self.hooks.OnMessagePublish(pb.MessagePublishRequest(
            message=pb.Message(topic=topic, payload=b"x")))
        return (resp.type, resp.WhichOneof("value"),
                dict(resp.message.headers))

    async def table(self):
        ft = await self.mirror.FilterTable(pb.FilterTableRequest())
        assert list(ft.filters) == self.sc.filter_table()
        return (ft.table_version, list(ft.filters))

    async def stats(self):
        st = await self.mirror.Stats(pb.StatsRequest())
        return (st.epoch, st.n_filters, st.n_states, st.batches,
                st.topics_matched, st.pending_deltas, dict(st.extra))

    def counters(self):
        d = self.sc._eng.dev
        return (self.sc.spill_fallbacks, d.uploads, d.delta_applies,
                self.sc.syncs)


async def _play(side, script, **kw):
    out = []
    async with Harness(side, **kw) as h:
        for op, *args in script:
            got = await getattr(h, op)(*args)
            out.append((op, got))
        out.append(("counters", h.counters()))
    return out


def play_both(script, **kw):
    """The script's transcript on the reference's sidecar and on the
    port's: equal, or the test fails.  Returns the port's."""
    ref = run(_play(REF, script, **kw))
    port = run(_play(PORT, script, **kw))
    assert len(port) == len(ref)
    for i, (a, b) in enumerate(zip(ref, port)):
        assert a == b, (i, script[i] if i < len(script) else "counters",
                        a, b)
    return port


def _steps(out, op):
    return [got for o, got in out if o == op]


FILTERS = ["s/+/t", "s/#", "a/b", "+/b", "$SYS/x", "deep/+/x/#"]
TOPICS = ["s/1/t", "s/9/zz", "a/b", "$SYS/x", "nomatch/q", "deep/k/x/y/z"]


def oracle(filters, topic):
    return sorted(f for f in filters if T.match(topic, f))


def test_sidecar_delta_feed_and_match_batch():
    script = ([("loaded",)] + [("sub", f) for f in FILTERS]
              + [("sync",), ("match", TOPICS), ("table",),
                 ("unsub", "a/b"), ("sync",), ("table",), ("stats",)])
    out = play_both(script)
    names = _steps(out, "loaded")[0]
    assert "session.subscribed" in names and "message.publish" in names
    (_, _, _, rows), = _steps(out, "match")
    assert rows == [oracle(FILTERS, t) for t in TOPICS]
    assert "a/b" in _steps(out, "table")[0][1]
    assert "a/b" not in _steps(out, "table")[1][1]
    st = _steps(out, "stats")[0]
    assert st[1] == len(FILTERS) - 1 and st[3] >= 1


def test_sidecar_snapshot_install_and_publish_hook():
    items = list(zip(FILTERS, [1, 2, 1, 1, 1, 1]))
    script = [("snapshot", 7, items, 3), ("sync",), ("publish", "s/1/t"),
              ("publish", "nomatch/q"), ("stats",)]
    out = play_both(script, annotate=True)
    assert _steps(out, "snapshot")[0] == (7, len(FILTERS), False)
    typ, which, headers = _steps(out, "publish")[0]
    assert typ == pb.ValuedResponse.STOP_AND_RETURN and which == "message"
    assert headers["matched_filters"] == str(len(oracle(FILTERS, "s/1/t")))
    assert _steps(out, "publish")[1][2]["matched_filters"] == "0"


def test_sidecar_deep_filters_merge_host_side():
    deep, shallow = "a/b/c/d/e/+/g", "a/#"
    script = [("sub", deep), ("sub", shallow), ("sync",),
              ("match", ["a/b/c/d/e/f/g", "a/x"])]
    out = play_both(script, depth=4)
    (_, _, _, rows), = _steps(out, "match")
    assert rows == [sorted([deep, shallow]), [shallow]]


def test_sidecar_overflow_reruns_spills_on_the_host_trie():
    flts = ["a/b/c", "+/b/c", "a/+/c", "a/b/+", "+/+/c", "a/+/+",
            "+/b/+", "+/+/+", "a/#", "#"]
    topics = ["a/b/c", "z/b/c", "none"]
    script = ([("sub", f) for f in flts]
              + [("sync",), ("match", topics), ("stats",)])
    out = play_both(script, active_slots=2, max_matches=4)
    (_, _, _, rows), = _steps(out, "match")
    assert rows == [oracle(flts, t) for t in topics]
    spills = out[-1][1][0]
    assert spills >= 1
    assert int(_steps(out, "stats")[0][6]["spill_fallbacks"]) == spills


def test_sidecar_incremental_no_reupload_under_churn():
    script = [("sub", f"base/{i}/+") for i in range(64)] + [("sync",),
                                                           ("stats",)]
    for i in range(40):
        script.append(("sub", f"churn/{i}"))
        if i % 2:
            script.append(("unsub", f"churn/{i}"))
    script += [("sync",), ("match", ["churn/2", "base/3/x"]), ("stats",)]
    out = play_both(script)
    before, after = _steps(out, "stats")
    assert before[6]["device_uploads"] == after[6]["device_uploads"]
    assert int(after[6]["device_delta_applies"]) >= 1
    (_, _, _, rows), = _steps(out, "match")
    assert rows == [["churn/2"], ["base/3/+"]]


def _deep_filters(rng, n):
    """Filters of 9-12 levels (deeper than the table's 8)."""
    out = set()
    while len(out) < n:
        lv = rng.randint(9, 12)
        ws = [rng.choice(("x", "y", "+")) for _ in range(lv)]
        if rng.random() < 0.3:
            ws[-1] = "#"
        out.add("/".join(ws))
    return sorted(out)


def _deep_topics(rng, n):
    return ["/".join(rng.choice(("x", "y", "z"))
                     for _ in range(rng.randint(9, 13))) for _ in range(n)]


def churn_script(seed, n_ops=300):
    """A seeded RPC script: an InstallSnapshot of most of ~2,000 filters,
    then subscribes, unsubscribes, delta batches, snapshots, syncs and
    matches (after a sync, and stale ones before it)."""
    rng = random.Random(seed)
    filters, topics = build_workload(np.random.default_rng(seed), 2000, 600)
    filters = list(filters) + _deep_filters(rng, 40)
    topics = list(topics) + _deep_topics(rng, 60)
    ref = {}
    items = [(f, rng.randint(1, 3)) for f in rng.sample(filters, 1500)]
    script = [("snapshot", 1, sorted(items)), ("sync",)]
    ref.update(items)
    epoch = 1
    for _ in range(n_ops):
        r = rng.random()
        if r < 0.3:
            f = rng.choice(filters)
            script.append(("sub", f))
            ref[f] = ref.get(f, 0) + 1
        elif r < 0.55 and ref:
            f = rng.choice(sorted(ref))
            script.append(("unsub", f))
            ref[f] -= 1
            if not ref[f]:
                del ref[f]
        elif r < 0.65:
            ops = []
            for _ in range(rng.randint(1, 30)):
                if rng.random() < 0.5 or not ref:
                    f = rng.choice(filters)
                    ops.append(("add", f))
                    ref[f] = ref.get(f, 0) + 1
                else:
                    f = rng.choice(sorted(ref))
                    ops.append(("del", f))
                    ref[f] -= 1
                    if not ref[f]:
                        del ref[f]
            epoch += 1
            script.append(("deltas", ops, epoch))
        elif r < 0.67:
            keep = [f for f in sorted(ref) if rng.random() < 0.9]
            new = rng.sample(filters, 50)
            items = sorted({**{f: ref[f] for f in keep},
                            **{f: 1 for f in new}}.items())
            epoch += 1
            script.append(("snapshot", epoch, items, 256))
            ref = dict(items)
        elif r < 0.92:
            script.append(("sync",))
            script.append(("match", rng.sample(topics, 64), sorted(ref)))
        elif r < 0.96:
            script.append(("match", rng.sample(topics, 64)))  # stale
        else:
            script.append(("stats",))
    script.append(("table",))
    return script


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_seeded_churn_equals_reference_and_oracle(seed):
    script = churn_script(seed)
    # the oracle's live set rides the script; the RPC takes the topics
    plain = [(s[0], s[1]) if s[0] == "match" else s for s in script]
    out = play_both(plain, active_slots=4, max_matches=8)
    checked = 0
    for step, (op, got) in zip(script, out):
        if op == "match" and len(step) == 3:
            trie = FilterTrie()
            for f in step[2]:
                trie.insert(f)
            assert got[3] == [sorted(trie.match(t)) for t in step[1]]
            checked += 1
    assert checked >= 50
    spills, uploads, applies, syncs = out[-1][1]
    assert spills > 0 and applies > 0 and syncs > 30


def test_match_batch_over_max_batch_fails_alike():
    """A fault of the reference that the port copies: the whole request
    is encoded at ``_bucket_batch(min(n, max_batch))`` rows, outside
    the device path's ``try``, so 4,097 topics fail as an RPC."""

    async def one(side):
        async with Harness(side, gate=False, rebuild_debounce_s=0.01) as h:
            await h.sub("a/+")
            assert await settle(lambda: synced(h.sc))
            ok = await h.match(["a/1"] * 4096)
            assert ok[3] == [["a/+"]] * 4096
            with pytest.raises(grpc.aio.AioRpcError) as ei:
                await h.match(["a/1"] * 4097)
            return ei.value.code(), ei.value.details()

    ref, port = run(one(REF)), run(one(PORT))
    assert ref == port
    assert ref[0] == grpc.StatusCode.UNKNOWN
    assert "4097 topics > batch 4096" in ref[1]


# ---------------------------------------------------------------------------
# the intended divergence: device errors are RPC errors
# ---------------------------------------------------------------------------


def _fail_match(*a, **kw):
    raise RuntimeError("injected device fault")


def test_device_fault_is_an_rpc_error_in_the_port():
    async def one(side, monkeypatch):
        async with Harness(side, gate=False, rebuild_debounce_s=0.01,
                           annotate=True) as h:
            for f in FILTERS:
                await h.sub(f)
            assert await settle(lambda: synced(h.sc))
            monkeypatch.setattr(h.sc._eng.dev, "match", _fail_match)
            out = {}
            try:
                out["match"] = (await h.match(TOPICS))[3]
            except grpc.aio.AioRpcError as e:
                out["match"] = e.code()
            try:
                out["publish"] = (await h.publish("s/1/t"))[2]
            except grpc.aio.AioRpcError as e:
                out["publish"] = e.code()
            monkeypatch.undo()
            # the next batch walks again
            out["after"] = (await h.match(TOPICS))[3]
            out["host_rows"] = getattr(h.sc, "host_rows", None)
            return out

    with pytest.MonkeyPatch.context() as mp:
        ref = run(one(REF, mp))
    with pytest.MonkeyPatch.context() as mp:
        port = run(one(PORT, mp))
    want = [oracle(FILTERS, t) for t in TOPICS]
    # the reference answers from the host trie
    assert ref["match"] == want
    assert ref["publish"]["matched_filters"] == str(
        len(oracle(FILTERS, "s/1/t")))
    # the port fails the RPCs; the broker's failure_action decides
    assert port["match"] == grpc.StatusCode.UNKNOWN
    assert port["publish"] == grpc.StatusCode.UNKNOWN
    assert port["after"] == ref["after"] == want
    assert port["host_rows"] == 0


def test_stalled_walk_fails_the_publish_in_the_port(monkeypatch):
    """A publish whose micro-batch does not come back in time fails with
    DEADLINE_EXCEEDED (counted); the host does not answer for the card,
    and once the walk returns the next publish is served by it."""
    queue_wait_s = port_server.QUEUE_WAIT_S
    monkeypatch.setattr(port_server, "QUEUE_WAIT_S", 0.2)

    async def main():
        async with Harness(PORT, gate=False, rebuild_debounce_s=0.01,
                           annotate=True) as h:
            for f in FILTERS:
                await h.sub(f)
            assert await settle(lambda: synced(h.sc))
            real = h.sc._device_rows

            def stalled(*a, **kw):
                import time

                time.sleep(0.6)
                return real(*a, **kw)

            monkeypatch.setattr(h.sc, "_device_rows", stalled)
            batches = h.sc.batches
            with pytest.raises(grpc.aio.AioRpcError) as e:
                await h.publish("s/1/t")
            assert e.value.code() == grpc.StatusCode.DEADLINE_EXCEEDED
            assert h.sc.queue_timeouts == 1 and h.sc.host_rows == 0
            monkeypatch.setattr(h.sc, "_device_rows", real)
            # the stalled batch drains: the batch loop has finished it
            assert await settle(lambda: h.sc.batches > batches)
            monkeypatch.setattr(port_server, "QUEUE_WAIT_S", queue_wait_s)
            got = await h.publish("s/1/t")
            assert got[2]["matched_filters"] == str(
                len(oracle(FILTERS, "s/1/t")))
            assert h.sc.queue_timeouts == 1 and h.sc.host_rows == 0

    run(main())


def test_port_counts_its_host_answers():
    """Before the first sync the sidecar answers from the host (counted);
    once synced, no row is served by the host beside spills, and each
    walk is a counted dispatch or the warm-up."""

    async def main():
        async with Harness(PORT) as h:
            for f in FILTERS:
                await h.sub(f)
            before = await h.match(TOPICS)
            assert h.sc.not_ready_rows == len(TOPICS)
            assert h.sc.device_batches == 0
            await h.sync()
            after = await h.match(TOPICS)
            assert after[3] == before[3]
            await asyncio.gather(*(h.publish(t) for t in TOPICS))
            sc = h.sc
            assert sc.host_rows == len(TOPICS)
            assert sc.warms == 1 and sc.device_batches >= 2
            assert sc.sync_failures == 0 and sc.queue_timeouts == 0

    run(main())


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------


def _mutate(inc, rng, filters):
    live = []
    for _ in range(600):
        if live and rng.random() < 0.35:
            inc.remove(live.pop(rng.randrange(len(live))))
        else:
            f = rng.choice(filters)
            if f not in live:
                inc.add(f)
                live.append(f)
    return inc


def test_snapshot_arrays_equal_reference():
    filters, _ = build_workload(np.random.default_rng(4), 800, 10)
    ref = _mutate(RefInc(depth=8), random.Random(4), filters).snapshot()
    port = _mutate(PortInc(depth=8), random.Random(4), filters).snapshot()
    for name in ("node_tab", "edge_tab", "seeds"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name))
    for name in ("n_states", "depth", "vocab", "accept_filters", "epoch"):
        assert getattr(port, name) == getattr(ref, name)


def test_checkpoint_roundtrip_matches(tmp_path):
    from emqx_tpu_torch.ops import compile_filters, match_topics

    filters = ["a/+/c", "a/#", "x/y", "$SYS/up", "+/b/#"]
    table = compile_filters(filters, depth=8)
    path = str(tmp_path / "nfa.npz")
    port_ckpt.save_table(table, path)
    loaded = port_ckpt.load_table(path)
    assert loaded is not None
    assert loaded.n_states == table.n_states
    assert loaded.accept_filters == table.accept_filters
    topics = ["a/q/c", "a/deep/er", "x/y", "$SYS/up", "q/b/z", "none"]
    got = match_topics(loaded, topics, device="cpu")
    for topic, row in zip(topics, got):
        assert sorted(row) == oracle(filters, topic), topic
    assert port_ckpt.load_table(str(tmp_path / "none.npz")) is None
    # the reference loads the port's file into the same table
    back = ref_ckpt.load_table(path)
    for name in ("node_tab", "edge_tab", "seeds"):
        np.testing.assert_array_equal(getattr(back, name),
                                      getattr(table, name))
    assert (back.n_states, back.depth, back.vocab, back.accept_filters,
            back.epoch) == (table.n_states, table.depth, table.vocab,
                            table.accept_filters, table.epoch)


CK_FILTERS = ["ck/+/a", "ck/#", "a/b/c/d/e/f/g/h/i/+"]
CK_TOPICS = ["ck/1/a", "nope", "a/b/c/d/e/f/g/h/i/j"]


async def _write_checkpoint(side, path):
    async with Harness(side, gate=False, rebuild_debounce_s=0.01,
                       checkpoint_path=path) as h:
        for f in CK_FILTERS:
            await h.sub(f)
        assert await settle(lambda: synced(h.sc) and os.path.exists(path))
        await asyncio.sleep(0.05)   # the save runs after the sync


async def _restore(side, path):
    async with Harness(side, gate=False, checkpoint_path=path) as h:
        assert h.sc._engine is not None      # serving before any feed
        return (await h.match(CK_TOPICS)), h.sc.filter_table()


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF),
                                           (PORT, PORT)])
def test_checkpoint_restores_across_packages(tmp_path, writer, reader):
    path = str(tmp_path / "sidecar.npz")
    run(_write_checkpoint(writer, path))
    got, table = run(_restore(reader, path))
    want, want_table = run(_restore(writer, path))
    assert got == want and table == want_table
    assert got[3] == [oracle(CK_FILTERS, t) for t in CK_TOPICS]


def test_emptied_mirror_removes_its_checkpoint(tmp_path):
    path = str(tmp_path / "sidecar.npz")
    run(_write_checkpoint(PORT, path))

    async def main():
        async with Harness(PORT, gate=False, rebuild_debounce_s=0.01,
                           checkpoint_path=path) as h:
            assert await h.snapshot(3, []) == (3, 0, False)
            assert await settle(lambda: not os.path.exists(path))

    run(main())


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_cli_serves_with_device_cpu():
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "emqx_tpu_torch.exhook.server", "--port",
         str(port), "--device", "cpu", "--annotate"],
        cwd=REPO, env=_env(), stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE)

    async def main():
        chan = grpc.aio.insecure_channel(f"127.0.0.1:{port}")
        hooks = port_rpc.HookProviderStub(chan)
        mirror = port_rpc.MirrorSyncStub(chan)
        try:
            await asyncio.wait_for(chan.channel_ready(), 60)
            await hooks.OnSessionSubscribed(
                pb.SessionSubscribedRequest(topic="cli/+"))
            for _ in range(500):
                st = await mirror.Stats(pb.StatsRequest())
                if st.n_states and not st.pending_deltas:
                    break
                await asyncio.sleep(0.02)
            resp = await mirror.MatchBatch(
                pb.MatchBatchRequest(topics=["cli/1", "x"]))
            ft = await mirror.FilterTable(pb.FilterTableRequest())
            pub = await hooks.OnMessagePublish(pb.MessagePublishRequest(
                message=pb.Message(topic="cli/2")))
            return ([[ft.filters[i] for i in r.filter_ids]
                     for r in resp.results],
                    pub.message.headers["matched_filters"])
        finally:
            await chan.close()

    try:
        rows, matched = run(main())
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    assert rows == [["cli/+"], []] and matched == "1"


def test_cli_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, "-m", "emqx_tpu_torch.exhook.server", "--port",
         str(_free_port())], cwd=REPO, env=_env(), capture_output=True,
        text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr


def test_sidecar_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_server.TpuMatchSidecar()


# ---------------------------------------------------------------------------
# the broker side: the manager in each package's node
# ---------------------------------------------------------------------------


async def start_provider(servicer, port=0):
    server = grpc.aio.server()
    ref_rpc.add_hook_provider_to_server(servicer, server)
    bound = server.add_insecure_port(f"127.0.0.1:{port}")
    await server.start()
    return server, bound


async def start_node(side, port, failure_action="ignore"):
    text = ('listeners.tcp.default.bind = "127.0.0.1:0"\n'
            f'exhook.servers = "default=127.0.0.1:{port}"\n'
            'exhook.request_timeout = 2s\n'
            f'exhook.failure_action = {failure_action}\n')
    if side == REF:
        node = RefNode(RefConfig(file_text=text))
    else:
        node = PortNode(PortConfig(file_text=text), device="cpu")
    await node.start()
    return node


def node_port(node):
    return node.listeners.all()[0].port


async def attempt(coro):
    """The awaited value, or the exception's type and text."""
    try:
        return await coro
    except Exception as e:  # noqa: BLE001 - the transcript records it
        return ("raised", type(e).__name__, str(e))


async def quiesce(node, provider):
    """Let the node's notification senders drain before it stops: every
    queue empty and the provider's log unchanged for 0.3 s."""
    mgr = node.exhook
    await settle(lambda: all(st.queue.empty() for st in mgr.servers), 10.0)
    seen, still = len(provider.events), 0
    while still < 3:
        await asyncio.sleep(0.1)
        n = len(provider.events)
        still = still + 1 if n == seen else 0
        seen = n


def _msg(m):
    return (m.topic, m.payload, m.qos) if hasattr(m, "topic") else m


def split_events(events):
    """The provider's log as (advisory calls in order, notifications in
    order per client): advisory round trips follow the clients' steps,
    notifications ride each server's queue."""
    advisory, notes = [], {}
    for e in events:
        if e[0] in ("loaded", "unloaded", "auth", "authz", "publish"):
            advisory.append(e)
        else:
            notes.setdefault(e[1], []).append(e)
    return advisory, notes


async def case_authenticate_deny(side, port, provider):
    node = await start_node(side, port)
    out = []
    try:
        ok = Client(clientid="good", port=node_port(node))
        out.append((await ok.connect()).reason_code)
        await ok.disconnect()
        bad = Client(clientid="evil", port=node_port(node))
        out.append(await attempt(bad.connect()))
        await quiesce(node, provider)
    finally:
        await node.stop()
    return out


async def case_authorize_deny(side, port, provider):
    node = await start_node(side, port)
    out = []
    try:
        sub = Client(clientid="s1", port=node_port(node), proto_ver=5)
        await sub.connect()
        out.append(await sub.subscribe("forbidden/t", qos=1))
        out.append(await sub.subscribe("allowed/t", qos=1))
        pub = Client(clientid="p1", port=node_port(node), proto_ver=5)
        await pub.connect()
        out.append(await pub.publish("forbidden/t", b"x", qos=1))
        out.append(await pub.publish("allowed/t", b"y", qos=1))
        out.append(_msg(await sub.recv()))
        await pub.disconnect()
        await sub.disconnect()
        await quiesce(node, provider)
    finally:
        await node.stop()
    return out


async def case_publish_rewrite(side, port, provider):
    node = await start_node(side, port)
    out = []
    try:
        sub = Client(clientid="s1", port=node_port(node))
        await sub.connect()
        out.append(await sub.subscribe("out/#", qos=0))
        pub = Client(clientid="p1", port=node_port(node))
        await pub.connect()
        out.append(await pub.publish("in/t", b"m", qos=1))
        out.append(_msg(await sub.recv()))
        await pub.disconnect()
        await sub.disconnect()
        await quiesce(node, provider)
    finally:
        await node.stop()
    return out


async def case_notification_stream(side, port, provider):
    node = await start_node(side, port)
    out = []
    try:
        c = Client(clientid="c1", port=node_port(node))
        await c.connect()
        out.append(await c.subscribe("a/b", qos=0))
        out.append(await c.unsubscribe("a/b"))
        await c.disconnect()
        await quiesce(node, provider)
    finally:
        await node.stop()
    return out


async def case_failure_action(side, port, provider):
    out = []
    node = await start_node(side, port, failure_action="ignore")
    try:
        c = Client(clientid="c1", port=node_port(node))
        out.append((await c.connect()).reason_code)
        await c.disconnect()
        await quiesce(node, provider)
    finally:
        await node.stop()
    node = await start_node(side, port, failure_action="deny")
    try:
        c = Client(clientid="c2", port=node_port(node))
        out.append(await attempt(c.connect()))
        await quiesce(node, provider)
    finally:
        await node.stop()
    return out


async def case_v311_suback_deny(side, port, provider):
    node = await start_node(side, port)
    out = []
    try:
        c = Client(clientid="v3", port=node_port(node), proto_ver=4)
        await c.connect()
        out.append(await c.subscribe("forbidden/t", qos=1))
        await c.disconnect()
        await quiesce(node, provider)
    finally:
        await node.stop()
    return out


async def case_topic_alias(side, port, provider):
    node = await start_node(side, port)
    out = []
    try:
        spy = Client(clientid="spy", port=node_port(node), proto_ver=5)
        await spy.connect()
        out.append(await spy.subscribe("#", qos=0))
        pub = Client(clientid="p1", port=node_port(node), proto_ver=5)
        await pub.connect()
        out.append(await pub.publish("forbidden/t", b"x", qos=1,
                                     properties={"Topic-Alias": 1}))
        got = await attempt(pub.publish("", b"y", qos=1,
                                        properties={"Topic-Alias": 1},
                                        timeout=2.0))
        out.append(got[:2] if isinstance(got, tuple) else got)
        out.append(await attempt(spy.recv(timeout=0.5)))
        await spy.disconnect()
        await quiesce(node, provider)
    finally:
        await node.stop()
    return out


NODE_CASES = {
    "authenticate_deny": (case_authenticate_deny,
                          dict(deny_clientids={"evil"})),
    "authorize_deny": (case_authorize_deny, dict(deny_topics={"forbidden/t"})),
    "publish_rewrite": (case_publish_rewrite, dict(rewrite=("in/t", "out/t"))),
    "notification_stream": (case_notification_stream, {}),
    "failure_action": (case_failure_action,
                       dict(fail_methods={"OnClientAuthenticate"})),
    "v311_suback_deny": (case_v311_suback_deny,
                         dict(deny_topics={"forbidden/t"})),
    "topic_alias": (case_topic_alias, dict(deny_topics={"forbidden/t"})),
}


def _run_node_case(side, name):
    case, kw = NODE_CASES[name]

    async def main():
        provider = DemoProvider(**kw)
        server, port = await start_provider(provider)
        try:
            out = await case(side, port, provider)
        finally:
            await server.stop(None)
        return out, provider.events

    return run(main())


@pytest.mark.parametrize("name", sorted(NODE_CASES))
def test_node_case_equals_reference(name):
    ref_out, ref_events = _run_node_case(REF, name)
    port_out, port_events = _run_node_case(PORT, name)
    assert port_out == ref_out
    assert split_events(port_events) == split_events(ref_events)
    # the reference case's own assertions, on the port's transcript
    adv, notes = split_events(port_events)
    if name == "authenticate_deny":
        assert port_out[0] == 0 and port_out[1][:2] == ("raised",
                                                        "MqttError")
        assert ("auth", "evil", False) in adv
    elif name == "authorize_deny":
        assert port_out[:4] == [[P.RC.NOT_AUTHORIZED], [1],
                                P.RC.NOT_AUTHORIZED, 0]
        assert port_out[4] == ("allowed/t", b"y", 1)
    elif name == "publish_rewrite":
        assert port_out[2][0] == "out/t"
    elif name == "notification_stream":
        assert notes["c1"] == [("connected", "c1"),
                               ("subscribed", "c1", "a/b"),
                               ("unsubscribed", "c1", "a/b"),
                               ("disconnected", "c1")]
    elif name == "failure_action":
        assert port_out[0] == 0 and port_out[1][0] == "raised"
    elif name == "v311_suback_deny":
        assert port_out == [[0x80]]
    elif name == "topic_alias":
        assert port_out[1] == P.RC.NOT_AUTHORIZED
        assert port_out[3][:2] == ("raised", "TimeoutError")


def test_server_down_fails_open_as_reference():
    async def main(side):
        node = await start_node(side, 1)   # nothing listens on port 1
        try:
            c = Client(clientid="c1", port=node_port(node))
            out = [(await c.connect()).reason_code,
                   await c.subscribe("x", qos=0)]
            await c.disconnect()
            out.append(node.exhook.stats()[0]["connected"])
        finally:
            await node.stop()
        return out

    assert run(main(PORT)) == run(main(REF)) == [0, [0], False]


def test_deny_policy_fails_closed_then_recovers_as_reference():
    import emqx_tpu.exhook.manager as ref_mgr
    import emqx_tpu_torch.exhook.manager as port_mgr

    async def main(side):
        cls = (ref_mgr if side == REF else port_mgr).ExHookManager
        old = cls.RECONNECT_INTERVAL
        cls.RECONNECT_INTERVAL = 0.1
        provider = DemoProvider()
        server, port = await start_provider(provider)
        await server.stop(None)
        node = await start_node(side, port, failure_action="deny")
        out = []
        try:
            c = Client(clientid="c1", port=node_port(node))
            got = await attempt(c.connect())
            out.append(got[:3])
            server2, bound = await start_provider(provider, port)
            out.append(bound == port)
            out.append(await settle(
                lambda: node.exhook.servers[0].stub is not None))
            c2 = Client(clientid="c2", port=node_port(node))
            out.append((await c2.connect()).reason_code)
            await c2.disconnect()
            await quiesce(node, provider)
            await server2.stop(None)
        finally:
            cls.RECONNECT_INTERVAL = old
            await node.stop()
        return out, split_events(provider.events)

    ref, port = run(main(REF)), run(main(PORT))
    assert port == ref
    # 3.1.1's "server unavailable"
    assert port[0][0] == ("raised", "MqttError", "CONNACK refused rc=3")
    assert port[0][1:] == [True, True, 0]


def test_port_manager_faults_take_the_failure_action():
    """``exhook.call`` (the port's injection point): a raised call takes
    the server's failure_action path on the publish advisory."""
    from emqx_tpu_torch import faultinject

    async def main(action):
        provider = DemoProvider(hooks=("message.publish",))
        server, port = await start_provider(provider)
        node = await start_node(PORT, port, failure_action=action)
        try:
            c = Client(clientid="c1", port=node_port(node), proto_ver=5)
            await c.connect()
            faultinject.install(faultinject.FaultInjector(
                [{"point": "exhook.call", "action": "raise", "times": 1}]))
            try:
                rc = await c.publish("t/1", b"x", qos=1)
            finally:
                faultinject.uninstall()
            rc2 = await c.publish("t/2", b"x", qos=1)
            await c.disconnect()
            failed = node.exhook.stats()[0]["failed"]
        finally:
            await node.stop()
            await server.stop(None)
        return rc, rc2, failed

    no_subs = P.RC.NO_MATCHING_SUBSCRIBERS
    assert run(main("ignore")) == (no_subs, no_subs, 1)
    assert run(main("deny")) == (P.RC.UNSPECIFIED_ERROR, no_subs, 1)


def test_chaos_exhook_sender_kill_recovers():
    """``tests/test_chaos_delivery.py``'s case on the port's manager: a
    notification sender killed mid-stream restarts under the supervisor
    and loses no queued event."""
    from emqx_tpu_torch.broker.broker import Broker
    from emqx_tpu_torch.exhook.manager import (ExHookManager, ServerSpec,
                                               _ServerState)
    from emqx_tpu_torch.observe.metrics import Metrics
    from emqx_tpu_torch.supervise import Supervisor

    class FakeStub:
        def __init__(self):
            self.calls = []

        def OnClientConnected(self, req):
            async def go():
                self.calls.append(req)
            return go()

    async def main():
        m = Metrics()
        sup = Supervisor(metrics=m, backoff_base=0.001, backoff_max=0.01,
                         jitter=0.0)
        node = types.SimpleNamespace(broker=Broker(), supervisor=sup,
                                     started_at=0.0)
        mgr = ExHookManager(node, [])
        st = _ServerState(spec=ServerSpec(name="s1", url="inproc"))
        st.stub = FakeStub()
        st.hooks = ["client.connected"]
        mgr.servers = [st]
        st.sender = sup.start_child("exhook.sender.s1",
                                    lambda: mgr._sender_loop(st))
        for i in range(3):
            st.queue.put_nowait(("OnClientConnected", i))
        assert await settle(lambda: len(st.stub.calls) == 3, 8.0)
        assert st.sender.kill()
        for i in range(3, 6):
            st.queue.put_nowait(("OnClientConnected", i))
        assert await settle(lambda: len(st.stub.calls) == 6, 8.0)
        assert st.stub.calls == list(range(6))
        assert m.get("broker.supervisor.restarts") >= 1
        st.sender.cancel()
        await sup.stop()

    run(main())


# ---------------------------------------------------------------------------
# end to end: node -> exhook -> sidecar
# ---------------------------------------------------------------------------


def test_shared_sub_filter_stripped_equals_reference():
    """Each package's node feeding its own sidecar: the mirror holds the
    routing filter ($share/<g>/ stripped) and drops it on unsubscribe."""

    async def main(side):
        async with Harness(side, gate=False, rebuild_debounce_s=0.01) as h:
            node = await start_node(side, h.port)
            try:
                c = Client(clientid="c1", port=node_port(node), proto_ver=5)
                await c.connect()
                await c.subscribe("$share/g1/room/+/temp", qos=0)
                assert await settle(
                    lambda: "room/+/temp" in h.sc.filter_table())
                seen = (h.sc.filter_table(), dict(h.sc._ref))
                await c.unsubscribe("$share/g1/room/+/temp")
                assert await settle(
                    lambda: "room/+/temp" not in h.sc.filter_table())
                await c.disconnect()
                return seen, (h.sc.filter_table(), dict(h.sc._ref))
            finally:
                await node.stop()

    port = run(main(PORT))
    assert port == run(main(REF))
    assert port[0][1] == {"room/+/temp": 1} and port[1][1] == {}


@pytest.mark.parametrize("node_side", [PORT, REF])
def test_node_feeds_the_port_sidecar(node_side):
    """The broker's subscribe events fill the port's sidecar mirror
    ($share stripped), and its publishes ride the micro-batch loop."""

    async def main():
        async with Harness(PORT, gate=False, rebuild_debounce_s=0.01,
                           batch_window_ms=0.5) as h:
            node = await start_node(node_side, h.port)
            try:
                c = Client(clientid="c1", port=node_port(node), proto_ver=5)
                await c.connect()
                await c.subscribe("room/+/temp", qos=0)
                await c.subscribe("$share/g1/hall/+", qos=0)
                assert await settle(lambda: {"room/+/temp", "hall/+"}
                                    <= set(h.sc.filter_table()))
                assert await settle(lambda: synced(h.sc))
                await c.publish("room/7/temp", b"21.5")
                msg = await c.recv()
                assert msg.payload == b"21.5"
                assert await settle(lambda: h.sc.topics_matched >= 1)
                await c.unsubscribe("$share/g1/hall/+")
                assert await settle(
                    lambda: "hall/+" not in h.sc.filter_table())
                await c.disconnect()
            finally:
                await node.stop()
            assert h.sc.host_rows == 0 and h.sc.device_batches >= 1

    run(main())


def test_reconnect_pushes_the_mirror_snapshot_to_the_port_sidecar():
    """A node started before its sidecar: the reconnect loop loads the
    sidecar and InstallSnapshot hands it the node's filter set."""
    import emqx_tpu_torch.exhook.manager as port_mgr

    async def main():
        old = port_mgr.ExHookManager.RECONNECT_INTERVAL
        port_mgr.ExHookManager.RECONNECT_INTERVAL = 0.1
        port = _free_port()
        node = await start_node(PORT, port)
        try:
            clients = []
            for i in range(3):
                c = Client(clientid=f"c{i}", port=node_port(node))
                await c.connect()
                await c.subscribe(f"r/{i}/+", qos=1)
                await c.subscribe("shared/#", qos=1)
                clients.append(c)
            sc = port_server.TpuMatchSidecar(device="cpu",
                                             rebuild_debounce_s=0.01)
            server, sc = await port_server.serve(port=port, sidecar=sc)
            try:
                assert await settle(lambda: sc._ref == {
                    "r/0/+": 1, "r/1/+": 1, "r/2/+": 1, "shared/#": 3})
                assert await settle(lambda: synced(sc))
                await clients[0].subscribe("late/+", qos=1)
                await clients[1].unsubscribe("r/1/+")
                assert await settle(lambda: "late/+" in sc._ref
                                    and "r/1/+" not in sc._ref)
                for c in clients:
                    await c.disconnect()
            finally:
                await sc.stop()
                await server.stop(None)
        finally:
            port_mgr.ExHookManager.RECONNECT_INTERVAL = old
            await node.stop()

    run(main())
