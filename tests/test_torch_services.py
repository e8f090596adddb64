"""The retainer's batched device replay (``Retainer.replay_batch``, BASELINE
config 5) of the port against the JAX reference's, on the CPU.

The case of ``tests/test_services.py`` and a seeded larger one (workload
filters, retained names with an expired message among them) are played
on both packages' ``Retainer``: per filter, the replayed topics equal,
in the same order, and equal to the host walk (``Retainer.match``).
The reference's fail-open is kept (a filter the compiler refuses, a walk
past K: every filter through the host walk); the port's ``try`` covers
those two calls only, so a failure of the walk itself raises (an
intended divergence)."""

import time

import numpy as np
import pytest
import torch

import emqx_tpu_torch.ops as port_ops
from emqx_tpu import topic as T
from emqx_tpu.broker.message import make_message as ref_make_message
from emqx_tpu.services import Retainer as RefRetainer

from emqx_tpu_torch.broker.message import make_message
from emqx_tpu_torch.services.retainer import Retainer
from emqx_tpu_torch.workload import build_workload


def _both(topics, props=None, payload=b"1"):
    """A reference and a port retainer holding ``topics`` (``props(i)``
    gives message i's properties)."""
    ref, port = RefRetainer(), Retainer()
    for i, t in enumerate(topics):
        p = props(i) if props else {}
        ref.insert(ref_make_message("p", t, payload, retain=True,
                                    properties=p))
        port.insert(make_message("p", t, payload, retain=True,
                                 properties=p))
    return ref, port


def _topics(out):
    return {f: [m.topic for m in msgs] for f, msgs in out.items()}


def _host(r, filters, now=None):
    return {f: [m.topic for m in r.match(f, now)] for f in filters}


def test_retainer_replay_batch_device_matches_host():
    topics = ["s/1/temp", "s/2/temp", "s/1/hum", "b/x", "deep/a/b/c/d"]
    ref, port = _both(topics)
    filters = ["s/+/temp", "s/#", "b/x", "nope/+", "#"]
    got = _topics(port.replay_batch(filters, device="cpu"))
    assert got == _topics(ref.replay_batch(filters))
    for f in filters:
        want = sorted(t for t in topics if T.match(t, f))
        assert got[f] == want, f


def test_seeded_replay_with_an_expired_message_equals_the_reference(
        monkeypatch):
    served = []
    walk = port_ops.match_topics

    def spy(*a, **kw):
        rows = walk(*a, **kw)      # raises on an overflow: no fail-open
        served.append(len(rows))
        return rows

    monkeypatch.setattr(port_ops, "match_topics", spy)
    filters, names = build_workload(np.random.default_rng(4), 1500, 2500)
    names = sorted(set(names)) + ["$SYS/broker/uptime"]
    filters = filters[:600] + ["#", "+/+", "$SYS/#"]
    ref, port = _both(names, props=lambda i: (
        {"Message-Expiry-Interval": 10} if i % 7 == 3 else {}))
    now = time.time() + 100          # every seventh message has expired
    got = _topics(port.replay_batch(filters, now=now, device="cpu"))
    assert got == _topics(ref.replay_batch(filters, now=now))
    assert got == _host(port, filters, now)
    live = [t for i, t in enumerate(names) if i % 7 != 3]
    assert got["#"] == sorted(t for t in live if not t.startswith("$"))
    assert got["$SYS/#"] == ["$SYS/broker/uptime"]
    # one walk over the unexpired names served every filter
    assert served == [len(live)]
    assert sum(map(len, got.values())) > 2 * len(live)


@pytest.mark.parametrize("case", ["deep_filter", "past_k"])
def test_fail_open_to_the_host_walk_equals_the_reference(case):
    """A filter deeper than the table (``compile_filters`` raises
    ValueError) or a name matching more than K = 32 filters (the walk
    raises OverflowError): every filter is served by the host walk, on
    both packages."""
    if case == "deep_filter":
        names = ["a/b", "a/c/d"]
        filters = ["a/+", "/".join(["a"] * 20)]
        depth = 16
    else:
        names = ["k/0", "k/1/x"]
        filters = [f"k/+/{'#' if i == 0 else f'x{i}'}" for i in range(40)] \
            + [f"k/{i}/#" for i in range(40)] + ["k/#", "+/1/x"]
        depth = 8
    ref, port = _both(names)
    got = _topics(port.replay_batch(filters, depth=depth, device="cpu"))
    assert got == _topics(ref.replay_batch(filters, depth=depth))
    assert got == _host(port, filters)


def test_a_failure_of_the_walk_raises(monkeypatch):
    """Only OverflowError and ValueError fall open: a walk that fails
    otherwise (a kernel that does not build or launch) raises, and the
    card is the default device."""
    _ref, port = _both(["a/b"])

    def boom(*a, **kw):
        raise RuntimeError("nfa_walk launch failed: cudaError 98")

    monkeypatch.setattr(port_ops, "match_topics", boom)
    with pytest.raises(RuntimeError, match="launch failed"):
        port.replay_batch(["a/+"], device="cpu")
    monkeypatch.undo()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port.replay_batch(["a/+"])
