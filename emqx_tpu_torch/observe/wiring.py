"""Hook-driven metric accounting: wires a Broker's hook bus to Metrics and
Stats, as the reference bumps counters at each layer.

The port's own copy of the reference's ``emqx_tpu/observe/wiring.py``.
One call, ``observe(broker)``, returns an :class:`Observed` bundle: the
counter table fed by the ``message.publish`` / ``message.acked`` /
``message.dropped`` / session lifecycle hooks, the stats providers
pulled from the live broker tables, and the alarm table.  The reference
also builds its ``$SYS`` publisher here (``SysBroker``); the port does
not publish ``$SYS`` topics yet, so the bundle has no ``sys``.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..broker.broker import Broker
from .alarm import Alarms
from .metrics import Metrics
from .stats import Stats

__all__ = ["Observed", "observe"]


@dataclass
class Observed:
    metrics: Metrics
    stats: Stats
    alarms: Alarms


def observe(broker: Broker) -> Observed:
    m = Metrics()
    s = Stats()
    alarms = Alarms()
    # broker-internal drop accounting (outbox overflow, fanout pipeline)
    # and the delivery paths' messages.delivered bump counters directly
    broker.metrics = m

    hooks = broker.hooks
    hooks.add("message.publish",
              lambda msg: m.inc_msg_received(msg.qos)
              if not msg.topic.startswith("$SYS") else None,
              name="metrics.publish")
    hooks.add("message.acked", lambda cid, msg: m.inc("messages.acked"),
              name="metrics.acked")

    def on_dropped(msg, reason):
        m.inc_msg_dropped(reason if reason != "shared_no_available"
                          else "no_subscribers")

    hooks.add("message.dropped", on_dropped, name="metrics.dropped")
    for ev in ("created", "resumed", "takenover", "discarded", "terminated"):
        hooks.add(
            f"session.{ev}",
            (lambda e: lambda *a: m.inc(f"session.{e}"))(ev),
            name=f"metrics.session.{ev}",
        )

    s.provide("topics.count", broker.router.route_count)
    s.provide("sessions.count", lambda: len(broker.sessions))
    s.provide(
        "subscriptions.count",
        lambda: sum(len(x.subscriptions) for x in broker.sessions.values()),
    )
    s.provide(
        "subscribers.count",
        lambda: sum(len(v) for v in broker.subscribers.values()),
    )
    s.provide(
        "subscriptions.shared.count",
        lambda: sum(
            len(broker.shared.members(g, t)) for g, t in broker.shared.groups()
        ),
    )
    return Observed(metrics=m, stats=s, alarms=alarms)
