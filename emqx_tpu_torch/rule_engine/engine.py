"""Rule registry, event wiring and actions.

The port's own copy of the reference's ``emqx_tpu/rule_engine/engine.py``
(nothing here imports the JAX package).

Behavioral reference: ``emqx_rule_engine.erl`` + the ``$events/...``
event topics of ``emqx_rule_events.erl`` [U] (SURVEY.md §2.3, §3.5):

* rules are created from SQL + action list, compiled once, stored by id;
* a plain topic filter in FROM selects ``message.publish`` events; the
  ``$events/<name>`` pseudo-topics select lifecycle events;
* on each event: for every enabled rule whose FROM matches, evaluate and
  run actions per output row; per-rule metrics
  (matched/passed/failed/no_result) mirror the reference's counters.

Actions: ``republish`` (topic/payload/qos ``${...}`` templates through
the normal broker pipeline, loop-guarded), ``console``, and any callable
``fn(output_row, columns)`` (the bridge boundary — Kafka/HTTP sinks plug
here).  The port has no bridges: ``bridge_resolver`` stays None, so a
``"<type>:<name>"`` string action counts as failed, as it does on a
reference node with no bridge configured.

Device co-batching (BASELINE config #3): :meth:`RuleEngine.attach_match_service`
registers every enabled rule's FROM filters in the port's
``MatchService`` table (``register_rule``), so one walk on the card
answers both the routes and the rule ids of a topic, and
:meth:`RuleEngine.apply_event` takes the rule ids from
``MatchService.hint_rules`` (a host trie of the rule filters when the
hint is absent or stale).  :meth:`RuleEngine.compile_table` compiles the same
filters into one stand-alone NFA table.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .. import topic as T
from ..broker.broker import Broker
from ..broker.message import Message, make_message
from ..broker.trie import FilterTrie
from .runtime import eval_rule, render_template
from .sqlparser import Rule as ParsedSql, parse_sql

log = logging.getLogger(__name__)

__all__ = ["Rule", "RuleResult", "RuleEngine", "EVENT_TOPICS",
           "message_columns"]

EVENT_TOPICS = {
    "$events/client_connected": "client.connected",
    "$events/client_disconnected": "client.disconnected",
    "$events/session_subscribed": "session.subscribed",
    "$events/session_unsubscribed": "session.unsubscribed",
    "$events/message_delivered": "message.delivered",
    "$events/message_acked": "message.acked",
    "$events/message_dropped": "message.dropped",
}


@dataclass
class Rule:
    id: str
    sql: str
    parsed: ParsedSql
    actions: List[Any]
    enable: bool = True
    description: str = ""
    created_at: float = field(default_factory=time.time)
    metrics: Dict[str, int] = field(default_factory=lambda: {
        "matched": 0, "passed": 0, "failed": 0, "no_result": 0,
        "actions.success": 0, "actions.failed": 0,
    })

    def publish_filters(self) -> List[str]:
        return [f for f in self.parsed.froms if not f.startswith("$events/")]

    def event_hooks(self) -> List[str]:
        return [EVENT_TOPICS[f] for f in self.parsed.froms if f in EVENT_TOPICS]


@dataclass
class RuleResult:
    rule_id: str
    outputs: List[Dict[str, Any]]


class RuleEngine:
    def __init__(
        self, broker: Optional[Broker] = None, max_republish_depth: int = 4
    ) -> None:
        self.rules: Dict[str, Rule] = {}
        self.broker = broker
        self._epoch = 0   # bumps on any rule change (device mirror key)
        # "<type>:<name>" action strings resolve through this (set by
        # BridgeManager); unresolved strings count as failed actions
        self.bridge_resolver: Optional[Callable[[str], Optional[Callable]]] = None
        self.max_republish_depth = max_republish_depth
        self._pub_depth = 0
        self._match_service = None  # device co-batching (attach below)
        # epoch-cached hook-listener state (rebuilt on rule churn)
        self._listener_hooks: set = set()
        self._any_publish_rules = False
        self._listeners_epoch = -1
        self._rank: Dict[str, int] = {}   # rule id -> evaluation order
        self._rank_epoch = -1
        self._index: Tuple[FilterTrie, Dict[str, List[str]]] = (
            FilterTrie(), {})              # host rule filters -> rule ids
        self._index_epoch = -1
        # per-message event taps (delivered/acked/dropped) fire per
        # fan-out leg — they are registered only while an enabled rule
        # listens on them (synced on rule churn), so a rule-less broker
        # pays nothing on the delivery hot path
        self._lazy_taps: Dict[str, tuple] = {}
        self._taps_on: set = set()
        self._hooks_ref = None
        if broker is not None:
            self._attach(broker)

    # -- device co-batching (BASELINE config 3) -------------------------

    def attach_match_service(self, ms: Any) -> None:
        """Co-batch every enabled rule's FROM filters into the node's
        device match table: rule selection then rides the same kernel
        call as routing (``MatchService.hint_rules``)."""
        self._match_service = ms
        for rule in self.rules.values():
            self._sync_rule_filters(rule)

    def _sync_rule_filters(self, rule: "Rule") -> None:
        ms = self._match_service
        if ms is None:
            return
        try:
            if rule.enable and rule.publish_filters():
                ms.register_rule(rule.id, rule.publish_filters())
            else:
                ms.unregister_rule(rule.id)
        except Exception:
            # co-batching is an optimization; host matching still works
            log.exception("rule %s device co-batch failed", rule.id)

    # ------------------------------------------------------------------
    # registry
    # ------------------------------------------------------------------

    def create_rule(
        self,
        rule_id: str,
        sql: str,
        actions: Optional[Sequence[Any]] = None,
        description: str = "",
        enable: bool = True,
    ) -> Rule:
        parsed = parse_sql(sql)
        for f in parsed.froms:
            if not f.startswith("$events/"):
                T.validate(f, "filter")
            elif f not in EVENT_TOPICS:
                raise ValueError(f"unknown event topic {f!r}")
        rule = Rule(rule_id, sql, parsed, list(actions or []), enable,
                    description)
        self.rules[rule_id] = rule
        self._epoch += 1
        self._sync_rule_filters(rule)
        self._sync_event_taps()
        return rule

    def delete_rule(self, rule_id: str) -> bool:
        ok = self.rules.pop(rule_id, None) is not None
        if ok:
            self._epoch += 1
            if self._match_service is not None:
                self._match_service.unregister_rule(rule_id)
            self._sync_event_taps()
        return ok

    def set_enable(self, rule_id: str, enable: bool) -> None:
        rule = self.rules[rule_id]
        rule.enable = enable
        self._epoch += 1
        self._sync_rule_filters(rule)
        self._sync_event_taps()

    @property
    def epoch(self) -> int:
        return self._epoch

    def _refresh_listeners(self) -> None:
        hooks = set()
        any_pub = False
        for rule in self.rules.values():
            if rule.enable:
                hooks.update(rule.event_hooks())
                if rule.publish_filters():
                    any_pub = True
        self._listener_hooks = hooks
        self._any_publish_rules = any_pub
        self._listeners_epoch = self._epoch

    def _ranked(self) -> Dict[str, int]:
        """Rule id -> its position in ``self.rules``, the order rules are
        evaluated in; rebuilt after rule churn (every change of
        ``self.rules`` bumps the epoch)."""
        if self._rank_epoch != self._epoch:
            self._rank = {rid: i for i, rid in enumerate(self.rules)}
            self._rank_epoch = self._epoch
        return self._rank

    def _host_rule_ids(self, topic: str) -> set:
        """Ids of the rules with a FROM filter matching ``topic``, from a
        trie of every rule's publish filters (rebuilt after rule churn):
        the host's answer when no fresh device hint serves, e.g. for a
        republished message, which is never prefetched."""
        if self._index_epoch != self._epoch:
            trie = FilterTrie()
            owners: Dict[str, List[str]] = {}
            for rule in self.rules.values():
                for f in rule.publish_filters():
                    trie.insert(f)
                    owners.setdefault(f, []).append(rule.id)
            self._index = (trie, owners)
            self._index_epoch = self._epoch
        trie, owners = self._index
        return {rid for f in trie.match(topic) for rid in owners[f]}

    def _event_has_listeners(self, hook: str) -> bool:
        """Epoch-cached set of event hooks any enabled rule listens on
        (rebuilt only after rule create/delete/enable churn)."""
        if self._listeners_epoch != self._epoch:
            self._refresh_listeners()
        return hook in self._listener_hooks

    def _any_publish_listeners(self) -> bool:
        """True when some enabled rule has a publish FROM filter —
        event-only rule sets must not re-impose the per-publish
        column-build cost."""
        if self._listeners_epoch != self._epoch:
            self._refresh_listeners()
        return self._any_publish_rules

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------

    def apply_event(
        self, hook_or_topic: str, columns: Dict[str, Any],
        is_event: bool = False,
        skip_rule: Optional[str] = None,
    ) -> List[RuleResult]:
        """Run all matching enabled rules; returns per-rule outputs.
        ``skip_rule`` excludes one rule id (republish loop guard).

        A publish visits only the rules whose FROM filters match, in the
        order of ``self.rules`` (:meth:`_ranked`): their ids come from a
        fresh device hint or, without one, from the host trie of the
        rule filters (:meth:`_host_rule_ids`).  The reference visits
        every rule, skipping those the hint does not name or, with no
        hint, those ``T.match`` rejects: the same rules in the same
        order, at a cost that grows with the rule set (with 1,000 rules,
        ~3 ms a publish on the loop)."""
        results: List[RuleResult] = []
        rules: Any = self.rules.values()
        if not is_event:
            # device co-batch fast path: a fresh hint names the matching
            # rule ids (None => stale or no device: the host trie answers)
            ids = None
            if self._match_service is not None:
                ids = self._match_service.hint_rules(hook_or_topic)
            matched = (set(ids) if ids is not None
                       else self._host_rule_ids(hook_or_topic))
            rank = self._ranked()
            rules = [self.rules[rid] for rid in
                     sorted(matched & rank.keys(), key=rank.__getitem__)]
        for rule in rules:
            if not rule.enable:
                continue
            if skip_rule is not None and rule.id == skip_rule:
                continue
            if is_event and hook_or_topic not in rule.event_hooks():
                continue
            rule.metrics["matched"] += 1
            try:
                outs = eval_rule(rule.parsed, columns)
            except Exception:
                rule.metrics["failed"] += 1
                continue
            if outs:
                rule.metrics["passed"] += 1
            else:
                rule.metrics["no_result"] += 1
                continue
            results.append(RuleResult(rule.id, outs))
            for out in outs:
                self._run_actions(rule, out, columns)
        return results

    def _run_actions(
        self, rule: Rule, output: Dict[str, Any], columns: Dict[str, Any]
    ) -> None:
        for action in rule.actions:
            try:
                if isinstance(action, dict) and action.get("function") == "republish":
                    self._republish(
                        action.get("args", {}), output, columns, rule.id
                    )
                elif isinstance(action, dict) and action.get("function") == "console":
                    print(f"[rule {rule.id}] {output}")
                elif isinstance(action, str):
                    fn = (
                        self.bridge_resolver(action)
                        if self.bridge_resolver is not None else None
                    )
                    if fn is None:
                        raise ValueError(f"unknown bridge action {action!r}")
                    fn(output, columns)
                elif callable(action):
                    action(output, columns)
                else:
                    raise ValueError(f"bad action {action!r}")
                rule.metrics["actions.success"] += 1
            except Exception:
                rule.metrics["actions.failed"] += 1

    def _republish(
        self, args: Dict[str, Any], output: Dict[str, Any],
        columns: Dict[str, Any], rule_id: str = "rule",
    ) -> None:
        if self.broker is None:
            raise RuntimeError("republish needs a broker")
        topic = render_template(args.get("topic", "republish/${topic}"),
                                output, columns)
        payload_tpl = args.get("payload", "${payload}")
        payload = render_template(payload_tpl, output, columns).encode()
        qos_t = args.get("qos", 0)
        qos = int(render_template(str(qos_t), output, columns) or 0) \
            if isinstance(qos_t, str) else int(qos_t)
        msg = make_message(None, topic, payload, qos=qos)
        # loop guard: the originating rule won't see its own republish
        msg.headers["republish_by"] = rule_id
        self.broker.publish(msg)

    # ------------------------------------------------------------------
    # broker wiring
    # ------------------------------------------------------------------

    def _attach(self, broker: Broker) -> None:
        def on_publish(acc: Message):
            if acc is None or acc.topic.startswith("$SYS"):
                return acc
            # loop guards: the originating rule is skipped (so chaining
            # A→B works), and chain depth is bounded so mutually
            # republishing rules can't recurse unboundedly
            if self._pub_depth >= self.max_republish_depth:
                return acc
            if not self._any_publish_listeners():
                return acc      # no publish rules: skip the column build
            self._pub_depth += 1
            try:
                self.apply_event(
                    acc.topic, message_columns(acc),
                    skip_rule=acc.headers.get("republish_by"),
                )
            finally:
                self._pub_depth -= 1
            return acc

        broker.hooks.add("message.publish", on_publish, priority=-50,
                         name="rule_engine.publish")

        def mk(hook: str, builder):
            def cb(*args):
                # build the (priceable) column dict ONLY when some
                # enabled rule actually listens on this event — these
                # hooks fire per delivered/acked message, and a broker
                # with no rules was measurably paying message_columns()
                # on every one (round-5 config-1 profile)
                if not self._event_has_listeners(hook):
                    return
                self.apply_event(hook, builder(*args), is_event=True)
            return cb

        broker.hooks.add(
            "client.connected",
            mk("client.connected", lambda cid, conninfo: {
                "clientid": cid, "event": "client.connected",
                "username": (conninfo or {}).get("username")
                if isinstance(conninfo, dict) else None,
                "timestamp": int(time.time() * 1000),
            }),
            priority=-50, name="rule_engine.connected",
        )
        broker.hooks.add(
            "client.disconnected",
            mk("client.disconnected", lambda cid, reason: {
                "clientid": cid, "event": "client.disconnected",
                "reason": reason, "timestamp": int(time.time() * 1000),
            }),
            priority=-50, name="rule_engine.disconnected",
        )
        broker.hooks.add(
            "session.subscribed",
            mk("session.subscribed", lambda cid, flt, opts, is_new: {
                "clientid": cid, "event": "session.subscribed",
                "topic": flt, "qos": opts.qos,
                "timestamp": int(time.time() * 1000),
            }),
            priority=-50, name="rule_engine.subscribed",
        )
        broker.hooks.add(
            "session.unsubscribed",
            mk("session.unsubscribed", lambda cid, flt: {
                "clientid": cid, "event": "session.unsubscribed",
                "topic": flt, "timestamp": int(time.time() * 1000),
            }),
            priority=-50, name="rule_engine.unsubscribed",
        )
        self._hooks_ref = broker.hooks
        self._lazy_taps = {
            "message.delivered": ("rule_engine.delivered", mk(
                "message.delivered", lambda cid, msg: {
                    **message_columns(msg), "event": "message.delivered",
                    "clientid": cid, "from_clientid": msg.sender,
                })),
            "message.acked": ("rule_engine.acked", mk(
                "message.acked", lambda cid, msg: {
                    **message_columns(msg), "event": "message.acked",
                    "clientid": cid, "from_clientid": msg.sender,
                })),
            "message.dropped": ("rule_engine.dropped", mk(
                "message.dropped", lambda msg, reason: {
                    **message_columns(msg), "event": "message.dropped",
                    "reason": reason,
                })),
        }
        self._sync_event_taps()

    def _sync_event_taps(self) -> None:
        """Register/unregister the per-message event taps to mirror the
        current enabled-rule listener set (see _lazy_taps above).  The
        cb's own ``_event_has_listeners`` guard stays as a belt for any
        add/delete race mid-batch."""
        hooks = self._hooks_ref
        if hooks is None:
            return
        if self._listeners_epoch != self._epoch:
            self._refresh_listeners()
        for point, (name, cb) in self._lazy_taps.items():
            want = point in self._listener_hooks
            if want and point not in self._taps_on:
                hooks.add(point, cb, priority=-50, name=name)
                self._taps_on.add(point)
            elif not want and point in self._taps_on:
                hooks.delete(point, name)
                self._taps_on.discard(point)

    # ------------------------------------------------------------------
    # device co-batch (north star: BASELINE config #3)
    # ------------------------------------------------------------------

    def compile_table(self, depth: int = 16):
        """Compile all enabled publish-rule FROM filters into one NFA
        table.  Returns ``(table, {filter: [rule_id]})`` or ``(None, {})``.

        The sidecar unions these filters with the route mirror's filter
        set so ONE kernel batch answers both "which subscribers" and
        "which rules" per topic."""
        from ..ops import compile_filters

        by_filter: Dict[str, List[str]] = {}
        for rule in self.rules.values():
            if not rule.enable:
                continue
            for f in rule.publish_filters():
                by_filter.setdefault(f, []).append(rule.id)
        if not by_filter:
            return None, {}
        return compile_filters(by_filter.keys(), depth=depth), by_filter


def message_columns(msg: Message) -> Dict[str, Any]:
    """The message.publish event column set (emqx_rule_events fields [U])."""
    return {
        "id": msg.id,
        "clientid": msg.sender,
        "username": msg.headers.get("username"),
        "topic": msg.topic,
        "qos": msg.qos,
        "payload": msg.payload,
        "retain": msg.retain,
        "dup": msg.dup,
        "flags": {"retain": msg.retain, "dup": msg.dup},
        "pub_props": dict(msg.properties),
        "timestamp": int(msg.timestamp * 1000),
        "publish_received_at": int(msg.timestamp * 1000),
        "node": "local",
    }
