"""Rule engine: SQL-ish streaming rules over broker events.

The port's own copy of the reference's ``emqx_tpu/rule_engine/__init__.py``
(nothing here imports the JAX package).

Behavioral reference: ``apps/emqx_rule_engine`` [U] (SURVEY.md §2.3,
§3.5): rules are ``SELECT ... FROM "topic/filter" WHERE ...`` statements
compiled at create time and evaluated per matching event; outputs feed
actions (republish, console, bridges).  ``FOREACH ... DO ... INCASE``
fans an array column out into per-element action runs.

The FROM topic filters ride the same wildcard matcher as routing: on
the card they co-batch into the match service's table
(:meth:`RuleEngine.attach_match_service`), so one walk answers a
topic's routes and its rules (``MatchService.hint_rules``).
"""

from .sqlparser import parse_sql, Rule as ParsedSql, SqlError
from .runtime import eval_rule, render_template
from .engine import RuleEngine, Rule, RuleResult

__all__ = [
    "parse_sql", "ParsedSql", "SqlError", "eval_rule", "render_template",
    "RuleEngine", "Rule", "RuleResult",
]
