"""exception-hygiene: no silently swallowed exceptions on the hot paths
(port of ``repro.analysis.rules.exception_hygiene``).

A fault-tolerant pipeline is only as debuggable as its failure reporting:
an ``except: pass`` in the data or kernel path turns a checksum mismatch,
a failed copy to the card or a dying prefetch worker into a silent wrong
answer.  This rule polices the port's numeric and data packages
(``core`` / ``backend`` / ``kernels`` / ``data``):

* **bare ``except:``** is always flagged — it catches ``KeyboardInterrupt``
  and ``SystemExit`` too.
* **broad ``except Exception`` / ``except BaseException``** is flagged when
  the handler *swallows*: it neither re-raises, nor uses the bound
  exception (chaining with ``raise ... from exc`` or enqueueing it counts),
  nor reports through ``warnings.warn`` / a logger.  A handler that picks a
  fallback value silently may be correct, but then the waiver comment is
  where that reasoning must live: ``# repro: allow[exception-hygiene] why``.

Narrow handlers (``except OSError:`` retry loops, ``except KeyError:``)
are none of this rule's business.
"""
from __future__ import annotations

import ast
import re
from typing import Iterable, Tuple

from repro_torch.analysis.framework import (
    FileContext, Rule, qualname, register_rule,
)
from repro_torch.analysis.rules._common import call_target, tail_name

_SCOPE_RE = re.compile(r"repro_torch/(core|backend|kernels|data)/")
_BROAD = {"Exception", "BaseException"}
_REPORTERS = {"warn", "warning", "error", "exception", "critical", "log",
              "fail", "print"}


def _uses_name(body, name: str) -> bool:
    for stmt in body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Name) and node.id == name:
                return True
    return False


def _reports(body) -> bool:
    """Does the handler raise, or call anything that looks like failure
    reporting (warnings.warn, logger.*, print)?"""
    for stmt in body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Raise):
                return True
            if isinstance(node, ast.Call):
                if tail_name(call_target(node)) in _REPORTERS:
                    return True
    return False


def _tail_of(expr: ast.AST):
    if isinstance(expr, ast.Tuple):
        for elt in expr.elts:
            name = _tail_of(elt)
            if name in _BROAD:
                return name
        return None
    return tail_name(qualname(expr))


@register_rule
class ExceptionHygiene(Rule):
    name = "exception-hygiene"
    description = ("no bare `except:` and no silently-swallowed broad "
                   "`except Exception` in core/backend/kernels/data — "
                   "swallowed failures become silent wrong answers")

    def applies_to(self, path: str) -> bool:
        return bool(_SCOPE_RE.search(path))

    def check(self, ctx: FileContext) -> Iterable[Tuple[ast.AST, str]]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None:
                yield node, ("bare `except:` — catches KeyboardInterrupt/"
                             "SystemExit too; name the exceptions this "
                             "handler is prepared to handle")
                continue
            caught = tail_name(
                call_target(node.type) if isinstance(node.type, ast.Call)
                else None) or _tail_of(node.type)
            if caught not in _BROAD:
                continue
            if _reports(node.body):
                continue
            if node.name and _uses_name(node.body, node.name):
                continue  # the exception is examined / chained / enqueued
            yield node, (f"`except {caught}` swallows the failure — "
                         "re-raise, chain it, warn/log it, or waive with "
                         "the reason a silent fallback is correct here")
