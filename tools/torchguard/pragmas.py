"""torchguard's inline-suppression grammar.

The same shape as the JAX tools' (``tools.pragmas``), under its own
prefix::

    # torchguard: allow(TG101) the admission read is the sanctioned sync
    # torchguard: allow(TG203, TL005) one-shot lazy open

and the hot mark ``# torchguard: hot`` on (or directly above) a ``def``
line. Rule ids are globally unique (TG*/TL* belong to this tool), so the
suppression semantics are the shared ones: :func:`tools.pragmas.suppress`
filters the raw findings by the lines :func:`allowed_lines` reads here.
The JAX tools' regex (``lint|jaxguard``) never matches a torchguard
comment, and this one never matches theirs.
"""
from __future__ import annotations

import re

from ..pragmas import suppress

PRAGMA_RE = re.compile(r"#\s*torchguard:\s*allow\(([A-Z0-9, ]+)\)")

HOT_MARK = "# torchguard: hot"


def allowed_lines(src: str) -> dict[int, frozenset[str]]:
    """line number → rule ids allowed by torchguard pragmas on that line."""
    out: dict[int, frozenset[str]] = {}
    for i, text in enumerate(src.splitlines(), start=1):
        rules: set[str] = set()
        for m in PRAGMA_RE.finditer(text):
            rules.update(r.strip() for r in m.group(1).split(",") if r.strip())
        if rules:
            out[i] = frozenset(rules)
    return out


def pragma_reason(line: str) -> str:
    """The reason text after a pragma's closing paren ("" when none)."""
    m = PRAGMA_RE.search(line)
    return line[m.end():].strip() if m else ""


__all__ = ["HOT_MARK", "PRAGMA_RE", "allowed_lines", "pragma_reason",
           "suppress"]
