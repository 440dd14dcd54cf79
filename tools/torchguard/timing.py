"""torchguard's timing-window rules, the twins of the linter's JX004 and
JX005 (``tools/lint/rules.py``) in torch spellings.

- **TL004** — a function in a script (``scripts/torch_*.py``,
  ``chip_smoke.py``) that reads a timer twice or more and never fences
  the card: no ``torch.cuda.synchronize()``, no ``Event.synchronize()`` /
  ``elapsed_time()``, no host read of a tensor (``.item()``, ``.cpu()``,
  ``.tolist()``, ``.numpy()``). Kernel launches return before the card
  runs them, so such a window measures the host's launches.
- **TL005** — a function in the port's library code (outside ``obs/``)
  that reads a timer twice or more: a hand-rolled window. ``obs.span`` /
  ``obs.timer`` fence on exit and emit the measurement.

JX001-JX003 (drifted JAX symbols, ``jax.experimental``, float64 on a TPU)
have no torch twin; TS001 already covers ``tests/``. Counting is the
linter's: the function's own body, nested defs apart, qualified
``time.*`` timers and the bare ``perf_counter``/``monotonic``.
"""
from __future__ import annotations

import ast

from tools.lint.rules import _dotted, _walk_own_body

from .model import PKG, TIMER_CALLS, TIMING_FENCES, Finding


def scopes(path: str) -> dict:
    p = path.replace("\\", "/")
    base = p.rsplit("/", 1)[-1]
    return {
        "tl004": base == "chip_smoke.py" or (
            "scripts/" in p and base.startswith("torch_")),
        "tl005": p.startswith(PKG + "/") and "/obs/" not in p,
    }


def _counts(fn: ast.AST) -> tuple:
    timers = fences = 0
    for sub in _walk_own_body(fn):
        if not isinstance(sub, ast.Call):
            continue
        d = _dotted(sub.func) or ""
        leaf = d.rsplit(".", 1)[-1]
        if leaf in TIMER_CALLS and (
            d.startswith("time.") or leaf in ("perf_counter", "monotonic")
        ):
            timers += 1
        elif isinstance(sub.func, ast.Attribute) and leaf in TIMING_FENCES:
            fences += 1
    return timers, fences


def check_tree(tree: ast.AST, path: str) -> list:
    """TL004/TL005 findings of one parsed module at repo-relative
    ``path``."""
    scope = scopes(path)
    if not (scope["tl004"] or scope["tl005"]):
        return []
    out = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        timers, fences = _counts(fn)
        if timers < 2:
            continue
        if scope["tl005"]:
            out.append(Finding(
                path, fn.lineno, "TL005",
                f"function '{fn.name}' hand-rolls a timing window in library "
                "code — use obs.span/obs.timer (they fence the card and emit "
                "the measurement)",
                function=fn.name,
            ))
        elif fences == 0:
            out.append(Finding(
                path, fn.lineno, "TL004",
                f"function '{fn.name}' times a region but never fences the "
                "card (torch.cuda.synchronize / Event.synchronize / "
                "elapsed_time / a host read of the result) — it measures "
                "launches, not the card",
                function=fn.name,
            ))
    return out
