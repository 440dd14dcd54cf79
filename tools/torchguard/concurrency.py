"""torchguard pass: lock discipline over the port's daemon and guest
threads (TG201-TG203).

jaxguard's pass (``tools.analyze.concurrency``) with the port's thread
surface: the same lock model (``with self._lock:`` regions, a private
method held at every call site inherits the lock), the same three checks
and the same reachability, entered from

- every ``threading.Thread(target=...)`` the resolver can chase (the
  manager's rescan and heartbeat loops, the fence watchdog's worker, the
  maintenance watch);
- ``run`` of a ``threading.Thread`` subclass (the health watcher);
- the kubelet gRPC methods of a ``*Servicer`` subclass;
- :data:`~.model.THREAD_ENTRY_REGISTRY`: JAX's hooks, then the port's
  ``/metrics`` handler, ``__main__``'s signal watcher and its dump thread,
  and the kernels' build (``ops/_build.py``).

The checks, their messages and their order of findings are jaxguard's,
so on one source the two passes report the same lines under TG and JG
ids (``tests/test_torch_guard.py`` holds them to it). Like jaxguard, the
pass models instance locks only: a module-level lock (the build lock,
``obs/events.py``'s sink registry) bounds nothing it checks.
"""
from __future__ import annotations

import ast

from tools.analyze import concurrency as _jg
from tools.analyze.graph import Program, dotted

from .model import GRPC_ENTRY_METHODS, THREAD_ENTRY_REGISTRY


def _registered(qualname: str) -> bool:
    flat = qualname.replace(":", ".")
    return any(flat.endswith("." + entry) for entry in THREAD_ENTRY_REGISTRY)


class _Pass(_jg._Pass):
    """jaxguard's JG2xx pass over the port's entry points, reporting TG
    ids."""

    def _emit(self, fn, node: ast.AST, rule: str, message: str,
              key: tuple = ()) -> None:
        super()._emit(fn, node, "TG" + rule[2:], message, key)

    def _find_entries(self) -> None:
        for qual, facts in self.facts.items():
            fn = facts.fn
            for node, name in facts.calls:
                if name not in _jg._THREAD_CTORS:
                    continue
                for kw in node.keywords:
                    ref = dotted(kw.value) if kw.arg == "target" else None
                    target = self._resolve(fn, ref) if ref else None
                    if target is not None:
                        self.entry.add(target.qualname)
            if _registered(qual):
                self.entry.add(qual)
            if fn.cls is None:
                continue
            cls_info = self.program.modules[fn.modname].classes.get(fn.cls)
            bases = cls_info.bases if cls_info else ()
            if fn.name == "run" and any(b in _jg._THREAD_CTORS for b in bases):
                self.entry.add(qual)
            if fn.name in GRPC_ENTRY_METHODS and any(
                b.split(".")[-1].endswith("Servicer") for b in bases
            ):
                self.entry.add(qual)


def analyze_concurrency(program: Program) -> list:
    """Run the TG2xx lock-discipline pass over an analyzed Program."""
    p = _Pass(program)
    p.build()
    p.jg201()
    p.jg202()
    p.jg203()
    p.findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return p.findings
