"""torchguard pass: the decode graphs' dispatch surface (TG401-TG404).

The port's serving loop runs every decode chunk through a
:class:`DecodeGraph` (or a persistent round through a
:class:`PersistentRound`): a CUDA graph captured once a signature and
replayed after. Its performance rests on jaxguard's JG4xx invariants in
graph form:

TG401 — **capture census**: every ``DecodeGraph(...)``/``PersistentRound(
    ...)`` reachable from the serving roots draws each signature static
    (:data:`~.model.SIGNATURE_STATICS`) from a bounded source — a
    literal, a server attribute, a parameter, a module constant — so the
    captures are a closed set. jaxguard's source classification
    (``_SiteWalk.classify``) decides, with torch's device calls.
TG402 — **frozen buffers** (the twin of donation completeness, inverted:
    JAX must rebind what it donated, a graph must never see its buffers
    rebound). A parameter, arena or pool attribute a graph constructor
    takes is rebound (``self.x = ...``) on the serving path by a function
    that does not rebuild the graphs after it: the graph keeps replaying
    over the old address. The static twin of the tripwire's address
    count (``compat/torchapi.py``).
TG403 — **kv-layout coverage**: jaxguard's lattice leg over the port's
    spec modules (:data:`~.model.SPEC_MODULE_PATHS`). Its ``device_put``
    leg, a synchronous upload, needs the device-value taint and runs in
    the dataflow pass (:mod:`.dataflow`); its ``shard_map`` leg has no
    spelling in the port.
TG404 — **stale pragmas**: a ``# torchguard: allow(RULE)`` whose rule no
    longer fires on its line.
"""
from __future__ import annotations

import ast
from typing import Optional

from tools.analyze import dispatch as _jg
from tools.analyze.contracts import _module_constants
from tools.analyze.graph import FunctionInfo, Program, dotted

from .model import (
    DEVICE_FN_NAMES,
    DISPATCH_ROOT_SUFFIXES,
    GRAPH_READS,
    LAYOUT_PARAM_NAMES,
    SIGNATURE_STATICS,
    SPEC_MODULE_PATHS,
    Finding,
)
from .pragmas import allowed_lines


class _SiteWalk(_jg._SiteWalk):
    """jaxguard's JG401 walk at the decode graphs' constructors."""

    def _classify_call(self, expr: ast.Call, depth: int) -> str:
        d = dotted(expr.func) or ""
        leaf = d.rsplit(".", 1)[-1]
        if d.startswith("torch.") or leaf in DEVICE_FN_NAMES:
            return _jg._DEVICE
        if leaf in _jg._PURE_HOST or self.prog.resolve_class(self.mod, d):
            out = _jg._BOUNDED  # a value record of bounded fields
            for a in list(expr.args) + [k.value for k in expr.keywords]:
                out = self._join(out, self.classify(a, depth + 1))
            return out
        return _jg._UNBOUNDED

    def _check_call(self, node: ast.Call) -> None:
        leaf = (dotted(node.func) or "").rsplit(".", 1)[-1]
        statics = SIGNATURE_STATICS.get(leaf)
        if statics is None:
            return
        _args, kws = self._expand_call(node)
        for pname, arg in kws:
            if pname not in statics:
                continue
            cls = self.classify(arg)
            var = self._in_loop_vars(arg)
            if cls == _jg._DEVICE:
                why = "a tensor can never be a graph's static"
            elif var is not None:
                why = f"it varies with loop variable '{var}'"
            elif cls == _jg._UNBOUNDED:
                src = dotted(arg) or ast.dump(arg)[:60]
                why = f"it draws from an unbounded source '{src}'"
            else:
                continue
            self._add(
                node, "TG401",
                f"signature static '{pname}' of {leaf}: {why} — the capture "
                "census is not closed (bind it to a server attribute or a "
                "knob constant)",
            )


# ---------------------------------------------------------------------------
# TG402 — buffers a captured graph reads
# ---------------------------------------------------------------------------


def _self_chains(expr: ast.AST) -> set:
    """``self.a.b`` attribute chains an expression reads (an ``IfExp``
    reads both arms)."""
    out = set()
    for sub in ast.walk(expr):
        d = dotted(sub) if isinstance(sub, ast.Attribute) else None
        if d is not None and d.startswith("self."):
            out.add(d)
    return {c for c in out if not any(o != c and o.startswith(c + ".")
                                      for o in out)}


def _graph_reads(fn: FunctionInfo) -> set:
    """The attribute chains the graph constructors in ``fn`` take as
    their frozen buffers, through one local binding."""
    bound: dict = {}
    for node in ast.walk(fn.node):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    bound.setdefault(tgt.id, set()).update(
                        _self_chains(node.value))
    chains: set = set()
    for node in ast.walk(fn.node):
        if not (isinstance(node, ast.Call) and (dotted(node.func) or "").rsplit(
                ".", 1)[-1] in SIGNATURE_STATICS):
            continue
        exprs = [node.args[i] for i, _n in GRAPH_READS if i < len(node.args)]
        names = {n for _i, n in GRAPH_READS}
        exprs += [k.value for k in node.keywords if k.arg in names]
        for expr in exprs:
            if isinstance(expr, ast.Name):
                chains |= bound.get(expr.id, set())
            else:
                chains |= _self_chains(expr)
    return chains


def _frozen_rebinds(program: Program, reach: set) -> list:
    findings: list = []
    builders: dict = {}  # (modname, cls) → (rebuild qualname, chains)
    for fn in program.functions.values():
        if fn.cls is None:
            continue
        chains = _graph_reads(fn)
        if chains:
            key = (fn.modname, fn.cls)
            q, old = builders.get(key, (fn.qualname, set()))
            builders[key] = (q, old | chains)
    for q in sorted(reach):
        fn = program.functions[q]
        entry = builders.get((fn.modname, fn.cls))
        if entry is None or entry[0] == q:
            continue
        rebuild_q, chains = entry
        rebuild_name = rebuild_q.rsplit(".", 1)[-1]
        rebuild_lines = [
            n.lineno for n in ast.walk(fn.node)
            if isinstance(n, ast.Call) and dotted(n.func) == f"self.{rebuild_name}"
        ]
        for node in ast.walk(fn.node):
            targets = node.targets if isinstance(node, ast.Assign) else (
                [node.target] if isinstance(node, (ast.AugAssign, ast.AnnAssign))
                else [])
            for tgt in targets:
                d = dotted(tgt) if isinstance(tgt, ast.Attribute) else None
                hit = d is not None and any(
                    c == d or c.startswith(d + ".") for c in chains)
                if not hit or any(line > node.lineno for line in rebuild_lines):
                    continue
                findings.append(Finding(
                    fn.path, node.lineno, "TG402",
                    f"'{d}' is read by a captured decode graph and rebound "
                    f"here without a later self.{rebuild_name}() — the graph "
                    "replays over the old address; copy into it in place, or "
                    "rebuild the graphs",
                    function=fn.qualname,
                ))
    return findings


# ---------------------------------------------------------------------------
# TG403 — kv-layout lattice coverage (jaxguard's leg over the port's paths)
# ---------------------------------------------------------------------------


def _layout_coverage(program: Program, lattice: dict) -> list:
    layouts: tuple = ()
    for value, choices in lattice.items():
        if isinstance(choices, tuple) and "LAYOUT" in value.upper():
            layouts = choices
    global_consts: dict = {}
    for m in program.modules.values():
        for name, (value, _ln) in _module_constants(m).items():
            global_consts.setdefault(name, value)
    findings: list = []
    for mod in program.modules.values():
        if _jg._norm(mod.path) not in SPEC_MODULE_PATHS:
            continue
        consts = dict(global_consts)
        consts.update({k: v for k, (v, _l) in _module_constants(mod).items()})
        for fn in mod.functions.values():
            lay_params = [p for p in fn.params if p in LAYOUT_PARAM_NAMES]
            if fn.nested or not lay_params:
                continue
            compared: set = set()
            for sub in ast.walk(fn.node):
                if not isinstance(sub, ast.Compare):
                    continue
                sides = [sub.left] + list(sub.comparators)
                if not any(isinstance(s, ast.Name) and s.id in lay_params
                           for s in sides):
                    continue
                for s in sides:
                    value = _layout_value(s, consts, mod)
                    if value is None:
                        continue
                    compared.add(value)
                    if layouts and value not in layouts:
                        findings.append(Finding(
                            mod.path, sub.lineno, "TG403",
                            f"'{fn.name}' compares its layout param against "
                            f"{value!r}, which is not in the kv-layout "
                            f"lattice {layouts} — a stale/typo'd layout name "
                            "can never match",
                            function=fn.qualname,
                        ))
            missing = [v for v in layouts if v not in compared]
            terminal = any(isinstance(s, ast.Return) for s in fn.node.body)
            if compared and missing and not terminal:
                findings.append(Finding(
                    mod.path, fn.node.lineno, "TG403",
                    f"'{fn.name}' switches on a kv-layout param but layout(s) "
                    f"{missing} fall off the end of the function — an "
                    "implicit None spec; add the branch or a terminal "
                    "default return",
                    function=fn.qualname,
                ))
    return findings


def _layout_value(s: ast.AST, consts: dict, mod) -> Optional[str]:
    if isinstance(s, ast.Constant) and isinstance(s.value, str):
        return s.value
    ds = dotted(s)
    if ds is None:
        return None
    leaf = ds.split(".")[-1]
    value = consts.get(leaf)
    if value is None and leaf in mod.imports:
        value = consts.get(mod.imports[leaf].rsplit(".", 1)[-1])
    return value


# ---------------------------------------------------------------------------
# TG404 — stale pragmas
# ---------------------------------------------------------------------------


def stale_pragmas(sources: dict, raw_findings: list) -> list:
    """A ``# torchguard: allow(RULE)`` whose rule did not fire on its own
    line in this run (``raw_findings``: every other pass's findings before
    suppression). ``sources`` maps a path to its text."""
    fired: dict = {}
    for f in raw_findings:
        fired.setdefault((f.path, f.line), set()).add(f.rule)
    findings: list = []
    for path, src in sorted(sources.items()):
        for line, rules in sorted(allowed_lines(src).items()):
            for rule in sorted(rules):
                if rule == "TG404" or not rule.startswith(("TG", "TL")):
                    continue
                if rule not in fired.get((path, line), ()):
                    findings.append(Finding(
                        path, line, "TG404",
                        f"stale pragma: allow({rule}) but {rule} no longer "
                        "fires on this line — delete the pragma, or annotate "
                        "allow(TG404) with why it must stay",
                    ))
    return findings


def analyze_dispatch(program: Program, analyzer) -> list:
    """TG401-TG403 over ``program``, on the call graph of the already-run
    :class:`~.dataflow.Analyzer`."""
    reach = analyzer.reach(DISPATCH_ROOT_SUFFIXES)
    findings: list = []
    for q in sorted(reach):
        walk = _SiteWalk(program, program.functions[q])
        walk.run()
        findings.extend(walk.findings)
    findings.extend(_frozen_rebinds(program, reach))
    findings.extend(_layout_coverage(program, _jg.knob_lattice(program)))
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


__all__ = ["analyze_dispatch", "stale_pragmas"]
