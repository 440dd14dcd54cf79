"""torchguard pass 1: interprocedural device-value dataflow (TG101, TG104,
and TG403's upload leg).

The engine is jaxguard's (``tools.analyze.dataflow``): the same three
fixpoints — which functions return device values, which parameters carry
them, which ``self.X`` attributes hold them — over the same name-based
call graph, then one collection walk per function. What changes is what a
device value is and what a sync is, in torch spellings
(:mod:`.model`), and two things JAX spells otherwise:

- **allow_transfer.** Strict mode's sanctioned regions
  (``compat.torchapi.allow_transfer``) are the port's sanction in code: a
  sync lexically inside one, or in a function whose every hot call site
  sits inside one (at most :data:`~.model.ALLOW_DEPTH` calls below the
  ``with``, the depth jaxguard's JG403 grants ``device_put``), is not a
  finding. JAX's JG101 knows no such region, so each of its admission
  reads carries a pragma; the port's twin sites carry the region.
- **Attribute dispatch.** ``self._decode(tok, pos)`` calls the
  :class:`DecodeGraph` the server built (``self._decode = DecodeGraph(
  ...)``): calls through an attribute whose constructor the program holds
  resolve to that class's method (``__call__`` for a bare call), as the
  lock-discipline pass resolves them.

TG101 fires only in HOT functions (reachable from the serving round or
``fit``, or marked ``# torchguard: hot``). TG403 fires at a synchronous
upload of host data (:data:`~.model.HOST_DATA_CTORS` with a ``device=``,
or followed at once by a blocking ``.to(device)``) in a function
reachable from the serving roots, under the same allow_transfer
sanction: the twin of JG403's ``device_put`` leg. TG104 fires at any
``DecodeGraph``/``PersistentRound`` construction whose signature static
(:data:`~.model.SIGNATURE_STATICS`) is an unhashable literal or varies
with a loop variable: each value is a new capture (the twin of JG104's
unhashable and loop-varying jit statics; the port traces nothing, so
JG104's shape branch has no twin).
"""
from __future__ import annotations

import ast
from collections import defaultdict
from typing import Optional

from tools.analyze import dataflow as _jg
from tools.analyze.graph import FunctionInfo, Program, dotted
from tools.analyze.graph import load_program as _load_program

from .model import (
    ALLOW_DEPTH,
    ALLOW_LEAVES,
    DEVICE_FN_NAMES,
    DISPATCH_ROOT_SUFFIXES,
    Finding,
    HOST_ANNOTATION_SUFFIX,
    HOST_ANNOTATIONS,
    HOST_DATA_CTORS,
    HOST_PARAM_NAMES,
    HOT_ROOT_SUFFIXES,
    NONDEVICE_ATTRS,
    NONDEVICE_METHODS,
    SIGNATURE_STATICS,
    SYNC_ANY_RECEIVER,
    SYNC_BUILTINS,
    SYNC_CALLS,
    SYNC_METHODS,
    SYNC_NUMPY,
    TORCH_FACTORIES,
    TORCH_HOST,
    TORCH_HOST_PREFIXES,
    TORCH_LIKE,
)
from .pragmas import HOT_MARK

_any = _jg._any
_merge_taint = _jg._merge_taint


def load_program(paths: list, root: str, sources: Optional[dict] = None):
    """:func:`tools.analyze.graph.load_program`, with the hot marks read
    as ``# torchguard: hot`` and no jit wrapping (the port traces
    nothing)."""
    prog, errors = _load_program(paths, root, sources=sources)
    for fn in prog.functions.values():
        lines = prog.modules[fn.modname].src.splitlines()
        fn.hot_marked = any(
            1 <= n <= len(lines) and HOT_MARK in lines[n - 1]
            for n in (fn.node.lineno, fn.node.lineno - 1)
        )
        fn.jit = None
    return prog, errors


def _host_params(fn: FunctionInfo) -> set:
    """Parameters that hold no tensor (:data:`~.model.HOST_PARAM_NAMES`,
    host-typed annotations)."""
    a = fn.node.args
    out = set()
    for p in a.posonlyargs + a.args + a.kwonlyargs:
        ann = dotted(p.annotation) if p.annotation is not None else None
        leaf = (ann or "").rsplit(".", 1)[-1]
        if (p.arg in HOST_PARAM_NAMES or leaf in HOST_ANNOTATIONS
                or leaf.endswith(HOST_ANNOTATION_SUFFIX)):
            out.add(p.arg)
    return out


def _tensor_test(test: ast.AST) -> tuple:
    """``(name, is_tensor)`` for a test ``torch.is_tensor(name)`` /
    ``isinstance(name, torch.Tensor)`` (``is_tensor`` False under ``not``),
    else ``(None, None)``: the branch where the test says "no tensor" reads
    ``name`` as a host value."""
    negate = False
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        test, negate = test.operand, True
    if not (isinstance(test, ast.Call) and test.args
            and isinstance(test.args[0], ast.Name)):
        return None, None
    d = dotted(test.func)
    if d == "torch.is_tensor" or (
            d == "isinstance" and len(test.args) == 2
            and (dotted(test.args[1]) or "").endswith("Tensor")):
        return test.args[0].id, not negate
    return None, None


def _allow_item(item: ast.withitem) -> bool:
    expr = item.context_expr
    return isinstance(expr, ast.Call) and (
        dotted(expr.func) or ""
    ).rsplit(".", 1)[-1] in ALLOW_LEAVES


def _device_target(node: ast.Call) -> Optional[bool]:
    """For ``x.to(...)``: True when it names a device other than the CPU,
    False for the CPU, None when it only changes the dtype."""
    target = node.args[0] if node.args else None
    for k in node.keywords:
        if k.arg == "device":
            target = k.value
    if target is None:
        return None
    if isinstance(target, ast.Constant):
        if isinstance(target.value, str):
            return not target.value.startswith("cpu")
        return None
    d = dotted(target)
    if d is not None and d.startswith("torch.") and d != "torch.device":
        return None  # torch.float32 and friends: a dtype
    if isinstance(target, ast.Call) and dotted(target.func) == "torch.device":
        arg = target.args[0] if target.args else None
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            return not arg.value.startswith("cpu")
    return True


def _factory_on_device(node: ast.Call) -> bool:
    for k in node.keywords:
        if k.arg == "device":
            v = k.value
            if isinstance(v, ast.Constant):
                return isinstance(v.value, str) and not v.value.startswith("cpu")
            return True
    return False


class _TorchEval(_jg._FnEval):
    """jaxguard's per-function walk in torch spellings (module doc)."""

    def __init__(self, an: "Analyzer", fn: FunctionInfo, collect: bool = False,
                 hot: bool = False, sanctioned: bool = False,
                 serving: bool = False):
        super().__init__(an, fn, collect=collect, hot=hot)
        self.serving = serving
        for p in _host_params(fn):
            self.env[p] = False
        self.sanctioned = sanctioned
        self.containers: set = set()  # names bound to a list/dict display
        self._allow = 0
        self.sites: list = []  # (callee qualname, inside allow_transfer)

    # ----- rules ------------------------------------------------------------

    def _sync(self, node: ast.AST, what: str) -> None:
        if self.hot and not self.sanctioned and not self._allow:
            self._add(
                node, "TG101",
                f"{what} makes the host wait for the card in a hot path — "
                "move it into a sanctioned sync (allow_transfer) or annotate "
                "'# torchguard: allow(TG101) <reason>'",
            )

    def _upload(self, node: ast.AST, what: str) -> None:
        if self.serving and not self.sanctioned and not self._allow:
            self._add(
                node, "TG403",
                f"{what} copies host data to the card on the serving path "
                "outside an allow_transfer region — the host waits for the "
                "copy (strict mode trips on it); fill on the device "
                "(torch.full), copy from pinned memory with non_blocking=True, "
                "or wrap the sanctioned slow path in allow_transfer(<reason>)",
            )

    def _pure_taint(self, exprs) -> bool:
        """Is any of ``exprs`` a device value (evaluated again, no rule
        firing)?"""
        self._pure += 1
        try:
            return any(_any(self.taint(e)) for e in exprs)
        finally:
            self._pure -= 1

    def _check_signature(self, node: ast.Call, ctor: str) -> None:
        if self._pure:
            return
        statics = SIGNATURE_STATICS[ctor]
        _args, kws = self._expanded_call(node)
        for name, value in kws:
            if name not in statics:
                continue
            if isinstance(value, _jg._UNHASHABLE):
                self._add(
                    value, "TG104",
                    f"unhashable {type(value).__name__} as signature static "
                    f"'{name}' of {ctor} — a signature must be hashable "
                    "(use a tuple)",
                )
                continue
            var = self._in_loop_vars(value)
            if var is not None:
                self._add(
                    value, "TG104",
                    f"signature static '{name}' of {ctor} varies with loop "
                    f"variable '{var}' — one capture per iteration",
                )

    # ----- resolution -------------------------------------------------------

    def prog_resolve(self, d: str):
        info = super().prog_resolve(d)
        if info is not None or not d.startswith("self.") or self.fn.cls is None:
            return info
        parts = d[len("self."):].split(".")
        if len(parts) > 2:
            return None
        owner = self.an.prog.attr_class(self.mod, self.fn.cls, parts[0])
        if owner is None:
            return None
        owner_mod = self.an.prog.modules.get(owner.modname)
        method = parts[1] if len(parts) == 2 else "__call__"
        return owner_mod.functions.get(f"{owner.name}.{method}") if (
            owner_mod is not None) else None

    # ----- expressions ------------------------------------------------------

    def _t_Attribute(self, node) -> bool:
        if node.attr in NONDEVICE_ATTRS:
            self.taint(node.value)
            return False
        return super()._t_Attribute(node)

    def _t_Call(self, node: ast.Call):
        d = dotted(node.func) or ""
        leaf = d.rsplit(".", 1)[-1]
        method = node.func.attr if isinstance(node.func, ast.Attribute) else None
        base_taint = False
        if method is not None:
            base_taint = _any(self.taint(node.func.value))
        arg_taints = [_any(self.taint(a)) for a in node.args]
        kw_taints = {k.arg: _any(self.taint(k.value)) for k in node.keywords}

        if leaf in SIGNATURE_STATICS:
            self._check_signature(node, leaf)
        # Synchronous uploads (JG403's device_put leg in torch spellings).
        if (d in HOST_DATA_CTORS and _factory_on_device(node)
                and arg_taints[:1] != [True]):
            self._upload(node, f"{d}(<host data>, device=...)")
        elif (method in ("to", "cuda") and isinstance(node.func.value, ast.Call)
              and (dotted(node.func.value.func) or "") in HOST_DATA_CTORS
              and (method == "cuda" or _device_target(node))
              and not any(k.arg == "non_blocking" for k in node.keywords)
              and not self._pure_taint(node.func.value.args[:1])):
            self._upload(node, f"{dotted(node.func.value.func)}(...).{method}(...)")
        # Host-sync sinks (the result is a host value; the call is the event).
        if d in SYNC_CALLS or method in SYNC_ANY_RECEIVER:
            self._sync(node, f"{d or method}()")
            return False
        if d in SYNC_BUILTINS and arg_taints[:1] == [True]:
            self._sync(node, f"{d}() of a tensor")
            return False
        if d in SYNC_NUMPY and (any(arg_taints) or any(kw_taints.values())):
            self._sync(node, f"{d}() of a tensor")
            return False
        if method in SYNC_METHODS and base_taint:
            self._sync(node, f".{method}() of a tensor")
            return False
        if method == "to" and base_taint and _device_target(node) is False:
            self._sync(node, ".to('cpu') of a tensor")
            return False
        if method in NONDEVICE_METHODS and base_taint:
            return False
        if d == "len":
            return False

        callee = self.prog_resolve(d)
        if callee is not None:
            self.edges.add(callee.qualname)
            self.sites.append((callee.qualname, self._allow > 0))
            self._record_param_taints(node, callee, arg_taints, kw_taints)
            return self.an.returns_device.get(callee.qualname, False)

        # Unresolved: the torch conventions.
        if d.startswith(("np.", "numpy.")):
            return False
        if d.startswith("torch."):
            if d in TORCH_HOST or d.startswith(TORCH_HOST_PREFIXES):
                return False
            if leaf in TORCH_FACTORIES:
                return _factory_on_device(node)
            if leaf in TORCH_LIKE:
                return any(arg_taints) or _factory_on_device(node)
            return any(arg_taints) or any(kw_taints.values())
        if method == "cuda" or (method == "to" and _device_target(node)):
            return True
        if leaf in DEVICE_FN_NAMES:
            return True
        if method is not None:
            base_d = dotted(node.func.value)
            if (method in _jg._MUTATORS and any(arg_taints)
                    and node is self._expr_value and base_d in self.env):
                self.env[base_d] = True
            if base_taint:
                return True  # x.float() / x.view() / x.argmax() stay on the card
        return False

    def _t_BoolOp(self, node) -> bool:
        out = False
        for v in node.values:
            t = _any(self.taint(v))
            if t and not self._container(v):
                self._sync(v, "truth-testing a tensor (and/or)")
            out = t or out
        return out

    def _t_IfExp(self, node):
        if _any(self.taint(node.test)) and not self._container(node.test):
            self._sync(node.test, "branching on a tensor (ternary)")
        body = self.taint(node.body)
        return _merge_taint(body, self.taint(node.orelse))

    def _container(self, test: ast.AST) -> bool:
        """A list or dict's truth test reads its length, not a tensor."""
        return isinstance(test, ast.Name) and test.id in self.containers

    # ----- statements -------------------------------------------------------

    def _branch_test(self, test, kind: str) -> None:
        if _any(self.taint(test)) and not self._container(test):
            self._sync(test, f"branching on a tensor ({kind})")

    def _s_If(self, node) -> None:
        self._branch_test(node.test, "if")
        name, is_tensor = _tensor_test(node.test)
        for body, host in ((node.body, is_tensor is False),
                           (node.orelse, is_tensor is True)):
            saved = self.env.get(name) if host else None
            if host:
                self.env[name] = False
            self._stmts(body)
            if host and self.env.get(name) is False:
                self.env[name] = saved

    def _assign_target(self, target, t, value_node) -> None:
        if isinstance(target, ast.Name):
            if isinstance(value_node, (ast.List, ast.ListComp, ast.Dict,
                                       ast.DictComp)):
                self.containers.add(target.id)
            else:
                self.containers.discard(target.id)
        super()._assign_target(target, t, value_node)

    def _s_With(self, node) -> None:
        allow = any(_allow_item(item) for item in node.items)
        for item in node.items:
            t = self.taint(item.context_expr)
            if item.optional_vars is not None:
                self._assign_target(item.optional_vars, t, None)
        self._allow += allow
        self._stmts(node.body)
        self._allow -= allow

    _s_AsyncWith = _s_With


class Analyzer(_jg.Analyzer):
    """jaxguard's fixpoint driver over :class:`_TorchEval`, with the
    allow_transfer sanction (module doc). One engine serves every pass:
    the dispatch pass reuses its ``call_edges``."""

    def __init__(self, program: Program):
        super().__init__(program)
        self.call_sites: dict[str, list] = {}

    def run(self) -> list[Finding]:
        fns = self.prog.functions
        changed, passes = True, 0
        while changed and passes < 12:
            changed, passes = False, passes + 1
            for q, fn in fns.items():
                ev = _TorchEval(self, fn)
                ev.walk()
                self.call_edges[q] = ev.edges
                self.call_sites[q] = ev.sites
                merged = _merge_taint(
                    self.returns_device.get(q, False), ev.returns_struct
                )
                if merged != self.returns_device.get(q, False):
                    self.returns_device[q] = merged
                    changed = True
                for callee_q, pname in ev.param_taints:
                    if pname not in self.tainted_params[callee_q]:
                        self.tainted_params[callee_q].add(pname)
                        changed = True
                for key, attr in ev.attr_taints:
                    if attr not in self.class_attrs[key]:
                        self.class_attrs[key].add(attr)
                        changed = True
        hot = self._hot_set()
        sanctioned = self._sanctioned(hot)
        serving = self.reach(DISPATCH_ROOT_SUFFIXES)
        findings: list[Finding] = []
        seen = set()
        for q, fn in fns.items():
            ev = _TorchEval(self, fn, collect=True, hot=q in hot,
                            sanctioned=q in sanctioned, serving=q in serving)
            ev.walk()
            for f in ev.findings:
                key = (f.path, f.line, f.rule, f.message)
                if key not in seen:
                    seen.add(key)
                    findings.append(f)
        return sorted(findings, key=lambda f: (f.path, f.line, f.rule))

    def _hot_set(self) -> set:
        return self.reach(HOT_ROOT_SUFFIXES, marked=True)

    def reach(self, suffixes: tuple, marked: bool = False) -> set:
        """Functions reachable from the roots named by ``suffixes`` (and
        the ``# torchguard: hot`` marks when ``marked``)."""
        seen = set()
        for q, fn in self.prog.functions.items():
            flat = q.replace(":", ".")
            if (marked and fn.hot_marked) or any(flat.endswith(s) for s in suffixes):
                seen.add(q)
        frontier = list(seen)
        while frontier:
            q = frontier.pop()
            for callee in self.call_edges.get(q, ()):
                if callee in self.prog.functions and callee not in seen:
                    seen.add(callee)
                    frontier.append(callee)
        return seen

    def _sanctioned(self, hot: set) -> set:
        """Functions whose every hot call site is inside allow_transfer,
        or inside a function so sanctioned, at most ALLOW_DEPTH calls
        below the lexical ``with`` (JG403's inheritance rule)."""
        by_callee: dict = defaultdict(list)
        for caller, sites in self.call_sites.items():
            if caller not in hot:
                continue
            for callee, in_allow in sites:
                by_callee[callee].append((caller, in_allow))
        depth: dict = {}
        for _ in range(ALLOW_DEPTH + 1):
            changed = False
            for q, callers in by_callee.items():
                if q in depth:
                    continue
                contrib: Optional[list] = []
                for caller, in_allow in callers:
                    if in_allow:
                        contrib.append(0)
                    elif caller in depth:
                        contrib.append(depth[caller])
                    else:
                        contrib = None
                        break
                if contrib is None:
                    continue
                level = 1 + max(contrib, default=0)
                if level <= ALLOW_DEPTH:
                    depth[q] = level
                    changed = True
            if not changed:
                break
        return set(depth)


def analyze_program(program: Program) -> list[Finding]:
    return Analyzer(program).run()


__all__ = ["Analyzer", "analyze_program", "load_program"]
