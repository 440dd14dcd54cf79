"""torchguard pass: the port's knob contract (TG301-TG304).

jaxguard's contract (``tools.analyze.contracts``) over the port's paths:
an ``ENV_*`` constant in ``kata_xpu_device_plugin_tpu_torch/constants.py``
must have a ``Config`` field (TG301), a reference on the injection
surface under ``plugin/`` (TG302), guest parse sites that degrade rather
than raise on a malformed value (TG303), and a row in the port's knob
table, ``docs/torch_guards.md`` (TG304). The legs' logic is jaxguard's
(its helpers are imported); what differs is the catalogue:

- :data:`~.model.KNOB_EXEMPT` — the daemon's identity envs
  (``TPU_WORKER_*``), exempt from every leg as in JAX;
- :data:`~.model.KNOB_GUEST_LOCAL` — knobs the JAX package defines beside
  their readers, outside its catalogue, and the port keeps in
  ``constants.py``: no Config field and no injection is asked of them
  (TG301/TG302), a degrading parse and a doc row are (TG303/TG304).
"""
from __future__ import annotations

import ast
from typing import Optional

from tools.analyze.contracts import (
    _ENV_GET,
    _FIELD_PREFIX,
    _env_arg_value,
    _function_nodes,
    _module_constants,
    _norm,
    _unsafe_conversions,
)
from tools.analyze.graph import Program, dotted

from .model import (
    KNOB_CONFIG_PATH,
    KNOB_CONSTANTS_PATH,
    KNOB_DOC_PATH,
    KNOB_EXEMPT,
    KNOB_FIELD_OVERRIDES,
    KNOB_GUEST_LOCAL,
    KNOB_INJECTION_PREFIXES,
    Finding,
)


def _config_fields(config_mod) -> set:
    fields: set = set()
    for node in ast.walk(config_mod.tree):
        if isinstance(node, ast.ClassDef) and node.name == "Config":
            for stmt in node.body:
                if isinstance(stmt, ast.AnnAssign) and isinstance(
                    stmt.target, ast.Name
                ):
                    fields.add(stmt.target.id)
    return fields


def _injected(program: Program, env_consts: dict) -> set:
    """Knobs referenced on the injection surface: by their own name, or by
    an import alias of it (the daemon's ``cdi/constants.py`` re-exports
    ``ENV_TP`` as ``ENV_SERVING_TP``, the JAX package's name)."""
    aliases: dict = {}
    for mod in program.modules.values():
        for local, target in mod.imports.items():
            leaf = target.rsplit(".", 1)[-1]
            if leaf in env_consts and local != leaf:
                aliases.setdefault(local, set()).add(leaf)
    out: set = set()
    for mod in program.modules.values():
        path = _norm(mod.path)
        if path == KNOB_CONSTANTS_PATH or not path.startswith(
            KNOB_INJECTION_PREFIXES
        ):
            continue
        for node in ast.walk(mod.tree):
            leaf = node.attr if isinstance(node, ast.Attribute) else (
                node.id if isinstance(node, ast.Name) else None)
            if leaf in env_consts:
                out.add(leaf)
            out.update(aliases.get(leaf, ()))
    return out


def _unsafe_parses(program: Program, env_values: dict) -> dict:
    """env value → first (module, node) that converts it outside a
    degrade guard: direct ``environ.get`` parses, and helpers taking the
    env name as a parameter at their call sites (jaxguard's leg (c))."""
    unsafe: dict = {}
    helper_unsafe: dict = {}
    helper_pos: dict = {}
    for mod in program.modules.values():
        local_consts = _module_constants(mod)
        for fn_node in _function_nodes(mod):
            params = [a.arg for a in fn_node.args.args]
            direct: list = []
            by_param: list = []
            for node in ast.walk(fn_node):
                if not (isinstance(node, ast.Call) and dotted(
                    node.func
                ) in _ENV_GET and node.args):
                    continue
                arg = node.args[0]
                value = _env_arg_value(arg, local_consts, env_values)
                if value is not None:
                    direct.append((node, value))
                elif isinstance(arg, ast.Name) and arg.id in params:
                    by_param.append((node, arg.id))
            for conv in (_unsafe_conversions(fn_node, [c for c, _v in direct])
                         if direct else ()):
                for _call, value in direct:
                    unsafe.setdefault(value, (mod, conv))
            if by_param:
                key = (mod.modname, fn_node.name)
                helper_unsafe[key] = bool(_unsafe_conversions(
                    fn_node, [c for c, _p in by_param]))
                helper_pos[key] = params.index(by_param[0][1])
    for mod in program.modules.values():
        local_consts = _module_constants(mod)
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call) and node.args):
                continue
            callee = dotted(node.func)
            if callee is None:
                continue
            leaf = callee.split(".")[-1]
            for key, is_unsafe in helper_unsafe.items():
                if key[1] != leaf or not is_unsafe:
                    continue
                pos = helper_pos[key]
                if pos < len(node.args):
                    value = _env_arg_value(node.args[pos], local_consts,
                                           env_values)
                    if value is not None:
                        unsafe.setdefault(value, (mod, node))
    return unsafe


def analyze_contracts(program: Program,
                      doc_text: Optional[str] = None) -> list:
    """Run the TG3xx pass. ``doc_text`` is ``docs/torch_guards.md`` (None
    skips the TG304 leg, for source sets that carry no docs)."""
    findings: list = []
    const_mod = config_mod = None
    for mod in program.modules.values():
        if _norm(mod.path) == KNOB_CONSTANTS_PATH:
            const_mod = mod
        elif _norm(mod.path) == KNOB_CONFIG_PATH:
            config_mod = mod
    if const_mod is None:
        return findings
    env_consts = {
        name: (value, lineno)
        for name, (value, lineno) in _module_constants(const_mod).items()
        if name.startswith("ENV_")
    }
    env_values = {n: v for n, (v, _ln) in env_consts.items()}
    fields = _config_fields(config_mod) if config_mod is not None else set()
    injected = _injected(program, env_consts)
    unsafe = _unsafe_parses(program, env_values)
    for name, (value, lineno) in sorted(env_consts.items(),
                                        key=lambda kv: kv[1][1]):
        if name in KNOB_EXEMPT:
            continue
        daemon_knob = name not in KNOB_GUEST_LOCAL
        field = KNOB_FIELD_OVERRIDES.get(name)
        if field is None:
            field = (value[len(_FIELD_PREFIX):] if value.startswith(
                _FIELD_PREFIX) else value).lower()
        if daemon_knob and config_mod is not None and field not in fields:
            findings.append(Finding(
                path=const_mod.path, line=lineno, rule="TG301",
                message=f"{name}={value} has no Config field {field!r} "
                        "backing it",
                function=name,
            ))
        if daemon_knob and name not in injected:
            findings.append(Finding(
                path=const_mod.path, line=lineno, rule="TG302",
                message=f"{name}={value} is never referenced on the "
                        "allocator/plugin injection surface",
                function=name,
            ))
        if value in unsafe:
            mod, node = unsafe[value]
            findings.append(Finding(
                path=mod.path, line=getattr(node, "lineno", 0), rule="TG303",
                message=f"{value} parsed with int()/float() outside a "
                        "degrade guard — malformed env raises instead of "
                        "emitting *_invalid/*_disabled",
                function=name,
            ))
        if doc_text is not None and value not in doc_text:
            findings.append(Finding(
                path=const_mod.path, line=lineno, rule="TG304",
                message=f"{name}={value} has no row in {KNOB_DOC_PATH}",
                function=name,
            ))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
