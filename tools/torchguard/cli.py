"""``python -m tools.torchguard`` — run torchguard over the port.

Exit status mirrors jaxguard's: 0 clean, 1 findings, 2 usage error.
Findings print as ``path:line: RULE message``; a summary line on stderr
counts the files, the findings by rule and the sanctions (pragmas) the
run honoured. ``--json FILE`` writes the report, clean or not.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
from typing import Iterable, Optional

from tools.analyze.cli import _iter_py_files

from .concurrency import analyze_concurrency
from .contracts import analyze_contracts
from .dataflow import Analyzer, load_program
from .dispatch import analyze_dispatch, stale_pragmas
from .model import ALL_RULES, KNOB_DOC_PATH, PKG, Finding
from .pragmas import allowed_lines, suppress
from .timing import check_tree

# `--rule TG4xx` selects a family; `--rule TLxxx` the timing pair.
_FAMILY_RE = re.compile(r"^(TG\d|TL)[xX]+$")

# The port, its card smoke script and its scripts. Tests are out of scope
# (fixtures write rule-tripping code on purpose), as in jaxguard.
DEFAULT_TARGETS = (PKG, "chip_smoke.py", "scripts/torch_*.py")


def _expand(targets: Iterable[str], root: str) -> list:
    paths: list = []
    for target in targets:
        abs_target = target if os.path.isabs(target) else os.path.join(root, target)
        matches = sorted(glob.glob(abs_target)) if glob.has_magic(target) else (
            [abs_target] if os.path.exists(abs_target) else [])
        if not matches:
            raise FileNotFoundError(f"torchguard target {target!r} does not exist")
        for m in matches:
            paths.extend(_iter_py_files(m))
    return paths


def run(targets: Optional[Iterable[str]] = None, root: Optional[str] = None,
        rules: Optional[Iterable[str]] = None, sources: Optional[dict] = None,
        summary: Optional[dict] = None) -> list[Finding]:
    """Analyze ``targets`` (default :data:`DEFAULT_TARGETS`), or an
    in-memory ``{rel_path: src}`` map (the doc under
    :data:`~.model.KNOB_DOC_PATH` rides in it as text). The whole file set
    is one program, as in jaxguard. ``summary``, when given, receives the
    file count and the sanctions honoured by rule."""
    root = root or os.getcwd()
    if sources is None:
        doc_path = os.path.join(root, KNOB_DOC_PATH)
        doc_text = None
        if os.path.exists(doc_path):
            with open(doc_path, encoding="utf-8") as fh:
                doc_text = fh.read()
        chosen = list(targets) if targets else [
            t for t in DEFAULT_TARGETS if glob.glob(os.path.join(root, t))]
        paths = _expand(chosen, root)
        if not paths:
            raise FileNotFoundError(
                f"no analyzable files under {root!r} — none of "
                f"{', '.join(DEFAULT_TARGETS)} exist (wrong --root/cwd?)")
        program, errors = load_program(paths, root)
    else:
        sources = dict(sources)
        doc_text = sources.pop(KNOB_DOC_PATH, None)
        program, errors = load_program([], root, sources=sources)
    findings = [
        Finding(msg.split(":", 1)[0], int(msg.split(":", 2)[1]), "E999",
                msg.split(":", 2)[2].strip())
        for msg in errors
    ]
    engine = Analyzer(program)
    findings.extend(engine.run())
    findings.extend(analyze_concurrency(program))
    findings.extend(analyze_contracts(program, doc_text))
    findings.extend(analyze_dispatch(program, engine))
    for mod in program.modules.values():
        findings.extend(check_tree(mod.tree, mod.path))
    texts = {m.path: m.src for m in program.modules.values()}
    findings.extend(stale_pragmas(texts, [f for f in findings if f.rule != "E999"]))
    out: list[Finding] = []
    by_path: dict = {}
    for f in findings:
        by_path.setdefault(f.path, []).append(f)
    honoured: dict = {}
    for path, fs in by_path.items():
        allowed = allowed_lines(texts.get(path, ""))
        kept = suppress(fs, allowed, rules)
        out.extend(kept)
        for f in fs:
            if f.rule in allowed.get(f.line, ()):
                honoured[f.rule] = honoured.get(f.rule, 0) + 1
    if summary is not None:
        summary.update(files=len(program.modules),
                       sanctions=sum(len(allowed_lines(s)) for s in texts.values()),
                       sanctioned_by_rule=dict(sorted(honoured.items())))
    return sorted(out, key=lambda f: (f.path, f.line, f.rule))


def analyze_sources(sources: dict, rules: Optional[Iterable[str]] = None
                    ) -> list[Finding]:
    """Test-facing API: an in-memory ``{rel_path: src}`` file set as one
    program."""
    return run(rules=rules, sources=sources)


def analyze_source(src: str, path: str = f"{PKG}/mod_under_test.py",
                   rules: Optional[Iterable[str]] = None) -> list[Finding]:
    return analyze_sources({path: src}, rules=rules)


def write_report(findings: list, path: str, root: str,
                 summary: Optional[dict] = None) -> None:
    counts: dict = {}
    for f in findings:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    report = {
        "tool": "torchguard",
        "root": os.path.abspath(root),
        "rules": ALL_RULES,
        "summary": {"total": len(findings), "by_rule": counts, **(summary or {})},
        "findings": [f.to_dict() for f in findings],
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(report, fh, indent=2)
        fh.write("\n")


def _expand_rules(rules: list) -> list:
    out: list = []
    for rule in rules:
        m = _FAMILY_RE.match(rule)
        family = [r for r in sorted(ALL_RULES) if m and r.startswith(m.group(1))]
        out.extend(family or [rule])
    return out


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m tools.torchguard",
        description=(
            "torchguard: the PyTorch port's static guards, each the twin of "
            "a JAX guard — host syncs and graph signatures (TG101/TG104), "
            "lock discipline (TG201-TG203), the ENV_* knob contract "
            "(TG301-TG304), the decode graphs' capture census, frozen "
            "buffers, kv-layout coverage and stale pragmas (TG401-TG404), "
            "timing windows (TL004/TL005)."),
    )
    parser.add_argument("targets", nargs="*",
                        help="files/directories/globs (default: the port, "
                             "chip_smoke.py, scripts/torch_*.py)")
    parser.add_argument("--rule", action="append", dest="rules", metavar="ID",
                        help="restrict to rule ids (repeatable); TG4xx or "
                             "TLxxx selects a family")
    parser.add_argument("--baseline", default=None, metavar="FILE",
                        help="fail only on findings new against this report "
                             "(by path+rule+function occurrence count)")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalogue")
    parser.add_argument("--json", default=None, metavar="FILE",
                        help="write the machine-readable report here")
    parser.add_argument("--root", default=None,
                        help="repo root paths are relative to (default: cwd)")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule, text in sorted(ALL_RULES.items()):
            print(f"{rule}  {text}")
        return 0
    if args.rules:
        args.rules = _expand_rules(args.rules)
        unknown = set(args.rules) - set(ALL_RULES)
        if unknown:
            print(f"unknown rule ids: {sorted(unknown)}", file=sys.stderr)
            return 2
    baseline: Optional[dict] = None
    if args.baseline:
        try:
            with open(args.baseline, encoding="utf-8") as fh:
                baseline = {}
                for f in json.load(fh)["findings"]:
                    key = (f["path"], f["rule"], f.get("function", ""))
                    baseline[key] = baseline.get(key, 0) + 1
        except (OSError, ValueError, KeyError, TypeError) as err:
            print(f"unreadable baseline {args.baseline!r}: {err}", file=sys.stderr)
            return 2
    summary: dict = {}
    root = args.root or os.getcwd()
    try:
        findings = run(args.targets or None, root, args.rules, summary=summary)
    except FileNotFoundError as err:
        print(str(err), file=sys.stderr)
        return 2
    if args.json:
        write_report(findings, args.json, root, summary)
    if baseline is not None:
        seen: dict = {}
        new: list = []
        for f in findings:
            key = (f.path, f.rule, f.function)
            seen[key] = seen.get(key, 0) + 1
            if seen[key] > baseline.get(key, 0):
                new.append(f)
        findings = new
    for f in findings:
        print(f)
    by_rule: dict = {}
    for f in findings:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    print(f"torchguard: {summary['files']} files, {len(findings)} finding(s) "
          f"{dict(sorted(by_rule.items()))}, {summary['sanctions']} sanction(s) "
          f"{summary['sanctioned_by_rule']}. Rule docs: docs/torch_guards.md",
          file=sys.stderr)
    return 1 if findings else 0
