"""torchguard (``tools/torchguard``): one tripping fixture and one negative
control per rule, the tree gate over the repo, parity with the JAX tools
(the TG2xx/TG3xx/TG403/TG404 passes report the lines their JG twins
report on the same sources), the sanction table of ``docs/torch_guards.md``
against both packages, and the tool's import hygiene.

Fixtures are analyzed under repo-relative paths inside the port, so hot
roots, thread entries and knob paths resolve as on the real tree.
"""
import ast
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from tools.analyze import analyze_sources as jg_analyze_sources
from tools.analyze.model import (
    KNOB_CONFIG_PATH as JG_CONFIG,
    KNOB_CONSTANTS_PATH as JG_CONSTANTS,
    KNOB_DOC_PATH as JG_DOC,
)
from tools.torchguard import ALL_RULES, JAX_TWIN, analyze_source, analyze_sources
from tools.torchguard.cli import main
from tools.torchguard.model import (
    KNOB_CONFIG_PATH,
    KNOB_CONSTANTS_PATH,
    KNOB_DOC_PATH,
    PKG,
)
from tools.torchguard.pragmas import PRAGMA_RE, pragma_reason

REPO = Path(__file__).resolve().parent.parent
JAX_PKG = "kata_xpu_device_plugin_tpu"

GUEST = f"{PKG}/guest/mod_under_test.py"
PLUGIN = f"{PKG}/plugin/mod_under_test.py"
SCRIPT = "scripts/torch_under_test.py"


def rules_of(findings):
    return [f.rule for f in findings]


# ----- TG101: host sync on a hot path ------------------------------------------

_HOT = '''
import torch

def step(x):  # torchguard: hot
    y = torch.zeros(4, device="cuda") + x
    return y.sum().item()
'''


@pytest.mark.parametrize("sink", [
    "y.sum().item()", "y.tolist()", "y.cpu()", "float(y.sum())",
    "np.asarray(y)", "y.to('cpu')", "bool(y.any())",
])
def test_tg101_fires_on_each_sync(sink):
    src = "import numpy as np\n" + _HOT.replace("y.sum().item()", sink)
    found = analyze_source(src, GUEST)
    assert rules_of(found) == ["TG101"], found


def test_tg101_fires_on_synchronize_and_truth_test():
    src = '''
import torch

def step(x, ev):  # torchguard: hot
    y = torch.ones(2, device=x.device) * x
    if y.sum() > 0:
        ev.synchronize()
    torch.cuda.synchronize()
    return y
'''
    found = analyze_source(src, GUEST)
    assert rules_of(found) == ["TG101", "TG101", "TG101"]


def test_tg101_near_miss_not_hot():
    assert analyze_source(_HOT.replace("  # torchguard: hot", ""), GUEST) == []


def test_tg101_near_miss_host_tensors_and_lists():
    src = '''
import numpy as np
import torch

def step(arr, cfg):  # torchguard: hot
    t = torch.from_numpy(arr)
    outs = []
    outs.append(torch.zeros(2, device="cuda"))
    n = int(t.sum()) + len(outs) + int(cfg.n_layers)
    return n if outs else 0
'''
    assert analyze_source(src, GUEST) == []


def test_tg101_near_miss_inside_allow_transfer():
    src = '''
import torch
from ..compat import torchapi

def step(x):  # torchguard: hot
    with torchapi.allow_transfer("the admission read"):
        return torch.zeros(4, device="cuda").sum().item()
'''
    assert analyze_source(src, GUEST) == []


_ALLOW_CHAIN = '''
import torch
from ..compat.torchapi import allow_transfer

class GenerationServer:
    def step(self):
        with allow_transfer("admission"):
            self._a()

    def _a(self):
        self._b()

    def _b(self):
        self._c()

    def _c(self):
        return torch.zeros(1, device="cuda").item()
'''


def test_tg101_allow_transfer_sanctions_two_calls_down_not_three():
    found = analyze_source(_ALLOW_CHAIN, GUEST)
    assert rules_of(found) == ["TG101"]
    assert found[0].function.endswith("GenerationServer._c")
    shallow = _ALLOW_CHAIN.replace("        self._c()\n", "        return torch.zeros("
                                   "1, device=\"cuda\").item()\n")
    assert analyze_source(shallow, GUEST) == []


def test_tg101_attribute_dispatch_and_pragma():
    src = '''
import torch

class Graph:
    def __call__(self, tok):
        return torch.zeros(4, device="cuda") + tok

class GenerationServer:
    def __init__(self):
        self._decode = Graph()

    def step(self):
        out = self._decode(1)
        return out.tolist()
'''
    assert rules_of(analyze_source(src, GUEST)) == ["TG101"]
    ok = src.replace("return out.tolist()",
                     "return out.tolist()  # torchguard: allow(TG101) fence")
    assert analyze_source(ok, GUEST) == []


def test_tg101_is_tensor_branch_reads_a_host_value():
    src = '''
import torch

def step(x):  # torchguard: hot
    y = torch.zeros(2, device="cuda")
    pos = y if x else 3
    if not torch.is_tensor(pos):
        return int(pos)
    return 0
'''
    assert analyze_source(src, GUEST) == []


# ----- TG104: decode-graph signature statics -----------------------------------

_SIG = '''
from .decode_graph import DecodeGraph

def build(params, arena, cfg):
    out = []
    for s in (1, 2, 4):
        out.append(DecodeGraph(params, arena, cfg, batch=8, steps=s, device="cuda"))
    return out
'''


def test_tg104_fires_on_loop_varying_static():
    found = analyze_source(_SIG, GUEST)
    assert rules_of(found) == ["TG104"]
    assert "'steps'" in found[0].message


def test_tg104_fires_on_unhashable_static():
    src = _SIG.replace("for s in (1, 2, 4):", "if True:").replace(
        "steps=s", "steps=4, table_width=[8]")
    found = analyze_source(src, GUEST)
    assert rules_of(found) == ["TG104"] and "unhashable" in found[0].message


def test_tg104_near_miss_bounded_static():
    assert analyze_source(_SIG.replace("steps=s", "steps=4"), GUEST) == []


# ----- TG401 / TG402: the decode graphs on the serving path --------------------

_SERVER = '''
from .decode_graph import DecodeGraph

class GenerationServer:
    def __init__(self, params, cfg):
        self.params, self.cfg = params, cfg
        self.arena = None
        self._queue = []
        self._build_decode()

    def _build_decode(self):
        arena = self.kv_pool.arena if self.paged else self.arena
        self._decode = DecodeGraph(self.params, arena, self.cfg, batch=self.max_batch,
                                   steps=self._steps, device=self.device)

    def step(self):
        self._shrink()
        return self._decode(1, 2)

    def _shrink(self):
        self.params = dict(self.params)
        self._build_decode()
'''


def test_tg4_server_fixture_is_clean():
    assert analyze_source(_SERVER, GUEST) == []


def test_tg401_fires_on_unbounded_static():
    src = _SERVER.replace("steps=self._steps", "steps=len(self._queue) + self.x()")
    found = analyze_source(src, GUEST)
    assert rules_of(found) == ["TG401"] and "'steps'" in found[0].message


def test_tg401_fires_on_device_static():
    src = _SERVER.replace("steps=self._steps", "steps=torch.argmax(self.params)")
    assert rules_of(analyze_source(src, GUEST)) == ["TG401"]


def test_tg402_fires_on_rebind_without_rebuild():
    src = _SERVER.replace(
        "        self.params = dict(self.params)\n        self._build_decode()\n",
        "        self.params = dict(self.params)\n        self.kv_pool = None\n")
    found = analyze_source(src, GUEST)
    assert rules_of(found) == ["TG402", "TG402"]
    assert {f.message.split("'")[1] for f in found} == {"self.params", "self.kv_pool"}


def test_tg402_near_miss_in_place_write():
    src = _SERVER.replace(
        "        self.params = dict(self.params)\n",
        "        self.arena[0].copy_(self.params['x'])\n        self.params['x'] = 1\n")
    assert analyze_source(src, GUEST) == []


# ----- TG403: kv-layout coverage ----------------------------------------------

_LATTICE = (
    'ENV_KV_LAYOUT = "KATA_TPU_KV_LAYOUT"\n'
    'KV_LAYOUT_HEADS = "heads"\nKV_LAYOUT_BLOCKS = "blocks"\n'
    "KV_LAYOUTS = (KV_LAYOUT_HEADS, KV_LAYOUT_BLOCKS)\n"
)
_SPEC_OK = '''
def pool_spec(layout):
    if layout == "heads":
        return 1
    if layout == "blocks":
        return 2
'''


def _spec_sources(pkg, body):
    return {f"{pkg}/guest/tp_serving.py": _LATTICE + body}


def test_tg403_fires_on_a_layout_off_the_lattice():
    found = analyze_sources(_spec_sources(PKG, _SPEC_OK.replace('"blocks"', '"rows"')))
    assert rules_of(found) == ["TG403", "TG403"]


def test_tg403_near_miss_whole_lattice():
    assert analyze_sources(_spec_sources(PKG, _SPEC_OK)) == []


# ----- TG201-TG203: lock discipline ---------------------------------------------


def test_tg201_fires_on_bare_access_and_not_under_the_lock():
    src = _DAEMON_FIXTURES["guard_elsewhere"]
    found = analyze_source(src, PLUGIN)
    assert rules_of(found) == ["TG201"] and "_events" in found[0].message
    held = src.replace("        self._events.append(ev)",
                       "        with self._lock:\n            self._events.append(ev)")
    assert analyze_source(held, PLUGIN) == []


def test_tg202_fires_on_inverted_order_and_not_on_a_consistent_one():
    src = _DAEMON_FIXTURES["inverted"]
    assert "TG202" in rules_of(analyze_source(src, PLUGIN))
    same = src.replace("with self._b:\n            with self._a:",
                       "with self._a:\n            with self._b:")
    assert analyze_source(same, PLUGIN) == []


_BUILD = '''
import threading
import time

class Builder:
    def __init__(self):
        self._lock = threading.Lock()

    def build(self):
        with self._lock:
            time.sleep(0.1)
'''


def test_tg203_fires_on_a_registered_thread_entry_only():
    # ops._build.build/load are registered entries; a bare function of
    # that name elsewhere is not.
    path = f"{PKG}/ops/builder.py"
    assert analyze_source(_BUILD, path) == []
    entry = _BUILD.replace("class Builder:", "class _Handler:").replace(
        "def build(self):", "def do_GET(self):")
    found = analyze_source(entry, path)
    assert rules_of(found) == ["TG203"] and "time.sleep" in found[0].message
    unlocked = entry.replace("        with self._lock:\n            time.sleep(0.1)",
                             "        time.sleep(0.1)")
    assert analyze_source(unlocked, path) == []


# ----- TG301-TG304: the knob contract ---------------------------------------------


def _port_knobs(**replace):
    return _knobs(PKG, KNOB_CONSTANTS_PATH, KNOB_CONFIG_PATH, KNOB_DOC_PATH,
                  **replace)


def test_knob_contract_all_legs_green():
    green = _port_knobs(**{
        KNOB_CONSTANTS_PATH: 'ENV_FOO = "KATA_TPU_FOO"\n',
        f"{PKG}/guest/parse_under_test.py": (
            "import os\n\ndef read():\n    try:\n"
            '        return int(os.environ.get("KATA_TPU_FOO", "0"))\n'
            "    except ValueError:\n        return 0\n")})
    assert analyze_sources(green) == []


@pytest.mark.parametrize("rule,replace", [
    ("TG301", {KNOB_CONFIG_PATH: "class Config:\n    other: int = 0\n"}),
    ("TG302", {f"{PKG}/plugin/inject_under_test.py": "def build(cfg):\n    return {}\n"}),
    ("TG303", {f"{PKG}/guest/parse_under_test.py": (
        'import os\n\ndef read():\n    return int(os.environ.get("KATA_TPU_FOO", "0"))\n')}),
    ("TG304", {KNOB_DOC_PATH: "no rows\n"}),
])
def test_knob_contract_each_leg_fires(rule, replace):
    sources = _port_knobs(**{
        KNOB_CONSTANTS_PATH: 'ENV_FOO = "KATA_TPU_FOO"\n',
        f"{PKG}/guest/parse_under_test.py": (
            "import os\n\ndef read():\n    try:\n"
            '        return int(os.environ.get("KATA_TPU_FOO", "0"))\n'
            "    except ValueError:\n        return 0\n")})
    sources.update(replace)
    assert rules_of(analyze_sources(sources)) == [rule]


def test_knob_contract_guest_local_and_aliased_injection():
    # A guest-local knob owes no Config field and no injection; a knob
    # the injection surface names through an import alias is injected.
    sources = _port_knobs(**{
        KNOB_CONSTANTS_PATH: ('ENV_FOO = "KATA_TPU_FOO"\n'
                              'ENV_STRICT = "KATA_TPU_STRICT"\n'),
        KNOB_DOC_PATH: "`KATA_TPU_FOO` `KATA_TPU_STRICT`\n",
        f"{PKG}/plugin/inject_under_test.py": (
            "from ..constants import ENV_FOO as ENV_SERVING_FOO\n\n"
            "def build(cfg):\n    return {ENV_SERVING_FOO: str(cfg.foo)}\n"),
        f"{PKG}/guest/parse_under_test.py": "def read():\n    return 0\n"})
    assert analyze_sources(sources) == []


_UPLOAD = '''
import torch

class GenerationServer:
    def step(self):
        self._commit([1, 2])

    def _commit(self, slots):
        return torch.as_tensor(slots, dtype=torch.long, device=self.device)
'''


def test_tg403_fires_on_a_synchronous_upload_on_the_serving_path():
    found = analyze_source(_UPLOAD, GUEST)
    assert rules_of(found) == ["TG403"] and "torch.as_tensor" in found[0].message
    inline = _UPLOAD.replace(
        "torch.as_tensor(slots, dtype=torch.long, device=self.device)",
        "torch.from_numpy(slots).to(self.device)")
    assert rules_of(analyze_source(inline, GUEST)) == ["TG403"]


def test_tg403_near_miss_filled_pinned_or_sanctioned_upload():
    for body in ("torch.full((), 3, device=self.device)",
                 "torch.from_numpy(slots).pin_memory().to(self.device, non_blocking=True)",
                 "torch.from_numpy(slots).to(self.device, non_blocking=True)"):
        src = _UPLOAD.replace(
            "torch.as_tensor(slots, dtype=torch.long, device=self.device)", body)
        assert analyze_source(src, GUEST) == [], body
    allowed = _UPLOAD.replace(
        "        self._commit([1, 2])",
        "        with allow_transfer(\"admission\"):\n            self._commit([1, 2])")
    assert analyze_source(allowed, GUEST) == []
    trainer = _UPLOAD.replace("class GenerationServer:", "class Trainer:")
    assert analyze_source(trainer, GUEST) == []


# ----- TG404: stale pragmas ------------------------------------------------------


def test_tg404_fires_on_a_pragma_that_suppresses_nothing():
    src = "def f():\n    return 1  # torchguard: allow(TG101) nothing syncs here\n"
    assert rules_of(analyze_source(src, GUEST)) == ["TG404"]


def test_tg404_near_miss_live_pragma_and_escape_hatch():
    src = _HOT.replace(".item()", ".item()  # torchguard: allow(TG101) the fence")
    assert analyze_source(src, GUEST) == []
    kept = "def f():\n    return 1  # torchguard: allow(TG101, TG404) defensive\n"
    assert analyze_source(kept, GUEST) == []


# ----- TL004 / TL005: timing windows ------------------------------------------

_TIMED = '''
import time
import torch

def bench(fn, x):
    t0 = time.perf_counter()
    y = fn(x)
    return y, time.perf_counter() - t0
'''


def test_tl004_fires_on_unfenced_script_window():
    found = analyze_source(_TIMED, SCRIPT)
    assert rules_of(found) == ["TL004"]
    assert rules_of(analyze_source(_TIMED, "chip_smoke.py")) == ["TL004"]


def test_tl004_near_miss_fenced_or_out_of_scope():
    fenced = _TIMED.replace("    y = fn(x)\n", "    y = fn(x)\n    torch.cuda.synchronize()\n")
    assert analyze_source(fenced, SCRIPT) == []
    event = _TIMED.replace("    y = fn(x)\n", "    y = fn(x)\n    ev = torch.cuda.Event()\n"
                           "    ev.record()\n    ev.synchronize()\n")
    assert analyze_source(event, SCRIPT) == []
    assert analyze_source(_TIMED, "scripts/exp_other.py") == []


def test_tl005_fires_on_library_window_only():
    assert rules_of(analyze_source(_TIMED, GUEST)) == ["TL005"]
    assert analyze_source(_TIMED, f"{PKG}/obs/mod_under_test.py") == []
    one = _TIMED.replace("time.perf_counter() - t0", "t0")
    assert analyze_source(one, GUEST) == []


def test_capture_spans_join_the_server_trace():
    """TL005's fix times a graph capture in an ``obs.span``: the span must
    join the server's trace (the daemon's per-allocation id), as every
    other span of the server does."""
    from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer
    from kata_xpu_device_plugin_tpu_torch.models import init_params
    from kata_xpu_device_plugin_tpu_torch.models.transformer import tiny_test_config

    cfg = tiny_test_config()
    params = init_params(cfg, seed=0, device="cpu")
    srv = GenerationServer(params, cfg, max_batch=2, max_len=64, chunk=2,
                           persistent=True, device="cpu")
    assert srv._decode.trace_id == srv._round.trace_id == srv._trace


def test_every_rule_has_a_jax_twin_and_a_fixture():
    assert set(ALL_RULES) == set(JAX_TWIN)
    text = Path(__file__).read_text()
    for rule in ALL_RULES:
        assert f'"{rule}"' in text, rule


# ----- parity with the JAX tools -----------------------------------------------

_DAEMON_FIXTURES = {
    "guard_elsewhere": '''
import threading

class Sink:
    def __init__(self):
        self._lock = threading.Lock()
        self._events = []
        self._t = threading.Thread(target=self.emit)

    def emit(self, ev):
        self._events.append(ev)

    def flush(self):
        with self._lock:
            self._events.clear()
''',
    "bare_write": '''
import threading

class Poller:
    def __init__(self):
        self._lock = threading.Lock()
        self.n = 0
        threading.Thread(target=self._loop).start()

    def _loop(self):
        self.n += 1
        with self._lock:
            self.seen = self.n
''',
    "inverted": '''
import threading

class Pair:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()

    def ab(self):
        with self._a:
            with self._b:
                return 1

    def ba(self):
        with self._b:
            with self._a:
                return 2
''',
    "reacquire": '''
import threading

class Once:
    def __init__(self):
        self._lock = threading.Lock()

    def stats(self):
        with self._lock:
            return self._both()

    def _both(self):
        with self._lock:
            return 1
''',
    "blocking": '''
import json
import os
import threading
import time

import grpc

class AllocationJournal:
    def __init__(self, path):
        self._lock = threading.Lock()
        self.path = path

    def record(self, entry):
        with self._lock:
            self._save_locked(entry)

    def _save_locked(self, entry):
        os.makedirs("d", exist_ok=True)
        with open(self.path, "w") as fh:
            json.dump(entry, fh)
        time.sleep(0.1)
        grpc.insecure_channel("unix:///x")
''',
    "servicer": '''
import threading
import time

class Plugin(DevicePluginServicer):
    def __init__(self):
        self._lock = threading.Lock()
        self.devs = {}

    def Allocate(self, request, context):
        with self._lock:
            time.sleep(0.5)
        self.devs["a"] = 1
        return self.devs

    def refresh(self):
        with self._lock:
            self.devs = {}
''',
}


def _lines(findings, prefix):
    return sorted((f.line, f.rule[2:]) for f in findings if f.rule.startswith(prefix))


@pytest.mark.parametrize("name", sorted(_DAEMON_FIXTURES))
def test_tg2xx_reports_the_lines_of_jg2xx(name):
    src = _DAEMON_FIXTURES[name]
    jg = jg_analyze_sources({f"{JAX_PKG}/plugin/mod_under_test.py": src})
    tg = analyze_sources({PLUGIN: src})
    assert _lines(jg, "JG2"), f"fixture {name} trips nothing"
    assert _lines(tg, "TG2") == _lines(jg, "JG2")


def _knobs(pkg, constants, config, doc, **replace):
    sources = {
        constants: 'ENV_FOO = "KATA_TPU_FOO"\nENV_BAR = "KATA_TPU_BAR"\n',
        config: "class Config:\n    foo: int = 0\n",
        f"{pkg}/plugin/inject_under_test.py": (
            "from .. import constants\n\n"
            "def build(cfg):\n"
            "    return {constants.ENV_FOO: str(cfg.foo)}\n"),
        f"{pkg}/guest/parse_under_test.py": (
            "import os\n\n"
            "def read():\n"
            '    a = int(os.environ.get("KATA_TPU_FOO", "0"))\n'
            "    try:\n"
            '        return a + float(os.environ.get("KATA_TPU_BAR", "0"))\n'
            "    except ValueError:\n"
            "        return a\n"),
        doc: "| `KATA_TPU_FOO` | `foo` | the default |\n",
    }
    sources.update(replace)
    return sources


def test_tg3xx_reports_the_lines_of_jg3xx():
    jg = jg_analyze_sources(_knobs(JAX_PKG, JG_CONSTANTS, JG_CONFIG, JG_DOC))
    tg = analyze_sources(_knobs(PKG, KNOB_CONSTANTS_PATH, KNOB_CONFIG_PATH,
                                KNOB_DOC_PATH))
    # ENV_BAR: no field, no injection, no doc row; ENV_FOO: a raising parse.
    assert {r for _ln, r in _lines(jg, "JG3")} == {"301", "302", "303", "304"}
    assert _lines(tg, "TG3") == _lines(jg, "JG3")


def test_tg403_and_tg404_report_the_lines_of_their_twins():
    body = _SPEC_OK.replace('"blocks"', '"rows"') + (
        "\ndef f():\n    return 1  # {tool}: allow({rule}) stale\n")
    jg = jg_analyze_sources({f"{JAX_PKG}/guest/tp_serving.py": _LATTICE + body.format(
        tool="jaxguard", rule="JG203")})
    tg = analyze_sources({f"{PKG}/guest/tp_serving.py": _LATTICE + body.format(
        tool="torchguard", rule="TG203")})
    assert [r for _ln, r in _lines(jg, "JG4")] == ["403", "403", "404"]
    assert _lines(tg, "TG4") == _lines(jg, "JG4")


# ----- the sanction table ---------------------------------------------------------


def _sanction_rows():
    rows = {}
    text = (REPO / "docs" / "torch_guards.md").read_text()
    for line in text.splitlines():
        m = re.match(r"\| `([^`]+:\d+)` \| ([A-Z0-9, ]+) \| `([^`]+)` `([^`]+)` "
                     r"\| (pragma|allow_transfer|absent): (.+) \|$", line)
        if m:
            rows[m.group(1)] = m.groups()[1:]
    return rows


def _function_lines(path: Path, qualname: str) -> list:
    tree = ast.parse(path.read_text())
    lines = path.read_text().splitlines()

    def find(node, parts):
        for ch in ast.iter_child_nodes(node):
            if getattr(ch, "name", None) == parts[0]:
                return ch if len(parts) == 1 else find(ch, parts[1:])
        return None

    fn = find(tree, qualname.split("."))
    assert fn is not None, f"{path}: no {qualname}"
    return lines[fn.lineno - 1:fn.end_lineno]


def test_every_jax_sanction_has_its_port_twin_or_a_reason():
    jax_root = REPO / JAX_PKG
    from tools.pragmas import PRAGMA_RE as JG_PRAGMA

    sanctions = {}
    for path in sorted(jax_root.rglob("*.py")):
        for i, line in enumerate(path.read_text().splitlines(), start=1):
            m = JG_PRAGMA.search(line)
            if m and "jaxguard" in line[m.start():m.end()]:
                sanctions[f"{path.relative_to(jax_root)}:{i}"] = (
                    m.group(1), line[m.end():].strip())
    assert len(sanctions) == 34
    rows = _sanction_rows()
    assert set(rows) == set(sanctions)
    for site, (rules, reason) in sanctions.items():
        got_rules, port_path, qualname, status, text = rows[site]
        assert got_rules.replace(" ", "") == rules.replace(" ", ""), site
        body = _function_lines(REPO / PKG / port_path, qualname)
        if status == "pragma":
            twins = {"TG" + r.strip()[2:] for r in rules.split(",")}
            held = [pragma_reason(ln) for ln in body if PRAGMA_RE.search(ln)
                    and twins <= set(PRAGMA_RE.search(ln).group(1).replace(" ", "").split(","))]
            assert reason in held and text == reason, (site, held)
        elif status == "allow_transfer":
            assert text.strip()
        else:
            assert len(text.split()) >= 5, site


def test_allow_transfer_rows_are_sanctioned_by_the_analyzer():
    from tools.analyze.cli import _iter_py_files
    from tools.torchguard.dataflow import Analyzer, load_program

    prog, _ = load_program(list(_iter_py_files(str(REPO / PKG))), str(REPO))
    an = Analyzer(prog)
    an.run()
    hot = an._hot_set()
    sanctioned = an._sanctioned(hot)
    for _rules, port_path, qualname, status, _text in _sanction_rows().values():
        if status != "allow_transfer":
            continue
        q = f"{PKG}.{port_path[:-3].replace('/', '.')}:{qualname}"
        lexical = any("allow_transfer(" in ln for ln in
                      _function_lines(REPO / PKG / port_path, qualname))
        assert q in sanctioned or lexical, q


# ----- the tree gate -------------------------------------------------------------


def test_tree_is_clean_and_a_removed_sanction_fails(tmp_path, capsys):
    assert main(["--root", str(REPO)]) == 0
    err = capsys.readouterr().err
    assert "0 finding(s)" in err and "sanction(s)" in err
    for rel in (PKG, "chip_smoke.py", "docs/torch_guards.md"):
        src = REPO / rel
        dst = tmp_path / rel
        if src.is_dir():
            shutil.copytree(src, dst, ignore=shutil.ignore_patterns("__pycache__"))
        else:
            dst.parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(src, dst)
    trainer = tmp_path / PKG / "parallel" / "trainer.py"
    text = trainer.read_text()
    pragma = "  # torchguard: allow(TG101) end-of-run conversion, after the loop"
    assert pragma in text
    trainer.write_text(text.replace(pragma, ""))
    assert main(["--root", str(tmp_path), PKG]) == 1
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1 and "parallel/trainer.py" in out[0] and "TG101" in out[0]


def test_cli_json_report_and_usage_errors(tmp_path):
    out = tmp_path / "r.json"
    src = tmp_path / "scripts" / "torch_t.py"
    src.parent.mkdir()
    src.write_text(_TIMED)
    assert main(["--root", str(tmp_path), "--json", str(out), "scripts/torch_t.py"]) == 1
    import json

    report = json.loads(out.read_text())
    assert report["tool"] == "torchguard" and report["summary"]["by_rule"] == {"TL004": 1}
    assert main(["--root", str(tmp_path), "--baseline", str(out),
                 "scripts/torch_t.py"]) == 0
    assert main(["--rule", "TG999"]) == 2
    assert main(["--root", str(tmp_path), "missing.py"]) == 2


# ----- hygiene -------------------------------------------------------------------


def test_tool_and_harness_import_nothing_of_jax():
    files = sorted((REPO / "tools" / "torchguard").glob("*.py")) + [
        REPO / "tests" / "torch_race_harness.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            bad = [n for n in names if n == "jax" or n.startswith("jax.")
                   or n == JAX_PKG or n.startswith(JAX_PKG + ".")]
            assert not bad, f"{path}:{node.lineno} imports {bad}"
    code = ("import sys; sys.path.insert(0, 'tests'); import tools.torchguard.cli; "
            "import torch_race_harness; "
            f"bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            f"or m == {JAX_PKG!r} or m.startswith({JAX_PKG!r} + '.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
