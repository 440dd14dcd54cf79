"""torchguard: the repo's static guards over the PyTorch port
(``kata_xpu_device_plugin_tpu_torch``), each rule the twin of a JAX
guard's and numbered after it:

- **TG101/TG104** — host syncs on the hot path outside ``allow_transfer``,
  and decode-graph signatures that recapture (:mod:`.dataflow`, twins of
  jaxguard's JG101/JG104);
- **TG201-TG203** — lock discipline over the daemon's and the guest's
  threads (:mod:`.concurrency`, JG2xx);
- **TG301-TG304** — the ``ENV_*`` knob contract (:mod:`.contracts`, JG3xx);
- **TG401-TG404** — the decode graphs' capture census, frozen buffers,
  kv-layout coverage and stale pragmas (:mod:`.dispatch`, JG4xx);
- **TL004/TL005** — unfenced and hand-rolled timing windows
  (:mod:`.timing`, the linter's JX004/JX005).

Stdlib AST analysis, as jaxguard: it imports ``tools.analyze``'s
framework-free engine (the program graph, the taint fixpoint, the lock
model) and nothing of JAX. Run ``python -m tools.torchguard``; suppress
with ``# torchguard: allow(TG101) <reason>`` (:mod:`.pragmas`). The rule
catalogue, the sanction table and the knob table are in
``docs/torch_guards.md``.
"""
from .cli import analyze_source, analyze_sources, main, run, write_report
from .model import ALL_RULES, JAX_TWIN, Finding

__all__ = [
    "ALL_RULES",
    "Finding",
    "JAX_TWIN",
    "analyze_source",
    "analyze_sources",
    "main",
    "run",
    "write_report",
]
