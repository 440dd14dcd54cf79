"""Device-utilization and memory ledger of a serving loop (counterpart of
``kata_xpu_device_plugin_tpu/obs/devledger.py``).

The server calls :meth:`DeviceLedger.on_dispatch` right before each decode
dispatch and :meth:`DeviceLedger.note_retire` at its retire fence; on the
card the stamps sit around the graph replay, never inside a capture.

- **Cost.** Each distinct dispatch signature (plain or fused chunk,
  persistent round, paged or slotted, steps, budget mask) is costed ONCE,
  analytically, by a callable the server passes (:func:`decode_cost`: the
  matmuls' 2 x parameters x tokens plus the attention over the keys the
  signature reads). Nothing is run to count: the JAX package lowers the
  executable and reads shapes only, and the port must not execute a chunk
  against the live arena either (a FLOP counter would run it, and would not
  see the custom CUDA launches). A signature whose cost callable fails
  degrades with one ``cost_unavailable`` event and adds no FLOPs.
- **Timing.** The dispatch and retire stamps give ``device_busy_frac``
  (the share of the heartbeat interval covered by decode rounds in flight)
  and ``mfu`` (the interval's FLOPs over its wall time x the peak of the
  server's device). Every shard of a tensor-parallel port server sits on
  its one card, so the peak is that card's, not x tp as on the JAX
  package's chips. The retire-to-next-dispatch host gap is
  attributed to the loop's phase clock (``dispatch_gap_*``). A persistent
  round's cost is that of its whole step cap, credited by the steps it
  delivered.
- **Memory.** At heartbeat cadence, ``torch.cuda.memory_stats()`` and
  ``torch.cuda.mem_get_info()``: bytes allocated (``hbm_used_bytes``), its
  peak, the allocator's reserve, the card's total and the headroom (free
  on the card plus the allocator's unused reserve), and the server's own
  components (``hbm_<name>_bytes``: params, the arena or pool, a
  standalone prefix store, the staged resume upload, the decode graphs'
  private pool) with the residual ``hbm_unattributed_bytes``. On the CPU
  the ``hbm_*`` fields are omitted, never faked as 0, with one
  ``hbm_stats_unavailable`` event.

The peak is the dense bf16 rate of the card (:data:`PEAK_FLOPS`, matched on
the device name); the CPU's figure is a placeholder that only keeps the
field's arithmetic defined there. An ``mfu`` above 1 means the count or the
peak is wrong. Pure host arithmetic: the ledger never fences or touches
device values, so greedy tokens are the same with it armed.
``KATA_TPU_DEVLEDGER=0`` disarms it without touching the heartbeat.
"""
from __future__ import annotations

import os
import time
from collections import deque
from typing import Callable, Optional

from ..constants import ENV_DEVLEDGER
from . import events

# Dense bf16 peak FLOP/s by a substring of the device name: NVIDIA H100
# SXM5 (80GB HBM3), data sheet, 700 W.
PEAK_FLOPS = {"H100": 989e12}
# The CPU's figure: a placeholder that keeps mfu defined in CPU tests, not
# a rate of any processor.
CPU_PLACEHOLDER_FLOPS = 0.1e12

# A dispatch that raised out of the loop leaves its entry unretired;
# bound the FIFO (healthy depth: 1 lock-step, 2 overlapped).
_MAX_PENDING = 4


def enabled() -> bool:
    """Is the ledger armed (``KATA_TPU_DEVLEDGER`` != "0")?"""
    return os.environ.get(ENV_DEVLEDGER, "1") != "0"


def matmul_params(cfg) -> int:
    """Parameters that take part in a matmul for every token: the layers'
    projections (a gated MLP, none for an MoE layer: :func:`moe_cost`) and
    the unembedding; the embedding gather is excluded (the JAX package's
    bench convention)."""
    per_layer = (cfg.d_model * cfg.q_dim + 2 * cfg.d_model * cfg.kv_dim
                 + cfg.q_dim * cfg.d_model)
    if not cfg.moe_num_experts:
        per_layer += 3 * cfg.d_model * cfg.d_ff
    return cfg.n_layers * per_layer + cfg.d_model * cfg.vocab_size


def moe_cost(cfg, tokens: int) -> tuple[float, float]:
    """``(flops, weight bytes)`` of the MoE FFNs of one forward call over
    ``tokens`` tokens (0 and 0 for a dense config): a layer's router
    ``2·T·d·E`` and its experts' MLPs over every capacity slot, filled or
    not, ``2·E·C·3·d·f``; every expert's weights and the router read."""
    from ..ops.moe import capacity

    E = cfg.moe_num_experts
    if not E or not tokens:
        return 0.0, 0.0
    d, f = cfg.d_model, cfg.d_ff
    C = capacity(cfg.moe_cfg(), tokens)
    flops = cfg.n_layers * (2.0 * tokens * d * E + 2.0 * E * C * 3 * d * f)
    nbytes = cfg.n_layers * (d * E + E * 3 * d * f) * getattr(cfg.dtype, "itemsize", 2)
    return flops, float(nbytes)


def decode_cost(cfg, *, lanes: int, steps: int, keys: float,
                kv_quant: bool, prefill_tokens: int = 0,
                prefill_keys: float = 0.0) -> dict:
    """FLOPs and bytes of one decode dispatch, from shapes alone: ``lanes``
    rows (every lane the chunk computes, live or not) for ``steps`` steps,
    each attending ``keys`` keys, plus an admission slice of
    ``prefill_tokens`` rows that attend ``prefill_keys`` keys each. FLOPs:
    2 x matmul parameters x tokens, plus 4 x heads x head_dim per (row,
    key) for QK^T and PV over every layer; an MoE config adds each forward
    call's experts (:func:`moe_cost`: a decode step is one call of
    ``lanes`` tokens, the admission slice another). Bytes: the weights
    once a step and the KV rows read."""
    p = matmul_params(cfg)
    tokens = lanes * steps + prefill_tokens
    per_key = 4 * cfg.n_heads * cfg.head_dim * cfg.n_layers
    step_moe, moe_bytes = moe_cost(cfg, lanes)
    flops = 2.0 * p * tokens + per_key * (lanes * steps * keys
                                          + prefill_tokens * prefill_keys)
    flops += steps * step_moe + moe_cost(cfg, prefill_tokens)[0]
    wbytes = p * getattr(cfg.dtype, "itemsize", 2) + moe_bytes
    row = cfg.head_dim * (1 if kv_quant else 2) + (4 if kv_quant else 0)
    kv = 2 * cfg.n_layers * cfg.n_kv_heads * row
    nbytes = (steps + (1 if prefill_tokens else 0)) * wbytes + kv * (
        lanes * steps * keys + prefill_tokens * prefill_keys)
    return {"flops": flops, "bytes_accessed": float(nbytes)}


class DeviceLedger:
    """Per-server device-utilization and memory ledger (module doc).

    ``gap_phases`` fixes the heartbeat's gap-attribution fields (the loop's
    phases); ``clock`` is the loop's phase clock; ``components`` returns the
    server's device-resident byte counts (non-overlapping); ``device`` is
    the server's device, the one polled and whose peak counts."""

    def __init__(self, *, armed: bool = True,
                 emit: Optional[Callable[..., None]] = None,
                 clock=None, gap_phases: tuple = ("other",),
                 components: Optional[Callable[[], dict]] = None,
                 device=None):
        self.armed = bool(armed)
        self._emit_fn = emit
        self._clock = clock
        self._gap_phases = tuple(gap_phases)
        if "other" not in self._gap_phases:
            self._gap_phases = self._gap_phases + ("other",)
        self._components = components
        self._device = device
        # Signature key -> {"flops", "bytes_accessed"}, or None when its
        # cost was unavailable (never asked again).
        self._costs: dict = {}
        self._cost_unavailable = 0
        self._pending: deque = deque()
        self._t_last_retire: Optional[float] = None
        self._snap_retire: dict = {}
        self._i = self._fresh_interval()
        self._dispatches = 0
        self._retired = 0
        self._peak_flops: Optional[float] = None
        self._hbm_peak = 0
        self._mem_unavailable = False
        self._mem_unavailable_emitted = False
        self._last_fields: dict = {}

    # ----- plumbing --------------------------------------------------------

    def _fresh_interval(self) -> dict:
        return {
            "dispatches": 0, "retires": 0, "busy_s": 0.0, "flops": 0.0,
            "gaps": 0, "gap_s": 0.0,
            "gap_attr": {p: 0.0 for p in self._gap_phases},
        }

    def _do_emit(self, name: str, **fields) -> None:
        try:
            if self._emit_fn is not None:
                self._emit_fn(name, **fields)
            else:
                events.emit("serving", name, **fields)
        except Exception:
            pass  # telemetry must never add a serving failure mode

    def _dev(self):
        import torch

        if self._device is None:
            self._device = (torch.device("cuda", torch.cuda.current_device())
                            if torch.cuda.is_available() else torch.device("cpu"))
        return torch.device(self._device)

    def peak_flops(self) -> float:
        """The peak FLOP/s of the server's device: its dense bf16 rate; the
        CPU placeholder on the CPU; 0.0 (mfu reads 0) on a card the table
        does not list."""
        if self._peak_flops is None:
            dev = self._dev()
            if dev.type != "cuda":
                peak = CPU_PLACEHOLDER_FLOPS
            else:
                import torch

                name = torch.cuda.get_device_name(dev)
                peak = next((f for k, f in PEAK_FLOPS.items() if k in name), 0.0)
            self._peak_flops = peak
        return self._peak_flops

    # ----- the dispatch-site hooks -----------------------------------------

    def on_dispatch(self, key: tuple, cost: Callable[[], dict],
                    loop_cap: Optional[int] = None) -> None:
        """Right before the dispatch: cost the signature on first sight
        (``cost()``), stamp the dispatch, and attribute the host gap since
        the last retire to the phase clock's deltas (residual ``other``;
        shares rescaled to sum to the gap). ``loop_cap``: a persistent
        round's step cap, which its cost covers in full."""
        if not self.armed:
            return
        if key not in self._costs:
            try:
                c = cost()
                c = c if c and c.get("flops", 0) > 0 else None
                reason = "no_flops"
            except Exception as exc:
                c, reason = None, f"cost_failed:{type(exc).__name__}"
            self._costs[key] = c
            if c is None:
                self._cost_unavailable += 1
                self._do_emit("cost_unavailable", reason=reason,
                              signature=repr(key))
        now = time.perf_counter()
        if self._t_last_retire is not None:
            gap = max(now - self._t_last_retire, 0.0)
            attr: dict = {}
            if self._clock is not None:
                for p, v in self._clock.snapshot().items():
                    d = v - self._snap_retire.get(p, 0.0)
                    if d > 0:
                        attr[p] = d
            total = sum(attr.values())
            if total > gap > 0:
                scale = gap / total
                attr = {p: v * scale for p, v in attr.items()}
                total = gap
            i = self._i
            i["gaps"] += 1
            i["gap_s"] += gap
            ga = i["gap_attr"]
            for p, v in attr.items():
                k = p if p in ga else "other"
                ga[k] = ga.get(k, 0.0) + v
            ga["other"] += max(gap - total, 0.0)
        if len(self._pending) >= _MAX_PENDING:
            self._pending.popleft()  # abandoned by a raising dispatch
        self._pending.append((key, now, loop_cap))
        self._dispatches += 1
        self._i["dispatches"] += 1

    def note_retire(self, now: Optional[float] = None,
                    delivered_steps: Optional[int] = None) -> None:
        """At the retire fence: credit the oldest dispatch's busy time
        (anchored at the later of its dispatch and the previous retire, so
        overlapped chunks never count their shared window twice) and its
        FLOPs (a persistent round's by ``delivered_steps / loop_cap``), and
        snapshot the phase clock as the next gap's baseline."""
        if not self.armed or not self._pending:
            return
        if now is None:
            now = time.perf_counter()
        key, t_dispatch, loop_cap = self._pending.popleft()
        anchor = (t_dispatch if self._t_last_retire is None
                  else max(t_dispatch, self._t_last_retire))
        busy = max(now - anchor, 0.0)
        self._t_last_retire = now
        if self._clock is not None:
            self._snap_retire = self._clock.snapshot()
        cost = self._costs.get(key)
        if cost:
            flops = cost["flops"]
            if loop_cap and delivered_steps is not None:
                flops *= min(max(delivered_steps, 0), loop_cap) / loop_cap
            self._i["flops"] += flops
        self._i["busy_s"] += busy
        self._retired += 1
        self._i["retires"] += 1

    # ----- memory poll (heartbeat cadence) ---------------------------------

    def poll_memory(self) -> dict:
        """One allocator poll plus component attribution: the ``hbm_*``
        fields, empty where the device has no allocator statistics (the
        CPU), announced once as ``hbm_stats_unavailable``."""
        if not self.armed:
            return {}
        dev = self._dev()
        stats = None
        if dev.type == "cuda":
            import torch

            try:
                stats = torch.cuda.memory_stats(dev)
                free, total = torch.cuda.mem_get_info(dev)
            except Exception:
                stats = None
        if not stats:
            self._mem_unavailable = True
            if not self._mem_unavailable_emitted:
                self._mem_unavailable_emitted = True
                self._do_emit("hbm_stats_unavailable",
                              reason="memory_stats_none", platform=dev.type)
            return {}
        self._mem_unavailable = False
        used = int(stats.get("allocated_bytes.all.current", 0))
        reserved = int(stats.get("reserved_bytes.all.current", 0))
        peak = int(stats.get("allocated_bytes.all.peak", 0))
        self._hbm_peak = max(self._hbm_peak, peak, used)
        out = {
            "hbm_used_bytes": used,
            "hbm_peak_bytes": self._hbm_peak,
            "hbm_reserved_bytes": reserved,
            "hbm_limit_bytes": int(total),
            "hbm_headroom_bytes": int(free) + max(reserved - used, 0),
        }
        comp: dict = {}
        if self._components is not None:
            try:
                comp = dict(self._components())
            except Exception:
                comp = {}
        attributed = 0
        for name, v in comp.items():
            v = int(v or 0)
            out[f"hbm_{name}_bytes"] = v
            attributed += v
        if comp:
            out["hbm_attributed_bytes"] = attributed
            # Signed: a negative residual is as diagnostic as a leak.
            out["hbm_unattributed_bytes"] = used - attributed
        return out

    def hbm_headroom(self) -> Optional[int]:
        """Last polled headroom; None where unavailable (the gauge exports
        NaN rather than a fake 0)."""
        v = self._last_fields.get("hbm_headroom_bytes")
        return int(v) if v is not None else None

    # ----- surfacing -------------------------------------------------------

    def heartbeat_fields(self, interval_s: float) -> dict:
        """Drain the interval into the heartbeat's ledger fields: the full
        utilization set on an armed ledger (zeros before any dispatch) and
        the ``hbm_*`` fields where the device reports them. Disarmed: {}."""
        if not self.armed:
            return {}
        i, self._i = self._i, self._fresh_interval()
        interval_s = max(float(interval_s), 1e-9)
        gap_ms = (i["gap_s"] / i["gaps"] * 1e3) if i["gaps"] else 0.0
        peak = self.peak_flops()
        fields = {
            "mfu": round(i["flops"] / (interval_s * peak), 6) if peak else 0.0,
            "device_busy_frac": round(min(i["busy_s"] / interval_s, 1.0), 4),
            "dispatch_gap_ms": round(gap_ms, 4),
            "dispatches_delta": i["dispatches"],
        }
        for p in self._gap_phases:
            fields[f"dispatch_gap_{p}_ms"] = round(
                (i["gap_attr"].get(p, 0.0) / i["gaps"] * 1e3)
                if i["gaps"] else 0.0, 4)
        fields.update(self.poll_memory())
        self._last_fields = fields
        return fields

    def stats_fields(self) -> dict:
        """The ``stats()`` block: ``mfu``, ``device_busy_frac`` and
        ``dispatch_gap_ms`` of the last heartbeat interval (0.0 before the
        first or disarmed) and the ``devledger`` detail."""
        last = self._last_fields
        detail = {
            "armed": int(self.armed),
            "dispatches": self._dispatches,
            "retired": self._retired,
            "cost_signatures": len(self._costs),
            "cost_unavailable": self._cost_unavailable,
            "peak_flops": self.peak_flops() if self.armed else 0.0,
            "hbm_stats_available": int(
                self.armed and not self._mem_unavailable
                and any(k.startswith("hbm_") for k in last)),
        }
        detail.update({k: v for k, v in last.items()
                       if k.startswith(("hbm_", "dispatch_gap_"))})
        return {
            "mfu": last.get("mfu", 0.0),
            "device_busy_frac": last.get("device_busy_frac", 0.0),
            "dispatch_gap_ms": last.get("dispatch_gap_ms", 0.0),
            "devledger": detail,
        }
