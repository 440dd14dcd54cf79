"""SLO-burn watchdog over serving heartbeats (a copy of
``kata_xpu_device_plugin_tpu/obs/watchdog.py``: the same rules, knobs,
alert kinds and events, over the port's flight ring and profiler).

The flight recorder (:mod:`.flight`) answers "what happened" only after a
TERMINAL event; everything softer — serving got slow, the pool started
thrashing, the host tier stopped hitting — used to require an operator
staring at dashboards. This module closes that gap: the serving loop
feeds each periodic ``serving_heartbeat`` (one host dict every K rounds,
``guest/serving.py``) into :meth:`SLOBurnWatchdog.observe`, which keeps
rolling burn-rate windows over the ITL SLO budget plus a small set of
anomaly rules, and on a SUSTAINED breach turns the incident into on-disk
artifacts with zero operator action:

- one ``watchdog_alert`` event (kind, the triggering numbers, the dump
  path) on the same stream/trace as everything else;
- a flight-ring postmortem dump (``katatpu_flight_watchdog_<kind>_*``)
  — the ring is always armed, so the K heartbeats and every serving
  event leading INTO the breach are captured even with the JSONL sink
  off;
- optionally a bounded ``torch.profiler`` window (:class:`.ProfilerHook`
  over the next N heartbeats) when a profile dir is configured — the
  Chrome trace of the slow period itself.

Alert kinds (``ALERT_KINDS``):

- ``slo_burn``            — the rolling fraction of heartbeats whose ITL
  p99 exceeds the SLO budget (``KATA_TPU_ITL_SLO_MS``) crossed the burn
  threshold over the window;
- ``preempt_storm``       — preemptions per heartbeat at/over the storm
  threshold (pool thrash: spill/restore churn eats the decode cadence);
- ``recovery_storm``      — supervisor recoveries per heartbeat at/over
  threshold (crash/chip-loss incidents);
- ``host_hit_collapse``   — the host-RAM KV tier is armed but the
  interval prefix hit rate collapsed under real lookup traffic (the
  offload tier stopped earning its transfers);
- ``tokens_regression``   — interval tokens/s fell below
  ``regress_ratio`` × the watchdog's own healthy-period EWMA;
- ``device_idle``         — the device ledger's ``dispatch_gap_ms``
  (retire→next-dispatch host gap) grew past ``gap_ratio`` ×
  the watchdog's own healthy-period gap EWMA — the chips are waiting on
  the host, and the heartbeat's ``dispatch_gap_*`` waterfall names the
  thief;
- ``hbm_headroom_collapse`` — sustained device-memory headroom below
  ``headroom_floor_frac`` × the ledger's peak-usage watermark (the
  workload has demonstrated it needs spikes the remaining headroom can
  no longer absorb). Armed only on heartbeats that CARRY the ``hbm_*``
  fields — the ledger omits them where the backend exposes no
  ``memory_stats`` (CPU), so the rule self-disarms there.

Each rule must breach ``sustain`` CONSECUTIVE heartbeats to fire (one
slow round never pages anyone) and must be healthy ``clear`` consecutive
heartbeats to emit ``watchdog_clear`` — the recovery-clears-alert
sequence the tests pin. The watchdog is pure host arithmetic over
dicts the loop already built: it never touches device state, so greedy
outputs are bit-identical with it armed (tested).

torch-free at import (the profiler hook loads ``torch.profiler`` only
when a window actually opens), so offline consumers — ``tools/obs_report.py``
replaying a recorded stream through :meth:`observe` — run anywhere.
"""
from __future__ import annotations

import os
import threading
from collections import deque
from dataclasses import dataclass, fields
from typing import Callable, Optional

# Kill switch ("0" disarms without touching the heartbeat stream) and the
# rule knobs, parsed by WatchdogConfig.from_env with the standard degrade
# (a malformed value falls back to the field default, never crashes a
# guest). The defaults are conservative: a breach must sustain across
# heartbeats, so one slow round or capture never dumps.
from ..constants import (
    ENV_ITL_SLO_MS,
    ENV_WATCHDOG,
    ENV_WATCHDOG_BURN as ENV_BURN_THRESHOLD,
    ENV_WATCHDOG_CLEAR as ENV_CLEAR,
    ENV_WATCHDOG_GAP_MIN_MS as ENV_GAP_MIN_MS,
    ENV_WATCHDOG_GAP_RATIO as ENV_GAP_RATIO,
    ENV_WATCHDOG_HEADROOM_FLOOR as ENV_HEADROOM_FLOOR,
    ENV_WATCHDOG_PREEMPT_STORM as ENV_PREEMPT_STORM,
    ENV_WATCHDOG_PROFILE_DIR as ENV_PROFILE_DIR,
    ENV_WATCHDOG_PROFILE_STEPS as ENV_PROFILE_STEPS,
    ENV_WATCHDOG_RECOVERY_STORM as ENV_RECOVERY_STORM,
    ENV_WATCHDOG_SUSTAIN as ENV_SUSTAIN,
    ENV_WATCHDOG_WINDOW as ENV_WINDOW,
)
from . import events, flight
from .profiler import ProfilerHook


ALERT_SLO_BURN = "slo_burn"
ALERT_PREEMPT_STORM = "preempt_storm"
ALERT_RECOVERY_STORM = "recovery_storm"
ALERT_HOST_HIT_COLLAPSE = "host_hit_collapse"
ALERT_TOKENS_REGRESSION = "tokens_regression"
ALERT_DEVICE_IDLE = "device_idle"
ALERT_HBM_HEADROOM_COLLAPSE = "hbm_headroom_collapse"
ALERT_KINDS = (
    ALERT_SLO_BURN,
    ALERT_PREEMPT_STORM,
    ALERT_RECOVERY_STORM,
    ALERT_HOST_HIT_COLLAPSE,
    ALERT_TOKENS_REGRESSION,
    ALERT_DEVICE_IDLE,
    ALERT_HBM_HEADROOM_COLLAPSE,
)


def enabled() -> bool:
    """Is the watchdog armed (``KATA_TPU_WATCHDOG`` != "0")?"""
    return os.environ.get(ENV_WATCHDOG, "1") != "0"


@dataclass
class WatchdogConfig:
    """Rule thresholds. ``slo_ms`` is the ITL budget the burn rules
    measure against — the serving loop passes its resolved scheduler SLO
    so the watchdog and the admission policy steer by ONE number; 0
    disables the burn rule (the anomaly rules still run)."""

    slo_ms: float = 0.0
    # slo_burn: fraction of the last ``window`` heartbeats whose ITL p99
    # exceeded slo_ms before the budget counts as burning.
    burn_threshold: float = 0.5
    window: int = 6
    # Consecutive breaching heartbeats before an alert fires / healthy
    # heartbeats before an active alert clears.
    sustain: int = 2
    clear: int = 2
    # Anomaly thresholds, per heartbeat interval.
    preempt_storm: int = 8
    recovery_storm: int = 3
    # host_hit_collapse: armed only while the host tier holds tokens;
    # needs at least min_lookups interval lookups to call a collapse.
    hit_floor: float = 0.2
    min_lookups: int = 8
    # tokens_regression: current interval rate under ratio × the EWMA of
    # previously observed healthy rates (alpha-weighted, min_samples
    # heartbeats of history before the rule arms).
    regress_ratio: float = 0.5
    ewma_alpha: float = 0.2
    min_samples: int = 4
    # device_idle: the heartbeat's mean retire→next-dispatch
    # gap over gap_ratio × the healthy-period gap EWMA (same
    # ewma_alpha / min_samples discipline as tokens_regression, and the
    # same fold-healthy-only rule — a sustained idle period must not
    # become the baseline mid-incident). gap_min_ms floors the breach so
    # ratios over microsecond-noise gaps never fire.
    gap_ratio: float = 3.0
    gap_min_ms: float = 1.0
    # hbm_headroom_collapse: headroom below this fraction of
    # the ledger's peak-usage watermark.
    headroom_floor_frac: float = 0.1
    # Auto-profile window: "" disables; else a torch.profiler trace spans
    # the ``profile_steps`` heartbeats after the FIRST alert.
    profile_dir: str = ""
    profile_steps: int = 2

    @classmethod
    def from_env(cls, slo_ms: Optional[float] = None) -> "WatchdogConfig":
        """Env-tuned config with the standard degrade contract (malformed
        values fall back to the field default). ``slo_ms=None`` resolves
        the serving ITL budget env directly."""
        def _f(env: str, default: float) -> float:
            raw = os.environ.get(env, "")
            try:
                return float(raw) if raw else default
            except ValueError:
                return default

        def _i(env: str, default: int) -> int:
            raw = os.environ.get(env, "")
            try:
                return int(raw) if raw else default
            except ValueError:
                return default

        if slo_ms is None:
            slo_ms = _f(ENV_ITL_SLO_MS, 0.0)
        d = cls()
        return cls(
            slo_ms=float(slo_ms),
            burn_threshold=_f(ENV_BURN_THRESHOLD, d.burn_threshold),
            window=max(1, _i(ENV_WINDOW, d.window)),
            sustain=max(1, _i(ENV_SUSTAIN, d.sustain)),
            clear=max(1, _i(ENV_CLEAR, d.clear)),
            preempt_storm=max(1, _i(ENV_PREEMPT_STORM, d.preempt_storm)),
            recovery_storm=max(1, _i(ENV_RECOVERY_STORM, d.recovery_storm)),
            profile_dir=os.environ.get(ENV_PROFILE_DIR, ""),
            profile_steps=max(1, _i(ENV_PROFILE_STEPS, d.profile_steps)),
            gap_ratio=_f(ENV_GAP_RATIO, d.gap_ratio),
            gap_min_ms=_f(ENV_GAP_MIN_MS, d.gap_min_ms),
            headroom_floor_frac=_f(ENV_HEADROOM_FLOOR,
                                   d.headroom_floor_frac),
        )

    def as_fields(self) -> dict:
        """Flat dict for the ``watchdog_alert`` event / ``stats()``."""
        return {f.name: getattr(self, f.name) for f in fields(self)}


@dataclass
class _RuleState:
    breach_streak: int = 0
    healthy_streak: int = 0
    active: bool = False
    alerts: int = 0


class SLOBurnWatchdog:
    """Consume heartbeats, fire/clear alerts, capture artifacts.

    ``emit(name, **fields)`` is the event emitter — the serving loop
    passes its ``_emit`` so alerts carry the server label and the
    allocation trace id; standalone/offline use defaults to the
    process-wide :func:`..obs.emit` under kind ``serving`` (the consumer
    vocabulary stays one namespace). ``dump`` overrides the flight-ring
    dump callable (tests); the default dumps the process recorder with
    reason ``watchdog_<kind>``, which both names the postmortem file and
    records WHY it exists."""

    def __init__(self, config: Optional[WatchdogConfig] = None, *,
                 label: str = "", trace: str = "",
                 emit: Optional[Callable[..., None]] = None,
                 dump: Optional[Callable[[str], Optional[str]]] = None):
        self.config = config or WatchdogConfig.from_env()
        self.label = label
        self._emit_fn = emit
        self._dump_fn = dump
        self._trace = trace
        # observe() runs on whatever thread feeds heartbeats (the serving
        # loop, or an offline replay) while stats()/active serve the
        # debug-dump threads — all rolling state below is guarded.
        # Alert/clear emission and the flight dump happen OUTSIDE the
        # held region (lock-held IO would stall every emitter).
        self._lock = threading.Lock()
        self._burning: deque = deque(maxlen=self.config.window)
        self._rules = {k: _RuleState() for k in ALERT_KINDS}
        self._rate_ewma: Optional[float] = None
        self._rate_samples = 0
        self._gap_ewma: Optional[float] = None
        self._gap_samples = 0
        self._observed = 0
        self._last_dump: Optional[str] = None
        self._prof: Optional[ProfilerHook] = None
        self._prof_step = 0

    # ----- plumbing --------------------------------------------------------

    def bind(self, emit: Callable[..., None]) -> None:
        """Adopt an emitter when none was injected — the serving loop
        binds its labeled/traced ``_emit`` onto an injected watchdog so
        alerts join the server's stream; a caller-supplied emitter
        wins."""
        if self._emit_fn is None:
            self._emit_fn = emit

    def _emit(self, name: str, **f) -> None:
        if self._emit_fn is not None:
            self._emit_fn(name, **f)
            return
        if self.label:
            f.setdefault("server", self.label)
        if self._trace:
            f.setdefault("trace", self._trace)
        events.emit("serving", name, **f)

    def _dump(self, kind: str) -> Optional[str]:
        if self._dump_fn is not None:
            return self._dump_fn(f"watchdog_{kind}")
        rec = flight.recorder()
        return rec.dump(f"watchdog_{kind}") if rec is not None else None

    # ----- rule evaluation -------------------------------------------------

    def _breaches(self, hb: dict) -> dict[str, str]:
        """Which rules this heartbeat breaches: ``{kind: reason}`` with
        the triggering numbers spelled out (the reason rides the alert
        event — the runbook's first look)."""
        cfg = self.config
        out: dict[str, str] = {}
        itl_p99 = float(hb.get("itl_p99_ms") or 0.0)
        if cfg.slo_ms > 0 and hb.get("interval_rounds"):
            self._burning.append(itl_p99 > cfg.slo_ms)
            if len(self._burning) >= cfg.window:
                burn = sum(self._burning) / len(self._burning)
                if burn >= cfg.burn_threshold:
                    out[ALERT_SLO_BURN] = (
                        f"burn_rate={burn:.2f} over {len(self._burning)} "
                        f"heartbeats (itl_p99={itl_p99:.1f}ms vs "
                        f"slo={cfg.slo_ms:g}ms)"
                    )
        preempts = int(hb.get("preemptions_delta") or 0)
        if preempts >= cfg.preempt_storm:
            out[ALERT_PREEMPT_STORM] = (
                f"preemptions={preempts}/heartbeat (threshold "
                f"{cfg.preempt_storm})"
            )
        recoveries = int(hb.get("recoveries_delta") or 0)
        if recoveries >= cfg.recovery_storm:
            out[ALERT_RECOVERY_STORM] = (
                f"recoveries={recoveries}/heartbeat (threshold "
                f"{cfg.recovery_storm})"
            )
        lookups = int(hb.get("prefix_hits_delta") or 0) + int(
            hb.get("prefix_misses_delta") or 0
        )
        if (int(hb.get("kv_host_tokens") or 0) > 0
                and lookups >= cfg.min_lookups):
            rate = int(hb.get("prefix_hits_delta") or 0) / lookups
            if rate < cfg.hit_floor:
                out[ALERT_HOST_HIT_COLLAPSE] = (
                    f"hit_rate={rate:.2f} over {lookups} lookups (floor "
                    f"{cfg.hit_floor:g}, host tier armed)"
                )
        rate = float(hb.get("tokens_per_s") or 0.0)
        if int(hb.get("interval_rounds") or 0) > 0 and rate > 0:
            if (self._rate_samples >= cfg.min_samples
                    and self._rate_ewma
                    and rate < cfg.regress_ratio * self._rate_ewma):
                out[ALERT_TOKENS_REGRESSION] = (
                    f"tokens_per_s={rate:.1f} under "
                    f"{cfg.regress_ratio:g}x ewma={self._rate_ewma:.1f}"
                )
            else:
                # Fold only NON-regressing samples into the baseline: a
                # sustained slump must not drag the EWMA down until the
                # regression reads as the new normal mid-incident.
                self._rate_ewma = (
                    rate if self._rate_ewma is None
                    else self._rate_ewma
                    + cfg.ewma_alpha * (rate - self._rate_ewma)
                )
                self._rate_samples += 1
        # device_idle: heartbeats without the ledger's gap
        # fields (kill switch, pre-ledger streams) leave the rule — and
        # its baseline — untouched; intervals with no dispatches carry
        # no gap signal either.
        gap_v = hb.get("dispatch_gap_ms")
        if gap_v is not None and int(hb.get("dispatches_delta") or 0) > 0:
            gap = float(gap_v)
            if (self._gap_samples >= cfg.min_samples
                    and self._gap_ewma is not None
                    and gap >= cfg.gap_min_ms
                    and gap > cfg.gap_ratio * self._gap_ewma):
                out[ALERT_DEVICE_IDLE] = (
                    f"dispatch_gap_ms={gap:.2f} over {cfg.gap_ratio:g}x "
                    f"ewma={self._gap_ewma:.2f}ms (floor "
                    f"{cfg.gap_min_ms:g}ms)"
                )
            else:
                # Same fold-healthy-only rule as tokens_regression: a
                # sustained idle period must not become the baseline.
                self._gap_ewma = (
                    gap if self._gap_ewma is None
                    else self._gap_ewma
                    + cfg.ewma_alpha * (gap - self._gap_ewma)
                )
                self._gap_samples += 1
        # hbm_headroom_collapse: armed only when the ledger
        # supplied the memory fields — they degrade by OMISSION on
        # backends without memory_stats, so absence self-disarms.
        headroom = hb.get("hbm_headroom_bytes")
        peak = hb.get("hbm_peak_bytes")
        if headroom is not None and peak is not None and float(peak) > 0:
            floor = cfg.headroom_floor_frac * float(peak)
            if float(headroom) < floor:
                out[ALERT_HBM_HEADROOM_COLLAPSE] = (
                    f"headroom={int(headroom)}B under floor={int(floor)}B "
                    f"({cfg.headroom_floor_frac:g} x peak="
                    f"{int(float(peak))}B watermark)"
                )
        return out

    # ----- the consumer API ------------------------------------------------

    def observe(self, hb: dict) -> list[str]:
        """Feed one heartbeat; returns the alert kinds that FIRED on this
        observation (usually empty). Never raises — the watchdog is
        telemetry and must not add a failure mode to the serving loop.

        The rolling windows and rule streaks update under the lock; the
        fire/clear decisions collected there turn into events and flight
        dumps AFTER it is released."""
        fired: list[tuple[str, str]] = []
        cleared: list[tuple[str, int]] = []
        with self._lock:
            self._observed += 1
            try:
                breaches = self._breaches(hb)
            except Exception:
                return []
            for kind in ALERT_KINDS:
                st = self._rules[kind]
                if kind in breaches:
                    st.breach_streak += 1
                    st.healthy_streak = 0
                    if (not st.active
                            and st.breach_streak >= self.config.sustain):
                        st.active = True
                        st.alerts += 1
                        fired.append((kind, breaches[kind]))
                else:
                    st.healthy_streak += 1
                    st.breach_streak = 0
                    if st.active and st.healthy_streak >= self.config.clear:
                        st.active = False
                        cleared.append((kind, st.healthy_streak))
        for kind, reason in fired:
            self._fire(kind, reason, hb)
        for kind, healthy in cleared:
            self._emit(
                "watchdog_clear", alert=kind,
                healthy_heartbeats=healthy,
                round=hb.get("round"),
            )
        # Advance an open profiler window one heartbeat; the hook stops
        # itself (and emits profile/torch_trace) at the window end.
        with self._lock:
            prof = self._prof
            if prof is not None:
                self._prof_step += 1
                step = self._prof_step
        if prof is not None:
            try:
                prof.on_step(step)
            except Exception:
                with self._lock:
                    self._prof = None  # profiling must never hurt serving
        return [kind for kind, _reason in fired]

    def _fire(self, kind: str, reason: str, hb: dict) -> None:
        dump_path = None
        try:
            dump_path = self._dump(kind)
        except Exception:
            pass
        with self._lock:
            self._last_dump = dump_path or self._last_dump
            want_prof = bool(self.config.profile_dir) and self._prof is None
        self._emit(
            "watchdog_alert", alert=kind, reason=reason,
            round=hb.get("round"), dump=dump_path or "",
            tokens_per_s=hb.get("tokens_per_s"),
            itl_p99_ms=hb.get("itl_p99_ms"),
            slo_ms=self.config.slo_ms,
        )
        if want_prof:
            # One bounded window per watchdog lifetime, opened at the
            # FIRST alert: the next profile_steps heartbeats of device
            # time land in the trace. (ProfilerHook._done keeps a
            # later alert from re-opening it.)
            prof = ProfilerHook(
                self.config.profile_dir, start_step=1,
                num_steps=self.config.profile_steps,
            )
            try:
                prof.on_step(0)  # opens the window now
            except Exception:
                prof = None
            if prof is not None:
                with self._lock:
                    self._prof = prof
                    self._prof_step = 0

    # ----- introspection / lifecycle ---------------------------------------

    @property
    def active(self) -> tuple[str, ...]:
        with self._lock:
            return tuple(k for k in ALERT_KINDS if self._rules[k].active)

    def stats(self) -> dict:
        """Always-present aggregate for ``GenerationServer.stats()``;
        reads the rolling state under the lock — this runs on the
        debug-dump thread mid-serving."""
        with self._lock:
            return {
                "alerts": sum(st.alerts for st in self._rules.values()),
                "active": [
                    k for k in ALERT_KINDS if self._rules[k].active
                ],
                "observed": self._observed,
                "last_dump": self._last_dump or "",
            }

    def close(self) -> None:
        """Stop an open profiler window (idempotent); the serving loop
        calls this when the server idles out so an alert near the end of
        a run can never leave ``torch.profiler`` running."""
        with self._lock:
            prof = self._prof
            self._prof = None
        if prof is not None:
            try:
                prof.stop()
            except Exception:
                pass
