"""Admission scheduling: the policy objects of
``kata_xpu_device_plugin_tpu/guest/scheduler.py``, copied.

A policy decides WHEN admission prefill runs and in what slices, never
what the forwards compute, so greedy outputs do not depend on it.

- :class:`Scheduler` (``fifo_batch``): every admission pass admits the
  FIFO prefix of the queue that fits the free lanes, grouped so that one
  prefill forward serves each group (``GenerationServer._admit``).
- :class:`SLOChunkedScheduler` (``slo_chunked``): when requests are
  decoding and the projected per-token latency of running the pending
  admission whole exceeds the deadline, the admission is sliced into
  ``chunk_tokens``-token chunks (``models.transformer.prefill_suffix``
  resumes each at its offset), and the serving loop runs at most one
  chunk per decode dispatch, or, with ``fused``, lets the chunk ride the
  decode dispatch. With nobody decoding, or no estimate yet, admission
  runs whole. A chunked admission is head-of-line: nothing admits past
  it while its chunks run, so FIFO holds.

The estimates are host floats (exponentially weighted averages of the
prefill cost per token and of the decode cadence per delivered token);
``slo_ms`` is in the unit of the server's ``decode_token_s`` metric.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..obs.metrics import Rolling

POLICY_FIFO = "fifo_batch"
POLICY_SLO = "slo_chunked"
POLICIES = (POLICY_FIFO, POLICY_SLO)

# A chunk should be several decode chunks' worth of work, small against a
# production prompt; 128 splits a 1k-token prompt into 8 slices.
DEFAULT_PREFILL_CHUNK = 128
# Interactive serving's common budget: ~20 tok/s perceived streaming rate.
DEFAULT_ITL_SLO_MS = 50.0

# Weight of a new observation in the estimates: converges within a few
# observations, and one outlier round does not flip a decision.
_EWMA_ALPHA = 0.3


@dataclass(frozen=True)
class Directive:
    """One admission decision. ``admit=True``: run the whole admission
    pass. ``admit=False``: advance the pending admission by one prefill
    chunk, then give the round back to decode (``defer_reason`` and
    ``projected_itl_ms`` say why). ``fused=True`` (set only on a deferral
    by a fused ``slo_chunked`` policy): the chunk rides the next decode
    dispatch instead of running on its own."""

    admit: bool
    defer_reason: str = ""
    projected_itl_ms: float = 0.0
    fused: bool = False


class Scheduler:
    """The ``fifo_batch`` policy, and the base of every policy: admit
    everything, every pass. Owns what every policy shares: the prefill-rate
    and per-token-cadence estimates, the chunk/defer/violation counters of
    ``stats()``, and the queue-delay summary (submit to admission)."""

    name = POLICY_FIFO

    def __init__(self, *, chunk_tokens: int = 0, slo_ms: float = 0.0,
                 decode_steps: int = 1, fused: bool = False):
        self.chunk_tokens = int(chunk_tokens)
        self.slo_ms = float(slo_ms)
        # The server's steps per dispatch: the default divisor that turns a
        # round's duration into a per-token one; note_round learns the
        # steps each round actually delivered.
        self.decode_steps = max(1, int(decode_steps))
        self.fused = bool(fused)
        self.chunks = 0          # chunk forwards run
        self.defers = 0          # passes that deferred admission to decode
        self.slo_violations = 0  # rounds over the deadline
        self.queue_delay = Rolling()
        self._prefill_s_per_tok: Optional[float] = None
        self._tok_s: Optional[float] = None
        self._last_steps: int = self.decode_steps

    # ----- observations (the serving loop feeds these) ---------------------

    def note_prefill(self, tokens: int, dur_s: float) -> None:
        """One prefill forward of ``tokens`` padded tokens took ``dur_s``:
        fold its per-token cost into the rate estimate (chunk forwards
        count too)."""
        if tokens <= 0 or dur_s <= 0:
            return
        per_tok = dur_s / tokens
        if self._prefill_s_per_tok is None:
            self._prefill_s_per_tok = per_tok
        else:
            self._prefill_s_per_tok += _EWMA_ALPHA * (
                per_tok - self._prefill_s_per_tok)

    def note_round(self, dur_s: float, steps: int = 0) -> bool:
        """One decode round retired after ``dur_s``, delivering ``steps``
        tokens per live lane (0: the configured ``decode_steps``). Folds
        the per-token cadence into its estimate; True when the round broke
        the policy's deadline (the base policy has none)."""
        if dur_s <= 0:
            return False
        steps = max(1, int(steps) if steps else self.decode_steps)
        self._last_steps = steps
        per_tok = dur_s / steps
        if self._tok_s is None:
            self._tok_s = per_tok
        else:
            self._tok_s += _EWMA_ALPHA * (per_tok - self._tok_s)
        return self._check_slo(per_tok)

    def note_queue_delay(self, delay_s: float) -> None:
        """A request left the queue: record its submit-to-admission wait."""
        self.queue_delay.observe(max(0.0, float(delay_s)))

    def reset_estimates(self) -> None:
        """Drop both estimates: measured under another dispatch regime,
        they would misproject the next admissions."""
        self._prefill_s_per_tok = None
        self._tok_s = None
        self._last_steps = self.decode_steps

    def note_config(self, *, decode_steps: Optional[int] = None,
                    fused: Optional[bool] = None) -> bool:
        """Adopt a changed dispatch configuration; when the steps per
        dispatch or the fused flag changed, the estimates are reset.
        Returns whether anything changed."""
        changed = False
        if decode_steps is not None and max(1, int(decode_steps)) != (
                self.decode_steps):
            self.decode_steps = max(1, int(decode_steps))
            changed = True
        if fused is not None and bool(fused) != self.fused:
            self.fused = bool(fused)
            changed = True
        if changed:
            self.reset_estimates()
        return changed

    def _check_slo(self, per_tok_s: float) -> bool:
        return False

    # ----- the decision ----------------------------------------------------

    def directive(self, *, live_lanes: int, pending_tokens: int,
                  partial: bool = False) -> Directive:
        """The admission decision of one pass. ``live_lanes``: requests
        decoding now; ``pending_tokens``: the prefill tokens the pending
        admission still needs; ``partial``: a chunked admission is already
        in progress (the choice is then to finish it or run one more
        chunk, never to skip it)."""
        return Directive(admit=True)

    # ----- introspection ---------------------------------------------------

    def projected_itl_s(self, pending_tokens: int) -> Optional[float]:
        """The per-token latency live requests would see if
        ``pending_tokens`` of prefill ran as one forward now: the
        estimated prefill time over the steps one dispatch delivers, plus
        the per-token cadence. None until both estimates exist."""
        if self._prefill_s_per_tok is None or self._tok_s is None:
            return None
        steps = max(1, self._last_steps)
        return pending_tokens * self._prefill_s_per_tok / steps + self._tok_s

    def stats(self) -> dict:
        """The scheduler's fields of ``GenerationServer.stats()`` (zeros
        under ``fifo_batch``), under the JAX server's names."""
        return {
            "sched_policy": self.name,
            "sched_chunks": self.chunks,
            "sched_defers": self.defers,
            "slo_violations": self.slo_violations,
            "prefill_chunk_tokens": self.chunk_tokens,
            "itl_slo_ms": self.slo_ms,
            "sched_queue_delay_s": self.queue_delay.summary(),
        }

    def heartbeat_fields(self) -> dict:
        """The scheduler's fields of the serving heartbeat: the admission
        wait's quantiles in ms (the chunk, defer and violation deltas come
        from the counters above)."""
        q = self.queue_delay.summary()
        return {
            "admission_wait_p50_ms": round(q.get("p50", 0.0) * 1e3, 3),
            "admission_wait_p99_ms": round(q.get("p99", 0.0) * 1e3, 3),
        }


class SLOChunkedScheduler(Scheduler):
    """``slo_chunked``: chunk the pending admission whenever running it
    whole would push the projected per-token latency past ``slo_ms`` and
    somebody is decoding to feel it (module doc)."""

    name = POLICY_SLO

    def __init__(self, *, chunk_tokens: int = DEFAULT_PREFILL_CHUNK,
                 slo_ms: float = DEFAULT_ITL_SLO_MS, decode_steps: int = 1,
                 fused: bool = False):
        if chunk_tokens < 1:
            raise ValueError(
                f"prefill chunk must be >= 1 token, got {chunk_tokens}")
        super().__init__(chunk_tokens=chunk_tokens, slo_ms=slo_ms,
                         decode_steps=decode_steps, fused=fused)

    def _check_slo(self, per_tok_s: float) -> bool:
        if per_tok_s * 1000.0 > self.slo_ms:
            self.slo_violations += 1
            return True
        return False

    def directive(self, *, live_lanes: int, pending_tokens: int,
                  partial: bool = False) -> Directive:
        if live_lanes == 0:
            # Nobody decoding: no latency to protect, and chunking would
            # only delay this request's first token.
            return Directive(admit=True)
        if not partial and pending_tokens <= self.chunk_tokens:
            # One chunk's worth: slicing cannot shrink the stall.
            return Directive(admit=True)
        proj = self.projected_itl_s(pending_tokens)
        if proj is None:
            # No estimates yet: the first admission and round measure them.
            return Directive(admit=True)
        proj_ms = proj * 1000.0
        if proj_ms <= self.slo_ms:
            return Directive(admit=True)
        return Directive(admit=False, defer_reason="projected_itl",
                         projected_itl_ms=round(proj_ms, 3), fused=self.fused)


def make_scheduler(policy: str, *, chunk_tokens: int, slo_ms: float,
                   decode_steps: int = 1, fused: bool = False) -> Scheduler:
    """The policy named ``policy``. An unknown name raises ``ValueError``:
    the caller owns the rule that an env value degrades and an explicit
    argument raises."""
    if policy == POLICY_FIFO:
        return Scheduler(decode_steps=decode_steps)
    if policy == POLICY_SLO:
        return SLOChunkedScheduler(chunk_tokens=chunk_tokens, slo_ms=slo_ms,
                                   decode_steps=decode_steps, fused=fused)
    raise ValueError(f"unknown scheduler policy {policy!r} (have {POLICIES})")
