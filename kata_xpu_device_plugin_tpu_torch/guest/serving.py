"""Continuous-batching generation server (counterpart of
``GenerationServer`` in ``kata_xpu_device_plugin_tpu/guest/serving.py``).

Two arena models are ported, both decoding greedily or by sampling
(``temperature``, ``top_k``, ``top_p`` from a generator seeded with
``seed``) in dispatches of ``chunk × decode_steps`` steps, with batched
admission through ``prefill_batch``:

- **slotted** (the default): one KV arena ``[L, max_batch, max_len, KV,
  D]`` (int8 by default); a request owns a whole slot.
- **paged** (``kv_pool_tokens``): one block pool
  (:class:`.kv_arena.KVPool`) shared by every lane through per-lane block
  tables. Admission reserves blocks for the padded prompt, tables grow one
  dispatch window ahead of decode, and under pool pressure the youngest
  lane is preempted: its written rows spill to the host and re-land
  verbatim when the pool drains, so greedy outputs do not change.

Two round loops, as in the JAX server:

- **overlapped** (``overlap=True``, the default): the next chunk is
  dispatched from the in-flight chunk's ``last``/``pos`` on the device,
  with the rows admission refilled since merged in from the host, and only
  then is the in-flight chunk retired through its
  :class:`..obs.trace.DeviceFence`; finish detection and admission run
  while the card computes. Tokens the in-flight chunk decoded for a lane
  that finished, or was preempted, meanwhile are dropped at retire.
- **lock-step** (``overlap=False``): admit, dispatch, wait for the tokens.

``decode_steps=K`` (argument, else ``KATA_TPU_DECODE_STEPS``) makes one
dispatch ``chunk × K`` steps, with every lane frozen on the device once it
has its budget or emits ``eos_id``. Greedy outputs do not depend on the
loop or on K.

Admission scheduling (``guest/scheduler.py``): ``sched_policy=
"slo_chunked"`` slices an admission into ``prefill_chunk``-token
``prefill_suffix`` chunks while requests decode and the projected
per-token latency of a whole prefill exceeds ``itl_slo_ms``; at most one
chunk runs per decode dispatch, and with ``fused`` (on by default under
``slo_chunked``) the chunk rides the decode dispatch itself. With
``persistent=True`` (greedy only) each round decodes on the card until a
cap, a lane's freeze, or a live lane's reserved window edge
(:class:`.decode_graph.PersistentRound`), and rounds run lock-step.
Neither changes greedy outputs.

The shared-prefix KV cache (``prefix_cache_tokens``, else
``KATA_TPU_PREFIX_CACHE_TOKENS``; or an injected ``prefix_store``): an
admission looks its prompt up in a radix index of cached bucket-aligned
prefixes, and a hit copies the prefix rows and prefills only the suffix
(``prefill_suffix``), batched across hits on one segment. Slotted, the
cache is a :class:`.prefix_cache.PrefixStore` of its own; paged, it is a
:class:`.kv_arena.PagedPrefixTier` inside the pool whose fully covered
blocks a hit's table shares (its boundary block copied on write).
``kv_host_tokens`` (else ``KATA_TPU_KV_HOST_TOKENS``; paged only) adds a
host-RAM tier below the pool: pool pressure demotes unpinned prefix
segments there before any lane is preempted, a hit on one promotes it
back, preemption spills are accounted there, and the oldest preempted
request's rows are uploaded on a side stream while a chunk decodes, so
its resume lands them without waiting. None of this changes greedy
outputs.

On CUDA every whole prefill runs the flash kernel and every decode step
the paged decode kernel: over the pool through the lanes' real block
tables, or over a zero-copy pool view of the slotted arena
(:func:`..ops.attention.make_decode_attn_fn`); each decode chunk after the
first is one CUDA graph replay (:class:`.decode_graph.DecodeGraph`), its
random draws included. A chunk slice reads the cache back, so by the JAX
rule it takes the plain attention. As in the JAX server, a config with a
sliding window or an attention-logit softcap, masks the kernel does not
model, decodes with the plain attention and says why in ``stats()``;
otherwise the plain versions run on the card only when the caller asks for
``decode_attn="reference"``, and anything the kernels cannot take raises.
On the CPU the wrappers run their plain versions and chunks run eagerly.
Greedy outputs per request equal the JAX server's on the same weights, as
do the round, admission, chunk and persistent-exit counts under the same
settings; sampled outputs repeat under one seed.

Tensor-parallel serving (``tp``, else ``KATA_TPU_TP`` and the topology
env, :mod:`.tp_serving`): the server splits its parameters into ``tp``
shards by the serving rules and runs every forward across them,
column-parallel q/k/v and gate/up, row-parallel ``wo`` and ``w_down`` each
followed by the sum across shards, every shard attending with its own
query heads. ``kv_layout`` picks the placement of the KV state: ``"heads"``
splits the KV heads where they divide ``tp`` (else every shard reads every
KV head), ``"blocks"`` (paged only) splits the pool into per-shard
sub-pools of whole blocks, and decode attention then runs the shard-local
paged kernel on each shard and merges the shards' softmax statistics.
Every shard lives on the server's one device (a port-only difference:
JAX places them on distinct chips); greedy outputs equal ``tp=1``'s.

Telemetry, as in the JAX server: every event goes through :meth:`_emit`
(kind ``serving``, the server's label and the allocation trace id of
``KATA_TPU_TRACE_CTX``), with the JAX server's names and fields, into the
default sink (``KATATPU_OBS``) and the flight ring. Admission forwards run
in ``serving.prefill*`` spans; each decode chunk is a
``serving.decode_chunk`` span (detached under overlap, ended at its
retire). Every request keeps a lifecycle ledger (queue, prefill, decode,
preempted) and emits one ``request_trace`` at its end. Every
``heartbeat_rounds`` rounds (``KATA_TPU_HEARTBEAT_ROUNDS``, default 32; 0
disables) one ``serving_heartbeat`` rolls up the interval: tokens/s,
latency quantiles, occupancy, tier traffic, the loop's phase times, and
the device ledger's ``mfu``, ``device_busy_frac``, dispatch gaps and
memory (:class:`..obs.devledger.DeviceLedger`); the SLO-burn watchdog
(:class:`..obs.watchdog.SLOBurnWatchdog`) reads each heartbeat. Every
``run()`` after the first counts the tripwire's compiles and reshards
(:mod:`..compat.torchapi`), and ``strict`` guards the overlapped round
against host synchronization with the card. None of it changes greedy
tokens; :meth:`export_metrics` exposes the JAX server's metric families.

Crash tolerance, as in the JAX server: :meth:`GenerationServer.step` is
supervised. A fault :func:`.resilience.classify` calls TRANSIENT (an
injected fault at one of the seams the JAX server crosses, as often for
the same requests, a watchdog stall of a fence, a CUDA out-of-memory
error) resets the device state IN PLACE (the pool's free list and tables,
the arena zeroed: the decode graph keeps its addresses, so no new
capture), then every implicated request is restored from the last host
checkpoint (``checkpoint_rounds``) or replays from its prompt, strict
FIFO, and ``quarantine_after`` consecutive implicated faults fail a
request on its own. A PERMANENT fault that names a shard (an injected
``chip_loss`` or ``ici_error``) shrinks a tensor-parallel server's degree
(:func:`.tp_serving.shrink_ladder`): the parameters are re-split from the
host donor copy and the decode graph is built anew; with no rung left,
or after a real PERMANENT CUDA error, which takes the one card, every
unfinished request fails loudly (``chip_lost``). Neither moves decode off
its backend. Anything else propagates after a ``fatal_error`` event.
Recovered greedy outputs equal fault-free ones.

Speculative decoding, as in the JAX server (``speculative_k=k``, armed by
``spec_opt_in=True`` or ``KATA_TPU_SPEC=1``, else it degrades to plain
decoding with a ``spec_disabled`` event): each round drafts ``k`` tokens a
lane, from the lane's own history (n-gram) or from a draft model
(``draft=(draft_params, draft_cfg)``, with an arena of its own at the
lanes' positions), verifies them in one ``[max_batch, k+1]`` forward
(:mod:`..models.speculative`) and accepts the longest prefix the target's
greedy choices reproduce, or, sampling, by the rejection scheme on the
device. Greedy tokens equal the plain server's. Rounds run lock-step, and
verify spans and the draft's decode take the plain attention (a span at an
offset takes no kernel, the JAX rule). ``stats()["draft_acceptance"]`` is
the accepted share of the drafts offered.

``ring_kv=True`` (a config with a sliding window) makes the slotted arena
a ring of ``window`` slots a lane (position p at slot ``p % window``), or,
with a window cycle (Gemma-2, Gemma-3), the cycle arena: rings for the
local layers, ``max_len`` for the global ones
(:func:`..models.transformer.init_cycle_kv_caches`). Under speculation
each ring carries ``speculative_k`` margin slots, so that a verify span
never evicts a key a live window still sees. Admission prefills into a
prompt-length cache and folds it into the lane's ring rows. Ring reads take
the plain attention (the kernels take no slot positions), in the
overlapped loop's decode graph too, where the slots and their positions
are computed on the card from the lanes' positions. Ring and speculative
servers admit one request a prefill, as the JAX server does, and refuse
(or, from the environment, degrade away from) the paged pool, the prefix
cache (ring and draft servers), chunked admission, ``decode_steps > 1``,
persistent rounds and ``tp > 1``; speculative servers refuse host
checkpoints.

A caller's training mesh (``mesh=``, a :func:`..parallel.mesh.build_mesh`
of data, fsdp and model axes; not with ``tp=``) serves a model straight
from its training layout: the params are the ``PARAM_RULES`` pieces
(:func:`..parallel.sharding.shard_params`; a tree already so placed, such
as :func:`..parallel.sharding.init_sharded_params`' or a sharded
checkpoint's, is taken as it is), the degree is the mesh's ``model`` size
and each layer gathers its weights over fsdp when it runs
(:meth:`.tp_serving.ServingMesh.layer_source`). The ``tp=`` path's
refusals (ring, speculation) do not apply, a draft is placed on the same
mesh, and a permanent fault fails the load (``why="mesh_injected"``): the
caller owns the layout, so it never shrinks.
"""
from __future__ import annotations

import itertools
import os
import time
from collections import deque
from dataclasses import dataclass, field
from functools import partial
from typing import Any, Optional

import numpy as np
import torch

from .. import obs, resolve_device
from ..compat import torchapi
from ..constants import (
    DEFAULT_HEARTBEAT_ROUNDS,
    DEFAULT_KV_QUANT,
    ENV_CHECKPOINT_ROUNDS,
    ENV_DECODE_ATTN,
    ENV_DECODE_STEPS,
    ENV_FENCE_TIMEOUT,
    ENV_FUSED,
    ENV_HEARTBEAT_ROUNDS,
    ENV_ITL_SLO_MS,
    ENV_KV_HOST_TOKENS,
    ENV_KV_LAYOUT,
    ENV_KV_POOL_TOKENS,
    ENV_KV_QUANT,
    ENV_PERSISTENT,
    ENV_PREFILL_CHUNK,
    ENV_PREFIX_CACHE_TOKENS,
    ENV_QUARANTINE_K,
    ENV_RECOVERY,
    ENV_RECOVERY_BACKOFF_S,
    ENV_SCHED_POLICY,
    ENV_SPEC_OPT_IN,
    ENV_TRACE_CTX,
)
from ..models.transformer import (
    DecoderConfig,
    _next_token,
    _sampling_args,
    check_supported,
    fold_prefill,
    init_cycle_kv_caches,
    init_kv_caches,
    prefill_batch,
    prefill_suffix,
    tp_serving_params,
)
from ..obs.metrics import Rolling
from ..obs.trace import DeviceFence
from ..ops import attention
from ..ops.quant import QTensor
from . import resilience, tp_serving
from .decode_graph import DecodeGraph, PersistentRound, Sampling, serve_decode
from .kv_arena import (
    RESERVED_BLOCKS,
    SCRATCH_BLOCK,
    HostKVTier,
    KVPool,
    PagedPrefixTier,
    map_rows,
    pool_gather_rows,
    pool_scatter_rows,
    pool_write_batch,
    pool_write_seq,
    rows_to_device,
    rows_to_host,
    table_tensor,
)
from .prefix_cache import PrefixHit, PrefixStore, cache_bytes, cache_leaves
from .resilience import ChipLossFault, DeviceStallError, FaultInjector, IciFault
from .scheduler import (
    DEFAULT_ITL_SLO_MS,
    DEFAULT_PREFILL_CHUNK,
    POLICIES,
    POLICY_FIFO,
    POLICY_SLO,
    make_scheduler,
)
from .tp_serving import KV_LAYOUT_BLOCKS, KV_LAYOUT_HEADS, KV_LAYOUTS, ServingMesh
from ..parallel.mesh import AXIS_MODEL
from ..parallel.sharding import Sharded, leaves

BACKEND_PAGED = attention.BACKEND_PAGED
BACKEND_REFERENCE = attention.BACKEND_REFERENCE

PERSISTENT_EXITS = ("cap", "done", "window")


def require_flash_buckets(buckets: tuple, head_dim: int) -> None:
    """On CUDA each prompt is padded to a prefill bucket and its prefill
    runs the flash kernel: raise unless there are buckets and the kernel
    takes every one of them."""
    if not buckets:
        raise ValueError(
            "a CUDA server needs prefill_buckets: prompts are padded to them "
            "so that every prefill runs the flash kernel")
    bad = [b for b in buckets
           if not attention.flash_eligible(b, b, head_dim, on_cuda=True)]
    if bad:
        raise ValueError(
            f"prefill_buckets {bad} are not flash-kernel lengths at head_dim "
            f"{head_dim} (need a divisor >= 128 that is a multiple of 32)")


def _no_emit(name: str, **fields) -> None:
    """The emitter of a resolution made outside a server: no event."""


def _env_int(name: str, default: int, emit=_no_emit, event: str = "") -> int:
    """An integer env knob; unset gives ``default``, and so does a
    malformed value, with one ``event`` (reason ``bad_env:<raw>``)."""
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        if event:
            emit(event, reason=f"bad_env:{raw[:32]}")
        return default


def _resolve_tokens(value: Optional[int], env: str, emit=_no_emit,
                    event: str = "", negative_event: bool = False
                    ) -> tuple[int, bool]:
    """A token-count knob: ``(tokens, explicit)``, the argument when given,
    else the env value, which degrades to 0 when malformed (with ``event``)
    or negative (with ``event`` too when ``negative_event``)."""
    if value is not None:
        return int(value), True
    n = _env_int(env, 0, emit, event)
    if n < 0 and negative_event:
        emit(event, reason=f"bad_env:{n}")
    return max(n, 0), False


def _env_flag(name: str, emit=_no_emit, event: str = "") -> Optional[bool]:
    """A ``"0"``/``"1"`` env knob: its value, or None when unset or
    malformed (which degrades to the knob's default, with ``event``)."""
    raw = os.environ.get(name, "").strip()
    if raw and raw not in ("0", "1"):
        emit(event, reason=f"bad_env:{raw[:32]}")
    return {"0": False, "1": True}.get(raw)


def resolve_kv_layout(kv_layout: Optional[str],
                      emit=_no_emit) -> tuple[str, bool]:
    """``(layout, explicit)``: an explicit unknown layout raises; an
    unknown ``KATA_TPU_KV_LAYOUT`` degrades to ``"heads"`` with a
    ``kv_layout_invalid`` event."""
    if kv_layout is not None:
        if kv_layout not in KV_LAYOUTS:
            raise ValueError(f"unknown kv_layout {kv_layout!r} (have {KV_LAYOUTS})")
        return kv_layout, True
    raw = os.environ.get(ENV_KV_LAYOUT, "").strip()
    if raw and raw not in KV_LAYOUTS:
        emit("kv_layout_invalid", reason=f"bad_env:{raw[:32]}")
    return (raw if raw in KV_LAYOUTS else KV_LAYOUT_HEADS), False


def tp_conflict(cfg: DecoderConfig, tp: int, ring_kv: bool,
                speculative: bool) -> Optional[str]:
    """Why this server cannot serve at degree ``tp``, or None: the JAX
    server's reasons (ring caches and speculation re-layout or add caches
    the serving rules do not cover), and this package's own, a split the
    shards cannot take (every shard holds whole query heads and an equal
    share of the KV features and of the MLP)."""
    if tp <= 1:
        return None
    if ring_kv:
        return "ring_kv"
    if speculative:
        return "speculative"
    for name, n in (("n_heads", cfg.n_heads), ("kv_dim", cfg.kv_dim),
                    ("d_ff", cfg.d_ff)):
        if n % tp:
            return f"indivisible:{name}={n}"
    return None


def resolve_tp(tp: Optional[int], cfg: DecoderConfig, ring_kv: bool = False,
               speculative: bool = False, emit=_no_emit, label: str = "",
               trace: str = "") -> int:
    """The serving degree: an explicit ``tp`` (< 1 or in
    :func:`tp_conflict` raises; more shards than devices share the one
    device), else :func:`.tp_serving.tp_from_env`, which degrades to 1 on
    a conflict with a ``tp_disabled`` event."""
    if tp is not None:
        tp = int(tp)
        if tp < 1:
            raise ValueError(f"tp must be >= 1, got {tp}")
        reason = tp_conflict(cfg, tp, ring_kv, speculative)
        if reason is not None:
            raise ValueError(f"tp={tp} is incompatible with this server "
                             f"({reason})")
        return tp
    if ring_kv or speculative:
        # Named before the devices are counted: the JAX server's order of
        # reasons.
        tp = tp_serving.env_degree(label=label, trace=trace)
    else:
        tp = tp_serving.tp_from_env(label=label, trace=trace)
    reason = tp_conflict(cfg, tp, ring_kv, speculative)
    if reason is not None:
        emit("tp_disabled", reason=reason, tp=tp)
        return 1
    return tp


def resolve_kv_quant(kv_quant, emit=_no_emit) -> bool:
    """Explicit argument > ``KATA_TPU_KV_QUANT`` ("int8" | "bf16") > int8.
    A malformed env value degrades to the default with one
    ``kv_quant_invalid`` event."""
    if kv_quant is not None:
        return bool(kv_quant)
    raw = os.environ.get(ENV_KV_QUANT, "").strip().lower()
    if raw and raw not in ("int8", "bf16"):
        emit("kv_quant_invalid", reason=f"bad_env:{raw[:32]}")
    if raw not in ("int8", "bf16"):
        raw = DEFAULT_KV_QUANT
    return raw == "int8"


def resolve_decode_steps(decode_steps: Optional[int], emit=_no_emit) -> int:
    """K, the decode chunks one dispatch runs: explicit argument >
    ``KATA_TPU_DECODE_STEPS`` > 1. An explicit value < 1 raises; a
    malformed or < 1 env value degrades to 1 with a
    ``decode_steps_invalid`` event."""
    if decode_steps is not None:
        if int(decode_steps) < 1:
            raise ValueError(f"decode_steps must be >= 1, got {decode_steps}")
        return int(decode_steps)
    k = _env_int(ENV_DECODE_STEPS, 1, emit, "decode_steps_invalid")
    if k < 1:
        emit("decode_steps_invalid", reason=f"bad_env:{k}")
        k = 1
    return k


def resolve_sched(sched_policy: Optional[str], prefill_chunk: Optional[int],
                  itl_slo_ms: Optional[float],
                  emit=_no_emit) -> tuple[str, int, float]:
    """``(policy, chunk tokens, slo ms)``, the JAX server's rules: an
    explicit unknown policy or a ``prefill_chunk`` < 1 raises; an unknown
    ``KATA_TPU_SCHED_POLICY`` degrades to ``fifo_batch``
    (``sched_disabled``), a malformed or < 1 ``KATA_TPU_PREFILL_CHUNK`` to
    128 (``prefill_chunk_invalid``) and a malformed ``KATA_TPU_ITL_SLO_MS``
    to 50 (``itl_slo_invalid``)."""
    if sched_policy is None:
        raw = os.environ.get(ENV_SCHED_POLICY, "").strip()
        sched_policy = raw or POLICY_FIFO
        if sched_policy not in POLICIES:
            emit("sched_disabled", reason=f"bad_env:{raw[:32]}")
            sched_policy = POLICY_FIFO
    elif sched_policy not in POLICIES:
        raise ValueError(
            f"unknown sched_policy {sched_policy!r} (have {POLICIES})")
    if prefill_chunk is not None:
        if int(prefill_chunk) < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1 token, got {prefill_chunk}")
        chunk_tokens = int(prefill_chunk)
    else:
        chunk_tokens = _env_int(ENV_PREFILL_CHUNK, DEFAULT_PREFILL_CHUNK, emit,
                                "prefill_chunk_invalid")
        if chunk_tokens < 1:
            emit("prefill_chunk_invalid", reason=f"bad_env:{chunk_tokens}")
            chunk_tokens = DEFAULT_PREFILL_CHUNK
    if itl_slo_ms is not None:
        slo_ms = float(itl_slo_ms)
    else:
        raw = os.environ.get(ENV_ITL_SLO_MS, "")
        try:
            slo_ms = float(raw) if raw else DEFAULT_ITL_SLO_MS
        except ValueError:
            emit("itl_slo_invalid", reason=f"bad_env:{raw[:32]}")
            slo_ms = DEFAULT_ITL_SLO_MS
    return sched_policy, chunk_tokens, slo_ms


def resolve_fused(fused: Optional[bool], sched_policy: str,
                  emit=_no_emit) -> bool:
    """Whether chunk slices ride decode dispatches: on under
    ``slo_chunked`` unless ``KATA_TPU_FUSED=0`` (a malformed value
    degrades to on, with ``fused_disabled``), off otherwise; an explicit
    ``fused=True`` without ``slo_chunked`` raises."""
    if fused is not None:
        if fused and sched_policy != POLICY_SLO:
            raise ValueError(
                "fused=True requires sched_policy='slo_chunked': only chunked "
                "admission makes the slices a fused dispatch carries")
        return bool(fused)
    flag = _env_flag(ENV_FUSED, emit, "fused_disabled")
    return sched_policy == POLICY_SLO and flag is not False


def resolve_persistent(persistent: Optional[bool], do_sample: bool,
                       emit=_no_emit, mode: Optional[str] = None) -> bool:
    """Whether rounds are persistent: explicit argument >
    ``KATA_TPU_PERSISTENT`` ("1" on; malformed degrades to off) > off. A
    server whose ``mode`` is ``"speculative"`` (lock-step rounds driven by
    the host) or ``"ring_kv"`` cannot, and the round is greedy only, so
    on a sampling server either: there an explicit ``persistent=True``
    raises and the env value degrades. Each degrade emits
    ``persistent_disabled``."""
    explicit = persistent is not None
    on = (bool(persistent) if explicit
          else _env_flag(ENV_PERSISTENT, emit, "persistent_disabled") is True)
    reason = mode or ("sampling" if do_sample else None)
    if on and reason is not None:
        if explicit:
            why = ("persistent rounds are greedy only" if reason == "sampling"
                   else "persistent rounds are not modeled for it")
            raise ValueError(
                f"persistent=True is incompatible with this server ({reason}): "
                f"{why}")
        emit("persistent_disabled", reason=reason)
        return False
    return on


# Serving heartbeat's loop-phase buckets (the JAX server's): where one
# interval's host wall clock went. ``admit``: admission passes (prefill
# forwards included); ``dispatch``: issuing decode chunks; ``retire``:
# fence waits and landing tokens; ``host_transfer``: preemption spills,
# resumes and the resume prefetch; ``other``: everything between.
LOOP_PHASE_ADMIT = "admit"
LOOP_PHASE_DISPATCH = "dispatch"
LOOP_PHASE_RETIRE = "retire"
LOOP_PHASE_HOST = "host_transfer"
LOOP_PHASE_OTHER = "other"
LOOP_PHASES = (LOOP_PHASE_ADMIT, LOOP_PHASE_DISPATCH, LOOP_PHASE_RETIRE,
               LOOP_PHASE_HOST, LOOP_PHASE_OTHER)


class _PhaseClock:
    """Exclusive loop-phase wall time: the loop brackets its sections with
    :meth:`push`/:meth:`pop`, and elapsed time is charged to the INNERMOST
    open phase (a spill inside a retire window lands in ``host_transfer``,
    not twice). Disarmed (``heartbeat_rounds=0``) both calls are one
    attribute test. Host arithmetic only."""

    __slots__ = ("armed", "acc", "_stack", "_mark")

    def __init__(self, armed: bool):
        self.armed = armed
        self.acc = {p: 0.0 for p in LOOP_PHASES[:-1]}
        self._stack: list = []
        self._mark = 0.0

    def push(self, phase: str) -> None:
        if not self.armed:
            return
        now = time.perf_counter()
        if self._stack:
            top = self._stack[-1]
            self.acc[top] = self.acc.get(top, 0.0) + (now - self._mark)
        self._stack.append(phase)
        self._mark = now

    def pop(self) -> None:
        if not self.armed or not self._stack:
            return
        now = time.perf_counter()
        phase = self._stack.pop()
        self.acc[phase] = self.acc.get(phase, 0.0) + (now - self._mark)
        self._mark = now

    def snapshot(self) -> dict:
        return dict(self.acc)

    def section(self, phase: str):
        """``with clock.section(phase):`` — :meth:`push` ... :meth:`pop`."""
        return _Section(self, phase)


class _Section:
    __slots__ = ("_clock", "_phase")

    def __init__(self, clock: _PhaseClock, phase: str):
        self._clock, self._phase = clock, phase

    def __enter__(self):
        self._clock.push(self._phase)

    def __exit__(self, *exc):
        self._clock.pop()


# Request lifecycle phases (the JAX server's): a request is in exactly one
# at any moment, and its ledger accrues wall time into the current one at
# each transition, so a ``request_trace``'s phases sum to its wall time.
PHASE_QUEUE = "queue"                # submit to admission grant
PHASE_PREFILL = "prefill"            # grant to the first-token fence
PHASE_DECODE = "decode"              # decoding rounds
PHASE_DECODE_DEGRADED = "decode_degraded"  # decoding after a mesh shrink
PHASE_PREEMPTED = "preempted"        # spilled, waiting for the pool
PHASE_RECOVERY = "recovery"          # crash recovery: restore wait, replay
PHASES = (PHASE_QUEUE, PHASE_PREFILL, PHASE_DECODE, PHASE_DECODE_DEGRADED,
          PHASE_PREEMPTED, PHASE_RECOVERY)

# Scrape-time gauges of stats() (the JAX server's names; a server's label
# tells instances apart). draft_acceptance reads 0 on a server that does
# not speculate.
_PROM_STATS = (
    ("rounds", "Device rounds dispatched"),
    ("prefills", "Prompt prefills performed"),
    ("tokens_emitted", "Tokens emitted (pre-trim, incl. prefill tokens)"),
    ("tokens_per_round", "Mean decoded tokens per device round"),
    ("slots_busy", "Arena slots currently serving a request"),
    ("queued", "Requests waiting for a slot"),
    ("batch_occupancy", "Busy fraction of the arena's slots"),
    ("kv_slot_utilization", "Mean busy-slot cache fill (pos / arena len)"),
    ("arena_bytes", "KV arena HBM footprint (addressable shards summed)"),
    ("draft_acceptance", "Speculative draft acceptance rate"),
    ("prefill_batches", "Multi-request admission prefill forwards"),
    ("prefix_hit_ratio", "Prefix-cache hit ratio (hits / lookups)"),
    ("prefix_store_occupancy", "Prefix store fill (tokens used / capacity)"),
    ("kv_pool_occupancy", "Paged KV pool fill (blocks in use / usable)"),
    ("kv_blocks_in_use", "Paged KV pool blocks currently referenced"),
    ("kv_host_blocks", "Host-RAM KV tier blocks resident (demoted prefix "
                       "segments + preempted session spills)"),
    ("preemptions", "Requests preempted (KV spilled, requeued FIFO)"),
    ("cow_copies", "Prefix-tier boundary blocks privatized copy-on-write"),
    ("recoveries", "Supervisor recoveries from a failed scheduler round"),
    ("quarantined", "Requests failed after K consecutive implicated rounds"),
    ("device_stalls", "Watchdog fence deadlines exceeded (real or injected)"),
    ("checkpoints", "Host KV checkpoints taken for crash recovery"),
    ("sched_chunks", "Chunked-prefill slices run by the admission scheduler"),
    ("sched_defers", "Admission passes deferred to decode under SLO pressure"),
    ("slo_violations", "Decode rounds whose cadence exceeded the ITL SLO"),
    ("tp_degree", "Tensor-parallel degree of the serving mesh (1 = unsharded)"),
    ("tp_degraded", "Serving below the configured tensor-parallel degree "
                    "after a permanent chip fault (0/1)"),
    ("tp_shrinks", "Elastic mesh-shrink recoveries performed (chip loss / "
                   "ICI failure survived degraded)"),
    ("request_traces", "Request lifecycle traces emitted (one request_trace "
                       "event per retired/failed request)"),
    ("decode_steps", "Multi-step decode multiplier K (tokens per dispatch = "
                     "chunk × K; 1 = one chunk per dispatch)"),
    ("heartbeats", "Serving heartbeats emitted (one serving_heartbeat "
                   "event every heartbeat_rounds rounds)"),
    ("heartbeat_tokens_per_s", "Decoded tokens/s over the last heartbeat "
                               "interval (0.0 before the first heartbeat)"),
    ("watchdog_alerts", "SLO-burn watchdog alerts fired (sustained "
                        "breaches; each dumped the flight ring)"),
    ("watchdog_active", "Watchdog alert kinds currently active (0 = "
                        "healthy)"),
    ("mfu", "Model FLOP/s utilization over the last heartbeat interval "
            "(dispatched executable FLOPs / interval wall / public "
            "per-chip peak x tp)"),
    ("device_busy_frac", "Fraction of the last heartbeat interval covered "
                         "by in-flight decode rounds (dispatch->retire)"),
    ("dispatch_gap_ms", "Mean retire-fence -> next-dispatch host gap over "
                        "the last heartbeat interval (ms; the "
                        "device-idle signal)"),
)

# Labeled histograms, gauges and counters (the JAX server's families),
# made through the idempotent factory: (kind, name, doc, labels).
_FAMILIES = {
    "phase": ("histogram", "kata_tpu_serving_request_phase_seconds",
              "Per-request lifecycle phase time attributed at retire "
              "(queue/prefill/decode/decode_degraded/preempted/recovery)",
              ("server", "phase")),
    "loop": ("histogram", "kata_tpu_serving_loop_phase_seconds",
             "Serving-loop phase time per heartbeat interval "
             "(admit/dispatch/retire/host_transfer/other)",
             ("server", "phase")),
    "ttft": ("histogram", "kata_tpu_serving_ttft_seconds",
             "Time to first token: submit → prefill token sampled",
             ("server",)),
    "tok_lat": ("histogram", "kata_tpu_serving_decode_token_seconds",
                "Per-token decode latency (fenced chunk time / steps)",
                ("server",)),
    "shard_occ": ("gauge", "kata_tpu_serving_kv_pool_shard_occupancy",
                  "Paged KV pool fill per tensor-parallel mesh shard "
                  "(0.0 at tp=1 or on slotted servers)", ("server", "shard")),
    "backend": ("gauge", "kata_tpu_serving_decode_attn_backend",
                "Active decode-attention backend (1 on the server's backend "
                "label, 0 on the others; cuda_paged | reference)",
                ("server", "backend")),
    "headroom": ("gauge", "kata_tpu_serving_hbm_headroom_bytes",
                 "Device memory headroom (limit - used) at the last heartbeat "
                 "poll; NaN where the backend exposes no memory_stats",
                 ("server",)),
    "prefix_hits": ("counter", "kata_tpu_serving_prefix_hits",
                    "Admissions served from the prefix KV store (suffix-only "
                    "prefill)", ("server",)),
    "prefix_misses": ("counter", "kata_tpu_serving_prefix_misses",
                      "Admissions with no usable cached prefix (cold "
                      "prefill)", ("server",)),
    "prefix_reused": ("counter", "kata_tpu_serving_prefix_tokens_reused",
                      "Prompt tokens whose KV was copied from the prefix "
                      "store instead of re-prefilled", ("server",)),
    "preempt": ("counter", "kata_tpu_serving_kv_preemptions_total",
                "Requests preempted under KV pool pressure (spilled + "
                "requeued)", ("server",)),
    "cow": ("counter", "kata_tpu_serving_kv_cow_copies_total",
            "Prefix-tier boundary blocks privatized copy-on-write at "
            "admission", ("server",)),
    "kv_demote": ("counter", "kata_tpu_serving_kv_demotions_total",
                  "Cold KV demoted from the device pool to the host-RAM tier "
                  "(prefix segments under pool pressure + preempted session "
                  "spills)", ("server",)),
    "kv_prefetch": ("counter", "kata_tpu_serving_kv_prefetches_total",
                    "Host-tier KV prefetched back to the device pool (prefix "
                    "hits on demoted segments + preempted session resumes)",
                    ("server",)),
    "sched_chunk": ("counter", "kata_tpu_serving_prefill_chunks_total",
                    "Chunked-prefill slices run by the admission scheduler",
                    ("server",)),
    "sched_defer": ("counter", "kata_tpu_serving_admission_defers_total",
                    "Admission passes deferred to decode under projected-ITL "
                    "pressure", ("server",)),
    "slo": ("counter", "kata_tpu_serving_itl_slo_violations_total",
            "Decode rounds whose retire cadence exceeded the ITL SLO",
            ("server",)),
    "fused": ("counter", "kata_tpu_serving_fused_admissions_total",
              "Chunked admissions whose slices rode fused prefill+decode "
              "dispatches", ("server",)),
    "recover": ("counter", "kata_tpu_serving_crash_recoveries_total",
                "Supervisor recoveries from a failed scheduler round",
                ("server",)),
    "quarantine": ("counter", "kata_tpu_serving_requests_quarantined_total",
                   "Requests failed individually after K consecutive "
                   "implicated rounds", ("server",)),
    "stall": ("counter", "kata_tpu_serving_fence_stalls_total",
              "Watchdog fence deadlines exceeded (real or injected)",
              ("server",)),
}


def _family(key: str):
    kind, name, doc, labels = _FAMILIES[key]
    return getattr(obs, kind)(name, doc, labels)


@dataclass
class _Request:
    rid: int
    prompt: np.ndarray  # [S] int32
    max_new_tokens: int
    t_submit: float = 0.0
    out: list = field(default_factory=list)
    done: bool = False
    # Consecutive failed rounds it was implicated in (0 again after a round
    # it survives; at quarantine_after it fails on its own), and the times
    # crash recovery requeued it to replay from its prompt.
    fails: int = 0
    replays: int = 0
    # Lifecycle ledger: seconds per PHASES entry, the current phase (None
    # once its request_trace is out) and when it was entered.
    phases: dict = field(default_factory=dict)
    state: Optional[str] = PHASE_QUEUE
    t_state: float = 0.0


@dataclass
class _CkptEntry:
    """One live lane's recovery checkpoint: the request, its tokens and
    scheduling state as of the snapshot, and its KV rows on the host (the
    preemption spill's ``[L, ceil(pos/bs)*bs, ...]`` rows when paged, the
    lane's ``[L, 1, max_len, ...]`` slot slice when slotted). A restore
    re-lands them verbatim, so greedy decode from there repeats the tokens
    after the snapshot."""
    req: _Request
    out: list
    pos: int
    last: int
    kv: Any


@dataclass
class _Preempted:
    """A request spilled under pool pressure: its written KV rows on the
    host (leaves ``[L, ceil(pos/bs)*bs, ...]``, pinned on CUDA), and where
    decode resumes. ``ready``: on CUDA an event recorded after the rows'
    copy to the host, which a staged upload on another stream waits for."""
    req: _Request
    kv: Any
    pos: int
    last: int
    ready: Optional[torch.cuda.Event] = None


@dataclass
class _ResumeStage:
    """The staged resume prefetch: request ``rid``'s spilled rows uploaded
    on the side stream into ``rows``; ``done`` is recorded there after the
    upload, ``src`` the pinned rows it reads."""
    rid: int
    rows: Any
    done: Optional[torch.cuda.Event] = None
    src: Any = None


@dataclass
class _LanePlan:
    """A paged admission's block reservation, made before its prefill
    forward. ``table[:n_shared]`` are prefix-tier blocks the lane reads and
    never writes (pool references); the admission scatter masks them with
    SCRATCH. When the match is not block-aligned, the partly covered
    boundary block is the first private entry, filled from the
    materialized cache: the copy on write."""
    table: list
    n_shared: int


@dataclass
class _PartialPrefill:
    """One chunked admission in progress: the queue head's prompt,
    prefilled in ``prefill_chunk``-token slices between decode rounds into
    its own ``[L, 1, max_len, ...]`` caches. It lands in a lane (arena
    write, first token) only when the last slice has run, through the
    same ``_finish_admission`` as every other admission. Head-of-line:
    while it exists nothing else admits or resumes."""
    req: _Request
    hit: Optional[PrefixHit]
    caches: Any
    offset: int     # prompt rows already resident (prefix reuse and chunks)
    reused: int = 0  # prefix rows copied from the store
    chunks: int = 0  # chunk forwards run so far
    fused: int = 0  # chunks that rode a decode dispatch


@dataclass
class _FusedChunk:
    """One admission slice that rode a decode dispatch (its partial's
    ``offset`` advanced at dispatch, so an overlapped pipeline carries the
    next slice in the next dispatch) and the slice's last-position logits
    on the device. ``last``: the final slice, whose retire samples the
    first token and lands the admission."""
    partial: _PartialPrefill
    last: bool
    logits: torch.Tensor


@dataclass
class _Inflight:
    """The dispatched, not yet retired decode chunk of the overlapped loop.
    ``last``/``pos`` are its outputs on the device, which the next chunk
    starts from; ``fence`` is their copy to the host, with the tokens.
    ``slots`` pins the (lane, request) pairs at dispatch: a lane refilled
    or preempted while the chunk was in flight fails the identity check at
    retire, and its tokens are dropped."""
    fence: DeviceFence
    last: torch.Tensor
    pos: torch.Tensor
    slots: list
    t_dispatch: float
    span: Optional[obs.Span] = None  # detached; ends at retire
    fused: Optional[_FusedChunk] = None  # an admission slice riding along


def _params_device(params) -> torch.device:
    """The device a params tree (whole or sharded) lives on."""
    return leaves(params["embed"])[0].device


def _tensor_leaves(tree) -> list:
    """The tensors of a params or cache tree (dicts, lists, tuples, QTensors
    of tensors and :class:`..parallel.sharding.Sharded` pieces), in a fixed
    order; other leaves are skipped."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, Sharded):
        return list(tree.pieces)
    if isinstance(tree, dict):
        return [t for k in sorted(tree, key=str) for t in _tensor_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensor_leaves(v)]
    return []


def _tree_to(tree, device: torch.device, copy: bool = False):
    """A params tree (dicts, lists, tuples and the int8 and LoRA wrappers of
    tensors) with every tensor on ``device``; ``copy`` copies even where it
    already is."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device, copy=copy)
    if hasattr(tree, "_fields"):  # QTensor, LoRAWeight
        return type(tree)(*(_tree_to(t, device, copy) for t in tree))
    if isinstance(tree, dict):
        return {k: _tree_to(v, device, copy) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device, copy) for v in tree)
    return tree


def _storage_bytes(tree) -> int:
    """Device bytes a tree's tensors hold, each storage once (the shards of
    a tensor-parallel server may view one storage)."""
    seen = {}
    for t in _tensor_leaves(tree):
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def _merge_rows(dev_vals: torch.Tensor, host_vals: torch.Tensor,
                fresh: torch.Tensor) -> torch.Tensor:
    """The overlapped dispatch's input: the in-flight chunk's rows on the
    device, with the rows the host refilled since the last dispatch
    (``fresh``) taken from the host."""
    return torch.where(fresh, host_vals, dev_vals)


def _write_slots(arena, batch_caches, slots: torch.Tensor) -> None:
    """Copy the N rows of one admission prefill (leaves ``[L, N, S, ...]``)
    into arena slots ``slots`` at positions ``0 .. S-1``, in place; a cycle
    arena pair by pair. Rows past S keep an earlier request's values:
    decode writes position p before it attends to it and masks everything
    past p, so they are never read."""
    for dst, src in zip(cache_leaves(arena), cache_leaves(batch_caches)):
        dst[:, slots, : src.shape[2]] = src


def _check_spec_ring(cfg: DecoderConfig, speculative_k: int, draft, top_k: int,
                     top_p: float, ring_kv: bool) -> None:
    """The JAX server's refusals of a speculative or ring config."""
    if speculative_k < 0:
        raise ValueError(f"speculative_k must be >= 0, got {speculative_k}")
    if draft is not None and not speculative_k:
        raise ValueError(
            "draft=(draft_params, draft_cfg) requires speculative_k > 0")
    if draft is not None and draft[1].vocab_size != cfg.vocab_size:
        raise ValueError(
            f"draft vocab {draft[1].vocab_size} != target vocab "
            f"{cfg.vocab_size} — draft tokens would be meaningless")
    if speculative_k and (top_k or top_p):
        raise ValueError(
            "speculative serving supports greedy (temperature=0, exact token "
            "identity) and plain temperature sampling (the lossless rejection "
            "scheme, models.speculative.sample_accept_row); top_k/top_p "
            "truncation is not modeled in the acceptance math — disable them "
            "with speculative_k")
    if ring_kv and not any(w > 0 for w in cfg.window_cycle):
        raise ValueError(
            "ring_kv needs a sliding-window config (cfg.sliding_window > 0 or "
            "a windowed attn_windows cycle)")


class GenerationServer:
    """Continuous batching over one decode arena, slotted or paged.

    >>> srv = GenerationServer(params, cfg, max_batch=4, max_len=512)
    >>> rid = srv.submit(prompt_tokens, max_new_tokens=64)
    >>> results = srv.run()          # {rid: np.ndarray of generated tokens}

    ``temperature > 0`` samples every token (with ``top_k``/``top_p``,
    :func:`..models.transformer.sample_token`) from :attr:`generator`, a
    ``torch.Generator`` on the server's device seeded with ``seed``.
    ``kv_quant=None`` resolves int8 KV unless ``KATA_TPU_KV_QUANT=bf16``.
    ``decode_attn`` picks the decode attention: ``"cuda_paged"`` (the
    kernel; its plain version on the CPU) or ``"reference"`` (the plain
    attention over the arena); None reads ``KATA_TPU_DECODE_ATTN``, then
    chooses the kernel on CUDA and the plain attention on the CPU, and the
    plain attention wherever the config has a sliding window or an
    attention-logit softcap (JAX's rule). An explicit ``"cuda_paged"``
    the config rules out, or a kernel that cannot take the config's
    shapes, raises. ``device`` defaults to
    CUDA and must hold ``params``; there every prompt is padded to one of
    ``prefill_buckets``, which must all be flash-kernel lengths.

    ``kv_pool_tokens`` (argument, else ``KATA_TPU_KV_POOL_TOKENS``) turns
    on the paged pool of that many tokens in blocks of ``kv_block_size``:
    ``max_batch`` becomes the number of decode lanes, and the pool, not the
    lane count, bounds the KV memory. The drained pool must hold one
    ``max_len`` request. An explicit value the server cannot run raises; a
    malformed or unusable environment value leaves the server slotted. On
    CUDA the block size must be a KV tile the paged kernel takes.

    ``overlap`` picks the round loop (pipelined by default, as in the JAX
    server) and ``decode_steps`` the chunks a dispatch runs (module doc).
    ``sched_policy`` (else ``KATA_TPU_SCHED_POLICY``, else
    ``"fifo_batch"``), ``prefill_chunk`` (``KATA_TPU_PREFILL_CHUNK``,
    128), ``itl_slo_ms`` (``KATA_TPU_ITL_SLO_MS``, 50) and ``fused``
    (``KATA_TPU_FUSED``, on under ``"slo_chunked"``) pick the admission
    schedule; ``persistent`` (``KATA_TPU_PERSISTENT``, off) the persistent
    rounds. Explicit values the server cannot take raise; env values
    degrade to the defaults, as in the JAX server.
    :meth:`request_drain` and :meth:`drain` stop admission: started work,
    preempted spills included, runs to its end, and what never started
    fails into :meth:`failures`.

    ``prefix_cache_tokens`` (else ``KATA_TPU_PREFIX_CACHE_TOKENS``) > 0
    turns on the prefix cache (module doc): a slotted server's
    :class:`.prefix_cache.PrefixStore` of that many tokens, a paged
    server's tier in its pool. ``prefix_store`` injects a store, which may
    back several slotted servers; its config, buckets, KV dtype and device
    must be this server's, and it keeps an env pool size from paging the
    server (an explicit one raises). The cache needs ``prefill_buckets``:
    without them an explicit size or store raises, an env size degrades.
    ``kv_host_tokens`` (else ``KATA_TPU_KV_HOST_TOKENS``) sizes the host
    tier of a paged server: explicit values < 0, or > 0 on a slotted
    server, raise; env values degrade to 0.

    ``speculative_k`` > 0 speculates (module doc) once opted in by
    ``spec_opt_in=True`` (else ``KATA_TPU_SPEC=1``; otherwise it degrades
    with ``spec_disabled``); ``draft=(draft_params, draft_cfg)`` (a model
    of the same vocabulary, on this device) drafts in place of n-gram
    lookup. ``ring_kv=True`` (a config with a sliding window) makes the
    arena rings (module doc). Both refuse what the JAX server refuses:
    ``speculative_k < 0``, a draft without ``speculative_k`` or of another
    vocabulary, ``top_k``/``top_p`` with ``speculative_k``, ``ring_kv``
    without a window; explicit knobs they cannot take raise, env ones
    degrade with JAX's events and reasons.

    ``tp`` (else ``KATA_TPU_TP`` and the topology env) serves across that
    many shards of the server's device (module doc); ``kv_layout`` (else
    ``KATA_TPU_KV_LAYOUT``, else ``"heads"``) places the KV state:
    ``"blocks"`` needs a paged pool (explicit on a slotted server raises,
    the env value degrades to ``"heads"``) and makes the pool one
    sub-pool a shard. An explicit ``tp`` below 1, with ``ring_kv`` or
    ``speculative_k``, or one the model's heads, KV features or MLP do
    not divide, raises; the env value degrades to 1. ``mesh`` (module doc)
    serves over a caller's training mesh; with ``tp`` it raises JAX's
    ``ValueError``.

    Crash tolerance (module doc): ``fault_injector`` (else one from
    ``KATA_TPU_FAULTS``/``KATA_TPU_FAULTS_SEED``), ``fence_timeout_s``
    (``KATA_TPU_FENCE_TIMEOUT_S``, 0: inline waits), ``quarantine_after``
    (``KATA_TPU_QUARANTINE_K``, 3), ``recovery_backoff_s``
    (``KATA_TPU_RECOVERY_BACKOFF_S``, 0.05), ``checkpoint_rounds``
    (``KATA_TPU_CHECKPOINT_ROUNDS``, 0; refused with speculative decoding,
    as in the JAX server), ``KATA_TPU_RECOVERY=0`` (no supervisor),
    ``degraded`` (``KATA_TPU_DEGRADED``, on) and ``tp_min``
    (``KATA_TPU_TP_MIN``, 1; < 1 raises). Env values degrade with the JAX
    server's events. A ``tp > 1`` server with degraded mode on keeps a host
    copy of the unsplit parameters to re-split after a shrink.

    Telemetry (module doc): ``heartbeat_rounds`` (else
    ``KATA_TPU_HEARTBEAT_ROUNDS``, else 32; 0 disables the heartbeat, the
    ledger, the watchdog and the phase clock; an explicit value < 0
    raises, a malformed env value degrades with ``heartbeat_invalid``);
    ``watchdog``: an injected :class:`..obs.watchdog.SLOBurnWatchdog` or
    ``True`` (both need the heartbeat, else raise), ``False`` disarms,
    None arms it with the heartbeat unless ``KATA_TPU_WATCHDOG=0``; the
    ledger follows the heartbeat unless ``KATA_TPU_DEVLEDGER=0``.
    ``strict`` (else ``KATA_TPU_STRICT``) guards the overlapped round
    against host synchronization on the card; ``tripwire`` (default on)
    counts steady-state compiles and reshards into ``stats()``
    (:mod:`..compat.torchapi`)."""

    _instance_ids = itertools.count()

    def __init__(self, params: Any, cfg: DecoderConfig, max_batch: int = 4,
                 max_len: int = 512, eos_id: Optional[int] = None,
                 chunk: int = 8, temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0, seed: int = 0,
                 kv_quant: Optional[bool] = None, prefill_buckets: tuple = (),
                 overlap: bool = True, decode_attn: Optional[str] = None,
                 device=None,
                 kv_pool_tokens: Optional[int] = None, kv_block_size: int = 16,
                 kv_host_tokens: Optional[int] = None,
                 kv_layout: Optional[str] = None, tp: Optional[int] = None,
                 speculative_k: int = 0, ring_kv: bool = False,
                 prefix_cache_tokens: Optional[int] = None,
                 prefix_store: Optional[PrefixStore] = None,
                 sched_policy: Optional[str] = None,
                 prefill_chunk: Optional[int] = None,
                 itl_slo_ms: Optional[float] = None,
                 fused: Optional[bool] = None,
                 decode_steps: Optional[int] = None,
                 persistent: Optional[bool] = None,
                 checkpoint_rounds: Optional[int] = None,
                 mesh: Any = None, draft: Optional[tuple] = None,
                 strict: Optional[bool] = None,
                 tripwire: Optional[bool] = None,
                 fault_injector: Any = None,
                 fence_timeout_s: Optional[float] = None,
                 quarantine_after: Optional[int] = None,
                 recovery_backoff_s: Optional[float] = None,
                 spec_opt_in: Optional[bool] = None,
                 tp_min: Optional[int] = None,
                 degraded: Optional[bool] = None,
                 heartbeat_rounds: Optional[int] = None,
                 watchdog: Any = None):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        _check_spec_ring(cfg, speculative_k, draft, top_k, top_p, ring_kv)
        # Label and trace first: every degrade event below carries them.
        # The trace is the daemon's per-allocation id when injected.
        self._label = f"server{next(GenerationServer._instance_ids)}"
        self._trace = (os.environ.get(ENV_TRACE_CTX, "").strip()
                       or obs.new_trace())
        # A valid speculative config arms only when opted in; otherwise the
        # server decodes plainly and says so (the JAX server's rule).
        if speculative_k:
            opted = (os.environ.get(ENV_SPEC_OPT_IN, "") == "1"
                     if spec_opt_in is None else bool(spec_opt_in))
            if not opted:
                self._emit("spec_disabled", reason="opt_in_required",
                           speculative_k=speculative_k)
                speculative_k, draft = 0, None
        self.speculative_k = speculative_k
        self.draft = draft
        self.ring_kv = bool(ring_kv)
        self._cycle = self.ring_kv and len(cfg.window_cycle) > 1
        # Windowed rings carry speculative_k margin slots: a verify span of
        # k+1 rows then never evicts a key a live window still sees.
        self._ring_margin = speculative_k if ring_kv else 0
        speculative = bool(speculative_k) or draft is not None
        # The mode a knob conflicts with, in the JAX server's order: the ring
        # first for chunked admission, speculation first for multi-step
        # decode and persistent rounds.
        self._mode = ("ring_kv" if ring_kv else
                      "speculative" if speculative else None)
        spec_first = "speculative" if speculative else self._mode
        self._init_resilience(
            fault_injector, fence_timeout_s, quarantine_after,
            recovery_backoff_s, checkpoint_rounds, speculative=speculative)
        if mesh is not None:
            if tp is not None:
                raise ValueError(
                    "pass tp= OR mesh=, not both — tp builds its own 1×N "
                    "serving mesh (guest/tp_serving.py)")
            # A caller's training mesh: the degree is its model axis, and
            # the tp= path's refusals (ring, speculation) do not apply.
            self._tp = mesh.shape.get(AXIS_MODEL, 1)
            for c in (cfg,) + ((draft[1],) if draft is not None else ()):
                reason = tp_conflict(c, self._tp, False, False)
                if reason is not None:
                    raise ValueError(f"mesh {mesh.shape} is incompatible "
                                     f"with this server ({reason})")
        else:
            self._tp = resolve_tp(tp, cfg, ring_kv, speculative,
                                  emit=self._emit, label=self._label,
                                  trace=self._trace)
        self._mesh_injected = mesh is not None
        # Degraded mode: the shrink ladder's floor and the kill switch.
        if tp_min is not None:
            if int(tp_min) < 1:
                raise ValueError(f"tp_min must be >= 1, got {tp_min}")
            self._tp_min = int(tp_min)
        else:
            self._tp_min = tp_serving.tp_min_from_env(label=self._label,
                                                      trace=self._trace)
        self._degraded_ok = (tp_serving.degraded_enabled() if degraded is None
                             else bool(degraded))
        self._tp_initial = self._tp
        self._tp_shrinks = 0
        if any(b < 1 or b > max_len for b in prefill_buckets):
            raise ValueError(
                f"prefill_buckets {prefill_buckets} must lie in [1, max_len]")
        check_supported(cfg)
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            require_flash_buckets(prefill_buckets, cfg.head_dim)
        if mesh is not None and mesh.device != self.device:
            raise ValueError(f"mesh lives on {mesh.device}, the server runs "
                             f"on {self.device}")
        if _params_device(params) != self.device:
            raise ValueError(
                f"params live on {_params_device(params)}, the server runs on "
                f"{self.device}")
        if draft is not None:
            check_supported(draft[1])
            if _params_device(draft[0]) != self.device:
                raise ValueError(
                    f"draft params live on {_params_device(draft[0])}, the "
                    f"server runs on {self.device}")
        self.cfg = cfg
        # The shards of a tensor-parallel server (every one on this device);
        # params split across them by the serving rules. The unsplit params
        # stay on the host for a shrink to re-split (the JAX server's donor
        # copy). A caller's mesh keeps its training layout (PARAM_RULES
        # pieces; the draft's too) and never shrinks, so keeps no copy.
        if mesh is not None:
            self._mesh = ServingMesh.for_mesh(cfg, mesh)
            if draft is not None:
                self.draft = draft = (tp_serving_params(
                    draft[0], draft[1], ServingMesh.for_mesh(draft[1], mesh)),
                    draft[1])
        else:
            self._mesh = (ServingMesh.for_config(cfg, self._tp, self.device)
                          if self._tp > 1 else None)
        self.params = (tp_serving_params(params, cfg, self._mesh)
                       if self._mesh is not None else params)
        self._params_host = (_tree_to(params, torch.device("cpu"), copy=True)
                             if self._tp > 1 and self._degraded_ok
                             and mesh is None else None)
        self.max_batch, self.max_len = max_batch, max_len
        self.eos_id, self.chunk = eos_id, chunk
        self.top_k, self.top_p = top_k, top_p
        # Every draw of the server, at admission and inside the decode
        # chunks, comes from this generator, in the order the host issues
        # them: one seed gives the same tokens run after run.
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))
        self._do_sample = _sampling_args(temperature, top_k, self.generator,
                                         top_p)
        # Device-resident temperature, made once: no per-dispatch upload.
        self._temp_dev = (torch.full((), float(temperature), dtype=torch.float32,
                                     device=self.device)
                          if self._do_sample else None)
        self.overlap = bool(overlap)
        # Every degrade below reports through _emit; the latency summaries
        # and histograms are bound before anything can observe into them.
        self._ttft = Rolling()
        self._tok_lat = Rolling()
        self._phase_roll = {p: Rolling() for p in PHASES}
        self._traces_emitted = 0
        self._bind_histograms()
        self.kv_quant = resolve_kv_quant(kv_quant, self._emit)
        # Strict mode guards each overlapped round (compat.torchapi); the
        # tripwire counts every run() after the first (the warm-up drain).
        self.strict = (torchapi.strict_enabled() if strict is None
                       else bool(strict))
        self.tripwire = True if tripwire is None else bool(tripwire)
        self._tw_warmed = False
        self._steady_compiles = 0
        self._steady_reshards = 0
        policy, chunk_tokens, slo_ms = resolve_sched(
            sched_policy, prefill_chunk, itl_slo_ms, self._emit)
        if policy == POLICY_SLO and self._mode is not None:
            # A chunk resumes through prefill_suffix: the ring folds and a
            # draft's arena have no chunk-resume path (the JAX server's set).
            if sched_policy is not None:
                raise ValueError(
                    "sched_policy='slo_chunked' is incompatible with this "
                    f"server ({self._mode})")
            self._emit("sched_disabled", reason=self._mode)
            policy = POLICY_FIFO
        self._decode_steps = resolve_decode_steps(decode_steps, self._emit)
        if self._decode_steps > 1 and spec_first is not None:
            # Speculative rounds are lock-step; a ring fold cannot take the
            # frozen lanes' rewrites across the wrap.
            if decode_steps is not None:
                raise ValueError(
                    f"decode_steps={self._decode_steps} is incompatible with "
                    f"this server ({spec_first})")
            self._emit("decode_steps_invalid", reason=spec_first)
            self._decode_steps = 1
        # Steps of one dispatch: ITL, the budget gate and the paged
        # lookahead key off this, never off ``chunk`` alone.
        self._dispatch_steps = chunk * self._decode_steps
        self._fused_ok = resolve_fused(fused, policy, self._emit)
        self._sched = make_scheduler(
            policy, chunk_tokens=chunk_tokens, slo_ms=slo_ms,
            decode_steps=self._dispatch_steps, fused=self._fused_ok)
        self._partial: Optional[_PartialPrefill] = None
        self._fuse_pending = False
        self._fused_ret: Optional[_FusedChunk] = None
        self._fused_admissions = 0
        self._persistent = resolve_persistent(
            persistent, self._do_sample, self._emit, mode=spec_first)
        self._hb_every = self._resolve_heartbeat(heartbeat_rounds)
        # A persistent round's step cap, a static of its executable: the
        # heartbeat cadence bounds it (the host surfaces telemetry at least
        # once a heartbeat interval), max_len its token buffer.
        cap_rounds = self._hb_every or DEFAULT_HEARTBEAT_ROUNDS
        self._persistent_cap = max(
            min(self._dispatch_steps * cap_rounds, max_len),
            self._dispatch_steps) if self._persistent else 0
        self._persistent_rounds = 0
        self._last_delivered = 0
        self._delivered_total = 0
        self._delivered_lane_steps = 0
        self._persistent_exits = dict.fromkeys(PERSISTENT_EXITS, 0)
        self._persistent_fut: Optional[tuple] = None  # (delivered, window)
        self.prefill_buckets = tuple(sorted(prefill_buckets))
        self.kv_block = int(kv_block_size)
        self.kv_pool: Optional[KVPool] = None
        # Set before the pool resolves: the blocks layout rounds the pool
        # to whole blocks a shard.
        self._kv_layout, explicit_layout = resolve_kv_layout(kv_layout,
                                                             self._emit)
        host_tokens, explicit_host = _resolve_tokens(
            kv_host_tokens, ENV_KV_HOST_TOKENS, self._emit, "kv_host_invalid",
            negative_event=True)
        if host_tokens < 0:
            raise ValueError(f"kv_host_tokens must be >= 0, got {host_tokens}")
        self.paged = self._resolve_paged(kv_pool_tokens, prefix_store)
        if not self.paged and self._kv_layout == KV_LAYOUT_BLOCKS:
            if explicit_layout:
                raise ValueError("kv_layout='blocks' requires a paged KV pool "
                                 "(kv_pool_tokens)")
            self._emit("kv_layout_disabled", reason="not_paged")
            self._kv_layout = KV_LAYOUT_HEADS
        if not self.paged and host_tokens > 0:
            if explicit_host:
                raise ValueError("kv_host_tokens requires a paged KV pool "
                                 "(kv_pool_tokens)")
            self._emit("kv_host_disabled", reason="not_paged")
            host_tokens = 0
        self._kv_host = (HostKVTier(host_tokens, self.kv_block)
                         if host_tokens > 0 else None)
        self._drafts_offered = 0
        self._drafts_accepted = 0
        self._spec_signatures: set = set()
        # Ring and draft admissions fold or mirror one request's prefill:
        # one request a forward, as in the JAX server.
        self._can_batch_prefill = not self.ring_kv and draft is None
        self.draft_arena = (init_kv_caches(draft[1], max_batch, max_len,
                                           device=self.device)
                            if draft is not None else None)
        if self.paged:
            self.arena = None  # the pool is the arena: no slot grid
            self.kv_pool = KVPool(cfg, self._pool_tokens, self.kv_block,
                                  kv_quant=self.kv_quant,
                                  shards=self._kv_shards(), device=self.device)
            # Once a server: the pool's placement shape.
            self._emit("kv_layout", layout=self._kv_layout,
                       shards=self.kv_pool.shards,
                       per_shard_bytes=(cache_bytes(self.kv_pool.arena)
                                        // self.kv_pool.shards),
                       host_tier_tokens=host_tokens)
            self._nb_max = -(-max_len // self.kv_block)
            self._lane_blocks: list[list[int]] = [[] for _ in range(max_batch)]
            # SCRATCH filler: a lane with no live request (or a finished
            # lane overrunning) writes into the scratch block, never into
            # another lane's KV.
            self._bt_host = np.full((max_batch, self._nb_max), SCRATCH_BLOCK,
                                    np.int32)
            self._plans: dict[int, list[int]] = {}
        elif self._cycle:
            self.arena = init_cycle_kv_caches(
                cfg, max_batch, max_len, device=self.device,
                quantized=self.kv_quant, margin=self._ring_margin)
        else:
            self.arena = init_kv_caches(cfg, max_batch, self._arena_len(),
                                        device=self.device,
                                        quantized=self.kv_quant)
        self.prefix_store = self._make_prefix_store(prefix_cache_tokens,
                                                    prefix_store)
        # An injected store may back other servers: a shrink disables it
        # where it rebuilds an owned one.
        self._prefix_injected = prefix_store is not None
        # The per-server prefix counters (a store may back several
        # servers), and each lane's pinned hit, released at its finish.
        self._slot_prefix: list[Optional[PrefixHit]] = [None] * max_batch
        self._prefix_hits = 0
        self._prefix_misses = 0
        self._prefix_tokens_reused = 0
        self._cow_copies = 0
        # Host-tier traffic of preemption spills (the tier's own demotions
        # and promotions count in the tier) and the staged resume upload.
        self._host_demotions = 0
        self._host_prefetches = 0
        self._resume_staged = 0
        self._stage: Optional[_ResumeStage] = None
        self._h2d_stream = None
        self._h2d_inflight: list[_ResumeStage] = []
        self._preempted: deque[_Preempted] = deque()
        self._preemptions = 0
        self._lanes_peak = 0
        self._occupancy_peak = 0.0
        self._shard_peak = [0.0] * self._tp
        self._decode_attn, self._decode_attn_reason = (
            self._resolve_decode_attn(decode_attn))
        self._decode_attn_emitted = False
        self._kv_replicated_warned: set[int] = set()
        self._note_kv_replicated()
        # Counts of the graphs a shrink dropped: stats() stay cumulative.
        self._retired_graphs = {"_decode": [0, 0, 0], "_round": [0, 0, 0]}
        self._build_decode()
        # Host-side slot state: the request in each slot, its next cache
        # write position, and its last token.
        self._slot_req: list[Optional[_Request]] = [None] * max_batch
        self._pos = np.zeros(max_batch, np.int32)
        self._last = np.zeros(max_batch, np.int32)
        self._queue: deque[_Request] = deque()
        self._results: dict[int, np.ndarray] = {}
        self._failures: dict[int, str] = {}
        self._next_rid = 0
        self._rounds = 0
        self._emitted = 0
        self._prefills = 0
        self._batch_prefills = 0
        # The overlapped loop: the chunk in flight, the lanes refilled since
        # the last dispatch, and the retire clock ITL is read from.
        self._inflight: Optional[_Inflight] = None
        self._fresh_rows: set[int] = set()
        self._t_last_retire = 0.0
        self._draining = False
        self._drain_reason = ""
        self._drain_done = False
        self._drain_announced = False
        self._init_telemetry(watchdog)

    def _init_resilience(self, fault_injector, fence_timeout_s,
                         quarantine_after, recovery_backoff_s,
                         checkpoint_rounds, speculative: bool) -> None:
        """The supervisor's knobs and counters (class doc), resolved as in
        the JAX server: explicit arguments win, env values degrade with an
        event. With every knob at its default the loop is untouched: the
        injector's ``fire`` is one test, fences wait inline and no
        checkpoint runs."""
        def env_int(name, default, event):
            return resilience.env_int(name, default, event=event,
                                      server=self._label, trace=self._trace)

        def env_float(name, default, event):
            return resilience.env_float(name, default, event=event,
                                        server=self._label, trace=self._trace)

        self._inj = (fault_injector if fault_injector is not None
                     else FaultInjector.from_env(label=self._label,
                                                 trace=self._trace))
        self._fence_timeout_s = (
            env_float(ENV_FENCE_TIMEOUT, 0.0, "fence_timeout_disabled")
            if fence_timeout_s is None else float(fence_timeout_s))
        self._quarantine_k = max(1, (
            env_int(ENV_QUARANTINE_K, 3, "quarantine_k_invalid")
            if quarantine_after is None else int(quarantine_after)))
        self._backoff_s = (
            env_float(ENV_RECOVERY_BACKOFF_S, 0.05, "recovery_backoff_invalid")
            if recovery_backoff_s is None else float(recovery_backoff_s))
        self._supervised = os.environ.get(ENV_RECOVERY, "1") != "0"
        ckpt = (env_int(ENV_CHECKPOINT_ROUNDS, 0, "checkpoint_disabled")
                if checkpoint_rounds is None else int(checkpoint_rounds))
        if ckpt > 0 and speculative:
            # A draft's cache is a second arena the lane snapshot does not
            # cover: an explicit cadence raises, the env's degrades.
            if checkpoint_rounds is not None:
                raise ValueError(
                    f"checkpoint_rounds={ckpt} is incompatible with "
                    "speculative/draft serving")
            self._emit("checkpoint_disabled", reason="speculative")
            ckpt = 0
        self._ckpt_every = max(0, ckpt)
        self._ckpt: dict[int, _CkptEntry] = {}
        self._ckpt_round = 0
        self._recoveries = 0
        self._quarantined_n = 0
        self._stalls = 0
        self._checkpoints = 0
        self._fail_streak = 0  # consecutive failed rounds: the backoff's input
        # Crash unwind: the requests taken from the queue and not yet in a
        # lane, and those the running fill (or a reservation, or a chunk)
        # admits: a fault there blames them alone. A slice riding a decode
        # dispatch is blamed with its lanes from preparation to record.
        self._admitting: list[tuple[_Request, Optional[PrefixHit]]] = []
        self._admit_current: list[_Request] = []
        self._fused_blame: Optional[_Request] = None

    def _note_kv_replicated(self) -> None:
        """The JAX server's warning that the KV heads replicate across the
        shards (:func:`.tp_serving.kv_cache_spec` replicated), once a
        degree (a shrink may reach another). Every shard here reads the
        one copy on the device: a ``tp=`` server reports the 0 bytes that
        costs, a server over a caller's mesh JAX's figure, the ``tp - 1``
        extra copies a mesh across devices would hold."""
        layout = self._kv_layout if self.paged else KV_LAYOUT_HEADS
        if (self._tp > 1 and layout == KV_LAYOUT_HEADS
                and tp_serving.kv_cache_spec(self.cfg, self._tp, layout) == ()
                and self._tp not in self._kv_replicated_warned):
            self._kv_replicated_warned.add(self._tp)
            extra = 0
            if self._mesh_injected:
                arena = self.kv_pool.arena if self.paged else self.arena
                extra = (self._tp - 1) * sum(
                    t.nbytes for t in _tensor_leaves(arena))
            self._emit("kv_replicated", tp=self._tp,
                       n_kv_heads=self.cfg.n_kv_heads, extra_bytes=extra)

    def _build_decode(self) -> None:
        """The decode executables over the current params and mesh: the
        decode kernel's callable, the chunk's :class:`DecodeGraph` and,
        persistent, the :class:`PersistentRound`. Built at construction and
        again after a mesh shrink, which drops the old graphs (their pools
        released) and so makes one new capture."""
        for name, acc in self._retired_graphs.items():
            old = getattr(self, name, None)
            if old is not None:
                acc[0] += old.captures
                acc[1] += old.replays
                acc[2] += getattr(old, "executed_total", 0)
                old.release()
        decode_kernel = None
        if self._decode_attn == BACKEND_PAGED:
            decode_kernel = attention.make_decode_attn_fn(
                self.cfg, paged=self.paged, block_size=self.kv_block,
                paged_len=self.max_len, arena_len=self.max_len,
                device=self.device, mesh=self._mesh, kv_layout=self._kv_layout)
        arena = self.kv_pool.arena if self.paged else self.arena
        paged_kw = dict(table_width=self._nb_max if self.paged else 0,
                        block_size=self.kv_block if self.paged else 0,
                        paged_len=self.max_len if self.paged else 0)
        # Persistent servers arm the budget mask on every dispatch, the
        # fixed-step chunk of a fused round included (as in JAX).
        self._decode = DecodeGraph(
            self.params, arena, self.cfg, batch=self.max_batch,
            steps=self._dispatch_steps, device=self.device,
            decode_kernel_fn=decode_kernel,
            budget=self._decode_steps > 1 or self._persistent,
            eos_id=self.eos_id,
            sampling=Sampling(self.generator, self._temp_dev, self.top_k,
                              self.top_p) if self._do_sample else None,
            ring=self.ring_kv, **paged_kw)
        self._round = PersistentRound(
            self.params, arena, self.cfg, batch=self.max_batch,
            cap=self._persistent_cap, device=self.device,
            decode_kernel_fn=decode_kernel, eos_id=self.eos_id,
            **paged_kw) if self._persistent else None

    # ----- arena model -----------------------------------------------------

    def _make_prefix_store(self, tokens: Optional[int], injected):
        """The prefix cache by the JAX server's rules (class doc), or
        None."""
        tokens, explicit = _resolve_tokens(tokens, ENV_PREFIX_CACHE_TOKENS,
                                           self._emit, "prefix_store_disabled")
        if injected is None and tokens <= 0:
            return None
        if self.ring_kv or self.draft is not None:
            # Cold admission instead: a ring folds a prefix's rows per lane,
            # and a draft's arena would miss its own prefix KV.
            self._emit("prefix_store_disabled",
                       reason="ring_kv" if self.ring_kv else "draft")
            return None
        if not self.prefill_buckets:
            if explicit or injected is not None:
                raise ValueError(
                    "prefix caching requires prefill_buckets: matches are "
                    "bucket-aligned")
            self._emit("prefix_store_disabled", reason="no_prefill_buckets")
            return None
        if self.paged:
            return PagedPrefixTier(
                self.kv_pool, self.cfg, self.prefill_buckets,
                host_tier=self._kv_host, label=self._label,
                on_demote=self._c_kv_demote.inc,
                on_prefetch=self._c_kv_prefetch.inc)
        if injected is not None:
            if (injected.cfg != self.cfg
                    or injected.buckets != self.prefill_buckets
                    or injected.kv_quant != self.kv_quant
                    or injected.dtype != self.cfg.dtype
                    or injected.device != self.device):
                raise ValueError(
                    "injected prefix_store does not match this server (cfg, "
                    "prefill_buckets, kv_quant, cache dtype and device must "
                    "agree: its rows land verbatim in this arena)")
            return injected
        return PrefixStore(self.cfg, tokens, self.prefill_buckets,
                           kv_quant=self.kv_quant, device=self.device,
                           label=self._label)

    def _resolve_paged(self, kv_pool_tokens: Optional[int],
                       prefix_store) -> bool:
        """Whether this server runs paged: explicit ``kv_pool_tokens`` >
        ``KATA_TPU_KV_POOL_TOKENS`` > slotted. A malformed environment
        value, or one this server cannot run, degrades to slotted; an
        explicit one it cannot run raises."""
        explicit = kv_pool_tokens is not None
        if not explicit:
            kv_pool_tokens = _env_int(ENV_KV_POOL_TOKENS, 0, self._emit,
                                      "kv_pool_disabled")
        self._pool_tokens = int(kv_pool_tokens)
        if self._pool_tokens <= 0:
            return False
        reason = self._pool_conflict(self._pool_tokens, prefix_store)
        if reason is None:
            return True
        if explicit:
            raise ValueError(f"kv_pool_tokens={kv_pool_tokens} is incompatible "
                             f"with this server ({reason})")
        self._emit("kv_pool_disabled", reason=reason)
        return False

    def _pool_conflict(self, pool_tokens: int, prefix_store) -> Optional[str]:
        """Why this server cannot run paged, or None, the JAX server's
        reasons: a ring (a block gather would re-lay the band out),
        speculation (a draft's second arena, verify spans), an injected
        prefix store (the pool's own tier is the paged prefix path)."""
        if self.kv_block < 1:
            return f"bad_block_size:{self.kv_block}"
        if self.ring_kv:
            return "ring_kv"
        if self.speculative_k or self.draft is not None:
            return "speculative"
        if prefix_store is not None:
            return "injected_prefix_store"
        shards = self._kv_shards()
        usable = (pool_tokens // self.kv_block) // shards * shards - RESERVED_BLOCKS
        if usable < -(-self.max_len // self.kv_block):
            # Progress guarantee: the drained pool must hold one full-length
            # request, or the oldest request could wait forever.
            return f"pool_too_small:{pool_tokens}"
        return None

    def _arena_len(self) -> int:
        """A lane's arena length: the first window of the cycle plus the
        speculative margin under ``ring_kv`` (the JAX server's reading; a
        cycle arena's global layers hold ``max_len``), else ``max_len``."""
        if self.ring_kv:
            return self.cfg.window_cycle[0] + self._ring_margin
        return self.max_len

    def _kv_shards(self) -> int:
        """The pool's sub-pools: the degree under the blocks layout, else
        1."""
        return self._tp if self._kv_layout == KV_LAYOUT_BLOCKS else 1

    # ----- telemetry -------------------------------------------------------

    def _resolve_heartbeat(self, heartbeat_rounds: Optional[int]) -> int:
        """The heartbeat cadence: explicit argument (< 0 raises) >
        ``KATA_TPU_HEARTBEAT_ROUNDS`` (malformed or < 0 degrades to the
        default with ``heartbeat_invalid``) > 32."""
        if heartbeat_rounds is not None:
            if int(heartbeat_rounds) < 0:
                raise ValueError(
                    f"heartbeat_rounds must be >= 0, got {heartbeat_rounds}")
            return int(heartbeat_rounds)
        every = _env_int(ENV_HEARTBEAT_ROUNDS, DEFAULT_HEARTBEAT_ROUNDS,
                         self._emit, "heartbeat_invalid")
        if every < 0:
            self._emit("heartbeat_invalid", reason=f"bad_env:{every}")
            every = DEFAULT_HEARTBEAT_ROUNDS
        return every

    def _init_telemetry(self, watchdog) -> None:
        """The heartbeat's state, the loop-phase clock, the device ledger
        and the watchdog (class doc), then the one ``serving_config``
        event."""
        every = self._hb_every
        self._hb_round = 0          # rounds at the last heartbeat
        self._hb_count = 0
        self._hb_t_last = time.monotonic()
        self._hb_last: Optional[dict] = None
        self._hb_prev: dict = {}    # the counters the deltas diff against
        self._clock = _PhaseClock(armed=every > 0)
        self._clock_prev: dict = {}
        self._devledger = obs.DeviceLedger(
            armed=every > 0 and obs.devledger.enabled(), emit=self._emit,
            clock=self._clock, gap_phases=LOOP_PHASES,
            components=self._hbm_components, device=self.device)
        if isinstance(watchdog, obs.SLOBurnWatchdog) or watchdog is True:
            if every <= 0:
                raise ValueError("watchdog requires heartbeat_rounds > 0: it "
                                 "consumes the heartbeats")
            self._watchdog: Optional[obs.SLOBurnWatchdog] = (
                watchdog if isinstance(watchdog, obs.SLOBurnWatchdog)
                else self._default_watchdog())
        elif watchdog is None and every > 0 and obs.watchdog.enabled():
            self._watchdog = self._default_watchdog()
        else:
            self._watchdog = None
        if self._watchdog is not None:
            self._watchdog.bind(self._emit)
        self._emit(
            "serving_config", sched_policy=self._sched.name,
            decode_steps=self._decode_steps, chunk=self.chunk,
            dispatch_steps=self._dispatch_steps, fused=int(self._fused_ok),
            overlap=int(self.overlap), paged=int(self.paged), tp=self._tp,
            kv_layout=self._kv_layout,
            prefill_buckets=list(self.prefill_buckets),
            tripwire=int(self.tripwire),
            kv_host_tokens=(self._kv_host.capacity_tokens
                            if self._kv_host else 0),
            heartbeat_rounds=every, watchdog=int(self._watchdog is not None),
            devledger=int(self._devledger.armed),
            persistent=int(self._persistent),
            persistent_cap=self._persistent_cap, tp_overlap=0)

    def _default_watchdog(self) -> obs.SLOBurnWatchdog:
        return obs.SLOBurnWatchdog(
            obs.WatchdogConfig.from_env(slo_ms=self._sched.slo_ms),
            label=self._label, trace=self._trace, emit=self._emit)

    def _emit(self, name: str, **fields) -> None:
        """The one emitter of serving events: kind ``serving``, the
        server's label and the allocation trace id (fields win on a
        collision)."""
        obs.emit("serving", name,
                 **{"server": self._label, "trace": self._trace, **fields})

    def _bind_histograms(self) -> None:
        """Resolve this server's labeled metric children once (again after
        :meth:`export_metrics` renames it)."""
        lab = dict(server=self._label)
        self._h_ttft = _family("ttft").labels(**lab)
        self._h_tok_lat = _family("tok_lat").labels(**lab)
        self._h_phase = {p: _family("phase").labels(phase=p, **lab)
                         for p in PHASES}
        self._h_loop = {p: _family("loop").labels(phase=p, **lab)
                        for p in LOOP_PHASES}
        for key in ("prefix_hits", "prefix_misses", "prefix_reused", "preempt",
                    "cow", "kv_demote", "kv_prefetch", "sched_chunk",
                    "sched_defer", "slo", "fused", "recover", "quarantine",
                    "stall"):
            setattr(self, f"_c_{key}", _family(key).labels(**lab))

    def _ledger_to(self, req: _Request, state: Optional[str],
                   now: Optional[float] = None) -> None:
        """Move ``req`` to lifecycle phase ``state``, accruing the time since
        its last transition into the phase it leaves; ``now`` stamps at a
        fence the caller holds. ``state=None`` closes the ledger; a closed
        ledger never accrues again."""
        if req.state is None:
            return
        if now is None:
            now = time.perf_counter()
        dt = now - req.t_state
        if dt > 0:
            req.phases[req.state] = req.phases.get(req.state, 0.0) + dt
        req.state = state
        req.t_state = now

    def _finish_trace(self, req: _Request, outcome: str,
                      reason: str = "") -> None:
        """Close a request's ledger and emit its one ``request_trace``: the
        six phase fields sum to ``wall_s`` (submit to this stamp) by
        construction. Observes the per-phase summaries of the phases the
        request spent time in."""
        if req.state is None:
            return
        now = time.perf_counter()
        self._ledger_to(req, None, now)
        wall = max(now - req.t_submit, 0.0)
        fields = {}
        for p in PHASES:
            v = req.phases.get(p, 0.0)
            fields[f"{p}_s"] = round(v, 6)
            if v > 0:
                self._phase_roll[p].observe(v)
                self._h_phase[p].observe(v)
        if reason:
            fields["reason"] = reason
        self._traces_emitted += 1
        self._emit("request_trace", rid=req.rid, outcome=outcome,
                   wall_s=round(wall, 6),
                   attributed_s=round(sum(req.phases.values()), 6),
                   tokens=len(req.out), prompt_len=len(req.prompt),
                   replays=req.replays, **fields)

    def _hb_counters(self) -> dict:
        """The cumulative counters the heartbeat turns into deltas."""
        tier = self.prefix_store
        paged_tier = isinstance(tier, PagedPrefixTier)
        return {
            "tokens": self._emitted - self._prefills,
            "prefills": self._prefills,
            "prefix_hits": self._prefix_hits,
            "prefix_misses": self._prefix_misses,
            "preemptions": self._preemptions,
            "recoveries": self._recoveries,
            "kv_demotions": self._host_demotions + (
                tier.demotions if paged_tier else 0),
            "kv_prefetches": self._host_prefetches + (
                tier.prefetches if paged_tier else 0),
            "slo_violations": self._sched.slo_violations,
            "sched_chunks": self._sched.chunks,
            "sched_defers": self._sched.defers,
        }

    def _hbm_components(self) -> dict:
        """The device bytes this server knows it holds, for the ledger's
        attribution; non-overlapping (a paged prefix tier lives inside the
        pool and counts 0; the host tier is host memory and stays out)."""
        store = self.prefix_store
        stage = self._stage
        draft_params, draft_arena = (self.draft[0], self.draft_arena
                                     ) if self.draft is not None else ({}, ())
        return {
            # A self draft's layers view the target's: counted once.
            "params": _storage_bytes([self.params, draft_params]),
            "kv_arena": _storage_bytes([self.kv_pool.arena if self.paged
                                        else self.arena, draft_arena]),
            "prefix_store": (_storage_bytes(store.arena)
                             if isinstance(store, PrefixStore) else 0),
            "resume_stage": _storage_bytes(stage.rows) if stage else 0,
            "decode_graph_pool": self._decode.pool_bytes + (
                self._round.pool_bytes if self._round is not None else 0),
        }

    def _tw_addresses(self) -> dict:
        """Where every parameter and arena (or pool) tensor lives: a decode
        graph freezes these addresses, so a move is the tripwire's
        reshard."""
        arena = self.kv_pool.arena if self.paged else self.arena
        return {i: t.data_ptr() for i, t in enumerate(
            _tensor_leaves(self.params) + _tensor_leaves(arena))}

    def _maybe_heartbeat(self, force: bool = False) -> None:
        """Emit the periodic ``serving_heartbeat`` when the cadence says so
        (``force`` flushes a partial interval at the end of a run), then
        feed it to the watchdog. Host state only."""
        if not self._hb_every:
            return
        lag = self._rounds - self._hb_round
        if lag < self._hb_every and not (force and lag > 0):
            return
        now = time.monotonic()
        interval_s = max(now - self._hb_t_last, 1e-9)
        snap = self._hb_counters()
        d = {k: snap[k] - self._hb_prev.get(k, 0) for k in snap}
        itl = self._tok_lat.summary()
        ttft = self._ttft.summary()
        pool, host = self.kv_pool, self._kv_host
        lookups = d["prefix_hits"] + d["prefix_misses"]
        phases = self._clock.snapshot()
        ph = {p: round(phases.get(p, 0.0) - self._clock_prev.get(p, 0.0), 6)
              for p in LOOP_PHASES[:-1]}
        ph[LOOP_PHASE_OTHER] = round(max(interval_s - sum(ph.values()), 0.0), 6)
        busy = sum(r is not None for r in self._slot_req)
        hb = {
            "round": self._rounds,
            "interval_rounds": lag,
            "interval_s": round(interval_s, 6),
            "tokens_delta": d["tokens"],
            "tokens_per_s": round(d["tokens"] / interval_s, 2),
            "prefills_delta": d["prefills"],
            "slots_busy": busy,
            "queued": len(self._queue),
            "preempted_waiting": len(self._preempted) if self.paged else 0,
            "batch_occupancy": round(busy / self.max_batch, 4),
            "kv_pool_occupancy": pool.occupancy() if pool else 0.0,
            "kv_pool_shard_occupancy": self._pool_shard_occupancy(),
            "kv_host_occupancy": host.occupancy() if host else 0.0,
            "kv_host_blocks": host.blocks_used if host else 0,
            "kv_host_tokens": host.capacity_tokens if host else 0,
            "prefix_store_occupancy": (self.prefix_store.occupancy()
                                       if self.prefix_store else 0.0),
            "prefix_hits_delta": d["prefix_hits"],
            "prefix_misses_delta": d["prefix_misses"],
            "prefix_hit_rate": (round(d["prefix_hits"] / lookups, 4)
                                if lookups else 0.0),
            "kv_demotions_delta": d["kv_demotions"],
            "kv_prefetches_delta": d["kv_prefetches"],
            "preemptions_delta": d["preemptions"],
            "recoveries_delta": d["recoveries"],
            "slo_violations_delta": d["slo_violations"],
            "sched_chunks_delta": d["sched_chunks"],
            "sched_defers_delta": d["sched_defers"],
            "itl_p50_ms": round(itl.get("p50", 0.0) * 1e3, 3),
            "itl_p99_ms": round(itl.get("p99", 0.0) * 1e3, 3),
            "ttft_p50_ms": round(ttft.get("p50", 0.0) * 1e3, 3),
            "ttft_p99_ms": round(ttft.get("p99", 0.0) * 1e3, 3),
            "slo_ms": self._sched.slo_ms,
            "tp": self._tp,
            "tp_degraded": int(self._tp < self._tp_initial),
            "decode_steps": self._decode_steps,
            "persistent": int(self._persistent),
            "delivered_steps": self._last_delivered,
            "tripwire_warmed": int(self._tw_warmed),
            "steady_state_compiles": self._steady_compiles,
            "steady_state_reshards": self._steady_reshards,
            "chips": tp_serving.allocation_chips(),
        }
        hb.update(self._sched.heartbeat_fields())
        hb.update({f"phase_{p}_s": v for p, v in ph.items()})
        hb.update(self._devledger.heartbeat_fields(interval_s))
        self._emit("serving_heartbeat", **hb)
        for p, v in ph.items():
            self._h_loop[p].observe(v)
        self._hb_count += 1
        self._hb_last = hb
        self._hb_prev = snap
        self._hb_round = self._rounds
        self._hb_t_last = now
        self._clock_prev = phases
        if self._watchdog is not None:
            self._watchdog.observe(hb)

    # ----- decode backend --------------------------------------------------

    def _resolve_decode_attn(self, choice: Optional[str]):
        """``(backend, reason)``: explicit argument > env > automatic. The
        config decides first, as in the JAX server: one the kernel cannot
        model decodes with the plain attention, and the reason says why;
        an explicit ``"cuda_paged"`` for it raises, an env one degrades.
        Otherwise the automatic pick is the kernel on CUDA and the plain
        attention on the CPU. A malformed env value is ignored, with a
        ``decode_attn_invalid`` event; the plain attention runs on the card
        otherwise only when asked for."""
        explicit = choice is not None
        if choice is None:
            raw = os.environ.get(ENV_DECODE_ATTN, "").strip()
            if raw and raw not in attention.DECODE_ATTN_BACKENDS:
                self._emit("decode_attn_invalid", reason=f"bad_env:{raw[:32]}")
            choice = raw if raw in attention.DECODE_ATTN_BACKENDS else None
        elif choice not in attention.DECODE_ATTN_BACKENDS:
            raise ValueError(f"unknown decode_attn {choice!r} "
                             f"(have {attention.DECODE_ATTN_BACKENDS})")
        if choice == BACKEND_REFERENCE:
            return choice, "forced"
        conflict = self._decode_attn_conflict()
        if conflict is not None:
            if explicit:
                raise ValueError(
                    f"decode_attn={BACKEND_PAGED!r} is incompatible with this "
                    f"server ({conflict})")
            return BACKEND_REFERENCE, conflict
        if choice is not None:
            return choice, "forced"
        if self.device.type != "cuda":
            return BACKEND_REFERENCE, "cpu_backend"
        return BACKEND_PAGED, ""

    def _decode_attn_conflict(self) -> Optional[str]:
        """Why this server cannot decode through the paged kernel, or None,
        in the JAX server's order: a ring (the kernel takes no slot
        positions), speculation (verify spans), then the masks the kernel
        does not model (a sliding window, the attention-logit softcap)."""
        if self.ring_kv:
            return "ring_kv"
        if self.speculative_k or self.draft is not None:
            return "speculative"
        return attention.decode_kernel_conflict(self.cfg)

    # ----- public API ------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int = 64) -> int:
        if self._draining:
            raise RuntimeError(
                f"server is draining ({self._drain_reason or 'requested'}): "
                "not accepting new requests")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds arena max_len ({self.max_len})")
        if self.device.type == "cuda" and len(prompt) > self.prefill_buckets[-1]:
            raise ValueError(
                f"prompt ({len(prompt)}) is longer than the largest prefill "
                f"bucket ({self.prefill_buckets[-1]}): on CUDA every prompt "
                "is padded to a bucket the flash kernel takes")
        rid = self._next_rid
        self._next_rid += 1
        now = time.perf_counter()
        # The ledger's queue phase starts at submit.
        self._queue.append(_Request(rid, prompt, max_new_tokens, t_submit=now,
                                    t_state=now))
        return rid

    def run(self) -> dict[int, np.ndarray]:
        """Drain queue and slots; returns ``{rid: generated tokens}``. The
        first drain is the tripwire's warm-up; every later one counts its
        compiles and reshards (:mod:`..compat.torchapi`) into
        ``steady_state_compiles``/``steady_state_reshards`` and emits
        ``tripwire_breach`` when either is nonzero."""
        armed = self.tripwire and self._tw_warmed
        try:
            with torchapi.compile_tripwire(enabled=armed,
                                           addresses=self._tw_addresses) as tw:
                while self.step():
                    pass
        finally:
            self._tw_warmed = True
            if armed:
                self._steady_compiles += tw.compiles
                self._steady_reshards += tw.transfers
                if tw.compiles or tw.transfers:
                    self._emit("tripwire_breach", compiles=tw.compiles,
                               reshards=tw.transfers)
        out, self._results = self._results, {}
        return out

    def failures(self) -> dict[int, str]:
        """Per-request terminal failures, ``{rid: error}``: the requests a
        drain failed before they started (or a preempted one the drained
        pool could not re-admit), those quarantined after
        ``quarantine_after`` consecutive faults, and every unfinished one
        when a permanent fault left no degraded configuration (reason
        ``chip_lost``). Every submitted rid ends in exactly one of the
        results and this."""
        return dict(self._failures)

    def request_drain(self, reason: str = "api") -> None:
        """Stop admitting queued work (idempotent): lanes in flight and
        preempted requests run to their end, then the queue fails into
        :meth:`failures`; :meth:`submit` refuses from now on."""
        if self._draining:
            return
        self._drain_reason = reason
        self._draining = True

    def drain(self, reason: str = "api") -> dict[int, np.ndarray]:
        """:meth:`request_drain`, then :meth:`run`: the completed results;
        everything that never started is in :meth:`failures`."""
        self.request_drain(reason)
        return self.run()

    def stats(self) -> dict:
        """Cumulative serving counters; keys keep the JAX server's names.
        The paged-pool keys are always present (zeros when slotted).
        ``lanes_busy_peak`` and ``kv_pool_occupancy_peak`` are this
        package's own: the most lanes that decoded in one round and the
        fullest the pool was at a dispatch; so are the ``decode_graph_*``
        keys: captures and replays of the decode chunk (both 0 on the CPU),
        the capture's seconds and its graph pool's bytes; and the
        ``delivered_lane_steps``, ``persistent_steps_executed`` and
        ``persistent_graph_*`` keys: the tokens persistent rounds
        delivered to live lanes, the steps they ran (delivered or past an
        exit), and the captures and replays of their graph. The
        scheduler's ``sched_*``, ``fused_*`` and persistent keys are the
        JAX server's, as are the prefix, copy-on-write and host-tier keys
        (zeros when the feature is off): ``prefix_hit_ratio`` is hits over
        this server's admitted lookups, ``kv_demotions`` and
        ``kv_prefetches`` count the tier's segment moves and the
        preemption spills and resumes a host tier accounts. So is
        ``kv_resume_staged``: the resumes that landed a staged upload. So
        are the occupancy keys (``tokens_per_round``, ``slots_busy``,
        ``queued``, ``batch_occupancy``, ``kv_slot_utilization``), the
        layout and the tensor-parallel keys (``kv_layout``,
        ``kv_pool_shards``, ``tp_degree``, ``tp_degraded``, ``tp_shrinks``,
        ``kv_pool_shard_occupancy``: one entry a shard, zeros at ``tp=1``
        and on slotted servers); ``kv_pool_shard_occupancy_peak`` is this
        package's own, each shard's fullest at a dispatch. ``arena_bytes``
        counts the one copy the shards share on this device."""
        pool, exe, rnd = self.kv_pool, self._decode, self._round
        old_exe, old_rnd = (self._retired_graphs[k] for k in ("_decode", "_round"))
        store, host = self.prefix_store, self._kv_host
        tier = store if isinstance(store, PagedPrefixTier) else None
        lookups = self._prefix_hits + self._prefix_misses
        arena_bytes = cache_bytes(pool.arena if pool else self.arena)
        busy = [b for b in range(self.max_batch) if self._slot_req[b] is not None]
        decoded = self._emitted - self._prefills
        return {
            "rounds": self._rounds,
            "decode_steps": self._decode_steps,
            "prefills": self._prefills,
            "prefill_batches": self._batch_prefills,
            "tokens_emitted": self._emitted,
            "tokens_per_round": (round(decoded / self._rounds, 3)
                                 if self._rounds else 0.0),
            "slots_busy": len(busy),
            "queued": len(self._queue),
            "batch_occupancy": round(len(busy) / self.max_batch, 4),
            # Mean cache fill of the busy lanes: positions over the arena
            # length (a ring's, its first window plus the margin).
            "kv_slot_utilization": round(float(np.mean(
                [min(1.0, self._pos[b] / self._arena_len()) for b in busy])), 4)
            if busy else 0.0,
            "ttft_s": self._ttft.summary(),
            "decode_token_s": self._tok_lat.summary(),
            "arena_bytes": arena_bytes,
            "decode_backend": self._decode_attn,
            "decode_backend_reason": self._decode_attn_reason,
            "kv_quant": "int8" if self.kv_quant else "bf16",
            "kv_pool_occupancy": pool.occupancy() if pool else 0.0,
            "kv_blocks_in_use": pool.blocks_in_use if pool else 0,
            "kv_blocks_total": pool.blocks_total if pool else 0,
            "kv_pool_tokens": pool.capacity_tokens if pool else 0,
            "preemptions": self._preemptions,
            "preempted_waiting": len(self._preempted),
            "lanes_busy_peak": self._lanes_peak,
            "kv_pool_occupancy_peak": self._occupancy_peak,
            "failed_requests": len(self._failures),
            "draining": self._draining,
            "decode_graph_captures": exe.captures + old_exe[0],
            "decode_graph_replays": exe.replays + old_exe[1],
            "decode_graph_capture_s": round(exe.capture_s, 6),
            "decode_graph_pool_bytes": exe.pool_bytes,
            **self._sched.stats(),
            "fused_enabled": int(self._fused_ok),
            "fused_admissions": self._fused_admissions,
            "persistent": int(self._persistent),
            "persistent_cap": self._persistent_cap,
            "persistent_rounds": self._persistent_rounds,
            "delivered_steps": self._last_delivered,
            "delivered_steps_total": self._delivered_total,
            "persistent_exits": dict(self._persistent_exits),
            "delivered_lane_steps": self._delivered_lane_steps,
            "persistent_steps_executed": (rnd.executed_total + old_rnd[2]
                                          if rnd else 0),
            "persistent_graph_captures": rnd.captures + old_rnd[0] if rnd else 0,
            "persistent_graph_replays": rnd.replays + old_rnd[1] if rnd else 0,
            "prefix_hits": self._prefix_hits,
            "prefix_misses": self._prefix_misses,
            "prefix_tokens_reused": self._prefix_tokens_reused,
            "prefix_hit_ratio": (round(self._prefix_hits / lookups, 4)
                                 if lookups else 0.0),
            "prefix_store_tokens": store.tokens_used if store else 0,
            "prefix_store_occupancy": store.occupancy() if store else 0.0,
            # The paged tier has no arena of its own: its footprint is the
            # share of the pool its segments' blocks hold.
            "prefix_store_bytes": (
                arena_bytes * tier.blocks_used // pool.num_blocks if tier
                else cache_bytes(store.arena) if store else 0),
            "cow_copies": self._cow_copies,
            "kv_host_tokens": host.capacity_tokens if host else 0,
            "kv_host_blocks": host.blocks_used if host else 0,
            "kv_demotions": self._host_demotions + (tier.demotions if tier else 0),
            "kv_prefetches": (self._host_prefetches
                              + (tier.prefetches if tier else 0)),
            "kv_resume_staged": self._resume_staged,
            "kv_layout": self._kv_layout,
            "kv_pool_shards": pool.shards if pool else 1,
            "tp_degree": self._tp,
            "tp_degraded": int(self._tp < self._tp_initial),
            "tp_shrinks": self._tp_shrinks,
            "recoveries": self._recoveries,
            "quarantined": self._quarantined_n,
            "device_stalls": self._stalls,
            "checkpoints": self._checkpoints,
            "checkpoint_rounds": self._ckpt_every,
            "kv_pool_shard_occupancy": self._pool_shard_occupancy(),
            "kv_pool_shard_occupancy_peak": list(self._shard_peak),
            **self._spec_stats(),
            **self._telemetry_stats(),
        }

    def _spec_stats(self) -> dict:
        """``draft_acceptance`` on a speculative server (the JAX server's
        key, absent otherwise): accepted drafts over drafts offered, 0.0
        before the first round."""
        if not self.speculative_k:
            return {}
        return {"draft_acceptance": (
            round(self._drafts_accepted / self._drafts_offered, 4)
            if self._drafts_offered else 0.0)}

    def _telemetry_stats(self) -> dict:
        """The telemetry keys of :meth:`stats`, the JAX server's: the trace
        id and request-ledger summaries, the tripwire's counts, the
        heartbeat and watchdog, and the device ledger (``hbm_*`` inside
        ``devledger`` only where the device reports memory)."""
        wd = self._watchdog.stats() if self._watchdog is not None else {
            "alerts": 0, "active": [], "observed": 0, "last_dump": ""}
        return {
            "trace": self._trace,
            "request_traces": self._traces_emitted,
            "request_phase_s": {p: self._phase_roll[p].summary()
                                for p in PHASES},
            "tripwire_enabled": int(self.tripwire),
            "tripwire_warmed": int(self._tw_warmed),
            "steady_state_compiles": self._steady_compiles,
            "steady_state_reshards": self._steady_reshards,
            "heartbeats": self._hb_count,
            "heartbeat_rounds": self._hb_every,
            "heartbeat_tokens_per_s": (self._hb_last.get("tokens_per_s", 0.0)
                                       if self._hb_last else 0.0),
            "loop_phase_s": {p: round(v, 6)
                             for p, v in self._clock.snapshot().items()},
            "watchdog_alerts": wd["alerts"],
            "watchdog_active": len(wd["active"]),
            "watchdog": wd,
            **self._devledger.stats_fields(),
        }

    def export_metrics(self, port: int = 0, label: Optional[str] = None) -> str:
        """Expose :meth:`stats` as ``kata_tpu_serving_*`` gauges read at
        scrape time, beside the histograms and counters the server feeds
        as it runs (the JAX server's families, :mod:`..obs.metrics`).
        ``port > 0`` also starts the ``/metrics`` endpoint (one a process).
        ``label`` renames this server (call it before traffic so samples
        land under the final label). Returns the label."""
        if label:
            self._label = label
            self._bind_histograms()
        for name, doc in _PROM_STATS:
            obs.gauge(f"kata_tpu_serving_{name}", doc, ["server"]).labels(
                server=self._label).set_function(
                    lambda self=self, n=name: float(self.stats().get(n, 0.0)))

        def shard_occ(i: int) -> float:
            occ = self._pool_shard_occupancy()
            return float(occ[i]) if i < len(occ) else 0.0

        for i in range(max(1, self._tp)):
            _family("shard_occ").labels(server=self._label, shard=str(i)) \
                .set_function(partial(shard_occ, i))
        for be in attention.DECODE_ATTN_BACKENDS:
            _family("backend").labels(server=self._label, backend=be) \
                .set_function(lambda be=be: float(self._decode_attn == be))

        def headroom() -> float:
            v = self._devledger.hbm_headroom()
            return float(v) if v is not None else float("nan")

        _family("headroom").labels(server=self._label).set_function(headroom)
        if port:
            obs.serve(port)
        return self._label

    def _pool_shard_occupancy(self) -> list:
        """Each shard's pool fill, ``tp`` entries: the sub-pools' own under
        the blocks layout, the pool's under heads (every block spans every
        shard), zeros at ``tp=1`` and on slotted servers."""
        if self._tp <= 1 or self.kv_pool is None:
            return [0.0] * self._tp
        if self.kv_pool.shards > 1:
            return self.kv_pool.shard_occupancy()
        return [self.kv_pool.occupancy()] * self._tp

    # ----- admission -------------------------------------------------------

    def _admit(self) -> None:
        """:meth:`_admit_unguarded` in the loop's ``admit`` phase, as one of
        strict mode's sanctioned sync regions: the prompt's upload and the
        first token's read are synchronous by nature."""
        with self._clock.section(LOOP_PHASE_ADMIT), \
                torchapi.allow_transfer("admission prefill + first-token read"):
            self._admit_unguarded()

    def _admit_unguarded(self) -> None:
        """Refill free slots from the queue, FIFO (:meth:`_take`), one
        forward per group: prefix hits on one segment at one match length
        and padded suffix share a ``prefill_suffix``, the rest a
        ``prefill_batch`` per padded length; hits run first, as in the JAX
        server. Loops because a request can finish during its own prefill
        (eos or a 1-token budget) and free its slot again. Paged: preempted
        requests are older than anything queued and resume first. A
        chunked admission in progress goes first of all (head-of-line), and
        the policy may start one instead of a whole pass; at most one chunk
        runs per pass while it defers."""
        pass_chunks = 0
        while True:
            if self._partial is not None:
                # Started work: it advances through a drain too.
                done, pass_chunks = self._advance_partial(pass_chunks)
                if not done:
                    return
                continue
            if not (self._queue or self._preempted):
                return
            free = [b for b in range(self.max_batch) if self._slot_req[b] is None]
            if not free:
                return
            if self._preempted and (
                    not self._queue
                    or self._preempted[0].req.rid < self._queue[0].rid):
                with self._clock.section(LOOP_PHASE_HOST):
                    resumed = self._resume_one(free[0])
                if resumed:
                    continue
                if self._draining and len(free) == self.max_batch:
                    # Every lane is free and the pool still cannot hold
                    # the spill: it never can, so the drain fails it.
                    self._fail_preempted(f"drained mid-flight "
                                         f"({self._drain_reason}): cannot "
                                         "re-admit")
                    continue
                return  # strict FIFO: nothing admits past it
            if self._draining and not self._queue[0].replays:
                # Queued work that never started: _finish_drain fails it.
                # Crash-recovery replays started: they admit and finish.
                return
            directive = self._sched.directive(
                live_lanes=sum(r is not None for r in self._slot_req),
                pending_tokens=self._cold_cost(self._queue[0]))
            if not directive.admit:
                if not self._start_partial():
                    return  # paged reservation failed: head-of-line wait
                continue  # the partial branch runs this pass's chunk
            take = self._take(len(free))
            if not take:
                return
            hit_groups: dict[tuple, list] = {}
            groups: dict[int, list] = {}
            for req, hit in take:
                if hit is None:
                    groups.setdefault(self._cold_cost(req), []).append(req)
                    continue
                pad = self._suffix_pad(hit.length, len(req.prompt) - hit.length)
                hit_groups.setdefault((id(hit.segment), hit.length, pad),
                                      []).append((req, hit))
            it = iter(free)
            for (_seg, _m, pad_len), pairs in hit_groups.items():
                for part in self._prefill_groups(pairs):
                    reqs, hits = zip(*part)
                    self._admit_current = list(reqs)
                    self._fill_slots([next(it) for _ in reqs], list(reqs),
                                     pad_len, list(hits))
            for pad_len, reqs in groups.items():
                for part in self._prefill_groups(reqs):
                    self._admit_current = list(part)
                    self._fill_slots([next(it) for _ in part], part, pad_len)
            self._admitting = []
            self._admit_current = []

    def _prefill_groups(self, group: list) -> list:
        """One admission group's prefill forwards: the whole group in one,
        or, on a ring or draft server, one request a forward."""
        if self._can_batch_prefill:
            return [list(group)]
        return [[x] for x in group]

    def _take(self, n_free: int) -> list:
        """Pop one pass's admitted set: the FIFO prefix of the queue that
        fits ``n_free`` lanes and, paged, whose block reservations succeed;
        the first request the pool cannot hold stays at the head and ends
        the pass. Each lookup pins its hit, and a failed reservation undoes
        the lookup wholly. Returns ``[(request, hit or None)]``, which is
        also ``_admitting``: a request leaves the queue and joins it in one
        step, so a fault anywhere before its lane finds it there. While a
        request is reserved, a fault blames it alone. Draining, only
        crash-recovery replays are taken."""
        take = self._admitting = []
        while self._queue and len(take) < n_free:
            req = self._queue[0]
            if self._draining and not req.replays:
                break
            self._admit_current = [req]
            hit = self._prefix_lookup_raw(req)
            try:
                reserved = not self.paged or self._reserve_lane_blocks(req, hit)
            except BaseException:
                if self.prefix_store is not None:
                    self.prefix_store.unlookup(hit)
                raise
            self._admit_current = []
            if not reserved:
                if self.prefix_store is not None:
                    self.prefix_store.unlookup(hit)
                break
            self._count_prefix(hit)
            self._queue.popleft()
            self._sched.note_queue_delay(time.perf_counter() - req.t_submit)
            if req.state != PHASE_RECOVERY:
                # Admission granted; a replay stays in recovery until its
                # first token.
                self._ledger_to(req, PHASE_PREFILL)
            take.append((req, hit))
        return take

    # ----- prefix cache ----------------------------------------------------

    def _prefix_lookup_raw(self, req: _Request) -> Optional[PrefixHit]:
        """The store's lookup without the server's counters (a paged
        reservation may still undo it), pinned; None when the store is off
        or nothing usable is cached. A hit whose suffix fits no bucket
        inside ``max_len`` while the whole prompt fits one is cancelled:
        cold bucketed admission keeps the bounded shapes."""
        if self.prefix_store is None:
            return None
        hit = self.prefix_store.lookup(req.prompt)
        if hit is not None:
            n = len(req.prompt)
            if (self._suffix_bucket(hit.length, n - hit.length) is None
                    and any(k >= n for k in self.prefill_buckets)):
                self.prefix_store.cancel(hit)
                hit = None
        return hit

    def _count_prefix(self, hit: Optional[PrefixHit]) -> None:
        """The server's counters for one admitted lookup (none when the
        store is off)."""
        if self.prefix_store is None:
            return
        if hit is None:
            self._prefix_misses += 1
            self._c_prefix_misses.inc()
            return
        self._prefix_hits += 1
        self._prefix_tokens_reused += hit.length
        self._c_prefix_hits.inc()
        self._c_prefix_reused.inc(hit.length)

    def _suffix_bucket(self, m: int, s_len: int) -> Optional[int]:
        """The smallest bucket that holds a suffix of ``s_len`` after a match
        of ``m`` inside ``max_len``, or None."""
        return next((k for k in self.prefill_buckets
                     if k >= s_len and m + k <= self.max_len), None)

    def _suffix_pad(self, m: int, s_len: int) -> int:
        """The padded suffix length of a hit at ``m``: its
        :meth:`_suffix_bucket`, or the exact length when none fits."""
        pad = self._suffix_bucket(m, s_len)
        return pad if pad is not None else s_len

    def _commit(self, slots: list[int], reqs: list, caches) -> None:
        """Write one admission forward's cache rows to their lanes (slotted
        arena or reserved pool blocks), then insert each prompt into the
        prefix cache."""
        if not self.paged:
            _write_slots(self.arena, caches, torch.as_tensor(
                slots, dtype=torch.long, device=self.device))
        elif len(reqs) == 1:
            self._paged_commit(slots[0], reqs[0], caches, 0)
        else:
            self._paged_commit_batch(slots, reqs, caches)
        if self.prefix_store is not None:
            for i, req in enumerate(reqs):
                self.prefix_store.insert(req.prompt, caches, i)

    def _fill_slots(self, slots: list[int], reqs: list, pad_len: int,
                    hits: Optional[list] = None) -> None:
        """Admit N requests in one ``[N, pad_len]`` forward and write their
        caches to the lanes. Cold (``hits`` None): a ``prefill_batch`` of
        the bucket-padded prompts. Prefix hits on one segment at one match
        length ``m``: the prefix rows copied into fresh caches (one copy
        fanned out to N rows) and a ``prefill_suffix`` of the padded rest
        at offset ``m`` (plain attention over the cache, the JAX rule).
        Each prompt is then inserted into the prefix cache, which for a hit
        deepens the store where the prompt reaches a bucket past the
        match."""
        n = len(reqs)
        m = hits[0].length if hits else 0
        tokens = np.zeros((n, pad_len), np.int32)
        true_lens = np.array([len(r.prompt) - m for r in reqs], np.int32)
        for i, req in enumerate(reqs):
            tokens[i, : true_lens[i]] = req.prompt[m:]
        # The JAX server's spans and ttft fields: one request takes its
        # single-request path's names, N >= 2 the batched ones.
        attrs = dict(trace_id=self._trace, server=self._label)
        if n == 1:
            attrs.update(rid=reqs[0].rid, slot=slots[0])
            if hits:
                name = "serving.prefill_suffix"
                attrs.update(prompt_len=len(reqs[0].prompt), reused=m,
                             suffix_len=int(true_lens[0]), padded_len=pad_len,
                             tokens=int(true_lens[0]))
            else:
                name = "serving.prefill"
                attrs.update(prompt_len=int(true_lens[0]), padded_len=pad_len,
                             tokens=int(true_lens[0]))
        else:
            name = ("serving.prefill_suffix_batch" if hits
                    else "serving.prefill_batch")
            attrs.update(n=n, **({"reused": m} if hits else {}),
                         padded_len=pad_len, tokens=int(true_lens.sum()),
                         rids=[r.rid for r in reqs], slots=list(slots))
        ev = {"batched": n} if n >= 2 else {}
        if hits:
            ev["prefix_reused"] = m
        self._inj.fire("prefill")
        with obs.span(name, **attrs) as sp:
            tokens = torch.from_numpy(tokens).to(self.device)
            if hits:
                self._inj.fire("store_gather")
                caches = self.prefix_store.materialize(hits[0], self.max_len,
                                                       n=n)
                _c, last_logits, _pos = prefill_suffix(
                    self.params, tokens, self.cfg, caches, m,
                    return_logits=True,
                    true_len=torch.from_numpy(true_lens).to(self.device))
            else:
                caches, last_logits, _pos = prefill_batch(
                    self.params, tokens, self.cfg, pad_len,
                    torch.from_numpy(true_lens), kv_quantized=self.kv_quant)
            # The first tokens' transfer fences the forward.
            firsts = _next_token(last_logits, self.generator, self._do_sample,
                                 self._temp_dev, self.top_k,
                                 self.top_p).cpu().numpy()
        t_first = time.perf_counter()
        self._sched.note_prefill(n * pad_len, sp.duration_s)
        self._inj.fire("admission_commit")
        if self.ring_kv:
            caches = fold_prefill(caches, int(true_lens[0]), self.cfg,
                                  self.max_len, self._ring_margin)
        self._commit(slots, reqs, caches)
        if self.draft is not None:
            # The draft prefills the same prompt into its own arena rows, so
            # its cache tracks the lane's positions from the first round.
            d_params, d_cfg = self.draft
            d_caches, _l, _p = prefill_batch(
                d_params, tokens, d_cfg, pad_len, torch.from_numpy(true_lens))
            _write_slots(self.draft_arena, d_caches, torch.as_tensor(
                slots, dtype=torch.long, device=self.device))
        if n >= 2:
            self._batch_prefills += 1
        for i, (b, req) in enumerate(zip(slots, reqs)):
            self._finish_admission(b, req, int(firsts[i]), m + int(true_lens[i]),
                                   t_first, hit=hits[i] if hits else None, **ev)

    def _finish_admission(self, b: int, req: _Request, first: int, pos: int,
                          t_first: float, hit: Optional[PrefixHit] = None,
                          **event_fields) -> None:
        """The admission epilogue every fill path shares: the first token,
        the ledger's move to decode at the first-token fence ``t_first``,
        TTFT and its ``ttft`` event (``event_fields`` extend it), the lane's
        state, and the immediate-finish check."""
        req.out.append(first)
        self._prefills += 1
        self._emitted += 1
        self._ledger_to(req, self._decode_state(), now=t_first)
        ttft = t_first - req.t_submit
        self._ttft.observe(ttft)
        self._h_ttft.observe(ttft)
        if req.replays:
            # A crash-recovery replay: its TTFT holds the recovery, and
            # says so.
            event_fields = {**event_fields, "replay": req.replays}
        self._emit("ttft", rid=req.rid, ttft_s=round(ttft, 6),
                   prompt_len=len(req.prompt), queued=len(self._queue),
                   **event_fields)
        self._slot_req[b] = req
        self._slot_prefix[b] = hit  # pinned until the request finishes
        self._pos[b] = pos
        self._last[b] = first
        self._fresh_rows.add(b)  # overlap: override the in-flight row
        # In a lane: no longer mid-admission for a crash unwind.
        self._admitting = [(r, h) for r, h in self._admitting if r is not req]
        self._maybe_finish(b, [first])

    # ----- chunked admission -----------------------------------------------

    def _cold_cost(self, req: _Request) -> int:
        """The padded prefill tokens a whole admission of ``req`` runs: the
        policy's projection input."""
        n = len(req.prompt)
        return next((k for k in self.prefill_buckets if k >= n), None) or n

    def _start_partial(self) -> bool:
        """Begin a chunked admission of the queue head: look it up and
        reserve its blocks (paged) as a whole admission would, then park it
        as the partial with caches of its own, a hit's prefix rows already
        in them; :meth:`_advance_partial` runs its chunks from there. False
        when the pool cannot hold it: it stays queued."""
        take = self._take(1)
        if not take:
            return False
        req, hit = take[0]
        if hit is not None:
            self._inj.fire("store_gather")
            caches = self.prefix_store.materialize(hit, self.max_len)
        else:
            caches = init_kv_caches(self.cfg, 1, self.max_len,
                                    device=self.device, quantized=self.kv_quant)
        m = hit.length if hit else 0
        self._partial = _PartialPrefill(req=req, hit=hit, caches=caches,
                                        offset=m, reused=m)
        return True

    def _advance_partial(self, ran: int = 0) -> tuple[bool, int]:
        """Advance the chunked admission. While the policy defers it runs
        at most one chunk a pass (``ran`` counts the chunks this pass has
        run already), or, fused, arms the next decode dispatch to carry
        the chunk; once the policy admits it runs the rest. Returns
        ``(landed in a lane, ran)``."""
        self._fuse_pending = False  # decided afresh every pass
        while True:
            p = self._partial
            remaining = len(p.req.prompt) - p.offset
            if remaining <= 0:
                return False, ran  # the final slice rides a dispatch in flight
            live = sum(r is not None for r in self._slot_req)
            d = self._sched.directive(live_lanes=live, pending_tokens=remaining,
                                      partial=True)
            if not d.admit:
                if d.fused and self._fused_ok and live > 0:
                    # Still a deferral: the slice rides the next dispatch.
                    self._fuse_pending = True
                    self._note_defer(p, remaining, d, fused=1)
                    return False, ran
                if ran:
                    return False, ran  # one chunk per decode dispatch
                self._note_defer(p, remaining, d)
            done = self._prefill_one_chunk(p)
            ran += 1
            if done:
                return True, ran

    def _note_defer(self, p: _PartialPrefill, remaining: int, d,
                    **fields) -> None:
        self._sched.defers += 1
        self._c_sched_defer.inc()
        self._emit("sched_defer", rid=p.req.rid, offset=p.offset,
                   remaining=remaining, queued=len(self._queue),
                   projected_itl_ms=d.projected_itl_ms,
                   slo_ms=self._sched.slo_ms, **fields)

    def _slice_geometry(self, p: _PartialPrefill) -> tuple:
        """The slice rule both chunk paths share: ``chunk_tokens`` wide,
        right-padded, exact width where padding would pass ``max_len``.
        Returns ``(suffix, take, width)``."""
        n = len(p.req.prompt)
        c = self._sched.chunk_tokens
        take = min(c, n - p.offset)
        width = c if p.offset + c <= self.max_len else take
        suffix = np.zeros(width, np.int32)
        suffix[:take] = p.req.prompt[p.offset:p.offset + take]
        return suffix, take, width

    def _run_slice(self, p: _PartialPrefill, suffix: np.ndarray, offset: int,
                   take: int) -> torch.Tensor:
        """One ``prefill_suffix`` slice into the partial's caches, in
        place: the slice's last-position logits ``[1, vocab]``."""
        tokens = self._host_tensor(suffix[None, :], torch.int64).to(
            self.device, non_blocking=True)
        _caches, logits, _pos = prefill_suffix(
            self.params, tokens, self.cfg, p.caches, offset,
            return_logits=True, true_len=take)
        return logits

    def _prefill_one_chunk(self, p: _PartialPrefill) -> bool:
        """Run one slice of the chunked admission now, fenced (the pass's
        budget is wall time); the final slice samples the first token and
        lands the admission. True when it landed."""
        suffix, take, width = self._slice_geometry(p)
        last = p.offset + take >= len(p.req.prompt)
        first = None
        # A fault in this chunk blames its request alone.
        self._admit_current = [p.req]
        self._inj.fire("sched_tick")
        self._inj.fire("prefill")
        with obs.span("serving.prefill_chunk", trace_id=self._trace,
                      server=self._label, rid=p.req.rid, offset=p.offset,
                      chunk_len=take, padded_len=width, tokens=take) as sp:
            logits = self._run_slice(p, suffix, p.offset, take)
            if last:
                first = int(self._sample_first(logits))
            else:
                self._fence_stream(seam="fence")  # watchdog-bounded
        t_done = time.perf_counter()
        p.offset += take
        p.chunks += 1
        self._sched.chunks += 1
        self._c_sched_chunk.inc()
        self._sched.note_prefill(width, sp.duration_s)
        if not last:
            self._admit_current = []
            return False
        self._commit_partial(p, first, t_done)
        return True

    def _sample_first(self, logits: torch.Tensor) -> int:
        return int(_next_token(logits, self.generator, self._do_sample,
                               self._temp_dev, self.top_k, self.top_p)[0])

    def _commit_partial(self, p: _PartialPrefill, first: int,
                        t_first: float) -> None:
        """Land a finished chunked admission in a free lane (free by
        construction: one was free when it started, and nothing fills
        lanes while it is head-of-line), the same way for the inline and
        the fused final slice."""
        req = p.req
        self._inj.fire("admission_commit")
        b = next(i for i in range(self.max_batch) if self._slot_req[i] is None)
        self._commit([b], [req], p.caches)
        self._partial = None
        if p.fused:
            self._fused_admissions += 1
            self._c_fused.inc()
        self._finish_admission(b, req, first, len(req.prompt), t_first,
                               hit=p.hit, prefix_reused=p.reused,
                               chunked=p.chunks, fused=p.fused)
        self._admit_current = []

    def _prepare_fused_chunk(self) -> Optional[tuple]:
        """Take the pending slice for a fused dispatch, advancing the
        partial's offset and counters at dispatch. Returns ``(suffix,
        offset, take, width, is_last)``, or None when none is pending."""
        if not (self._fuse_pending and self._fused_ok
                and self._partial is not None):
            self._fuse_pending = False
            return None
        self._fuse_pending = False
        p = self._partial
        n = len(p.req.prompt)
        if p.offset >= n:
            return None  # the final slice is already in flight
        # The slice's request joins the dispatch's blame cohort until its
        # record is made.
        self._fused_blame = p.req
        suffix, take, width = self._slice_geometry(p)
        self._inj.fire("sched_tick")
        offset = p.offset
        p.offset += take
        p.chunks += 1
        p.fused += 1
        self._sched.chunks += 1
        self._c_sched_chunk.inc()
        return suffix, offset, take, width, p.offset >= n

    def _apply_fused(self, fc: Optional[_FusedChunk]) -> None:
        """Land a slice that rode a decode dispatch, at its retire: only
        the final slice has work left, sampling the first token from the
        slice's logits and committing the admission."""
        if fc is None or not fc.last or self._partial is not fc.partial:
            return
        with torchapi.allow_transfer("fused admission commit + first token"):
            first = self._sample_first(fc.logits)
            self._admit_current = [fc.partial.req]
            self._commit_partial(fc.partial, first, time.perf_counter())

    def _maybe_finish(self, b: int, new_tokens: list) -> None:
        req = self._slot_req[b]
        if req is None:
            return
        hit_eos = self.eos_id is not None and self.eos_id in new_tokens
        if hit_eos:
            req.out = req.out[: req.out.index(self.eos_id) + 1]
        if hit_eos or len(req.out) >= req.max_new_tokens:
            req.out = req.out[: req.max_new_tokens]
            self._results[req.rid] = np.asarray(req.out, np.int32)
            req.done = True
            self._finish_trace(req, outcome="completed")
            self._slot_req[b] = None
            self._release_prefix(b)
            if self.paged:
                # The table resets to SCRATCH, so what this lane still
                # writes in the round lands in the scratch block.
                self._free_lane(b)

    # ----- paged pool scheduling -------------------------------------------

    def _set_lane_table(self, b: int, table: list) -> None:
        """The one writer of a lane's block table. Entries past the
        allocation stay SCRATCH; positions <= pos always sit inside the
        allocation by construction."""
        self._lane_blocks[b] = list(table)
        self._bt_host[b, : len(table)] = table
        self._bt_host[b, len(table):] = SCRATCH_BLOCK

    def _free_lane(self, b: int) -> None:
        """Drop the lane's block references: private blocks return to the
        pool now, tier-shared ones once the tier and every other lane let
        go."""
        self.kv_pool.unref(self._lane_blocks[b])
        self._set_lane_table(b, [])

    def _release_prefix(self, b: int) -> None:
        """Unpin the lane's prefix hit: its segment may be evicted again
        once no other request holds it."""
        hit, self._slot_prefix[b] = self._slot_prefix[b], None
        if hit is not None:
            self.prefix_store.release(hit)

    def _alloc_blocks(self, n: int) -> Optional[list]:
        """``n`` pool blocks, evicting (or, with a host tier, demoting)
        unpinned prefix-tier segments LRU first under pressure; None when
        live state holds everything. Every allocation for a lane comes
        through here, so the tier always gives way before a preemption.
        The ``pool_alloc`` seam."""
        self._inj.fire("pool_alloc")
        got = self.kv_pool.try_alloc(n)
        while got is None:
            tier = self.prefix_store
            if not isinstance(tier, PagedPrefixTier):
                return None
            with torchapi.allow_transfer("kv host tier demotion under pool "
                                         "pressure"):
                if not tier.evict_one():
                    return None
            got = self.kv_pool.try_alloc(n)
        return got

    def _reserve_lane_blocks(self, req: _Request,
                             hit: Optional[PrefixHit] = None) -> bool:
        """Reserve the blocks ``req``'s admission scatter needs, those of
        its bucket-padded rows, BEFORE its prefill forward runs: a failed
        reservation must leave the request queued, not waste a forward. A
        hit shares the tier segment's fully covered blocks and gets private
        ones for the rest, the copy-on-write boundary block among them when
        the match is not block-aligned. The plan waits in ``_plans`` until
        the fill path commits it."""
        n = len(req.prompt)
        shared: list = []
        if hit is not None:
            rows = hit.length + self._suffix_pad(hit.length, n - hit.length)
            shared = self.prefix_store.shared_blocks(hit)
        else:
            rows = self._cold_cost(req)
        priv = self._alloc_blocks(-(-rows // self.kv_block) - len(shared))
        if priv is None:
            return False
        self.kv_pool.ref(shared)
        if hit is not None and hit.length % self.kv_block:
            self._cow_copies += 1
            self._c_cow.inc()
        self._plans[req.rid] = _LanePlan(shared + priv, len(shared))
        return True

    def _paged_commit(self, b: int, req: _Request, caches, row: int) -> None:
        """Land one admission's cache row in its reserved private blocks and
        install the lane table. Shared tier blocks are masked with SCRATCH
        in the scatter: other lanes read their rows, which must not be
        written again."""
        plan = self._plans.pop(req.rid)
        scatter = [SCRATCH_BLOCK] * plan.n_shared + plan.table[plan.n_shared:]
        pool_write_seq(self.kv_pool.arena, caches, row,
                       table_tensor(scatter, self.device), self.kv_block)
        self._set_lane_table(b, plan.table)

    def _paged_commit_batch(self, slots: list[int], reqs: list, caches) -> None:
        """Batched :meth:`_paged_commit`: one scatter per leaf for a whole
        admission group, shared entries masked with SCRATCH per row and
        tables padded with SCRATCH to the widest plan; masked and pad
        entries collide only on SCRATCH, which nothing reads, and never
        touch the ZERO block."""
        plans = [self._plans.pop(req.rid) for req in reqs]
        width = max(len(p.table) for p in plans)
        tables = np.full((len(plans), width), SCRATCH_BLOCK, np.int32)
        for i, plan in enumerate(plans):
            tables[i, plan.n_shared:len(plan.table)] = plan.table[plan.n_shared:]
        pool_write_batch(self.kv_pool.arena, caches,
                         table_tensor(tables, self.device), self.kv_block)
        for b, plan in zip(slots, plans):
            self._set_lane_table(b, plan.table)

    def _preempt_lane(self, b: int, reason: str = "pool_exhausted") -> None:
        """Preempt the request in lane ``b`` under pool pressure: gather its
        written KV rows out of the pool, copy them to the host, release its
        blocks and prefix pin and put it on the wait list. Only the blocks
        that hold written rows (``ceil(pos / bs)``) are spilled: there is no
        compiled executable whose shape a full-width table would keep
        fixed. Greedy output is unchanged: :meth:`_resume_one` re-lands the
        rows verbatim and decode resumes at the same ``pos`` with the same
        ``last``. Under overlap those are the host's, one chunk behind the
        device: the in-flight chunk's tokens for this lane are dropped at
        retire. The gather and the copy to pinned memory are queued on the
        stream behind that chunk, which still writes these blocks, so they
        read its rows; what it writes past ``pos`` into the freed blocks
        lands, in stream order, before anything their next owner writes.
        With a host tier the spill is accounted there, pinned."""
        req = self._slot_req[b]
        pos = int(self._pos[b])
        written = self._lane_blocks[b][: -(-pos // self.kv_block)]
        with torchapi.allow_transfer("kv pool preemption spill"):
            spilled = rows_to_host(pool_gather_rows(
                self.kv_pool.arena, table_tensor(written, self.device),
                self.kv_block))
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
        self._free_lane(b)
        self._release_prefix(b)
        # Kept sorted by rid: a pass preempts youngest first while older
        # requests may already wait, and resume order must be submit order.
        self._preempted = deque(sorted(
            [*self._preempted,
             _Preempted(req=req, kv=spilled, pos=pos, last=int(self._last[b]),
                        ready=ready)],
            key=lambda p: p.req.rid))
        self._slot_req[b] = None
        self._preemptions += 1
        self._c_preempt.inc()
        if self._kv_host is not None:
            self._kv_host.put(("spill", req.rid), pos, pinned=True)
            self._host_demotions += 1
            self._c_kv_demote.inc()
        self._ledger_to(req, PHASE_PREEMPTED)  # spilled: decode stops here
        self._emit("kv_preempt", rid=req.rid, pos=pos, reason=reason,
                   waiting=len(self._preempted), queued=len(self._queue))

    def _resume_one(self, b: int) -> bool:
        """Re-admit the OLDEST preempted request into lane ``b``: fresh
        blocks for its spilled rows, the rows re-landed as they were (int8
        payload and scale alike), decode resuming where the spill cut it.
        False when the pool still cannot hold it: the caller waits."""
        pre = self._preempted[0]
        blocks = self._alloc_blocks(-(-pre.pos // self.kv_block))
        if blocks is None:
            return False
        stage, self._stage = self._stage, None
        if stage is not None and stage.done is not None:
            # Held, source and rows, until its upload is known complete.
            self._h2d_inflight.append(stage)
        staged = stage is not None and stage.rid == pre.req.rid
        if staged:
            rows = stage.rows
            if stage.done is not None:
                # The main stream waits for the side stream's upload and
                # uses the rows it made.
                main = torch.cuda.current_stream(self.device)
                main.wait_event(stage.done)
                for t in cache_leaves(rows):
                    t.record_stream(main)
            self._resume_staged += 1
        else:
            rows = rows_to_device(pre.kv, self.device)
        pool_scatter_rows(self.kv_pool.arena, rows,
                          table_tensor(blocks, self.device), self.kv_block)
        self._set_lane_table(b, blocks)
        self._slot_req[b] = pre.req
        self._pos[b] = pre.pos
        self._last[b] = pre.last
        self._fresh_rows.add(b)  # overlap: override the in-flight row
        self._preempted.popleft()
        if self._kv_host is not None:
            self._kv_host.pop(("spill", pre.req.rid))
            self._host_prefetches += 1
            self._c_kv_prefetch.inc()
        self._ledger_to(pre.req, self._decode_state())  # decoding again
        self._emit("kv_resume", rid=pre.req.rid, pos=pre.pos,
                   waiting=len(self._preempted), queued=len(self._queue),
                   prefetched=int(staged))
        return True

    def _stage_resume_prefetch(self) -> None:
        """Start the upload of the oldest preempted request's spilled rows
        while a decode chunk is in flight (called right after each
        dispatch, and after a lock-step round), so that its resume lands
        rows already on the card. Only with a host tier, one staged upload
        at a time. On CUDA the upload runs on a side stream from the pinned
        spill, after the spill's own copy (its ``ready`` event), beside the
        chunk; it records ``done``, which the resume waits for. A failed
        copy raises."""
        if self._kv_host is None or not self._preempted:
            return
        pre = self._preempted[0]
        if self._stage is not None and self._stage.rid == pre.req.rid:
            return  # already staged for the current head
        if self.device.type != "cuda":
            self._stage = _ResumeStage(pre.req.rid, rows_to_device(pre.kv,
                                                                   self.device))
            return
        self._h2d_inflight = [s for s in self._h2d_inflight
                              if not s.done.query()]
        if self._h2d_stream is None:
            self._h2d_stream = torch.cuda.Stream(self.device)
        side = self._h2d_stream
        side.wait_event(pre.ready)
        with torch.cuda.stream(side):
            rows = rows_to_device(pre.kv, self.device)
            done = torch.cuda.Event()
            done.record(side)
        if self._stage is not None:  # staged for an earlier head: dropped
            self._h2d_inflight.append(self._stage)
        self._stage = _ResumeStage(pre.req.rid, rows, done, src=pre.kv)

    def _ensure_blocks(self) -> None:
        """Grow every live lane's table to cover the next dispatch window,
        OLDEST request first: ``chunk × decode_steps`` positions past the
        host's ``pos``, twice that under overlap, whose host ``pos`` lags
        the device by the chunk in flight; a persistent server's whole step
        cap, since a round cannot ask the host for blocks midway. When the
        pool is exhausted the YOUNGEST live lane is preempted until the
        older ones fit; the head of the line always makes progress because
        the drained pool holds one full-length request. Growth is capped by
        the request's own ``prompt + max_new_tokens`` and the table width:
        writes past a finished request's budget aim at SCRATCH, so no block
        is spent on dead rows."""
        if not self.paged:
            return
        bs = self.kv_block
        lookahead = (self._persistent_cap if self._persistent
                     else self._dispatch_steps * (2 if self.overlap else 1))
        lanes = sorted((b for b in range(self.max_batch)
                        if self._slot_req[b] is not None),
                       key=lambda b: self._slot_req[b].rid)
        for b in lanes:
            req = self._slot_req[b]
            if req is None:
                continue  # preempted while an older lane grew
            cap = -(-(len(req.prompt) + req.max_new_tokens) // bs)
            need = min(-(-(int(self._pos[b]) + lookahead) // bs), cap,
                       self._nb_max)
            while len(self._lane_blocks[b]) < need and self._slot_req[b] is req:
                got = self._alloc_blocks(need - len(self._lane_blocks[b]))
                if got is not None:
                    self._set_lane_table(b, self._lane_blocks[b] + got)
                    break
                with self._clock.section(LOOP_PHASE_HOST):
                    self._preempt_lane(max(
                        (v for v in range(self.max_batch)
                         if self._slot_req[v] is not None),
                        key=lambda v: self._slot_req[v].rid))

    # ----- the round loop --------------------------------------------------

    def step(self) -> bool:
        """One SUPERVISED round of the server's loop: :meth:`_step_overlapped`
        by default, :meth:`_step_lockstep` with ``overlap=False`` or
        persistent rounds. A fault :func:`.resilience.recoverable` takes
        runs :meth:`_recover` in place of unwinding :meth:`run`; anything
        else, or any fault under ``KATA_TPU_RECOVERY=0``, emits
        ``fatal_error`` (the flight ring dumps on it) and propagates. A round
        that completes resets the failure streaks and takes the periodic
        checkpoint, inside the supervised region. A requested drain
        finishes here once nothing is in flight. Returns False when the
        queue, the wait list, the lanes and the pipeline are empty."""
        if self._draining and not self._drain_announced:
            self._drain_announced = True
            self._emit("drain_begin", reason=self._drain_reason,
                       queued=len(self._queue),
                       slots_busy=sum(r is not None for r in self._slot_req))
        try:
            alive = self._step_inner()
            self._note_progress()
        except BaseException as exc:
            if not (self._supervised and resilience.recoverable(exc)):
                self._emit_fatal(exc)
                raise
            alive = self._recover(exc)
        if self._draining and not self._drain_done and self._drain_idle():
            self._finish_drain()
            alive = False
        # The flush when the loop idles out leaves the partial interval on
        # the stream and closes any watchdog profiler window.
        self._maybe_heartbeat(force=not alive)
        if not alive and self._watchdog is not None:
            self._watchdog.close()
        return alive

    def _step_inner(self) -> bool:
        """Persistent and speculative rounds run lock-step: the host reads
        the delivered count, or the accepted drafts, before it can schedule
        the next round. Under strict the overlapped round is guarded
        against host syncs."""
        if self.overlap and not self.speculative_k and not self._persistent:
            if self.strict:
                with torchapi.strict_mode(scope="serving.decode_dispatch",
                                          device=self.device):
                    return self._step_overlapped()
            return self._step_overlapped()
        return self._step_lockstep()

    def _emit_fatal(self, exc: BaseException) -> None:
        self._emit("fatal_error", error=f"{type(exc).__name__}: {exc}"[:200],
                   queued=len(self._queue),
                   slots_busy=sum(r is not None for r in self._slot_req))

    def _drain_idle(self) -> bool:
        """Nothing in flight: no chunk, no busy lane, no chunked or other
        mid-admission work, no preempted spill and no crash-recovery replay
        in the queue (all started work, which finishes before the drain
        closes)."""
        return (self._inflight is None and not self._preempted
                and self._partial is None and not self._admitting
                and all(r is None for r in self._slot_req)
                and not any(r.replays for r in self._queue))

    def _finish_drain(self) -> None:
        """Fail everything that never started, with the JAX server's
        messages, drop the checkpoint (its final ``checkpoint`` event) and
        close the drain. Every submitted request is now in the results or
        in :meth:`failures`."""
        failed = 0
        while self._preempted:
            self._fail_preempted(f"drained mid-flight ({self._drain_reason})")
            failed += 1
        while self._queue:
            self._fail_request(self._queue.popleft(), "drained",
                               f"drained before start ({self._drain_reason})")
            failed += 1
        self._ckpt = {}
        self._emit("checkpoint", round=self._rounds, lanes=0, tokens=0,
                   final=True)
        self._emit("drain", reason=self._drain_reason,
                   completed=len(self._results), failed=failed)
        self._drain_done = True

    def _fail_preempted(self, error: str) -> None:
        """Fail the oldest preempted request."""
        self._fail_request(self._preempted.popleft().req, "drained", error)

    def _fail_request(self, req: _Request, reason: str, error: str = "") -> None:
        """A request's terminal failure: :meth:`failures`, a
        ``request_failed`` event and its ``request_trace``; never retried.
        Its host-tier accounting and any staged upload of its spill go
        with it."""
        req.done = True
        self._failures[req.rid] = error or reason
        if self._kv_host is not None:
            self._kv_host.pop(("spill", req.rid))
        stage = self._stage
        if stage is not None and stage.rid == req.rid:
            self._stage = None
            if stage.done is not None:  # held until its upload completes
                self._h2d_inflight.append(stage)
        self._emit("request_failed", rid=req.rid, reason=reason,
                   error=(error or reason)[:200], emitted=len(req.out))
        self._finish_trace(req, outcome="failed", reason=reason)

    # ----- recovery supervisor ----------------------------------------------

    def _decode_state(self) -> str:
        """The ledger phase of decoding: ``decode_degraded`` once a shrink
        left the server below its first degree."""
        return (PHASE_DECODE_DEGRADED if self._tp < self._tp_initial
                else PHASE_DECODE)

    def _note_progress(self) -> None:
        """A round completed: reset the backoff streak and every lane's
        implication count, then take the periodic checkpoint when the
        cadence says so."""
        self._fail_streak = 0
        for req in self._slot_req:
            if req is not None:
                req.fails = 0
        if (self._ckpt_every
                and self._rounds - self._ckpt_round >= self._ckpt_every):
            with self._clock.section(LOOP_PHASE_HOST):
                self._checkpoint()

    def _checkpoint(self) -> None:
        """Snapshot every live lane's KV rows to the host with the state a
        restore needs (the preemption spill's rows when paged, the lane's
        slot slice when slotted), then wait, watchdog-bounded, for the
        copies. Under overlap the host's ``pos``/``out`` are the retired
        state and the rows may hold the chunk in flight past ``pos``, which
        decode overwrites before it reads them. A sanctioned sync at the
        checkpoint cadence, never a round's."""
        entries: dict[int, _CkptEntry] = {}
        tokens = 0
        bs = self.kv_block
        with torchapi.allow_transfer("recovery checkpoint spill"):
            for b in range(self.max_batch):
                req = self._slot_req[b]
                if req is None or req.done:
                    continue
                pos = int(self._pos[b])
                if self.paged:
                    rows = pool_gather_rows(
                        self.kv_pool.arena, table_tensor(
                            self._lane_blocks[b][: -(-pos // bs)], self.device),
                        bs)
                else:  # a copy: the host rows must not alias the arena
                    rows = map_rows(self.arena,
                                    lambda a, b=b: a[:, b:b + 1].clone())
                entries[req.rid] = _CkptEntry(
                    req=req, out=list(req.out), pos=pos,
                    last=int(self._last[b]), kv=rows_to_host(rows))
                tokens += pos
            self._fence_stream(seam="checkpoint")
        self._ckpt = entries
        self._ckpt_round = self._rounds
        self._checkpoints += 1
        self._emit("checkpoint", round=self._rounds, lanes=len(entries),
                   tokens=tokens)

    def _recover(self, exc: BaseException) -> bool:
        """Rebuild after a failed round, as the JAX server does. A
        PERMANENT fault first shrinks the mesh (:meth:`_degrade_mesh`) or,
        with no rung left, fails the whole load (:meth:`_fail_all`). The
        blamed set is the running fill's requests when the fault was in
        one (a reservation's, a chunk's), else every lane resident, the
        chunk in flight's and a slice riding it; a blamed request that
        reaches ``quarantine_after`` consecutive faults fails on its own.
        Then the device state is reset in place and every other implicated
        request is restored from the checkpoint or requeued, strict FIFO,
        to replay from its prompt; a fault inside the restore resets once
        more and replays them all. The backoff doubles with the streak,
        to at most 5 s."""
        err = f"{type(exc).__name__}: {exc}"[:200]
        self._fail_streak += 1
        self._recoveries += 1
        self._c_recover.inc()
        if isinstance(exc, DeviceStallError):
            self._stalls += 1
            self._c_stall.inc()
        if resilience.classify(exc) == resilience.PERMANENT:
            if not self._degrade_mesh(exc):
                return self._fail_all(err)
        blamed = {r.rid for r in self._admit_current if not r.done}
        if not blamed:
            cohort = [r for r in self._slot_req if r is not None]
            if self._inflight is not None:
                cohort += [r for _b, r in self._inflight.slots]
            for fc in (self._fused_ret,
                       self._inflight.fused if self._inflight else None):
                if fc is not None:
                    cohort.append(fc.partial.req)
            if self._fused_blame is not None:
                cohort.append(self._fused_blame)
            blamed = {r.rid for r in cohort if not r.done}
        lost = self._unfinished()
        # A blamed request still queued (a reservation's fault) joins the
        # lost set, so that its quarantine streak counts.
        for req in [r for r in self._queue
                    if r.rid in blamed and r.rid not in lost]:
            self._queue.remove(req)
            lost[req.rid] = req
        self._release_prefix_state()
        quarantined = 0
        survivors: list[_Request] = []
        for rid in sorted(lost):
            req = lost[rid]
            if rid in blamed:
                req.fails += 1
            if req.fails >= self._quarantine_k:
                self._fail_request(req, "quarantined", err)
                self._ckpt.pop(rid, None)
                self._quarantined_n += 1
                self._c_quarantine.inc()
                quarantined += 1
            else:
                self._ledger_to(req, PHASE_RECOVERY)
                survivors.append(req)
        self._reset_device_state()
        restored = 0
        replay: list[_Request] = []
        lanes = iter(range(self.max_batch))
        try:
            with torchapi.allow_transfer("crash recovery restore"):
                for req in survivors:  # rid order
                    entry = self._ckpt.get(req.rid)
                    if entry is not None and self._restore_lane(next(lanes),
                                                                entry):
                        restored += 1
                    else:
                        req.out = []
                        req.replays += 1
                        replay.append(req)
        except BaseException as exc2:
            if not (self._supervised and resilience.recoverable(exc2)):
                raise
            if (resilience.classify(exc2) == resilience.PERMANENT
                    and not self._degrade_mesh(exc2)):
                # No rung left: the survivors not in a lane go back to the
                # queue first, so that _fail_all fails every one of them.
                in_lane = {r.rid for r in self._slot_req if r is not None}
                self._queue.extendleft(reversed(
                    [r for r in survivors if r.rid not in in_lane]))
                return self._fail_all(f"{type(exc2).__name__}: {exc2}"[:200])
            # The half-restored state is not to be trusted: reset once more
            # and replay every survivor from its prompt.
            self._reset_device_state()
            counted = {r.rid for r in replay}
            restored = 0
            for req in survivors:
                if req.rid not in counted:
                    req.replays += 1
                req.out = []
                self._ledger_to(req, PHASE_RECOVERY)
            replay = list(survivors)
        if replay:
            self._queue.extendleft(reversed(replay))
        if self.paged:
            self._preempted = deque(sorted(self._preempted,
                                           key=lambda p: p.req.rid))
        backoff = (min(self._backoff_s * 2 ** (self._fail_streak - 1), 5.0)
                   if self._backoff_s > 0 else 0.0)
        self._emit("recovery", error=err, restored=restored,
                   requeued=len(replay), quarantined=quarantined,
                   streak=self._fail_streak, backoff_s=round(backoff, 4))
        if backoff:
            time.sleep(backoff)
        return (bool(self._queue) or bool(self._preempted)
                or any(r is not None for r in self._slot_req))

    def _unfinished(self) -> dict[int, _Request]:
        """The unfinished requests a failed round takes down: lane
        residents, the chunk in flight's, and those mid-admission."""
        lost: dict[int, _Request] = {}
        reqs = [r for r in self._slot_req if r is not None]
        if self._inflight is not None:
            reqs += [r for _b, r in self._inflight.slots]
        reqs += [r for r, _h in self._admitting]
        for req in reqs:
            if not req.done:
                lost[req.rid] = req
        return lost

    def _release_prefix_state(self) -> None:
        """Release every lane's prefix pin and cancel the mid-admission
        lookups against a slotted server's store (a paged tier is rebuilt
        with its pool), then strip the hits from ``_admitting`` so that
        nothing releases them twice."""
        store = self.prefix_store
        if isinstance(store, PrefixStore):
            for hit in self._slot_prefix:
                if hit is not None:
                    store.release(hit)
            for _req, hit in self._admitting:
                if hit is not None:
                    store.cancel(hit)
        self._slot_prefix = [None] * self.max_batch
        self._admitting = [(r, None) for r, _h in self._admitting]

    def _degrade_mesh(self, exc: BaseException) -> bool:
        """The shrink after a PERMANENT fault: the next rung of
        :func:`.tp_serving.shrink_ladder` over the survivors (an injected
        ``chip_loss`` loses one shard, ``ici_error`` none), the params
        re-split from the host copy at the new degree, the decode kernel's
        callable and graphs built anew (one new capture), and a slotted
        server's own prefix store rebuilt empty (an injected one is
        disabled). The caller's pass then resets the pool, re-partitioned
        for the blocks layout, and restores or replays. False, after a
        ``chip_loss_fatal`` event, when no rung exists: a server at one
        shard, degraded mode off, the ``tp_min`` floor, or a real CUDA
        error, which takes the one card and every shard on it."""
        if isinstance(exc, ChipLossFault):
            reason, survivors = f"chip_loss:{exc.device_index}", self._tp - 1
        elif isinstance(exc, IciFault):
            reason, survivors = "ici_error", self._tp
        else:
            reason, survivors = "cuda_error", 0
        if (self._tp <= 1 or not self._degraded_ok or survivors == 0
                or self._mesh_injected):
            why = ("degraded_disabled" if not self._degraded_ok
                   else "single_chip" if self._tp <= 1 or survivors == 0
                   else "mesh_injected")
            self._emit("chip_loss_fatal", reason=reason, tp=self._tp, why=why)
            return False
        new_tp = tp_serving.shrink_ladder(self._tp, survivors, self._tp_min)
        if new_tp is None:
            self._emit("chip_loss_fatal", reason=reason, tp=self._tp,
                       why=f"tp_min_floor:{self._tp_min}", survivors=survivors)
            return False
        t0 = time.perf_counter()
        old_tp = self._tp
        self._release_prefix_state()
        if isinstance(self.prefix_store, PrefixStore):
            if self._prefix_injected:
                self._emit("prefix_store_disabled", reason="tp_degraded")
                self.prefix_store = None
            else:
                self.prefix_store = PrefixStore(
                    self.cfg, self.prefix_store.capacity_tokens,
                    self.prefill_buckets, kv_quant=self.kv_quant,
                    device=self.device, label=self._label)
        self._tp = new_tp
        with torchapi.allow_transfer("degraded-mode shrink: the params "
                                     "re-split from the host copy"):
            params = _tree_to(self._params_host, self.device)
            self._mesh = (ServingMesh.for_config(self.cfg, new_tp, self.device)
                          if new_tp > 1 else None)
            self.params = (tp_serving_params(params, self.cfg, self._mesh)
                           if self._mesh is not None else params)
            self._build_decode()
        self._shard_peak = self._shard_peak[:new_tp]
        self._tp_shrinks += 1
        # The scheduler's rates were measured at the old degree.
        self._sched.reset_estimates()
        self._emit("tp_degraded", reason=reason, old_tp=old_tp, tp=new_tp,
                   survivors=survivors, tp_min=self._tp_min,
                   resplit_s=round(time.perf_counter() - t0, 6))
        return True

    def _fail_all(self, err: str) -> bool:
        """No degraded configuration exists: every unfinished request (lane
        residents, the chunk in flight's, mid-admission work, preempted
        spills, the queue) fails loudly (``chip_lost``) BEFORE the device
        state is reset, so that when the reset itself raises (the card's
        context is gone) none vanish; its error then propagates after a
        ``fatal_error`` event. Results already banked stay."""
        lost = self._unfinished()
        for req in [p.req for p in self._preempted] + list(self._queue):
            if not req.done:
                lost[req.rid] = req
        self._preempted.clear()
        self._queue.clear()
        self._release_prefix_state()
        self._ckpt = {}
        for rid in sorted(lost):
            self._fail_request(lost[rid], "chip_lost", err)
        try:
            self._reset_device_state()
        except BaseException as exc:
            self._emit_fatal(exc)
            raise
        self._emit("recovery", error=err, restored=0, requeued=0,
                   quarantined=0, failed=len(lost), streak=self._fail_streak,
                   backoff_s=0.0)
        return False

    def _reset_device_state(self) -> None:
        """The device state after a failed round, IN PLACE (the JAX server
        builds a fresh pool or arena; here the decode graphs hold their
        addresses): the card quiesced (the chunk in flight, the resume
        uploads' side stream), the pool's free list, counts and tables as
        new and its blocks zeroed, or the slotted arena zeroed, and the
        host mirrors of device work cleared. A paged prefix tier dies with
        its pool's contents: its traffic counts fold into the server's and
        its demoted segments leave the host tier. Host-side request state
        (queue, results, failures, checkpoint, preempted spills) stays. The
        host mirrors clear first: when the card's context is gone and the
        device part raises, the server holds no lane of a failed load."""
        self._slot_req = [None] * self.max_batch
        self._inflight = None
        self._fresh_rows.clear()
        self._partial = None
        self._fuse_pending = False
        self._fused_ret = None
        self._fused_blame = None
        self._persistent_fut = None
        self._admitting = []
        self._admit_current = []
        if self.paged:
            self._lane_blocks = [[] for _ in range(self.max_batch)]
            self._bt_host[:] = SCRATCH_BLOCK
            self._plans.clear()
        if self.device.type == "cuda":
            with torchapi.allow_transfer("crash recovery: the card quiesced "
                                         "before the in-place reset"):
                torch.cuda.synchronize(self.device)
        if self.paged:
            self.kv_pool.reset(shards=self._kv_shards())
            self._stage = None
            self._h2d_inflight = []
            tier = self.prefix_store
            if isinstance(tier, PagedPrefixTier):
                self._host_demotions += tier.demotions
                self._host_prefetches += tier.prefetches
                if self._kv_host is not None:
                    self._kv_host.drop_unpinned()
                self.prefix_store = PagedPrefixTier(
                    self.kv_pool, self.cfg, self.prefill_buckets,
                    host_tier=self._kv_host, label=self._label,
                    on_demote=self._c_kv_demote.inc,
                    on_prefetch=self._c_kv_prefetch.inc)
        else:
            for t in cache_leaves(self.arena):
                t.zero_()
        if self.draft_arena is not None:
            for t in cache_leaves(self.draft_arena):
                t.zero_()
        self._note_kv_replicated()

    def _restore_lane(self, b: int, entry: _CkptEntry) -> bool:
        """Re-land one checkpointed request in lane ``b``: its KV rows
        verbatim, its tokens cut back to the snapshot, decode resuming at
        the snapshot's ``pos``/``last`` (the preemption restore's argument:
        greedy output does not change). False when the pool cannot hold the
        rows now; the caller requeues it to replay instead."""
        req = entry.req
        rows = rows_to_device(entry.kv, self.device)
        if self.paged:
            blocks = self._alloc_blocks(-(-entry.pos // self.kv_block))
            if blocks is None:
                return False
            pool_scatter_rows(self.kv_pool.arena, rows,
                              table_tensor(blocks, self.device), self.kv_block)
            self._set_lane_table(b, blocks)
        else:
            _write_slots(self.arena, rows, torch.as_tensor(
                [b], dtype=torch.long, device=self.device))
        req.out = list(entry.out)
        self._slot_req[b] = req
        self._slot_prefix[b] = None
        self._pos[b] = entry.pos
        self._last[b] = entry.last
        self._fresh_rows.add(b)
        self._ledger_to(req, self._decode_state())  # restored: decoding
        return True

    def _fence_wait(self, wait, seam: str = "fence", inject: bool = True):
        """One blocking device-to-host wait through the watchdog fence
        (:func:`.resilience.fence_with_timeout`): the injector's seam first
        (``inject=False`` skips it: recovery machinery is no seam), then the
        wait, on a worker thread that makes the server's card current when
        ``fence_timeout_s`` is set. A sanctioned region of strict mode, as
        the retire it wraps."""
        fn = wait
        if self._fence_timeout_s > 0 and self.device.type == "cuda":
            device = self.device

            def fn():
                torch.cuda.set_device(device)
                return wait()
        with torchapi.allow_transfer("watchdog fence (a retire or a "
                                     "checkpoint's wait)"):
            return resilience.fence_with_timeout(
                fn, timeout_s=self._fence_timeout_s, seam=seam,
                injector=self._inj if inject else None, server=self._label,
                trace=self._trace)

    def _fence_stream(self, seam: str) -> None:
        """Wait, watchdog-bounded and crossing no seam, for everything queued
        on the current stream (nothing to wait for on the CPU)."""
        if self.device.type != "cuda":
            return
        done = torch.cuda.Event()
        done.record()
        self._fence_wait(done.synchronize, seam=seam, inject=False)

    def _decode_budget(self) -> Optional[np.ndarray]:
        """Per-lane upper bounds on the tokens still to come, which arm the
        freeze mask at ``decode_steps > 1`` (None at K = 1: the plain
        chunk). From the host's retired counts: under overlap they exceed
        the truth by at most the chunk in flight, so a lane freezes late
        (tokens trimmed), never early. Empty lanes get 0. Persistent
        servers always arm it: the round's exits read it."""
        if self._decode_steps <= 1 and not self._persistent:
            return None
        budget = np.zeros(self.max_batch, np.int32)
        for b, req in enumerate(self._slot_req):
            if req is not None:
                budget[b] = max(0, req.max_new_tokens - len(req.out))
        return budget

    def _host_tensor(self, arr, dtype=torch.int32) -> torch.Tensor:
        """A snapshot of host array ``arr`` for one dispatch, pinned on
        CUDA: its copy to the card runs asynchronously, and later edits of
        ``arr`` cannot reach it."""
        t = torch.empty(np.shape(arr), dtype=dtype,
                        pin_memory=self.device.type == "cuda")
        t.numpy()[...] = arr
        return t

    def _to_device(self, arr, dtype=torch.int32) -> torch.Tensor:
        return self._host_tensor(arr, dtype).to(self.device, non_blocking=True)

    def _dispatch_decode(self, tok, pos):
        """The one decode dispatch: one chunk of ``chunk × decode_steps``
        steps for every lane from ``tok``/``pos`` (device tensors, or host
        snapshots), with the budget mask and (paged) a snapshot of the
        block tables; an admission slice rides along when one is pending
        under the fused plan (its logits wait in ``_fused_ret``), and a
        persistent server runs a persistent round otherwise (its delivered
        count and windows wait in ``_persistent_fut``). Lanes past their
        budget decode on harmlessly: their writes clamp inside their own
        slot or land in the scratch block, and their extra tokens are
        trimmed. Returns ``(toks, last, pos)`` on the device, not yet
        waited for, except a persistent round's, which has finished. The
        device ledger stamps the dispatch right before the chunk's call
        (a graph replay on the card) with the signature's analytic cost.
        The ``decode_dispatch`` seam."""
        self._inj.fire("decode_dispatch")
        if not self._decode_attn_emitted:
            self._decode_attn_emitted = True
            self._emit(
                "decode_attn_backend", backend=self._decode_attn,
                reason=self._decode_attn_reason, paged=self.paged,
                block_size=(self.kv_block if self.paged
                            else attention.dense_decode_tile(self.max_len)),
                kv_quant="int8" if self.kv_quant else "bf16")
        budget = self._decode_budget()
        eos_none = budget is None or self.eos_id is None
        kw = {}
        if budget is not None:
            kw["budget"] = self._host_tensor(budget)
        if self.paged:
            self._occupancy_peak = max(self._occupancy_peak,
                                       self.kv_pool.occupancy())
            self._shard_peak = [max(a, b) for a, b in zip(
                self._shard_peak, self._pool_shard_occupancy())]
            kw["block_tables"] = self._host_tensor(self._bt_host)
        steps = self._dispatch_steps
        fuse = self._prepare_fused_chunk()
        if fuse is not None:
            p = self._partial
            suffix, offset, take, width, is_last = fuse
            self._devledger.on_dispatch(
                ("fused", self.paged, steps, width, eos_none, budget is None),
                partial(self._dispatch_cost, steps, width))
            out, logits = self._decode.fused(
                lambda: self._run_slice(p, suffix, offset, take), tok, pos, **kw)
            self._fused_ret = _FusedChunk(partial=p, last=is_last, logits=logits)
            self._fused_blame = None  # the record carries the blame now
            return out
        if self._persistent:
            window = self._persistent_window()
            cap = self._persistent_cap
            self._devledger.on_dispatch(
                ("persistent", self.paged, cap, eos_none),
                partial(self._dispatch_cost, cap), loop_cap=cap)
            toks, last, new_pos, delivered = self._round(
                tok, pos, kw["budget"], self._host_tensor(window),
                kw.get("block_tables"))
            self._persistent_fut = (delivered, window)
            return toks[:, :delivered], last, new_pos
        self._devledger.on_dispatch(
            ("plain", self.paged, steps, eos_none, budget is None),
            partial(self._dispatch_cost, steps))
        return self._decode(tok, pos, **kw)

    def _dispatch_cost(self, steps: int, slice_width: int = 0) -> dict:
        """A dispatch signature's FLOPs and bytes from shapes alone
        (:func:`..obs.devledger.decode_cost`): every lane for ``steps``
        steps, plus an admission slice ``slice_width`` rows wide. The
        signature does not know the lanes' positions: each row is costed
        over half the arena's keys, or, in a ring layer, its whole ring
        (the mean over the layers; at the served models' widths the
        attention is a few percent of a decode step's FLOPs)."""
        keys = self.max_len / 2
        if self.ring_kv:
            keys = float(np.mean([
                w + self._ring_margin if w > 0 else self.max_len / 2
                for w in (self.cfg.layer_window(i)
                          for i in range(self.cfg.n_layers))]))
        return obs.devledger.decode_cost(
            self.cfg, lanes=self.max_batch, steps=steps, keys=keys,
            kv_quant=self.kv_quant, prefill_tokens=slice_width,
            prefill_keys=keys)

    def _persistent_window(self) -> np.ndarray:
        """Each lane's write bound for a persistent round: the end of its
        reserved blocks when paged, the arena's length when slotted."""
        window = np.full(self.max_batch, self.max_len, np.int32)
        if self.paged:
            for b in range(self.max_batch):
                if self._slot_req[b] is not None:
                    window[b] = min(len(self._lane_blocks[b]) * self.kv_block,
                                    self.max_len)
        return window

    def _step_lockstep(self) -> bool:
        """Refill free lanes, (paged) grow the lanes' tables or preempt,
        then one dispatch for every lane, fenced by its token transfer
        inside one ``serving.decode_chunk`` span. A persistent round is
        accounted by the steps it delivered, and its exit attributed
        (``persistent_exit``): ``cap`` when it delivered the cap,
        ``window`` when a lane still running sits at its window edge, else
        ``done``."""
        self._admit()
        self._ensure_blocks()
        self._fresh_rows.clear()  # lock-step dispatch reads host rows
        active = [b for b in range(self.max_batch) if self._slot_req[b] is not None]
        if not active:
            return (bool(self._queue) or bool(self._preempted)
                    or self._partial is not None)
        self._lanes_peak = max(self._lanes_peak, len(active))
        if self.speculative_k:
            return self._verify_round(active)
        with obs.span("serving.decode_chunk", trace_id=self._trace,
                      server=self._label,
                      tokens=len(active) * self._dispatch_steps,
                      slots_busy=len(active), queued=len(self._queue),
                      batch_occupancy=round(len(active) / self.max_batch, 4)
                      ) as sp:
            with self._clock.section(LOOP_PHASE_DISPATCH):
                toks, last, pos = self._dispatch_decode(
                    self._host_tensor(self._last), self._host_tensor(self._pos))
            with self._clock.section(LOOP_PHASE_RETIRE):
                host = self._fence_wait(
                    DeviceFence(toks=toks, last=last, pos=pos).wait)
        dur = sp.duration_s
        fut, self._persistent_fut = self._persistent_fut, None
        delivered = None if fut is None else fut[0]
        # The retire stamp after the span: its fence time is in the clock.
        self._devledger.note_retire(delivered_steps=delivered)
        steps = self._dispatch_steps if delivered is None else delivered
        tok_lat = dur / max(steps, 1)
        self._tok_lat.observe(tok_lat)
        self._h_tok_lat.observe(tok_lat)
        self._note_round(dur, len(active), steps=max(steps, 1))
        self._last, self._pos = host["last"], host["pos"]
        self._rounds += 1
        for b in active:
            new = host["toks"][b].tolist()
            self._slot_req[b].out.extend(new)
            self._emitted += len(new)
            self._maybe_finish(b, new)
        if fut is not None:
            window = fut[1]
            if delivered >= self._persistent_cap:
                reason = "cap"
            elif any(self._slot_req[b] is not None and self._pos[b] >= window[b]
                     for b in active):
                reason = "window"
            else:
                reason = "done"
            self._persistent_rounds += 1
            self._delivered_lane_steps += delivered * len(active)
            self._last_delivered = delivered
            self._delivered_total += delivered
            self._persistent_exits[reason] += 1
            self._emit("persistent_exit", reason=reason, delivered=delivered,
                       cap=self._persistent_cap)
        # A slice that rode this dispatch lands after the decode tokens.
        fc, self._fused_ret = self._fused_ret, None
        self._apply_fused(fc)
        # No chunk is in flight here, but the upload still runs ahead of
        # the next round's admission pass.
        with self._clock.section(LOOP_PHASE_HOST):
            self._stage_resume_prefetch()
        return True

    def _verify_round(self, active: list) -> bool:
        """One speculative round (:meth:`_step_speculative`) in a
        ``serving.verify_round`` span, whose token transfer fences it; the
        accepted tokens then give ITL (the span over the tokens a lane
        gained) and a ``spec_round`` event, as in the JAX server."""
        before = self._emitted
        with obs.span("serving.verify_round", trace_id=self._trace,
                      server=self._label, slots_busy=len(active),
                      queued=len(self._queue)) as sp:
            alive = self._step_speculative(active)
        accepted = self._emitted - before
        if accepted:
            tok_lat = sp.duration_s / (accepted / len(active))
            self._tok_lat.observe(tok_lat)
            self._h_tok_lat.observe(tok_lat)
            self._emit("spec_round", accepted=accepted,
                       offered=self.speculative_k * len(active),
                       dur_s=round(sp.duration_s, 6))
        return alive

    def _step_speculative(self, active: list) -> bool:
        """One speculative round over every lane: ``k`` drafts a lane, from
        its request's history (n-gram) or from a ``k+1``-step decode of the
        draft over its arena (keep k: the cache-hole argument of
        :func:`..models.speculative.draft_propose`), verified in ONE
        ``[max_batch, k+1]`` forward at the lanes' positions; greedy,
        each lane accepts the longest draft prefix the target's own choices
        reproduce, then its correction, so the tokens are the plain greedy
        server's. Sampling, the rejection scheme runs on the device
        (:func:`..models.speculative.sample_accept_device`) and only token
        ids and counts come to the host. Lanes without a request verify
        harmlessly in their own rows."""
        from ..models.speculative import (
            accept_drafts,
            draft_sample_propose,
            ngram_propose,
            sample_accept_device,
            verify_logits_step,
            verify_step,
        )

        k = self.speculative_k
        sampling = self._do_sample
        signature = ("verify", sampling, self.draft is not None)
        if signature not in self._spec_signatures:
            self._spec_signatures.add(signature)
            torchapi.note_compile("speculative signature")
        cur = self._last.copy()
        cur_dev = self._to_device(cur)
        pos_dev = self._to_device(self._pos)
        q_dev = None
        if self.draft is not None and sampling:
            d_params, d_cfg = self.draft
            drafts_dev, q_dev, _c = draft_sample_propose(
                d_params, self.draft_arena, cur_dev, pos_dev, d_cfg, k,
                self._temp_dev, self.generator)
            drafts = drafts_dev.cpu().numpy()
        elif self.draft is not None:
            d_params, d_cfg = self.draft
            toks_dev, _l, _p = serve_decode(d_params, self.draft_arena, cur_dev,
                                            pos_dev, d_cfg, k + 1)
            drafts = toks_dev.cpu().numpy()[:, :k]
        else:
            drafts = np.zeros((self.max_batch, k), np.int32)
            for b in active:
                req = self._slot_req[b]
                hist = np.concatenate(
                    [req.prompt, np.asarray(req.out[:-1], np.int32)])
                drafts[b] = ngram_propose(hist, int(cur[b]), k)
        toks = self._to_device(np.concatenate([cur[:, None], drafts], axis=1),
                               torch.int64)
        if sampling:
            logits, _c = verify_logits_step(self.params, self.arena, toks,
                                            pos_dev, self.cfg, ring=self.ring_kv)
            tok_acc, counts = sample_accept_device(
                self._to_device(drafts), q_dev, logits, self._temp_dev,
                self.generator, k, has_q=q_dev is not None)
            tok_acc, counts = tok_acc.cpu().numpy(), counts.cpu().numpy()
        else:
            greedy, _c = verify_step(self.params, self.arena, toks, pos_dev,
                                     self.cfg, ring=self.ring_kv)
            greedy = greedy.cpu().numpy()
        self._rounds += 1
        for b in active:
            if sampling:
                accepted = tok_acc[b, : counts[b]].tolist()
            else:
                accepted = accept_drafts(drafts[b], greedy[b], k)
            self._slot_req[b].out.extend(accepted)
            self._last[b] = accepted[-1]
            self._pos[b] += len(accepted)
            self._emitted += len(accepted)
            self._drafts_offered += k
            self._drafts_accepted += len(accepted) - 1
            self._maybe_finish(b, accepted)
        return True

    def _note_round(self, dur_s: float, busy: int,
                    steps: Optional[int] = None) -> None:
        """Feed one round's cadence to the scheduler, with the steps it
        delivered; a round over the deadline counts and emits
        ``slo_violation``."""
        steps = self._dispatch_steps if steps is None else max(steps, 1)
        if self._sched.note_round(dur_s, steps=steps):
            self._c_slo.inc()
            self._emit("slo_violation", round_s=round(dur_s, 6),
                       itl_s=round(dur_s / steps, 6),
                       slo_ms=self._sched.slo_ms, slots_busy=busy)

    def _step_overlapped(self) -> bool:
        """One pipelined round: dispatch the NEXT chunk first, from the
        in-flight chunk's ``last``/``pos`` on the device with refilled rows
        merged in, and only then retire the in-flight chunk, so that finish
        detection and admission run while the card computes. A chunk
        dispatched before its predecessor's tokens were read may decode
        rows of requests that turn out to have finished: retire drops those
        tokens (wasted work on a dead row, never a wrong token)."""
        prev, self._inflight = self._inflight, None
        if prev is None:
            self._admit()  # pipeline empty: admission feeds this dispatch
        busy = any(r is not None for r in self._slot_req)
        if busy and (prev is None or self._any_survives(prev)):
            self._ensure_blocks()  # paged: before the tables are copied
            if prev is None:
                last = self._host_tensor(self._last)
                pos = self._host_tensor(self._pos)
            elif self._fresh_rows:
                mask = np.zeros(self.max_batch, np.bool_)
                mask[list(self._fresh_rows)] = True
                fresh = self._to_device(mask, torch.bool)
                last = _merge_rows(prev.last, self._to_device(self._last), fresh)
                pos = _merge_rows(prev.pos, self._to_device(self._pos), fresh)
            else:
                last, pos = prev.last, prev.pos
            self._fresh_rows.clear()
            self._dispatch_chunk(last, pos)
            with self._clock.section(LOOP_PHASE_HOST):
                self._stage_resume_prefetch()  # overlaps the chunk just sent
        if prev is not None:
            with self._clock.section(LOOP_PHASE_RETIRE):
                self._retire(prev)  # host work overlaps the dispatched chunk
        return (self._inflight is not None or bool(self._queue)
                or bool(self._preempted) or self._partial is not None
                or any(r is not None for r in self._slot_req))

    def _any_survives(self, prev: _Inflight) -> bool:
        """Whether any lane is certain to still be decoding once the
        in-flight chunk lands: a lane at ``len(out) + steps >=
        max_new_tokens`` is certain to finish (eos only finishes it
        earlier). When none survives, the next chunk would be wholly dead
        (budgets aligned to chunk edges would waste half the card), so the
        pipeline drains and the next round dispatches from host state."""
        prev_req = dict(prev.slots)
        for b, req in enumerate(self._slot_req):
            if req is None:
                continue
            if prev_req.get(b) is not req:
                return True  # refilled since dispatch: untouched budget
            if len(req.out) + self._dispatch_steps < req.max_new_tokens:
                return True
        return False

    def _dispatch_chunk(self, last, pos) -> None:
        """Dispatch one chunk without waiting: a :class:`DeviceFence`
        starts its outputs' copy to the host behind it, before the next
        chunk can overwrite them. Its detached ``serving.decode_chunk``
        span ends at retire (``dispatch_s`` the host's dispatch cost)."""
        active = [(b, req) for b, req in enumerate(self._slot_req)
                  if req is not None]
        self._lanes_peak = max(self._lanes_peak, len(active))
        # chunk_tokens, not tokens: this span's dur_s is the pipeline window
        # (about two chunk periods), so a rate over it would halve the
        # truth; retire attaches the rate over the retire cadence.
        sp = obs.start_span(
            "serving.decode_chunk", trace_id=self._trace, server=self._label,
            chunk_tokens=len(active) * self._dispatch_steps,
            slots_busy=len(active), queued=len(self._queue),
            batch_occupancy=round(len(active) / self.max_batch, 4),
            overlapped=True)
        with self._clock.section(LOOP_PHASE_DISPATCH):
            toks, new_last, new_pos = self._dispatch_decode(last, pos)
        sp.mark("dispatch")
        # A slice dispatched with the chunk rides its record to retire.
        fc, self._fused_ret = self._fused_ret, None
        self._inflight = _Inflight(
            fence=DeviceFence(toks=toks, last=new_last, pos=new_pos),
            last=new_last, pos=new_pos, slots=active,
            t_dispatch=time.perf_counter(), span=sp, fused=fc)

    def _retire(self, fl: _Inflight) -> None:
        """Land one in-flight chunk: wait for its copy, hand its tokens to
        the requests that still own their lanes, land an admission slice
        that rode along, then refill freed lanes
        (their rows join the next dispatch through ``_fresh_rows``). ITL is
        the retire-to-retire cadence over the dispatch's steps, anchored at
        this chunk's dispatch when the pipeline was empty."""
        host = self._fence_wait(fl.fence.wait)
        now = time.perf_counter()
        round_s = now - max(fl.t_dispatch, self._t_last_retire)
        self._t_last_retire = now
        # The ledger's busy time takes the same anchor as round_s.
        self._devledger.note_retire(now)
        n_tokens = len(fl.slots) * self._dispatch_steps
        fl.span.set(round_s=round(round_s, 6),
                    tokens_per_s=(round(n_tokens / round_s, 2)
                                  if round_s > 0 else 0.0))
        fl.span.end()
        tok_lat = round_s / self._dispatch_steps
        self._tok_lat.observe(tok_lat)
        self._h_tok_lat.observe(tok_lat)
        # The retire cadence is the latency the policy steers by: an
        # admission that took host time between retires shows here.
        self._note_round(round_s, len(fl.slots))
        self._rounds += 1
        for b, req in fl.slots:
            if self._slot_req[b] is not req:
                continue  # finished, refilled or preempted meanwhile
            self._last[b] = host["last"][b]
            self._pos[b] = host["pos"][b]
            new = host["toks"][b].tolist()
            req.out.extend(new)
            self._emitted += len(new)
            self._maybe_finish(b, new)
        # A slice that rode this chunk lands before the admission pass, so
        # a finished chunked admission unblocks the queue head in it.
        self._apply_fused(fl.fused)
        self._admit()


def serve_batch(params: Any, cfg: DecoderConfig, prompts: list,
                max_new_tokens: int = 64, **server_kwargs) -> list[np.ndarray]:
    """Continuous-batch a list of ragged prompts through a
    :class:`GenerationServer` built with ``server_kwargs`` (the overlapped
    loop unless they say ``overlap=False``); tokens in input order."""
    srv = GenerationServer(params, cfg, **server_kwargs)
    rids = [srv.submit(p, max_new_tokens) for p in prompts]
    results = srv.run()
    return [results[r] for r in rids]
