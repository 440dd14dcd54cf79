"""The server's decode executables on CUDA: a decode chunk as one CUDA
graph (counterpart of the jitted ``_serve_decode`` in
``kata_xpu_device_plugin_tpu/guest/serving.py`` and its per-server
executable cache), the fused chunk that carries an admission slice beside
it (``_fused_serve_decode``), and the persistent round
(``_persistent_serve_decode``, :class:`PersistentRound`).

JAX hands the server one compiled executable a chunk; here the same chunk
is ``steps × n_layers`` eager launches of small kernels, which the host
issues more slowly than the card runs them. Replaying a captured graph
issues the whole chunk in one call.

A :class:`DecodeGraph` serves one static signature of one server: the
chunk's step count, slotted or paged, the budget mask armed or not,
``eos_id``, and greedy or sampled (:class:`Sampling`: ``top_k``,
``top_p``, the server's generator, and the temperature as a static device
scalar). Its static inputs are ``tok [B]``, ``pos [B]``, ``budget
[B]`` (armed only) and ``block_tables [B, NB]`` (paged only); every call
copies the caller's values into them on the current stream, so the
copies are ordered behind whatever the stream already holds. Its static
outputs are ``toks [B, steps]``, ``last [B]`` and ``pos [B]``: a replay
overwrites them, so a caller reads or copies a chunk's outputs (a
:class:`..obs.trace.DeviceFence`, the next chunk's inputs) on the stream
before it dispatches the next chunk. :meth:`DecodeGraph.fused` replays
the same chunk with an admission slice beside it on a side stream.

- The first call runs the chunk eagerly on a side stream. That is the
  warm-up (first cuBLAS calls, the decode function's table cache), and
  its result is the first chunk's.
- The second call captures the chunk on that stream, then replays it. A
  capture executes nothing, so no chunk runs twice on the live arena.
- Every later call replays.

The graph freezes the addresses of the parameters and of the arena (or
pool): both must only ever be written in place while the graph lives. A
sampled chunk's generator is registered with the graph before capture, so
each replay draws from the generator's offset at that moment and moves it
on, as the same chunk run eagerly would: two replays draw fresh numbers,
and restoring the generator's state (``get_state``/``set_state``) before a
replay repeats an eager chunk's draws. A
capture that fails raises; nothing drops back to eager launches. The
kernels' launch counters count at capture and not at replay, so the
graph takes back what the capture counted and adds it on every replay.
On the CPU every call runs :func:`serve_decode` eagerly, the plain path.
"""
from __future__ import annotations

import gc
import time
from typing import NamedTuple, Optional

import torch

from ..models.transformer import (
    _decode_scan,
    _persistent_steps,
    persistent_state,
)
from ..ops import attention

# Steps one replay of a persistent round's graph runs (PersistentRound).
# The host reads the round's exit flag after each replay, so at most
# PERSISTENT_SUB_STEPS - 1 steps run past an exit; each replay costs the
# card a host round trip. Chosen from card measurements (PERF.md).
PERSISTENT_SUB_STEPS = 1


class Sampling(NamedTuple):
    """A sampled chunk's draw: from ``generator`` at ``temperature`` (a
    0-dim fp32 tensor on the device), cut to ``top_k`` and ``top_p``."""
    generator: torch.Generator
    temperature: torch.Tensor
    top_k: int = 0
    top_p: float = 0.0


def serve_decode(params, arena, tok, pos, cfg, steps: int,
                 decode_kernel_fn=None, block_tables=None, block_size: int = 0,
                 paged_len: int = 0, budget=None, eos_id: Optional[int] = None,
                 sampling: Optional[Sampling] = None):
    """One fixed-``steps`` ragged decode chunk over the arena (in place),
    through ``decode_kernel_fn``, or the plain attention when it is None.
    With ``block_tables`` the arena is the block pool and each lane decodes
    through its table. ``budget [B]`` (with ``eos_id``) arms the freeze
    mask. Greedy, or sampled with ``sampling``. Returns ``(tokens [B,
    steps], last [B], pos [B])``."""
    skw = {}
    if sampling is not None:
        skw = dict(do_sample=True, generator=sampling.generator,
                   temperature=sampling.temperature, top_k=sampling.top_k,
                   top_p=sampling.top_p)
    toks, _caches, last, pos = _decode_scan(
        params, arena, tok, pos, cfg, steps,
        attn_fn=attention.reference_attention, return_state=True,
        decode_kernel_fn=decode_kernel_fn, block_tables=block_tables,
        block_size=block_size, paged_len=paged_len, budget=budget,
        eos_id=eos_id, **skw,
    )
    return toks, last, pos


def launch_counted():
    """Every kernel wrapper of the port that counts its launches."""
    from ..ops import decode_attn, flash

    return (decode_attn.paged_decode_attention, decode_attn.decode_attention,
            flash.flash_forward, flash.flash_bwd_dq, flash.flash_bwd_dkv)


class DecodeGraph:
    """One server's decode chunk of one static signature (module doc)."""

    def __init__(self, params, arena, cfg, *, batch: int, steps: int, device,
                 decode_kernel_fn=None, table_width: int = 0,
                 block_size: int = 0, paged_len: int = 0,
                 budget: bool = False, eos_id: Optional[int] = None,
                 sampling: Optional[Sampling] = None):
        self.params, self.arena, self.cfg = params, arena, cfg
        self.steps = steps
        self.device = torch.device(device)
        # Read at the warm-up and the capture: a wrapper set here before
        # them (a checked kernel call) runs in both.
        self.decode_kernel_fn = decode_kernel_fn
        self._kw = dict(block_size=block_size, paged_len=paged_len,
                        eos_id=eos_id if budget else None, sampling=sampling)
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0
        self.pool_bytes = 0
        self._warm = False
        self._graph = None
        self._out = None
        self._delta: dict = {}
        self._in: dict[str, torch.Tensor] = {}
        if self.device.type == "cuda":
            def zeros(*shape):
                return torch.zeros(shape, dtype=torch.int32, device=self.device)

            self._in = {"tok": zeros(batch), "pos": zeros(batch)}
            if budget:
                self._in["budget"] = zeros(batch)
            if table_width:
                self._in["block_tables"] = zeros(batch, table_width)
            self._stream = torch.cuda.Stream(self.device)
        self._slice_stream = None

    def _run(self, tok, pos, budget=None, block_tables=None):
        return serve_decode(self.params, self.arena, tok, pos, self.cfg,
                            self.steps, self.decode_kernel_fn,
                            block_tables=block_tables, budget=budget,
                            **self._kw)

    def __call__(self, tok, pos, budget=None, block_tables=None):
        """Dispatch one chunk from ``tok``/``pos`` (and the budget and
        tables where the signature has them): device tensors, or pinned
        host tensors, whose copies run asynchronously. Returns ``(toks,
        last, pos)`` on the device without waiting for them."""
        if self.device.type != "cuda":
            return self._run(tok, pos, budget, block_tables)
        given = {"tok": tok, "pos": pos, "budget": budget,
                 "block_tables": block_tables}
        for name, buf in self._in.items():
            buf.copy_(given[name], non_blocking=True)
        if self._graph is None:
            if not self._warm:
                return self._warm_up()
            self._capture()
        self._graph.replay()
        self.replays += 1
        for fn, n in self._delta.items():
            fn.launches += n
        return self._out

    def fused(self, slice_fn, tok, pos, budget=None, block_tables=None):
        """Dispatch one decode chunk (as :meth:`__call__`) together with
        one admission slice, ``slice_fn()``: a ``prefill_suffix`` that
        runs eagerly on a side stream and returns its logits, ordered after everything the
        current stream held before the chunk (the slice's caches and
        inputs), so it overlaps the chunk on the card. The current stream
        then waits for the slice: a fence recorded next covers both.
        Neither reads what the other writes, so the results are those of
        the chunk and the slice run one after the other. Returns the
        chunk's ``(toks, last, pos)`` and ``slice_fn()``'s result."""
        if self.device.type != "cuda":
            return self(tok, pos, budget, block_tables), slice_fn()
        cur = torch.cuda.current_stream(self.device)
        ready = torch.cuda.Event()
        ready.record(cur)
        out = self(tok, pos, budget, block_tables)
        if self._slice_stream is None:
            self._slice_stream = torch.cuda.Stream(self.device)
        self._slice_stream.wait_event(ready)
        with torch.cuda.stream(self._slice_stream):
            res = slice_fn()
        cur.wait_stream(self._slice_stream)
        res.record_stream(cur)
        return out, res

    def _warm_up(self):
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            out = self._run(**self._in)
        cur.wait_stream(self._stream)
        for t in out:
            t.record_stream(cur)
        self._warm = True
        return out

    def _capture(self) -> None:
        counters = launch_counted()
        before = [fn.launches for fn in counters]
        t0 = time.perf_counter()
        # torch.cuda.graph synchronizes and empties the allocator's cache
        # itself; doing it first makes the reserved bytes' growth the pool's.
        torch.cuda.synchronize(self.device)
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        sampling = self._kw["sampling"]
        if sampling is not None:
            graph.register_generator_state(sampling.generator)
        with torch.cuda.graph(graph, stream=self._stream):
            out = self._run(**self._in)
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.capture_s = time.perf_counter() - t0
        self._delta = {}
        for fn, n in zip(counters, before):
            if fn.launches != n:
                self._delta[fn] = fn.launches - n
                fn.launches = n
        self._graph, self._out = graph, out
        self.captures += 1


class PersistentRound:
    """One server's persistent decode rounds (counterpart of JAX
    ``_persistent_serve_decode``): greedy steps over the arena (or pool)
    until the cap, a lane's freeze or a live lane's window edge
    (:func:`..models.transformer._decode_while`).

    The round's carry lives in static device tensors
    (:func:`..models.transformer.persistent_state`), loaded from the
    caller's ``tok``/``pos``/``budget``/``window`` (and block tables)
    at the start of each round. On CUDA the round is one CUDA graph of
    ``sub_steps`` steps (:func:`..models.transformer._persistent_steps`)
    replayed back to back: after each replay the host reads the exit flag
    from pinned memory and stops at the first replay that set it, so at
    most ``sub_steps - 1`` steps run past the exit, each a no-op that
    rewrites pinned values (the device folds the exit into the freeze
    mask). ``delivered`` is counted on the device. The first round runs
    eagerly on a side stream (the warm-up), the second captures the
    graph, later rounds replay it; a capture that fails raises, and
    nothing drops back to eager launches. The kernels' launch counters
    count the steps executed: the capture's count is taken back and
    added on every replay. On the CPU every round runs the same steps
    eagerly."""

    def __init__(self, params, arena, cfg, *, batch: int, cap: int, device,
                 sub_steps: int = PERSISTENT_SUB_STEPS, decode_kernel_fn=None,
                 table_width: int = 0, block_size: int = 0, paged_len: int = 0,
                 eos_id: Optional[int] = None):
        if sub_steps < 1 or cap < 1:
            raise ValueError(f"sub_steps {sub_steps} and cap {cap} must be >= 1")
        self.params, self.arena, self.cfg = params, arena, cfg
        self.cap, self.sub_steps = int(cap), int(sub_steps)
        self.device = torch.device(device)
        self.decode_kernel_fn = decode_kernel_fn
        self._kw = dict(block_size=block_size, paged_len=paged_len,
                        eos_id=eos_id)
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0
        self.pool_bytes = 0
        self.executed = 0       # steps run in the last round
        self.executed_total = 0
        self._warm = False
        self._graph = None
        self._delta: dict = {}

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=self.device)

        self.state = persistent_state(zeros(batch), zeros(batch), zeros(batch),
                                      zeros(batch), self.cap)
        self._tables = zeros(batch, table_width) if table_width else None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._stop_host = torch.zeros((), dtype=torch.bool, pin_memory=True)
            self._event = torch.cuda.Event()

    def _steps(self) -> None:
        _persistent_steps(self.params, self.arena, self.state, self.cfg,
                          self.sub_steps, self.cap,
                          attn_fn=attention.reference_attention,
                          decode_kernel_fn=self.decode_kernel_fn,
                          block_tables=self._tables, **self._kw)

    def __call__(self, tok, pos, budget, window, block_tables=None):
        """Run one round from ``tok``/``pos``/``budget``/``window [B]`` (and
        ``block_tables``): device tensors or pinned host tensors. Returns
        ``(out [B, cap], tok, pos)`` on the device (the state's tensors,
        which the next round overwrites) and ``delivered`` as an int; the
        round has finished on the card when this returns."""
        st = self.state
        for name, src in (("tok", tok), ("pos", pos), ("rem", budget),
                          ("window", window)):
            st[name].copy_(src, non_blocking=True)
        st["alive0"].copy_(st["rem"] > 0)
        st["out"].zero_()
        st["delivered"].zero_()
        st["stop"].zero_()
        if self._tables is not None:
            self._tables.copy_(block_tables, non_blocking=True)
        if self.device.type != "cuda":
            self._eager_round()
        elif self._graph is None and not self._warm:
            self._warm_up()
        else:
            if self._graph is None:
                self._capture()
            self._replay_round()
        return st["out"], st["tok"], st["pos"], int(st["delivered"])

    def _eager_round(self) -> None:
        """The round's steps run eagerly, the exit flag read on the host
        after each group of ``sub_steps`` (the CPU, and the warm-up)."""
        st = self.state
        self.executed = 0
        while True:
            self._steps()
            self.executed += self.sub_steps
            if bool(st["stop"]):
                break
        self.executed_total += self.executed

    def _replay_round(self) -> None:
        self.executed = 0
        while True:
            self._graph.replay()
            self.replays += 1
            self.executed += self.sub_steps
            for fn, n in self._delta.items():
                fn.launches += n
            self._stop_host.copy_(self.state["stop"], non_blocking=True)
            self._event.record()
            self._event.synchronize()
            if bool(self._stop_host):
                break
        self.executed_total += self.executed

    def _warm_up(self) -> None:
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            self._eager_round()
        cur.wait_stream(self._stream)
        self._warm = True

    def _capture(self) -> None:
        counters = launch_counted()
        before = [fn.launches for fn in counters]
        t0 = time.perf_counter()
        torch.cuda.synchronize(self.device)
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self._stream):
            self._steps()
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.capture_s = time.perf_counter() - t0
        self._delta = {}
        for fn, n in zip(counters, before):
            if fn.launches != n:
                self._delta[fn] = fn.launches - n
                fn.launches = n
        self._graph = graph
        self.captures += 1
