"""The server's decode executable: one decode chunk, dispatched on CUDA as
one CUDA graph (counterpart of the jitted ``_serve_decode`` in
``kata_xpu_device_plugin_tpu/guest/serving.py`` and its per-server
executable cache).

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
before it dispatches the next chunk.

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

from ..models.transformer import _decode_scan
from ..ops import attention


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
