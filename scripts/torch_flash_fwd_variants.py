#!/usr/bin/env python3
"""Variants of the flash forward kernel side by side on one card: each a
copy of ``csrc/flash_fwd.cu`` with one change, built with nvcc beside the
others, held against the plain version, then timed in turns by CUDA-graph
replay at the Gemma-2B prefill shape and the two training shapes (with the
lse), beside SDPA's forward. What ``scripts/torch_flash_fwd_timing.py``
cannot do: compare designs that are not a checkout.

    python3 scripts/torch_flash_fwd_variants.py [--derive NAME ...] [VARIANT.cu ...]

``--derive`` adds variants made from this checkout's ``csrc/flash_fwd.cu``
by one substitution each, to measure where the time goes (their outputs
are wrong by design, so they are timed without the check): ``fastexp``
(``__expf`` for ``expf``), ``no_s`` (S = Q K^T not issued), ``no_pv``
(O += p V not issued), ``no_softmax`` (the logits only scaled, no max,
exponential or sum). The source itself is always the first variant,
``kernel``. Each other variant is checked in a process of its own under a
timeout, so that one that hangs (a ``setmaxnreg`` waiting for registers
nobody frees) dies with its process; a variant that fails is not timed.
Prints one JSON line per variant built, per check and per timed case. Needs
a CUDA card and nvcc; builds into ``build/fwd_variants/``.
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(HERE, "build", "fwd_variants")
DERIVED = {  # name: (text in csrc/flash_fwd.cu, its replacement)
    "fastexp": ("const float pe = expf(", "const float pe = __expf("),
    "no_s": ("          wg::wgmma_ss<NK>(sc,", "          if (p.Sq < 0) wg::wgmma_ss<NK>(sc,"),
    "no_pv": ("          wg::wgmma_rs<D>(o,", "          if (p.Sq < 0) wg::wgmma_rs<D>(o,"),
    "no_softmax": (
        """        float corr[2];
        if (tile_live<NK>(p, qw, k0))
          softmax_tile<CAP, false>(p, sc, qpos, k0 + 2 * t4, m, l, corr);
        else
          softmax_tile<CAP, true>(p, sc, qpos, k0 + 2 * t4, m, l, corr);""",
        """        float corr[2] = {1.f, 1.f};
#pragma unroll
        for (int i = 0; i < NK / 2; ++i) sc[i] *= p.scale;"""),
}
CHECKS = [  # (B, S, H, KV, D, causal, window, softcap)
    (2, 256, 8, 2, 128, False, 0, 0.0), (2, 256, 8, 2, 64, True, 0, 0.0),
    (1, 320, 4, 1, 256, True, 96, 30.0), (2, 160, 8, 2, 128, True, 0, 0.0),
    (1, 320, 8, 1, 256, True, 0, 0.0), (2, 2048, 32, 8, 128, True, 0, 0.0),
]


def _timing():
    spec = importlib.util.spec_from_file_location(
        "torch_flash_fwd_timing", os.path.join(HERE, "scripts", "torch_flash_fwd_timing.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(sources: dict) -> dict:
    """nvcc for every variant at once; ``{name: library path}`` of those
    that built."""
    sys.path.insert(0, HERE)
    from kata_xpu_device_plugin_tpu_torch.ops import _build

    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        lib = os.path.join(OUT, f"lib{name}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", lib, src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        keep = sorted({ln.strip()[:160] for ln in log.splitlines() if any(
            t in ln for t in ("registers", "error", "C75"))
            or ("spill" in ln and " 0 bytes spill stores" not in ln)})
        print(json.dumps({"variant": name, "rc": proc.returncode, "ptxas": keep}),
              flush=True)
        if proc.returncode == 0:
            libs[name] = lib
    return libs


def kernel(lib: str):
    fn = ctypes.CDLL(lib).flash_fwd_bf16
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    fn.argtypes = [P] * 5 + [I] * 6 + [L] * 9 + [I, I, F, F, P]
    fn.restype = ctypes.c_int

    def call(q, k, v, causal=True, window=0, softcap=0.0, lse=False):
        import torch

        B, Sq, H, D = q.shape
        out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
        ls = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
              if lse else None)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if ls is None else ls.data_ptr(), B, Sq, k.shape[1], H,
                 k.shape[2], D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 int(causal), int(window), float(softcap), D ** -0.5,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return (out, ls) if lse else out
    return call


def check(name: str, lib: str) -> None:
    """Both instantiations against the plain version at the edge shapes,
    the lse within the card tests' bound, a relaunch bit-equal."""
    import torch

    sys.path.insert(0, HERE)
    from kata_xpu_device_plugin_tpu_torch.ops import attention, flash

    tm, fwd, worst, bad = _timing(), kernel(lib), 0.0, []
    for B, S, H, KV, D, causal, window, softcap in CHECKS:
        q, k, v = tm.fused_qkv(B, S, H, KV, D, S + D + H)
        rkw = dict(causal=causal, window=window, logits_softcap=softcap)
        ref = attention.reference_attention(q, k, v, **rkw)
        mag = attention.reference_attention(q.float(), k.float(), v.abs().float(), **rkw)
        _, ref_lse = flash.flash_reference(q, k, v, causal, window, softcap)
        for lse in (False, True):
            runs = [fwd(q, k, v, causal, window, softcap, lse) for _ in range(2)]
            out = runs[0][0] if lse else runs[0]
            res = attention.kernel_tolerance(out, ref, mag)
            worst = max(worst, res["max_err_over_bound"])
            ok = res["ok"] and all(torch.equal(a, b) for a, b in zip(
                *(r if lse else (r,) for r in runs)))
            if lse:
                ok = ok and torch.allclose(runs[0][1], ref_lse, atol=1e-4, rtol=1e-5)
            if not ok:
                bad.append([B, S, H, KV, D, causal, window, softcap, lse])
    print(json.dumps({"variant": name, "check_worst_over_bound": worst,
                      "failed": bad}), flush=True)
    sys.exit(1 if bad else 0)


def time_all(libs: dict) -> None:
    """Every variant at every timed case, in turns (forward, then reverse
    order), and SDPA once a case."""
    import torch
    import torch.nn.functional as F

    tm = _timing()
    cs = tm.cs
    smi = cs.phase_device()
    fwds = {n: kernel(lib) for n, lib in libs.items()}
    times = {}
    for name in list(fwds) + list(fwds)[::-1]:
        for case, B, S, H, KV, D, lse in tm.CASES:
            q, k, v = tm.fused_qkv(B, S, H, KV, D, B * S + H + D)
            times.setdefault(case, {}).setdefault(name, []).append(
                cs.graph_ms(lambda: fwds[name](q, k, v, lse=lse), 20))
    for case, B, S, H, KV, D, lse in tm.CASES:
        q, k, v = tm.fused_qkv(B, S, H, KV, D, B * S + H + D)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = cs.graph_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 20)
        print(json.dumps({"case": case, "sdpa_ms": sdpa, **times[case],
                          **cs.flash_fwd_bound(B, S, H, KV, D, True, lse),
                          "device": smi}), flush=True)
    torch.cuda.synchronize()


def main(argv: list[str]) -> int:
    if argv[:1] == ["--check-one"]:
        check(argv[1], argv[2])
    derive = []
    while argv[:1] == ["--derive"]:
        derive.append(argv[1])
        argv = argv[2:]
    src = os.path.join(HERE, "kata_xpu_device_plugin_tpu_torch", "csrc", "flash_fwd.cu")
    sources = {"kernel": src}
    os.makedirs(OUT, exist_ok=True)
    for name in derive:
        old, new = DERIVED[name]
        text = open(src).read()
        if old not in text:
            raise SystemExit(f"--derive {name}: the source no longer has its text")
        sources[name] = os.path.join(OUT, f"{name}.cu")
        with open(sources[name], "w") as f:
            f.write(text.replace(old, new))
    for path in argv:
        sources[os.path.splitext(os.path.basename(path))[0]] = os.path.abspath(path)
    libs = build(sources)
    timed = {}
    for name, lib in libs.items():
        if name in derive:
            timed[name] = lib  # wrong by design: timed only
            continue
        try:
            rc = subprocess.run([sys.executable, __file__, "--check-one", name, lib],
                                timeout=120).returncode
        except subprocess.TimeoutExpired:
            rc = "timeout"
        if rc == 0:
            timed[name] = lib
        else:
            print(json.dumps({"variant": name, "check": f"failed ({rc})"}), flush=True)
    time_all(timed)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
