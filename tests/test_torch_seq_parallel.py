"""PyTorch port, sequence parallelism: the ring block API (K1's plain
version), ring attention, Ulysses, the meshes and the train step over a
``seq`` mesh against the JAX functions on the same numpy inputs (fp32, the
CPU; JAX's Pallas block kernel in interpret mode, at the one tiny shape
that needs it). The port's mesh keeps every shard on one device; JAX's
runs on the forced host devices of ``tests/conftest.py``.

Tolerances: both sides compute the same fp32 arithmetic and differ only
in summation order (XLA's against PyTorch's, a block pair's softmax merged
in another order on the ring), measured at 1e-6 here; 1e-5 on outputs and
logsumexps and 1e-4 on gradients (sums over more terms) stay far below any
masking, offset or merge fault, which moves values by O(1). The train step
is held as ``tests/test_torch_train.py`` holds the one-device step: each
step's loss within 1e-5 relative. Adam normalises each gradient to about
+-lr per weight, so a weight whose gradient is within rounding of zero can
move by up to a step's lr in either direction when the ring sums in
another order (seen: 1.5e-4 and 3e-4 on 1 weight of 16384 and 98304); so
after two steps every weight within the most two updates can part them
(2 x 2 x lr, lr = 1e-3, times 1.001 for the bias correction's excess),
and all but one in 10^3 within 1e-5.
"""
import inspect
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec
import pytest
import torch

from kata_xpu_device_plugin_tpu.ops import collectives as jcoll
from kata_xpu_device_plugin_tpu.ops import flash as jflash
from kata_xpu_device_plugin_tpu.parallel import mesh as jmesh
from kata_xpu_device_plugin_tpu.parallel import sharding as jsh
from kata_xpu_device_plugin_tpu.parallel.ring import make_ring_attention as jring
from kata_xpu_device_plugin_tpu.parallel.ulysses import (
    make_ulysses_attention as julysses,
)
from kata_xpu_device_plugin_tpu_torch.models import llama as tllama
from kata_xpu_device_plugin_tpu_torch.ops import collectives as tcoll
from kata_xpu_device_plugin_tpu_torch.ops import flash as tflash
from kata_xpu_device_plugin_tpu_torch.ops.attention import NEG_INF
from kata_xpu_device_plugin_tpu_torch.parallel import mesh as tmesh
from kata_xpu_device_plugin_tpu_torch.parallel import sharding as tsh
from kata_xpu_device_plugin_tpu_torch.parallel import ring as tring
from kata_xpu_device_plugin_tpu_torch.parallel.ulysses import (
    make_ulysses_attention as tulysses,
)

from .torch_parity import CONFIGS, FAMILIES, build_pair

OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the shapes are tiny, and beside other test
    processes more threads mostly wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, B, S, H, KV, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((B, S, H, D), (B, S, KV, D), (B, S, KV, D), (B, S, H, D))]


def _cpu_mesh(n):
    return tmesh.seq_mesh(n, devices=["cpu"])


# ----- the block API (K1) ------------------------------------------------------

BLOCK_CASES = {  # (q_off, k_off, window, softcap) at S = 128 a block
    "diagonal": (256, 256, 0, 0.0),
    "full": (384, 0, 0, 0.0),
    "window-dead-rows": (384, 0, 300, 0.0),
    "window-across": (256, 128, 160, 0.0),
    "softcap": (128, 0, 0, 30.0),
}


@pytest.mark.parametrize("case", BLOCK_CASES)
def test_block_attention_matches_jax_interpret(case):
    """The plain block API against JAX's ``flash_block_attention`` (the
    Pallas kernel in interpret mode), B=1, S=128, H=2, KV=1, D=64: out on
    the live rows, the lse on every row (a dead row's at or below
    NEG_INF / 2 on both sides), and the gradients of q, k and v under a
    nonzero random cotangent of both outputs (``jax.vjp``)."""
    q_off, k_off, window, cap = BLOCK_CASES[case]
    B, S, H, KV, D = 1, 128, 2, 1, 64
    q, k, v, do = _inputs(3, B, S, H, KV, D)
    dlse = np.random.default_rng(4).standard_normal((B, S, H)).astype(np.float32)

    def jfn(q, k, v):
        return jflash.flash_block_attention(q, k, v, q_off, k_off,
                                            interpret=True, softcap=cap,
                                            window=window)

    (jo, jl), vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in (q, k, v)))
    jg = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    to, tl = tflash.flash_block_attention(*xs, q_off, k_off, softcap=cap,
                                          window=window)
    assert to.dtype == torch.float32 and tl.shape == (B, S, H)
    tg = torch.autograd.grad((to, tl), xs, (torch.from_numpy(do),
                                            torch.from_numpy(dlse)))
    live = tflash.live_rows(S, S, True, window, q_off, k_off).numpy()
    assert live.all() == (case != "window-dead-rows")
    np.testing.assert_allclose(to.detach().numpy()[:, live],
                               np.asarray(jo)[:, live], **OUT_TOL)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **OUT_TOL)
    assert np.isfinite(to.detach().numpy()).all()
    assert (tl.detach().numpy()[:, ~live] <= NEG_INF / 2).all()
    assert (np.asarray(jl)[:, ~live] <= NEG_INF / 2).all()
    for name, a, b in zip("qkv", tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=f"d{name}",
                                   **GRAD_TOL)


def test_block_attention_raises_as_jax():
    """No ``pick_block`` for the length: JAX's ValueError; the zero-offset
    pair is the self-attention flash path (forward and gradients)."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(5, 1, 160, 4, 2, 64))
    with pytest.raises(ValueError, match="no valid flash block"):
        tflash.flash_block_attention(q[:, :100], k[:, :100], v[:, :100], 0, 0)
    with pytest.raises(ValueError, match="no valid flash block"):
        jflash.flash_block_attention(*(jnp.asarray(x.numpy()[:, :100])
                                       for x in (q, k, v)), 0, 0)
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    out, _ = tflash.flash_block_attention(*xs, 0, 0)
    ref = tflash.FlashAttention.apply(*xs, True, 0, 0.0)
    torch.testing.assert_close(out, ref, **OUT_TOL)
    ga = torch.autograd.grad(out, xs, do)
    gb = torch.autograd.grad(ref, xs, do)
    for a, b in zip(ga, gb):
        torch.testing.assert_close(a, b, **GRAD_TOL)


# ----- ring attention ------------------------------------------------------------

RING_CASES = {  # n, S, H, KV, D, window, softcap
    "n2-gqa": (2, 256, 4, 2, 64, 0, 0.0),
    "n4-gqa": (4, 512, 4, 2, 64, 0, 0.0),
    "n4-window": (4, 512, 4, 2, 64, 200, 0.0),
    "n2-softcap": (2, 256, 4, 1, 64, 0, 20.0),
    "n4-window-softcap": (4, 512, 2, 1, 64, 96, 20.0),
}


@pytest.mark.parametrize("case", RING_CASES)
def test_ring_matches_jax(case):
    """The port's ring, on its einsum path and on its block path (the K1
    plain versions and the fp32 merge), against JAX's
    ``make_ring_attention(seq_mesh(n), use_flash=False)``: the output and
    the gradients of q, k and v under a random cotangent."""
    n, S, H, KV, D, window, cap = RING_CASES[case]
    q, k, v, do = _inputs(7, 1, S, H, KV, D)
    jattn = jring(jmesh.seq_mesh(n), use_flash=False)

    def jloss(q, k, v):
        out = jattn(q, k, v, window=window, logits_softcap=cap)
        return jnp.sum(out * jnp.asarray(do)), out

    (_, jo), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                             has_aux=True))(
        *(jnp.asarray(x) for x in (q, k, v)))
    for use_flash in (False, True):
        attn = tring.make_ring_attention(_cpu_mesh(n), use_flash=use_flash)
        xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        out = attn(*xs, window=window, logits_softcap=cap)
        tg = torch.autograd.grad(out, xs, torch.from_numpy(do))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo),
                                   err_msg=f"flash={use_flash}", **OUT_TOL)
        for name, a, b in zip("qkv", tg, jg):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       err_msg=f"flash={use_flash} d{name}",
                                       **GRAD_TOL)


@pytest.mark.parametrize("n,window,pairs", [(4, 0, 10), (4, 200, 9), (2, 0, 3),
                                            (4, 100, 7)])
def test_ring_launches_a_block_per_live_pair(monkeypatch, n, window, pairs):
    """The block path calls the block API once per live (shard, hop) pair:
    the n (n + 1) / 2 pairs of a causal ring, fewer once the window bounds
    the hops (``t_last``), and never a pair with ``src > idx``."""
    calls = []
    real = tflash.flash_block_attention

    def counting(q, k, v, q_offset, k_offset, **kw):
        assert k_offset <= q_offset
        calls.append((q_offset, k_offset))
        return real(q, k, v, q_offset, k_offset, **kw)

    monkeypatch.setattr(tflash, "flash_block_attention", counting)
    S = 128 * n
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(9, 1, S, 2, 1, 64))
    tring.make_ring_attention(_cpu_mesh(n), use_flash=True)(q, k, v,
                                                            window=window)
    assert len(calls) == len(set(calls)) == pairs


def test_ring_raises_what_jax_raises():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(2, 1, 256, 2, 1, 64))
    attn = tring.make_ring_attention(_cpu_mesh(2))
    jattn = jring(jmesh.seq_mesh(2))
    jq, jk, jv = (jnp.asarray(t.numpy()) for t in (q, k, v))
    for kw in (dict(causal=False), dict(q_offset=3)):
        with pytest.raises(ValueError, match="causal self-attention only"):
            attn(q, k, v, **kw)
        with pytest.raises(ValueError, match="causal self-attention only"):
            jattn(jq, jk, jv, **kw)


# ----- Ulysses -------------------------------------------------------------------

@pytest.mark.parametrize("n,H,KV,window,cap", [
    (2, 4, 2, 0, 0.0), (4, 4, 2, 0, 0.0), (4, 8, 1, 8, 0.0), (2, 4, 2, 0, 20.0),
], ids=["kv-split", "kv-per-group", "mqa-window", "softcap"])
def test_ulysses_matches_jax(n, H, KV, window, cap):
    """Ulysses with its default inner attention on both sides (the plain
    version here, XLA's reference there): output and gradients, with the
    KV heads split across the degree or one KV head a query-head group."""
    q, k, v, do = _inputs(11, 2, 32, H, KV, 16)
    jattn = julysses(jmesh.seq_mesh(n))

    def jloss(q, k, v):
        out = jattn(q, k, v, window=window, logits_softcap=cap)
        return jnp.sum(out * jnp.asarray(do)), out

    (_, jo), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                             has_aux=True))(
        *(jnp.asarray(x) for x in (q, k, v)))
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tulysses(_cpu_mesh(n))(*xs, window=window, logits_softcap=cap)
    tg = torch.autograd.grad(out, xs, torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo), **OUT_TOL)
    for name, a, b in zip("qkv", tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=f"d{name}",
                                   **GRAD_TOL)


@pytest.mark.parametrize("n,H,KV,kw,match", [
    (4, 6, 2, {}, "n_heads % sp"),
    (4, 12, 3, {}, "must divide n_kv_heads"),
    (2, 4, 2, dict(causal=False), "causal self-attention only"),
    (2, 4, 2, dict(q_offset=1), "causal self-attention only"),
], ids=["heads", "kv-heads", "non-causal", "q-offset"])
def test_ulysses_raises_what_jax_raises(n, H, KV, kw, match):
    q, k, v, _ = _inputs(12, 1, 16, H, KV, 8)
    with pytest.raises(ValueError, match=match):
        tulysses(_cpu_mesh(n))(*(torch.from_numpy(x) for x in (q, k, v)), **kw)
    with pytest.raises(ValueError, match=match):
        julysses(jmesh.seq_mesh(n))(*(jnp.asarray(x) for x in (q, k, v)), **kw)


# ----- meshes and collectives ------------------------------------------------------

def test_mesh_shapes_match_jax():
    for n in range(1, 17):
        assert tmesh.default_mesh_shape(n) == jmesh.default_mesh_shape(n), n
    for shape in ({"seq": 2}, {"fsdp": 2, "seq": 4}, {"model": 2}):
        n = int(np.prod(list(shape.values())))
        jm = jmesh.build_mesh(shape, jax.devices()[:n])
        tm = tmesh.build_mesh(shape, devices=["cpu"])
        assert tm.axis_names == tuple(jm.axis_names)
        assert tm.shape == dict(jm.shape)
    jm = jmesh.seq_mesh(4)
    tm = tmesh.seq_mesh(4, devices=["cpu"])
    assert tm.axis_names == tuple(jm.axis_names) and tm.shape == dict(jm.shape)
    assert tm.device == torch.device("cpu")
    with pytest.raises(ValueError, match="does not cover"):
        tmesh.build_mesh({"seq": 2}, devices=["cpu"] * 4)


def test_batch_spec_and_shard_batch_match_jax():
    for shape in ({"seq": 2}, {"data": 1, "fsdp": 1, "model": 1}):
        n = int(np.prod(list(shape.values())))
        jm = jmesh.build_mesh(shape, jax.devices()[:n])
        tm = tmesh.build_mesh(shape, devices=["cpu"])
        assert tsh.batch_spec(tm) == tuple(jsh.batch_spec(jm))
    toks = np.arange(12, dtype=np.int32).reshape(2, 6)
    placed = tsh.shard_batch(toks, _cpu_mesh(2))
    assert placed.dtype == torch.int64 and placed.device.type == "cpu"
    np.testing.assert_array_equal(placed.numpy(), toks)


def test_collectives_match_jax():
    """The neighbour hop is a rotation; the ring all-reduce leaves every
    shard the total (JAX's ``ring_all_reduce`` on 4 devices); gather and
    all-to-all are the tiled ``lax`` collectives."""
    x = np.arange(8, dtype=np.float32) + 1.0
    parts = [torch.from_numpy(c) for c in np.split(x, 4)]
    assert [p[0].item() for p in tcoll.ppermute(parts)] == [7.0, 1.0, 3.0, 5.0]
    want = np.asarray(jcoll.ring_all_reduce(jmesh.seq_mesh(4), jnp.asarray(x),
                                            "seq"))
    got = torch.cat(tcoll.ring_all_reduce(parts)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tcoll.all_gather(parts).numpy(), x)
    y = torch.arange(2 * 4 * 6).reshape(2, 4, 6).float()
    shards = list(y.chunk(2, dim=1))  # [2, 2, 6] each: sequence cut in two
    heads = tcoll.all_to_all(shards, split_dim=2, concat_dim=1)
    assert [tuple(h.shape) for h in heads] == [(2, 4, 3)] * 2
    torch.testing.assert_close(torch.cat(heads, dim=2), y)
    back = tcoll.all_to_all(heads, split_dim=1, concat_dim=2)
    for a, b in zip(back, shards):
        torch.testing.assert_close(a, b)


# ----- the train step over a seq mesh ----------------------------------------------

def test_train_step_takes_every_jax_parameter():
    jax_names = set(inspect.signature(jsh.make_train_step).parameters)
    port = inspect.signature(tsh.make_train_step).parameters
    assert jax_names <= set(port), jax_names - set(port)
    assert port["mesh"].kind is inspect.Parameter.KEYWORD_ONLY
    assert list(port)[:7] == ["cfg", "optimizer", "attn_fn", "remat",
                              "accum_steps", "aux_metrics", "device"]


def test_train_step_refuses_unported_axes():
    cfg = tllama.llama3_train_test(dtype=torch.float32)
    for shape in ({"fsdp": 2}, {"model": 2, "seq": 2}, {"data": 2}):
        with pytest.raises(NotImplementedError, match="item 12b"):
            tsh.make_train_step(cfg, mesh=tmesh.build_mesh(shape, devices=["cpu"]))
    with pytest.raises(ValueError, match="not the mesh's device"):
        tsh.make_train_step(cfg, device="meta", mesh=_cpu_mesh(2))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v.detach() if torch.is_tensor(v) else v)
    return out


SEQ_CONFIGS = {
    "llama": (lambda: CONFIGS["llama3_test"](), 2),
    "mistral-window-n4": (lambda: FAMILIES["mistral"](), 4),
    "gemma2-cycle-softcap": (lambda: replace(FAMILIES["gemma2"](), n_layers=2), 2),
    "gemma3-dual-rope": (lambda: replace(FAMILIES["gemma3"](), n_layers=3), 2),
}


@pytest.mark.parametrize("case", SEQ_CONFIGS)
def test_seq_train_step_matches_jax(case):
    """``make_train_step(cfg, mesh=seq_mesh(n))`` against JAX's step on
    ``build_mesh({"seq": n})`` from the same numpy weights (through the
    bridge) and tokens: ring attention on both sides; the first step's
    loss, then the params after two AdamW steps."""
    make_cfg, n = SEQ_CONFIGS[case]
    jcfg = make_cfg()
    jp, tp, tcfg = build_pair(jcfg, seed=2, perturbed=True)
    jm = jmesh.build_mesh({"seq": n}, jax.devices()[:n])
    jopt = jsh.make_optimizer(lr=1e-3)
    _, jstep = jsh.make_train_step(jcfg, jm, jopt)
    # Placed as JAX's ``init_state`` places its state, so the second step
    # reuses the first one's executable.
    params = jsh.shard_params(jp, jm)
    jstate = {"params": params,
              "opt": jax.jit(jopt.init, out_shardings=jsh._opt_shardings(
                  jopt, params, jm))(params),
              "step": jax.device_put(jnp.zeros((), jnp.int32),
                                     NamedSharding(jm, PartitionSpec()))}
    topt = tsh.make_optimizer(lr=1e-3)
    _, tstep = tsh.make_train_step(tcfg, topt, mesh=_cpu_mesh(n))
    tstate = {"params": tp, "opt": topt.init(tp), "step": 0}
    toks = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    for _ in range(2):
        jstate, lj = jstep(jstate, jsh.shard_batch(jnp.asarray(toks), jm))
        tstate, lt = tstep(tstate, tsh.shard_batch(toks, _cpu_mesh(n)))
        np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    assert tstate["step"] == int(jstate["step"]) == 2
    flat_t = _flat(tstate["params"])
    far = total = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(jstate["params"])[0]:
        key = ".".join(p.key for p in path)
        diff = np.abs(flat_t[key] - np.asarray(leaf))
        assert diff.max() <= 2 * 2 * 1e-3 * 1.001, key
        far += int((diff > 1e-5).sum())
        total += diff.size
    assert far <= total * 1e-3, (far, total)
    # The loss of the params after two steps.
    _, lj = jstep(jstate, jsh.shard_batch(jnp.asarray(toks), jm))
    _, lt = tstep(tstate, tsh.shard_batch(toks, _cpu_mesh(n)))
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
