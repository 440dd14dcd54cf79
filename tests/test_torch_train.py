"""PyTorch port, training: ``next_token_loss`` and its gradients, AdamW
steps and the train-step options against the JAX package on the same
numpy weights and tokens (fp32, the CPU)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kata_xpu_device_plugin_tpu.models import llama as jllama
from kata_xpu_device_plugin_tpu.models import transformer as jt
from kata_xpu_device_plugin_tpu.parallel import mesh as jmesh
from kata_xpu_device_plugin_tpu.parallel import sharding as jsh
from kata_xpu_device_plugin_tpu_torch.models import bridge
from kata_xpu_device_plugin_tpu_torch.models import transformer as tt
from kata_xpu_device_plugin_tpu_torch.ops import quant
from kata_xpu_device_plugin_tpu_torch.parallel import sharding as tsh

from .torch_parity import build_pair

# The loss and gradient tolerances of the JAX package's own flash-vs-
# reference training test (tests/test_ops.py): the same fp32 model, with
# only the summation order of XLA and PyTorch differing.
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=3e-3, atol=3e-4)


@pytest.fixture
def one_thread():
    """A fixed summation order for an exact comparison: with several
    threads, MKL by default may run a product on fewer threads than asked
    when the machine is loaded, and so split its sums differently."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _flat_jax(tree):
    """{dotted path: numpy} of a JAX param tree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[".".join(p.key for p in path)] = np.asarray(leaf)
    return out


def _flat_torch(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_torch(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v.detach().numpy()
    return out


def _setup(seed=0):
    jcfg = jllama.llama3_train_test(dtype=jnp.float32)
    jp, tp, tcfg = build_pair(jcfg, seed=seed)
    return jcfg, jp, tp, tcfg


def test_bridge_carries_the_training_layout():
    jcfg, jp, tp, tcfg = _setup()
    assert set(tp["layers"]) == {"attn_norm", "wq", "wk", "wv", "wo", "mlp_norm",
                                 "w_gate", "w_up", "w_down"}
    assert "unembed" in tp and not tcfg.tie_embeddings
    flat_j, flat_t = _flat_jax(jp), _flat_torch(tp)
    assert flat_j.keys() == flat_t.keys()
    for k, a in flat_j.items():
        assert flat_t[k].dtype == np.float32
        np.testing.assert_array_equal(flat_t[k], a)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_next_token_loss_and_grads_match_jax(remat):
    jcfg, jp, tp, tcfg = _setup(seed=1)
    toks = _tokens(2, (2, 17), jcfg.vocab_size)
    lj, gj = jax.value_and_grad(
        lambda p: jt.next_token_loss(p, jnp.asarray(toks), jcfg, remat=remat))(jp)
    xs = {k: v.requires_grad_() for k, v in _flat_torch_tensors(tp).items()}
    lt = tt.next_token_loss(tp, torch.from_numpy(toks), tcfg, remat=remat)
    gt = torch.autograd.grad(lt, list(xs.values()))
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=LOSS_RTOL)
    flat_gj = _flat_jax(gj)
    for (k, _), g in zip(xs.items(), gt):
        np.testing.assert_allclose(g.numpy(), flat_gj[k], err_msg=k, **GRAD_TOL)


def _flat_torch_tensors(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_torch_tensors(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def test_token_nll_sum_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 4
    targets = rng.integers(0, 11, (2, 5)).astype(np.int32)
    want = float(jt.token_nll_sum(jnp.asarray(logits), jnp.asarray(targets)))
    got = float(tt.token_nll_sum(torch.from_numpy(logits), torch.from_numpy(targets)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_unembedding_gradient_matches_jax():
    """``matmul_f32`` (the fp32-logit unembedding) differentiates like
    JAX's ``dot_general`` with ``preferred_element_type=float32``."""
    rng = np.random.default_rng(4)
    a = rng.standard_normal((2, 3, 8)).astype(np.float32)
    b = rng.standard_normal((8, 5)).astype(np.float32)
    g = rng.standard_normal((2, 3, 5)).astype(np.float32)

    def fj(a, b):
        out = jax.lax.dot_general(a, b, (((2,), (0,)), ((), ())),
                                  preferred_element_type=jnp.float32)
        return jnp.sum(out * g)

    gaj, gbj = jax.grad(fj, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    at, bt = torch.from_numpy(a).requires_grad_(), torch.from_numpy(b).requires_grad_()
    out = quant.matmul_f32(at, bt)
    gat, gbt = torch.autograd.grad(out, (at, bt), torch.from_numpy(g))
    np.testing.assert_allclose(gat.numpy(), np.asarray(gaj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gbt.numpy(), np.asarray(gbj), rtol=1e-5, atol=1e-6)


# ----- optimizer -----------------------------------------------------------


@pytest.mark.parametrize("warmup,total", [(0, 0), (3, 10), (0, 7), (2, 5)])
def test_schedule_matches_optax(warmup, total):
    opt = tsh.make_optimizer(lr=1e-2, warmup_steps=warmup, total_steps=total)
    if total:
        ref = optax.warmup_cosine_decay_schedule(0.0, 1e-2, warmup, total,
                                                 1e-2 * 0.1)
    else:
        ref = lambda c: 1e-2  # noqa: E731
    for count in range(total + 3):
        np.testing.assert_allclose(opt.learning_rate(count), float(ref(count)),
                                   rtol=1e-6, atol=1e-12)
    if warmup:
        assert opt.learning_rate(0) == 0.0  # the first update only moves moments


@pytest.mark.parametrize("scale", [0.5, 2.0], ids=["below", "above"])
def test_clip_matches_optax_without_an_epsilon(scale):
    """Grads with a global norm of 2e-3 against a cap of 2e-3 / scale:
    optax scales by ``max / norm`` exactly; an epsilon of 1e-6 on the norm
    (``clip_grad_norm_``'s) would be off by 5e-4 relative, far outside
    the 1e-6 tolerance."""
    rng = np.random.default_rng(5)
    gs = [rng.standard_normal(s).astype(np.float32) for s in ((4, 3), (7,))]
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in gs))
    gs = [g * (2e-3 / norm) for g in gs]
    cap = 2e-3 / scale
    want, _ = optax.clip_by_global_norm(cap).update([jnp.asarray(g) for g in gs],
                                                    None)
    got = [torch.from_numpy(g.copy()) for g in gs]
    tsh.AdamW(grad_clip=cap).clip(got)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)


def _jax_state(jp, jcfg, optimizer, mesh):
    params = jsh.shard_params(jp, mesh)
    return {"params": params, "opt": optimizer.init(params),
            "step": jnp.zeros((), jnp.int32)}


def test_three_adamw_steps_match_jax():
    """Three steps of ``make_train_step`` against the JAX step on a one-
    device CPU mesh, from the same numpy params and batches, with a warmup-
    cosine schedule and clipping that triggers (first update at lr 0).
    Losses within 1e-5 relative; params within 1e-5 absolute, 1% of the
    ~lr = 1e-3 that Adam's normalised update moves a weight each step. Most
    weights agree to 1e-7; the margin is for the few whose gradient is
    near its own rounding, where g / (|g| + eps) differs by more than the
    gradient does (seen: 2.9e-6 on 1 of 65536 embedding weights)."""
    jcfg, jp, tp, tcfg = _setup(seed=6)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=5, grad_clip=0.05)
    mesh = jmesh.build_mesh({"data": 1, "fsdp": 1, "model": 1},
                            devices=jax.devices()[:1])
    jinit, jstep = jsh.make_train_step(jcfg, mesh, jsh.make_optimizer(**kw),
                                       aux_metrics=True)
    jstate = _jax_state(jp, jcfg, jsh.make_optimizer(**kw), mesh)
    opt = tsh.make_optimizer(**kw)
    _, tstep = tsh.make_train_step(tcfg, opt, aux_metrics=True, device="cpu")
    tstate = {"params": tp, "opt": opt.init(tp), "step": 0}
    for i in range(3):
        toks = _tokens(10 + i, (2, 17), jcfg.vocab_size)
        jstate, lj, auxj = jstep(jstate, jnp.asarray(toks))
        tstate, lt, auxt = tstep(tstate, toks)
        np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
        np.testing.assert_allclose(float(auxt["grad_norm"]),
                                   float(auxj["grad_norm"]), rtol=1e-4)
        assert float(auxj["grad_norm"]) > kw["grad_clip"]  # clipping triggers
    assert tstate["step"] == int(jstate["step"]) == 3
    flat_j, flat_t = _flat_jax(jstate["params"]), _flat_torch(tstate["params"])
    for k, a in flat_j.items():
        np.testing.assert_allclose(flat_t[k], a, rtol=0, atol=1e-5, err_msg=k)


def test_accumulation_equals_the_full_batch():
    """``accum_steps=2`` against the full batch on the same tokens: the
    mean of two equal microbatch means is the full-batch mean, up to fp32
    summation order. As the JAX package's test does, the loss and the sum
    of |params| within 1e-5 relative; each weight within 1e-4, a tenth of
    one lr = 1e-3 update, because Adam normalises the gradient and a
    weight whose gradient is near its rounding can move by a visible share
    of a step (seen: 3.1e-5 on 2 of 65536)."""
    jcfg, jp, tp, tcfg = _setup(seed=7)
    toks = _tokens(8, (4, 17), jcfg.vocab_size)
    runs = []
    for accum in (1, 2):
        _, _, params, _ = _setup(seed=7)
        opt = tsh.make_optimizer(lr=1e-3)
        _, step = tsh.make_train_step(tcfg, opt, accum_steps=accum, device="cpu")
        state, loss = step({"params": params, "opt": opt.init(params), "step": 0},
                           toks)
        runs.append((float(loss), _flat_torch(state["params"])))
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-5)
    fp = [sum(float(np.abs(a).sum()) for a in r[1].values()) for r in runs]
    np.testing.assert_allclose(fp[1], fp[0], rtol=1e-5)
    for k, a in runs[0][1].items():
        np.testing.assert_allclose(runs[1][1][k], a, rtol=0, atol=1e-4, err_msg=k)
    with pytest.raises(ValueError, match="accum_steps"):
        tsh.make_train_step(tcfg, accum_steps=3, device="cpu")[1](
            {"params": tp, "opt": opt.init(tp), "step": 0}, toks)
    with pytest.raises(ValueError, match="accum_steps"):
        tsh.make_train_step(tcfg, accum_steps=0, device="cpu")


def test_remat_equals_plain_exactly(one_thread):
    _, _, _, tcfg = _setup()
    toks = _tokens(9, (2, 17), tcfg.vocab_size)
    out = []
    for remat in (False, True):
        _, _, params, _ = _setup(seed=8)
        opt = tsh.make_optimizer(lr=1e-3)
        _, step = tsh.make_train_step(tcfg, opt, remat=remat, device="cpu")
        state = {"params": params, "opt": opt.init(params), "step": 0}
        for _ in range(2):
            state, loss = step(state, toks)
        out.append((float(loss), _flat_torch(state["params"])))
    assert out[0][0] == out[1][0]
    for k, a in out[0][1].items():
        np.testing.assert_array_equal(out[1][1][k], a, err_msg=k)


def test_init_state_matches_the_contract():
    cfg = dataclasses.replace(tt.tiny_test_config(dtype=torch.float32), n_layers=1)
    init, _ = tsh.make_train_step(cfg, device="cpu")
    state = init(3)
    assert set(state) == {"params", "opt", "step"} and state["step"] == 0
    assert state["params"]["embed"].dtype == torch.float32
    assert state["opt"]["count"] == 0
    assert all(not t.any() for t in tsh.leaves(state["opt"]["mu"]))
    a = tsh.leaves(init(3)["params"])
    assert all(torch.equal(x, y) for x, y in zip(a, tsh.leaves(state["params"])))
