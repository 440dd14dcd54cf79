"""PyTorch port, LoRA and QLoRA (``ops/lora.py``) against the JAX package's
``ops/lora.py`` on the same numpy weights (fp32, the CPU): JAX's adapted
trees carried across by the bridge give the port's logits; a fresh adapter
is the base model bit for bit (forward and served tokens); ``merge_lora``;
QLoRA over an int8 fused base; three ``make_lora_train_step`` steps
against JAX's; the trainable mask; a tp=2 LoRA server against tp=1 and
against the JAX server; the refusals.

Tolerances: logits within 1e-4 of their scale (fp32, the two libraries'
summation orders); merged weights within 1e-6; adapters after three Adam
steps within 1e-5 (the train tests' bound: Adam moves a weight ~lr = 1e-3
a step); losses within 1e-5 relative; tokens equal."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kata_xpu_device_plugin_tpu.guest.serving import GenerationServer as JaxServer
from kata_xpu_device_plugin_tpu.models import transformer as jt
from kata_xpu_device_plugin_tpu.ops import lora as jlora
from kata_xpu_device_plugin_tpu.ops import quant as jquant
from kata_xpu_device_plugin_tpu_torch.guest.serving import GenerationServer
from kata_xpu_device_plugin_tpu_torch.models import bridge
from kata_xpu_device_plugin_tpu_torch.models import transformer as tt
from kata_xpu_device_plugin_tpu_torch.ops import lora as tlora
from kata_xpu_device_plugin_tpu_torch.ops import quant as tquant
from kata_xpu_device_plugin_tpu_torch.parallel import sharding as tsh

from .torch_parity import CONFIGS, numpy_pair


@pytest.fixture(scope="module")
def model():
    jcfg = CONFIGS["tiny"]()
    return (jcfg,) + numpy_pair(jcfg, seed=11)


def _toks(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.int32)


def _nonzero_b(tree, seed):
    """JAX's adapted tree with every ``b`` drawn by numpy (0.1 x normal), so
    the adapters change the model."""
    rng = np.random.default_rng(seed)
    layers = dict(tree["layers"])
    for k, v in layers.items():
        if isinstance(v, jlora.LoRAWeight):
            b = (0.1 * rng.standard_normal(v.b.shape)).astype(np.float32)
            layers[k] = v._replace(b=jnp.asarray(b))
    return {**tree, "layers": layers}


def _to_port(tree, tcfg):
    return bridge.params_from_numpy(jax.tree.map(np.asarray, tree), tcfg, "cpu")


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_fresh_adapter_is_the_base_model(model):
    """``b = 0``: forward and ``generate`` bit-equal to the base, plain and
    QLoRA; the adapters are fp32 with the leading layer axis on ``scale``."""
    _, _, tp, tcfg = model
    gen = torch.Generator().manual_seed(0)
    adapted = tlora.apply_lora(tp, gen, rank=4)
    wq = adapted["layers"]["wq"]
    assert isinstance(wq, tlora.LoRAWeight)
    assert wq.a.shape == (2, 64, 4) and wq.b.shape == (2, 4, 128)
    assert wq.scale.shape == (2,) and float(wq.scale[0]) == 4.0
    assert not wq.b.any()
    toks = torch.from_numpy(_toks(1, (2, 12))).long()
    assert torch.equal(tt.forward(adapted, toks, tcfg), tt.forward(tp, toks, tcfg))
    out = tt.generate(adapted, toks[:1, :6], tcfg, 8, max_len=16, device="cpu")
    ref = tt.generate(tp, toks[:1, :6], tcfg, 8, max_len=16, device="cpu")
    assert torch.equal(out, ref)
    qbase = tquant.quantize_decoder_params(tt.fuse_decoder_params(tp))
    qadapted = tlora.apply_lora(qbase, gen, rank=4, targets=("wqkv", "wo"))
    assert torch.equal(tt.forward(qadapted, toks, tcfg), tt.forward(qbase, toks, tcfg))


def test_adapted_logits_match_jax(model):
    """JAX's adapted tree (non-zero ``b``) through the bridge: the port's
    logits within 1e-4 of scale of JAX's, and the adapters moved them
    (the loss is held against JAX's in the train-step test)."""
    jcfg, jp, tp, tcfg = model
    jad = _nonzero_b(jlora.apply_lora(jp, jax.random.PRNGKey(1), rank=4), 2)
    tad = _to_port(jad, tcfg)
    assert isinstance(tad["layers"]["wo"], tlora.LoRAWeight)
    toks = _toks(3, (2, 12))
    want = jt.forward(jad, jnp.asarray(toks), jcfg)
    got = tt.forward(tad, torch.from_numpy(toks).long(), tcfg)
    _close(got, want)
    base = tt.forward(tp, torch.from_numpy(toks).long(), tcfg)
    assert float((got - base).abs().max()) > 1e-2


def test_merge_matches_jax_and_the_adapted_model(model):
    jcfg, jp, _, tcfg = model
    jad = _nonzero_b(jlora.apply_lora(jp, jax.random.PRNGKey(4), rank=4), 5)
    tad = _to_port(jad, tcfg)
    jm, tm = jlora.merge_lora(jad), tlora.merge_lora(tad)
    for k in ("wq", "wk", "wv", "wo"):
        assert not isinstance(tm["layers"][k], tuple)
        np.testing.assert_allclose(tm["layers"][k].numpy(),
                                   np.asarray(jm["layers"][k]), rtol=0, atol=1e-6)
    toks = torch.from_numpy(_toks(6, (2, 12))).long()
    np.testing.assert_allclose(tt.forward(tm, toks, tcfg).numpy(),
                               tt.forward(tad, toks, tcfg).numpy(),
                               rtol=2e-5, atol=2e-5)


def test_qlora_matches_jax(model):
    """An int8 fused base with adapters on ``wqkv`` and ``w_gateup``: the
    bridge carries the int8 base inside the adapter; logits match JAX's;
    the merge dequantizes to fp32 as JAX's does."""
    jcfg, jp, _, tcfg = model
    jq = jquant.quantize_decoder_params(jt.fuse_decoder_params(jp))
    jad = _nonzero_b(jlora.apply_lora(jq, jax.random.PRNGKey(7), rank=4,
                                      targets=("wqkv", "w_gateup")), 8)
    tad = _to_port(jad, tcfg)
    assert isinstance(tad["layers"]["wqkv"].base, tquant.QTensor)
    toks = _toks(9, (2, 10))
    _close(tt.forward(tad, torch.from_numpy(toks).long(), tcfg),
           jt.forward(jad, jnp.asarray(toks), jcfg))
    merged = tlora.merge_lora(tad)["layers"]["wqkv"]
    assert merged.dtype == torch.float32
    np.testing.assert_allclose(merged.numpy(),
                               np.asarray(jlora.merge_lora(jad)["layers"]["wqkv"]),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("qlora", [False, True], ids=["lora", "qlora"])
def test_three_lora_steps_match_jax(model, qlora):
    """Three ``make_lora_train_step`` steps against JAX's on the same
    adapted tree and batches: losses within 1e-5 relative, every adapter
    within 1e-5, the base and every other leaf untouched (bit-equal)."""
    jcfg, jp, _, tcfg = model
    if qlora:
        jp = jquant.quantize_decoder_params(jt.fuse_decoder_params(jp))
        targets = ("wqkv", "wo")
    else:
        targets = jlora.DEFAULT_TARGETS
    jad = jlora.apply_lora(jp, jax.random.PRNGKey(2), rank=4, targets=targets)
    tad = _to_port(jad, tcfg)
    frozen = {k: [t.clone() for t in tsh.leaves(v)]
              for k, v in tad["layers"].items()}
    jinit, jstep = jlora.make_lora_train_step(jcfg, lr=1e-3)
    tinit, tstep = tlora.make_lora_train_step(tcfg, lr=1e-3)
    js, ts = jinit(jad), tinit(tad)
    for i in range(3):
        toks = _toks(20 + i, (2, 16))
        js, lj = jstep(js, jnp.asarray(toks))
        ts, lt = tstep(ts, toks)
        np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    assert ts["step"] == int(js["step"]) == 3
    jt_, _ = jlora.split_trainable(js["params"])
    tt_, _ = tlora.split_trainable(ts["params"])
    assert len(tt_) == len(jt_) == 2 * len(targets)
    for g, w in zip(tt_, jt_):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    for k, v in ts["params"]["layers"].items():
        if isinstance(v, tlora.LoRAWeight):
            base = tsh.leaves(v.base)
            assert all(torch.equal(a, b) for a, b in zip(base, frozen[k]))
            assert torch.equal(v.scale, frozen[k][-1])
            assert v.b.abs().max() > 0
        else:
            assert all(torch.equal(a, b) for a, b in
                       zip(tsh.leaves(v), frozen[k]))


def test_trainable_mask_is_jax_s(model):
    jcfg, jp, _, tcfg = model
    jq = jquant.quantize_decoder_params(jt.fuse_decoder_params(jp))
    jad = jlora.apply_lora(jq, jax.random.PRNGKey(3), targets=("wqkv",))
    tad = _to_port(jad, tcfg)
    assert (tsh.leaves(tlora.lora_trainable_mask(tad))
            == jax.tree.leaves(jlora.lora_trainable_mask(jad)))
    trainable, rebuild = tlora.split_trainable(tad)
    assert [t.shape for t in trainable] == [(2, 64, 8), (2, 8, 192)]
    again = rebuild(trainable)
    assert all(a is b for a, b in zip(tsh.leaves(again), tsh.leaves(tad)))


SERVE = dict(max_len=48, prefill_buckets=(8, 16), chunk=4, kv_quant=True)
LENGTHS = (5, 7, 11, 16, 3)
BUDGETS = (6, 9, 4, 12, 7)


def _serve(srv):
    rng = np.random.default_rng(12)
    rids = [srv.submit(rng.integers(0, 256, n).astype(np.int32), b)
            for n, b in zip(LENGTHS, BUDGETS)]
    out = srv.run()
    return [np.asarray(out[r]) for r in rids]


@pytest.mark.parametrize("qlora", [False, True], ids=["lora", "qlora"])
def test_lora_servers_match_jax_and_tp(model, qlora):
    """An adapted fused tree (non-zero ``b`` on ``wqkv`` and ``wo``: a
    column- and a row-parallel weight) served paged and overlapped by the
    JAX server and the port's at tp=1, and by the port's at tp=2 under
    each KV layout: every token equal. Each shard holds its slice of the
    base and of ``b`` (``wqkv``) or ``a`` (``wo``)."""
    jcfg, jp, _, tcfg = model
    jp = jt.fuse_decoder_params(jp)
    if qlora:
        jp = jquant.quantize_decoder_params(jp)
    jad = _nonzero_b(jlora.apply_lora(jp, jax.random.PRNGKey(5), rank=4,
                                      targets=("wqkv", "wo")), 13)
    tad = _to_port(jad, tcfg)
    kw = dict(SERVE, max_batch=3, kv_pool_tokens=96, kv_block_size=4)
    want = _serve(JaxServer(jad, jcfg, **kw))
    for tp, layout in ((1, "heads"), (2, "heads"), (2, "blocks")):
        srv = GenerationServer(tad, tcfg, device="cpu", tp=tp, kv_layout=layout,
                               **kw)
        if tp > 1:
            sh = srv.params["shards"]
            assert sh[0]["wqkv"].a.shape == (2, 64, 4)  # whole in axis
            assert sh[0]["wqkv"].b.shape == (2, 4, 96)  # half of q+2kv
            assert sh[0]["wo"].a.shape == (2, 64, 4)  # half of q_dim
            assert sh[0]["wo"].b.shape == (2, 4, 64)
        for g, w in zip(_serve(srv), want):
            np.testing.assert_array_equal(g, w, err_msg=f"tp={tp} {layout}")


def test_refusals(model):
    _, _, tp, tcfg = model
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="targets"):
        tlora.apply_lora(tp, gen, targets=("nope",))
    with pytest.raises(ValueError, match="fuse_decoder_params first"):
        tt.fuse_decoder_params(tlora.apply_lora(tp, gen))
    with pytest.raises(ValueError, match="fuse_decoder_params first"):
        tt.fuse_decoder_params(tquant.quantize_decoder_params(tp))
    with pytest.raises(ValueError, match="merge_lora"):
        tquant.quantize_decoder_params(tlora.apply_lora(tp, gen))
    with pytest.raises(NotImplementedError, match="item 12b"):
        tlora.make_lora_train_step(tcfg, mesh=object())
    with pytest.raises(ValueError, match="apply_lora first"):
        tlora.make_lora_train_step(tcfg)[0](tp)
