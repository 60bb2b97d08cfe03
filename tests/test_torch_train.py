"""The port's training path against the JAX package's, on the CPU, fp32.

Held, each with its tolerance:
  * ``models.loss_fn`` and every gradient leaf against
    ``jax.value_and_grad`` for the dense (tinyllama), vlm (qwen2-vl, with
    vision embeds), moe (kimi-k2: a dense and a moe layer; arctic) , ssm
    (mamba2) and hybrid (zamba2) families, reduced, with masked labels:
    the loss within rtol 1e-5, each gradient leaf within 1e-4 of the
    leaf's largest magnitude (fp32 sums in two frameworks' orders); the
    dense family also through the kernel route forced on the CPU (the
    ``torch.autograd.Function``s of K6 and K8, their backward's plain
    versions);
  * ``chunked_xent`` (chunks, a ragged tail, masked labels) within rtol
    1e-6 and its gradients within 1e-6 of their largest magnitude;
  * ``adamw.update`` (fp32 and bf16 parameters), ``clip_by_global_norm``
    and ``cosine_schedule`` within rtol 1e-6 (the moments within 1e-5: a
    few fp32 roundings; the learning rate also within 1e-6 of its base,
    where the cosine's tail cancels; bf16 parameters within one bf16 step,
    where the fp32 results straddle a rounding);
  * ``synthetic_batch`` byte for byte (and through the ``Prefetcher``,
    in step order); ``compress_grads`` int8 values
    equal, scales and residuals within rtol 1e-6; ``microbatch_grads``
    within the loss_fn tolerances;
  * the twin of ``tests/test_system.py::test_train_with_crash_and_restart``:
    ``restarts == 1``, ``final_step == 30``, the loss falls, and every
    step's loss (replays included) within 2e-4 of JAX's run;
  * the train CLI at ``--device cpu``; the forward-only guard: with the
    kernel route forced on the CPU, every forward-only wrapper raises
    ``NotImplementedError`` when an input requires grad; the ssm / hybrid
    losses there train through K7 / K12 and K8 / K11's gate variant and
    equal JAX's.
"""
import functools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.data.pipeline import synthetic_batch as j_synthetic_batch
from repro.dist.collectives import compress_grads as j_compress
from repro.dist.collectives import microbatch_grads as j_microbatch
from repro.models import init_params as j_init_params
from repro.models import loss_fn as j_loss_fn
from repro.models.layers import chunked_xent as j_chunked_xent
from repro.optim import adamw as j_adamw
from repro.runtime import TrainConfig as JTrainConfig
from repro.runtime import train as j_train
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.data import Prefetcher, batch_to, synthetic_batch
from repro_torch.dist.collectives import (compress_grads, decompress_grads,
                                          init_residual, microbatch_grads)
from repro_torch.kernels.coherence_sim import kernel as CSK
from repro_torch.kernels.decode_attention import kernel as DK
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rmsnorm import kernel as RK
from repro_torch.kernels.rmsnorm import ops as norm_ops
from repro_torch.kernels.ssd_scan import kernel as SK
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.tardis_lease import kernel as LK
from repro_torch.launch import train as train_cli
from repro_torch.models import attention, chunked_xent, layers, loss_fn, ssm
from repro_torch.optim import adamw
from repro_torch.runtime import TrainConfig, train
from repro_torch.tree import leaves, tree_map, value_and_grad

LOSS = dict(rtol=1e-5, atol=0)
GRAD_REL = 1e-4          # gradient leaf error / the leaf's max |value|
STEP_LOSS = dict(rtol=2e-4, atol=0)

# family -> (arch, reduced overrides)
FAMILIES = {"dense": ("tinyllama-1.1b", {}),
            "vlm": ("qwen2-vl-72b", {}),
            "moe": ("kimi-k2-1t-a32b", dict(vocab=128)),
            "moe_residual": ("arctic-480b", dict(vocab=128)),
            "ssm": ("mamba2-130m", {}),
            "hybrid": ("zamba2-2.7b", {})}


@functools.lru_cache(maxsize=None)
def _model(family):
    arch, over = FAMILIES[family]
    cfg = reduced(get_arch(arch), **over)
    tcfg = t_reduced(t_get_arch(arch), **over)
    params = j_init_params(cfg, jax.random.PRNGKey(3), jnp.float32)
    return cfg, tcfg, params, params_from_jax(jax.tree.map(np.asarray,
                                                           params))


def _batch(cfg, b=2, s=40, seed=0, vision=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels[0, :5] = -1                       # masked
    labels[1, -3:] = -1
    out = {"tokens": toks, "labels": labels}
    if vision:
        out["vision_embeds"] = rng.standard_normal(
            (b, 4, cfg.d_model)).astype(np.float32)
    return out


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _hold_grads(got, want_jax):
    """Each port gradient leaf within GRAD_REL of its JAX leaf's largest
    magnitude (the JAX tree carried across as the parameters are)."""
    want = params_from_jax(jax.tree.map(np.asarray, want_jax))
    g_leaves, w_leaves = leaves(got), leaves(want)
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        assert g.shape == w.shape and g.dtype == w.dtype
        scale = max(float(w.abs().max()), 1e-12)
        err = float((g - w).abs().max())
        assert err <= GRAD_REL * scale, (tuple(g.shape), err, scale)


@pytest.fixture
def kernel_route(monkeypatch):
    """The card's routing on CPU tensors: attention, SSD scans and norms
    go through the kernels' ops wrappers (their plain versions here)."""
    monkeypatch.setattr(attention, "_flash_kernel_eligible",
                        lambda q, k, window: window == 0)
    monkeypatch.setattr(ssm, "_ssd_kernel_eligible", lambda x: True)
    monkeypatch.setattr(layers, "_rmsnorm_kernel_eligible", lambda x: True)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_grads_match_jax(family):
    cfg, tcfg, params, tparams = _model(family)
    batch = _batch(cfg, vision=family == "vlm")
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: j_loss_fn(cfg, p, batch)))(params)
    tl, tg = value_and_grad(lambda p, b: loss_fn(tcfg, p, b), tparams,
                            _t(batch))
    np.testing.assert_allclose(float(tl), float(jl), **LOSS)
    _hold_grads(tg, jg)


def test_loss_and_grads_through_the_kernel_route_match_jax(kernel_route):
    """K6 and K8 as ``torch.autograd.Function``s (forward: the kernels'
    wrappers; backward: K10's and K11's plain versions on the CPU)."""
    cfg, tcfg, params, tparams = _model("dense")
    batch = _batch(cfg, s=48)
    calls = {"fb": 0, "nb": 0}
    fb, nb = flash_ops.flash_backward, norm_ops.rmsnorm_backward

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    flash_ops.flash_backward = count("fb", fb)
    norm_ops.rmsnorm_backward = count("nb", nb)
    try:
        jl, jg = jax.jit(jax.value_and_grad(
            lambda p: j_loss_fn(cfg, p, batch)))(params)
        tl, tg = value_and_grad(lambda p, b: loss_fn(tcfg, p, b), tparams,
                                _t(batch))
    finally:
        flash_ops.flash_backward, norm_ops.rmsnorm_backward = fb, nb
    assert calls == {"fb": cfg.n_layers, "nb": 2 * cfg.n_layers + 1}
    np.testing.assert_allclose(float(tl), float(jl), **LOSS)
    _hold_grads(tg, jg)


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_forward_only_kernels_raise_under_autograd(kernel_route, family):
    """On the kernel route the ssm and hybrid families train: K7 and K8's
    gate variant run as ``torch.autograd.Function``s whose backward is K12
    and K11's gate variant (their plain versions on the CPU).  The loss
    and every gradient leaf equal ``jax.value_and_grad``'s, and each
    backward wrapper runs once a Mamba2 layer.  (The name is kept from
    when these two families raised here.)"""
    cfg, tcfg, params, tparams = _model(family)
    batch = _batch(cfg, s=40)
    calls = {"ssd": 0, "gate": 0}
    sb, nb = ssd_ops.ssd_chunk_backward, norm_ops.rmsnorm_backward_gate

    def ssd_count(*a, **k):
        calls["ssd"] += 1
        return sb(*a, **k)

    def norm_count(*a, **k):
        calls["gate"] += 1
        return nb(*a, **k)

    ssd_ops.ssd_chunk_backward = ssd_count
    norm_ops.rmsnorm_backward_gate = norm_count
    try:
        jl, jg = jax.jit(jax.value_and_grad(
            lambda p: j_loss_fn(cfg, p, batch)))(params)
        tl, tg = value_and_grad(lambda p, b: loss_fn(tcfg, p, b), tparams,
                                _t(batch))
    finally:
        ssd_ops.ssd_chunk_backward, norm_ops.rmsnorm_backward_gate = sb, nb
    assert calls == {"ssd": cfg.n_layers, "gate": cfg.n_layers}
    np.testing.assert_allclose(float(tl), float(jl), **LOSS)
    _hold_grads(tg, jg)


def _forward_only_calls():
    """Each forward-only wrapper with a float operand (K1 and K2 take int32
    tables only, which cannot require grad), called on ``r`` in place of
    that operand (None: a fresh tensor)."""
    x = torch.randn(2, 8, 4, 16)
    pool = torch.randn(32, 128)
    return {
        "K3 gather_rows": lambda r: LK.gather_rows(
            pool if r is None else r, torch.arange(4, dtype=torch.int32)),
        "K5 dense_decode": lambda r: DK.dense_decode(
            torch.randn(2, 4, 2, 16) if r is None else r, x, x, 5),
        "K6 flash_prefill": lambda r: FK.flash_prefill(
            torch.randn(2, 8, 8, 16) if r is None else r, x, x),
        "K7 ssd_chunk": lambda r: SK.ssd_chunk(
            torch.randn(1, 8, 2, 4) if r is None else r,
            torch.rand(1, 8, 2), torch.zeros(1, 1, 8, 2),
            torch.randn(1, 8, 4), torch.randn(1, 8, 4), chunk=8),
        "K8 rmsnorm_2d (gate variant)": lambda r: RK.rmsnorm_2d(
            torch.randn(4, 16) if r is None else r, torch.ones(16),
            gate=torch.randn(4, 16)),
        "K8 rmsnorm_2d": lambda r: RK.rmsnorm_2d(
            torch.randn(4, 16) if r is None else r, torch.ones(16)),
    }


@pytest.mark.parametrize("kernel", list(_forward_only_calls()))
def test_forward_only_wrapper_raises_when_an_input_requires_grad(kernel):
    call = _forward_only_calls()[kernel]
    call(None)                              # no grad: the plain version
    needs = {"K3 gather_rows": torch.randn(32, 128, requires_grad=True),
             "K5 dense_decode": torch.randn(2, 4, 2, 16, requires_grad=True),
             "K6 flash_prefill": torch.randn(2, 8, 8, 16,
                                             requires_grad=True),
             "K7 ssd_chunk": torch.randn(1, 8, 2, 4, requires_grad=True),
             "K8 rmsnorm_2d (gate variant)": torch.randn(
                 4, 16, requires_grad=True),
             "K8 rmsnorm_2d": torch.randn(4, 16, requires_grad=True)}[kernel]
    with pytest.raises(NotImplementedError, match=kernel.split(" (")[0]):
        call(needs)
    with torch.no_grad():
        call(needs)
    st = {"a": torch.zeros(3, requires_grad=True)}
    with pytest.raises(NotImplementedError, match="K9 sim_run"):
        CSK.sim_run(st, None, "tardis")


@pytest.mark.parametrize("s,chunk", [(64, 16), (70, 16), (12, 512)])
def test_chunked_xent_matches_jax(s, chunk):
    rng = np.random.default_rng(s)
    d, v = 16, 64
    hidden = rng.standard_normal((2, s, d)).astype(np.float32)
    w = rng.standard_normal((d, v)).astype(np.float32)
    labels = rng.integers(0, v, (2, s)).astype(np.int32)
    labels[:, ::7] = -1
    jl, (jgh, jgw) = jax.value_and_grad(
        lambda h, ww: j_chunked_xent(h, ww, jnp.asarray(labels), chunk),
        argnums=(0, 1))(jnp.asarray(hidden), jnp.asarray(w))
    th = torch.from_numpy(hidden).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tl = chunked_xent(th, tw, torch.from_numpy(labels), chunk)
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    for got, want in ((th.grad, jgh), (tw.grad, jgw)):
        want = np.asarray(want)
        err = float(np.abs(got.numpy() - want).max())
        assert err <= 1e-6 * float(np.abs(want).max()), err


def _rand_tree(rng, dtype=np.float32):
    return {"a": rng.standard_normal((5, 7)).astype(dtype),
            "b": {"c": rng.standard_normal((11,)).astype(dtype),
                  "d": rng.standard_normal((3, 2, 4)).astype(dtype)}}


def _to_t(tree, dtype=torch.float32):
    return tree_map(lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(
        dtype), tree)


def test_global_norm_and_clip_match_jax():
    rng = np.random.default_rng(1)
    g = _rand_tree(rng)
    for max_norm in (1.0, 100.0):
        jc, jn = j_adamw.clip_by_global_norm(g, max_norm)
        tc, tn = adamw.clip_by_global_norm(_to_t(g), max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for a, b in zip(leaves(tc), jax.tree.leaves(jc)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(dtype):
    rng = np.random.default_rng(2)
    p = _rand_tree(rng)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), p)
    tp = _to_t(p, tdt)
    jst, tst = j_adamw.init(jp), adamw.init(tp)
    assert all(m.dtype == torch.float32 for m in leaves(tst["m"]))
    lr_j = j_adamw.cosine_schedule(1e-2, 2, 6)
    lr_t = adamw.cosine_schedule(1e-2, 2, 6)
    for step in range(4):
        g = _rand_tree(rng)
        lj, lt = lr_j(jst["step"] + 1), lr_t(tst["step"] + 1)
        np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)
        jp, jst, jm = j_adamw.update(jp, jax.tree.map(jnp.asarray, g), jst,
                                     lr=lj)
        tp, tst, tm = adamw.update(tp, _to_t(g), tst, lr=lt)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        assert int(tst["step"]) == int(jst["step"]) == step + 1
        for a, b in zip(leaves(tst["m"]) + leaves(tst["v"]),
                        jax.tree.leaves(jst["m"]) + jax.tree.leaves(
                            jst["v"])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-12)
        for a, b in zip(leaves(tp), jax.tree.leaves(jp)):
            assert a.dtype == tdt
            want = np.asarray(jnp.asarray(b, jnp.float32))
            if dtype == "float32":
                np.testing.assert_allclose(a.numpy(), want, rtol=1e-6,
                                           atol=1e-7)
            else:
                np.testing.assert_allclose(a.float().numpy(), want,
                                           rtol=2 ** -7, atol=0)
        # carry JAX's state on, so bf16 roundings do not compound
        tp = _to_t(jax.tree.map(lambda a: np.asarray(a, np.float32), jp),
                   tdt)
        tst = {"m": _to_t(jst["m"]), "v": _to_t(jst["v"]),
               "step": torch.tensor(int(jst["step"]), dtype=torch.int32)}


def test_cosine_schedule_matches_jax():
    for base, warm, total in ((3e-4, 20, 100), (1e-3, 0, 10), (1.0, 5, 5)):
        jf = j_adamw.cosine_schedule(base, warm, total)
        tf = adamw.cosine_schedule(base, warm, total)
        for s in range(0, total + 3):
            np.testing.assert_allclose(
                float(tf(torch.tensor(s, dtype=torch.int32))),
                float(jf(jnp.int32(s))), rtol=1e-6, atol=1e-6 * base)


@pytest.mark.parametrize("seed,step,b,s,vocab", [(0, 0, 4, 32, 128),
                                                (0, 17, 4, 32, 128),
                                                (3, 5, 2, 1024, 32000),
                                                (7, 2, 3, 9, 50)])
def test_synthetic_batch_is_byte_identical(seed, step, b, s, vocab):
    extras = {"vision_embeds": {"shape": (b, 4, 8)}}
    want = j_synthetic_batch(seed, step, b, s, vocab, extras=extras)
    got = synthetic_batch(seed, step, b, s, vocab, extras=extras)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k


def test_prefetcher_yields_the_stream_in_order():
    pf = Prefetcher(lambda s: synthetic_batch(1, s, 2, 8, 64), start_step=3,
                    depth=2)
    try:
        for want_step in range(3, 7):
            step, batch = next(pf)
            assert step == want_step
            want = j_synthetic_batch(1, step, 2, 8, 64)
            assert all(batch[k].tobytes() == want[k].tobytes()
                       for k in want)
    finally:
        pf.close()
    t = batch_to(batch, "cpu")
    assert t["tokens"].dtype == torch.int32 and t["tokens"].shape == (2, 8)


def test_compress_grads_matches_jax():
    rng = np.random.default_rng(4)
    g = _rand_tree(rng)
    g["zero"] = np.zeros((3,), np.float32)   # scale 0: the safe divisor
    r = jax.tree.map(lambda a: 1e-3 * np.ones_like(a), g)
    (jq, js), jr = j_compress(jax.tree.map(jnp.asarray, g),
                              jax.tree.map(jnp.asarray, r))
    tres = init_residual(_to_t(g))
    assert all(t.dtype == torch.float32 and not t.any()
               for t in leaves(tres))
    (tq, ts), tr = compress_grads(_to_t(g), _to_t(r))
    for a, b in zip(leaves(tq), jax.tree.leaves(jq)):
        assert a.dtype == torch.int8
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(leaves(ts) + leaves(tr),
                    jax.tree.leaves(js) + jax.tree.leaves(jr)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-9)
    deq = decompress_grads((tq, ts))
    for a, q, s in zip(leaves(deq), leaves(tq), leaves(ts)):
        assert torch.equal(a, q.float() * s)


@pytest.mark.parametrize("n_micro", [1, 2, 4])
def test_microbatch_grads_match_jax(n_micro):
    cfg, tcfg, params, tparams = _model("dense")
    batch = _batch(cfg, b=4, s=24, seed=n_micro)
    jl, jg = jax.jit(lambda p, b: j_microbatch(
        lambda pp, bb: j_loss_fn(cfg, pp, bb), p, b, n_micro))(
            params, jax.tree.map(jnp.asarray, batch))
    tl, tg = microbatch_grads(lambda p, b: loss_fn(tcfg, p, b), tparams,
                              _t(batch), n_micro)
    np.testing.assert_allclose(float(tl), float(jl), **LOSS)
    _hold_grads(tg, jg)


CRASH_CFG = dict(n_layers=2, d_model=64, vocab=128)


def test_train_with_crash_and_restart_matches_jax():
    """The twin of ``tests/test_system.py``'s: both packages from one
    initial state, each run's losses step by step (the 7 replayed steps
    after the restore from step 10 included)."""
    cfg = reduced(get_arch("tinyllama-1.1b"), **CRASH_CFG)
    tcfg = t_reduced(t_get_arch("tinyllama-1.1b"), **CRASH_CFG)
    params = j_init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, params))
    kw = dict(steps=30, ckpt_every=10, batch=4, seq=32, fail_at_step=17,
              grad_compression=True, n_micro=2)
    with tempfile.TemporaryDirectory() as d:
        jout = j_train(cfg, params, JTrainConfig(ckpt_dir=d + "/j", **kw))
        tout = train(tcfg, tparams, TrainConfig(ckpt_dir=d + "/t", **kw),
                     device="cpu")
    assert tout["restarts"] == jout["restarts"] == 1
    assert tout["final_step"] == jout["final_step"] == 30
    assert tout["losses"][-1] < tout["losses"][0]
    assert len(tout["losses"]) == len(jout["losses"]) == 37
    np.testing.assert_allclose(tout["losses"], jout["losses"], **STEP_LOSS)
    assert int(tout["opt_state"]["step"]) == 30
    # the first replayed step reads the restored state: equal bit for bit
    assert tout["losses"][17] == tout["losses"][10]


def test_opt_state_from_jax_carries_m_v_step():
    cfg, tcfg, params, tparams = _model("hybrid")
    st = j_adamw.init(params)
    st = {"m": jax.tree.map(lambda a: a + 1.5, st["m"]), "v": st["v"],
          "step": jnp.int32(7)}
    tst = opt_state_from_jax(jax.tree.map(np.asarray, st))
    assert int(tst["step"]) == 7 and tst["step"].dtype == torch.int32
    assert [t.shape for t in leaves(tst["m"])] == \
        [t.shape for t in leaves(tparams)]
    assert all(bool((t == 1.5).all()) for t in leaves(tst["m"]))


def test_train_cli_on_the_cpu(capsys):
    out = train_cli.main(["--arch", "tinyllama-1.1b", "--device", "cpu",
                          "--steps", "3", "--batch", "2", "--seq", "16",
                          "--n-micro", "2", "--grad-compression"])
    text = capsys.readouterr().out
    assert "device=cpu" in text and "final loss" in text
    assert out["final_step"] == 3 and out["restarts"] == 0
    assert all(np.isfinite(out["losses"]))
