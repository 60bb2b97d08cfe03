"""K12's plain version and the differentiable SSD scan against the JAX
package's gradients, on the CPU, and (``cuda`` lane) K12 against its plain
version on the card.

``ssd_chunk_backward_ref`` (the closed form of K7's gradient) is held to
``torch.autograd`` of the plain forward ``ssd_chunk_ref`` and to
``jax.vjp`` of the JAX kernel's own per-grid-point function
(``repro.kernels.ssd_scan.kernel._ssd_kernel``, vmapped over the folded
(batch, chunk, head) axis: ``pallas_call`` has no autodiff rule), with
s not a multiple of the chunk and B / C both shared by every head (b, s,
n) and per head (b, s, h, n).  ``ops.ssd_scan`` under autograd (the
``torch.autograd.Function`` whose forward is K7's wrapper and backward
K12's; plain versions on CPU tensors) is held to ``jax.grad`` of the JAX
package's chunked scan ``repro.models.ssm.ssd_chunked``.  fp32 within
rtol = atol = 2e-4 of each leaf's largest magnitude
(``tests/test_kernels.py``).  On the card K12 is held to the plain version
at zamba2's and mamba2's training shapes and at ragged ones, fp32 within
2e-4, and two calls are bit-identical."""
import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd_scan import kernel as SK
from repro_torch.kernels.ssd_scan import ops as T
from repro_torch.kernels.ssd_scan.ref import (ssd_chunk_backward_ref,
                                              ssd_chunk_ref)

try:
    import jax
    import jax.numpy as jnp
    from repro.kernels.ssd_scan.kernel import _ssd_kernel
    from repro.models.ssm import ssd_chunked as j_ssd_chunked
except ImportError:      # the card's machine has no JAX: only the CUDA
    jax = None           # lane (-m cuda) runs there

TOL = 2e-4
# b, s, h, p, n, chunk, shared
CASES = [(2, 40, 3, 8, 6, 16, True), (1, 37, 2, 5, 4, 8, False),
         (2, 64, 2, 16, 8, 32, True), (1, 9, 4, 4, 3, 16, False)]


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, (what, err, scale)


@functools.lru_cache(maxsize=None)
def _inputs(b, s, h, p, n, chunk, shared, seed=0):
    rng = np.random.default_rng(seed)
    nc = -(-s // chunk)
    bshape = (b, s, n) if shared else (b, s, h, n)
    f = np.float32
    return dict(
        x=rng.standard_normal((b, s, h, p)).astype(f),
        dt=(0.05 + 0.5 * rng.random((b, s, h))).astype(f),
        cum=np.cumsum(-0.2 * rng.random((b, nc, chunk, h)), axis=2).astype(f),
        B=rng.standard_normal(bshape).astype(f),
        C=rng.standard_normal(bshape).astype(f),
        dy=rng.standard_normal((b, nc, chunk, h, p)).astype(f),
        dS=rng.standard_normal((b, nc, h, p, n)).astype(f))


def _torch(a):
    return {k: torch.from_numpy(v) for k, v in a.items()}


@pytest.mark.parametrize("case", CASES, ids=str)
def test_backward_ref_matches_autograd(case):
    *shape, chunk, shared = case
    a = _torch(_inputs(*shape, chunk, shared))
    ins = [a[k].clone().requires_grad_() for k in ("x", "dt", "cum", "B",
                                                    "C")]
    y, S = ssd_chunk_ref(*ins, chunk=chunk)
    want = torch.autograd.grad((y * a["dy"]).sum() + (S * a["dS"]).sum(),
                               ins)
    got = ssd_chunk_backward_ref(a["x"], a["dt"], a["cum"], a["B"], a["C"],
                                 a["dy"], a["dS"], chunk=chunk)
    for name, g, w in zip(("dx", "ddt", "dcum", "dB", "dC"), got, want):
        _close(g.numpy(), w.numpy(), name)


class _Ref:
    """A Pallas ref over a traced array: ``[0]`` reads, ``[0] = v``
    writes."""

    def __init__(self, v):
        self.v = v
        self.dtype = v.dtype

    def __getitem__(self, i):
        return self.v[i]

    def __setitem__(self, i, val):
        self.v = self.v.at[i].set(val)


def _j_intra(x, dt, cum, B, C, chunk):
    """K7's contract in jnp on the model layout, through the JAX kernel's
    per-grid-point function: pad, fold (batch, chunk, head), xdt = x dt;
    returns (y_intra (b, nc, q, h, p), S (b, nc, h, p, n))."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    nc = cum.shape[1]
    pad = nc * chunk - s
    if B.ndim == 3:
        B = jnp.broadcast_to(B[:, :, None], (b, s, h, n))
        C = jnp.broadcast_to(C[:, :, None], (b, s, h, n))
    padded = [jnp.pad(t, ((0, 0), (0, pad), (0, 0), (0, 0)))
              for t in (x, B, C)]
    x, B, C = padded
    dt = jnp.pad(dt, ((0, 0), (0, pad), (0, 0)))

    def fold(a):
        k = a.shape[-1]
        return a.reshape(b, nc, chunk, h, k).transpose(0, 1, 3, 2, 4) \
            .reshape(b * nc * h, chunk, k)

    def one(c, bb, xx, cm):
        refs = [_Ref(t[None]) for t in (c, bb, xx, cm)]
        y = _Ref(jnp.zeros((1, chunk, p), jnp.float32))
        st = _Ref(jnp.zeros((1, n, p), jnp.float32))
        _ssd_kernel(*refs, y, st)
        return y.v[0], st.v[0]

    y, S = jax.vmap(one)(fold(C), fold(B), fold(x * dt[..., None]),
                         fold(cum[..., None]))
    y = y.reshape(b, nc, h, chunk, p).transpose(0, 1, 3, 2, 4)
    S = S.reshape(b, nc, h, n, p).swapaxes(-1, -2)
    return y, S


@pytest.mark.skipif(jax is None, reason="needs JAX")
@pytest.mark.parametrize("case", CASES, ids=str)
def test_backward_ref_matches_jax_vjp(case):
    *shape, chunk, shared = case
    a = _inputs(*shape, chunk, shared)
    fwd, vjp = jax.vjp(lambda *t: _j_intra(*t, chunk), a["x"], a["dt"],
                       a["cum"], a["B"], a["C"])
    t = _torch(a)
    y, S = ssd_chunk_ref(t["x"], t["dt"], t["cum"], t["B"], t["C"],
                         chunk=chunk)
    _close(y.numpy(), fwd[0], "y_intra")
    _close(S.numpy(), fwd[1], "S")
    want = vjp((a["dy"], a["dS"]))
    got = ssd_chunk_backward_ref(t["x"], t["dt"], t["cum"], t["B"], t["C"],
                                 t["dy"], t["dS"], chunk=chunk)
    for name, g, w in zip(("dx", "ddt", "dcum", "dB", "dC"), got, want):
        _close(g.numpy(), w, name)


@pytest.mark.skipif(jax is None, reason="needs JAX")
@pytest.mark.parametrize("s,chunk", [(40, 16), (64, 32), (7, 16)])
def test_ssd_scan_function_matches_jax_grad(s, chunk):
    """``ops.ssd_scan`` (K7 / K12 as one Function, the cumsum and the
    inter-chunk recurrence by autograd) against ``jax.grad`` of the JAX
    package's chunked scan, over every input and both outputs."""
    rng = np.random.default_rng(s)
    b, h, p, n = 2, 3, 8, 6
    f = np.float32
    x = rng.standard_normal((b, s, h, p)).astype(f)
    dt = (0.05 + 0.5 * rng.random((b, s, h))).astype(f)
    A = (-0.5 - rng.random(h)).astype(f)
    B = rng.standard_normal((b, s, n)).astype(f)
    C = rng.standard_normal((b, s, n)).astype(f)
    D = rng.standard_normal(h).astype(f)
    gy = rng.standard_normal((b, s, h, p)).astype(f)
    gs = rng.standard_normal((b, h, p, n)).astype(f)

    def j_obj(*t):
        y, st = j_ssd_chunked(*t, chunk)
        return jnp.sum(y * gy) + jnp.sum(st * gs)
    args = (x, dt, A, B, C, D)
    want = jax.grad(j_obj, argnums=tuple(range(6)))(*args)
    ins = [torch.from_numpy(t).requires_grad_() for t in args]
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = T.ssd_chunk, T.ssd_chunk_backward

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped
    T.ssd_chunk, T.ssd_chunk_backward = count("fwd", fwd), count("bwd", bwd)
    try:
        y, st = T.ssd_scan(*ins, chunk=chunk)
        ((y * torch.from_numpy(gy)).sum()
         + (st * torch.from_numpy(gs)).sum()).backward()
    finally:
        T.ssd_chunk, T.ssd_chunk_backward = fwd, bwd
    assert calls == {"fwd": 1, "bwd": 1}
    for name, t, w in zip("x dt A B C D".split(), ins, want):
        _close(t.grad.numpy(), w, name)


def test_raw_wrappers_name_the_differentiable_entry_point():
    a = _torch(_inputs(1, 9, 4, 4, 3, 16, False))
    x = a["x"].clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="ops.ssd_scan"):
        SK.ssd_chunk(x, a["dt"], a["cum"], a["B"], a["C"], chunk=16)
    with pytest.raises(NotImplementedError, match="K12"):
        SK.ssd_chunk_backward(x, a["dt"], a["cum"], a["B"], a["C"], a["dy"],
                              a["dS"], chunk=16)


# ---------------------------------------------------------------------------
# cuda lane: K12 against its plain version on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K12 has no CPU or interpret "
                    "mode); run on the card with -m cuda")
    return torch.device("cuda")


def _card_case(cuda, b, s, h, p, n, chunk, shared, bc_dtype, seed=0):
    """K7's operands as the model lays them out: x, B and C column views
    of one projection (the conv output), dt and cum fp32."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    nc = -(-s // chunk)
    width = h * p + (2 * n if shared else 0) + 8
    proj = torch.randn(b, s, width, generator=g, device=cuda)
    x = proj[..., :h * p].reshape(b, s, h, p)
    if shared:
        B = proj[..., h * p:h * p + n].to(bc_dtype)
        C = proj[..., h * p + n:h * p + 2 * n].to(bc_dtype)
    else:
        B = torch.randn(b, s, h, n, generator=g, device=cuda).to(bc_dtype)
        C = torch.randn(b, s, h, n, generator=g, device=cuda).to(bc_dtype)
    dt = 0.05 + 0.5 * torch.rand(b, s, h, generator=g, device=cuda)
    cum = torch.cumsum(-0.05 * torch.rand(b, nc, chunk, h, generator=g,
                                          device=cuda), dim=2)
    dy = torch.randn(b, nc, chunk, h, p, generator=g, device=cuda)
    dS = torch.randn(b, nc, h, p, n, generator=g, device=cuda)
    return x, dt, cum, B, C, dy, dS


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    (1, 512, 80, 64, 64, 256, True, torch.float32),    # zamba2 training
    (1, 512, 24, 64, 128, 256, True, torch.float32),   # mamba2-130m
    (2, 100, 3, 16, 12, 64, False, torch.float32),
    (1, 70, 2, 70, 66, 32, True, torch.float32),
    (1, 130, 4, 64, 64, 128, True, torch.bfloat16)], ids=str)
def test_cuda_ssd_chunk_backward_matches_plain(cuda, case):
    *shape, chunk, shared, bc_dtype = case
    ops = _card_case(cuda, *shape, chunk, shared, bc_dtype)
    before = SK.ssd_chunk_backward.launches
    got = SK.ssd_chunk_backward(*ops, chunk=chunk)
    again = SK.ssd_chunk_backward(*ops, chunk=chunk)
    assert SK.ssd_chunk_backward.launches == before + 2
    want = ssd_chunk_backward_ref(*ops, chunk=chunk)
    for name, g, g2, w in zip(("dx", "ddt", "dcum", "dB", "dC"), got, again,
                              want):
        assert torch.equal(g, g2), name
        tol = TOL if g.dtype == torch.float32 else 3e-2
        scale = max(float(w.float().abs().max()), 1.0)
        err = float((g.float() - w.float()).abs().max())
        assert err <= tol * scale, (name, err, scale)
