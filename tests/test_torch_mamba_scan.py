"""The port's Mamba selective scan (``repro_torch.kernels``) against the
JAX package: the Pallas ``mamba_scan`` (interpret mode on the CPU) and
``ref.mamba_scan_ref`` over the sweep of ``tests/test_kernels.py``, and
the JAX model's ``_chunked_scan(_mamba_step)`` for the port's extensions
(an initial state, the final state returned, rows whose state is kept).

On CPU tensors the port's wrapper runs the kernel's plain PyTorch
version; the Hopper kernel itself is held against that plain version on
the card by ``chip_smoke.py``.  Inputs are drawn with numpy from a seed
and handed to both packages.  Both packages run the recurrence in
float32 in the same order (the y contraction over d_state may sum in
another order), so float32 results agree to 2e-5 of the largest
element; bfloat16 outputs are rounded from nearly equal float32 values
and may differ by one bfloat16 step, within 2e-2.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cpu import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models.ssm import _chunked_scan, _mamba_step  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.mamba_scan import _check, mamba_scan_fwd  # noqa: E402
from repro_torch.kernels.ref import mamba_scan_ref  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
NAMES = ("x", "dt", "b", "c")


def mamba_case(B, S, di, ds, seed=0, state=False):
    """x ~ 0.5 N(0, 1), dt = 0.1 softplus(N(0, 1)), b, c ~ N(0, 1),
    a = -exp(N(0, 1)) (as in ``test_kernels.py``), and optionally an
    initial state ~ N(0, 1)."""
    rng = np.random.RandomState(seed)
    c = {"x": (rng.randn(B, S, di) * 0.5).astype(np.float32),
         "dt": (np.log1p(np.exp(rng.randn(B, S, di))) * 0.1).astype(np.float32),
         "b": rng.randn(B, S, ds).astype(np.float32),
         "c": rng.randn(B, S, ds).astype(np.float32),
         "a": (-np.exp(rng.randn(di, ds))).astype(np.float32)}
    if state:
        c["h0"] = rng.randn(B, di, ds).astype(np.float32)
    return c


def _torch_args(c, dtype):
    return ([torch.from_numpy(c[n]).to(dtype) for n in NAMES]
            + [torch.from_numpy(c["a"])])


def _close_at_scale(out, exp, tol):
    exp = np.asarray(exp, np.float32)
    scale = max(1.0, float(np.abs(exp).max()))
    np.testing.assert_allclose(np.asarray(out, np.float32), exp,
                               atol=tol * scale, rtol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,S,di,ds,chunk,dib",
                         [(1, 32, 64, 8, 16, 64),
                          (2, 96, 192, 16, 32, 64),
                          (1, 50, 48, 4, 64, 128)])
def test_mamba_scan_matches_jax_kernel_and_ref(B, S, di, ds, chunk, dib,
                                               dtype):
    jdt, tdt, tol = DTYPES[dtype]
    c = mamba_case(B, S, di, ds, seed=S)
    jargs = [jnp.asarray(c[n], jdt) for n in NAMES] + [jnp.asarray(c["a"])]
    exp_kernel = jops.mamba_scan(*jargs, chunk=chunk, di_block=dib)
    exp_ref = jref.mamba_scan_ref(*jargs)
    args = _torch_args(c, tdt)
    out = ops.mamba_scan(*args)
    assert out.dtype == tdt and out.shape == (B, S, di)
    _close_at_scale(out.float().numpy(), exp_kernel, tol)
    _close_at_scale(out.float().numpy(), exp_ref, tol)
    assert torch.equal(mamba_scan_ref(*args), out)


@pytest.mark.parametrize("S", [1, 5, 150])
def test_mamba_scan_with_state_matches_jax_chunked_scan(S):
    """The model path's form: bfloat16 x / dt / b / c, a cached initial
    state, float32 output and the final state returned.  S = 150 crosses
    the JAX scan's 128-step chunk with a padded tail."""
    B, di, ds = 2, 32, 16
    c = mamba_case(B, S, di, ds, seed=S, state=True)
    jx, jdt, jb, jc = (jnp.asarray(c[n], jnp.bfloat16) for n in NAMES)
    ja = jnp.asarray(c["a"])
    tm = lambda a: jnp.moveaxis(a, 1, 0)
    jh, jy = _chunked_scan(lambda h, xs: _mamba_step(h, xs, ja),
                           jnp.asarray(c["h0"]),
                           (tm(jx), tm(jdt), tm(jb), tm(jc)), S)
    args = _torch_args(c, torch.bfloat16)
    y, h = ops.mamba_scan(*args, h0=torch.from_numpy(c["h0"]),
                          out_dtype=torch.float32, return_state=True)
    assert y.dtype == torch.float32 and h.shape == (B, di, ds)
    _close_at_scale(y.numpy(), np.moveaxis(np.asarray(jy), 0, 1), 2e-5)
    _close_at_scale(h.numpy(), jh, 2e-5)


@pytest.mark.parametrize("S1", [1, 37])
def test_split_scan_equals_whole_scan(S1):
    """Scanning S steps equals scanning S1 steps, then the remaining S2
    from the returned state: the same float32 operations in the same
    order, so bit for bit."""
    c = mamba_case(2, 64, 48, 16, seed=7, state=True)
    args = _torch_args(c, torch.float32)
    h0 = torch.from_numpy(c["h0"])
    y, h = ops.mamba_scan(*args, h0=h0, return_state=True)
    first = [t[:, :S1] for t in args[:4]] + [args[4]]
    second = [t[:, S1:] for t in args[:4]] + [args[4]]
    y1, h1 = ops.mamba_scan(*first, h0=h0, return_state=True)
    y2, h2 = ops.mamba_scan(*second, h0=h1, return_state=True)
    assert torch.equal(torch.cat([y1, y2], dim=1), y)
    assert torch.equal(h2, h)


def test_rows_keep_their_state_and_state_out_may_be_h0():
    """Rows flagged False end with h0 bit for bit (their outputs are still
    computed); writing the final state into h0 itself gives the same
    bits as a separate output buffer."""
    c = mamba_case(3, 7, 40, 8, seed=4, state=True)
    args = _torch_args(c, torch.float32)
    h0 = torch.from_numpy(c["h0"])
    rows = torch.tensor([True, False, True])
    y_all, h_all = ops.mamba_scan(*args, h0=h0, return_state=True)
    y, h = ops.mamba_scan(*args, h0=h0, return_state=True, rows=rows)
    assert torch.equal(y, y_all)
    assert torch.equal(h[1], h0[1])
    assert torch.equal(h[0::2], h_all[0::2])
    buf = h0.clone()
    y2 = ops.mamba_scan(*args, h0=buf, rows=rows, state_out=buf)
    assert torch.equal(y2, y) and torch.equal(buf, h)


def test_wrapper_checks_what_the_kernel_takes():
    """The checks the wrapper runs before a launch, on CPU tensors: d_state
    above 16, mixed or unsupported dtypes, wrong shapes, a non-contiguous
    operand and a state buffer that overlaps h0 without being it are
    refused."""
    c = mamba_case(2, 3, 8, 4, state=True)
    x, dt, b, cm, a = _torch_args(c, torch.bfloat16)
    h0 = torch.from_numpy(c["h0"])
    ok = dict(h0=h0, rows=None, state_out=h0, out_dtype=torch.float32)
    _check(x, dt, b, cm, a, **ok)
    wide = mamba_case(2, 3, 8, 17)
    with pytest.raises(ValueError, match="d_state"):
        _check(*_torch_args(wide, torch.bfloat16), **dict(ok, h0=None,
                                                          state_out=None))
    with pytest.raises(TypeError, match="float32 / bfloat16"):
        _check(x.half(), dt.half(), b.half(), cm.half(), a, **ok)
    with pytest.raises(ValueError, match="dt must match"):
        _check(x, dt.float(), b, cm, a, **ok)
    with pytest.raises(ValueError, match="b must be"):
        _check(x, dt, b[:, :2], cm, a, **ok)
    with pytest.raises(ValueError, match="a must be"):
        _check(x, dt, b, cm, a.bfloat16(), **ok)
    with pytest.raises(ValueError, match="h0 must be"):
        _check(x, dt, b, cm, a, **dict(ok, h0=h0[:1], state_out=None))
    with pytest.raises(ValueError, match="rows must be"):
        _check(x, dt, b, cm, a, **dict(ok, rows=torch.ones(2)))
    with pytest.raises(ValueError, match="contiguous"):
        xt = x.transpose(1, 2).contiguous().transpose(1, 2)
        _check(xt, dt, b, cm, a, **ok)
    big = torch.zeros(2 * h0.numel() + 4)
    with pytest.raises(ValueError, match="overlaps"):
        _check(x, dt, b, cm, a, **dict(ok, h0=big[:h0.numel()].view_as(h0),
                                       state_out=big[4:4 + h0.numel()]
                                       .view_as(h0)))


def test_cpu_path_counts_no_launch_and_other_devices_raise():
    """On CPU tensors the wrapper runs the plain version: the launch count
    stays put.  A tensor on any other non-CUDA device is refused."""
    args = _torch_args(mamba_case(1, 3, 8, 4), torch.bfloat16)
    before = mamba_scan_fwd.launches
    ops.mamba_scan(*args)
    assert mamba_scan_fwd.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        ops.mamba_scan(*(t.to("meta") for t in args))
