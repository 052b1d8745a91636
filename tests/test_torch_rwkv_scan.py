"""The port's RWKV6 wkv recurrence (``repro_torch.kernels``) against the
JAX package: the Pallas ``rwkv_scan`` (interpret mode on the CPU) over
the sweep of ``tests/test_kernels.py``, and the JAX model's
``_chunked_scan(_rwkv_step)`` for the port's extensions (an initial
state, the final state returned).

On CPU tensors the port's wrapper runs the kernel's plain PyTorch
version; the Hopper kernel itself is held against that plain version on
the card by ``chip_smoke.py``.  Inputs are drawn with numpy from a seed
and handed to both packages.  Both packages run the recurrence in
float32 in the same order, so float32 results agree to 2e-5 (relative
to the largest element, which grows with S); bfloat16 outputs are
rounded from nearly equal float32 values and may differ by one bfloat16
step, within 2e-2.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cpu import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.models.ssm import _chunked_scan, _rwkv_step  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import (rwkv_scan_ref,  # noqa: E402
                                     rwkv_scan_split_ref)
from repro_torch.kernels.rwkv_scan import rwkv_scan_fwd  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def rwkv_case(B, S, H, hd, seed=0, state=False):
    """r, k, v ~ N(0, 1), w = sigmoid(N(0, 1)) in (0, 1), u ~ 0.1 N(0, 1)
    (as in ``test_kernels.py``), and optionally an initial state."""
    rng = np.random.RandomState(seed)
    c = {n: rng.randn(B, S, H, hd).astype(np.float32) for n in "rkv"}
    c["w"] = (1.0 / (1.0 + np.exp(-rng.randn(B, S, H, hd)))).astype(np.float32)
    c["u"] = (rng.randn(H, hd) * 0.1).astype(np.float32)
    if state:
        c["s0"] = rng.randn(B, H, hd, hd).astype(np.float32)
    return c


def _torch_inputs(c, dtype, w_dtype=None):
    t = {n: torch.from_numpy(c[n]).to(dtype) for n in "rkv"}
    t["w"] = torch.from_numpy(c["w"]).to(w_dtype or dtype)
    t["u"] = torch.from_numpy(c["u"])
    if "s0" in c:
        t["s0"] = torch.from_numpy(c["s0"])
    return t


def _close_at_scale(out, exp, tol):
    exp = np.asarray(exp, np.float32)
    scale = max(1.0, float(np.abs(exp).max()))
    np.testing.assert_allclose(np.asarray(out, np.float32), exp,
                               atol=tol * scale, rtol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,S,H,hd,chunk", [(1, 32, 2, 16, 8),
                                            (2, 64, 3, 16, 16),
                                            (1, 40, 1, 32, 64)])
def test_rwkv_scan_matches_jax_kernel(B, S, H, hd, chunk, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    c = rwkv_case(B, S, H, hd, seed=S)
    exp = jops.rwkv_scan(*(jnp.asarray(c[n], jdt) for n in "rkvw"),
                         jnp.asarray(c["u"]), chunk=chunk)
    t = _torch_inputs(c, tdt)
    args = [t[n] for n in "rkvw"] + [t["u"]]
    out = ops.rwkv_scan(*args, chunk=chunk)
    assert out.dtype == tdt and out.shape == (B, S, H, hd)
    _close_at_scale(out.float().numpy(), exp, tol)
    assert torch.equal(rwkv_scan_ref(*args), out)


@pytest.mark.parametrize("S", [1, 5, 128, 150])
def test_rwkv_scan_with_state_matches_jax_chunked_scan(S):
    """The model path's form: bfloat16 r / k / v, float32 w, a cached
    initial state, float32 output and the final state returned.  S = 150
    crosses the JAX scan's 128-step chunk with a padded tail."""
    B, H, hd = 2, 2, 16
    c = rwkv_case(B, S, H, hd, seed=S, state=True)
    jr, jk, jv = (jnp.asarray(c[n], jnp.bfloat16) for n in "rkv")
    ju = jnp.asarray(c["u"])[None]
    tm = lambda a: jnp.moveaxis(a, 1, 0)
    js, jo = _chunked_scan(lambda s_, x: _rwkv_step(s_, x, ju),
                           jnp.asarray(c["s0"]),
                           (tm(jr), tm(jk), tm(jv), tm(jnp.asarray(c["w"]))),
                           S)
    t = _torch_inputs(c, torch.bfloat16, w_dtype=torch.float32)
    o, st = ops.rwkv_scan(t["r"], t["k"], t["v"], t["w"], t["u"],
                          s0=t["s0"], out_dtype=torch.float32,
                          return_state=True)
    assert o.dtype == torch.float32 and st.shape == (B, H, hd, hd)
    _close_at_scale(o.numpy(), np.moveaxis(np.asarray(jo), 0, 1), 2e-5)
    _close_at_scale(st.numpy(), js, 2e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,S,H,hd,chunk", [(1, 32, 2, 16, 8),
                                            (2, 64, 3, 16, 16),
                                            (1, 40, 1, 32, 64)])
def test_split_mirror_matches_jax_kernel(B, S, H, hd, chunk, dtype):
    """The plain mirror of the Hopper kernel's arithmetic (the bonus term
    factored out, the i-sum in row groups added in halving order)
    against the Pallas kernel, at the tolerances above."""
    jdt, tdt, tol = DTYPES[dtype]
    c = rwkv_case(B, S, H, hd, seed=S)
    exp = jops.rwkv_scan(*(jnp.asarray(c[n], jdt) for n in "rkvw"),
                         jnp.asarray(c["u"]), chunk=chunk)
    t = _torch_inputs(c, tdt)
    out = rwkv_scan_split_ref(*(t[n] for n in "rkvw"), t["u"])
    assert out.dtype == tdt and out.shape == (B, S, H, hd)
    _close_at_scale(out.float().numpy(), exp, tol)


@pytest.mark.parametrize("S,hd", [(1, 64), (150, 16), (37, 100)])
def test_split_mirror_with_state_matches_jax_chunked_scan(S, hd):
    """The mirror in the model path's form against the JAX model's scan:
    hd 64 fills the kernel's 8 row groups of 8, hd 16 leaves rows past hd
    as zeros, hd 100 takes 16 row groups of a 128-wide tile."""
    B, H = 2, 2
    c = rwkv_case(B, S, H, hd, seed=S + hd, state=True)
    jr, jk, jv = (jnp.asarray(c[n], jnp.bfloat16) for n in "rkv")
    ju = jnp.asarray(c["u"])[None]
    tm = lambda a: jnp.moveaxis(a, 1, 0)
    js, jo = _chunked_scan(lambda s_, x: _rwkv_step(s_, x, ju),
                           jnp.asarray(c["s0"]),
                           (tm(jr), tm(jk), tm(jv), tm(jnp.asarray(c["w"]))),
                           S)
    t = _torch_inputs(c, torch.bfloat16, w_dtype=torch.float32)
    o, st = rwkv_scan_split_ref(t["r"], t["k"], t["v"], t["w"], t["u"],
                                s0=t["s0"], out_dtype=torch.float32,
                                return_state=True)
    _close_at_scale(o.numpy(), np.moveaxis(np.asarray(jo), 0, 1), 2e-5)
    _close_at_scale(st.numpy(), js, 2e-5)


def test_rows_keep_their_state_and_state_out_may_be_s0():
    """Rows flagged False end with s0 bit for bit (their outputs are still
    computed); writing the final state into s0 itself gives the same
    bits as a separate output buffer."""
    c = rwkv_case(3, 7, 2, 16, seed=4, state=True)
    t = _torch_inputs(c, torch.float32)
    args = [t[n] for n in "rkvw"] + [t["u"]]
    rows = torch.tensor([True, False, True])
    o_all, s_all = ops.rwkv_scan(*args, s0=t["s0"], return_state=True)
    o, st = ops.rwkv_scan(*args, s0=t["s0"], return_state=True, rows=rows)
    assert torch.equal(o, o_all)
    assert torch.equal(st[1], t["s0"][1])
    assert torch.equal(st[0::2], s_all[0::2])
    buf = t["s0"].clone()
    o2 = ops.rwkv_scan(*args, s0=buf, rows=rows, state_out=buf)
    assert torch.equal(o2, o) and torch.equal(buf, st)


def test_cpu_path_counts_no_launch_and_other_devices_raise():
    """On CPU tensors the wrapper runs the plain version: the launch count
    stays put.  A tensor on any other non-CUDA device is refused."""
    t = _torch_inputs(rwkv_case(1, 3, 1, 16), torch.bfloat16)
    before = rwkv_scan_fwd.launches
    ops.rwkv_scan(*(t[n] for n in "rkvw"), t["u"])
    assert rwkv_scan_fwd.launches == before
    meta = [t[n].to("meta") for n in "rkvw"] + [t["u"].to("meta")]
    with pytest.raises(ValueError, match="unsupported device"):
        ops.rwkv_scan(*meta)
