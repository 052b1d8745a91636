"""The port's int8 block quantization (``repro_torch.kernels.quantize``,
``ops.int8_quantize`` / ``ops.int8_dequantize`` and their plain versions)
against the JAX package on the same numpy inputs.

Two JAX references compute scales differently.  The eager
``repro.core.compression.int8_block_encode`` divides ``absmax / 127``;
the jitted ``repro.kernels.ops.int8_quantize`` (the Pallas kernel, run in
interpret mode here) lets XLA turn that division by a constant into a
multiply by f32(1/127), which moves some rows' scales by one ulp.  The
port divides, as both sources are written.  So against the eager
function codes, scales and decoded values are bit for bit; against the
jitted kernel scales are within one ulp (``rtol=1e-6``, as
``tests/test_kernels.py``), codes equal in every row whose scale is
equal, and within 1 elsewhere.  The CUDA kernels run only on the card
(``chip_smoke.py`` holds them against these plain versions bit for bit);
here the wrappers take their plain branch, because the tensors lie on
the CPU.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cpu import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.core import compression as JC  # noqa: E402
from repro.kernels import ops as JO  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402
from repro_torch.convert import tensor_from_numpy  # noqa: E402
from repro_torch.kernels import build, ops, quantize, ref  # noqa: E402

CPU = torch.device("cpu")
DTYPES = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
SWEEP = [17, 256, 1000, 4096]          # tests/test_kernels.py:37


def _x(n, dtype, seed=7):
    x = np.random.RandomState(seed + n).standard_normal(n).astype(np.float32)
    return (x * 5).astype(DTYPES[dtype])


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("block", [256, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", SWEEP)
def test_plain_equals_eager_jax_bit_for_bit(n, dtype, block):
    x = _x(n, dtype)
    qj, sj = JC.int8_block_encode(jnp.asarray(x), block)
    q, s = ref.int8_quantize_ref(tensor_from_numpy(x, CPU), block)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(
        ref.int8_dequantize_ref(q, s, (n,)).numpy(),
        np.asarray(JC.int8_block_decode(qj, sj, (n,))))
    np.testing.assert_array_equal(
        _np(ref.int8_dequantize_ref(q, s, (n,), torch.bfloat16)),
        np.asarray(JR.int8_dequantize_ref(qj, sj, (n,), jnp.bfloat16),
                   np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", SWEEP + [65536 + 3])
def test_plain_vs_jitted_pallas_kernel(n, dtype):
    """Scales within one ulp of the jitted kernel's; codes equal where the
    scales are, within 1 elsewhere; decode bit for bit on equal codes."""
    x = _x(n, dtype, seed=3)
    qk, sk = JO.int8_quantize(jnp.asarray(x))
    qk, sk = np.asarray(qk), np.asarray(sk)
    q, s = ops.int8_quantize(tensor_from_numpy(x, CPU))
    q, s = q.numpy(), s.numpy()
    np.testing.assert_allclose(s, sk, rtol=1e-6, atol=0)
    assert np.abs(s.view(np.int32) - sk.view(np.int32)).max() <= 1
    same = s[:, 0] == sk[:, 0]
    np.testing.assert_array_equal(q[same], qk[same])
    assert np.abs(q.astype(np.int32) - qk.astype(np.int32)).max() <= 1
    dec = ops.int8_dequantize(torch.from_numpy(qk.copy()),
                              torch.from_numpy(sk.copy()), (n,))
    np.testing.assert_array_equal(
        dec.numpy(), np.asarray(JO.int8_dequantize(jnp.asarray(qk),
                                                   jnp.asarray(sk), (n,))))


@pytest.mark.parametrize("n", SWEEP)
def test_roundtrip_error_bound(n):
    """absmax int8: per-element error <= absmax / 127 (half-step rounding
    of each row's own absmax), as tests/test_kernels.py checks."""
    x = torch.from_numpy(_x(n, "float32"))
    q, s = ops.int8_quantize(x)
    xd = ops.int8_dequantize(q, s, (n,))
    assert (xd - x).abs().max().item() <= x.abs().max().item() / 127.0 + 1e-6


def test_wrappers_take_the_plain_branch_on_cpu_without_a_launch():
    x = torch.from_numpy(_x(1000, "float32")).reshape(10, 100)
    before = (quantize.int8_quantize_fwd.launches,
              quantize.int8_dequantize_fwd.launches)
    q, s = ops.int8_quantize(x, block=64)
    eq, es = ref.int8_quantize_ref(x, 64)
    assert q.shape == (16, 64) and s.shape == (16, 1)
    assert torch.equal(q, eq) and torch.equal(s, es)
    out = ops.int8_dequantize(q, s, (10, 100), torch.bfloat16)
    assert out.shape == (10, 100) and out.dtype == torch.bfloat16
    assert torch.equal(out, ref.int8_dequantize_ref(q, s, (10, 100),
                                                    torch.bfloat16))
    assert (quantize.int8_quantize_fwd.launches,
            quantize.int8_dequantize_fwd.launches) == before


def test_nan_row_propagates_to_its_scale_only():
    """A NaN makes its row's scale NaN (``jnp.max`` propagates it) and the
    row's codes 0; the other rows are untouched — as in eager JAX."""
    x = _x(1000, "float32")
    x[300] = np.nan
    qj, sj = JC.int8_block_encode(jnp.asarray(x))
    q, s = ops.int8_quantize(torch.from_numpy(x))
    sj = np.asarray(sj)
    assert np.isnan(s[1, 0].item()) and np.isnan(sj[1, 0])
    assert not torch.isnan(s[[0, 2, 3]]).any()
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy()[[0, 2, 3]], sj[[0, 2, 3]])
    assert (q[1] == 0).all()


def test_padding_codes_are_zero_and_decode_trims():
    n, block = 300, 128
    x = torch.from_numpy(_x(n, "float32"))
    q, s = ops.int8_quantize(x, block=block)
    assert q.shape == (math.ceil(n / block), block)
    assert (q.reshape(-1)[n:] == 0).all()
    out = ops.int8_dequantize(q, s, (3, 100))
    assert torch.equal(out.reshape(-1), (q.float() * s).reshape(-1)[:n])


def test_wrappers_refuse_what_they_cannot_take():
    x = torch.ones(8)
    with pytest.raises(ValueError):
        ops.int8_quantize(x, block=0)
    q, s = ops.int8_quantize(x, block=4)
    with pytest.raises(ValueError):
        ops.int8_dequantize(q, s, (9,))
    with pytest.raises(ValueError):
        ops.int8_dequantize(q, s[:1], (8,))
    # a device that is neither the CPU nor CUDA: no silent fallback
    with pytest.raises(ValueError, match="unsupported device"):
        ops.int8_quantize(torch.ones(8, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        ops.int8_dequantize(q.to("meta"), s.to("meta"), (8,))


def test_kernel_source_is_built_without_fast_math():
    """IEEE division is what keeps the kernel's codes equal to the plain
    version's: the build must not trade it for speed."""
    assert "quantize" in build.sources()
    assert not any("fast" in f for f in build.NVCC_FLAGS)
    src = (build.CSRC / "quantize.cu").read_text()
    for needle in ("int8_quantize_fwd", "int8_dequantize_fwd", "__fdiv_rn",
                   "rintf", "int64_t n"):
        assert needle in src, needle
