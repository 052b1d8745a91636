"""The port's paged-decode attention (``repro_torch.kernels``) against the
JAX package's ``repro.kernels.ops.paged_attention`` (interpret mode on
the CPU), over the sweep of ``tests/test_paged_kernel.py``.

On CPU tensors the port's wrapper runs the kernel's plain PyTorch
version; the Hopper kernel itself is held against that plain version on
the card by ``chip_smoke.py``.  ``paged_attention_split_ref`` is the
plain mirror of the kernel's split-K algorithm (fixed column splits,
ordered merge); it is held against the sequential plain version, the
JAX kernel, and its own bitwise invariants.  Inputs are drawn with numpy from a seed
and handed to both packages.  Tolerances are those of
``test_paged_kernel.py``: 2e-5 for float32, 2e-2 for bfloat16.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cpu import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention_fwd  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    PAGES_PER_SPLIT, paged_attention_ref, paged_attention_split_ref)
from repro_torch.models.layers import attention  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def pool_case(B, Hq, Hkv, D, page, n_cols, *, used_cols, seed=0, Dv=None,
              De=0):
    """numpy pool + table: each row has ``used_cols`` allocated pages
    (scattered blocks, the rest -1) and a partially written last page."""
    rng = np.random.RandomState(seed)
    Dv = Dv or D
    N = B * n_cols + 2
    case = {"q": rng.randn(B, 1, Hq, D), "k": rng.randn(N, page, Hkv, D),
            "v": rng.randn(N, page, Hkv, Dv)}
    if De:
        case["q_extra"] = rng.randn(B, 1, Hq, De)
        case["k_extra"] = rng.randn(N, page, Hkv, De)
    pos = np.full((N, page), -1, np.int32)
    table = np.full((B, n_cols), -1, np.int32)
    q_pos = np.zeros((B, 1), np.int32)
    perm = rng.permutation(N)
    blk = 0
    for b in range(B):
        t_total = used_cols * page - rng.randint(0, page)
        q_pos[b, 0] = t_total
        for c in range(used_cols):
            table[b, c] = perm[blk]
            lo, hi = c * page, min((c + 1) * page, t_total)
            if hi > lo:
                pos[perm[blk], :hi - lo] = np.arange(lo, hi)
            blk += 1
    case.update(pos=pos, table=table, q_pos=q_pos)
    return case


def to_jax(case, dtype):
    return {k: jnp.asarray(v, jnp.int32 if v.dtype == np.int32 else dtype)
            for k, v in case.items()}


def to_torch(case, dtype):
    return {k: (torch.from_numpy(v) if v.dtype == np.int32
                else torch.from_numpy(v.astype(np.float32)).to(dtype))
            for k, v in case.items()}


def call(mod, c, **kw):
    extra = {k: c[k] for k in ("q_extra", "k_extra") if k in c}
    return mod.paged_attention(c["q"], c["k"], c["v"], c["pos"], c["table"],
                               c["q_pos"], **extra, **kw)


SWEEP = [(2, 4, 2, 32, 8, 4, 3, 0, 0.0),      # GQA, -1 tail columns
         (1, 8, 8, 64, 16, 4, 4, 0, 0.0),     # MHA, full table
         (3, 4, 1, 80, 8, 6, 2, 0, 0.0),      # MQA, odd head dim
         (2, 4, 2, 32, 8, 8, 5, 20, 0.0),     # SWA window crossing pages
         (1, 4, 2, 32, 8, 4, 3, 0, 30.0),     # softcap
         (2, 16, 4, 128, 16, 3, 3, 0, 0.0)]   # wide heads


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,Hq,Hkv,D,page,n_cols,used,window,softcap", SWEEP)
def test_paged_attention_matches_jax(B, Hq, Hkv, D, page, n_cols, used,
                                     window, softcap, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    case = pool_case(B, Hq, Hkv, D, page, n_cols, used_cols=used,
                     seed=B + used)
    exp = call(jops, to_jax(case, jdt), window=window, softcap=softcap)
    out = call(ops, to_torch(case, tdt), window=window, softcap=softcap)
    assert out.dtype == tdt and out.shape == (B, 1, Hq, D)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(exp, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_paged_attention_mla_second_contraction_matches_jax(dtype):
    """MLA absorbed decode: the latent pool is both K and V, the rope pool
    enters as q_extra / k_extra."""
    jdt, tdt, tol = DTYPES[dtype]
    case = pool_case(2, 4, 1, 48, 8, 4, used_cols=3, seed=11, De=16)
    case["v"] = case["k"]
    scale = (48 + 16) ** -0.5
    exp = call(jops, to_jax(case, jdt), scale=scale)
    out = call(ops, to_torch(case, tdt), scale=scale)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(exp, np.float32), atol=tol, rtol=tol)


def test_paged_attention_swa_ring_matches_jax():
    """A long sequence wrapped into 3 ring pages; the window mask must stay
    exact across page boundaries."""
    window, page, N, ring = 20, 8, 8, 24
    rng = np.random.RandomState(3)
    pos = np.full((N, page), -1, np.int32)
    table = np.asarray([[2, 5, 1]], np.int32)
    for p in range(46):
        sl = p % ring
        pos[table[0, sl // page], sl % page] = p
    case = {"q": rng.randn(1, 1, 4, 32), "k": rng.randn(N, page, 2, 32),
            "v": rng.randn(N, page, 2, 32), "pos": pos, "table": table,
            "q_pos": np.asarray([[45]], np.int32)}
    exp = call(jops, to_jax(case, jnp.float32), window=window)
    out = call(ops, to_torch(case, torch.float32), window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), atol=2e-5,
                               rtol=2e-5)


def test_unallocated_column_is_exactly_neutral():
    """-1 table columns contribute exactly nothing: appending two leaves
    the output bit for bit unchanged."""
    c = to_torch(pool_case(1, 4, 2, 32, 8, 4, used_cols=4, seed=7),
                 torch.float32)
    full = call(ops, c)
    c["table"] = torch.cat([c["table"],
                            torch.full((1, 2), -1, dtype=torch.int32)], 1)
    assert torch.equal(call(ops, c), full)


def test_idle_slot_outputs_exact_zeros():
    c = to_torch(pool_case(2, 4, 2, 32, 8, 4, used_cols=3, seed=5),
                 torch.float32)
    c["q_pos"][1, 0] = -1
    c["table"][1] = -1
    out = call(ops, c)
    assert torch.equal(out[1], torch.zeros_like(out[1]))
    # the live row still matches the scan path
    exp = attention(c["q"], c["k"], c["v"], c["q_pos"], c["pos"],
                    table=c["table"], kv_chunk=8)
    torch.testing.assert_close(out[0], exp[0], atol=2e-5, rtol=2e-5)


# the sweep plus a table long enough for several splits, some empty
SPLIT_SWEEP = SWEEP + [(2, 8, 2, 64, 8, 3 * PAGES_PER_SPLIT + 1, 6, 0, 0.0)]


@pytest.mark.parametrize("B,Hq,Hkv,D,page,n_cols,used,window,softcap",
                         SPLIT_SWEEP)
def test_split_ref_matches_sequential_plain(B, Hq, Hkv, D, page, n_cols, used,
                                            window, softcap):
    """The split-K merge is the same function as the column-by-column
    online softmax: float32, within 2e-5."""
    c = to_torch(pool_case(B, Hq, Hkv, D, page, n_cols, used_cols=used,
                           seed=B + used), torch.float32)
    kw = dict(window=window, softcap=softcap)
    out = paged_attention_split_ref(*(c[k] for k in ARGS), **kw)
    exp = paged_attention_ref(*(c[k] for k in ARGS), **kw)
    torch.testing.assert_close(out, exp, atol=2e-5, rtol=2e-5)


ARGS = ("q", "k", "v", "pos", "table", "q_pos")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,Hq,Hkv,D,page,n_cols,used,window,softcap",
                         SPLIT_SWEEP)
def test_split_ref_matches_jax(B, Hq, Hkv, D, page, n_cols, used, window,
                               softcap, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    case = pool_case(B, Hq, Hkv, D, page, n_cols, used_cols=used,
                     seed=B + used)
    exp = call(jops, to_jax(case, jdt), window=window, softcap=softcap)
    c = to_torch(case, tdt)
    out = paged_attention_split_ref(*(c[k] for k in ARGS), window=window,
                                    softcap=softcap)
    assert out.dtype == tdt and out.shape == (B, 1, Hq, D)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(exp, np.float32), atol=tol, rtol=tol)


def test_split_ref_mla_second_contraction_matches_jax():
    case = pool_case(2, 4, 1, 48, 8, 4, used_cols=3, seed=11, De=16)
    case["v"] = case["k"]
    scale = (48 + 16) ** -0.5
    exp = call(jops, to_jax(case, jnp.float32), scale=scale)
    c = to_torch(case, torch.float32)
    out = paged_attention_split_ref(*(c[k] for k in ARGS), scale=scale,
                                    q_extra=c["q_extra"], k_extra=c["k_extra"])
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("extra", [2, PAGES_PER_SPLIT, 3 * PAGES_PER_SPLIT + 1])
def test_split_ref_appended_columns_are_neutral_bit_for_bit(extra):
    """-1 columns appended inside the last split, filling it, or adding
    whole empty splits leave every output bit unchanged: the split
    boundaries of the real columns do not move, a -1 column's rows are
    masked, and an empty split is skipped in the merge."""
    c = to_torch(pool_case(2, 8, 2, 32, 8, 2 * PAGES_PER_SPLIT + 1,
                           used_cols=2 * PAGES_PER_SPLIT + 1, seed=4),
                 torch.float32)
    base = paged_attention_split_ref(*(c[k] for k in ARGS))
    c["table"] = torch.cat([c["table"], torch.full((2, extra), -1,
                                                   dtype=torch.int32)], 1)
    assert torch.equal(paged_attention_split_ref(*(c[k] for k in ARGS)), base)


def test_split_ref_empty_splits_and_idle_slot():
    """A table whose first split is all -1 (real columns later), and an
    idle slot: the live row matches the sequential plain version, the
    idle one is exact zeros."""
    c = to_torch(pool_case(2, 4, 2, 32, 8, 3 * PAGES_PER_SPLIT, used_cols=2,
                           seed=6), torch.float32)
    t = c["table"]
    t[0, 2 * PAGES_PER_SPLIT:2 * PAGES_PER_SPLIT + 2] = t[0, :2]
    t[0, :2] = -1
    c["q_pos"][1, 0] = -1
    out = paged_attention_split_ref(*(c[k] for k in ARGS))
    exp = paged_attention_ref(*(c[k] for k in ARGS))
    assert torch.equal(out[1], torch.zeros_like(out[1]))
    torch.testing.assert_close(out[0], exp[0], atol=2e-5, rtol=2e-5)


def test_cpu_path_counts_no_launch_and_other_devices_raise():
    """On CPU tensors the wrapper runs the plain version: the launch count
    stays put.  A tensor on any other non-CUDA device is refused."""
    before = paged_attention_fwd.launches
    call(ops, to_torch(pool_case(2, 4, 2, 32, 8, 4, used_cols=3),
                       torch.bfloat16))
    assert paged_attention_fwd.launches == before
    meta = {k: v.to("meta") for k, v in
            to_torch(pool_case(1, 4, 2, 32, 8, 2, used_cols=2),
                     torch.float32).items()}
    with pytest.raises(ValueError, match="unsupported device"):
        call(ops, meta)
