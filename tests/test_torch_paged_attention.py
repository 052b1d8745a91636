"""The port's paged-decode attention (``repro_torch.kernels``) against the
JAX package's ``repro.kernels.ops.paged_attention`` (interpret mode on
the CPU), over the sweep of ``tests/test_paged_kernel.py``.

On CPU tensors the port's wrapper runs the kernel's plain PyTorch
version; the Hopper kernel itself is held against that plain version on
the card by ``chip_smoke.py``.  ``paged_attention_split_ref`` is the
plain mirror of the kernel's split-K algorithm (fixed column splits,
ordered merge); it is held against the sequential plain version, the
JAX kernel, and its own bitwise invariants.  MLA's absorbed-decode shape
(one latent head under many query heads, the latent pool as both K and
V, a rope term; the kernel's head-tiled instances on the card) is covered
at a CPU-sized copy: G = 32, D = Dv = 64, De = 16, with the mirror of
the CUDA-core instance (``PAGES_PER_SPLIT`` columns a split) and of the
MLA instance (``MLA_PAGES_PER_SPLIT``, P rounded to the input dtype).  Inputs are drawn
with numpy from a seed and handed to both packages.  Tolerances are those of
``test_paged_kernel.py``: 2e-5 for float32, 2e-2 for bfloat16.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cpu import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    MAX_GROUP, instance, paged_attention_fwd)
from repro_torch.kernels.ref import (  # noqa: E402
    MLA_PAGES_PER_SPLIT, PAGES_PER_SPLIT, paged_attention_ref,
    paged_attention_split_ref)
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


# gemma3-12b's decode head geometry at a CPU size: 4 q / 2 kv heads (G =
# 2) of 256, 16-row pages (the wide-head instance on the card)
GEMMA_CPU = dict(B=2, Hq=4, Hkv=2, D=256, page=16)
GEMMA_WINDOW = 48


def gemma_ring_case(seed, lengths=(100, 37), lag=(3, 1), ring_cols=4):
    """Each row's ring of ``ring_cols`` 16-row pages (64 positions, scattered
    blocks) after writing positions 0 .. length - 1 (slot p % 64 holds the
    newest p); row b queries at length - 1 + lag, so with the window of
    48 the ring's oldest positions lie below it.  A ring not yet wrapped
    leaves its unwritten columns -1."""
    rng = np.random.RandomState(seed)
    B, Hq, Hkv, D, page = (GEMMA_CPU[k] for k in ("B", "Hq", "Hkv", "D",
                                                  "page"))
    N = B * ring_cols + 2
    table = rng.permutation(N)[:B * ring_cols].reshape(B, ring_cols)
    table = table.astype(np.int32)
    pos = np.full((N, page), -1, np.int32)
    R = ring_cols * page
    for b in range(B):
        for p in range(max(0, lengths[b] - R), lengths[b]):
            sl = p % R
            pos[table[b, sl // page], sl % page] = p
        table[b, -(-lengths[b] // page):] = -1
    return {"q": rng.randn(B, 1, Hq, D), "k": rng.randn(N, page, Hkv, D),
            "v": rng.randn(N, page, Hkv, D), "pos": pos, "table": table,
            "q_pos": np.asarray([[lengths[b] - 1 + lag[b]] for b in range(B)],
                                np.int32)}


def gemma_case(layout, seed):
    """(case, window): the wrapped ring with its window, or a global
    layer's 8-column table with -1 tail columns (5 pages used, 2 splits)."""
    if layout == "ring":
        return gemma_ring_case(seed), GEMMA_WINDOW
    g = GEMMA_CPU
    return pool_case(g["B"], g["Hq"], g["Hkv"], g["D"], g["page"], 8,
                     used_cols=5, seed=seed), 0


PLAIN_FNS = {"plain": paged_attention_ref, "split": paged_attention_split_ref}


@pytest.mark.parametrize("fn", list(PLAIN_FNS))
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("layout", ["ring", "table"])
def test_gemma_geometry_matches_jax(layout, dtype, fn):
    """gemma3's G = 2, D = 256 decode: the plain version and the split-K
    mirror against the JAX kernel, over a wrapped ring whose oldest
    positions the window masks and over a table with -1 tail columns."""
    jdt, tdt, tol = DTYPES[dtype]
    case, window = gemma_case(layout, seed=21)
    if layout == "ring":     # the window masks a position the ring holds
        q_pos = case["q_pos"][:, :1]
        got = case["pos"][np.maximum(case["table"], 0)]
        assert ((case["table"] >= 0)[..., None] & (got >= 0)
                & (got <= q_pos[:, :, None] - window)).any()
    exp = call(jops, to_jax(case, jdt), window=window)
    c = to_torch(case, tdt)
    out = PLAIN_FNS[fn](*(c[k] for k in ARGS), window=window)
    assert out.dtype == tdt and out.shape == (2, 1, 4, 256)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(exp, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("fn", list(PLAIN_FNS))
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("layout", ["ring", "table"])
def test_gemma_geometry_appended_columns_neutral(layout, dtype, fn):
    """At gemma3's geometry, -1 columns appended inside the last split and
    as a whole empty split leave every output bit unchanged; an idle slot
    outputs exact zeros."""
    case, window = gemma_case(layout, seed=22)
    c = to_torch(case, DTYPES[dtype][1])
    f = PLAIN_FNS[fn]
    base = f(*(c[k] for k in ARGS), window=window)
    for extra in (1, PAGES_PER_SPLIT + 2):
        wide = dict(c, table=torch.cat([c["table"], torch.full(
            (2, extra), -1, dtype=torch.int32)], 1))
        assert torch.equal(f(*(wide[k] for k in ARGS), window=window), base)
    c["q_pos"] = c["q_pos"].clone()
    c["q_pos"][1, 0] = -1
    out = f(*(c[k] for k in ARGS), window=window)
    assert torch.equal(out[1], torch.zeros_like(out[1]))
    assert torch.equal(out[0], base[0])


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


# MLA's absorbed decode at a CPU-sized copy of deepseek-v3's shape (G =
# 128, D = Dv = 512, De = 64): one latent head, k is v, several splits
MLA_CPU = dict(B=2, Hq=32, Hkv=1, D=64, page=16,
               n_cols=2 * PAGES_PER_SPLIT + 1, De=16)


def mla_case(used, seed):
    m = MLA_CPU
    case = pool_case(m["B"], m["Hq"], m["Hkv"], m["D"], m["page"],
                     m["n_cols"], used_cols=used, seed=seed, De=m["De"])
    case["v"] = case["k"]
    return case


MLA_SCALE = (32 + 32) ** -0.5           # (nope + rope) ** -0.5, deepseek smoke


def mirror(pps):
    """The split mirror's options for a split length: the MLA instance's
    (P rounded to the input dtype) at ``MLA_PAGES_PER_SPLIT``, the split
    kernel's otherwise."""
    return dict(pages_per_split=pps, round_p=pps == MLA_PAGES_PER_SPLIT)


SPLITS = [PAGES_PER_SPLIT, MLA_PAGES_PER_SPLIT]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("used", [1, 3, MLA_CPU["n_cols"]])
def test_mla_shape_matches_jax(used, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    case = mla_case(used, seed=20 + used)
    exp = call(jops, to_jax(case, jdt), scale=MLA_SCALE)
    c = to_torch(case, tdt)
    c["v"] = c["k"]                     # one tensor as both, as mla_apply
    out = call(ops, c, scale=MLA_SCALE)
    assert out.dtype == tdt and out.shape == (2, 1, 32, 64)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(exp, np.float32), atol=tol, rtol=tol)
    for pps in SPLITS:
        split = paged_attention_split_ref(*(c[k] for k in ARGS),
                                          scale=MLA_SCALE,
                                          q_extra=c["q_extra"],
                                          k_extra=c["k_extra"], **mirror(pps))
        np.testing.assert_allclose(split.float().numpy(),
                                   np.asarray(exp, np.float32), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("pps", SPLITS)
@pytest.mark.parametrize("used", [1, 3, MLA_CPU["n_cols"]])
def test_mla_shape_split_ref_matches_sequential_plain(used, pps):
    """The split mirror of either head-tiled instance against the
    sequential plain version and the JAX kernel (interpret mode) in
    float32."""
    case = mla_case(used, seed=30 + used)
    c = to_torch(case, torch.float32)
    c["v"] = c["k"]
    kw = dict(scale=MLA_SCALE, q_extra=c["q_extra"], k_extra=c["k_extra"])
    out = paged_attention_split_ref(*(c[k] for k in ARGS), **kw,
                                    **mirror(pps))
    exp = paged_attention_ref(*(c[k] for k in ARGS), **kw)
    torch.testing.assert_close(out, exp, atol=2e-5, rtol=2e-5)
    jexp = call(jops, to_jax(case, jnp.float32), scale=MLA_SCALE)
    np.testing.assert_allclose(out.numpy(), np.asarray(jexp, np.float32),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("pps", SPLITS)
@pytest.mark.parametrize("extra", [2, 3 * PAGES_PER_SPLIT + 1])
def test_mla_shape_neutral_columns_and_idle_slot(extra, pps):
    """-1 columns appended leave the split mirror's output bit for bit;
    an idle slot outputs exact zeros."""
    c = to_torch(mla_case(5, seed=40), torch.float32)
    c["v"] = c["k"]
    kw = dict(scale=MLA_SCALE, q_extra=c["q_extra"], k_extra=c["k_extra"],
              **mirror(pps))
    base = paged_attention_split_ref(*(c[k] for k in ARGS), **kw)
    wide = dict(c, table=torch.cat([c["table"], torch.full(
        (2, extra), -1, dtype=torch.int32)], 1))
    assert torch.equal(paged_attention_split_ref(*(wide[k] for k in ARGS),
                                                 **kw), base)
    c["q_pos"][1, 0] = -1
    out = paged_attention_split_ref(*(c[k] for k in ARGS), **kw)
    assert torch.equal(out[1], torch.zeros_like(out[1]))
    assert torch.equal(out[0], base[0])
    out = paged_attention_ref(*(c[k] for k in ARGS), scale=MLA_SCALE,
                              q_extra=c["q_extra"], k_extra=c["k_extra"])
    assert torch.equal(out[1], torch.zeros_like(out[1]))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("extra", [1, MLA_PAGES_PER_SPLIT,
                                   MLA_PAGES_PER_SPLIT + 1])
def test_mla_split_ref_columns_past_boundary_bit_for_bit(extra, dtype):
    """A table whose used columns end on an MLA split boundary (one whole
    split, and one and a half splits in the next case): -1 columns
    appended past the boundary, in a new split or two, leave the MLA
    mirror's output bit for bit in float32 and in bf16 (P rounded)."""
    tdt = DTYPES[dtype][1]
    for used in (MLA_PAGES_PER_SPLIT, MLA_PAGES_PER_SPLIT + 4):
        case = pool_case(2, 32, 1, 64, 16, used, used_cols=used, seed=50,
                         De=16)
        case["v"] = case["k"]
        c = to_torch(case, tdt)
        c["v"] = c["k"]
        kw = dict(scale=MLA_SCALE, q_extra=c["q_extra"],
                  k_extra=c["k_extra"], **mirror(MLA_PAGES_PER_SPLIT))
        base = paged_attention_split_ref(*(c[k] for k in ARGS), **kw)
        wide = dict(c, table=torch.cat([c["table"], torch.full(
            (2, extra), -1, dtype=torch.int32)], 1))
        out = paged_attention_split_ref(*(wide[k] for k in ARGS), **kw)
        assert torch.equal(out, base)
        exp = paged_attention_ref(*(c[k] for k in ARGS), scale=MLA_SCALE,
                                  q_extra=c["q_extra"], k_extra=c["k_extra"])
        tol = DTYPES[dtype][2]
        torch.testing.assert_close(out.float(), exp.float(), atol=tol,
                                   rtol=tol)


def test_instance_choice():
    """Groups of more than MAX_GROUP query heads, or head dims past the
    split kernel's, go to a head-tiled instance: deepseek-v3's absorbed
    decode in bf16 with the latent pool as k and v (D = Dv = 512, a rope
    term of 8 to 64, a multiple of 8) to the MLA instance; float32 (which
    the tensor cores would round), a separate v, other pages, other head
    dims or rope widths, an odd head count, unaligned rows or the
    CPU-sized copy of the shape to the CUDA cores.  The GQA decode shapes of qwen3-8b and jamba, and the
    small MLA case, keep the split kernel.  gemma3-12b's decode (G = 2,
    D = Dv = 256, 16-row pages, bf16) takes the split kernel's wide-head
    instance, built for that shape alone; in float32, unaligned, with
    other pages, another group or other head dims it keeps the split
    kernel."""
    bf, f32 = torch.bfloat16, torch.float32
    assert instance(2, 256, 256, 0, 16, bf, False) == "wide"     # gemma3
    assert instance(1, 256, 256, 0, 16, bf, False) == "split"
    assert instance(2, 192, 192, 0, 16, bf, False) == "split"
    assert instance(2, 256, 128, 0, 16, bf, False) == "split"
    assert instance(2, 256, 256, 0, 16, f32, False) == "split"
    assert instance(2, 256, 256, 0, 16, bf, False, aligned=False) == "split"
    assert instance(2, 256, 256, 0, 16, bf, False, vec=False) == "split"
    assert instance(2, 256, 256, 0, 8, bf, False) == "split"
    assert instance(2, 256, 256, 16, 16, bf, False) == "split"
    assert instance(4, 256, 256, 0, 16, bf, False) == "split"
    assert instance(2, 128, 128, 0, 16, bf, False) == "split"
    assert instance(4, 128, 128, 0, 16, bf, False) == "split"    # qwen3-8b
    assert instance(8, 128, 128, 0, 16, bf, False) == "split"    # jamba
    assert instance(MAX_GROUP, 512, 512, 64, 16, bf, True) == "tiled"
    assert instance(4, 128, 128, 0, 16, bf, False) == "split"
    assert instance(4, 48, 48, 16, 8, bf, True) == "split"
    assert instance(128, 512, 512, 64, 16, bf, True) == "mla"
    assert instance(64, 512, 512, 64, 16, bf, True) == "mla"
    assert instance(128, 512, 512, 16, 16, bf, True) == "mla"
    assert instance(128, 512, 512, 72, 16, bf, True) == "tiled"
    assert instance(128, 512, 512, 12, 16, bf, True) == "tiled"
    assert instance(128, 512, 512, 0, 16, bf, True) == "tiled"
    assert instance(128, 256, 256, 64, 16, bf, True) == "tiled"
    assert instance(128, 512, 256, 64, 16, bf, True) == "tiled"
    assert instance(128, 512, 512, 64, 16, bf, True, vec=False) == "tiled"
    assert instance(128, 512, 512, 64, 16, f32, True) == "tiled"
    assert instance(128, 512, 512, 64, 16, bf, False) == "tiled"
    assert instance(128, 512, 512, 64, 8, bf, True) == "tiled"
    assert instance(96, 512, 512, 64, 16, bf, True) == "tiled"
    assert instance(128, 512, 512, 64, 16, bf, True, aligned=False) == "tiled"
    assert instance(32, 64, 64, 16, 16, bf, True) == "tiled"
    assert instance(8, 128, 128, 0, 16, bf, False) == "split"
