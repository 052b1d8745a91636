"""The port's dense layers (``repro_torch.models.layers``) against the JAX
package's ``repro.models.layers`` on the same numpy inputs.

Pure data movement (ring writes, cache updates, gathers) must agree bit
for bit.  Arithmetic uses the tolerances of ``test_paged_kernel.py``:
2e-5 for float32, 2e-2 for bfloat16.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cpu import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import layers as J  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import layers as T  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def both(a, dtype="float32"):
    """The same numpy array as a JAX array and a torch tensor."""
    a = np.asarray(a)
    if a.dtype.kind in "iu":
        return jnp.asarray(a, jnp.int32), torch.from_numpy(a.astype(np.int32))
    return (jnp.asarray(a, JDT[dtype]),
            torch.from_numpy(a.astype(np.float32)).to(TDT[dtype]))


def close(t, j, dtype="float32"):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def same(t, j):
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(j, np.float32))


def tiny_cfg(**kw):
    cfg = jax_smoke("qwen3-8b")
    return dataclasses.replace(cfg, vocab_size=64, d_model=64, d_ff=96,
                               n_heads=4, n_kv_heads=2, head_dim=16, **kw)


# ---------------------------------------------------------------------------
# norms / rope
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax_scale_stored_minus_one(dtype):
    rng = np.random.RandomState(0)
    jx, tx = both(rng.randn(3, 5, 32), dtype)
    js, ts = both(rng.randn(32) * 0.1)            # scale kept in float32
    out = T.rmsnorm(tx, ts, 1e-6)
    assert out.dtype == TDT[dtype]
    close(out, J.rmsnorm(jx, js, 1e-6), dtype)
    # a zero stored scale is the identity gain (applied as 1 + scale)
    x = torch.from_numpy(rng.randn(2, 8).astype(np.float32))
    unit = x / torch.sqrt(x.square().mean(-1, keepdim=True) + 1e-6)
    torch.testing.assert_close(T.rmsnorm(x, torch.zeros(8)), unit)


def test_rope_matches_jax_and_rotates_halves():
    rng = np.random.RandomState(1)
    jx, tx = both(rng.randn(2, 7, 3, 16))
    jp, tp = both(rng.randint(0, 900, (2, 7)))
    out = T.rope(tx, tp, 1_000_000.0)
    close(out, J.rope(jx, jp, 1_000_000.0))
    # halves, not interleaved pairs: element i pairs with i + D/2
    x = torch.zeros(1, 1, 1, 16)
    x[..., 0] = 1.0
    r = T.rope(x, torch.tensor([[3]]), 10_000.0)
    assert r[..., 8].item() == pytest.approx(np.sin(3.0), abs=1e-6)
    assert r[..., 1].item() == 0.0


# ---------------------------------------------------------------------------
# attention (dense and paged scan paths)
# ---------------------------------------------------------------------------

def _dense_case(B, S, T_, Hq, Hkv, D, seed=0):
    rng = np.random.RandomState(seed)
    kv_pos = np.tile(np.arange(T_, dtype=np.int32), (B, 1))
    kv_pos[:, T_ - 3:] = -1                                    # unwritten
    q_pos = np.tile(np.arange(T_ - 3 - S, T_ - 3, dtype=np.int32), (B, 1))
    return (rng.randn(B, S, Hq, D), rng.randn(B, T_, Hkv, D),
            rng.randn(B, T_, Hkv, D), q_pos, kv_pos)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_chunk,window,softcap",
                         [(8, 0, 0.0), (16, 0, 30.0), (1024, 9, 0.0)])
def test_dense_attention_matches_jax(kv_chunk, window, softcap, dtype):
    """T = 37 is not a multiple of the chunk: the ragged tail pads."""
    q, k, v, qp, kp = _dense_case(2, 5, 37, 4, 2, 16)
    args = [both(a, dtype) for a in (q, k, v)] + [both(qp), both(kp)]
    kw = dict(kv_chunk=kv_chunk, window=window, softcap=softcap)
    exp = J.attention(*[a[0] for a in args], **kw)
    out = T.attention(*[a[1] for a in args], **kw)
    close(out, exp, dtype)


def _paged_from_dense(k, v, kv_pos, page, rng):
    """Scatter a dense (B, T) cache into a shuffled pool + table."""
    B, T_ = kv_pos.shape
    n_cols = T_ // page
    N = B * n_cols + 3
    perm = rng.permutation(N)[:B * n_cols].reshape(B, n_cols)
    kp = np.zeros((N, page) + k.shape[2:])
    vp = np.zeros((N, page) + v.shape[2:])
    pp = np.full((N, page), -1, np.int32)
    for b in range(B):
        for c in range(n_cols):
            sl = slice(c * page, (c + 1) * page)
            kp[perm[b, c]], vp[perm[b, c]] = k[b, sl], v[b, sl]
            pp[perm[b, c]] = kv_pos[b, sl]
    return kp, vp, pp, perm.astype(np.int32)


def test_paged_attention_scan_matches_jax_and_dense_bitwise():
    rng = np.random.RandomState(2)
    q, k, v, qp, kp = _dense_case(2, 4, 32, 4, 2, 16, seed=2)
    kpool, vpool, ppool, table = _paged_from_dense(k, v, kp, 8, rng)
    table[1, 3] = -1                                  # an unallocated page
    kp_masked = kp.copy()
    kp_masked[1, 24:] = -1
    for kv_chunk in (8, 16):
        jargs = [both(a)[0] for a in (q, kpool, vpool, qp, ppool)]
        targs = [both(a)[1] for a in (q, kpool, vpool, qp, ppool)]
        exp = J.attention(*jargs, table=jnp.asarray(table), kv_chunk=kv_chunk)
        out = T.attention(*targs, table=torch.from_numpy(table),
                          kv_chunk=kv_chunk)
        close(out, exp)
        # same chunk partition as the dense path -> same accumulation order
        dense = T.attention(*[both(a)[1] for a in (q, k, v, qp, kp_masked)],
                            kv_chunk=kv_chunk)
        assert torch.equal(out, dense)


# ---------------------------------------------------------------------------
# ring writes and cache helpers (bit for bit)
# ---------------------------------------------------------------------------

def _ring_cases():
    rng = np.random.RandomState(4)
    buf = rng.randn(3, 8, 2, 4)
    return rng, buf


def test_ring_write_s1_drops_negative_positions():
    rng, buf = _ring_cases()
    val = rng.randn(3, 1, 2, 4)
    pos = np.asarray([[5], [-1], [11]], np.int32)     # 11 wraps to slot 3
    jb, tb = both(buf)
    same(T.ring_write(tb.clone(), both(val)[1], both(pos)[1]),
         J.ring_write(jb, both(val)[0], both(pos)[0]))


@pytest.mark.parametrize("S,p0", [(8, 5), (3, 2), (3, 7)])
def test_ring_write_row_uniform_roll_and_slice(S, p0):
    """S == T places by a roll; S < T writes a slice whose start clamps."""
    rng, buf = _ring_cases()
    val = rng.randn(3, S, 2, 4)
    pos = np.tile(np.arange(p0, p0 + S, dtype=np.int32), (3, 1))
    jb, tb = both(buf)
    same(T.ring_write(tb.clone(), both(val)[1], both(pos)[1]),
         J.ring_write(jb, both(val)[0], both(pos)[0]))


def test_ring_write_per_row_masked_and_wrapping():
    rng, buf = _ring_cases()
    val = rng.randn(3, 4, 2, 4)
    pos = np.asarray([[6, 7, 8, 9],                   # wraps the ring
                      [-1, -1, -1, -1],               # idle slot
                      [2, 3, -1, -1]], np.int32)      # padded tail
    jb, tb = both(buf)
    same(T.ring_write(tb.clone(), both(val)[1], both(pos)[1], per_row=True),
         J.ring_write(jb, both(val)[0], both(pos)[0], per_row=True))


def test_ring_write_paged_drops_invalid_entries():
    """Position -1, an unallocated (-1) page and a column past the table
    are dropped; everything else lands at pool[table[col], off]."""
    rng = np.random.RandomState(5)
    pool = rng.randn(6, 4, 2, 3)
    table = np.asarray([[3, -1, 0], [5, 1, 2]], np.int32)
    val = rng.randn(2, 5, 2, 3)
    pos = np.asarray([[2, 3, 4, 5, 14], [-1, 7, 8, 9, 10]], np.int32)
    jp, tp = both(pool)
    out = T.ring_write(tp.clone(), both(val)[1], both(pos)[1],
                       table=torch.from_numpy(table))
    same(out, J.ring_write(jp, both(val)[0], both(pos)[0],
                           table=jnp.asarray(table)))
    # every entry dropped (an all-idle step): the pool is bit for bit intact
    idle = T.ring_write(tp.clone(), both(val)[1],
                        torch.full((2, 5), -1, dtype=torch.int32),
                        table=torch.from_numpy(table))
    assert torch.equal(idle, tp)


def test_cache_update_and_paged_cache_update_match_jax():
    rng = np.random.RandomState(6)
    k, v = rng.randn(2, 3, 2, 4), rng.randn(2, 3, 2, 4)
    pos = np.asarray([[4, 5, 6], [-1, -1, -1]], np.int32)
    jc = J.cache_init(2, 8, 2, 4, jnp.float32)
    tc = T.cache_init(2, 8, 2, 4, torch.float32)
    *_, jnew = J.cache_update(jc, both(k)[0], both(v)[0], both(pos)[0],
                              per_row=True)
    T.cache_update(tc, both(k)[1], both(v)[1], both(pos)[1], per_row=True)
    for name in ("k", "v", "pos"):
        same(tc[name], jnew[name])
    table = np.asarray([[2, 0], [-1, 1]], np.int32)
    jpc = J.paged_cache_init(3, 4, 2, 4, jnp.float32)
    tpc = T.paged_cache_init(3, 4, 2, 4, torch.float32)
    jnew = J.paged_cache_update(jpc, both(k)[0], both(v)[0], both(pos)[0],
                                jnp.asarray(table))
    T.paged_cache_update(tpc, both(k)[1], both(v)[1], both(pos)[1],
                         torch.from_numpy(table))
    for name in ("k", "v", "pos"):
        same(tpc[name], jnew[name])
    same(T.gather_pages(tpc["k"], torch.from_numpy(table)),
         J.gather_pages(jnew["k"], jnp.asarray(table)))
    same(T.gather_pos(tpc["pos"], torch.from_numpy(table)),
         J.gather_pos(jnew["pos"], jnp.asarray(table)))
    assert T.swa_ring_blocks(20, 8, 8) == J.swa_ring_blocks(20, 8, 8) == 3


# ---------------------------------------------------------------------------
# FFN and the attention block
# ---------------------------------------------------------------------------

def test_ffn_apply_matches_jax():
    cfg = tiny_cfg()
    jp = J.ffn_init(jax.random.PRNGKey(0), cfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    jx, tx = both(np.random.RandomState(7).randn(2, 5, cfg.d_model),
                  "bfloat16")
    close(T.ffn_apply(tp, tx), J.ffn_apply(jp, jx), "bfloat16")


@pytest.mark.parametrize("S", [1, 4])
def test_attn_apply_paged_matches_jax_with_qk_norm_and_bias(S):
    """One chunked-prefill (S = 4) or decode (S = 1) step against a paged
    pool that already holds 6 positions; qk_norm and QKV bias both on."""
    cfg = tiny_cfg(attn_bias=True)
    jp = J.attn_init(jax.random.PRNGKey(1), cfg)
    rng = np.random.RandomState(8)
    jp = dict(jp, bq=jnp.asarray(rng.randn(64) * 0.1, jnp.float32),
              bk=jnp.asarray(rng.randn(32) * 0.1, jnp.float32),
              q_norm=jnp.asarray(rng.randn(16) * 0.1, jnp.float32))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    page, N = 4, 6
    pool = {"k": rng.randn(N, page, 2, 16), "v": rng.randn(N, page, 2, 16)}
    ppos = np.full((N, page), -1, np.int32)
    table = np.asarray([[4, 1, 3, -1], [0, 2, 5, -1]], np.int32)
    for b in range(2):
        for p in range(6):
            ppos[table[b, p // page], p % page] = p
    positions = np.tile(np.arange(6, 6 + S, dtype=np.int32), (2, 1))
    positions[1] = -1                                # an idle slot
    jcache = {"k": both(pool["k"], "bfloat16")[0],
              "v": both(pool["v"], "bfloat16")[0], "pos": both(ppos)[0]}
    tcache = {"k": both(pool["k"], "bfloat16")[1],
              "v": both(pool["v"], "bfloat16")[1], "pos": both(ppos)[1]}
    jx, tx = both(rng.randn(2, S, cfg.d_model), "bfloat16")
    jout, jnew = J.attn_apply(jp, jx, cfg, positions=both(positions)[0],
                              cache=jcache, masked_slots=True,
                              table=jnp.asarray(table))
    tout, tnew = T.attn_apply(tp, tx, cfg, positions=both(positions)[1],
                              cache=tcache, masked_slots=True,
                              table=torch.from_numpy(table))
    close(tout, jout, "bfloat16")
    same(tnew["pos"], jnew["pos"])
    close(tnew["k"], jnew["k"], "bfloat16")
    close(tnew["v"], jnew["v"], "bfloat16")


def test_attn_apply_sliding_window_no_cache_matches_jax():
    """Sliding-window attention is ported now (``test_torch_swa.py`` holds
    its cache paths): the no-cache windowed branch matches JAX's, the
    flash path (its plain version on the CPU) and the scan path alike."""
    cfg = tiny_cfg()
    jp = J.attn_init(jax.random.PRNGKey(0), cfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.RandomState(5).standard_normal((2, 24, cfg.d_model))
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24))
    jx, tx = both(x)
    exp, _ = J.attn_apply(jp, jx, cfg, positions=jnp.asarray(pos), window=8)
    for use_kernel in (True, False):
        out, _ = T.attn_apply(tp, tx, cfg, positions=torch.from_numpy(
            pos.copy()), window=8, use_kernel=use_kernel)
        close(out, exp)
