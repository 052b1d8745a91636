"""Sliding-window attention of the port (``attn_apply`` with ``window >
0``) against the JAX package's, on gemma3-12b's smoke widths (window 64,
4 q / 2 kv heads of 64) and the same numpy inputs.

Each case runs a whole sequence of calls through both packages: an
80-token prompt (longer than the window) in chunks of 16 or 80 with the
per-row masked write the engine uses (slot 0 live, slot 1 idle), then
three decode steps after the wrap.  The caches are a dense ring of
``min(window, cache_len)`` = 64 entries, or ring pages of a paged pool
read through a per-kind {"attn", "swa"} table or through the first
columns of one shared table.  The port writes its caches in place, so
the ring before a chunk's write must be copied before the write; a port
that read it afterwards would attend over the chunk's own keys where the
evicted in-window keys were and drift from JAX here.  Also the dense
prefill longer than its ring (``generate()``'s path: no per-row write).
Outputs within 2e-2 of their scale in bfloat16 and 2e-5 in float32;
cache positions bit for bit, keys and values within the same tolerance.
"""
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
CFG = jax_smoke("gemma3-12b")
W = CFG.sliding_window                     # 64
PROMPT, PAGE, B = 80, 16, 2


@pytest.fixture(scope="module")
def params():
    jp = J.attn_init(jax.random.PRNGKey(0), CFG)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _close(t, j, dtype, what):
    j = np.asarray(j, np.float32)
    scale = max(1.0, float(np.abs(j).max()))
    np.testing.assert_allclose(t.float().numpy(), j,
                               atol=TOL[dtype] * scale, rtol=0, err_msg=what)


def _calls(chunk):
    """Positions (B, S) of the prefill chunks and three decode steps: row
    0 walks the prompt then decodes, row 1 stays idle."""
    out = []
    for c0 in range(0, PROMPT, chunk):
        pos = np.full((B, min(chunk, PROMPT - c0)), -1, np.int32)
        pos[0] = np.arange(c0, c0 + pos.shape[1])
        out.append(pos)
    for t in range(3):
        out.append(np.asarray([[PROMPT + t], [-1]], np.int32))
    return out


def _caches(layout, dtype):
    """The JAX cache of one layout and its table operand (numpy)."""
    if layout == "dense":
        jc = J.cache_init(B, W, CFG.n_kv_heads, CFG.head_dim, JDT[dtype])
        return jc, None
    nb = -(-W // PAGE)                         # 4 ring pages a slot
    jc = J.paged_cache_init(B * nb, PAGE, CFG.n_kv_heads, CFG.head_dim,
                            JDT[dtype])
    ring = np.asarray([[3, 1, 6, 0], [2, 5, 4, 7]], np.int32)
    if layout == "paged":
        table = {"attn": np.full((B, 8), -1, np.int32), "swa": ring}
    else:                                      # one shared, wider table
        table = np.concatenate([ring, np.full((B, 4), -1, np.int32)], 1)
    return jc, table


def _as_torch(table):
    if isinstance(table, dict):
        return {k: torch.from_numpy(v) for k, v in table.items()}
    return torch.from_numpy(table)


def _as_jax(table):
    if isinstance(table, dict):
        return {k: jnp.asarray(v) for k, v in table.items()}
    return jnp.asarray(table)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("chunk", [16, 80])
@pytest.mark.parametrize("layout", ["dense", "paged", "shared_table"])
def test_chunked_prefill_wraps_the_ring_then_decodes(params, layout, chunk,
                                                     dtype):
    jp, tp = params
    jc, table = _caches(layout, dtype)
    tc = {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.int32 if k == "pos" else TDT[dtype]) for k, v in jc.items()}
    rng = np.random.RandomState(1)
    for n, pos in enumerate(_calls(chunk)):
        x = rng.standard_normal((B, pos.shape[1], CFG.d_model)) * 0.5
        jx = jnp.asarray(x, JDT[dtype])
        tx = torch.from_numpy(x.astype(np.float32)).to(TDT[dtype])
        kw = dict(window=W, masked_slots=True)
        jo, jc = J.attn_apply(jp, jx, CFG, positions=jnp.asarray(pos),
                              cache=jc, table=None if table is None
                              else _as_jax(table), **kw)
        to, tc = T.attn_apply(tp, tx, CFG, positions=torch.from_numpy(pos),
                              cache=tc, table=None if table is None
                              else _as_torch(table), **kw)
        what = f"{layout} chunk {chunk} {dtype}: call {n}"
        _close(to[0], jo[0], dtype, what)      # the live row
        np.testing.assert_array_equal(tc["pos"].numpy(),
                                      np.asarray(jc["pos"]), err_msg=what)
        for name in ("k", "v"):
            _close(tc[name], jc[name], dtype, f"{what}: {name}")
    # the ring wrapped: it holds only the last 64 positions of row 0
    live = np.sort(tc["pos"].numpy().reshape(-1))
    assert live[-1] == PROMPT + 2 and (live[live >= 0] > PROMPT + 2 - W).all()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dense_prefill_longer_than_the_ring(params, dtype):
    """generate()'s prefill: row-uniform positions, no per-row write; the
    ring keeps the last 64 entries and the chunk attends over itself."""
    jp, tp = params
    jc, _ = _caches("dense", dtype)
    tc = {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.int32 if k == "pos" else TDT[dtype]) for k, v in jc.items()}
    x = np.random.RandomState(2).standard_normal((B, PROMPT, CFG.d_model))
    pos = np.broadcast_to(np.arange(PROMPT, dtype=np.int32), (B, PROMPT))
    jo, jc = J.attn_apply(jp, jnp.asarray(x, JDT[dtype]), CFG,
                          positions=jnp.asarray(pos), cache=jc, window=W)
    to, tc = T.attn_apply(tp, torch.from_numpy(x.astype(np.float32)).to(
        TDT[dtype]), CFG, positions=torch.from_numpy(pos.copy()), cache=tc,
        window=W)
    _close(to, jo, dtype, "output")
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    _close(tc["k"], jc["k"], dtype, "k")


@pytest.mark.parametrize("ring", [0, 24])
def test_paged_ring_write_matches_jax(ring):
    """``ring_write`` through a table: ``logical = pos % ring`` on ring
    pages, and of a chunk longer than the ring only its last ``ring``
    entries land; without a ring, positions map straight to columns."""
    N, page = 8, 8
    buf = np.random.RandomState(3).standard_normal((N, page, 2))
    table = np.asarray([[2, 5, 1, -1], [0, 7, 3, 6]], np.int32)
    pos = np.asarray([np.arange(3, 33), np.arange(40, 70)], np.int32)
    pos[1, :4] = -1
    if not ring:
        pos[1] = np.where(pos[1] >= 0, pos[1] - 40, -1)
    val = np.random.RandomState(4).standard_normal((2, 30, 2))
    jt = J.ring_write(jnp.asarray(buf, jnp.float32),
                      jnp.asarray(val, jnp.float32), jnp.asarray(pos),
                      table=jnp.asarray(table), ring=ring)
    tt = T.ring_write(torch.from_numpy(buf.astype(np.float32)),
                      torch.from_numpy(val.astype(np.float32)),
                      torch.from_numpy(pos), table=torch.from_numpy(table),
                      ring=ring)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
