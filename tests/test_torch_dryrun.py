"""The port's dry-run plane (``repro_torch.launch.dryrun``): each pair
traced in a process of its own (the fake process group is global state).

- Five pairs on the fake 256-rank production mesh (one attention with
  sliding windows, one RWKV, one hybrid whose MoE runs expert-parallel,
  one MLA, one frontend-stub decode that is red in the JAX package): each
  record is "ok" with 256 chips, and its per-chip argument bytes equal
  the JAX package's ``NamedSharding.shard_shape`` bytes of the same
  inputs; ``compute_s`` and ``memory_s`` equal JAX's analytic formula
  (``repro.core.workload``) over the H100 constants, to 1e-12 relative.
- Their collective bytes, kind by kind, beside the JAX package's dry-run
  record of the same pair (``_jax_dryrun_dump.py``): printed, and the
  total within ``COLL_BOUND`` of JAX's.
- A 1x1 mesh moves nothing: ``collective_s`` is 0.
- A tensor-parallel matmul on a fake 2x2 mesh: the all-gather of its
  column-split bf16 output counts the bytes a rank receives, by hand.
- The custom ops of the three kernels on the dry-run's path: their FLOP
  formulas equal ``FlopCounterMode``'s count of the plain versions; on
  fake tensors they run their fake implementations (launch counters
  untouched); on DTensors the model runs them and their plain versions
  on each rank's shard by one plan (``hints.LAYOUTS``).
"""
import json
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from _torch_dryrun import SRC, jax_dryrun, jax_dump  # noqa: E402

from repro_torch.launch import roofline as rl  # noqa: E402

PAIRS = [("gemma3-12b", "decode_32k"), ("rwkv6-7b", "long_500k"),
         ("jamba-1.5-large-398b", "prefill_32k"),
         ("deepseek-v3-671b", "decode_32k"),
         ("musicgen-medium", "decode_32k")]
# the port's plans (DTensor's redistributions and the local maps of
# ``hints.LAYOUTS``) against GSPMD's: collective bytes within this factor
# of the JAX package's on these pairs (0.5-1.6 when written; the plans of
# an attention that gathered whole caches were 62-80 times JAX's)
COLL_BOUND = 4.0
ITEMSIZE = {"bfloat16": 2, "float32": 4, "int32": 4, "uint32": 4, "bool": 1,
            "int8": 1}


def _py(code: str, timeout: int = 300) -> str:
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return jax_dump(str(tmp_path_factory.mktemp("jax_dryrun")))


@pytest.fixture(scope="module")
def jax_records(tmp_path_factory):
    return jax_dryrun(str(tmp_path_factory.mktemp("jax_records")), PAIRS)


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_pair_on_the_production_mesh(ref, jax_records, arch, shape,
                                     tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--device", "cpu", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads((tmp_path / f"{arch}_{shape}_pod16x16.json").read_text())
    assert rec["status"] == "ok", (rec.get("error"), rec.get("where"))
    assert rec["chips"] == 256 and rec["mesh"] == "pod16x16"

    case = ref["cases"][f"{arch}|{shape}|dense"]
    want = 0
    for g, per in case["meshes"]["pod16x16"].items():
        dtypes = [d for _, _, d in case["leaves"][g]]
        want += sum(math.prod(shard) * ITEMSIZE[dt]
                    for (_, _, shard), dt in zip(per, dtypes))
    assert rec["per_chip_arg_bytes"] == want

    from repro.configs import INPUT_SHAPES, get_config
    from repro.core.workload import (analytic_hbm_bytes, model_flops,
                                     step_flops)
    cfg, sh = get_config(arch), INPUT_SHAPES[shape]
    B, S = sh.global_batch, sh.seq_len
    kw = (dict(batch=B, seq=1, kind="decode", kv_cache_len=S)
          if sh.kind == "decode" else dict(batch=B, seq=S, kind=sh.kind))
    eflops = step_flops(cfg, batch=kw["batch"], seq=kw["seq"], kind=sh.kind,
                        kv_cache_len=kw.get("kv_cache_len", 0))
    ro = rec["roofline"]
    assert ro["model_flops"] == pytest.approx(model_flops(cfg, **kw),
                                              rel=1e-12)
    assert ro["compute_s"] == pytest.approx(eflops / (256 * 989e12),
                                            rel=1e-12)
    assert ro["memory_s"] == pytest.approx(
        analytic_hbm_bytes(cfg, **kw) / (256 * 3.35e12), rel=1e-12)
    assert ro["bottleneck"] in ("compute", "memory", "collective")
    assert rec["memory_analysis"]["temp_size_in_bytes"] > 0

    # collective bytes by kind beside the JAX package's record of the pair
    jrec = jax_records[(arch, shape)]
    assert jrec["status"] == "ok", jrec.get("error")
    mine, theirs = ro["coll_detail"], jrec["roofline"]["coll_detail"]
    print(f"{arch} x {shape} collective bytes, port / JAX: " + ", ".join(
        f"{k} {mine[k]:.4g} / {theirs[k]:.4g}" for k in theirs))
    assert mine["total"] <= COLL_BOUND * theirs["total"], (
        mine["total"] / theirs["total"])


def test_one_rank_mesh_moves_nothing():
    out = _py("""
import json
from repro_torch.launch import dryrun, mesh
m = mesh.make_mesh((1, 1), ("data", "model"), device_type="cpu")
rec = dryrun.run_one("rwkv6-7b", "decode_32k", mesh=m, mesh_name="1x1",
                     device="cpu", verbose=False)
print(json.dumps(rec))
""")
    rec = json.loads(out.splitlines()[-1])
    assert rec["status"] == "ok", rec.get("error")
    assert rec["chips"] == 1
    assert rec["roofline"]["collective_s"] == 0.0
    assert rec["roofline"]["coll_detail"]["total"] == 0.0


def test_tp_matmul_all_gather_bytes_by_hand():
    """x (8, 64) split by rows over data, w (64, 32) split by columns over
    model: y = x @ w is split both ways with no traffic; making y whole
    over model all-gathers, into each rank, a (4, 32) bf16 block: 256
    bytes, at the NVLink rate (4 ranks share a node)."""
    out = _py("""
import json, torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.launch import mesh, roofline
m = mesh.make_mesh((2, 2), ("data", "model"), device_type="cpu")
with FakeTensorMode():
    x = DTensor.from_local(torch.empty(4, 64, dtype=torch.bfloat16), m,
                           [Shard(0), Replicate()], run_check=False,
                           shape=(8, 64), stride=(64, 1))
    w = DTensor.from_local(torch.empty(64, 16, dtype=torch.bfloat16), m,
                           [Replicate(), Shard(1)], run_check=False,
                           shape=(64, 32), stride=(32, 1))
    c = roofline.TraceCounter()
    with c:
        y = x @ w
        before = dict(c.coll)
        y = y.redistribute(m, [Shard(0), Replicate()])
print(json.dumps([before, c.coll, c.coll_s, c.flops, list(y.placements[1:].__repr__())]))
""")
    before, after, secs, flops, _ = json.loads(out.splitlines()[-1])
    assert sum(before.values()) == 0
    assert after["all-gather"] == 4 * 32 * 2
    assert sum(after.values()) == after["all-gather"]
    assert secs == pytest.approx(256 / rl.NVLINK_BW)
    assert flops == 2 * 4 * 64 * 16          # one rank's local matmul


def test_custom_op_flops_equal_the_plain_versions():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels import mamba_scan, paged_attention, ref, rwkv_scan
    g = torch.Generator().manual_seed(0)
    B, Hq, Hkv, D, De, page, n_cols = 3, 8, 2, 16, 8, 4, 5
    q = torch.randn(B, 1, Hq, D, generator=g)
    k = torch.randn(B * n_cols, page, Hkv, D, generator=g)
    qe = torch.randn(B, 1, Hq, De, generator=g)
    ke = torch.randn(B * n_cols, page, Hkv, De, generator=g)
    pos = torch.arange(B * n_cols * page, dtype=torch.int32).reshape(-1, page)
    tab = torch.arange(B * n_cols, dtype=torch.int32).reshape(B, n_cols)
    qp = torch.full((B, 1), 10, dtype=torch.int32)
    r = torch.randn(2, 5, 3, 8, generator=g)
    x = torch.randn(2, 5, 12, generator=g)
    bm = torch.randn(2, 5, 4, generator=g)
    a = -torch.rand(12, 4, generator=g)
    cases = [
        (lambda: ref.paged_attention_ref(q, k, k, pos, tab, qp, q_extra=qe,
                                         k_extra=ke),
         paged_attention.paged_attention_flops(B, Hq, n_cols, page, D, D,
                                               De)),
        (lambda: ref.rwkv_scan_ref(r, r, r, r.sigmoid(), r[0, 0]),
         rwkv_scan.rwkv_scan_flops(2, 5, 3, 8)),
        (lambda: ref.mamba_scan_ref(x, x, bm, bm, a),
         mamba_scan.mamba_scan_flops(2, 5, 12, 4))]
    for fn, formula in cases:
        with FlopCounterMode(display=False) as fc:
            fn()
        assert fc.get_total_flops() == formula
    # on fake CUDA tensors the ops run their fake implementations: the
    # formula counts, the launch counters do not move
    launches = (paged_attention.paged_attention_fwd.launches,
                rwkv_scan.rwkv_scan_fwd.launches,
                mamba_scan.mamba_scan_fwd.launches)
    with FakeTensorMode():
        fq, fk, fqe, fke = (torch.empty(t.shape, device="cuda")
                            for t in (q, k, qe, ke))
        fpos, ftab, fqp = (torch.empty(t.shape, dtype=torch.int32,
                                       device="cuda") for t in (pos, tab, qp))
        with FlopCounterMode(display=False) as fc:
            out = paged_attention.paged_attention_fwd(
                fq, fk, fk, fpos, ftab, fqp, q_extra=fqe, k_extra=fke)
        assert out.shape == (B, 1, Hq, D) and out.device.type == "cuda"
        assert fc.get_total_flops() == cases[0][1]
        fr = torch.empty(r.shape, device="cuda")
        st = torch.empty((2, 3, 8, 8), device="cuda")
        o, s = rwkv_scan.rwkv_scan_fwd(fr, fr, fr, fr, torch.empty(
            (3, 8), device="cuda"), s0=st, state_out=st, return_state=True)
        assert o.shape == r.shape and s is st
        fx = torch.empty(x.shape, device="cuda")
        y = mamba_scan.mamba_scan_fwd(fx, fx, torch.empty(bm.shape,
                                                          device="cuda"),
                                      torch.empty(bm.shape, device="cuda"),
                                      torch.empty(a.shape, device="cuda"))
        assert y.shape == x.shape
    assert launches == (paged_attention.paged_attention_fwd.launches,
                        rwkv_scan.rwkv_scan_fwd.launches,
                        mamba_scan.mamba_scan_fwd.launches)


def test_kernels_and_plain_versions_share_one_plan():
    """As DTensors on a fake 2x2 mesh, each op traced through the model's
    function with the kernel (fake cuda tensors on a cuda mesh: the custom
    op) and with its plain version (on a cpu mesh): both keep slots and GQA heads split (no
    collective where the inputs are already laid out), MLA's single
    latent head splits slots on the mesh dim that splits the table and
    runs whole on the one that splits the latent width, kv heads that do not
    divide the ranks are not split (a GQA group would part from its kv
    head), the scans keep slots and heads / channels split, and the two
    trace the same output placements and the same collectives.  A custom
    op called on DTensors directly has no rule: it raises."""
    out = _py("""
import json, torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate as R, Shard as S
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.launch import mesh, roofline
from repro_torch.models import layers, ssm
meshes = {dev: mesh.make_mesh((2, 2), ("data", "model"), device_type=dev)
          for dev in ("cpu", "cuda")}
def dt(shape, pl, dtype=torch.bfloat16, dev="cpu"):
    loc = list(shape)
    for p in pl:
        if isinstance(p, S):
            loc[p.dim] //= 2
    return DTensor.from_local(torch.empty(loc, dtype=dtype, device=dev),
                              meshes[dev], pl, run_check=False, shape=shape,
                              stride=torch.empty(shape).stride())
def cases(dev):
    d = lambda *a, **k: dt(*a, dev=dev, **k)
    i32, f32 = torch.int32, torch.float32
    pos = d((32, 16), [R(), R()], i32)
    tab = d((4, 8), [S(0), R()], i32)
    qp = d((4, 1), [S(0), R()], i32)
    k = d((32, 16, 4, 64), [R(), S(2)])
    yield "gqa", lambda kern: layers.attention(
        d((4, 1, 8, 64), [S(0), S(2)]), k, k, qp, pos, table=tab,
        scale=.1, use_kernel=kern)
    pool = d((32, 16, 1, 64), [S(0), S(3)])
    ke = d((32, 16, 1, 16), [S(0), S(3)])
    yield "mla", lambda kern: layers.attention(
        d((4, 1, 8, 64), [R(), S(3)]), pool, pool, qp, pos, table=tab,
        scale=.1, q_extra=d((4, 1, 8, 16), [R(), S(3)]), k_extra=ke,
        use_kernel=kern)
    k3 = d((32, 16, 3, 64), [R(), R()])
    yield "uneven", lambda kern: layers.attention(
        d((4, 1, 6, 64), [S(0), R()]), k3, k3, qp, pos, table=tab,
        scale=.1, use_kernel=kern)
    r = d((4, 1, 4, 8), [S(0), S(2)])
    w = d((4, 1, 4, 8), [S(0), S(2)], f32)
    st = d((4, 4, 8, 8), [S(0), S(1)], f32)
    yield "rwkv", lambda kern: ssm._rwkv_scan(
        r, r, r, w, d((4, 8), [R(), S(0)], f32), st, None, kern)[0]
    x = d((4, 1, 16), [S(0), S(2)])
    b = d((4, 1, 4), [S(0), R()])
    h = d((4, 16, 4), [S(0), S(1)], f32)
    yield "mamba", lambda kern: ssm._mamba_scan(
        x, x, b, b, d((16, 4), [R(), S(0)], f32), h, None, kern)[0]
out = {}
with FakeTensorMode(allow_non_fake_inputs=True), implicit_replication():
    for dev, kern in (("cpu", False), ("cuda", True)):
        for name, fn in cases(dev):
            c = roofline.TraceCounter()
            with c:
                o = fn(kern)
            out[f"{name}/{kern}"] = {
                "placements": [repr(p) for p in o.placements],
                "coll": dict(c.coll), "calls": dict(c.custom_calls)}
    q = dt((4, 1, 8, 64), [S(0), S(2)], dev="cuda")
    k = dt((32, 16, 4, 64), [R(), S(2)], dev="cuda")
    i = lambda shape, pl: dt(shape, pl, torch.int32, "cuda")
    try:
        torch.ops.repro_torch.paged_attention(
            q, k, k, i((32, 16), [R(), R()]), i((4, 8), [S(0), R()]),
            i((4, 1), [S(0), R()]), None, None, .1, 0, 0.)
        out["direct"] = "ran"
    except Exception as e:  # noqa: BLE001
        out["direct"] = type(e).__name__
print(json.dumps(out))
""")
    got = json.loads(out.splitlines()[-1])
    want = {"gqa": ["Shard(dim=0)", "Shard(dim=2)"],
            "mla": ["Shard(dim=0)", "Replicate()"],
            "rwkv": ["Shard(dim=0)", "Shard(dim=2)"],
            "mamba": ["Shard(dim=0)", "Shard(dim=2)"]}
    for name in ("gqa", "mla", "uneven", "rwkv", "mamba"):
        plain, kern = got[f"{name}/False"], got[f"{name}/True"]
        assert plain["placements"] == kern["placements"], name
        assert plain["coll"] == kern["coll"], name
        assert plain["calls"] == {}, name
        op = {"rwkv": "rwkv_scan", "mamba": "mamba_scan"}.get(
            name, "paged_attention")
        assert kern["calls"] == {op: 1}, name
        if name in want:
            assert kern["placements"] == want[name], name
    assert "Shard(dim=2)" not in got["uneven/True"]["placements"]
    assert sum(got["gqa/True"]["coll"].values()) == 0   # laid out: local
    assert got["direct"] != "ran"
