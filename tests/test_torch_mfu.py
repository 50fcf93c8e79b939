"""The FMA roof probe (B11d) and the port of the per-kernel MFU tool
(`tools/kernel_mfu.py`) on the CPU: `fma_roof_plain` against the JAX tool's
`_fma_kernel` (`tools/experiments/kernel_mfu.py`) in interpret mode, the
tool's analytic counts, the SASS count, and its host BVH walk against a
numpy statement of the JAX tool's loop."""
import importlib.util
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mitsuba3_plt_tpu_torch import ops
from mitsuba3_plt_tpu_torch.ops import mfu
from mitsuba3_plt_tpu_torch.scene.bvh import build_bvh
from mitsuba3_plt_tpu_torch.scene.presets import cornell_box, mesh_scene
from mitsuba3_plt_tpu_torch.scene.shape import make_sphere
from mitsuba3_plt_tpu_torch.tools import isect_unroll_sweep as us
from mitsuba3_plt_tpu_torch.tools import kernel_mfu as km

KERNEL_MFU_PY = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools", "experiments", "kernel_mfu.py")


@pytest.fixture(scope="module")
def jax_mfu():
    """The JAX tool as a module (its `main` is guarded)."""
    spec = importlib.util.spec_from_file_location("jax_kernel_mfu",
                                                  KERNEL_MFU_PY)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_fma(mod, x, a):
    """`_fma_kernel` over x [8 k, 128] as `vpu_fma_roof` calls it (a whole,
    x in (8, 128) tiles), in interpret mode."""
    rows = x.shape[0]
    spec = pl.BlockSpec((mod.SUB, mod.LANES), lambda i: (i, 0),
                        memory_space=pltpu.VMEM)
    f = pl.pallas_call(
        mod._fma_kernel, grid=(rows // mod.SUB,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM), spec],
        out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((rows, mod.LANES), jnp.float32),
        interpret=True)
    return np.asarray(f(jnp.asarray(a), jnp.asarray(x)))


def _ulps(a, b):
    """|a - b| in units in the last place (same-sign float32)."""
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32))


@pytest.mark.parametrize("inputs", ["probe", "random"])
def test_fma_roof_plain_matches_jax_kernel(jax_mfu, inputs):
    """The probe's own inputs (ones, a = 0.9999999) and random ones over
    two tiles, a per row of the tile and lane, some chains driven into the
    3e38 clamp (their sums overflow to inf in both). Tolerance: 1 ulp
    an element, the plain version's double rounding; XLA on this CPU
    contracts each x a + c into an FMA (measured: 0 ulp; rounding the
    product and the sum apart moves the random case by up to 79 ulp)."""
    rows = 16
    if inputs == "probe":
        x = np.ones((rows, 128), np.float32)
        a = np.full((8, 128), 0.9999999, np.float32)
    else:
        rng = np.random.default_rng(3)
        x = rng.uniform(0.5, 2.0, (rows, 128)).astype(np.float32)
        a = rng.uniform(0.98, 1.02, (8, 128)).astype(np.float32)
        x[3, :8] = 1e38
        a[3, :8] = 1.5
    want = _jax_fma(jax_mfu, x, a)
    got = mfu.fma_roof(torch.as_tensor(x), torch.as_tensor(a)).numpy()
    assert int(_ulps(got, want).max()) <= 1
    if inputs == "random":
        # rows 3 and 11 meet a = 1.5 on their first 8 lanes: 1.5^512
        clamp = np.zeros(x.shape, bool)
        clamp[[3, 11], :8] = True
        assert np.isinf(got[clamp]).all() and np.isfinite(got[~clamp]).all()
        # a broadcasts by row: tile 1 of x meets the same a as tile 0
        x2 = x.copy()
        x2[8:] = x[:8]
        same = mfu.fma_roof_plain(torch.as_tensor(x2), torch.as_tensor(a))
        assert torch.equal(same[8:], same[:8])


def test_fma_roof_checks_arguments():
    x, a = torch.ones((16, 128)), torch.ones((8, 128))
    with pytest.raises(ValueError):
        mfu.fma_roof(x[:12], a)
    with pytest.raises(ValueError):
        mfu.fma_roof(x, a[:4])
    with pytest.raises(ValueError):
        mfu.fma_roof(x[:, :64], a)
    with pytest.raises(TypeError):
        mfu.fma_roof(x.double(), a)
    assert mfu.FMA_ITERS == 2048 and mfu.FMA_STEPS == 512


def _sass(unroll):
    """cuobjdump -sass text of a probe-like kernel whose step loop holds
    `unroll` steps of the four chains."""
    lines = ["\tcode for sm_90a",
             "\t\tFunction : _ZN12_GLOBAL__N_115other_kernelEv",
             "        /*0000*/                   FFMA R1, R2, R3, R4 ;",
             "\t\tFunction : _ZN12_GLOBAL__N_115fma_roof_kernelEPKfS1_Pfi",
             '\t.headerflags\t@"EF_CUDA_SM90"']
    addr = 0

    def ins(text):
        nonlocal addr
        lines.append(f"        /*{addr:04x}*/                   {text} ;"
                     f"                 /* 0x000fe20000000f00 */")
        lines.append("                                          "
                     "/* 0x000fe40000000800 */")
        addr += 16

    for text in ("LDC R1, c[0x0][0x28]", "S2R R0, SR_TID.X",
                 "LDG.E R4, desc[UR4][R2.64]", "FFMA R5, R4, 1, 0.25",
                 "FFMA R6, R4, 0.99999988079071044922, 0.5",
                 "FFMA R7, R4, 1.0000002384185791016, 0.75"):
        ins(text)
    top = addr
    for _ in range(unroll):
        for c in range(4):
            ins(f"FFMA R{8 + c}, R{8 + c}, R3, 1.0000000116860974231e-09")
            ins(f"FMNMX R{8 + c}, R{8 + c}, 3.0000000331813535140e+38, PT")
    ins("IADD3 R0, R0, 0x1, RZ")
    ins("ISETP.NE.AND P0, PT, R0, 0x200, PT")
    ins(f"@P0 BRA {hex(top)}")
    ins("FADD R5, R4, R5")
    ins("STG.E desc[UR4][R2.64], R5")
    ins("EXIT")
    ins(f"BRA {hex(addr)}")
    ins("NOP")
    ins("NOP")
    return "\n".join(lines)


@pytest.mark.parametrize("unroll", [4, 32])
def test_count_sass_reads_the_issued_instructions(unroll):
    c = mfu.count_sass(_sass(unroll), "fma_roof_kernel")
    trips = mfu.FMA_STEPS // unroll
    assert c["loop_trips"] == trips
    assert c["loop"] == {"ffma": 4 * unroll, "fmnmx": 4 * unroll,
                         "other": 3}
    assert c["outside"] == {"ffma": 3, "fmnmx": 0, "other": 6}
    assert c["ffma"] == mfu.FMA_ITERS + 3 and c["fmnmx"] == mfu.FMA_ITERS
    assert c["other"] == 6 + 3 * trips
    assert c["slots"] == c["ffma"] + c["fmnmx"] + c["other"]
    assert c["per_step"]["fmnmx"] == 4
    with pytest.raises(RuntimeError):
        mfu.count_sass(_sass(4), "missing_kernel")


def _jax_walk(lo, hi, first, cnt, miss, o_np, d_np):
    """`kernel_mfu.py:236-255` as written there, per ray."""
    nodes_v = 0
    tris_t = 0
    for i in range(len(o_np)):
        node = 0
        inv = 1.0 / np.where(np.abs(d_np[i]) > 1e-12, d_np[i], 1e-12)
        while node >= 0 and node < len(lo):
            t0 = (lo[node] - o_np[i]) * inv
            t1 = (hi[node] - o_np[i]) * inv
            near = np.minimum(t0, t1).max()
            far = np.maximum(t0, t1).min()
            nodes_v += 1
            if near <= far and far > 0:
                if cnt[node] > 0:
                    tris_t += int(cnt[node])
                    node = miss[node]
                else:
                    node = node + 1
            else:
                node = miss[node]
            if node < 0:
                break
    return nodes_v, tris_t


def test_host_bvh_walk_matches_the_jax_loop():
    """The vectorised walk against the JAX tool's loop on 256 sampled
    camera rays of mesh_scene(32, 32, 3) and 64 rays from inside the
    sphere (every leaf box they meet in front of them is entered)."""
    scene = mesh_scene(32, 32, 3, device="cpu")
    mesh = make_sphere(3)
    bvh = build_bvh(mesh.vertices, mesh.faces)
    o, d, mt = km.pixel_rays(scene)
    assert o.shape == (1024, 3) and torch.isinf(mt).all()
    sel = np.random.default_rng(0).integers(0, 1024, 256)
    rng = np.random.default_rng(1)
    inner_o = rng.uniform(-0.3, 0.3, (64, 3)).astype(np.float32)
    inner_d = rng.normal(size=(64, 3)).astype(np.float32)
    inner_d[:4, 0] = 0.0  # axis-parallel: the 1e-12 guard
    for o_np, d_np in ((o.numpy()[sel], d.numpy()[sel]), (inner_o, inner_d)):
        got = km.bvh_walk_stats(bvh, o_np, d_np)
        want = _jax_walk(bvh.node_lo, bvh.node_hi, bvh.node_first,
                         bvh.node_count, bvh.node_miss, o_np, d_np)
        assert got == want
        assert got[1] > 0


def test_clu2_setup_walks_the_scenes_own_bvh():
    """`clu2_setup`'s BVH is the one the scene's treelet table was packed
    from (built once): node for node the native builder's BVH of the same
    icosphere, and the scene equals `mesh_scene`'s; a brute-routed
    icosphere has no such BVH."""
    scene, bvh = km.clu2_setup("cpu", 8, 5)
    mesh = make_sphere(5)
    ref = build_bvh(mesh.vertices, mesh.faces)
    for k in ("node_lo", "node_hi", "node_first", "node_count",
              "node_miss"):
        np.testing.assert_array_equal(getattr(bvh, k), getattr(ref, k))
    want = mesh_scene(8, 8, 5, device="cpu")
    for k in ("supers", "boxes", "rows", "anchor"):
        assert torch.equal(getattr(scene.ctab2, k), getattr(want.ctab2, k))
    with pytest.raises(ValueError, match="brute force"):
        km.clu2_setup("cpu", 8, 2)


def test_probe_counts_on_the_cpu():
    """Each probe's counts (the JAX tool's), no launches on the CPU, and
    the rates and shares from given times."""
    cbox = cornell_box(16, 16, device="cpu")
    rays = us.sweep_rays(cbox, 1024, seed=2)
    ops.reset_launch_counts()
    fma = km.fma_roof_probe("cpu", rows=8,
                            sass={"slots": 4100, "ffma": 2051})
    hbm = km.hbm_probe("cpu", n=4096)
    qc, qa = km.q_probe(cbox, rays)
    lobe = km.lobe_sum_probe("cpu", n=64)
    clu2 = km.clu2_probe(*km.clu2_setup("cpu", 16, 5), samples=32)
    assert all(v == 0 for v in ops.launch_counts().values())
    assert fma["flop"] == 8 * 128 * 2048 * 2 and fma["finite"]
    assert fma["slots"] == 8 * 128 * 4100 and fma["ms"] is None
    assert hbm["bytes"] == 4096 * 4 * 4 and hbm["correct"]
    assert hbm["bytes_jax_count"] == hbm["copy_bytes"] == 4096 * 4 * 2
    # 36 faces: T_pad 48 (closest, unroll 16) and 64 (any hit, 32)
    assert (qc["pairs"], qa["pairs"]) == (1024 * 48, 1024 * 64)
    assert qc["flop"] == qc["pairs"] * 38 and qc["slots"] == qc["pairs"] * 32
    assert qa["slots"] == qa["pairs"] * 28
    assert 0 < qa["pairs_tested"] < 1024 * 36
    assert qc["hit_share"] == pytest.approx(qa["occluded_share"])
    assert lobe["finite"] and lobe["n"] == 64 and "flop" not in lobe
    assert clu2["faces"] == 20480 and clu2["n"] == 256
    assert clu2["useful_flop_per_ray"] == pytest.approx(
        clu2["nodes_per_ray"] * 14 + clu2["tris_per_ray"] * 38)
    # given times: 0.5 ms a chained FMA call (0.6 at 16 rows), 2 ms a
    # roll, 1 ms a copy or a q call
    sass = {"slots": 4100}
    fma = km.fma_roof_probe("cpu", rows=8, chained=lambda f, x: 0.5,
                            sass=sass)
    wide = km.fma_roof_probe("cpu", rows=16, chained=lambda f, x: 0.6,
                             sass=sass)
    hbm = km.hbm_probe("cpu", n=4096, chained=lambda f, x: 2.0,
                       timer=lambda fn: 1.0)
    qc = km.q_probe(cbox, rays, timer=lambda fn: 1.0)[0]
    r = km.roofs([fma, wide], hbm)
    assert r["flops"] == wide["flop"] / 6e-4
    assert r["slots"] == 16 * 128 * 4100 / 6e-4
    assert hbm["bytes_per_s"] == 4096 * 16 / 2e-3
    assert r["bytes"] == hbm["copy_bytes_per_s"] == 4096 * 8 / 1e-3
    assert r["published_slots"] == 67e12 / 2
    s = km.shares(qc, r)
    assert s["flop_share"]["measured"] == pytest.approx(
        qc["flop"] / 1e-3 / r["flops"])
    assert s["slot_share"]["jax_rule"] == pytest.approx(
        qc["slots"] / 1e-3 / (r["flops"] / 2))
    assert s["slot_share"]["published"] == pytest.approx(
        qc["slots"] / 1e-3 / 33.5e12)
    assert qc["gpairs_per_s"] == qc["pairs"] / 1e6
