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


def _probe_sass(body):
    """cuobjdump -sass text of fn_probe_kernel<0> (load, add, store) and
    fn_probe_kernel<1> whose function is `body`: [(op text)] between the
    load and the add, with "@!P0 BRA +k" for a branch k instructions on,
    "CALL sub" for a call of the subroutine placed after EXIT (three FFMAs,
    a loop back to its start, RET)."""
    out = ["\tcode for sm_90a"]
    for f, rows in ((0, []), (1, body)):
        out.append(f"\t\tFunction : _Z15fn_probe_kernelILi{f}EEvPKfS1_PfS2_")
        text = (["LDC R1, c[0x0][0x28]", "LDG.E R2, desc[UR4][R2.64]"]
                + list(rows) + ["FADD R0, R2, R5",
                                "STG.E desc[UR4][R2.64], R0", "EXIT"])
        sub = 16 * (len(text) + 1)
        for k, t in enumerate(text):
            m = t.split("+")
            if " +" in t:  # a branch k rows on
                t = f"{m[0]}{hex(16 * (k + int(m[1])))}"
            elif t == "CALL sub":
                t = f"CALL.REL.NOINC {hex(sub)}"
            out.append(f"        /*{16 * k:04x}*/                   {t} ;")
        k = len(text)
        for t in (f"BRA {hex(16 * k)}", "FFMA R0, R1, R2, R3",
                  f"@P1 BRA {hex(sub)}", "FFMA R0, R1, R2, R3",
                  "FFMA R0, R1, R2, R3", "RET.REL.NODEC R8 0x0", "NOP"):
            out.append(f"        /*{16 * k:04x}*/                   {t} ;")
            k += 1
    return "\n".join(out)


def test_fast_path_takes_the_fewest_instructions_to_exit():
    """A branch around a slow-path call: the fast path is the taken branch
    (four instructions and its BSYNC); the call costs its callee to RET
    (four, the loop back not taken); NOPs and the BRA to itself after EXIT
    are not counted."""
    body = ["MUFU.RSQ R3, R2", "BSSY B0, 0x100", "@!P0 BRA +4",
            "MOV R8, 0x80", "CALL sub", "BRA +4", "FMUL.FTZ R5, R2, R3",
            "FFMA R5, R0, R3, R5", "FFMA R5, R0, R3, R5", "BSYNC B0"]
    sass = _probe_sass(body)
    own = mfu.fast_path(sass, "fn_probe_kernelILi0E")
    assert own == {"ffma": 0, "other": 5, "slots": 5}
    c = mfu.fast_path(sass, "fn_probe_kernelILi1E")
    # LDC LDG MUFU BSSY BRA, FMUL FFMA FFMA BSYNC, FADD STG EXIT
    assert c == {"ffma": 2, "other": 10, "slots": 12}
    # without the branch the call is the only way: LDC LDG MUFU BSSY MOV
    # CALL, the callee's FFMA BRA FFMA FFMA RET, BRA to BSYNC, FADD STG EXIT
    slow = mfu.fast_path(_probe_sass(body[:2] + body[3:]),
                         "fn_probe_kernelILi1E")
    assert slow == {"ffma": 3, "other": 13, "slots": 16}
    with pytest.raises(RuntimeError):
        mfu.fast_path(sass, "missing_kernel")


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


def _q_sass(rows, rays):
    """cuobjdump -sass text of a q-kernel-like closest hit: a staging loop
    (no FFMA), then a tile loop around a row loop of `rows` rows a trip,
    each row 4 LDS.128 and `rays` tests of FMUL, 13 FFMA, 3 FADD, 3 LOP3,
    6 FSETP (one against the det epsilon), 2 FMUL and 5 SEL; and another
    kernel whose loop holds more FFMAs."""
    out = ["\tcode for sm_90a"]
    addr = 0

    def ins(text):
        nonlocal addr
        out.append(f"        /*{addr:04x}*/                   {text} ;"
                   f"                 /* 0x000fe20000000f00 */")
        addr += 16
        return addr - 16

    def test():
        ins("FMUL R20, R4, R8")
        for _ in range(13):
            ins("FFMA R20, R5, R9, R20")
        ins("LOP3.LUT R21, R20, 0x80000000, R22, 0x48, !PT")
        ins("LOP3.LUT R23, R24, 0x80000000, R22, 0x48, !PT")
        ins("LOP3.LUT R25, R26, 0x80000000, R22, 0x48, !PT")
        ins("FADD R27, |R22|, -R21")
        ins("FADD R27, R27, -R23")
        ins("FADD R28, R28, -c[0x0][0x10]")
        ins("FSETP.GT.AND P0, PT, |R22|, 9.9999999600419720025e-13, PT")
        ins("FSETP.GE.AND P0, PT, R21, RZ, P0")
        ins("FSETP.GE.AND P0, PT, R23, RZ, P0")
        ins("FSETP.GE.AND P0, PT, R27, RZ, P0")
        ins("FSETP.GT.AND P0, PT, R25, RZ, P0")
        ins("FMUL R29, R25, R30")
        ins("FMUL R31, R32, |R22|")
        ins("FSETP.GEU.AND P0, PT, R29, R31, !P0")
        for _ in range(5):
            ins("SEL R33, R33, R34, P0")

    for f, loop_tests in ((0, True), (1, False)):
        out.append(f"\t\tFunction : _ZN12_GLOBAL__N_18q_kernelILb{f}EEvPKfi")
        ins("LDC R1, c[0x0][0x28]")
        ins("S2R R0, SR_TID.X")
        top = ins("LDG.E R4, desc[UR4][R2.64]")
        ins("STS [R5], R4")
        ins("ISETP.GE.AND P0, PT, R5, 0x100, PT")
        ins(f"@!P0 BRA {hex(top)}")
        ins("BAR.SYNC.DEFER_BLOCKING 0x0")
        tile = ins("LDG.E R6, desc[UR4][R2.64]")
        row = ins("IADD3 R7, R7, 0x1, RZ")
        for _ in range(rows):
            for k in range(4):
                ins(f"LDS.128 R{8 + 4 * k}, [R7+{hex(16 * k)}]")
            for _ in range(rays if loop_tests else 1):
                test()
        ins("ISETP.GE.AND P1, PT, R7, R35, PT")
        ins(f"@!P1 BRA {hex(row)}")
        ins("STG.E desc[UR4][R2.64], R20")
        ins("ISETP.GE.AND P2, PT, R6, R36, PT")
        ins(f"@!P2 BRA {hex(tile)}")
        ins("EXIT")
        ins(f"BRA {hex(addr)}")
        ins("NOP")
    out.append("\t\tFunction : _ZN12_GLOBAL__N_114other_kernelEv")
    top = ins("FFMA R1, R2, R3, R4")
    for _ in range(200):
        ins("FFMA R1, R2, R3, R4")
    ins(f"@P0 BRA {hex(top)}")
    return "\n".join(out)


@pytest.mark.parametrize("rows,rays", [(1, 1), (4, 4), (2, 8)])
def test_count_sass_reads_a_q_tests_instructions(rows, rays):
    """count_sass(per_test=True) picks the row loop (the innermost loop
    with the most FFMAs: not the staging loop, not the tile loop around
    it, not another kernel's), counts its tests by the det epsilon's
    compares and its instructions by class; the loop's LDS.128 and its
    three instructions of overhead spread over the trip's tests."""
    c = mfu.count_sass(_q_sass(rows, rays), "q_kernelILb0E", per_test=True)
    tests = rows * rays
    assert c["tests_per_trip"] == tests
    assert c["loop"] == {"ffma": 13 * tests, "fmul": 3 * tests,
                         "fadd": 3 * tests, "fsetp": 6 * tests,
                         "lop3": 3 * tests, "lds": 4 * rows,
                         "other": 5 * tests + 3}
    assert c["ops"]["SEL"] == 5 * tests and c["ops"]["BRA"] == 1
    per = c["per_test"]
    assert per["ffma"] == 13 and per["fsetp"] == 6
    assert per["lds"] == pytest.approx(4 / rays)
    assert per["slots"] == pytest.approx(33 + (4 * rows + 3) / tests)
    assert per["slots"] == pytest.approx(sum(
        v for k, v in per.items() if k != "slots"))
    # the any-hit kernel's loop holds one test a row
    a = mfu.count_sass(_q_sass(rows, rays), "q_kernelILb1E", per_test=True)
    assert a["tests_per_trip"] == rows
    with pytest.raises(RuntimeError, match="no det epsilon"):
        mfu.count_sass(_q_sass(rows, rays), "other_kernel", per_test=True)
    with pytest.raises(RuntimeError, match="no SASS"):
        mfu.count_sass(_q_sass(rows, rays), "q_kernelILb2E", per_test=True)


def _sweep_sass(ffma):
    """cuobjdump -sass text of a sweep-like closest hit: a staging loop, a
    loop of 240 FFMAs and no det epsilon (more than the row loop's: a loop
    the rule of the most FFMAs would take), then a tile loop around a row loop fully unrolled to 16 tests
    a trip, each row 4 LDS.128 and one test: det, u, v and t in FMUL and
    13 FFMA (`ffma`) or 14 FMUL and 13 FADD (every product and sum
    rounded on its own), 3 LOP3, 3 FADD, 6 FSETP (one against the det
    epsilon), 2 FMUL and 3 SEL."""
    out = ["\tcode for sm_90a",
           "\t\tFunction : _ZN12_GLOBAL__N_114sweep_q_kernelILi16ELi1ELb0EEv"
           "PKfiS2_S2_S2_S2_iPfPiS3_S3_"]
    addr = 0

    def ins(text):
        nonlocal addr
        out.append(f"        /*{addr:04x}*/                   {text} ;"
                   f"                 /* 0x000fe20000000f00 */")
        addr += 16
        return addr - 16

    top = ins("LDG.E R4, desc[UR4][R2.64]")
    ins("STS [R5], R4")
    ins("ISETP.GE.AND P0, PT, R5, 0x200, PT")
    ins(f"@!P0 BRA {hex(top)}")
    top = ins("FFMA R9, R9, R10, R11")
    for _ in range(239):
        ins("FFMA R9, R9, R10, R11")
    ins(f"@P3 BRA {hex(top)}")
    tile = ins("LDG.E R6, desc[UR4][R2.64]")
    row = ins("IADD3 R7, R7, 0x400, RZ")
    for _ in range(16):
        for k in range(4):
            ins(f"LDS.128 R{8 + 4 * k}, [R7+{hex(16 * k)}]")
        ins("FMUL R20, R4, R8")
        for _ in range(13):
            if ffma:
                ins("FFMA R20, R5, R9, R20")
            else:
                ins("FMUL R21, R5, R9")
                ins("FADD R20, R20, R21")
        ins("LOP3.LUT R21, R20, 0x80000000, R22, 0x48, !PT")
        ins("LOP3.LUT R23, R24, 0x80000000, R22, 0x48, !PT")
        ins("LOP3.LUT R25, R26, 0x80000000, R22, 0x48, !PT")
        ins("FADD R27, |R22|, -R21")
        ins("FADD R27, R27, -R23")
        ins("FADD R28, R28, -c[0x0][0x10]")
        ins("FSETP.GT.AND P0, PT, |R22|, 9.9999999600419720025e-13, PT")
        ins("FSETP.GE.AND P0, PT, R21, RZ, P0")
        ins("FSETP.GE.AND P0, PT, R23, RZ, P0")
        ins("FSETP.GE.AND P0, PT, R27, RZ, P0")
        ins("FSETP.GT.AND P0, PT, R25, RZ, P0")
        ins("FMUL R29, R25, R30")
        ins("FMUL R31, R32, |R22|")
        ins("FSETP.GEU.AND P0, PT, R29, R31, !P0")
        for _ in range(3):
            ins("SEL R33, R33, R34, P0")
    ins("ISETP.GE.AND P1, PT, R7, R35, PT")
    ins(f"@!P1 BRA {hex(row)}")
    ins("STG.E desc[UR4][R2.64], R20")
    ins("ISETP.GE.AND P2, PT, R6, R36, PT")
    ins(f"@!P2 BRA {hex(tile)}")
    ins("EXIT")
    ins(f"BRA {hex(addr)}")
    return "\n".join(out)


@pytest.mark.parametrize("ffma", [True, False])
def test_count_sass_reads_a_sweep_trip(ffma):
    """count_sass(per_test=True) takes the sweep's row loop, the innermost
    loop with the most det-epsilon compares, over a loop with more FFMAs
    and none, with or without FFMAs in the test (the sweep built without
    FMA contraction had none); a fully unrolled trip is 16 tests, and its
    4 LDS.128 a row and 3 instructions of loop overhead spread over
    them."""
    c = mfu.count_sass(_sweep_sass(ffma), "sweep_q_kernelILi16ELi1ELb0E",
                       per_test=True)
    assert c["tests_per_trip"] == 16
    per = c["per_test"]
    want = ({"ffma": 13, "fmul": 3, "fadd": 3} if ffma
            else {"ffma": 0, "fmul": 16, "fadd": 16})
    assert {k: per[k] for k in want} == want
    assert per["fsetp"] == 6 and per["lop3"] == 3 and per["lds"] == 4
    assert c["ops"]["SEL"] == 48 and c["ops"]["BRA"] == 1
    assert per["other"] == pytest.approx(3 + 3 / 16)
    assert per["slots"] == pytest.approx(
        (35 if ffma else 48) + 3 / 16)
    assert per["slots"] == pytest.approx(sum(
        v for k, v in per.items() if k != "slots"))


def _mxu_sass():
    """`cuobjdump -sass` text shaped like B9's kernel: a staging loop, then
    a tile loop around the row loop: 5 LDS.128, 24 HMMA, the filter and a
    predicated branch around a candidate's FP32 test (LDG.128 and FFMA), a
    BSSY / BSYNC pair, then the loop's own compare and backward branch."""
    out = ["\t\tFunction : _ZN12_GLOBAL__N_110mxu_kernelILb1EEEvPKfiiS2_S2_"
           "S2_iPfPiS3_S3_Py"]
    addr = 0

    def ins(text):
        nonlocal addr
        out.append(f"        /*{addr:04x}*/                   {text} ;"
                   f"                 /* 0x000fe20000000f00 */")
        addr += 16
        return addr - 16

    top = ins("LDG.E.128 R4, desc[UR4][R2.64]")
    ins("STS.128 [R5], R4")
    ins("ISETP.GE.AND P0, PT, R5, 0x200, PT")
    ins(f"@!P0 BRA {hex(top)}")
    tile = ins("LDG.E R6, desc[UR4][R2.64]")
    row = ins("LDS.128 R8, [R7]")
    for k in range(4):
        ins(f"LDS.128 R{12 + 4 * k}, [R7+{hex(512 * (k + 1))}]")
    for _ in range(24):
        ins("HMMA.1688.F32.TF32 R40, R20, R30, R40")
    for _ in range(4):
        ins("LOP3.LUT R41, R42, 0x80000000, R40, 0x78, !PT")
        ins("FFMA R43, R9, R44, R41")
        ins("FSETP.GEU.AND P0, PT, R43, RZ, PT")
        ins("FADD R45, R41, R42")
        ins("FSETP.GT.OR P0, PT, R45, R46, P0")
        ins("BSSY B0, 0x9990")
        skip = addr + 16 * 11  # the BSYNC
        ins(f"@P0 BRA {hex(skip)}")
        for _ in range(4):
            ins("LDG.E.128.CONSTANT R48, desc[UR4][R2.64]")
        for _ in range(6):
            ins("FFMA R52, R48, R53, R52")
        ins("BSYNC B0")
    ins("IADD3 R7, R7, 0x10, RZ")
    ins("ISETP.GE.AND P1, PT, R7, R6, PT")
    ins(f"@!P1 BRA {hex(row)}")
    ins("STG.E desc[UR4][R2.64], R20")
    ins("ISETP.GE.AND P2, PT, R6, R36, PT")
    ins(f"@!P2 BRA {hex(tile)}")
    ins("EXIT")
    ins(f"BRA {hex(addr)}")
    ins("NOP")
    return "\n".join(out)


def test_loop_trip_reads_a_step_without_candidates():
    """loop_trip takes the innermost loop with the most HMMA (not the
    staging loop before it; with none it raises), and a trip that skips
    every candidate's test:
    5 LDS.128, 24 HMMA, 4 x (LOP3, FFMA, 2 FSETP, FADD, BSSY, BRA, BSYNC:
    the branch taken to the BSYNC) and 3 of loop; the span also counts the
    candidate bodies' LDG and FFMA."""
    c = mfu.loop_trip(_mxu_sass(), "mxu_kernelILb1EE")
    assert c["trip"] == {"LDS": 5, "HMMA": 24, "LOP3": 4, "FFMA": 4,
                         "FSETP": 8, "FADD": 4, "BSSY": 4, "BRA": 5,
                         "BSYNC": 4, "IADD3": 1, "ISETP": 1}
    assert c["slots"] == 64
    assert c["span"]["FFMA"] == 4 + 24 and c["span"]["LDG"] == 16
    with pytest.raises(RuntimeError, match="no HMMA"):
        mfu.loop_trip(_mxu_sass().replace("HMMA", "DMMA"),
                      "mxu_kernelILb1EE")


def _classic_sass():
    """`cuobjdump -sass` text shaped like B8a's filter kernel: a staging
    loop, then a tile loop around the row loop: per row 3 LDS.128, 27 FMUL,
    18 FADD, 3 LOP3 and 6 FSETP (one against the det epsilon); a vote and a
    predicated branch past the candidates' block, which holds its own loop
    (the exact test: another LDS.128, MUFU.RCP, an FSETP against the
    epsilon's neighbour) and a second backward branch; then the row loop's
    own compare and backward branch."""
    out = ["\t\tFunction : _ZN12_GLOBAL__N_114classic_kernelILb0ELb0EEEvPKfi"
           "S2_S2_S2_iPfPiS3_S3_Py"]
    addr = 0

    def ins(text):
        nonlocal addr
        out.append(f"        /*{addr:04x}*/                   {text} ;"
                   f"                 /* 0x000fe20000000f00 */")
        addr += 16
        return addr - 16

    top = ins("LDG.E.CONSTANT R4, desc[UR4][R2.64]")
    ins("STS [R5], R4")
    ins("ISETP.GE.AND P0, PT, R5, 0x200, PT")
    ins(f"@!P0 BRA {hex(top)}")
    tile = ins("LDG.E.CONSTANT R6, desc[UR4][R2.64]")
    row = ins("LDS.128 R8, [R7]")
    for k in range(4):
        for _ in range(3 if k else 2):
            ins("LDS.128 R12, [R7+0x10]")
        for _ in range(27):
            ins("FMUL R20, R21, R22")
        for _ in range(18):
            ins("FADD R23, R24, -R25")
        for _ in range(3):
            ins("LOP3.LUT R26, R27, 0x80000000, R28, 0x78, !PT")
        ins("FSETP.GT.AND P0, PT, |R28|, 9.9999999600419720025e-13, P0")
        for _ in range(5):
            ins("FSETP.GE.AND P0, PT, R26, -R29, P0")
    ins("PLOP3.LUT P4, PT, P1, P0, P2, 0xfe, 0x0")
    ins("VOTE.ANY P4, P4")
    tail = addr + 16 * 9
    ins(f"@!P4 BRA {hex(tail)}")
    cand = ins("LDS.128 R8, [R30]")
    ins("MUFU.RCP R31, R32")
    ins("FFMA R33, R32, R31, -1")
    ins("FMUL R34, R35, R31")
    ins("FSETP.GT.AND P5, PT, |R32|, 9.9999997e-13, PT")
    ins("LOP3.LUT R36, R36, R37, RZ, 0xc0, !PT")
    ins("VOTE.ANY P6, P6")
    ins(f"@P6 BRA {hex(cand)}")
    assert addr == tail
    ins("IADD3 R7, R7, 0xc0, RZ")
    ins("ISETP.GE.AND P1, PT, R7, R6, PT")
    ins(f"@!P1 BRA {hex(row)}")
    ins("STG.E desc[UR4][R2.64], R20")
    ins("ISETP.GE.AND P2, PT, R6, R36, PT")
    ins(f"@!P2 BRA {hex(tile)}")
    ins("EXIT")
    ins(f"BRA {hex(addr)}")
    ins("NOP")
    return "\n".join(out)


def test_loop_trip_reads_a_filter_trip_per_test():
    """loop_trip(..., per_test=True) takes the loop with the most FSETPs
    against the det epsilon (the row loop, not the candidates' loop inside
    it nor the staging loop), and a trip that skips the candidates' block:
    4 tests of 3 LDS.128, 27 FMUL, 18 FADD, 3 LOP3 and 6 FSETP, then
    PLOP3, VOTE, the branch and 3 of loop over the 4; with no epsilon it
    raises."""
    c = mfu.loop_trip(_classic_sass(), "classic_kernelILb0ELb0EE",
                      per_test=True, tests=4)
    assert c["tests_per_trip"] == 4
    assert c["trip"] == {"LDS": 12, "FMUL": 108, "FADD": 72, "LOP3": 12,
                         "FSETP": 24, "PLOP3": 1, "VOTE": 1, "BRA": 2,
                         "IADD3": 1, "ISETP": 1}
    assert c["per_test"]["slots"] == pytest.approx((4 * 57 + 6) / 4)
    assert c["span"]["MUFU"] == 1 and c["span"]["FSETP"] == 25
    with pytest.raises(RuntimeError, match="no det epsilon"):
        mfu.loop_trip(_classic_sass().replace("9.9999999600419720025e-13",
                                              "0.5"),
                      "classic_kernelILb0ELb0EE", per_test=True, tests=4)


def test_loop_trip_takes_the_tests_a_trip_runs():
    """The tests a trip runs come from the caller, and per_test raises
    without them: where nvcc compares a det with the epsilon twice (B8a's
    every-pair instance, after the reciprocal's slow-path branch), the
    slots a test still follow the tests given."""
    sass = _classic_sass().replace(
        "FSETP.GE.AND P0, PT, R26, -R29, P0",
        "FSETP.GT.AND P0, PT, |R28|, 9.9999999600419720025e-13, P0", 4)
    for tests in (None, 0):
        with pytest.raises(ValueError, match="tests a trip"):
            mfu.loop_trip(sass, "classic_kernelILb0ELb0EE", per_test=True,
                          tests=tests)
    c = mfu.loop_trip(sass, "classic_kernelILb0ELb0EE", per_test=True,
                      tests=4)
    assert c["tests_per_trip"] == 4
    assert c["per_test"]["slots"] == pytest.approx((4 * 57 + 6) / 4)
