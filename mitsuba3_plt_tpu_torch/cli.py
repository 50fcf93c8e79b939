"""Render a Mitsuba XML scene from the command line:

    python -m mitsuba3_plt_tpu_torch.cli scene.xml -o out/result \\
        --spp 256 -D key=value --integrator plt [--device cpu]

Writes <out>.pfm, <out>.png (tonemapped) and <out>_params.json (the
integrator, spp, resolution, load and render seconds and time_per_sample
in ms a sample per pixel, and the render's pass statistics), and for a
15-channel Stokes image also <out>_S0.pfm .. <out>_S3.pfm. --profile DIR
writes a torch.profiler trace of the render to DIR/trace.json."""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description="mitsuba3_plt_tpu_torch "
                                             "renderer")
    ap.add_argument("scene", help="scene .xml file")
    ap.add_argument("-o", "--output", default="result")
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("-m", "--variant", default="rgb",
                    help="rgb | rgb_polarized")
    ap.add_argument("-D", "--define", action="append", default=[],
                    help="scene parameter key=value")
    ap.add_argument("--integrator", default=None,
                    help="the integrator's type (path, plt, stokes, ...)")
    ap.add_argument("--max-depth", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resx", type=int, default=None)
    ap.add_argument("--resy", type=int, default=None)
    ap.add_argument("--sampler", default=None,
                    help="the sampler's type (default: the scene's)")
    ap.add_argument("--timeout", type=float, default=None,
                    help="stop between passes after this many seconds and "
                         "write the passes done")
    ap.add_argument("--profile", default=None,
                    help="directory for a torch.profiler trace")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    import numpy as np

    import mitsuba3_plt_tpu_torch as mi
    from mitsuba3_plt_tpu_torch.integrators import make_integrator
    from mitsuba3_plt_tpu_torch.utils.io import write_bitmap

    mi.set_variant(args.variant)
    params = dict(d.partition("=")[::2] for d in args.define)
    if args.resx:
        params["resx"] = args.resx
    if args.resy:
        params["resy"] = args.resy

    t0 = time.perf_counter()
    scene, meta = mi.load_file(args.scene, parameters=params,
                               device=args.device)
    t_load = time.perf_counter() - t0
    integrator_cfg = dict(meta.get("integrator", {"type": "path"}))
    if args.integrator:
        integrator_cfg["type"] = args.integrator
    if args.max_depth:
        integrator_cfg["max_depth"] = args.max_depth
    integ = make_integrator(integrator_cfg)
    spp = args.spp or meta.get("spp", 16)
    kw = {"sampler_type": args.sampler} if args.sampler else {}
    stats = {}

    def progress(done, total, elapsed):
        if not args.quiet:
            print(f"\r[{100.0 * done / total:5.1f}%] pass {done}/{total}  "
                  f"{elapsed:7.1f}s", end="", flush=True)

    prof = contextlib.nullcontext()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if scene.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
    t0 = time.perf_counter()
    with prof as p:
        img = mi.render((scene, meta), integrator=integ, spp=spp,
                        seed=args.seed, timeout=args.timeout,
                        progress=progress, stats=stats, **kw)
        img = img.cpu().numpy()
    t_render = time.perf_counter() - t0
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        p.export_chrome_trace(os.path.join(args.profile, "trace.json"))
    if not args.quiet:
        print()

    out = args.output
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    write_bitmap(out + ".pfm", img[..., :3])
    write_bitmap(out + ".png", img[..., :3])
    if img.shape[-1] == 15:  # [rgb, S0, S1, S2, S3]
        for i, name in enumerate(("S0", "S1", "S2", "S3")):
            write_bitmap(f"{out}_{name}.pfm", img[..., 3 + 3 * i:6 + 3 * i])
    per_pass = stats["spp_done"] // max(stats["passes_done"], 1)
    meta_out = {
        "scene": os.path.abspath(args.scene),
        "variant": args.variant,
        "integrator": integrator_cfg,
        "spp": spp,
        "resolution": list(scene.sensor.resolution),
        "device": str(scene.device),
        "load_time_s": round(t_load, 3),
        "render_time_s": round(t_render, 3),
        "time_per_sample": round(t_render / max(spp, 1) * 1e3, 3),  # ms/spp
        **stats,
        "time_per_sample_steady": (
            round(stats["steady_s_per_pass"] / max(per_pass, 1) * 1e3, 3)
            if stats.get("steady_s_per_pass") else None),
    }
    with open(out + "_params.json", "w") as f:
        json.dump(meta_out, f, indent=2)
    print(json.dumps(meta_out))


if __name__ == "__main__":
    main()
