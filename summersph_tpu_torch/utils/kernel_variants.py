#!/usr/bin/env python3
"""Time variants of `csrc/sph_pairs.cu`, made by text substitution, on the
full-size inputs of the pair kernels on one CUDA card: where a kernel's
time goes, and what a constant is worth.

    python3 summersph_tpu_torch/utils/kernel_variants.py [NAME:OLD=>NEW ...]

Run from the root of a checkout.  Built in are `base` (the source as it
is) and two variants that compute wrong sums on purpose and only tell what
a part costs: `no_arithmetic` (candidates are staged and tested, survivors
compacted, the pair arithmetic skipped) and `no_test` (candidates are
staged, nothing is tested: what staging, the empty compaction, the row
reductions, the stores and the launch cost).  Each further argument adds a
variant NAME in which the text OLD is replaced by NEW (OLD must occur), for
example  rows8:ROWS_DENSITY = 4;=>ROWS_DENSITY = 8;

All variants are compiled at once (one nvcc each) into the build directory,
their ptxas registers and shared memory are printed, and each is timed with
CUDA events (10 launches through the wrapper, so the pack is included)
twice, in the order base ... last, last ... base; printed is least /
largest mean per kernel.  Inputs, at N = 1,048,576: the Keplerian disc's
initial state (`density_fixed_h`, `force_fixed_h`; `force_fixed_h_grav`
at grid 256; `grav_short` on the gravity sort at grid 128) and config 5's
after its first h iteration (`density_var_h`, `force_var_h`), as
chip_smoke.py builds them.
"""

import ctypes
import os
import re
import subprocess
import sys

DIAGNOSTIC = {
    "no_arithmetic": [("t0 < n_sph;", "t0 < 0 * n_sph;"),
                      ("t < n_grav;", "t < 0 * n_grav;"),
                      ("t < n_in;", "t < 0 * n_in;")],
    "no_test": [("k0 < n_it;", "k0 < 0 * n_it;")],
}


def substitute(src, pairs):
    for old, new in pairs:
        if old not in src:
            sys.exit(f"kernel_variants: {old!r} does not occur in the source")
        src = src.replace(old, new)
    return src


def ptxas_summary(log):
    """{kernel<template arguments>: (registers, shared bytes, spill note)}"""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(grav_short|pack_force|force|density)_kernelI"
                      r"((?:Lb[01]E)+)E", line)
        if m:
            flags = m.group(2).replace("Lb", "").replace("E", "")
            cur = f"{m.group(1)}<{flags}>"
        m = re.search(r"Used (\d+) registers.*?(?:(\d+) bytes smem)?$", line)
        if m and cur:
            out[cur] = [int(m.group(1)), int(m.group(2) or 0),
                        out.get(cur, [0, 0, ""])[2]]
        if "spill stores" in line and cur and "0 bytes spill stores" not in line:
            out[cur] = [0, 0, line.strip()]
    return out


def main():
    sys.path.insert(0, os.getcwd())
    import torch
    import chip_smoke as cs
    from summersph_tpu_torch.ops import cuda_pairs, pm_gravity
    from summersph_tpu_torch.ops.smoothing import update_smoothing
    from summersph_tpu_torch.ops.sorted_grid import sort_particles
    from summersph_tpu_torch.utils import build

    if not torch.cuda.is_available():
        sys.exit("kernel_variants: needs a CUDA card")
    base = (build.CSRC_DIR / "sph_pairs.cu").read_text()
    variants = {"base": base}
    for name, pairs in DIAGNOSTIC.items():
        variants[name] = substitute(base, pairs)
    for arg in sys.argv[1:]:
        name, _, rule = arg.partition(":")
        variants[name] = substitute(base, [tuple(rule.split("=>", 1))])

    build.BUILD_DIR.mkdir(exist_ok=True)
    procs = {}
    for name, src in variants.items():
        cu = build.BUILD_DIR / f"variant_{name}.cu"
        cu.write_text(src)
        procs[name] = subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-o",
             str(cu.with_suffix(".so")), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            sys.exit(f"kernel_variants: nvcc refused {name}:\n{log[-3000:]}")
        print(f"{name}: " + ", ".join(
            f"{k} {r} regs {s} B{' ' + note if note else ''}"
            for k, (r, s, note) in sorted(ptxas_summary(log).items())
            if not k.startswith("pack")), flush=True)

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    dev, n = torch.device("cuda", 0), 1048576
    state, cfg = cs.disc(n, dev)
    p2, grid = sort_particles(state.particles, cfg)
    pd = cuda_pairs.pair_eval(p2, cfg, grid)[0]
    st128, cfg128 = cs.disc(n, dev, gravity="pm", grav_grid=128)
    r_s = pm_gravity.pm_geometry(st128.particles, cfg128)[2]
    gpos, gm, gh, ggrid, _, gsplit = pm_gravity.gravity_sort(
        st128.particles, cfg128, r_s)
    st256, cfg256 = cs.disc(n, dev, gravity="pm", grav_grid=256, pm_every=8)
    p2f, gridf = sort_particles(st256.particles, cfg256)
    pdf = cuda_pairs.pair_eval(p2f, cfg256, gridf)[0]
    r_sf = pm_gravity.pm_geometry(p2f, cfg256)[2]
    splitf = (r_sf, cfg256.effective_rcut_rs() * r_sf)
    state5, cfg5 = cs.config5(n, dev)
    p5, _ = update_smoothing(state5.particles, cfg5)
    p52, grid5 = sort_particles(p5, cfg5, h_pad=cfg5.sort_h_pad)
    pd5 = cuda_pairs.pair_eval(p52, cfg5, grid5)[0]
    calls = {
        "density_fixed_h": lambda: cuda_pairs.density_sums(p2, cfg, grid),
        "density_var_h": lambda: cuda_pairs.density_sums(p52, cfg5, grid5),
        "force_fixed_h": lambda: cuda_pairs.force_sums(pd, cfg, grid),
        "force_fixed_h_grav": lambda: cuda_pairs.force_sums(pdf, cfg256,
                                                            gridf, splitf),
        "force_var_h": lambda: cuda_pairs.force_sums(pd5, cfg5, grid5),
        "grav_short": lambda: cuda_pairs.grav_short_sums(gpos, gm, gh, ggrid,
                                                         cfg128, gsplit),
    }
    print("pack alone, ms: geometry "
          f"{cs.cuda_ms(lambda: cuda_pairs.pack_geometry(pd.pos, grid.key), 20):.4f}"
          ", pack_force fixed h "
          f"{cs.cuda_ms(lambda: cuda_pairs.pack_force(pd, grid.key, False), 20):.4f}"
          ", variable h "
          f"{cs.cuda_ms(lambda: cuda_pairs.pack_force(pd5, grid5.key, True), 20):.4f}",
          flush=True)

    times = {name: {k: [] for k in calls} for name in variants}
    for name in list(variants) + list(variants)[::-1]:
        lib = str(build.BUILD_DIR / f"variant_{name}.so")
        build.load = lambda _name, lib=lib: ctypes.CDLL(lib)
        cuda_pairs._library.cache_clear()
        for k, fn in calls.items():
            times[name][k].append(cs.cuda_ms(fn, 10))
    for name in variants:
        print(f"{name:14s}" + "  ".join(
            f"{k} {min(t):.3f}/{max(t):.3f}" for k, t in times[name].items()),
            flush=True)


if __name__ == "__main__":
    main()
