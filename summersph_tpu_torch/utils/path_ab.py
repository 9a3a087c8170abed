#!/usr/bin/env python3
"""Time the four full-size main paths and the ungated pair kernels of one
checkout of this repository on one CUDA card.

    python3 summersph_tpu_torch/utils/path_ab.py TREE TAG

TREE is the root of a checkout (its `chip_smoke.py` and its
`summersph_tpu_torch` are the ones imported, whatever checkout this file
lies in), TAG a word printed on every line.  To compare two commits, unpack
the older one (`git archive`) into a directory beside the newer and run
this script on one card of one machine in turns (old, new, new, old): the
disc paths are bound by the host, whose speed differs between machines, so
rates taken on two machines do not compare.

Per tree, at N = 1,048,576 and bench.py's / config5_run.py's configs as
chip_smoke.py builds them: prime, 20 warm-up and 20 timed steps of the disc
with gravity 'none', TreePM fused (grid 256, pm_every 8), TreePM separate
(grid 128, pm_every 1) and of config 5, each followed by CUDA-event times
(mean of 20 wrapper calls) of that path's pair kernels on its end state,
and the wrappers' fixed part: the gated forms with 4 window groups listed.
"""

import os
import sys


def main():
    tree, tag = os.path.abspath(sys.argv[1]), sys.argv[2]
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch
    import chip_smoke as cs
    from summersph_tpu_torch.ops import cuda_pairs, pm_gravity
    from summersph_tpu_torch.ops.sorted_grid import (group_worklist,
                                                     sort_particles)
    from summersph_tpu_torch.utils import build

    if not torch.cuda.is_available():
        sys.exit("path_ab: needs a CUDA card")
    build.build("sph_pairs")
    dev, n = torch.device("cuda", 0), 1048576

    def path(name, state, cfg):
        _, out, rate, step_s = cs.time_main_path(state, cfg)
        print(f"AB {tag} {name}: {rate:.6e} particle-steps/s "
              f"{step_s * 1e3:.3f} ms/step", flush=True)
        return out

    def kernels(**calls):
        print(f"AB {tag} kernels, ms: " + ", ".join(
            f"{name} {cs.cuda_ms(fn, 20):.4f}" for name, fn in calls.items()),
            flush=True)

    def few_groups(p2, cfg):
        act = torch.zeros(p2.capacity, dtype=torch.bool, device=dev)
        act[:4 * cfg.window_group] = True
        return group_worklist(act, cfg.window_group)

    state, cfg = cs.disc(n, dev)
    out = path("disc none", state, cfg)
    p2, grid = sort_particles(out.particles, cfg)
    pd = cuda_pairs.pair_eval(p2, cfg, grid)[0]
    gate = few_groups(p2, cfg)
    kernels(
        density_fixed_h=lambda: cuda_pairs.density_sums(p2, cfg, grid),
        force_fixed_h=lambda: cuda_pairs.force_sums(pd, cfg, grid),
        density_fixed_h_gated_4_groups=lambda: cuda_pairs.density_sums(
            p2, cfg, grid, gate),
        force_fixed_h_gated_4_groups=lambda: cuda_pairs.force_sums(
            pd, cfg, grid, None, gate))

    state, cfg = cs.disc(n, dev, gravity="pm", grav_grid=256, pm_every=8)
    out = path("disc pm fused", state, cfg)
    p2, grid = sort_particles(out.particles, cfg)
    pd = cuda_pairs.pair_eval(p2, cfg, grid)[0]
    r_s = pm_gravity.pm_geometry(p2, cfg)[2]
    split = (r_s, cfg.effective_rcut_rs() * r_s)
    kernels(force_fixed_h_grav=lambda: cuda_pairs.force_sums(pd, cfg, grid,
                                                             split))

    state, cfg = cs.disc(n, dev, gravity="pm", grav_grid=128, pm_every=1)
    out = path("disc pm separate", state, cfg)
    r_s = pm_gravity.pm_geometry(out.particles, cfg)[2]
    pos, m, h, ggrid, _, gsplit = pm_gravity.gravity_sort(out.particles, cfg,
                                                          r_s)
    ggate = few_groups(out.particles, cfg)
    kernels(
        grav_short=lambda: cuda_pairs.grav_short_sums(pos, m, h, ggrid, cfg,
                                                      gsplit),
        grav_short_gated_4_groups=lambda: cuda_pairs.grav_short_sums(
            pos, m, h, ggrid, cfg, gsplit, ggate))

    state, cfg = cs.config5(n, dev)
    out = path("config 5", state, cfg)
    p2, grid = sort_particles(out.particles, cfg, h_pad=cfg.sort_h_pad)
    pd = cuda_pairs.pair_eval(p2, cfg, grid)[0]
    gate = few_groups(p2, cfg)
    kernels(
        density_var_h=lambda: cuda_pairs.density_sums(p2, cfg, grid),
        force_var_h=lambda: cuda_pairs.force_sums(pd, cfg, grid),
        density_var_h_gated_4_groups=lambda: cuda_pairs.density_sums(
            p2, cfg, grid, gate),
        force_var_h_gated_4_groups=lambda: cuda_pairs.force_sums(
            pd, cfg, grid, None, gate))


if __name__ == "__main__":
    main()
