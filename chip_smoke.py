#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (summersph_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, in order; any failure raises and exits non-zero, and nothing is
caught:

1. print the card (nvidia-smi name and power limit) and the torch / CUDA
   versions;
2. build the CUDA pair kernels, the sink kernels and the PM mesh's
   gradient kernel from summersph_tpu_torch/csrc with nvcc (sph_pairs.cu,
   sinks.cu, pm_mesh.cu);
3. on the N = 131,072 Keplerian disc (bench.py's sweep geometry): hold the
   density and force kernels against their plain PyTorch versions, time
   both with CUDA events, and time the gravity='none' main path;
4. the gravity kernels at N = 131,072: the fused force kernel at the
   grid-256 configuration, the short-range gravity kernel at the grid-128
   configuration and on a clustered clump (tests/test_grav_overflow.py's
   recipe), each against its plain version (the gravity sums against the
   plain version in float64, `hold_exact`); and the rms force error of
   both TreePM routes against the exact direct sum;
5. the gravity='none' main path at full size: the N = 1,048,576 disc with
   bench.py's headline config -- prime, run_steps(20) to warm up,
   run_steps(20) timed -- with every launch counter reset just before,
   then checks (41 launches of each SPH kernel, of sink_gravity's pass
   and its reduce, 40 of accretion's pass and its reduce, no creation or
   merging kernel: `sink_expect`; all health counters zero,
   check_health, particles lost only to accretion, finite diagnostics), the
   span table of 5 steps (`span_table`: the program's spans reduced by
   `summersph_tpu_torch/span_table.py`), and each kernel against its
   plain version at these shapes;
6. the fused TreePM path at full size: N = 1,048,576, bench.py's first pm
   sweep cell (grav_grid 256, grav_fuse_short, pm_every 8): 41 fused
   force launches, 7 mesh solves, no short-range kernel launch, the same
   health checks, the span table of 5 steps with the busy share, and the
   fused kernel against its plain version;
7. the separate TreePM path at full size: grav_grid 128, pm_every 1: 41
   launches of the short-range kernel and 41 solves, the same checks, the
   span table, and the kernel against its plain version;
8. the variable-h kernels at N = 131,072 on config 5's collapse sphere
   (scripts/config5_run.py build(), h0 = 2.0) after one standalone
   h-iteration: density_var_h (rho_raw and Omega_raw) and force_var_h
   against their plain versions, force_var_h_grav at grid 256 with
   `hold_exact`;
9. the fused collapse path at N = 131,072 (config 5 with grid 256,
   grav_fuse_short, pm_every 8; 20 warm-up and 20 timed steps): 41
   force_var_h_grav and 121 density_var_h launches (1 + 3 per step: the
   force pass and the h-iteration's two re-sums), none of force_var_h,
   grav_short or the fixed-h kernels, and grav_window_overflow 0 on every
   step;
10. sink creation on the card at N = 131,072 on the separate route: after
   one step, `sink_create_density` is set below the densest particle's
   m (eta / h)^3; `create_sinks` seeds a sink with mass sink_create_mass
   and radius 2h at that particle, and 10 steps create at least one sink,
   with no full slots, no non-finite particle, gas lost equal to gas
   accreted and the total mass conserved to 1e-5;
11. the slice's path at full size: config 5 as built by
   scripts/config5_run.py (its port, `tools.config5.build`, which the other
   config 5 phases take too) at N = 1,048,576 (variable h, TreePM grid 128
   separate, pm_every 4, 128 sink slots, merging): prime, run_steps(20)
   warm-up, run_steps(20) timed; 121 density_var_h, 41 force_var_h, 41
   grav_short launches and 11 mesh solves, no fixed-h kernel; the sink
   kernels as in phase 5 and 40 launches each of creation's pass and
   pick and of merge_sinks (phases 6, 7 and 9 hold them too); the window,
   non-finite and sink-slot counters 0 (sph_clamped and h_unconverged are
   printed: the JAX package counts them too); check_health, mass
   conservation, particle-steps/s, peak memory, the span table with the
   busy share, and both variable-h kernels against their plain versions at these
   shapes;
12. the seven gated kernels (block timesteps) at N = 131,072, on the
   states of phases 3, 4 and 8 with the rows of the lowest quarter in x
   active: each against its gated plain version (cancelling sums in
   float64), equal to its ungated kernel bit for bit on the listed groups'
   rows and 0 on the rest, and with a full worklist bit for bit
   everywhere; each timed ungated, at the full and at the partial
   worklist;
13. block timesteps at full size on the disc: N = 1,048,576, gravity
   'none', dt_bins = 4, prime + run_steps with the base dt at
   min(8 x the tightest candidate, dt_max): the rung occupancy (at least
   two rungs populated), the active share of rows and groups per substep,
   8 launches of density_fixed_h_gated and of force_fixed_h_gated per base
   step and none of any ungated kernel, the health checks, the host waits
   the profiler counts in a base step beside a global step's, the span
   table of one base step (its `substep` spans) with the busy share, and
   the A/B:
   the global engine (dt_bins = 1) and the binned engine from the same
   primed state over the same simulated time, wall seconds per unit of
   simulated time and mass, momentum, e_kin and rho_max of both legs
   (printed; only conservation and the health counters are required);
14. the fused forms with block timesteps at N = 131,072, dt_bins = 3: the
   disc at grid 256 (force_fixed_h_grav_gated) and the collapse at grid
   256 (force_var_h_grav_gated, density_var_h_gated), a few base steps
   each, no ungated launch, no short-range launch, one mesh solve per
   run_steps call;
15. config 5 with block timesteps at N = 1,048,576, dt_bins = 3 (separate
   TreePM, pm_every 4): 3 density_var_h_gated, 1 force_var_h_gated and 1
   grav_short_gated launch per substep, one mesh solve per run_steps call,
   the collapse checks, the span table with the busy share and the A/B;
16. window shapes built to break a queue or a tile loop
   (summersph_tpu_torch/models/ragged.py: empty ranges, ranges of 1, 31,
   32, 33 and 129 candidates, groups of more than one chunk of
   candidates, a group that ends in dead rows, rows with no pair, a group
   whose every candidate is a pair, a small clump, an h gradient whose
   pairs reach only from j) and a 16,384-particle clump with variable h:
   the density kernels (fixed h, variable h: rho_raw within RHO_RTOL of
   the plain version, Omega_raw against it in float64) with their gated
   forms equal to them bit for bit at a partial and at a full worklist,
   the force kernels (fixed h, variable h, fused) and the gravity kernel
   against the plain version in float64 (`hold_exact`), two launches of
   each compared bit for bit, the fused form's SPH sums equal to the
   unfused kernel's, and the `pack_force` kernel equal to its plain
   version bit for bit; the clump also with fixed h, for the density
   kernels only;
17. the reference user's workflow through the CLI at full size
   (`summersph_tpu_torch.cli.main` in this process, in a temporary
   directory): `make-ics disc --n 1048576 --seed 0`; `run` with bench.py's
   headline physics (--fixed-h h0, --gamma 1.4, --bounding-size 1500, dt
   and window knobs through --set), the default neighbor_mode ('grid', run
   on the sorted engine), 4 saves, to the t that phase 5 reached in
   2 x STEPS steps: density_fixed_h and force_fixed_h launched once a step
   plus once for prime and no other pair kernel, every health counter zero
   on every segment, 4 saveN.txt files of the live gas and sink rows, the
   checkpoint's live gas equal to the last snapshot's columns at float32;
   `resume` with --gravity pm --set grav_grid=128 for 2 more ticks:
   grav_short and the mesh solve once a step plus once for prime, the
   resumed config the saved one with only the flags given changed, t
   risen, check_health; the z-projected density image of the last snapshot
   on the card at 40^3 (64 columns within rtol 1e-4 of a float64 numpy
   sum, the array saved with np.save and read back); the Sod tube
   (n = 400) with `simulate` to t = 0.1, its L2 density error below 0.03.
   It prints the seconds of every file read and write, the steps,
   particle-steps/s with the file I/O taken out, and the seconds of the
   image;
19. multi-device runs in gather mode and the dense engine (run before
   the results of phase 18):
   a. the row slabs at full size: on the end states of phases 5 (the
      disc) and 11 (config 5) and on the gravity sort of phase 7's, each
      of density_fixed_h, density_var_h, force_fixed_h, force_var_h and
      grav_short in its row-slab form (`_rows`) as 4 slabs of 262,144
      rows: laid end to end equal to the whole launch bit for bit, held
      against the plain version's slabs (cancelling sums in float64), the
      4 slabs' summed time beside the whole launch's;
   b. gather mode on the card at D = 1 over NCCL (a process group from a
      HashStore, `make_mesh`, `shard_state`, `make_sharded_prime`,
      `make_sharded_run_steps`, `gather_state`; destroyed after): the
      disc with fixed h (4 + 4 steps: 9 launches of density_fixed_h_rows
      and force_fixed_h_rows) and config 5 (20 + 20 steps: 121
      density_var_h_rows, 41 force_var_h_rows and 41 grav_short_rows
      launches, 11 mesh solves), no whole-set launch of any pair kernel,
      the health checks of phases 5 and 11, the sink layers through
      their kernels (each one-block kernel launched twice a pass, for
      the rank's sums and after their sum over the ranks), and each run
      held per pid
      against the single-device run from the same state at
      tests/test_sharding.py's tolerances (printed: whether bit for bit),
      with both runs' ms per step;
   c. the dense O(N^2) oracle at N = 16,384: the sorted density and force
      kernels against `compute_density` / `compute_sph_forces` on the
      disc (fixed h) and on config 5's sphere after one h-iteration
      (variable h; Omega and the forces against the dense pass in
      float64), then one `neighbor_mode='dense'` step of the disc against
      the sorted step, per pid; the dense passes' times;
20. the slab decomposition (run after phase 19, before the results of
   phase 18):
   a. at D = 1 over NCCL at N = 1,048,576 (a process group from a
      HashStore, destroyed after): the disc (fixed h, gravity none) and
      config 5 with pm_every 1 (the JAX package refuses a held far field
      under slab) and cell_h_quantile 1 (at its 0.9 the slab's histogram
      quantile and the one-device sort's exact one give other cells),
      each with decomp='slab' through make_sharded_prime and
      make_sharded_run_steps (prime + SLAB_HOLD + SLAB_TIMED steps): the
      launches by form (the key_rows form of the four `_rows` SPH
      entry points, `grav_short` whole on the local set, the mesh solves
      all through the pencil solve), no other pair launch, the sink
      kernels as in 19b; the health checks of phases 5 and 11,
      decomp_pressure and nonfinite 0; the
      state after prime + SLAB_HOLD steps held per pid against the one
      device run at tests/test_decomp.py's tolerances; ms a step beside
      one device and gather mode on the same state, the collectives'
      result bytes a step, the peak device memory;
   b. the key_rows kernels with real rims: the sorted end states of
      phases 5 and 11 cut into 4 slabs in this process, no collective
      (`parallel.decomp.slabs_in_process`), each with [left rim | own |
      right rim] columns, the rim the smallest power of two from 8,192
      rows up that leaves no row short (printed); every slab's key_rows
      launch of the four instantiations held against its plain version
      in float64 (`hold_exact`) and, per row, against the whole-set
      launch; their summed time beside the plain version's;
21. the bench entry point at full size (run after phase 20, before the
   results of phase 18): `summersph_tpu_torch.bench.main([])` in this
   process with every BENCH_* knob at its default and BENCH_BUDGET_S wide
   enough for every cell: the headline (N = 1,048,576, gravity 'none')
   and bench.py's four sweep cells (TreePM grid 256 fused with pm_every
   8, 4 and 1; N = 131,072 without gravity), each prime + 20 warm-up + 20
   timed steps.  Every line it prints parses with bench.py's keys, the
   first with an empty sweep, platform 'gpu' and a finite positive value,
   the last with all four cells finite and positive; the launches of the
   whole run are 205 density_fixed_h, 82 force_fixed_h, 123
   force_fixed_h_grav, 205 pack_force and 59 mesh solves (7 + 11 + 41)
   and nothing else; the headline lies within 0.5-2x phase 5's rate.  It
   prints the five rates beside the card's name and power limit, then
   runs `python -m summersph_tpu_torch bench --steps 2` with
   BENCH_SWEEP=0 in a subprocess: exit code 0 and one line;
22. reproducible TreePM runs and config 5 in segments (run after phase 21,
   before the results of phase 18):
   a. phase 7's separate path (grid 128, pm_every 1) and phase 6's fused
      path (grid 256, pm_every 8) at N = 1,048,576, each primed once and
      run REPRO_STEPS steps twice from copies of that state: the end
      states equal bit for bit in every field; on each end state the CIC
      deposit (integer fixed point) twice, equal bit for bit, its time
      beside the float `index_add_` form (kept here only as its
      yardstick), both against the float64 sum of the same corner values,
      and whether two float `index_add_`s are equal (printed);
   b. `summersph_tpu_torch.tools.config5.run` at N = 1,048,576 in a
      temporary directory, 16 steps a segment: 3 segments uninterrupted,
      and 2 segments, the checkpoint, then 1 resumed segment; the two end
      checkpoints equal bit for bit in every field, both 15-column ledgers
      equal but for the wall column, the ms a step, and the launches of
      the three runs (counts reset just before and read just after: 290
      density_var_h, 98 force_var_h, 98 grav_short, 98 pack_force, 26
      mesh solves, nothing else);
23. the graded configurations 1-4 through the port's evidence tools (run
   after phase 22, before the results of phase 18):
   a. `summersph_tpu_torch.tools.evidence` in a temporary directory for
      ring (N = 4,000), disc100 (12,000) and varh (20,000), 2 segments of
      64 steps each: exit code 0, check_health after every segment, the
      launches of each run (ring: density_fixed_h, force_fixed_h and
      pack_force 129 each, nothing else; disc100: the same and 129
      grav_short and 129 mesh solves; varh: 385 density_var_h, 129 each of
      force_var_h, pack_force, grav_short and mesh solves), both ledger
      rows' n_gas equal to the JAX ledger's first two and E_kin, E_int,
      Lz within 1e-3 of it at matching t; the ms a step beside the card,
      the SPH candidates tested per row, and the span table of 5 more
      steps;
   b. `summersph_tpu_torch.tools.sod_evidence.run_case` at n = 400 on
      'grid' and on 'sorted': the L2 within 5e-4 of 0.01383, all 400
      alive, only density_fixed_h, force_fixed_h and pack_force
      launched, as often each; the span table of 5 steps;
24. the sink layers at N = 1,048,576 (run after phase 23, before the
   results of phase 18): on config 5's ICs, once with its own slots (128,
   one live: the massless dummy) and once with all 128 live and massive,
   at 128 live rows spread through the cloud (radius 2 h, the creation
   threshold at the 0.999 quantile of m (eta / h)^3): each of
   `sink_gravity`, `create_sinks`, `accrete` and `merge_sinks` against
   its plain version (every mask, index, slot and copied field exactly,
   the sums in float64 by `hold_exact`), launched twice bit for bit; the
   layer's kernel ms against its plain ms (CUDA events, the layer and
   each call) and its launches a call of each; the kernels' own device
   ms from the profiler, beside their bounds (`sink_bound_ms`: the pairs
   each kernel evaluates on these slots and rows); the layer with 128
   live slots under SINK_LIVE_MS a step;
25. the PM mesh's gradient (run after phase 24): `fd4_gradient` on the
   potential that one `pm_long_range` solve hands it (`gradient_input`:
   config 5's ICs at grid 128, the self-gravitating disc's at grid 256,
   each the 2n-padded cube of the fd path), equal bit for bit to its
   plain version and to `roll_form` (the test module's), the 12-roll form
   of the whole padded cube that it replaced; kernel,
   plain and roll ms (CUDA events, mean of FD4_REPS calls) beside the
   byte bound (`fd4_bound_ms`) and the kernel's ptxas registers and
   shared memory.  Wherever `launch_counts` reads the counters, one
   `fd4_gradient` launch a mesh solve is required;
18. print the kernels' JSON line (with each kernel's bound: the larger of
   its input and output bytes over 3.35 TB/s and its FP32 operations on
   the pairs this run's data needs over 67 TFLOP/s; for a gated kernel
   the rows and pairs of the listed groups only; for a row-slab form on
   all the rows of its path, its whole form's on the same state; for a
   key_rows form its whole form's pairs and the bytes of its rows and of
   its rim-extended columns; its launches from phases 19b and 20a, its
   times from 19a and 20b; each sink kernel twice, with config 5's slots
   and, its name ending in SINK_LIVE, with 128 live, its times and
   bounds from phase 24, its launches from phase 11; `fd4_gradient` at
   grid 128 and 256 from phase 25, the roll form's ms as `library_ms`,
   its launches from phase 11 (grid 128) and phase 6 (grid 256))
   and, last, {"ok": true, "device": ...}.

For the pair kernels, which test every candidate of a row's windows and
run the pair arithmetic on the survivors only, the kernel checks print the
candidates tested per row and the share that survives the test; every
check of a density and force kernel pair (`sph_kernels`, phases 3, 5, 8,
11, 12, 13 and 15) also launches both twice on one state and requires
equal bits, and where it is ungated the gated density at a full worklist,
equal to the ungated one bit for bit; phases 7, 11 and 15 launch
`grav_short` twice too.

It exits non-zero, printing no result, when torch.cuda.is_available() is
false.  No JAX is imported.
"""

import contextlib
import json
import subprocess
import sys
import time

STEPS = 20
RHO_RTOL = 2e-5          # density vs plain version
FORCE_RTOL = 2e-4        # acc, du, dalpha and gravity sums vs plain version
FORCE_ATOL_REL = 1e-5    # atol = this x max|component|: another sum order
PEAK_FP32 = 67e12        # H100 SXM FP32 outside the tensor cores, FLOP/s
PEAK_BYTES = 3.35e12     # H100 SXM HBM3, bytes/s
# FP32 operations per pair inside the support, counted from
# csrc/sph_pairs.cu (add, multiply, compare, rsqrt, exp and divide once,
# a fused multiply-add twice); the gravity sums in the fused kernel reuse
# the pair geometry (11 operations) of the force sums.  The variable-h
# density adds dw_shape and the dW/dh sum (11); the variable-h force adds
# the j-side skip, dW_j (7), dWbar, hbar, av_eps hbar^2 and the two-term
# pressure factor (16).
OPS_DENSITY, OPS_FORCE, OPS_GRAV, OPS_GEOMETRY = 20, 64, 55, 11
OPS_DENSITY_VAR, OPS_FORCE_VAR = 31, 80
KEY_ROWS = " (key_rows)"   # the name suffix of a key_rows form
KERNELS = {
    # name: (TPU kernel it replaces, bytes per row read and written)
    "density_fixed_h": ("summersph_tpu/ops/pallas_pairs.py:365", 24 + 4),
    "force_fixed_h": ("summersph_tpu/ops/pallas_pairs.py:604", 56 + 20),
    "force_fixed_h_grav": ("summersph_tpu/ops/pallas_pairs.py:657",
                           56 + 32),
    "grav_short": ("summersph_tpu/ops/pallas_pairs.py:880", 24 + 12),
    "density_var_h": ("summersph_tpu/ops/pallas_pairs.py:457", 24 + 8),
    "force_var_h": ("summersph_tpu/ops/pallas_pairs.py:699", 56 + 20),
    "force_var_h_grav": ("summersph_tpu/ops/pallas_pairs.py:699", 56 + 32),
}
# the gated forms (pallas_pairs.py _gate_plan :328 and the kernels' gated=)
# move the same bytes per listed row
KERNELS.update({
    name + "_gated": (f"summersph_tpu/ops/pallas_pairs.py:{line}",
                      KERNELS[name][1])
    for name, line in (("density_fixed_h", 366), ("force_fixed_h", 606),
                       ("force_fixed_h_grav", 606), ("grav_short", 881),
                       ("density_var_h", 366), ("force_var_h", 606),
                       ("force_var_h_grav", 606))})
# the row-slab forms (gather mode, `_row_slices` with rows=(p_rows, offset)
# :533-542, and the sharded gravity split, pm_gravity.py:678-685) move the
# same bytes per row
KERNELS.update({
    name + "_rows": (replaces, KERNELS[name][1])
    for name, replaces in (
        ("density_fixed_h", "summersph_tpu/ops/pallas_pairs.py:533"),
        ("density_var_h", "summersph_tpu/ops/pallas_pairs.py:533"),
        ("force_fixed_h", "summersph_tpu/ops/pallas_pairs.py:533"),
        ("force_var_h", "summersph_tpu/ops/pallas_pairs.py:533"),
        ("grav_short", "summersph_tpu/ops/pm_gravity.py:678"))})
# the key_rows forms (the slab decomposition, `_row_slices` with
# rows=(p_rows, key_rows) :530-532): the same entry points on a row set
# apart from the columns, counted apart; bytes per own row as above, and
# per column (rims included) its records: geo and m, or geo and attr
KERNELS.update({
    name + KEY_ROWS: ("summersph_tpu/ops/pallas_pairs.py:530",
                      KERNELS[name][1])
    for name in ("density_fixed_h_rows", "density_var_h_rows",
                 "force_fixed_h_rows", "force_var_h_rows")})
COLUMN_BYTES = {"density_fixed_h_rows": 20, "density_var_h_rows": 20,
                "force_fixed_h_rows": 16 + 32, "force_var_h_rows": 16 + 64}
# the force kernels' per-particle records (the TPU pack `_pack`), formed by
# one kernel before every force launch; bytes with variable h
KERNELS["pack_force"] = ("summersph_tpu/ops/pallas_pairs.py:94", 57 + 84)
BINS_DISC, BINS_COLLAPSE = 4, 3     # dt_bins of the block-timestep paths


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def kernel_name(wrapper, attr):
    """The CUDA entry point a launch count of `cuda_pairs` belongs to, with
    KEY_ROWS appended for a key_rows launch of a `_rows` entry point."""
    form = ("_gated" if "gated_" in attr else "") + (
        "_rows" if "rows_" in attr else "") + (
        KEY_ROWS if "key_rows_" in attr else "")
    if wrapper.__name__ == "grav_short_sums":
        return "grav_short" + form
    base = "density" if wrapper.__name__ == "density_sums" else "force"
    return (base + ("_var_h" if attr.startswith("var_") else "_fixed_h")
            + ("_grav" if "fused_" in attr else "") + form)


# the sink kernels, in the order of ops.cuda_sinks.launch_counters()
SINK_KERNELS = ("sink_gravity_pass", "sink_gravity_reduce",
                "create_sinks_pass", "create_sinks_pick", "accrete_pass",
                "accrete_reduce", "merge_sinks")


def sink_launches():
    from summersph_tpu_torch.ops import cuda_sinks

    return {name: getattr(f, a) for name, (f, a)
            in zip(SINK_KERNELS, cuda_sinks.launch_counters())}


def launch_counts():
    """The launches of every pair kernel and sink kernel, the force packs,
    the mesh solves and the mesh gradient since the last `reset_counts`."""
    from summersph_tpu_torch.ops import cuda_pairs, pm_gravity

    counts = {kernel_name(w, a): getattr(w, a)
              for w, a in cuda_pairs.launch_counters()}
    counts["pack_force"] = cuda_pairs.pack_force.launches
    counts["mesh solves"] = pm_gravity.pm_long_range.solves
    counts["pencil solves"] = pm_gravity.pm_long_range.pencil_solves
    counts.update(sink_launches())
    counts["fd4_gradient"] = pm_gravity.fd4_gradient_cuda.launches
    require(counts["fd4_gradient"] == counts["mesh solves"],
            f"{counts['fd4_gradient']} fd4_gradient launches for "
            f"{counts['mesh solves']} mesh solves: every solve launches the "
            f"gradient kernel once")
    return counts


def nonzero(counts):
    return {name: k for name, k in counts.items() if k}


def pair_launches(counts):
    """`counts` without the sink kernels and the mesh gradient (one launch
    a solve, which `launch_counts` requires), for the checks of a path's
    pair kernels, packs and solves alone."""
    return {name: k for name, k in counts.items()
            if name not in SINK_KERNELS and name != "fd4_gradient"}


def sink_expect(cfg, steps):
    """The sink kernels' launches of prime + `steps` single-device steps
    that each evaluate the forces once: sink_gravity's pass and its one
    reduce once a force pass, accretion's pass and reduce once a step,
    creation's pass and pick once a step with variable h, merging once a
    step where cfg.sink_merge_factor > 0."""
    var = cfg.fixed_h is None
    merge = cfg.sink_merge_factor > 0.0
    return {"sink_gravity_pass": 1 + steps, "sink_gravity_reduce": 1 + steps,
            "create_sinks_pass": steps if var else 0,
            "create_sinks_pick": steps if var else 0,
            "accrete_pass": steps, "accrete_reduce": steps,
            "merge_sinks": steps if merge else 0}


def require_sinks_on_a_mesh(label, var):
    """The sink layers of a mesh path went through their kernels: each
    pass once a call, each one-block kernel twice (the rank's sums, then
    the finish on their sum over the ranks), sink_gravity once more than
    accrete (prime's force pass); with variable h creation and merging as
    often as accretion."""
    got = sink_launches()
    calls = got["accrete_pass"]
    want = {"sink_gravity_pass": calls + 1,
            "sink_gravity_reduce": 2 * (calls + 1), "accrete_pass": calls,
            "accrete_reduce": 2 * calls,
            "create_sinks_pass": calls if var else 0,
            "create_sinks_pick": 2 * calls if var else 0,
            "merge_sinks": calls if var else 0}
    require(calls > 0 and got == want,
            f"{label}: sink launches {got}, expected {want}")
    print(f"[{label}] sink kernel launches {nonzero(got)}", flush=True)


def reset_counts():
    from summersph_tpu_torch.ops import cuda_pairs, cuda_sinks, pm_gravity

    for wrapper, attr in cuda_pairs.launch_counters():
        setattr(wrapper, attr, 0)
    for wrapper, attr in cuda_sinks.launch_counters():
        setattr(wrapper, attr, 0)
    cuda_pairs.pack_force.launches = 0
    pm_gravity.pm_long_range.solves = 0
    pm_gravity.pm_long_range.pencil_solves = 0
    pm_gravity.fd4_gradient_cuda.launches = 0


def disc(n, device, **kw):
    """bench.py's disc and config (`summersph_tpu_torch.bench`): `kw` are
    bench_config's gravity, grav_grid and pm_every."""
    from summersph_tpu_torch.bench import bench_config, bench_disc

    cfg, h0 = bench_config(n, **kw)
    return bench_disc(n, cfg, h0, device), cfg


def config5(n, device, **over):
    """`summersph_tpu_torch.tools.config5.build` (scripts/config5_run.py's
    build() at N = n, h0 = (2^20 / n)^(1/3)), with `over` replacing config
    knobs that the ICs do not read; the TPU-only window knobs are accepted
    and have no effect.  Returns (state, cfg)."""
    from summersph_tpu_torch.tools.config5 import build

    state, cfg = build(n, device=device)
    return state, cfg.with_(**over)


def clustered(n, device):
    """tests/test_grav_overflow.py's clump recipe (seeded numpy): 3/4 of
    the particles in a Gaussian of 1.2 AU, the rest uniform in 100 AU."""
    import numpy as np
    from summersph_tpu_torch.state import Particles

    rng = np.random.default_rng(3)
    pos = rng.uniform(-50, 50, (n, 3)).astype(np.float32)
    pos[: 3 * n // 4] = rng.normal(0, 1.2, (3 * n // 4, 3))
    return Particles.create(pos=pos, vel=np.zeros((n, 3)),
                            mass=np.full(n, 1e-3), u=np.ones(n), h=0.5,
                            device=device)


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over `reps` calls after one warm-up call,
    from CUDA events."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def hold(name, kernel_out, plain_out, label, rtol=FORCE_RTOL,
         atol_rel=FORCE_ATOL_REL):
    """Each output of a kernel against its plain version; returns the
    largest |kernel - plain|."""
    import torch

    torch.cuda.synchronize()
    err = 0.0
    for c, (a, b) in enumerate(zip(kernel_out, plain_out)):
        require(bool(torch.isfinite(a).all()),
                f"{name} output {c} not finite ({label})")
        tol = dict(rtol=rtol, atol=atol_rel * float(b.abs().max()))
        torch.testing.assert_close(a, b, **tol,
                                   msg=f"{name} output {c} ({label})")
        e = float((a - b).abs().max())
        err = max(err, e)
        print(f"[{label}] {name} output {c}: max |kernel - plain| {e:.3e} "
              f"within rtol {tol['rtol']:g} atol {tol['atol']:.3e}",
              flush=True)
    return err


def hold_exact(name, kernel_out, plain_out, exact_out, label, first=0):
    """Sums whose terms nearly cancel (the gravity sums' f(r/h) - S(r);
    with variable h Omega_raw, a dW/dh sum of both signs, and the force
    sums of a rotating cloud, whose du and alpha_raw vanish with div v)
    lose digits in float32 in the kernel and its plain version alike.
    Each is held against the plain version on the same inputs in float64:
    within
    rtol 2e-4 and atol = 1e-5 x max|component| + twice the float32 plain
    version's own largest error.  Returns the largest |kernel - plain|."""
    import torch

    torch.cuda.synchronize()
    err = 0.0
    for c, (a, b, r) in enumerate(zip(kernel_out, plain_out, exact_out),
                                  start=first):
        require(bool(torch.isfinite(a).all()),
                f"{name} output {c} not finite ({label})")
        floor = float((b.double() - r).abs().max())
        tol = dict(rtol=FORCE_RTOL,
                   atol=FORCE_ATOL_REL * float(r.abs().max()) + 2 * floor)
        torch.testing.assert_close(a.double(), r, **tol,
                                   msg=f"{name} output {c} ({label})")
        e = float((a - b).abs().max())
        err = max(err, e)
        e64 = float((a.double() - r).abs().max())
        print(f"[{label}] {name} output {c}: max |kernel - plain| {e:.3e}; "
              f"against float64: kernel {e64:.3e}, plain {floor:.3e}, "
              f"within rtol {tol['rtol']:g} atol {tol['atol']:.3e}",
              flush=True)
    return err


def f64(p):
    """Particles with every float field in float64."""
    return p.map(lambda a: a.double() if a.is_floating_point() else a)


def compare(name, kernel, plain, label, plain_reps=2, exact=None, **tol):
    """Hold `kernel()` against `plain()`, then time both; returns
    (max_abs_err, kernel ms, plain ms).  With `exact` (the plain version
    in float64), the last outputs, as many as `exact()` gives, are sums
    that cancel and are held by `hold_exact`."""
    k, p = flat(kernel()), flat(plain())
    q = flat(exact()) if exact is not None else []
    n_sph = len(k) - len(q)
    err = hold(name, k[:n_sph], p[:n_sph], label, **tol)
    if q:
        err = max(err, hold_exact(name, k[n_sph:], p[n_sph:], q, label,
                                  first=n_sph))
    ms = cuda_ms(kernel, 10)
    plain_ms = cuda_ms(plain, plain_reps)
    print(f"[{label}] {name}: max_abs_err={err:.3e} kernel {ms:.4f} ms "
          f"plain {plain_ms:.4f} ms", flush=True)
    return err, ms, plain_ms


def count_pairs(pos, grid, wg, radius2, h=None, both=False, active=None):
    """Pairs of distinct particles inside each row's windows and key mask
    with r^2 < radius2: the pairs whose arithmetic the sums need.  With
    per-particle `h`, radius2 is a factor: r^2 < radius2 h_i^2, or with
    `both` r^2 < radius2 max(h_i, h_j)^2 (the variable-h force pairs).
    With `active` = (worklist, count) the rows of the listed groups only."""
    import torch
    from summersph_tpu_torch.ops import cuda_pairs

    total = torch.zeros((), dtype=torch.int64, device=pos.device)
    for rows, idx, valid, off in cuda_pairs._candidate_chunks(grid, wg,
                                                              active):
        mask, _, _, _, r2 = cuda_pairs._pair_geometry(pos, grid, rows, idx,
                                                      valid, off)
        reach2 = radius2
        if h is not None:
            hh = h[rows][:, :, None]
            if both:
                hh = torch.maximum(hh, h[idx][:, None, :])
            reach2 = radius2 * hh * hh
        total += torch.sum(mask & (r2 > 0.0) & (r2 < reach2))
    return int(total)


def bound(name, n_rows, groups, ops, active=None):
    """(bound_ms, bound_by): the larger of the bytes the kernel must move
    over the card's memory rate and its FP32 operations over the FP32
    peak.  With `active` = (worklist, count) the rows and windows of the
    listed groups, and the worklist itself."""
    extra = 0
    if active is not None:
        wg = n_rows // groups
        extra = 4 * groups + 4
        groups = int(active[1])
        n_rows = groups * wg
    t_bytes = (KERNELS[name][1] * n_rows + 72 * groups + extra) / PEAK_BYTES
    t_ops = ops / PEAK_FP32
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations")


def bound_key_rows(name, n_rows, n_cols, groups, ops):
    """bound() of a key_rows launch: the rows' bytes as the whole form's,
    each column's records (rims included) read once, the windows, and the
    FP32 operations."""
    base = name[:-len(KEY_ROWS)]
    t_bytes = (KERNELS[name][1] * n_rows + COLUMN_BYTES[base] * n_cols
               + 72 * groups) / PEAK_BYTES
    t_ops = ops / PEAK_FP32
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations")


def tested_share(name, grid, wg, survivors, label, active=None):
    """Print what a kernel that tests every candidate and runs the pair
    arithmetic on the survivors had to do: the candidates each row tests
    (all of its group's 9 ranges) and the share of them that survives."""
    ext = (grid.ends - grid.starts).sum(dim=1)
    if active is not None:
        ext = ext[active[0][:int(active[1])].long()]
    tested = int(ext.sum()) * wg
    print(f"[{label}] {name}: candidates tested per row "
          f"{tested / max(ext.shape[0] * wg, 1):.1f}, of which "
          f"{survivors / max(tested, 1):.4f} survive the test "
          f"({survivors} of {tested})", flush=True)


def twice_bitwise(name, call, label):
    """Two launches of one kernel on one state must give the same bits."""
    import torch

    first, second = flat(call()), flat(call())
    torch.cuda.synchronize()
    for c, (a, b) in enumerate(zip(first, second)):
        require(torch.equal(a, b),
                f"{name} output {c}: two launches differ ({label})")
    print(f"[{label}] {name}: two launches on one state equal bit for bit",
          flush=True)


_PAIR_COUNTS = {}   # (id(p.pos), id(grid.key)) -> (pos, key, counts)


def sph_pair_counts(p, grid, cfg, active=None):
    """(density pairs, force pairs) the sums need: inside 2h with fixed
    h; inside 2 h_i and inside 2 max(h_i, h_j) with variable h.  With
    `active` those of the listed groups' rows.  The ungated counts are
    kept with the arrays they were counted on, for the script's life
    (phase 20b needs those of the states of phases 5 and 11 again)."""
    wg = cfg.window_group
    key = (id(p.pos), id(grid.key))
    if active is None and key in _PAIR_COUNTS:
        return _PAIR_COUNTS[key][2]
    if cfg.fixed_h is not None:
        n = count_pairs(p.pos, grid, wg, 4.0 * cfg.fixed_h ** 2,
                        active=active)
        counts = (n, n)
    else:
        counts = (count_pairs(p.pos, grid, wg, 4.0, h=p.h, active=active),
                  count_pairs(p.pos, grid, wg, 4.0, h=p.h, both=True,
                              active=active))
    if active is None:   # the arrays kept, so that no other takes the ids
        _PAIR_COUNTS[key] = (p.pos, grid.key, counts)
    return counts


def density_bitwise(name, p_sorted, grid, cfg, label, active=None):
    """Two launches of a density kernel on one state give the same bits;
    ungated, its gated form at a full worklist gives them too."""
    import torch
    from summersph_tpu_torch.ops import cuda_pairs
    from summersph_tpu_torch.ops.sorted_grid import group_worklist

    call = lambda a=active: cuda_pairs.density_sums(p_sorted, cfg, grid, a)
    twice_bitwise(name, call, label)
    if active is None:
        full = group_worklist(torch.ones_like(p_sorted.alive),
                              cfg.window_group)
        for c, (a, b) in enumerate(zip(call(), call(full))):
            require(torch.equal(a, b), f"{name}_gated output {c}: full "
                    f"worklist differs from ungated ({label})")
        print(f"[{label}] {name}_gated at a full worklist: equal to "
              f"{name} bit for bit", flush=True)


def sph_kernels(p_sorted, grid, cfg, label, active=None):
    """The density and force kernels (fixed-h or variable-h by cfg) against
    their plain versions on one sorted state; returns {name: (err, ms,
    plain_ms, bound_ms, by)}.  With variable h, Omega_raw and the force
    sums are held in float64 (`hold_exact`).  With `active` = (worklist,
    count) the gated kernels against the gated plain versions, the bound
    counting the listed groups only."""
    from summersph_tpu_torch.ops import cuda_pairs

    var = cfg.fixed_h is None
    gated = "_gated" if active is not None else ""
    dname, fname = (("density_var_h" + gated, "force_var_h" + gated) if var
                    else ("density_fixed_h" + gated,
                          "force_fixed_h" + gated))
    p_dens = cuda_pairs.pair_eval(p_sorted, cfg, grid)[0]
    if var:
        p64, pd64 = f64(p_sorted), f64(p_dens)
        dens = compare(
            dname,
            lambda: cuda_pairs.density_sums(p_sorted, cfg, grid, active),
            lambda: cuda_pairs.density_sums_plain(p_sorted, cfg, grid,
                                                  active),
            label, rtol=RHO_RTOL, atol_rel=0.0,
            exact=lambda: cuda_pairs.density_sums_plain(p64, cfg, grid,
                                                        active)[1])
        force = compare(
            fname,
            lambda: cuda_pairs.force_sums(p_dens, cfg, grid, None, active),
            lambda: cuda_pairs.force_sums_plain(p_dens, cfg, grid, None,
                                                active), label,
            exact=lambda: cuda_pairs.force_sums_plain(pd64, cfg, grid, None,
                                                      active))
    else:
        dens = compare(
            dname,
            lambda: cuda_pairs.density_sums(p_sorted, cfg, grid, active)[0],
            lambda: cuda_pairs.density_sums_plain(p_sorted, cfg, grid,
                                                  active)[0],
            label, rtol=RHO_RTOL, atol_rel=0.0)
        force = compare(
            fname,
            lambda: cuda_pairs.force_sums(p_dens, cfg, grid, None, active),
            lambda: cuda_pairs.force_sums_plain(p_dens, cfg, grid, None,
                                                active), label)
    out = {dname: dens, fname: force}
    n_dens, n_force = sph_pair_counts(p_sorted, grid, cfg, active)
    rows, groups = p_sorted.capacity, grid.starts.shape[0]
    n_rows = rows if active is None else int(active[1]) * cfg.window_group
    if var:
        print(f"[{label}] pairs inside 2h_i: {n_dens} "
              f"({n_dens / max(n_rows, 1):.1f} per row of {n_rows}); inside "
              f"2 max(h_i, h_j): {n_force} "
              f"({n_force / max(n_rows, 1):.1f} per row)", flush=True)
    else:
        print(f"[{label}] pairs inside 2h: {n_dens} "
              f"({n_dens / max(n_rows, 1):.1f} per row of {n_rows})",
              flush=True)
    # each kernel's test also passes a live row's own candidate (r = 0)
    live = int((p_sorted.alive if active is None else (
        p_sorted.alive.view(groups, -1)[
            active[0][:int(active[1])].long()])).sum())
    tested_share(dname, grid, cfg.window_group, n_dens + live, label, active)
    density_bitwise(dname, p_sorted, grid, cfg, label, active)
    tested_share(fname, grid, cfg.window_group, n_force + live, label,
                 active)
    twice_bitwise(fname, lambda: cuda_pairs.force_sums(p_dens, cfg, grid,
                                                       None, active), label)
    out[dname] += bound(dname, rows, groups,
                        n_dens * (OPS_DENSITY_VAR if var else OPS_DENSITY),
                        active)
    out[fname] += bound(fname, rows, groups,
                        n_force * (OPS_FORCE_VAR if var else OPS_FORCE),
                        active)
    return out


def fused_kernel(p_sorted, grid, cfg, label, active=None):
    """The fused force kernel (fixed-h or variable-h by cfg) against its
    plain version at the step's split; returns (err, ms, plain_ms,
    bound_ms, by).  With `active` the gated kernel, as `sph_kernels`."""
    from summersph_tpu_torch.ops import cuda_pairs, pm_gravity

    var = cfg.fixed_h is None
    name = (("force_var_h_grav" if var else "force_fixed_h_grav")
            + ("_gated" if active is not None else ""))
    p_dens = cuda_pairs.pair_eval(p_sorted, cfg, grid)[0]
    r_s = pm_gravity.pm_geometry(p_sorted, cfg)[2]
    split = (r_s, cfg.effective_rcut_rs() * r_s)
    require(float(split[1]) <= float(grid.cell_size),
            f"r_cut {float(split[1])} > SPH cell {float(grid.cell_size)}")
    p64, split64 = f64(p_dens), tuple(v.double() for v in split)
    # the gravity sums in float64; with variable h all eight
    first = 0 if var else 5
    res = compare(
        name,
        lambda: cuda_pairs.force_sums(p_dens, cfg, grid, split, active),
        lambda: cuda_pairs.force_sums_plain(p_dens, cfg, grid, split,
                                            active), label,
        exact=lambda: cuda_pairs.force_sums_plain(p64, cfg, grid, split64,
                                                  active)[first:])
    n_sph = sph_pair_counts(p_sorted, grid, cfg, active)[1]
    n_grav = count_pairs(p_sorted.pos, grid, cfg.window_group,
                         split[1] ** 2, active=active)
    print(f"[{label}] r_s {float(r_s):.4f} r_cut {float(split[1]):.4f} "
          f"SPH cell {float(grid.cell_size):.4f}; pairs inside "
          f"{'2 max(h_i, h_j)' if var else '2h'} {n_sph}, inside r_cut "
          f"{n_grav}", flush=True)
    return res + bound(name, p_sorted.capacity, grid.starts.shape[0],
                       n_sph * (OPS_FORCE_VAR if var else OPS_FORCE)
                       + n_grav * (OPS_GRAV - OPS_GEOMETRY), active)


def grav_kernel(p, cfg, label, plain_reps=2, active_rows=None, r_s=None):
    """The short-range gravity kernel against its plain version on the
    gravity sort of `p` at its mesh split (or at the split `r_s` given);
    returns (err, ms, plain_ms, bound_ms, by).  With `active_rows` [N]
    bool (in p's order) the gated kernel on the worklist of the
    gravity-sorted groups that hold such a row, as `pm_short_range`
    builds it."""
    import torch
    from summersph_tpu_torch.ops import cuda_pairs, pm_gravity
    from summersph_tpu_torch.ops.sorted_grid import group_worklist

    if r_s is None:
        r_s = pm_gravity.pm_geometry(p, cfg)[2]
    pos, m, h, ggrid, perm, split = pm_gravity.gravity_sort(p, cfg, r_s)
    active, name = None, "grav_short"
    if active_rows is not None:
        pad = active_rows.new_zeros(perm.shape[0] - p.capacity)
        active = group_worklist(torch.cat([active_rows, pad])[perm],
                                cfg.window_group)
        name = "grav_short_gated"
    ext = (ggrid.ends - ggrid.starts).sum(dim=1)
    print(f"[{label}] gravity windows: r_cut {float(split[1]):.4f}, "
          f"candidates per row mean {float(ext.float().mean()):.1f} max "
          f"{int(ext.max())}", flush=True)
    exact = (pos.double(), m.double(), h.double(), ggrid, cfg,
             tuple(v.double() for v in split), active)
    res = compare(
        name,
        lambda: cuda_pairs.grav_short_sums(pos, m, h, ggrid, cfg, split,
                                           active),
        lambda: cuda_pairs.grav_short_sums_plain(pos, m, h, ggrid, cfg,
                                                 split, active),
        label, plain_reps=plain_reps,
        exact=lambda: cuda_pairs.grav_short_sums_plain(*exact))
    n_grav = count_pairs(pos, ggrid, cfg.window_group, split[1] ** 2,
                         active=active)
    n_rows = (p.capacity if active is None
              else int(active[1]) * cfg.window_group)
    print(f"[{label}] pairs inside r_cut: {n_grav} "
          f"({n_grav / max(n_rows, 1):.1f} per row of {n_rows})", flush=True)
    tested_share(name, ggrid, cfg.window_group, n_grav, label, active)
    twice_bitwise(name, lambda: cuda_pairs.grav_short_sums(
        pos, m, h, ggrid, cfg, split, active), label)
    return res + bound(name, pos.shape[0], ggrid.starts.shape[0],
                       n_grav * OPS_GRAV, active)


def pm_vs_direct(state, label):
    """rms and median relative error of the two TreePM routes (separate at
    grid 128, fused at grid 256) against the exact direct sum, printed:
    the mesh delivers the unsoftened force beyond r_cut, where the direct
    sum still softens up to 2h, so the size of the error depends on the
    mesh and is no pass mark."""
    import torch
    from summersph_tpu_torch.bench import bench_config
    from summersph_tpu_torch.ops import cuda_pairs, gravity, pm_gravity
    from summersph_tpu_torch.ops.sorted_grid import sort_particles

    n = state.particles.capacity
    cfg128, _ = bench_config(n, gravity="pm", grav_grid=128)
    cfg256, _ = bench_config(n, gravity="pm", grav_grid=256)
    p2, grid = sort_particles(state.particles, cfg256)
    direct = gravity.gas_gravity_direct(p2, cfg256)
    sep = pm_gravity.gas_gravity_pm(p2, cfg128)[0]
    r_s = pm_gravity.pm_geometry(p2, cfg256)[2]
    out = cuda_pairs.pair_eval(p2, cfg256, grid,
                               (r_s, cfg256.effective_rcut_rs() * r_s))
    fused = pm_gravity.pm_long_range(p2, cfg256)[0] + out[4]
    mag = torch.linalg.norm(direct, dim=1)
    live = p2.alive
    for route, acc in (("separate, grid 128", sep), ("fused, grid 256",
                                                     fused)):
        rel = (torch.linalg.norm(acc - direct, dim=1)
               / torch.clamp(mag, min=1e-12))[live]
        rms = float(torch.sqrt(torch.mean(rel ** 2)))
        require(bool(torch.isfinite(acc).all()), f"{route} not finite")
        print(f"[{label}] gas_gravity_pm ({route}) vs gas_gravity_direct: "
              f"rms relative error {rms:.4e}, median "
              f"{float(torch.median(rel)):.4e}", flush=True)


def time_main_path(state, cfg, steps=STEPS):
    """prime, run_steps(steps) warm-up, run_steps(steps) timed.  Returns
    (warm-up state, final state, particle-steps/s, s/step)."""
    import torch
    from summersph_tpu_torch.integrate import prime, run_steps

    warm = run_steps(prime(state, cfg), cfg, steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_steps(warm, cfg, steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rate = int(out.particles.n_alive) * steps / wall
    return warm, out, rate, wall / steps


def check_run(state, warm, out, label):
    """Health counters zero, check_health, particles lost only to
    accretion, finite diagnostics."""
    import torch
    from summersph_tpu_torch import diagnostics
    from summersph_tpu_torch.integrate import check_health

    n = state.particles.capacity
    m_p = float(state.particles.mass[0])
    m_sink0 = float(state.sinks.mass[0])
    for st, what in ((warm, "warm-up"), (out, "timed")):
        require(not any(st.stats.tolist()),
                f"{label} {what} stats not all zero: {st.stats_dict()}")
    check_health(out, where=label)
    n_lost = n - int(out.particles.n_alive)
    accreted = (float(out.sinks.mass[0]) - m_sink0) / m_p
    require(abs(accreted - round(accreted)) < 1e-6
            and n_lost == round(accreted),
            f"{label}: {n_lost} particles lost but {accreted} accreted")
    d = diagnostics.measure(out)
    for key, val in d.items():
        require(bool(torch.isfinite(torch.as_tensor(val)).all()),
                f"{label}: measure()[{key!r}] not finite")
    print(f"[{label}] {diagnostics.format_report(d)}; lost {n_lost} "
          f"particles, all accreted", flush=True)


def check_collapse(state, warm, out, label):
    """The variable-h paths' checks: the window, non-finite and sink-slot
    counters zero on every step (sph_clamped and h_unconverged printed),
    check_health, gas lost equal to gas accreted, the total mass conserved
    to 1e-5, finite diagnostics."""
    import torch
    from summersph_tpu_torch import diagnostics
    from summersph_tpu_torch.integrate import check_health

    for st, what in ((warm, "warm-up"), (out, "timed")):
        d = st.stats_dict()
        bad = {k: d[k] for k in ("sph_window_overflow",
                                 "grav_window_overflow", "nonfinite",
                                 "sink_slots_full") if d[k]}
        require(not bad, f"{label} {what} counters tripped: {d}")
        print(f"[{label}] {what} counters (maximum over the steps): "
              f"sph_clamped {d['sph_clamped']}, h_unconverged "
              f"{d['h_unconverged']}; the window, non-finite and sink-slot "
              f"counters 0", flush=True)
    check_health(out, where=label)
    n_lost = int(state.particles.n_alive) - int(out.particles.n_alive)
    m_p = float(state.particles.mass[0])
    gained = float(out.sinks.mass.double().sum()
                   - state.sinks.mass.double().sum())
    total0 = float(state.particles.mass.double().sum()
                   + state.sinks.mass.double().sum())
    total1 = float(out.particles.mass.double().sum()
                   + out.sinks.mass.double().sum())
    require(abs(gained - n_lost * m_p) <= 1e-5 * max(gained, m_p),
            f"{label}: {n_lost} particles lost, sinks gained {gained}")
    require(abs(total1 - total0) <= 1e-5 * total0,
            f"{label}: total mass {total0} -> {total1}")
    d = diagnostics.measure(out)
    for key, val in d.items():
        require(bool(torch.isfinite(torch.as_tensor(val)).all()),
                f"{label}: measure()[{key!r}] not finite")
    print(f"[{label}] {diagnostics.format_report(d)}; lost {n_lost} "
          f"particles, all accreted; total mass {total0:.7g} -> "
          f"{total1:.7g}", flush=True)


def span_table(state, cfg, steps, label):
    """The program's spans of `steps` steps of run_steps on `state` under
    torch.profiler (the card's activity), reduced by
    `summersph_tpu_torch.span_table`: per span name the host and device
    ms, launches and idle ms, the counters, and the busy share of the
    window."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from summersph_tpu_torch import span_table, tracing
    from summersph_tpu_torch.integrate import run_steps

    torch.cuda.synchronize()
    tracing.collect()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_steps(state, cfg, steps)
        torch.cuda.synchronize()
    table = span_table.table(prof, tracing.collect())
    for line in table.lines():
        print(f"[{label}] {steps} steps: {line}", flush=True)


def require_packs(launches, label):
    """Every force launch, of whatever form, is preceded by one launch of
    the `pack_force` kernel (a key_rows launch by two: the columns' and
    the rows' records), and nothing else launches it."""
    forces = sum(k * (2 if name.endswith(KEY_ROWS) else 1)
                 for name, k in launches.items()
                 if name.startswith("force_"))
    require(launches["pack_force"] == forces,
            f"{label}: pack_force counted {launches['pack_force']}, force "
            f"kernels {forces}")


def run_path(state, cfg, expect, label, check):
    """One main path: reset the counts, prime + warm-up + timed steps, read
    the counts and check them against `expect`; then `check` (health),
    the peak memory, the span table of 5 steps.  Returns
    (launches, final state, cfg)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reset_counts()
    warm, out, rate, step_s = time_main_path(state, cfg)
    launches = launch_counts()
    print(f"[{label}] main path: {rate:.6e} particle-steps/s "
          f"({step_s * 1e3:.3f} ms/step, {STEPS} steps timed) launches "
          f"{nonzero(launches)}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
          f"{time.perf_counter() - t0:.1f} s with prime and warm-up",
          flush=True)
    expect = {**sink_expect(cfg, 2 * STEPS), **expect}
    for name, count in expect.items():
        require(launches[name] == count,
                f"{label}: {name} counted {launches[name]}, expected {count}")
    require_packs(launches, label)
    check(state, warm, out, label)
    span_table(out, cfg, 5, label)
    return launches, out, cfg


def sink_creation(n, dev, label, steps=10):
    """Config 5 at N = n on the separate route: one step, then the creation
    threshold below the densest particle's m (eta / h)^3.  `create_sinks`
    must seed a sink at that particle (mass sink_create_mass, radius 2h,
    its position); then `steps` one-step segments must create at least one
    sink, with no full slots or non-finite particle, gas lost equal to gas
    accreted and the total mass conserved to 1e-5."""
    import torch
    from summersph_tpu_torch.integrate import check_health, prime, run_steps
    from summersph_tpu_torch.ops.sinks import create_sinks

    state, cfg = config5(n, dev)
    st = run_steps(prime(state, cfg), cfg, 1)
    p = st.particles
    code = torch.where(p.alive, p.mass * (cfg.eta / p.h) ** 3, 0.0)
    best = int(torch.argmax(code))
    cfg = cfg.with_(sink_create_density=0.95 * float(code[best]))
    s2, full = create_sinks(p, st.sinks, cfg)
    new = torch.nonzero(s2.alive & ~st.sinks.alive)[:, 0].tolist()
    require(len(new) == 1 and int(full) == 0,
            f"{label}: create_sinks made {new}, slots_full {int(full)}")
    k = new[0]
    require(float(s2.mass[k]) == float(torch.tensor(cfg.sink_create_mass))
            and float(s2.radius[k]) == 2.0 * float(p.h[best])
            and torch.equal(s2.pos[k], p.pos[best]),
            f"{label}: seed sink mass {float(s2.mass[k])} radius "
            f"{float(s2.radius[k])} at {s2.pos[k].tolist()}, particle "
            f"{best} h {float(p.h[best])} at {p.pos[best].tolist()}")
    print(f"[{label}] threshold {cfg.sink_create_density:.6e} (0.95 x the "
          f"densest m (eta/h)^3): create_sinks seeded slot {k} with mass "
          f"{float(s2.mass[k]):.3g} and radius {float(s2.radius[k]):.4f} = "
          f"2h at particle {best}", flush=True)
    out, created, d = st, 0, {}
    for _ in range(steps):
        nxt = run_steps(out, cfg, 1)
        created += int((nxt.sinks.alive & ~out.sinks.alive).sum())
        out = nxt
        d = {k2: max(d.get(k2, 0), v) for k2, v in out.stats_dict().items()}
    require(created >= 1, f"{label}: no sink created in {steps} steps")
    require(d["sink_slots_full"] == 0 and d["nonfinite"] == 0,
            f"{label}: counters {d}")
    check_collapse(st, st, out, label)
    check_health(out, where=label)
    print(f"[{label}] {created} sinks created in {steps} steps, "
          f"{int(out.sinks.n_alive)} alive; counters {d}", flush=True)


def flat(out):
    """The tensors of a wrapper's result, nested tuples laid end to end."""
    out = (out,) if not isinstance(out, tuple) else out
    return [t for o in out for t in (o if isinstance(o, tuple) else (o,))]


def gated_bitwise(name, call, act, wg, label):
    """A gated kernel against its ungated form, bit for bit: `call(active)`
    launches the wrapper.  With a full worklist every row must be equal;
    with the worklist of `act` [N] bool the rows of the listed groups must
    be equal and every other row must read 0.  Times the ungated kernel and
    the gated one at both worklists; returns (ungated ms, full ms, partial
    ms, share of groups listed)."""
    import torch
    from summersph_tpu_torch.ops.sorted_grid import group_worklist

    full = group_worklist(torch.ones_like(act), wg)
    part = group_worklist(act, wg)
    groups = part[0].shape[0]
    listed = torch.zeros(groups, dtype=torch.bool, device=act.device)
    listed[part[0][:int(part[1])].long()] = True
    rows = listed.repeat_interleave(wg)
    require(0 < int(part[1]) < groups and bool(rows[act].all()),
            f"{name}: worklist lists {int(part[1])} of {groups} groups")
    ungated, at_full, at_part = (flat(call(a)) for a in (None, full, part))
    torch.cuda.synchronize()
    for c, (a, b, d) in enumerate(zip(ungated, at_full, at_part)):
        require(torch.equal(a, b),
                f"{name} output {c}: full worklist differs from ungated "
                f"({label})")
        require(torch.equal(a[rows], d[rows]),
                f"{name} output {c}: listed rows differ from ungated "
                f"({label})")
        require(not bool(d[~rows].any()),
                f"{name} output {c}: an unlisted row is not 0 ({label})")
    ms = [cuda_ms(lambda a=a: call(a), 10) for a in (None, full, part)]
    share = int(part[1]) / groups
    print(f"[{label}] {name}: equal to the ungated kernel bit for bit (full "
          f"worklist everywhere; {int(part[1])} of {groups} groups listed: "
          f"their rows equal, the rest 0); ungated {ms[0]:.4f} ms, full "
          f"worklist {ms[1]:.4f} ms, {share:.3f} of the groups {ms[2]:.4f} "
          f"ms", flush=True)
    return ms[0], ms[1], ms[2], share


def lowest_quarter(pos, alive):
    """[N] bool: the live rows whose x lies in the lowest quarter."""
    import torch

    return alive & (pos[:, 0] < torch.quantile(pos[alive, 0], 0.25))


def gated_sph_checks(p_sorted, grid, cfg, label, fused=False, plain=True):
    """Every gated SPH kernel of cfg's h mode on one sorted state, with the
    lowest quarter in x active: bit for bit against the ungated kernel
    (`gated_bitwise`), then, with `plain`, against the gated plain version
    (`sph_kernels`, or `fused_kernel` with `fused`)."""
    from summersph_tpu_torch.ops import cuda_pairs, pm_gravity
    from summersph_tpu_torch.ops.sorted_grid import group_worklist

    var = "var_h" if cfg.fixed_h is None else "fixed_h"
    wg = cfg.window_group
    act = lowest_quarter(p_sorted.pos, p_sorted.alive)
    p_dens = cuda_pairs.pair_eval(p_sorted, cfg, grid)[0]
    gate = group_worklist(act, wg)
    if fused:
        r_s = pm_gravity.pm_geometry(p_sorted, cfg)[2]
        split = (r_s, cfg.effective_rcut_rs() * r_s)
        gated_bitwise(f"force_{var}_grav_gated",
                      lambda a: cuda_pairs.force_sums(p_dens, cfg, grid,
                                                      split, a),
                      act, wg, label)
        if plain:
            fused_kernel(p_sorted, grid, cfg, label, gate)
        return
    gated_bitwise(f"density_{var}_gated",
                  lambda a: cuda_pairs.density_sums(p_sorted, cfg, grid, a),
                  act, wg, label)
    gated_bitwise(f"force_{var}_gated",
                  lambda a: cuda_pairs.force_sums(p_dens, cfg, grid, None, a),
                  act, wg, label)
    if plain:
        sph_kernels(p_sorted, grid, cfg, label, gate)


def gated_grav_check(p, cfg, label, plain=True):
    """`grav_short_gated` on the gravity sort of `p`, the lowest quarter in
    x active: bit for bit against `grav_short`, then, with `plain`,
    against the gated plain version (`grav_kernel`)."""
    from summersph_tpu_torch.ops import cuda_pairs, pm_gravity

    r_s = pm_gravity.pm_geometry(p, cfg)[2]
    pos, m, h, ggrid, _, split = pm_gravity.gravity_sort(p, cfg, r_s)
    gated_bitwise("grav_short_gated",
                  lambda a: cuda_pairs.grav_short_sums(pos, m, h, ggrid, cfg,
                                                       split, a),
                  lowest_quarter(pos, m > 0.0), cfg.window_group, label)
    if plain:
        grav_kernel(p, cfg, label, active_rows=lowest_quarter(p.pos,
                                                              p.alive))


def pack_kernel(p_dens, key, var, label):
    """The `pack_force` kernel against its plain version, bit for bit, on
    sorted particles that carry rho, P, omega and cs; returns (err, ms,
    plain_ms, bound_ms, by), the bound from the bytes it reads and
    writes."""
    import torch
    from summersph_tpu_torch.ops import cuda_pairs

    ours = cuda_pairs.pack_force(p_dens, key, var)
    plain = cuda_pairs.pack_force_plain(p_dens, key, var)
    torch.cuda.synchronize()
    err = 0.0
    for c, (a, b) in enumerate(zip(ours, plain)):
        if b is None:
            require(a is None, f"pack_force output {c} ({label})")
            continue
        require(torch.equal(a, b),
                f"pack_force output {c} differs from its plain version "
                f"({label})")
        err = max(err, float((a.double() - b.double()).abs().max()))
    ms = cuda_ms(lambda: cuda_pairs.pack_force(p_dens, key, var), 10)
    plain_ms = cuda_ms(lambda: cuda_pairs.pack_force_plain(p_dens, key, var),
                       2)
    n = p_dens.capacity
    per_row = KERNELS["pack_force"][1] if var else 53 + 48
    print(f"[{label}] pack_force ({'variable' if var else 'fixed'} h): equal "
          f"to its plain version bit for bit; kernel {ms:.4f} ms plain "
          f"{plain_ms:.4f} ms", flush=True)
    return err, ms, plain_ms, per_row * n / PEAK_BYTES * 1e3, "bytes"


def ragged_checks(dev, n_clump=16384):
    """The pair kernels on window shapes built to break a queue or a tile
    loop (models/ragged.py) and on a clump of `n_clump` particles with
    variable h: the density kernels' rho_raw within RHO_RTOL of the plain
    version, every other sum against the plain version in float64
    (`hold_exact`), two launches bit for bit, a gated density launch bit
    for bit the ungated one on the listed rows and 0 elsewhere (at a
    partial and a full worklist), the fused form's SPH sums bit for bit
    the unfused kernel's, `pack_force` bit for bit its plain version.  The
    clump with fixed h runs the density checks only."""
    import torch
    from summersph_tpu_torch.config import SimConfig
    from summersph_tpu_torch.models import ragged
    from summersph_tpu_torch.ops import cuda_pairs
    from summersph_tpu_torch.ops.sorted_grid import sort_particles
    from summersph_tpu_torch.state import Particles

    def density_checks(p2, grid, cfg, label):
        var = cfg.fixed_h is None
        name = f"density_{'var' if var else 'fixed'}_h"
        call = lambda a=None: cuda_pairs.density_sums(p2, cfg, grid, a)
        ours = flat(call())
        plain = cuda_pairs.density_sums_plain(p2, cfg, grid)
        hold(name, ours[:1], plain[:1], label, rtol=RHO_RTOL, atol_rel=0.0)
        if var:
            hold_exact(name, ours[1:], plain[1:],
                       cuda_pairs.density_sums_plain(f64(p2), cfg, grid)[1:],
                       label, first=1)
        else:
            require(not bool(ours[1].any()),
                    f"{name}: omega_raw not 0 ({label})")
        twice_bitwise(name, call, label)
        gated_bitwise(name + "_gated", call, lowest_quarter(p2.pos, p2.alive),
                      cfg.window_group, label)
        survivors = count_pairs(p2.pos, grid, cfg.window_group, 4.0,
                                h=p2.h) + int(p2.alive.sum())
        tested_share(name, grid, cfg.window_group, survivors, label)

    def check(p, cfg, r_cut, label):
        var = cfg.fixed_h is None
        p2, grid = sort_particles(p, cfg)
        density_checks(p2, grid, cfg, label)
        p3 = cuda_pairs.pair_eval(p2, cfg, grid)[0]
        r_cut = torch.as_tensor(r_cut, dtype=torch.float32, device=dev)
        split = (r_cut / cfg.effective_rcut_rs(), r_cut)
        require(float(r_cut) <= float(grid.cell_size),
                f"{label}: r_cut {float(r_cut)} > cell")
        p64, split64 = f64(p3), tuple(v.double() for v in split)
        lengths = sorted(ragged.range_lengths(grid))
        print(f"[{label}] range lengths {lengths[:8]} ... {lengths[-3:]}, "
              f"largest group {int((grid.ends - grid.starts).sum(1).max())} "
              f"candidates", flush=True)
        pack_kernel(p3, grid.key, var, label)
        unfused = None
        for sp, sp64 in ((None, None), (split, split64)):
            name = (f"force_{'var' if var else 'fixed'}_h"
                    + ("_grav" if sp is not None else ""))
            call = lambda sp=sp: cuda_pairs.force_sums(p3, cfg, grid, sp)
            ours = flat(call())
            hold_exact(name, ours,
                       flat(cuda_pairs.force_sums_plain(p3, cfg, grid, sp)),
                       flat(cuda_pairs.force_sums_plain(p64, cfg, grid,
                                                        sp64)), label)
            twice_bitwise(name, call, label)
            if sp is None:
                unfused = ours
            else:
                for c, (a, b) in enumerate(zip(ours[:5], unfused)):
                    require(torch.equal(a, b),
                            f"{name} output {c} differs from the unfused "
                            f"kernel ({label})")
        m = torch.where(p3.alive, p3.mass, 0.0)
        call = lambda: cuda_pairs.grav_short_sums(p3.pos, m, p3.h, grid, cfg,
                                                  split)
        hold_exact("grav_short", call(),
                   cuda_pairs.grav_short_sums_plain(p3.pos, m, p3.h, grid,
                                                    cfg, split),
                   cuda_pairs.grav_short_sums_plain(
                       p3.pos.double(), m.double(), p3.h.double(), grid, cfg,
                       split64), label)
        twice_bitwise("grav_short", call, label)
        return grid

    for name in ragged.CASES:
        case = ragged.ragged_case(name)
        for var in (False, True):
            cfg = SimConfig(fixed_h=None if var else case["h0"],
                            neighbor_mode="sorted", sorted_block=128,
                            window_group=32, gravity="pm")
            p = Particles.create(
                pos=case["pos"], vel=case["vel"], mass=case["mass"],
                u=case["u"], h=case["h"] if var else case["h0"],
                capacity=case["capacity"], device=dev)
            grid = check(p, cfg, case["r_cut"],
                         f"ragged {name} {'var' if var else 'fixed'} h")
            if name == "clusters":
                require({0, 1, 31, 32, 33, 129}
                        <= ragged.range_lengths(grid),
                        "the cluster case lost its hard range lengths")
    # the clump: its core rows have ~10^4 candidates in many chunks, most
    # of them pairs; h varies by 20% so that the j side reaches further
    p = clustered(n_clump, dev)
    h = 0.5 * (1.0 + 0.2 * torch.rand(
        n_clump, device=dev, generator=torch.Generator(dev).manual_seed(5)))
    rng_vel = torch.randn((n_clump, 3), device=dev,
                          generator=torch.Generator(dev).manual_seed(6))
    p = p.replace(h=h, vel=0.3 * rng_vel)
    cfg = SimConfig(fixed_h=None, neighbor_mode="sorted", sorted_block=128,
                    window_group=32, gravity="pm")
    check(p, cfg, 1.0, f"ragged clump N={n_clump} var h")
    cfg = cfg.with_(fixed_h=0.5)
    p = p.replace(h=torch.full_like(h, 0.5))
    density_checks(*sort_particles(p, cfg), cfg,
                   f"ragged clump N={n_clump} fixed h")


# ------------------------------------------------------- block timesteps

def binned_start(state, cfg, bins, label):
    """`state` primed under cfg.with_(dt_bins=bins), its dt raised to what
    the rungs allow: min(2^(bins-1) x the tightest candidate, dt_max), as
    scripts/blockstep_ab.py sets it.  Prints the rung occupancy.  Returns
    (primed state, binned cfg, tightest candidate, populated rungs)."""
    import torch
    from summersph_tpu_torch.blockstep import assign_rungs
    from summersph_tpu_torch.integrate import prime
    from summersph_tpu_torch.ops.timestep import dt_candidates

    cfg_b = cfg.with_(dt_bins=bins)
    s0 = prime(state, cfg_b)
    tight = float(torch.amin(dt_candidates(s0.particles, cfg_b)))
    base = min((1 << (bins - 1)) * tight, cfg.dt_max)
    s0 = s0.replace(dt=torch.as_tensor(base, dtype=s0.dt.dtype,
                                       device=s0.dt.device))
    rung = assign_rungs(s0.particles, cfg_b, s0.dt)
    hist = torch.bincount(rung[s0.particles.alive], minlength=bins).tolist()
    print(f"[{label}] tightest candidate {tight:.6e}, base dt {base:.6e} "
          f"(dt_max {cfg.dt_max:g}), rung occupancy {hist}", flush=True)
    return s0, cfg_b, tight, sum(1 for k in hist if k)


def substep_gates(state, cfg):
    """The sorted particles and grid of `state` with the rungs riding, and
    for every substep j of a base step (act [N] bool, worklist) at these
    positions (a run drifts between substeps; the shares barely move)."""
    from summersph_tpu_torch.blockstep import assign_rungs, closing_mask
    from summersph_tpu_torch.ops.sorted_grid import (group_worklist,
                                                     sort_particles)

    n_sub = 1 << (cfg.dt_bins - 1)
    h_pad = 1.0 if cfg.fixed_h is not None else cfg.sort_h_pad
    rung = assign_rungs(state.particles, cfg, state.dt)
    p2, grid, rung = sort_particles(state.particles, cfg, h_pad=h_pad,
                                    carry_derived=True, extra=rung)
    gates = []
    for j in range(n_sub):
        act = p2.alive & closing_mask(rung, j, n_sub)
        gates.append((act, group_worklist(act, cfg.window_group)))
    return p2, grid, gates


def pick_gate(gates, label):
    """(act, worklist) of the substep that lists the fewest groups, but at
    least one: the worklist the gated kernels are timed on at a path's
    shapes."""
    counts = [int(gate[1]) for _, gate in gates]
    j = min((j for j, c in enumerate(counts) if c), key=counts.__getitem__)
    print(f"[{label}] gated kernels at the worklist of substep {j}: "
          f"{counts[j]} of {gates[j][1][0].shape[0]} groups", flush=True)
    return gates[j]


def print_shares(gates, n_alive, label):
    groups = gates[0][1][0].shape[0]
    print(f"[{label}] active share per substep (rows of the live, window "
          f"groups): " + ", ".join(
              f"j={j} {int(act.sum()) / n_alive:.4f} "
              f"{int(gate[1]) / groups:.4f}"
              for j, (act, gate) in enumerate(gates)), flush=True)


def binned_path(state, cfg, bins, steps, per_substep, label, check,
                min_rungs=1):
    """One block-timestep path: prime, raise the base dt, reset the counts,
    run_steps(steps[0]) to warm up and run_steps(steps[1]) timed (base
    steps), read the counts.  `per_substep` gives the gated launches each
    substep must make; every kernel it does not name, gated or not, must
    count 0, and the mesh is solved once per run_steps call when gravity is
    on (pm_every >= the base steps of a call).  Then `check`, the host
    waits and the span table of one base step.  Returns
    (launches, primed state, final state, binned cfg, the primed state's
    tightest candidate)."""
    import torch
    from summersph_tpu_torch.integrate import run_steps

    n_sub = 1 << (bins - 1)
    s0, cfg_b, tight, populated = binned_start(state, cfg, bins, label)
    require(populated >= min_rungs,
            f"{label}: {populated} rungs populated, need {min_rungs}")
    n_alive = int(s0.particles.n_alive)
    print_shares(substep_gates(s0, cfg_b)[2], n_alive, label)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    warm = run_steps(s0, cfg_b, steps[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_steps(warm, cfg_b, steps[1])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    substeps = n_sub * sum(steps)
    expect = {name: 0 for name in pair_launches(launches)}
    expect.update({name: k * substeps for name, k in per_substep.items()})
    expect["mesh solves"] = 2 if cfg.gravity != "none" else 0
    del expect["pack_force"]
    for name, count in expect.items():
        require(launches[name] == count,
                f"{label}: {name} counted {launches[name]}, expected {count}")
    require_packs(launches, label)
    advanced = float(out.t) - float(warm.t)
    print(f"[{label}] block steps: {steps[1]} base steps of {n_sub} substeps "
          f"timed, {wall / steps[1] * 1e3:.3f} ms per base step "
          f"({wall / steps[1] / n_sub * 1e3:.3f} ms per substep), "
          f"{int(out.particles.n_alive) * steps[1] * n_sub / wall:.6e} "
          f"particle-substeps/s, simulated time {advanced:.6e} in "
          f"{wall:.4f} s; launches {nonzero(launches)}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB",
          flush=True)
    check(s0, warm, out, label)
    host_waits(out, cfg_b, cfg, label)
    span_table(out, cfg_b, 1, label)
    return launches, s0, out, cfg_b, tight


def host_waits(state, cfg_b, cfg_g, label):
    """Calls that make the host wait for the card (`aten::item`,
    `aten::_local_scalar_dense`, `cudaStreamSynchronize`), counted by
    torch.profiler over one base step of the binned engine and over one
    step of the global engine from the same state.  A substep is a step's
    counterpart: a base step must count no more than its substeps times
    the global step's count."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from summersph_tpu_torch.integrate import run_steps

    names = ("aten::item", "aten::_local_scalar_dense",
             "cudaStreamSynchronize")
    counts = {}
    for leg, cfg in (("global step", cfg_g), ("base step", cfg_b)):
        run_steps(state, cfg, 1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            run_steps(state, cfg, 1)
        torch.cuda.synchronize()
        counts[leg] = {e.key: e.count for e in prof.key_averages()
                       if e.key in names}
    n_sub = 1 << (cfg_b.dt_bins - 1)
    print(f"[{label}] host waits (torch.profiler counts of {names}): one "
          f"global step {counts['global step'] or 0}, one base step of "
          f"{n_sub} substeps {counts['base step'] or 0}", flush=True)
    require(sum(counts["base step"].values())
            <= n_sub * sum(counts["global step"].values()),
            f"{label}: a base step waits for the card: {counts}")


def conserved(s0, out, label, leg):
    """Total mass (live gas and sinks) of `out` against `s0` to 1e-5."""
    def total(st):
        p = st.particles
        return float(p.mass[p.alive].double().sum()
                     + st.sinks.mass[st.sinks.alive].double().sum())

    m0, m1 = total(s0), total(out)
    require(abs(m1 - m0) <= 1e-5 * m0,
            f"{label} {leg}: total mass {m0} -> {m1}")
    return m1


def ab_legs(s0, cfg_b, tight, base_steps, label, counters):
    """The A/B: from the primed state `s0` the binned engine (cfg_b, its
    base dt pinned) takes `base_steps` base steps and the global engine
    (dt_bins = 1, dt pinned at the tightest candidate or dt_max) as many
    steps as reach the same simulated time; each leg after one untimed run
    of the same length.  Prints wall seconds per unit of simulated time and
    the physics of both legs; requires the total mass conserved to 1e-5 and
    the health counters named in `counters` zero (None: all)."""
    import torch
    from summersph_tpu_torch import diagnostics
    from summersph_tpu_torch.integrate import run_steps

    base = float(s0.dt)
    dt_g = min(tight, cfg_b.dt_max)
    n_g = round(base_steps * base / dt_g)
    dt_g = base_steps * base / n_g
    legs = {}
    for leg, cfg, dt, n in (
            ("binned", cfg_b.with_(dt_min=base, dt_max=base), base,
             base_steps),
            ("global", cfg_b.with_(dt_bins=1, dt_min=dt_g, dt_max=dt_g),
             dt_g, n_g),
            ("global", None, None, None), ("binned", None, None, None)):
        if cfg is None:     # second turn: time what the first turn warmed
            cfg, st, n = legs[leg][:3]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run_steps(st, cfg, n)
            torch.cuda.synchronize()
            legs[leg] += (time.perf_counter() - t0, out)
            continue
        st = s0.replace(dt=torch.as_tensor(dt, dtype=s0.dt.dtype,
                                           device=s0.dt.device))
        run_steps(st, cfg, n)
        legs[leg] = (cfg, st, n)
    rate = {}
    for leg, (cfg, st, n, wall, out) in legs.items():
        advanced = float(out.t) - float(st.t)
        d = out.stats_dict()
        bad = {k: v for k, v in d.items()
               if v and (counters is None or k in counters)}
        require(not bad, f"{label} {leg}: counters tripped: {d}")
        mass = conserved(st, out, label, leg)
        m = diagnostics.measure(out)
        rate[leg] = wall / advanced
        print(f"[{label}] A/B {leg}: {n} steps of dt {float(st.dt):.6e}, "
              f"simulated {advanced:.6e} in {wall:.4f} s wall = "
              f"{rate[leg]:.6e} s per unit of simulated time; total mass "
              f"{mass:.7g}, momentum "
              f"{[f'{v:.4e}' for v in m['momentum'].tolist()]}, e_kin "
              f"{float(m['e_kin']):.6e}, rho_max {float(m['rho_max']):.6e}, "
              f"n_gas {int(m['n_gas'])}, stats {d}", flush=True)
    print(f"[{label}] A/B: the binned engine takes "
          f"{rate['binned'] / rate['global']:.4f} x the global engine's wall "
          f"time per unit of simulated time", flush=True)


IMAGE_RES = 40      # phase 17's image: 40^3 grid points against every particle
SOD_N, SOD_T, SOD_L2_MAX = 400, 0.1, 0.03


@contextlib.contextmanager
def io_timed(log, run):
    """Inside the block, every file read and write of the port's I/O
    appends (name, seconds) to `log`, and every `integrate.run_steps` call
    adds its steps to run["steps"] and takes the running maximum of its
    health counters into run["stats"].  It wraps the module attributes the
    CLI and `run_until` look up when they call them."""
    import torch
    from summersph_tpu_torch import integrate
    from summersph_tpu_torch.io import checkpoint, txt
    from summersph_tpu_torch.tools import make_ics

    saved = [(mod, name, getattr(mod, name)) for mod, name in (
        (txt, "read_ic_txt"), (txt, "write_snapshot_txt"),
        (make_ics, "write_snapshot_txt"), (checkpoint, "save_npz"),
        (checkpoint, "load_npz_with_config"), (integrate, "run_steps"))]

    def timed(name, fn):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            log.append((name, time.perf_counter() - t0))
            return out
        return call

    def counted(fn):
        def call(state, cfg, n_steps, axis_name=None):
            out = fn(state, cfg, n_steps, axis_name)
            run["steps"] += n_steps
            run["stats"] = torch.maximum(run.get("stats", out.stats),
                                         out.stats)
            return out
        return call

    for mod, name, fn in saved:
        setattr(mod, name, counted(fn) if name == "run_steps"
                else timed(name, fn))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def print_io(log, label):
    for name, sec in log:
        print(f"[{label}] {name}: {sec:.3f} s", flush=True)


def snapshot_rows(path):
    with open(path, "rb") as f:
        return f.read().count(b"\n")


def cli_run_checks(launches, run, label):
    """One pair-kernel launch of each of `run`'s kernels a step plus one
    for prime, no other pair kernel, health counters zero."""
    steps = run["steps"]
    pair = {k: v for k, v in nonzero(pair_launches(launches)).items()
            if k not in ("pack_force", "mesh solves")}
    print(f"[{label}] {steps} steps; launches {nonzero(launches)}",
          flush=True)
    require(steps > 0, f"{label}: no step taken")
    require(not any(run["stats"].tolist()),
            f"{label}: health counters {run['stats'].tolist()}")
    require_packs(launches, label)
    return steps, pair


def column_densities(path, xi, cols, h, box):
    """The z-projected density of `cols` (pairs of grid indices) in float64
    numpy, from the snapshot's own text: sum over the z grid points of
    sum_j m_j W(|x_g - x_j|, h) over the gas rows inside the box."""
    import numpy as np

    raw = np.loadtxt(path, skiprows=1, ndmin=2)
    gas = raw[raw[:, 6] != 0.0]
    gas = gas[np.all(np.abs(gas[:, :3]) < box, axis=1)]
    pos, m = gas[:, :3], gas[:, 7]
    out = []
    for i, j in cols:
        near = ((np.abs(pos[:, 0] - xi[i]) < 2 * h)
                & (np.abs(pos[:, 1] - xi[j]) < 2 * h))
        g = np.stack(np.broadcast_arrays(xi[i], xi[j], xi), axis=-1)
        q = np.linalg.norm(g[:, None, :] - pos[near][None], axis=-1) / h
        w = np.where(q <= 1.0, 1.0 - 1.5 * q * q + 0.75 * q ** 3,
                     np.where(q <= 2.0, 0.25 * (2.0 - q) ** 3, 0.0))
        out.append(float(np.sum(m[near] * w / (np.pi * h ** 3))))
    return np.array(out)


def cli_path(dev, n, t_end):
    """Phase 17: the reference user's workflow through the CLI in this
    process, in a temporary directory: make-ics, run with the default
    neighbor_mode ('grid') to t_end (the disc's t after 2 x STEPS steps in
    phase 5), resume with TreePM, the image of the last snapshot, and the
    Sod tube with `simulate`."""
    import os
    import tempfile

    import numpy as np
    import torch
    from summersph_tpu_torch import cli
    from summersph_tpu_torch.bench import bench_config
    from summersph_tpu_torch.config import SimConfig
    from summersph_tpu_torch.integrate import check_health, simulate
    from summersph_tpu_torch.io import checkpoint as ck_io
    from summersph_tpu_torch.io import txt as txt_io
    from summersph_tpu_torch.models.sod import (sod_config, sod_ic,
                                                sod_l2_density_error)
    from summersph_tpu_torch.tools.density_image import \
        projected_density_from_snapshot

    cfg, h0 = bench_config(n)
    sets = [f"{k}={getattr(cfg, k)}" for k in (
        "dt_init", "dt_min", "dt_max", "sorted_block", "window_group",
        "window_blocks", "pallas_window", "pallas_fetch_window",
        "grav_window_blocks", "use_pallas")]
    set_flags = [a for kv in sets for a in ("--set", kv)]
    device = ["--device", str(dev)]
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        ic = os.path.join(tmp, "disc.txt")
        out, res = os.path.join(tmp, "run"), os.path.join(tmp, "resumed")

        # 1. the IC file
        label = f"N={n} cli make-ics"
        log = []
        t0 = time.perf_counter()
        with io_timed(log, {}):
            require(cli.main(["make-ics", "disc", "--n", str(n), "--seed",
                              "0", "--out", ic, *device]) == 0,
                    "make-ics failed")
        print(f"[{label}] {time.perf_counter() - t0:.3f} s in all; "
              f"{os.path.getsize(ic) / 2**20:.1f} MiB", flush=True)
        print_io(log, label)

        # 2. run the disc with the default neighbor_mode
        label = f"N={n} cli run"
        log, run = [], {"steps": 0}
        reset_counts()
        t0 = time.perf_counter()
        with io_timed(log, run):
            require(cli.main([
                "run", "--ic", ic, "--out", out, "--fixed-h", repr(h0),
                "--gamma", "1.4", "--bounding-size", "1500", "--end-time",
                repr(t_end), "--n-saves", "4", *set_flags, *device]) == 0,
                "run failed")
        run_s = time.perf_counter() - t0
        launches = launch_counts()
        steps, pair = cli_run_checks(launches, run, label)
        for name in ("density_fixed_h", "force_fixed_h"):
            require(pair.get(name) == 1 + steps,
                    f"{label}: {name} launched {pair.get(name)}, expected "
                    f"{1 + steps}")
        require(set(pair) == {"density_fixed_h", "force_fixed_h"},
                f"{label}: other pair kernels launched: {pair}")
        io_s = sum(sec for _, sec in log)
        print_io(log, label)
        print(f"[{label}] {run_s:.3f} s in all, {io_s:.3f} s of it in file "
              f"I/O; {n * steps / (run_s - io_s):.6e} particle-steps/s with "
              f"the I/O taken out (prime and the tick diagnostics in)",
              flush=True)
        results["run"] = {"steps": steps, "launches": pair}

        log = []
        with io_timed(log, {}):
            # through the modules, so that io_timed sees the calls
            ck, ck_cfg = ck_io.load_npz_with_config(
                os.path.join(out, "checkpoint.npz"), device=dev)
            snap, _ = txt_io.read_ic_txt(os.path.join(out, "save3.txt"),
                                         ck_cfg, device=dev)
        print_io(log, f"{label} checkpoint and last snapshot read back")
        require(ck_cfg.neighbor_mode == "grid" and ck_cfg.fixed_h == h0,
                f"{label}: checkpoint config {ck_cfg}")
        check_health(ck, where=label)
        p = ck.particles
        live = p.alive
        n_live, n_sinks = int(live.sum()), int(ck.sinks.alive.sum())
        saves = sorted(f for f in os.listdir(out) if f.startswith("save"))
        require(saves == [f"save{i}.txt" for i in range(4)],
                f"{label}: saves {saves}")
        rows = [snapshot_rows(os.path.join(out, f)) for f in saves]
        print(f"[{label}] rows (header, gas, sinks) of {saves}: {rows}; "
              f"checkpoint {n_live} gas + {n_sinks} sinks at "
              f"t={float(ck.t):.6g}", flush=True)
        require(rows[-1] == 1 + n_live + n_sinks,
                f"{label}: last snapshot has {rows[-1]} lines")
        require(all(1 + n_live + n_sinks <= r <= 1 + n + n_sinks
                    for r in rows), f"{label}: snapshot rows {rows}")
        order = torch.argsort(p.pid[live])
        for name in ("pos", "vel", "u", "mass", "alpha"):
            require(torch.equal(getattr(p, name)[live][order],
                                getattr(snap, name)[:n_live][order]),
                    f"{label}: checkpoint {name} differs from save3.txt")
        print(f"[{label}] checkpoint live gas equal to save3.txt's columns "
              f"at float32, row for row", flush=True)

        # 3. resume with TreePM for two more ticks
        label = f"N={n} cli resume --gravity pm"
        log, run = [], {"steps": 0}
        reset_counts()
        t0 = time.perf_counter()
        with io_timed(log, run):
            require(cli.main([
                "resume", os.path.join(out, "checkpoint.npz"), "--out", res,
                "--gravity", "pm", "--set", "grav_grid=128", "--end-time",
                repr(2.2 * t_end), "--n-saves", "2", *device]) == 0,
                "resume failed")
            ck2, ck2_cfg = ck_io.load_npz_with_config(
                os.path.join(res, "checkpoint.npz"), device=dev)
        resume_s = time.perf_counter() - t0
        launches = launch_counts()
        steps, pair = cli_run_checks(launches, run, label)
        for name in ("grav_short", "mesh solves", "density_fixed_h",
                     "force_fixed_h"):
            require(launches[name] == 1 + steps,
                    f"{label}: {name} counted {launches[name]}, expected "
                    f"{1 + steps}")
        require(set(pair) == {"density_fixed_h", "force_fixed_h",
                              "grav_short"},
                f"{label}: other pair kernels launched: {pair}")
        require(ck2_cfg == ck_cfg.with_(gravity="pm", grav_grid=128,
                                        end_time=2.2 * t_end, n_saves=2),
                f"{label}: resumed config {ck2_cfg}")
        check_health(ck2, where=label)
        rise = float(ck2.t) - float(ck.t)
        require(rise > 0, f"{label}: t rose by {rise}")
        print_io(log, label)
        print(f"[{label}] {resume_s:.3f} s in all; t {float(ck.t):.6g} -> "
              f"{float(ck2.t):.6g}; {int(ck2.particles.n_alive)} gas",
              flush=True)
        results["resume"] = {"steps": steps, "launches": pair,
                             "mesh solves": launches["mesh solves"]}

        # 4. the image of the last snapshot
        label = f"N={n} image"
        last = os.path.join(res, "save1.txt")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        proj, xi, sink_xy = projected_density_from_snapshot(
            last, resolution=IMAGE_RES, device=dev)
        image_s = time.perf_counter() - t0
        h_img, box = SimConfig().fixed_h, 100.0
        rng = np.random.default_rng(0)
        cols = rng.integers(0, IMAGE_RES, (64, 2))
        ref = column_densities(last, xi, cols, h_img, box)
        got = proj[cols[:, 0], cols[:, 1]].astype(np.float64)
        err = np.abs(got - ref)
        bad = err > 1e-4 * np.abs(ref) + 1e-7 * float(proj.max())
        require(not bad.any(), f"{label}: {int(bad.sum())} of 64 columns "
                f"off the float64 sum, worst {float(err.max()):.3e}")
        np.save(os.path.join(tmp, "image.npy"), proj)
        require(np.array_equal(np.load(os.path.join(tmp, "image.npy")),
                               proj), f"{label}: the saved array differs")
        print(f"[{label}] {IMAGE_RES}^3 grid against the snapshot's gas in "
              f"{image_s:.3f} s (the file read included); 64 columns "
              f"within rtol 1e-4 of a float64 numpy sum, max abs error "
              f"{float(err.max()):.3e} of max {float(proj.max()):.3e}; "
              f"{len(sink_xy)} sinks", flush=True)
        results["image_s"] = image_s

    # 5. the Sod tube on the card
    label = f"Sod n={SOD_N}"
    scfg = sod_config(n=SOD_N).with_(
        end_time=SOD_T, n_saves=1, neighbor_mode="sorted", sorted_block=128,
        window_group=32, window_blocks=4)
    state, _ = sod_ic(n=SOD_N, cfg=scfg, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = simulate(state, scfg, verbose=False)
    sod_s = time.perf_counter() - t0
    l2 = sod_l2_density_error(state)
    print(f"[{label}] simulate to t={float(state.t):.6g} in {sod_s:.3f} s: "
          f"L2 density error {l2:.6f} (bound {SOD_L2_MAX})", flush=True)
    require(l2 < SOD_L2_MAX and int(state.particles.n_alive) == SOD_N,
            f"{label}: L2 {l2}, {int(state.particles.n_alive)} alive")
    results["sod_l2"] = l2
    return results


# ------------------------------------------------- phase 19: gather mode

SLABS = 4              # phase 19a: row slabs of each whole launch
DENSE_N = 16384        # phase 19c: the dense oracle's particles
# tests/test_sharding.py's tolerances for a sharded run against one device
SHARD_TOL = {"pos": (2e-5, 1e-6), "vel": (2e-4, 1e-5), "rho": (1e-4, 0.0),
             "h": (1e-4, 0.0)}


def slab_kernel(name, n, whole, slab, plain, label, exact=None, first=None,
                **tol):
    """Phase 19a for one row-slab kernel.  `whole()` launches the whole
    set, `slab(off, n_rows)` the row-slab form, `plain(off, n_rows)` its
    plain version and `exact(off, n_rows)` the plain version in float64 of
    the outputs from `first` on (sums that cancel, `hold_exact`).  The
    SLABS slabs laid end to end must equal the whole launch bit for bit,
    and they are held against their plain versions laid end to end.
    Prints the slabs' summed time beside the whole launch's.  Returns
    (max_abs_err, ms of the row-slab form on all n rows, the plain
    version's ms on the same rows: its slabs' times summed)."""
    import torch

    nl = n // SLABS
    ref = flat(whole())
    parts = [flat(slab(k * nl, nl)) for k in range(SLABS)]
    torch.cuda.synchronize()
    got = [torch.cat([p[c] for p in parts]) for c in range(len(ref))]
    for c, (a, b) in enumerate(zip(ref, got)):
        require(torch.equal(a, b), f"{name} output {c}: {SLABS} slabs "
                f"differ from the whole launch ({label})")
    print(f"[{label}] {name}: {SLABS} slabs of {nl} rows laid end to end "
          f"equal the whole launch bit for bit", flush=True)
    plain_ms, pl, ex = 0.0, [], []
    for k in range(SLABS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        pl.append(flat(plain(k * nl, nl)))
        stop.record()
        torch.cuda.synchronize()
        plain_ms += start.elapsed_time(stop)
        if exact is not None:
            ex.append(flat(exact(k * nl, nl)))
    pl = [torch.cat([p[c] for p in pl]) for c in range(len(ref))]
    first = len(ref) if exact is None else first
    err = hold(name, got[:first], pl[:first], label, **tol) if first else 0.0
    if exact is not None:
        ex = [torch.cat([q[c] for q in ex]) for c in range(len(ex[0]))]
        err = max(err, hold_exact(name, got[first:], pl[first:], ex, label,
                                  first=first))
    whole_ms = cuda_ms(whole, 10)
    slab_ms = [cuda_ms(lambda k=k: slab(k * nl, nl), 10)
               for k in range(SLABS)]
    rows_ms = cuda_ms(lambda: slab(0, n), 10)
    print(f"[{label}] {name}: {SLABS} slabs {sum(slab_ms):.4f} ms ("
          + ", ".join(f"{t:.4f}" for t in slab_ms) + f") against the whole "
          f"launch {whole_ms:.4f} ms ({sum(slab_ms) / whole_ms:.4f}x); the "
          f"row-slab form on all {n} rows {rows_ms:.4f} ms; plain "
          f"{plain_ms:.1f} ms; max_abs_err={err:.3e}", flush=True)
    return err, rows_ms, plain_ms


def row_slab_phase(disc_sorted, c5_sorted, grav_state, results, label):
    """Phase 19a: the five row-slab kernels at full size, on the sorted end
    states of phases 5 (the disc, fixed h) and 11 (config 5, variable h)
    and on the gravity sort of phase 7's end state.  Each as SLABS slabs
    (`slab_kernel`); the bound of the row-slab form on all n rows is its
    whole form's on the same state (`results`: the same rows, pairs and
    bytes).  Returns {name: (err, ms, plain_ms, bound_ms, bound_by)}."""
    from summersph_tpu_torch.ops import cuda_pairs, pm_gravity

    def rows(p, off, nl):
        return (p.map(lambda a: a[off:off + nl]), off)

    out = {}
    p2, grid, cfg = disc_sorted
    pd = cuda_pairs.pair_eval(p2, cfg, grid)[0]
    n = p2.capacity
    out["density_fixed_h_rows"] = slab_kernel(
        "density_fixed_h_rows", n,
        lambda: cuda_pairs.density_sums(p2, cfg, grid)[0],
        lambda o, k: cuda_pairs.density_sums(p2, cfg, grid,
                                             rows=rows(p2, o, k))[0],
        lambda o, k: cuda_pairs.density_sums_plain(p2, cfg, grid,
                                                   rows=rows(p2, o, k))[0],
        f"{label} disc", rtol=RHO_RTOL, atol_rel=0.0)
    out["force_fixed_h_rows"] = slab_kernel(
        "force_fixed_h_rows", n,
        lambda: cuda_pairs.force_sums(pd, cfg, grid),
        lambda o, k: cuda_pairs.force_sums(pd, cfg, grid,
                                           rows=rows(pd, o, k)),
        lambda o, k: cuda_pairs.force_sums_plain(pd, cfg, grid,
                                                 rows=rows(pd, o, k)),
        f"{label} disc")

    p2, grid, cfg = c5_sorted
    pd = cuda_pairs.pair_eval(p2, cfg, grid)[0]
    p64, pd64 = f64(p2), f64(pd)
    n = p2.capacity
    out["density_var_h_rows"] = slab_kernel(
        "density_var_h_rows", n,
        lambda: cuda_pairs.density_sums(p2, cfg, grid),
        lambda o, k: cuda_pairs.density_sums(p2, cfg, grid,
                                             rows=rows(p2, o, k)),
        lambda o, k: cuda_pairs.density_sums_plain(p2, cfg, grid,
                                                   rows=rows(p2, o, k)),
        f"{label} config 5",
        exact=lambda o, k: cuda_pairs.density_sums_plain(
            p64, cfg, grid, rows=rows(p64, o, k))[1], first=1,
        rtol=RHO_RTOL, atol_rel=0.0)
    out["force_var_h_rows"] = slab_kernel(
        "force_var_h_rows", n,
        lambda: cuda_pairs.force_sums(pd, cfg, grid),
        lambda o, k: cuda_pairs.force_sums(pd, cfg, grid,
                                           rows=rows(pd, o, k)),
        lambda o, k: cuda_pairs.force_sums_plain(pd, cfg, grid,
                                                 rows=rows(pd, o, k)),
        f"{label} config 5",
        exact=lambda o, k: cuda_pairs.force_sums_plain(
            pd64, cfg, grid, rows=rows(pd64, o, k)), first=0)

    p, cfg = grav_state
    r_s = pm_gravity.pm_geometry(p, cfg)[2]
    pos, m, h, ggrid, _, split = pm_gravity.gravity_sort(p, cfg, r_s)
    ex = (pos.double(), m.double(), h.double(), ggrid, cfg,
          tuple(v.double() for v in split))
    out["grav_short_rows"] = slab_kernel(
        "grav_short_rows", pos.shape[0],
        lambda: cuda_pairs.grav_short_sums(pos, m, h, ggrid, cfg, split),
        lambda o, k: cuda_pairs.grav_short_sums(pos, m, h, ggrid, cfg, split,
                                                rows=(o, k)),
        lambda o, k: cuda_pairs.grav_short_sums_plain(pos, m, h, ggrid, cfg,
                                                      split, rows=(o, k)),
        f"{label} pm separate grid 128",
        exact=lambda o, k: cuda_pairs.grav_short_sums_plain(*ex,
                                                            rows=(o, k)),
        first=0)
    return {name: res + tuple(results[name[:-len("_rows")]][3:5])
            for name, res in out.items()}


def by_pid(state):
    """A gathered or single-device state's particles in pid order."""
    import torch

    order = torch.argsort(state.particles.pid)
    return state.particles.map(lambda a: a[order])


def hold_sharded(ours, ref, label, against="one device"):
    """A sharded run against the single-device run from the same state
    (or another engine's run, `against`), per pid, at
    tests/test_sharding.py's tolerances (pos, vel, rho and h of the live
    particles; the alive masks equal; the sinks' mass rtol 1e-5; dt rtol
    1e-6, and t, its sum over the run's steps, too).  Prints whether every
    field is equal bit for bit."""
    import torch

    a, b = by_pid(ours), by_pid(ref)
    require(torch.equal(a.pid, b.pid) and torch.equal(a.alive, b.alive),
            f"{label}: pids or alive masks differ")
    live = b.alive
    for name, (rtol, atol) in SHARD_TOL.items():
        torch.testing.assert_close(getattr(a, name)[live],
                                   getattr(b, name)[live], rtol=rtol,
                                   atol=atol, msg=f"{label}: {name}")
    torch.testing.assert_close(ours.sinks.mass, ref.sinks.mass, rtol=1e-5,
                               atol=0.0, msg=f"{label}: sink mass")
    for name in ("t", "dt"):
        torch.testing.assert_close(getattr(ours, name), getattr(ref, name),
                                   rtol=1e-6, atol=0.0,
                                   msg=f"{label}: {name}")
    fields = ("pos", "vel", "u", "rho", "h", "acc")
    same = [f for f in fields if torch.equal(getattr(a, f), getattr(b, f))]
    bitwise = (len(same) == len(fields) and torch.equal(ours.t, ref.t)
               and torch.equal(ours.sinks.mass, ref.sinks.mass))
    print(f"[{label}] against {against}, per pid: within tests/"
          f"test_sharding.py's tolerances; bit for bit: {bitwise} (equal: "
          f"{', '.join(same) or 'none'} of {', '.join(fields)})", flush=True)


def sharded_path(state, cfg, mesh, steps, expect, label, check):
    """One gather-mode path on `mesh`: pad and shard `state`, reset the
    counts, make_sharded_prime, make_sharded_run_steps(steps) to warm up
    and again timed, read the counts and check them against `expect`;
    `check` (health) on the gathered states; then the single-device
    prime + run_steps from the same state, timed alike, and the two held
    per pid (`hold_sharded`).  Returns the launch counts."""
    import torch
    from summersph_tpu_torch.integrate import init_carries
    from summersph_tpu_torch.parallel import (gather_state,
                                              make_sharded_prime,
                                              make_sharded_run_steps,
                                              pad_state_to_devices,
                                              shard_state)

    st = shard_state(pad_state_to_devices(init_carries(state, cfg),
                                          mesh.size), mesh)
    run = make_sharded_run_steps(cfg, mesh, n_steps=steps)
    reset_counts()
    warm = run(make_sharded_prime(cfg, mesh)(st))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run(warm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    warm, out = gather_state(warm, mesh), gather_state(out, mesh)
    print(f"[{label}] gather mode on {mesh.size} rank(s), NCCL: "
          f"{wall / steps * 1e3:.3f} ms/step ({steps} steps timed) launches "
          f"{nonzero(launches)}", flush=True)
    for name, count in expect.items():
        require(launches[name] == count,
                f"{label}: {name} counted {launches[name]}, expected {count}")
    require_packs(launches, label)
    require_sinks_on_a_mesh(label, cfg.fixed_h is None)
    check(state, warm, out, label)
    _, ref, _, ref_s = time_main_path(state, cfg, steps)
    print(f"[{label}] one device, the same steps: {ref_s * 1e3:.3f} ms/step; "
          f"gather mode / one device {wall / steps / ref_s:.4f}x",
          flush=True)
    hold_sharded(out, ref, label)
    return launches


def sharded_phase(n, dev, steps_disc=4):
    """Phase 19b: gather mode on the card, D = 1 over NCCL (one H100; NCCL
    puts no two ranks of one communicator on one card): the process group
    from a HashStore, `make_mesh`, then the disc (fixed h, gravity none,
    `steps_disc` + `steps_disc` steps) and config 5 (STEPS + STEPS) at N =
    n through `sharded_path`; the group is destroyed after.  Returns
    (disc launches, config 5 launches)."""
    import torch.distributed as dist
    from summersph_tpu_torch.parallel import make_mesh

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(1)
        whole = {name: 0 for name in KERNELS if not name.endswith("_rows")
                 and name != "pack_force"}
        disc_l = sharded_path(
            *disc(n, dev), mesh, steps_disc,
            {**whole, "density_fixed_h_rows": 1 + 2 * steps_disc,
             "force_fixed_h_rows": 1 + 2 * steps_disc},
            f"N={n} gather mode disc", check_run)
        c5_l = sharded_path(
            *config5(n, dev), mesh, STEPS,
            {**whole, "density_var_h_rows": 1 + 3 * 2 * STEPS,
             "force_var_h_rows": 1 + 2 * STEPS,
             "grav_short_rows": 1 + 2 * STEPS,
             "mesh solves": 1 + 2 * len(range(0, STEPS, 4))},
            f"N={n} gather mode config 5", check_collapse)
    finally:
        dist.destroy_process_group()
    return disc_l, c5_l


# ----------------------------------------------- phase 20: slab decomposition

SLAB_HOLD, SLAB_TIMED = 2, 4   # phase 20a: steps held per pid, steps timed
# tests/test_decomp.py's tolerances (:150-162) for a slab run against one
# device: rho, u, h and P; vel
DECOMP_TOL = {"rho": (5e-6, 1e-12), "u": (5e-6, 1e-12), "h": (5e-6, 1e-12),
              "pressure": (5e-6, 1e-12), "vel": (2e-4, 1e-5)}


def hold_decomp(ours, ref, label):
    """A slab run against the single-device run from the same state, per
    pid, at tests/test_decomp.py's tolerances (and dt rtol 1e-6); prints
    the largest relative difference of each field."""
    import torch

    a, b = by_pid(ours), by_pid(ref)
    require(torch.equal(a.pid, b.pid) and torch.equal(a.alive, b.alive),
            f"{label}: pids or alive masks differ")
    live = b.alive
    worst = {}
    for name, (rtol, atol) in DECOMP_TOL.items():
        x, y = getattr(a, name)[live], getattr(b, name)[live]
        torch.testing.assert_close(x, y, rtol=rtol, atol=atol,
                                   msg=f"{label}: {name}")
        worst[name] = float(((x - y).abs() / y.abs().clamp(min=1e-30))
                            .max())
    torch.testing.assert_close(ours.dt, ref.dt, rtol=1e-6, atol=0.0,
                               msg=f"{label}: dt")
    print(f"[{label}] against one device, per pid: within tests/"
          f"test_decomp.py's tolerances; largest relative differences "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()),
          flush=True)


def slab_path(state, cfg, mesh, expect, label, check):
    """One phase-20a path: decomp='slab' on `mesh` through
    make_sharded_prime + make_sharded_run_steps(SLAB_HOLD) and
    make_sharded_run_steps(SLAB_TIMED) timed, the counts against `expect`
    (and every other pair kernel 0), `check` and the decomp and
    non-finite slots on the gathered states, the held state against one
    device per pid; then one device and gather mode timed alike from the
    same state.  Returns (the launch counts, this rank's end state, the
    slab config)."""
    import torch
    from summersph_tpu_torch.integrate import init_carries, prime, run_steps
    from summersph_tpu_torch.parallel import (comm, gather_state,
                                              make_sharded_prime,
                                              make_sharded_run_steps,
                                              pad_state_to_devices,
                                              shard_state)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) / SLAB_TIMED

    def sharded(c):
        st = shard_state(pad_state_to_devices(
            init_carries(state, c), mesh.size, max(c.sorted_block, 128)),
            mesh)
        held = make_sharded_run_steps(c, mesh, SLAB_HOLD)(
            make_sharded_prime(c, mesh)(st))
        run = make_sharded_run_steps(c, mesh, SLAB_TIMED)
        return held, run

    scfg = cfg.with_(decomp="slab")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    held, run = sharded(scfg)
    comm.reset_result_bytes()
    out, slab_s = timed(lambda: run(held))
    launches = launch_counts()
    moved = {k: v // SLAB_TIMED for k, v in comm.RESULT_BYTES.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{label}] slab mode on {mesh.size} rank(s), NCCL: "
          f"{slab_s * 1e3:.3f} ms/step ({SLAB_TIMED} steps timed) launches "
          f"{nonzero(launches)}; collective result bytes per step {moved}; "
          f"peak device memory {peak:.3f} GiB", flush=True)
    for name in list(KERNELS) + ["mesh solves", "pencil solves"]:
        if name != "pack_force":
            want = expect.get(name, 0)
            require(launches[name] == want,
                    f"{label}: {name} counted {launches[name]}, expected "
                    f"{want}")
    require_packs(launches, label)
    require_sinks_on_a_mesh(label, cfg.fixed_h is None)
    held_g, out_g = gather_state(held, mesh), gather_state(out, mesh)
    for st, what in ((held_g, "held"), (out_g, "timed")):
        d = st.stats_dict()
        require(d["decomp_pressure"] == 0 and d["nonfinite"] == 0,
                f"{label} {what}: stats {d}")
    check(state, held_g, out_g, label)
    ref = run_steps(prime(init_carries(state, cfg), cfg), cfg, SLAB_HOLD)
    hold_decomp(held_g, ref, label)
    _, one_s = timed(lambda: run_steps(ref, cfg, SLAB_TIMED))
    g_held, g_run = sharded(cfg.with_(decomp="gather"))
    _, gather_s = timed(lambda: g_run(g_held))
    print(f"[{label}] ms/step: slab {slab_s * 1e3:.3f}, one device "
          f"{one_s * 1e3:.3f}, gather mode {gather_s * 1e3:.3f} (slab / one "
          f"device {slab_s / one_s:.4f}x)", flush=True)
    return launches, out, scfg


def slab_grav_short(state, cfg, mesh, label):
    """`grav_short` as the slab decomposition launches it: whole, on the
    local [left rim | own | right rim] set that `gas_gravity_pm_decomp`
    builds, caught in one more slab step from `state` (this rank's),
    against its plain version at the step's split, timed, with its
    bound."""
    from summersph_tpu_torch.ops import pm_gravity
    from summersph_tpu_torch.parallel import make_sharded_step

    caught = []
    whole = pm_gravity.pm_short_range

    def catch(p, c, r_s, *args, **kw):
        caught.append((p, r_s))
        return whole(p, c, r_s, *args, **kw)

    pm_gravity.pm_short_range = catch
    try:
        make_sharded_step(cfg, mesh)(state)
    finally:
        pm_gravity.pm_short_range = whole
    [(local, r_s)] = caught
    print(f"[{label}] grav_short on the local set: {local.capacity} rows "
          f"({int(local.n_alive)} live)", flush=True)
    return grav_kernel(local, cfg, label, plain_reps=1, r_s=r_s)


def slab_phase(n, dev):
    """Phase 20a: the slab decomposition on the card at D = 1 over NCCL,
    the disc (fixed h, gravity none) and config 5 with pm_every 1 and
    cell_h_quantile 1, at N = n, through `slab_path`.  The slab
    decomposition takes its cell from a summed histogram's quantile, the
    one-device sort from the exact one: at config 5's 0.9 the two cells
    differ and so do the pairs the clamped rows lose, so the run that is
    held against one device sizes its cell by h_max.  Then `grav_short`
    on config 5's local set (`slab_grav_short`).  Returns (disc launches,
    config 5 launches)."""
    import torch.distributed as dist
    from summersph_tpu_torch.parallel import make_mesh

    evals = 1 + SLAB_HOLD + SLAB_TIMED
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(1)
        disc_l, _, _ = slab_path(
            *disc(n, dev), mesh,
            {"density_fixed_h_rows" + KEY_ROWS: evals,
             "force_fixed_h_rows" + KEY_ROWS: evals},
            f"N={n} slab mode disc", check_run)
        label = f"N={n} slab mode config 5"
        c5_l, c5_out, c5_cfg = slab_path(
            *config5(n, dev, pm_every=1, cell_h_quantile=1.0), mesh,
            {"density_var_h_rows" + KEY_ROWS: evals + 2 * (evals - 1),
             "force_var_h_rows" + KEY_ROWS: evals, "grav_short": evals,
             "mesh solves": evals, "pencil solves": evals},
            label, check_collapse)
        _, ms, plain_ms, bound_ms, by = slab_grav_short(c5_out, c5_cfg,
                                                         mesh, label)
        print(f"[{label}] grav_short on the local set: {ms:.4f} ms, plain "
              f"{plain_ms:.1f} ms, bound {bound_ms:.4f} ms ({by}); "
              f"{c5_l['grav_short']} launches in the slab run", flush=True)
    finally:
        dist.destroy_process_group()
    return disc_l, c5_l


def key_rows_phase(disc_sorted, c5_sorted, label):
    """Phase 20b: the four key_rows instantiations on the sorted end states
    of phases 5 (the disc) and 11 (config 5), cut into SLABS in-process
    slabs (`parallel.decomp.slabs_in_process`) with the smallest rim, a
    power of two from 8,192 rows up, that leaves no row short.  Every
    slab's launch is held against its plain version in float64
    (`hold_exact`) and, per row, against the whole-set launch within
    FORCE_ATOL_REL x max plus twice the whole launch's own error against
    float64 (the slabs' float64 sums).  Returns {name: (err, ms of the
    SLABS launches, the plain version's ms summed, bound_ms, bound_by)}."""
    import torch
    from summersph_tpu_torch.ops import cuda_pairs
    from summersph_tpu_torch.parallel.decomp import slabs_in_process

    out = {}
    for which, (p2, grid, cfg) in (("disc", disc_sorted),
                                   ("config 5", c5_sorted)):
        var = cfg.fixed_h is None
        tag = f"{label} {which}"
        pd = cuda_pairs.pair_eval(p2, cfg, grid)[0]
        h_pad = cfg.sort_h_pad if var else 1.0
        halo = 8192
        while True:
            slabs = slabs_in_process(pd, grid, cfg, SLABS, halo, h_pad)
            short = [int(sl[4]) for sl in slabs]
            if not any(short) or halo >= p2.capacity:
                break
            halo *= 2
        require(not any(short), f"{tag}: rows short of the rims {short}")
        n_cols = sum(sl[2].capacity for sl in slabs)
        print(f"[{tag}] {SLABS} slabs of {p2.capacity // SLABS} rows, rims "
              f"of halo_rows {halo} each side: rim_short 0 on every slab; "
              f"{n_cols} columns in all", flush=True)
        n_dens, n_force = sph_pair_counts(p2, grid, cfg)
        for kind in ("density", "force"):
            name = (f"{kind}_{'var' if var else 'fixed'}_h_rows"
                    + KEY_ROWS)
            sums = (cuda_pairs.density_sums if kind == "density"
                    else cuda_pairs.force_sums)
            plain = (cuda_pairs.density_sums_plain if kind == "density"
                     else cuda_pairs.force_sums_plain)
            n_out = 1 if kind == "density" and not var else None

            def launch(fn, sl, q=None):
                key, own, cols = sl[0], sl[1], sl[2]
                if q is not None:
                    own, cols = f64(own), f64(cols)
                return flat(fn(cols, cfg, sl[3], rows=(own, key)))[:n_out]

            got = [launch(sums, sl) for sl in slabs]
            pl, plain_ms = [], 0.0
            for sl in slabs:
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                pl.append(launch(plain, sl))
                stop.record()
                torch.cuda.synchronize()
                plain_ms += start.elapsed_time(stop)
            ex = [launch(plain, sl, 64) for sl in slabs]

            def cat(parts):
                return [torch.cat([q[c] for q in parts])
                        for c in range(len(parts[0]))]

            got, pl, ex = cat(got), cat(pl), cat(ex)
            err = hold_exact(name, got, pl, ex, tag)
            whole = flat(sums(pd, cfg, grid))[:n_out]
            for c, (a, w, r) in enumerate(zip(got, whole, ex)):
                tol = (FORCE_ATOL_REL * float(r.abs().max())
                       + 2 * float((w.double() - r).abs().max()))
                torch.testing.assert_close(
                    a, w, rtol=FORCE_RTOL, atol=tol,
                    msg=f"{name} output {c}: against the whole launch "
                    f"({tag})")
            ms = sum(cuda_ms(lambda sl=sl: launch(sums, sl), 10)
                     for sl in slabs)
            whole_ms = cuda_ms(lambda: sums(pd, cfg, grid), 10)
            print(f"[{tag}] {name}: against the whole-set launch per row "
                  f"within rtol {FORCE_RTOL:g}; {SLABS} slabs {ms:.4f} ms "
                  f"against the whole launch {whole_ms:.4f} ms; plain "
                  f"{plain_ms:.1f} ms; max_abs_err={err:.3e}", flush=True)
            pairs = n_dens if kind == "density" else n_force
            ops = pairs * ((OPS_DENSITY_VAR if var else OPS_DENSITY)
                           if kind == "density"
                           else (OPS_FORCE_VAR if var else OPS_FORCE))
            out[name] = (err, ms, plain_ms) + bound_key_rows(
                name, p2.capacity, n_cols, grid.starts.shape[0], ops)
    return out


def dense_phase(dev, n=DENSE_N):
    """Phase 19c: the dense O(N^2) oracle on the card.  On the disc (fixed
    h) and on config 5's collapse sphere after one h-iteration (variable
    h, the sort's cell at 2 h_max so that its windows hold every pair), both
    at N = n: the sorted kernels (`density_*`, `force_*` through
    `cuda_pairs.density` / `forces`) against `compute_density` /
    `compute_sph_forces` on the same sorted rows, rho within RHO_RTOL,
    with variable h Omega and the forces against the dense pass in float64
    (`hold_exact`); then one `neighbor_mode='dense'` step of the disc
    against the sorted step, per pid.  Prints the dense passes' times."""
    import torch
    from summersph_tpu_torch.integrate import prime, step
    from summersph_tpu_torch.ops import cuda_pairs
    from summersph_tpu_torch.ops.density import compute_density
    from summersph_tpu_torch.ops.eos import eos_update
    from summersph_tpu_torch.ops.forces import compute_sph_forces
    from summersph_tpu_torch.ops.smoothing import update_smoothing
    from summersph_tpu_torch.ops.sorted_grid import sort_particles

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        res = fn()
        stop.record()
        torch.cuda.synchronize()
        return res, start.elapsed_time(stop)

    for what in ("disc", "collapse"):
        label = f"N={n} dense oracle {what}"
        if what == "disc":
            state, cfg = disc(n, dev)
            p2, grid = sort_particles(state.particles, cfg)
        else:
            state, cfg = config5(n, dev, cell_h_quantile=1.0)
            p, _ = update_smoothing(state.particles, cfg)
            p2, grid = sort_particles(p, cfg, h_pad=cfg.sort_h_pad)
        require(int(grid.n_clamped) == 0, f"{label}: {int(grid.n_clamped)} "
                f"rows reach past the sort's cell")
        kd = eos_update(cuda_pairs.density(p2, cfg, grid), cfg)
        dd, d_ms = timed(lambda: eos_update(compute_density(p2, cfg), cfg))
        kf = cuda_pairs.forces(kd, cfg, grid)
        df, f_ms = timed(lambda: compute_sph_forces(kd, cfg))
        hold("density", [kd.rho], [dd.rho], label, rtol=RHO_RTOL,
             atol_rel=0.0)
        if what == "disc":
            hold("force", list(kf), list(df), label)
        else:
            d64 = compute_density(f64(p2), cfg)
            hold_exact("density (Omega)", [kd.omega], [dd.omega],
                       [d64.omega], label)
            hold_exact("force", list(kf), list(df),
                       list(compute_sph_forces(f64(kd), cfg)), label)
        print(f"[{label}] dense density pass {d_ms:.3f} ms, dense force pass "
              f"{f_ms:.3f} ms ({n} x {n} pairs)", flush=True)
    state, cfg = disc(n, dev)
    dcfg = cfg.with_(neighbor_mode="dense")
    ref = step(prime(state, cfg), cfg)
    primed, p_ms = timed(lambda: prime(state, dcfg))
    out, s_ms = timed(lambda: step(primed, dcfg))
    label = f"N={n} dense step"
    require(not any(out.stats.tolist()), f"{label}: stats {out.stats_dict()}")
    hold_sharded(out, ref, label, against="the sorted step")
    print(f"[{label}] dense prime {p_ms:.3f} ms, dense step {s_ms:.3f} ms",
          flush=True)


# ------------------------------------------------ phase 21: the bench entry point

BENCH_KEYS = ["metric", "value", "unit", "vs_baseline", "platform",
              "utilization", "sweep"]


@contextlib.contextmanager
def bench_env(**knobs):
    """os.environ without any BENCH_* knob but `knobs`, restored after."""
    import os

    saved = {k: v for k, v in os.environ.items() if k.startswith("BENCH_")}
    for k in saved:
        del os.environ[k]
    os.environ.update(knobs)
    try:
        yield
    finally:
        for k in [k for k in os.environ if k.startswith("BENCH_")]:
            del os.environ[k]
        os.environ.update(saved)


def bench_lines(text, label):
    """The JSON lines `bench` printed, each with bench.py's keys in order."""
    lines = [json.loads(line) for line in text.splitlines()]
    require(lines, f"{label}: no line printed")
    for line in lines:
        require(list(line) == BENCH_KEYS, f"{label}: keys {list(line)}")
    return lines


def finite_rate(x):
    import math

    return isinstance(x, float) and math.isfinite(x) and x > 0.0


def bench_phase(n, rate_none, card):
    """Phase 21: `summersph_tpu_torch.bench.main([])` in this process, the
    bench knobs at their defaults and the wall budget wide enough for
    every cell: the headline and bench.py's four sweep cells, their lines
    parsed and checked, the launches of the whole run counted, the
    headline within 0.5-2x phase 5's rate on the same config; then
    `python -m summersph_tpu_torch bench --steps 2` with BENCH_SWEEP=0 as
    a user would run it."""
    import io
    import os
    from summersph_tpu_torch import bench

    label = f"N={n} bench"
    buf = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with bench_env(BENCH_BUDGET_S="1e9"), contextlib.redirect_stdout(buf):
        rc = bench.main([])
    launches = launch_counts()
    for line in buf.getvalue().splitlines():
        print(f"[{label}] {line}", flush=True)
    require(rc == 0, f"{label}: exit code {rc}")
    lines = bench_lines(buf.getvalue(), label)
    head, last = lines[0], lines[-1]
    require(head["sweep"] == {} and head["platform"] == "gpu"
            and finite_rate(head["value"]),
            f"{label}: headline line {head}")
    cells = bench.sweep_cells(n)
    labels = [bench.cell_label(*cell) for cell in cells]
    require(list(last["sweep"]) == labels
            and all(finite_rate(v) for v in last["sweep"].values()),
            f"{label}: sweep {last['sweep']}")
    per_run = 1 + 2 * STEPS
    solves = sum(1 + 2 * len(range(0, STEPS, spe))
                 for _, sg, spe in cells if sg == "pm")
    expect = {"density_fixed_h": 5 * per_run, "force_fixed_h": 2 * per_run,
              "force_fixed_h_grav": 3 * per_run,
              "pack_force": 5 * per_run, "mesh solves": solves}
    require(nonzero(pair_launches(launches)) == expect,
            f"{label}: launches {nonzero(launches)}, expected {expect}")
    require_packs(launches, label)
    ratio = head["value"] / rate_none
    require(0.5 <= ratio <= 2.0, f"{label}: headline {head['value']:.6e} is "
            f"{ratio:.3f}x phase 5's {rate_none:.6e}")
    print(f"[{label}] {time.perf_counter() - t0:.1f} s; launches "
          f"{nonzero(launches)}; headline {ratio:.4f}x phase 5's rate",
          flush=True)
    for what, rate in {"headline": head["value"], **last["sweep"]}.items():
        print(f"[{label}] {card}: {what} {rate:.6e} particle-steps/s",
              flush=True)

    with bench_env(BENCH_SWEEP="0"):
        run = subprocess.run(
            [sys.executable, "-m", "summersph_tpu_torch", "bench",
             "--steps", "2"], capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)))
    for line in run.stdout.splitlines():
        print(f"[{label} CLI] {line}", flush=True)
    require(run.returncode == 0, f"{label} CLI: exit code "
            f"{run.returncode}: {run.stderr[-2000:]}")
    [line] = bench_lines(run.stdout, f"{label} CLI")
    require(line["platform"] == "gpu" and finite_rate(line["value"]),
            f"{label} CLI: {line}")


# ---------------------------------- phase 22: reproducible TreePM runs
REPRO_STEPS = 10   # phase 22a: steps of each run from one state


def float_deposit(pos, mass, origin, cell, n, dtype=None):
    """The CIC deposit as one float `index_add_` of the 8 corners: the
    port's form before its fixed point, on the card an atomic add whose
    order changes from run to run.  Kept here only as the yardstick of
    `pm_gravity._cic_deposit`.  With `dtype` the same corner values are
    summed in that dtype."""
    import torch
    from summersph_tpu_torch.ops.pm_gravity import _cic_corners

    flat, w = zip(*_cic_corners(pos, origin, cell, n))
    vals = torch.cat([mass * wx for wx in w]).to(dtype or mass.dtype)
    rho = torch.zeros(n * n * n, dtype=vals.dtype, device=mass.device)
    rho.index_add_(0, torch.cat(flat), vals)
    return rho.reshape(n, n, n)


def differing_fields(a, b):
    """The fields of two states (particles, sinks, t, dt, stats, pm_r_s)
    that differ in any bit; [] when the states are equal."""
    from summersph_tpu_torch.state import to_numpy

    def fields(state):
        d = to_numpy(state)
        out = {f"{g}.{k}": v for g in ("particles", "sinks")
               for k, v in d.pop(g).items()}
        out.update(d)
        return out

    fa, fb = fields(a), fields(b)
    return sorted(k for k in fa.keys() | fb.keys()
                  if k not in fa or k not in fb
                  or fa[k].dtype != fb[k].dtype or fa[k].shape != fb[k].shape
                  or fa[k].tobytes() != fb[k].tobytes())


def rerun_bitwise(state, cfg, label, steps=REPRO_STEPS):
    """prime, then run_steps(steps) twice from copies of the primed state;
    the two end states must be equal bit for bit.  Returns one of them."""
    from summersph_tpu_torch.integrate import prime, run_steps
    from summersph_tpu_torch.state import from_numpy, to_numpy

    start = to_numpy(prime(state, cfg))
    dev = state.particles.pos.device
    outs = [run_steps(from_numpy(start, dev), cfg, steps) for _ in range(2)]
    diff = differing_fields(*outs)
    require(not diff, f"{label}: two runs from one state differ in {diff}")
    print(f"[{label}] two runs of {steps} steps from one primed state: "
          f"equal bit for bit in every field", flush=True)
    return outs[0]


def deposit_check(p, cfg, label):
    """The fixed-point deposit on `p` at cfg's grid: two calls equal bit
    for bit; its time beside the float `index_add_` (CUDA events, mean of
    10 calls); both against the float64 sum of the same corner values;
    whether two float `index_add_`s are equal (printed)."""
    import torch
    from summersph_tpu_torch.ops import pm_gravity

    n = cfg.grav_grid
    origin, cell, _ = pm_gravity.pm_geometry(p, cfg)
    m = torch.where(p.alive, p.mass, 0.0)

    def fixed():
        return pm_gravity._cic_deposit(p.pos, m, origin, cell, n)

    def old():
        return float_deposit(p.pos, m, origin, cell, n)

    a, b = fixed(), fixed()
    require(torch.equal(a.view(torch.int32), b.view(torch.int32)),
            f"{label}: two fixed-point deposits differ")
    c, d = old(), old()
    exact = float_deposit(p.pos, m, origin, cell, n, torch.float64)
    scale = float(exact.abs().max())
    ms, old_ms = cuda_ms(fixed, 10), cuda_ms(old, 10)
    print(f"[{label}] CIC deposit, grid {n}, N={p.capacity}: fixed point "
          f"{ms:.4f} ms, float index_add_ {old_ms:.4f} ms "
          f"({ms / old_ms:.3f}x); two fixed-point deposits equal bit for "
          f"bit; two index_add_ deposits equal: {torch.equal(c, d)} (max "
          f"difference {float((c - d).abs().max()):.3e}); against the "
          f"float64 sum, max |difference| / max: fixed point "
          f"{float((a.double() - exact).abs().max()) / scale:.3e}, "
          f"index_add_ {float((c.double() - exact).abs().max()) / scale:.3e}",
          flush=True)


def config5_segments(n, dev, label, steps_per_seg=16):
    """Phase 22b: `tools.config5.run` in a temporary directory, 3 segments
    uninterrupted, and 2 segments, the checkpoint, then 1 resumed segment:
    the two end checkpoints equal bit for bit in every field, both
    15-column ledgers equal but for the wall column.  Returns the launch
    counts of the three runs."""
    import csv
    import os
    import tempfile
    from summersph_tpu_torch.io.checkpoint import load_npz
    from summersph_tpu_torch.tools import config5

    kw = dict(steps_per_seg=steps_per_seg, device=dev, n=n)
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        whole, split = os.path.join(tmp, "whole"), os.path.join(tmp, "split")
        for out, fresh, segs in ((whole, True, 3), (split, True, 2),
                                 (split, False, 1)):
            code = config5.run(out, fresh=fresh, max_segments=segs, **kw)
            require(code == 0, f"{label}: config5.run exit code {code}")
        launches = launch_counts()
        diff = differing_fields(
            *(load_npz(os.path.join(d, "checkpoint.npz"), device="cpu")
              for d in (whole, split)))
        require(not diff, f"{label}: the resumed run differs from the "
                f"uninterrupted one in {diff}")
        ledgers = []
        for d in (whole, split):
            with open(os.path.join(d, "ledger.csv")) as fh:
                ledgers.append(list(csv.reader(fh)))
    for rows in ledgers:
        require(len(rows) == 4 and rows[0] == config5.LEDGER_COLUMNS
                and all(len(r) == 15 for r in rows),
                f"{label}: ledger {rows}")
    require([r[:-1] for r in ledgers[0]] == [r[:-1] for r in ledgers[1]],
            f"{label}: ledgers differ: {ledgers}")
    wall = sum(float(r[-1]) for r in ledgers[0][1:])
    print(f"[{label}] 2 segments + checkpoint + 1 resumed segment equal 3 "
          f"uninterrupted segments bit for bit in every field; ledger rows "
          f"equal but for wall_s; {wall / (3 * steps_per_seg) * 1e3:.1f} ms "
          f"a step (the ledger's wall column); launches "
          f"{nonzero(launches)}", flush=True)
    return launches


# ------------------------------- phase 23: the graded configurations 1-4
EVIDENCE_SEGMENTS = 2   # phase 23a: segments of 64 steps of each run
EVIDENCE_ROW_TOL = 1e-3   # E_kin, E_int, Lz against the JAX ledger's rows
SOD_L2, SOD_L2_BOUND = 0.01383, 5e-4   # docs/results/sod/README.md, n = 400


def evidence_expect(name, steps):
    """The launches of `tools.evidence` on `name`: one prime and `steps`
    steps, a force launch and its pack each, the density once (fixed h)
    or 1 + 2 h re-sums (variable h), with TreePM one short-range launch
    and one mesh solve (pm_every 1)."""
    one = 1 + steps
    if name == "varh":
        expect = {"density_var_h": 1 + 3 * steps, "force_var_h": one}
    else:
        expect = {"density_fixed_h": one, "force_fixed_h": one}
    expect["pack_force"] = one
    if name != "ring":
        expect.update({"grav_short": one, "mesh solves": one})
    return expect


def evidence_phase(dev, card, seg=64):
    """Phase 23a: `tools.evidence.run_config` for ring, disc100 and varh at
    full N in a temporary directory, EVIDENCE_SEGMENTS segments of `seg`
    steps each: exit code 0 (check_health passed after every segment),
    the launches of each run (counts reset just before, read just after)
    as `evidence_expect` says, both ledger rows' n_gas equal to the JAX
    ledger's first two and E_kin, E_int, Lz within EVIDENCE_ROW_TOL of it
    at matching t (`config5.compare`, the reference with the run's t0 row
    in front, `evidence.jax_reference`); the ms a step beside the card;
    then the span table of 5 more steps."""
    import os
    import tempfile
    import numpy as np
    from summersph_tpu_torch.tools import config5, evidence

    steps = EVIDENCE_SEGMENTS * seg
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("ring", "disc100", "varh"):
            label = f"{name} evidence"
            out = os.path.join(tmp, name)
            reset_counts()
            state, cfg, code = evidence.run_config(
                name, seg_steps=seg, device=dev, out_dir=out,
                max_segments=EVIDENCE_SEGMENTS)
            launches = launch_counts()
            require(code == 0, f"{label}: exit code {code}")
            expect = evidence_expect(name, steps)
            require(nonzero(pair_launches(launches)) == expect,
                    f"{label}: launches {nonzero(launches)}, expected "
                    f"{expect}")
            led = config5.read_ledger(os.path.join(out, "ledger.csv"))
            z = np.load(os.path.join(out, "panels.npz"))
            ref = evidence.jax_reference(
                name, dict(zip(config5.LEDGER_COLUMNS, z["row0"])))
            require(len(led["t"]) == EVIDENCE_SEGMENTS
                    and np.array_equal(led["n_gas"], ref["n_gas"][1:3]),
                    f"{label}: n_gas {led['n_gas']} against the JAX "
                    f"ledger's {ref['n_gas'][1:3]}")
            span = (0.0, float(led["t"][-1]))
            dev_rows = config5.compare(led, ref, [span],
                                       ("E_kin", "E_int", "Lz"))[span]
            require(dev_rows.pop("rows") == EVIDENCE_SEGMENTS
                    and all(v <= EVIDENCE_ROW_TOL
                            for v in dev_rows.values()),
                    f"{label}: against the JAX ledger {dev_rows}")
            ms = float(np.median(z["seg_wall"])) / seg * 1e3
            print(f"[{label}] N={int(z['n0'])}, {EVIDENCE_SEGMENTS} segments"
                  f" of {seg} steps to t={float(led['t'][-1]):.6f}: n_gas "
                  f"{led['n_gas'].astype(int).tolist()} as the JAX "
                  f"ledger's; largest relative deviation from it "
                  f"{ {k: f'{v:.3e}' for k, v in dev_rows.items()} }; "
                  f"check_health passed; launches {nonzero(launches)}; "
                  f"{ms:.3f} ms a step (median segment) on {card}; SPH "
                  f"candidates tested per row "
                  f"{z['tested_per_row'].round(1).tolist()}", flush=True)
            span_table(state, cfg, 5, label)


def sod_phase(dev, card, n=400):
    """Phase 23b: `tools.sod_evidence.run_case` at n on 'grid' and on
    'sorted': the L2 within SOD_L2_BOUND of SOD_L2 (run_case raises when
    a particle is lost), the launches (density_fixed_h, force_fixed_h and
    pack_force, equal counts, nothing else), the wall; then the span
    table of 5 steps from the ICs."""
    from summersph_tpu_torch.models.sod import sod_ic
    from summersph_tpu_torch.tools import sod_evidence

    for mode in ("grid", "sorted"):
        label = f"Sod n={n} {mode}"
        reset_counts()
        err, wall = sod_evidence.run_case(n, mode, dev)
        launches = nonzero(pair_launches(launch_counts()))
        k = launches.get("density_fixed_h", 0)
        require(k > 0 and launches == {"density_fixed_h": k,
                                       "force_fixed_h": k, "pack_force": k},
                f"{label}: launches {launches}")
        require(abs(err - SOD_L2) <= SOD_L2_BOUND,
                f"{label}: L2 {err} against {SOD_L2}")
        print(f"[{label}] L2 {err:.6f} (JAX package {SOD_L2}, bound "
              f"{SOD_L2_BOUND}), all {n} alive, {wall:.3f} s to t = 0.1 "
              f"({k} steps, {wall / k * 1e3:.3f} ms a step) on {card}; "
              f"launches {launches}", flush=True)
        cfg = sod_evidence.case_config(n, mode)
        span_table(sod_ic(n=n, cfg=cfg, device=dev)[0], cfg, 5, label)


# ---------------------------------------------------- phase 24: the sink layers
SINK_REPS = 20         # calls of the layer timed with CUDA events
SINK_LIVE_MS = 2.0     # the layer's ceiling a step with 128 live slots
# the fields each call copies or decides, held exactly (every integer and
# bool field too); the others are sums, held by `hold_exact`
SINK_EXACT = {"sink_gravity": (),
              "create_sinks": ("0.",),
              "accrete": ("0.", "1.alive", "1.radius", "1.acc"),
              "merge_sinks": ("0.alive", "0.radius", "0.acc")}


def sink_calls(p, s, cfg, plain=False):
    """name -> a call of each sink layer of a config 5 step on (p, s): the
    public functions, or with `plain` their plain versions."""
    from summersph_tpu_torch.ops import gravity, sinks

    tail = "_plain" if plain else ""
    return {
        "sink_gravity": lambda: getattr(gravity, "sink_gravity" + tail)(p, s),
        "create_sinks": lambda: getattr(sinks, "create_sinks" + tail)(
            p, s, cfg),
        "accrete": lambda: getattr(sinks, "accrete" + tail)(p, s),
        "merge_sinks": lambda: getattr(sinks, "merge_sinks" + tail)(s, cfg)}


def named_fields(out):
    """(name, tensor) of every tensor of a sink call's result."""
    got = []
    for k, x in enumerate(out):
        if hasattr(x, "__dataclass_fields__"):
            got += [(f"{k}.{f}", getattr(x, f)) for f in x.__dataclass_fields__
                    if getattr(x, f) is not None]
        else:
            got.append((str(k), x))
    return got


def sink_checks(p, s, cfg, label):
    """Each sink call's kernels against its plain version on (p, s): the
    fields of SINK_EXACT and every integer and bool equal, the sums by
    `hold_exact` against the plain version in float64; two launches equal
    bit for bit.  Returns {call: the largest |kernel - plain| of its
    sums}."""
    import torch

    kernel, plain = sink_calls(p, s, cfg), sink_calls(p, s, cfg, plain=True)
    exact64 = sink_calls(f64(p), f64(s), cfg, plain=True)
    errs = {}
    for name in kernel:
        a, b = named_fields(kernel[name]()), named_fields(kernel[name]())
        q, r = named_fields(plain[name]()), named_fields(exact64[name]())
        torch.cuda.synchronize()
        require([k for k, _ in a] == [k for k, _ in q],
                f"{label}: {name} fields {[k for k, _ in a]}")
        for (k, x), (_, y) in zip(a, b):
            require(torch.equal(x, y),
                    f"{label}: {name} {k}: two launches differ")
        same, errs[name] = [], 0.0
        for (k, x), (_, y), (_, z) in zip(a, q, r):
            if not x.is_floating_point() or any(
                    k == e or (e.endswith(".") and k.startswith(e))
                    for e in SINK_EXACT[name]):
                require(torch.equal(x, y), f"{label}: {name} {k} differs "
                        f"from the plain version")
                same.append(k)
            else:
                errs[name] = max(errs[name], hold_exact(
                    f"{name} {k}", [x], [y], [z], label))
        print(f"[{label}] {name}: equal to the plain version {same}; two "
              f"launches bit for bit", flush=True)
    return errs


def sink_kernel_ms(p, s, cfg):
    """Device ms of each sink kernel a call of the layer, from the
    profiler's kernel events over SINK_REPS calls (None where it saw no
    device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    layer = sink_calls(p, s, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(SINK_REPS):
            for call in layer.values():
                call()
        torch.cuda.synchronize()
    us = dict.fromkeys(SINK_KERNELS, 0.0)
    for e in prof.events():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        for name in SINK_KERNELS:
            if f"{name}_kernel<" in e.name:
                us[name] += e.time_range.end - e.time_range.start
    return {k: (v * 1e-3 / SINK_REPS if v else None) for k, v in us.items()}


# the call each sink kernel belongs to, and the JAX package's function
# whose masked [S, N] (or [S, S]) array operations it replaces
SINK_OF = {"sink_gravity_pass": "sink_gravity",
           "sink_gravity_reduce": "sink_gravity",
           "create_sinks_pass": "create_sinks",
           "create_sinks_pick": "create_sinks",
           "accrete_pass": "accrete", "accrete_reduce": "accrete",
           "merge_sinks": "merge_sinks"}
SINK_REPLACES = {"sink_gravity": "summersph_tpu/ops/gravity.py sink_gravity",
                 "create_sinks": "summersph_tpu/ops/sinks.py create_sinks",
                 "accrete": "summersph_tpu/ops/sinks.py accrete",
                 "merge_sinks": "summersph_tpu/ops/sinks.py merge_sinks"}


def sink_bound_ms(p, s, cfg):
    """{kernel: (bound_ms, bound_by)}: the least time of each sink kernel
    on (p, s), the larger of its bytes (each field it reads once, each it
    writes once) over 3.35 TB/s and its FP32 operations over 67 TFLOP/s.
    Operations on the pairs each kernel evaluates: sink_gravity_pass ~25
    on every row and live slot; accrete_pass ~10 on every live row and
    live, massive slot; create_sinks_pass the code density (5) on every
    live row and the near-sink test (~10) on the rows above the threshold
    and the live, massive slots, whose positions alone it reads; merging
    ~10 on the pairs of live, massive slots.  The one-block kernels'
    bytes are the partials they sum and the slots they read and write."""
    import torch
    from summersph_tpu_torch.ops import cuda_sinks

    n, S, b = p.capacity, s.capacity, p.pos.element_size()
    live = int(s.alive.sum())
    real = int((s.alive & (s.mass > 0.0)).sum())
    rows = int(p.alive.sum())
    code = torch.where(p.alive, p.mass * (cfg.eta / p.h) ** 3, 0.0)
    above = int((p.alive & (code > cfg.sink_create_density)).sum())
    nb_grav = cuda_sinks.blocks(n, cuda_sinks.GRAV_TILE)
    nb_acc = cuda_sinks.blocks(n, cuda_sinks.BLOCK)
    nb_create = cuda_sinks.blocks(n, cuda_sinks.BLOCK,
                                  cuda_sinks.CREATE_MAX_BLOCKS)
    work = {   # (bytes, FP32 operations)
        "sink_gravity_pass": (n * (3 * b + b + 1 + 3 * b), n * live * 25),
        "sink_gravity_reduce": (nb_grav * live * 3 * b + S * (4 * b + 1)
                                + S * 3 * b, 0),
        "create_sinks_pass": (n * (b + b + 1) + above * 3 * b
                              + nb_create * (b + 4),
                              rows * 5 + above * real * 10),
        "create_sinks_pick": (nb_create * (b + 4) + 2 * S * (14 * b + 1), 0),
        "accrete_pass": (2 * n * (3 * b + 3 * b + b + 1)
                         + nb_acc * real * 10 * b, rows * real * 10),
        "accrete_reduce": (nb_acc * real * 10 * b + S * (11 * b + 1)
                           + S * 10 * b, 0),
        "merge_sinks": (2 * S * (11 * b + 1), real * real * 10)}
    out = {}
    for name, (nbytes, ops) in work.items():
        t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_FP32
        out[name] = (max(t_bytes, t_ops) * 1e3,
                     "bytes" if t_bytes >= t_ops else "operations")
    return out


SINK_LIVE = " (128 live)"   # the name suffix of phase 24's all-live rows


def sink_phase(n, dev):
    """Phase 24: the sink layers at N = n on config 5's ICs, with its own
    slots and with all 128 live and massive.  Returns {kernel: (err, ms,
    plain_ms, bound_ms, bound_by)}, the all-live rows under names ending
    in SINK_LIVE; plain_ms, the plain version of the kernel's call, on
    its particle pass (on merge_sinks, its one kernel), None on the
    others."""
    import torch

    state, cfg = config5(n, dev)
    p, s0 = state.particles, state.sinks
    S = s0.capacity
    gen = torch.Generator(device="cpu").manual_seed(24)
    rows = torch.nonzero(p.alive)[:, 0].cpu()
    rows = rows[torch.randperm(rows.numel(), generator=gen)[:S]].to(dev)
    s_live = s0.replace(
        pos=p.pos[rows].clone(), vel=p.vel[rows].clone(),
        mass=torch.full_like(s0.mass, 1.0e-3), radius=2.0 * p.h[rows],
        alive=torch.ones_like(s0.alive))
    code = torch.where(p.alive, p.mass * (cfg.eta / p.h) ** 3, 0.0)
    cfg_live = cfg.with_(sink_create_density=float(
        torch.quantile(code[p.alive].double().cpu(), 0.999)))
    layer_ms, results = {}, {}
    for what, s, c, suffix in (("config 5's slots", s0, cfg, ""),
                               (f"{S} slots live", s_live, cfg_live,
                                SINK_LIVE)):
        label = f"N={n} sinks, {what}"
        live = int(s.alive.sum())
        errs = sink_checks(p, s, c, label)
        kernel = sink_calls(p, s, c)
        plain = sink_calls(p, s, c, plain=True)
        reset_counts()
        for call in kernel.values():
            call()
        torch.cuda.synchronize()
        launched = sink_launches()
        ms = cuda_ms(lambda: [call() for call in kernel.values()],
                     SINK_REPS)
        plain_each = {name: cuda_ms(call, 2) for name, call in plain.items()}
        plain_ms = sum(plain_each.values())
        each = sink_kernel_ms(p, s, c)
        bound = sink_bound_ms(p, s, c)
        layer_ms[what] = ms
        print(f"[{label}] {live} of {S} slots live: layer {ms:.4f} ms a "
              f"step, plain {plain_ms:.3f} ms ({plain_ms / ms:.1f}x; "
              f"{ {k: round(v, 4) for k, v in plain_each.items()} }); "
              f"{sum(launched.values())} launches a step {launched}",
              flush=True)
        for name in SINK_KERNELS:
            got, (b_ms, b_by) = each[name], bound[name]
            print(f"[{label}] {name}: "
                  + (f"{got:.4f} ms" if got is not None else "not measured")
                  + f", bound {b_ms:.6f} ms ({b_by})"
                  + (f", {100.0 * b_ms / got:.2f}% of it" if got else ""),
                  flush=True)
            call = SINK_OF[name]
            first = name.endswith("_pass") or name == "merge_sinks"
            results[name + suffix] = (errs[call], got,
                                      plain_each[call] if first else None,
                                      b_ms, b_by)
    require(layer_ms[f"{S} slots live"] < SINK_LIVE_MS,
            f"the sink layer with {S} live slots took "
            f"{layer_ms[f'{S} slots live']:.3f} ms a step, over "
            f"{SINK_LIVE_MS} ms")
    return results


# ------------------------------------------------- phase 25: the mesh gradient
FD4_REPS = 10          # calls of each gradient timed with CUDA events


def gradient_input(p, cfg):
    """(phi, cell, lead): what one `pm_long_range` solve on p hands to
    `fd4_gradient`, captured from the solve itself."""
    from summersph_tpu_torch.ops import pm_gravity as pm

    seen, real = [], pm.fd4_gradient

    def record(phi, cell, n, lead=0):
        seen.append((phi, cell, lead))
        return real(phi, cell, n, lead)

    pm.fd4_gradient = record
    try:
        pm.pm_long_range(p, cfg)
    finally:
        pm.fd4_gradient = real
    require(len(seen) == 1, f"{len(seen)} gradient calls in one solve")
    return seen[0]


def roll_form():
    """The yardstick: `roll_form` of tests/test_torch_pm_mesh_kernel.py,
    the gradient as the port computed it before `fd4_gradient` (4
    torch.rolls a component over the whole padded cube, then the crop to
    n^3 and the stack to [n, n, n, 3])."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "test_torch_pm_mesh_kernel.py")
    spec = importlib.util.spec_from_file_location("pm_mesh_kernel_tests",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.roll_form


def fd4_bound_ms(n, itemsize):
    """The least time of the gradient on an n^3 mesh: the n^3 kept cells
    and the 12 n^2 cells of the stencil's ring read once, the 3 n^3
    components written once, over 3.35 TB/s."""
    return (4 * n ** 3 + 12 * n ** 2) * itemsize / PEAK_BYTES * 1e3


def ptxas_usage(source, kernel):
    """{mangled entry point: its ptxas 'Used ...' line} of the entry points
    of csrc/<source>.cu whose names hold `kernel`."""
    from summersph_tpu_torch.utils import build

    usage, entry = {}, None
    for line in build.build_log(source).splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if kernel in line else None
        elif entry and "Used" in line:
            usage[entry] = line.split(":", 1)[1].strip()
            entry = None
    return usage


def fd4_phase(n, dev):
    """Phase 25: `fd4_gradient` on the potential that one solve of config
    5's grid-128 mesh and of the self-gravitating disc's grid-256 mesh at
    N = n hands it.  Returns {grid: (err, ms, plain_ms, bound_ms,
    bound_by, roll_ms)}."""
    import torch
    from summersph_tpu_torch.ops import pm_gravity as pm

    for entry, used in ptxas_usage("pm_mesh", "fd4_gradient").items():
        print(f"[fd4_gradient] ptxas {entry}: {used}", flush=True)
    roll_gradient, results = roll_form(), {}
    for what, (state, cfg) in (
            ("config 5 grid 128", config5(n, dev)),
            ("disc_sg grid 256", disc(n, dev, gravity="pm", grav_grid=256))):
        g = cfg.grav_grid
        label = f"N={n} {what}"
        phi, cell, lead = gradient_input(state.particles, cfg)
        require(lead == 0 and phi.shape == (2 * g,) * 3,
                f"{label}: the solve's gradient took a {tuple(phi.shape)} "
                f"cube at lead {lead}, not the fd path's padded cube")
        reset_counts()
        got = pm.fd4_gradient(phi, cell, g)
        again = pm.fd4_gradient(phi, cell, g)
        torch.cuda.synchronize()
        require(pm.fd4_gradient_cuda.launches == 2,
                f"{label}: {pm.fd4_gradient_cuda.launches} kernel launches "
                f"for 2 calls")
        require(torch.equal(got, again), f"{label}: two launches differ")
        require(torch.equal(got, pm.fd4_gradient_plain(phi, cell, g)),
                f"{label}: fd4_gradient differs from its plain version")
        require(torch.equal(got, roll_gradient(phi, cell, g)),
                f"{label}: fd4_gradient differs from the roll form")
        ms = cuda_ms(lambda: pm.fd4_gradient(phi, cell, g), FD4_REPS)
        plain_ms = cuda_ms(lambda: pm.fd4_gradient_plain(phi, cell, g),
                           FD4_REPS)
        roll_ms = cuda_ms(lambda: roll_gradient(phi, cell, g), FD4_REPS)
        bound = fd4_bound_ms(g, phi.element_size())
        print(f"[{label}] fd4_gradient: {ms:.4f} ms a call, bound "
              f"{bound:.4f} ms (bytes, {100.0 * bound / ms:.1f}% of it); "
              f"plain {plain_ms:.3f} ms, roll form {roll_ms:.3f} ms "
              f"({roll_ms / ms:.1f}x the kernel); equal to both bit for "
              f"bit, two launches equal; max |F| "
              f"{float(got.abs().max()):.6e}", flush=True)
        results[g] = (0.0, ms, plain_ms, bound, "bytes", roll_ms)
        del phi, got, again
        reset_counts()
    return results


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "smoke run needs a CUDA card")

    from summersph_tpu_torch.ops.sorted_grid import sort_particles
    from summersph_tpu_torch.utils import build

    t_start = time.perf_counter()
    phase_t = [t_start]

    def phase_done(name):
        now = time.perf_counter()
        print(f"== phase {name}: {now - phase_t[0]:.1f} s "
              f"(total {now - t_start:.1f} s)", flush=True)
        phase_t[0] = now

    # -- phase 1: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 2: build the kernels from csrc/ (one nvcc a source)
    for source in ("sph_pairs", "sinks", "pm_mesh"):
        lib = build.build(source)
        print(f"built {lib.name}", flush=True)
        for line in build.build_log(source).splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("  ptxas:", line.strip())
    dev = torch.device("cuda", 0)
    phase_done("card + build")

    # -- phase 3: N = 131,072, SPH kernels vs plain and the main path
    n_small = 131072
    state, cfg = disc(n_small, dev)
    p2, grid = sort_particles(state.particles, cfg)
    label = f"N={n_small}"
    sph_kernels(p2, grid, cfg, label)
    _, out_s, rate_s, step_s = time_main_path(state, cfg)
    require(not any(out_s.stats.tolist()), f"stats {out_s.stats_dict()}")
    print(f"[{label}] main path: {rate_s:.6e} particle-steps/s "
          f"({step_s * 1e3:.3f} ms/step, {STEPS} steps timed)", flush=True)
    phase_done("3 (N=131072, gravity none)")

    # -- phase 4: N = 131,072, the gravity kernels vs plain
    st256, cfg256 = disc(n_small, dev, gravity="pm", grav_grid=256,
                         pm_every=8)
    p2, grid = sort_particles(st256.particles, cfg256)
    fused_kernel(p2, grid, cfg256, f"{label} grid 256")
    st128, cfg128 = disc(n_small, dev, gravity="pm", grav_grid=128)
    grav_kernel(st128.particles, cfg128, f"{label} grid 128")
    grav_kernel(clustered(n_small, dev), cfg128, f"{label} clustered clump",
                plain_reps=1)
    pm_vs_direct(st128, label)
    phase_done("4 (N=131072, gravity kernels)")

    # -- phase 5: N = 1,048,576, gravity='none' at full size
    n = 1048576
    label = f"N={n}"
    state, cfg = disc(n, dev)
    reset_counts()
    warm, out, rate, step_s = time_main_path(state, cfg)
    none_launches = launch_counts()
    print(f"[{label}] main path: {rate:.6e} particle-steps/s "
          f"({step_s * 1e3:.3f} ms/step, {STEPS} steps timed) "
          f"launches {nonzero(none_launches)}", flush=True)
    for name in ("density_fixed_h", "force_fixed_h"):
        require(none_launches[name] == 1 + 2 * STEPS,
                f"{name} launched {none_launches[name]} times, expected "
                f"{1 + 2 * STEPS}")
    for name, count in sink_expect(cfg, 2 * STEPS).items():
        require(none_launches[name] == count,
                f"{label}: {name} counted {none_launches[name]}, expected "
                f"{count}")
    require_packs(none_launches, label)
    check_run(state, warm, out, label)
    span_table(out, cfg, 5, label)
    p2, grid = sort_particles(out.particles, cfg)
    ext = (grid.ends - grid.starts).sum(dim=1)
    print(f"[{label}] candidates per row: mean {float(ext.float().mean()):.1f}"
          f" max {int(ext.max())}", flush=True)
    results = sph_kernels(p2, grid, cfg, label)
    slab_disc = (p2, grid, cfg)   # phase 19a's fixed-h state
    rate_none = rate              # phase 21's headline is held against it
    t_disc = float(out.t)  # the disc's t after 2 x STEPS steps from the ICs
    phase_done("5 (N=1048576, gravity none)")

    # -- phase 6: the fused TreePM path at full size (pm_every 8)
    solves = 1 + 2 * len(range(0, STEPS, 8))
    fused_launches, out, cfg = run_path(
        *disc(n, dev, gravity="pm", grav_grid=256, pm_every=8),
        {"force_fixed_h_grav": 1 + 2 * STEPS, "density_fixed_h":
         1 + 2 * STEPS, "force_fixed_h": 0, "grav_short": 0,
         "mesh solves": solves}, f"{label} pm fused grid 256", check_run)
    p2, grid = sort_particles(out.particles, cfg)
    results["force_fixed_h_grav"] = fused_kernel(
        p2, grid, cfg, f"{label} pm fused grid 256")
    phase_done("6 (N=1048576, fused TreePM)")

    # -- phase 7: the separate TreePM path at full size (pm_every 1)
    sep_launches, out, cfg = run_path(
        *disc(n, dev, gravity="pm", grav_grid=128, pm_every=1),
        {"grav_short": 1 + 2 * STEPS, "mesh solves": 1 + 2 * STEPS,
         "force_fixed_h": 1 + 2 * STEPS, "force_fixed_h_grav": 0},
        f"{label} pm separate grid 128", check_run)
    results["grav_short"] = grav_kernel(out.particles, cfg,
                                        f"{label} pm separate grid 128")
    slab_grav = (out.particles, cfg)   # phase 19a's gravity state
    phase_done("7 (N=1048576, separate TreePM)")

    # -- phase 8: the variable-h kernels at N = 131,072 on config 5's ICs
    from summersph_tpu_torch.ops.smoothing import update_smoothing
    label = f"N={n_small} collapse"
    state, cfg = config5(n_small, dev)
    p, _ = update_smoothing(state.particles, cfg)
    p2, grid = sort_particles(p, cfg, h_pad=cfg.sort_h_pad)
    h = p2.h[p2.alive]
    print(f"[{label}] after one h-iteration: h {float(h.min()):.4f} to "
          f"{float(h.max()):.4f}, SPH cell {float(grid.cell_size):.4f}",
          flush=True)
    sph_kernels(p2, grid, cfg, label)
    fused_kernel(p2, grid, cfg.with_(grav_grid=256, grav_fuse_short=True,
                                     pm_every=8), f"{label} grid 256")
    phase_done("8 (N=131072, variable-h kernels)")

    # -- phase 9: the fused collapse path at N = 131,072
    label = f"N={n_small} collapse fused grid 256"
    var_fused_launches, out, cfg = run_path(
        *config5(n_small, dev, grav_grid=256, grav_fuse_short=True,
                 pm_every=8),
        {"force_var_h_grav": 1 + 2 * STEPS,
         "density_var_h": 1 + 3 * 2 * STEPS, "force_var_h": 0,
         "grav_short": 0, "density_fixed_h": 0, "force_fixed_h": 0,
         "force_fixed_h_grav": 0, "mesh solves": solves},
        label, check_collapse)
    p2, grid = sort_particles(out.particles, cfg, h_pad=cfg.sort_h_pad)
    results["force_var_h_grav"] = fused_kernel(p2, grid, cfg, label)
    phase_done("9 (N=131072, fused collapse)")

    # -- phase 10: sink creation on the card
    sink_creation(n_small, dev, f"N={n_small} sink creation")
    phase_done("10 (N=131072, sink creation)")

    # -- phase 11: the slice's path, config 5 at N = 1,048,576
    label = f"N={n} config 5"
    c5_launches, out, cfg = run_path(
        *config5(n, dev),
        {"density_var_h": 1 + 3 * 2 * STEPS, "force_var_h": 1 + 2 * STEPS,
         "grav_short": 1 + 2 * STEPS,
         "mesh solves": 1 + 2 * len(range(0, STEPS, 4)),  # pm_every 4
         "density_fixed_h": 0, "force_fixed_h": 0, "force_fixed_h_grav": 0,
         "force_var_h_grav": 0},
        label, check_collapse)
    p2, grid = sort_particles(out.particles, cfg, h_pad=cfg.sort_h_pad)
    ext = (grid.ends - grid.starts).sum(dim=1)
    print(f"[{label}] candidates per row: mean {float(ext.float().mean()):.1f}"
          f" max {int(ext.max())}; SPH cell {float(grid.cell_size):.4f}",
          flush=True)
    results.update(sph_kernels(p2, grid, cfg, label))
    slab_c5 = (p2, grid, cfg)   # phase 19a's variable-h state
    from summersph_tpu_torch.ops import cuda_pairs
    results["pack_force"] = pack_kernel(
        cuda_pairs.pair_eval(p2, cfg, grid)[0], grid.key, True, label)
    phase_done("11 (N=1048576, config 5)")

    # -- phase 12: the seven gated kernels at N = 131,072
    label = f"N={n_small} gated"
    state, cfg = disc(n_small, dev)
    gated_sph_checks(*sort_particles(state.particles, cfg), cfg, label)
    gated_sph_checks(*sort_particles(st256.particles, cfg256), cfg256,
                     f"{label} grid 256", fused=True)
    gated_grav_check(st128.particles, cfg128, f"{label} grid 128")
    state, cfg = config5(n_small, dev)
    p, _ = update_smoothing(state.particles, cfg)
    p2, grid = sort_particles(p, cfg, h_pad=cfg.sort_h_pad)
    gated_sph_checks(p2, grid, cfg, f"{label} collapse")
    gated_sph_checks(p2, grid, cfg.with_(grav_grid=256, grav_fuse_short=True,
                                         pm_every=8),
                     f"{label} collapse grid 256", fused=True)
    phase_done("12 (N=131072, gated kernels)")

    # -- phase 13: block timesteps on the disc at N = 1,048,576
    label = f"N={n} block steps dt_bins {BINS_DISC}"
    disc_b_launches, s0, out, cfg_b, tight = binned_path(
        *disc(n, dev), BINS_DISC, (2, 5),
        {"density_fixed_h_gated": 1, "force_fixed_h_gated": 1}, label,
        check_run, min_rungs=2)
    # the gated kernels at this path's shapes: the first substep's worklist
    p2, grid, gates = substep_gates(out, cfg_b)
    print_shares(gates, int(out.particles.n_alive), label)
    results.update(sph_kernels(p2, grid, cfg_b, label,
                               pick_gate(gates, label)[1]))
    gated_sph_checks(p2, grid, cfg_b, f"{label}, lowest quarter in x",
                     plain=False)
    ab_legs(s0, cfg_b, tight, 4, label, None)
    phase_done("13 (N=1048576, block steps on the disc)")

    # -- phase 14: the fused forms with block timesteps at N = 131,072
    label = f"N={n_small} block steps fused grid 256"
    fused_b_launches, _, out, cfg_b, _ = binned_path(
        *disc(n_small, dev, gravity="pm", grav_grid=256, pm_every=8),
        BINS_COLLAPSE, (1, 2),
        {"density_fixed_h_gated": 1, "force_fixed_h_grav_gated": 1}, label,
        check_run)
    p2, grid, gates = substep_gates(out, cfg_b)
    results["force_fixed_h_grav_gated"] = fused_kernel(
        p2, grid, cfg_b, label, pick_gate(gates, label)[1])
    label = f"N={n_small} block steps collapse fused grid 256"
    var_fused_b_launches, _, out, cfg_b, _ = binned_path(
        *config5(n_small, dev, grav_grid=256, grav_fuse_short=True,
                 pm_every=8), BINS_COLLAPSE, (1, 2),
        {"density_var_h_gated": 3, "force_var_h_grav_gated": 1}, label,
        check_collapse)
    p2, grid, gates = substep_gates(out, cfg_b)
    results["force_var_h_grav_gated"] = fused_kernel(
        p2, grid, cfg_b, label, pick_gate(gates, label)[1])
    phase_done("14 (N=131072, fused block steps)")

    # -- phase 15: config 5 with block timesteps at N = 1,048,576
    label = f"N={n} config 5 block steps dt_bins {BINS_COLLAPSE}"
    c5_b_launches, s0, out, cfg_b, tight = binned_path(
        *config5(n, dev), BINS_COLLAPSE, (1, 3),
        {"density_var_h_gated": 3, "force_var_h_gated": 1,
         "grav_short_gated": 1}, label, check_collapse)
    p2, grid, gates = substep_gates(out, cfg_b)
    print_shares(gates, int(out.particles.n_alive), label)
    act, gate = pick_gate(gates, label)
    results.update(sph_kernels(p2, grid, cfg_b, label, gate))
    # grav_short_gated on the gravity sort, the same rows active
    by_pid = torch.zeros(out.particles.capacity, dtype=torch.bool,
                         device=dev)
    by_pid[p2.pid[act].long()] = True
    results["grav_short_gated"] = grav_kernel(
        out.particles, cfg_b, label,
        active_rows=by_pid[out.particles.pid.long()])
    gated_sph_checks(p2, grid, cfg_b, f"{label}, lowest quarter in x",
                     plain=False)
    gated_grav_check(out.particles, cfg_b,
                     f"{label}, lowest quarter in x", plain=False)
    ab_legs(s0, cfg_b, tight, 2, label,
            ("sph_window_overflow", "grav_window_overflow", "nonfinite",
             "sink_slots_full"))
    phase_done("15 (N=1048576, config 5 block steps)")

    # -- phase 16: window shapes built to break the redesigned kernels
    ragged_checks(dev)
    phase_done("16 (ragged windows)")

    # -- phase 17: the CLI at full size: make-ics, run, resume, image, Sod
    cli_path(dev, n, t_disc)
    phase_done("17 (N=1048576, the CLI)")

    # -- phase 19: gather mode and the dense engine
    results.update(row_slab_phase(slab_disc, slab_c5, slab_grav, results,
                                  f"N={n} row slabs"))
    del slab_grav
    phase_done("19a (N=1048576, row slabs)")
    disc_rows_launches, c5_rows_launches = sharded_phase(n, dev)
    phase_done("19b (N=1048576, gather mode)")
    dense_phase(dev)
    phase_done("19c (the dense oracle)")

    # -- phase 20: the slab decomposition
    disc_key_launches, c5_key_launches = slab_phase(n, dev)
    phase_done("20a (N=1048576, slab mode)")
    results.update(key_rows_phase(slab_disc, slab_c5, f"N={n} key_rows"))
    del slab_disc, slab_c5
    phase_done("20b (N=1048576, key_rows kernels)")

    # -- phase 21: the bench entry point at full size
    bench_phase(n, rate_none, card)
    phase_done("21 (N=1048576, the bench entry point)")

    # -- phase 22: reproducible TreePM runs; config 5 in segments
    for kw, what in (({"grav_grid": 128, "pm_every": 1}, "separate grid 128"),
                     ({"grav_grid": 256, "pm_every": 8}, "fused grid 256")):
        label = f"N={n} pm {what}"
        state, cfg = disc(n, dev, gravity="pm", **kw)
        deposit_check(rerun_bitwise(state, cfg, label).particles, cfg, label)
    phase_done("22a (N=1048576, TreePM runs twice)")
    # config 5's own path, run by the tool: 2 primes and 6 segments of 16
    c5_seg = config5_segments(n, dev, f"N={n} config 5 segments")
    steps, primes = 6 * 16, 2
    expect = {"density_var_h": primes + 3 * steps,
              "force_var_h": primes + steps, "grav_short": primes + steps,
              "pack_force": primes + steps,
              "mesh solves": primes + 6 * len(range(0, 16, 4))}
    require(nonzero(pair_launches(c5_seg)) == expect,
            f"config 5 segments: launches {nonzero(c5_seg)}, expected "
            f"{expect}")
    phase_done("22b (N=1048576, config 5 segments)")

    # -- phase 23: the graded configurations 1-4 through their tools
    evidence_phase(dev, card)
    phase_done("23a (ring, disc100, varh: tools.evidence)")
    sod_phase(dev, card)
    phase_done("23b (Sod: tools.sod_evidence)")

    # -- phase 24: the sink layers
    sink_results = sink_phase(n, dev)
    phase_done("24 (N=1048576, the sink layers)")

    # -- phase 25: the PM mesh's gradient
    fd4_results = fd4_phase(n, dev)
    phase_done("25 (N=1048576, the mesh gradient)")

    # -- phase 18: results
    launches = {"density_fixed_h": none_launches["density_fixed_h"],
                "pack_force": c5_launches["pack_force"],
                "force_fixed_h": none_launches["force_fixed_h"],
                "force_fixed_h_grav": fused_launches["force_fixed_h_grav"],
                "grav_short": sep_launches["grav_short"],
                "density_var_h": c5_launches["density_var_h"],
                "force_var_h": c5_launches["force_var_h"],
                "force_var_h_grav": var_fused_launches["force_var_h_grav"]}
    for name, counted in (
            ("density_fixed_h_gated", disc_b_launches),
            ("force_fixed_h_gated", disc_b_launches),
            ("force_fixed_h_grav_gated", fused_b_launches),
            ("grav_short_gated", c5_b_launches),
            ("density_var_h_gated", c5_b_launches),
            ("force_var_h_gated", c5_b_launches),
            ("force_var_h_grav_gated", var_fused_b_launches),
            ("density_fixed_h_rows", disc_rows_launches),
            ("force_fixed_h_rows", disc_rows_launches),
            ("density_var_h_rows", c5_rows_launches),
            ("force_var_h_rows", c5_rows_launches),
            ("grav_short_rows", c5_rows_launches),
            ("density_fixed_h_rows" + KEY_ROWS, disc_key_launches),
            ("force_fixed_h_rows" + KEY_ROWS, disc_key_launches),
            ("density_var_h_rows" + KEY_ROWS, c5_key_launches),
            ("force_var_h_rows" + KEY_ROWS, c5_key_launches)):
        launches[name] = counted[name]
        require(counted[name] > 0, f"{name} was never launched on its path")
    # the mesh gradient's launches on a main path at each grid: config 5's
    # (grid 128, phase 11) and the fused TreePM disc's (grid 256, phase 6)
    fd4_launches = {128: c5_launches["fd4_gradient"],
                    256: fused_launches["fd4_gradient"]}
    from summersph_tpu_torch.ops import cuda_sinks, pm_gravity
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": cuda_pairs.SOURCE,
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": results[name][0], "ms": results[name][1],
         "plain_ms": results[name][2], "bound_ms": results[name][3],
         "bound_by": results[name][4], "library_ms": None}
        for name, (replaces, _) in KERNELS.items()] + [
        {"name": name, "route": "cuda", "source": cuda_sinks.SOURCE,
         "replaces": SINK_REPLACES[SINK_OF[name.replace(SINK_LIVE, "")]],
         "launches": c5_launches[name.replace(SINK_LIVE, "")],
         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
        for name, (err, ms, plain_ms, bound_ms, bound_by)
        in sink_results.items()] + [
        {"name": f"fd4_gradient (grid {g})", "route": "cuda",
         "source": pm_gravity.SOURCE,
         "replaces": "none (summersph_tpu/ops/pm_gravity.py _fd4_gradient"
                     " is jnp)", "launches": fd4_launches[g],
         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": roll_ms}
        for g, (err, ms, plain_ms, bound_ms, bound_by, roll_ms)
        in fd4_results.items()]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
