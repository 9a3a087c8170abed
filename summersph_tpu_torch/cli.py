"""Command-line interface of the PyTorch / CUDA port.

    python -m summersph_tpu_torch run --ic disc_12000_2.txt
        [--params parameters.txt] [--out runs/disc]
        [--fixed-h 2.5 | --variable-h] [--gravity pm] ...
    python -m summersph_tpu_torch make-ics disc --out disc_12000.txt \
        --n 12000
    python -m summersph_tpu_torch image save275.txt --out save275.png
    python -m summersph_tpu_torch resume runs/disc/checkpoint.npz \
        --out runs/disc
    python -m summersph_tpu_torch bench [--n 1048576] [--steps 20]

The subcommands, flags and defaults are those of `python -m summersph_tpu`,
and `run` reads the reference's IC and `parameters.txt` files unchanged.
One flag is added to each: `--device` (default `cuda`); without a card
the default raises, and `--device cpu` runs on the CPU with the kernels'
plain versions.  `bench` is `bench.py`'s benchmark (`bench.py` in this
package).
"""

from __future__ import annotations

import argparse
import os


def _add_config_flags(ap):
    ap.add_argument("--params", help="reference parameters.txt")
    ap.add_argument("--fixed-h", type=float, default=None,
                    help="fixed smoothing length (reference fixed-h mode)")
    ap.add_argument("--variable-h", action="store_true",
                    help="grad-h variable smoothing length mode")
    ap.add_argument("--gravity", choices=["none", "direct", "pm", "bh"],
                    default=None)
    ap.add_argument("--end-time", type=float, default=None)
    ap.add_argument("--n-saves", type=int, default=None)
    ap.add_argument("--gamma", type=float, default=None)
    ap.add_argument("--bounding-size", type=float, default=None)
    ap.add_argument("--neighbor-mode", choices=["sorted", "grid", "dense"],
                    default=None)
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VAL",
                    help="override any SimConfig field")


def _add_device_flag(ap):
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda, which needs a card)")


def _build_config(args, base=None):
    """The config: parameters.txt (over `base` when given), else `base`,
    else the defaults; then --variable-h, --fixed-h, the named flags and
    each --set KEY=VAL in that order."""
    from .config import SimConfig, read_parameters_txt

    if args.params:
        cfg = read_parameters_txt(args.params, base=base)
    elif base is not None:
        cfg = base
    else:
        cfg = SimConfig()
    if args.variable_h:
        cfg = cfg.with_(fixed_h=None)
    if args.fixed_h is not None:
        cfg = cfg.with_(fixed_h=args.fixed_h)
    for name in ("gravity", "end_time", "n_saves", "gamma", "bounding_size",
                 "neighbor_mode"):
        val = getattr(args, name)
        if val is not None:
            cfg = cfg.with_(**{name: val})
    for kv in args.set:
        key, _, raw = kv.partition("=")
        cur = getattr(cfg, key)  # raises for unknown keys
        if isinstance(cur, bool):
            val = raw.lower() in ("1", "true", "yes")
        elif isinstance(cur, int):
            val = int(raw)
        elif isinstance(cur, float) or cur is None:
            val = float(raw)
        else:
            val = raw
        cfg = cfg.with_(**{key: val})
    return cfg


def _columns(cfg) -> int:
    return 9 if cfg.fixed_h is not None else 10


def cmd_run(args):
    from .integrate import simulate
    from .io.checkpoint import save_npz
    from .io.txt import read_ic_txt
    from .state import SimState

    cfg = _build_config(args)
    particles, sinks = read_ic_txt(args.ic, cfg, capacity=args.capacity,
                                   device=args.device)
    state = SimState.create(particles, sinks, dt=cfg.dt_init)
    out = args.out or "."
    print(f"summersph_tpu_torch: {int(particles.n_alive)} gas + "
          f"{int(sinks.n_alive)} sinks from {args.ic} on {args.device}; "
          f"mode={'fixed-h' if cfg.fixed_h is not None else 'variable-h'} "
          f"gravity={cfg.gravity} -> {out}", flush=True)
    state = simulate(state, cfg, out_dir=out, snapshot_columns=_columns(cfg))
    save_npz(os.path.join(out, "checkpoint.npz"), state, cfg)
    return 0


def cmd_resume(args):
    from .integrate import simulate
    from .io.checkpoint import load_npz_with_config, save_npz

    state, saved_cfg = load_npz_with_config(args.checkpoint,
                                            device=args.device)
    # the checkpoint's config is the base physics; flags override it
    cfg = _build_config(args, base=saved_cfg)
    if args.variable_h is False and args.fixed_h is None and saved_cfg is None:
        print("note: checkpoint carries no config; pass the original flags "
              "explicitly", flush=True)
    out = args.out or os.path.dirname(args.checkpoint) or "."
    print(f"summersph_tpu_torch: resume t={float(state.t):.6g} on "
          f"{args.device} -> {out}", flush=True)
    state = simulate(state, cfg, out_dir=out, snapshot_columns=_columns(cfg))
    save_npz(os.path.join(out, "checkpoint.npz"), state, cfg)
    return 0


def cmd_make_ics(args):
    from .tools.make_ics import make_ics

    kw = {}
    if args.n:
        kw["n"] = args.n
    if args.seed is not None:
        kw["seed"] = args.seed
    path = make_ics(args.kind, args.out, device=args.device, **kw)
    print(f"wrote {path}")
    return 0


def cmd_image(args):
    from .tools.density_image import (projected_density_from_snapshot,
                                      save_image)

    proj, xi, sinks = projected_density_from_snapshot(
        args.snapshot, h=args.h, resolution=args.resolution, box=args.box,
        device=args.device)
    out = args.out or (os.path.splitext(args.snapshot)[0] + ".png")
    save_image(proj, xi, sinks, out)
    print(f"wrote {out}")
    return 0


def cmd_bench(args):
    from .bench import bench

    return bench(args.n, args.steps, args.gravity, args.device)


def build_parser() -> argparse.ArgumentParser:
    from .tools.make_ics import GENERATORS

    ap = argparse.ArgumentParser(prog="summersph_tpu_torch",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run",
                       help="run a simulation from reference-format ICs")
    p.add_argument("--ic", required=True, help="IC/snapshot .txt file")
    p.add_argument("--out", help="output directory for saves/checkpoint")
    p.add_argument("--capacity", type=int, default=None,
                   help="particle slot capacity (default: IC count)")
    _add_config_flags(p)
    _add_device_flag(p)
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("resume", help="resume from an npz checkpoint")
    p.add_argument("checkpoint")
    p.add_argument("--out")
    _add_config_flags(p)
    _add_device_flag(p)
    p.set_defaults(fn=cmd_resume)

    p = sub.add_parser("make-ics", help="generate reference-format IC files")
    p.add_argument("kind", choices=sorted(GENERATORS))
    p.add_argument("--out", required=True)
    p.add_argument("--n", type=int)
    p.add_argument("--seed", type=int)
    _add_device_flag(p)
    p.set_defaults(fn=cmd_make_ics)

    p = sub.add_parser("image", help="density projection image of a snapshot")
    p.add_argument("snapshot")
    p.add_argument("--out")
    p.add_argument("--h", type=float, default=None)
    p.add_argument("--resolution", type=int, default=120)
    p.add_argument("--box", type=float, default=100.0)
    _add_device_flag(p)
    p.set_defaults(fn=cmd_image)

    p = sub.add_parser("bench", help="throughput benchmark (JSON line)")
    p.add_argument("--n", type=int)
    p.add_argument("--steps", type=int)
    p.add_argument("--gravity")
    _add_device_flag(p)
    p.set_defaults(fn=cmd_bench)
    return ap


def main(argv=None):
    import torch

    args = build_parser().parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {args.device}: torch sees no CUDA card; pass "
            f"--device cpu to run on the CPU")
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
