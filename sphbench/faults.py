"""Faults planted in the timed path, for the tests and for `calibrate.py`.

Each is a function of the program's `integrate` module that replaces one
of its functions with a broken form and returns nothing; undo it by
restoring the attribute (pytest's `monkeypatch` does).  A cell must come
out not correct under each fault that it can have:

* `unchanged`: a segment returns its state as it came, only `t` advanced;
* `half`: a segment advances the particles of even id and leaves the
  rest as they were;
* `altered`: one particle is moved after the segment, where the answer
  is produced;
* `h_frozen` (variable h only): the h-iteration is skipped, every h kept
  as the step found it.
"""

import torch

NAMES = ("unchanged", "half", "altered", "h_frozen")
VARIABLE_H_ONLY = ("h_frozen",)


def unchanged(integrate):
    def broken(state, cfg, n, axis_name=None):
        return state.replace(t=state.t + n * state.dt)
    integrate.run_steps = broken


def half(integrate):
    run_steps = integrate.run_steps

    def broken(state, cfg, n, axis_name=None):
        out = run_steps(state, cfg, n, axis_name)
        p_in, p = state.particles, out.particles
        order = torch.argsort(p_in.pid.long())
        keep = (p.pid.long() % 2 == 0)

        def mix(a_out, a_in):
            a_in = a_in[order][p.pid.long()]
            shape = (-1,) + (1,) * (a_out.dim() - 1)
            return torch.where(keep.view(shape), a_out, a_in)

        return out.replace(particles=p.replace(
            pos=mix(p.pos, p_in.pos), vel=mix(p.vel, p_in.vel),
            u=mix(p.u, p_in.u), h=mix(p.h, p_in.h)))
    integrate.run_steps = broken


def altered(integrate):
    run_steps = integrate.run_steps

    def broken(state, cfg, n, axis_name=None):
        out = run_steps(state, cfg, n, axis_name)
        p = out.particles
        i = int(torch.argmax(p.alive.to(torch.int32)))
        pos = p.pos.clone()
        pos[i, 0] += 0.01 * float(torch.abs(pos[i]).max())
        return out.replace(particles=p.replace(pos=pos))
    integrate.run_steps = broken


def h_frozen(integrate):
    def broken(p, cfg, **kw):
        return p, torch.zeros((), dtype=torch.int32, device=p.pos.device)
    integrate.update_smoothing = broken


def plant(integrate, name: str) -> None:
    """Plant the fault `name` in the `integrate` module."""
    if name not in NAMES:
        raise ValueError(f"no fault {name!r}; one of {NAMES}")
    globals()[name](integrate)


__all__ = ["NAMES", "VARIABLE_H_ONLY", "plant"] + list(NAMES)
