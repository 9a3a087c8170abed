"""The comparison that decides `correct`.

A segment of the timed path turns a state S_in into S_out.  The plain
reference (`reference.py`) runs the same steps from S_in in float64, and
`numbers` holds S_out against its result, particle by particle id:

* `t`: |t_out - t_ref| over the span t_ref - t_in;
* `alive`: the particles alive in one of the two states and not in the
  other (a count);
* `pos`, `vel`, `u`, `alpha`, and with variable h `h`: the RMS over the
  particles alive in both of |X_out - X_ref|, over the RMS of the
  segment's change |X_ref - X_in| (u with the Kahan carry taken off);
* `pos_max`, `vel_max`: the largest single |X_out - X_ref| over that RMS
  change, which a lone altered particle cannot hide in;
* `sink_pos`, `sink_vel`: the same ratio for the sinks alive in both;
  `sink_mass`: the largest |m_out - m_ref| / m_ref of a sink with mass.

Each number has its limit in the workload's file (`limits`); a run is
correct when every number of every compared segment is within it, a
number that is not finite never.  The control is the same reference run
in bfloat16 from S_in and held against the float64 one by the same
numbers (`calibrate.py`).
"""

from __future__ import annotations

import math

import torch

PARTICLE_FIELDS = ("pos", "vel", "acc", "mass", "u", "du", "alpha",
                   "dalpha", "h", "rho", "omega", "pressure", "cs", "alive",
                   "pid", "u_c", "acc_ext")
SINK_FIELDS = ("pos", "vel", "acc", "spin", "mass", "radius", "alive")


def state_from_program(state, dtype=torch.float64) -> dict:
    """The program's SimState as the reference's dict, floats in `dtype`,
    on the state's device."""
    out = {}
    p, s = state.particles, state.sinks

    def cast(a):
        return a.to(dtype) if a.is_floating_point() else a.clone()

    for f in PARTICLE_FIELDS:
        a = getattr(p, f)
        out[f] = None if a is None else cast(a)
    out["pid"] = out["pid"].to(torch.int64)
    for f in SINK_FIELDS:
        out["s" + f] = cast(getattr(s, f))
    out["t"], out["dt"] = cast(state.t), cast(state.dt)
    out["pm_r_s"] = None if state.pm_r_s is None else cast(state.pm_r_s)
    return out


def _by_pid(st, name):
    """Field `name` in particle-id order."""
    a = st[name]
    out = torch.empty_like(a)
    out[st["pid"]] = a
    return out


def _u_total(st):
    u = st["u"]
    return u if st.get("u_c") is None else u - st["u_c"]


def _rms(x):
    return math.sqrt(float(torch.mean(x.double() ** 2))) if x.numel() else 0.0


def numbers(s_in: dict, s_out: dict, s_ref: dict, var_h: bool) -> dict:
    """The compared numbers of one segment (see the module docstring)."""
    res = {}
    span = float(s_ref["t"]) - float(s_in["t"])
    res["t"] = abs(float(s_out["t"]) - float(s_ref["t"])) / max(span, 1e-300)
    a_out, a_ref = _by_pid(s_out, "alive"), _by_pid(s_ref, "alive")
    a_in = _by_pid(s_in, "alive")
    res["alive"] = float(torch.sum(a_out != a_ref))
    both = a_out & a_ref & a_in
    fields = ["pos", "vel", "u", "alpha"] + (["h"] if var_h else [])
    for f in fields:
        get = _u_total if f == "u" else (lambda st, f=f: st[f])
        x_in, x_out, x_ref = ({**st, f: get(st)} for st in (s_in, s_out,
                                                            s_ref))
        xi, xo, xr = (_by_pid(st, f)[both].double()
                      for st in (x_in, x_out, x_ref))
        err = xo - xr
        chg = xr - xi
        if err.dim() > 1:
            err, chg = torch.linalg.norm(err, dim=1), torch.linalg.norm(
                chg, dim=1)
        scale = max(_rms(chg), 1e-300)
        res[f] = _rms(err) / scale
        if f in ("pos", "vel"):
            res[f + "_max"] = (float(torch.max(torch.abs(err)))
                               if err.numel() else 0.0) / scale
    sa = s_out["salive"] & s_ref["salive"]
    res["alive"] += float(torch.sum(s_out["salive"] != s_ref["salive"]))
    for f in ("spos", "svel"):
        err = torch.linalg.norm((s_out[f] - s_ref[f])[sa].double(), dim=1)
        chg = torch.linalg.norm((s_ref[f] - s_in[f])[sa].double(), dim=1)
        res["sink_" + f[1:]] = _rms(err) / max(_rms(chg), 1e-300)
    m_ref = s_ref["smass"][sa].double()
    heavy = m_ref > 0.0
    dm = (s_out["smass"][sa].double() - m_ref)[heavy] / m_ref[heavy]
    res["sink_mass"] = float(torch.max(torch.abs(dm))) if dm.numel() else 0.0
    return res


def worst(readings: list) -> dict:
    """The largest reading of each number over several segments."""
    out = {}
    for r in readings:
        for k, v in r.items():
            v = v if math.isfinite(v) else math.inf
            out[k] = max(out.get(k, 0.0), v)
    return out


def judge(readings: dict, limits: dict):
    """(correct, lines): each number beside its limit."""
    ok = True
    lines = []
    for k in sorted(limits):
        v = readings.get(k)
        good = v is not None and math.isfinite(v) and v <= limits[k]
        ok &= good
        lines.append((k, v, limits[k], good))
    return ok, lines


__all__ = ["state_from_program", "numbers", "worst", "judge"]
