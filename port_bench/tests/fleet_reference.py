"""The plain reference of the test-only ``quadruple_tank_fleet`` kind:
each lane's plant from its own valve split, condensed lane by lane by
``reference/condensed_mpc.qp``; ``Qp`` comes back per lane (B, M, M) and
``Gp`` shared (N, M).  Imports nothing of the program.  Tests copy this
file to ``reference/quadruple_tank_fleet.py`` under a root of their own."""

from __future__ import annotations

import numpy as np
import torch

from port_bench.reference import condensed_mpc

scale = condensed_mpc.scale


def plant(conf: dict, g1: float, g2: float) -> dict:
    """``A``, ``B``, ``C`` of the tanks at the valve split (g1, g2)."""
    p = conf["plant"]
    T, a, k, dt = p["T"], p["areas"], p["k"], p["dt"]
    A = np.eye(4) - dt * np.diag([1.0 / t for t in T])
    A[0, 2] = dt * a[2] / (a[0] * T[2])
    A[1, 3] = dt * a[3] / (a[1] * T[3])
    B = dt * np.array([[g1 * k[0] / a[0], 0.0], [0.0, g2 * k[1] / a[1]],
                       [0.0, (1 - g2) * k[1] / a[2]],
                       [(1 - g1) * k[0] / a[3], 0.0]])
    return {"A": A.tolist(), "B": B.tolist(), "C": p["C"]}


def qp(conf: dict, lanes: dict, device):
    """(Qp (B, M, M), Gp (N, M), Fp, Kp, Mp) in float64."""
    gam = lanes["gamma"].double().cpu()
    out = []
    for b in range(gam.shape[1]):
        one = {k: v[:, b:b + 1] for k, v in lanes.items() if k != "gamma"}
        out.append(condensed_mpc.qp(
            dict(conf, plant=plant(conf, *gam[:, b].tolist())), one, device))
    Qp, Gp, Fp, Kp, Mp = zip(*out)
    return (torch.stack(Qp), Gp[0], torch.cat(Fp, 1), torch.cat(Kp, 1),
            torch.cat(Mp))
