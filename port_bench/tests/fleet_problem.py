"""The program's side of the test-only ``quadruple_tank_fleet`` kind: a
fleet of Johansson's quadruple-tank process, each lane at its own valve
split (gamma1, gamma2), so each lane has its own ``Qp`` and ``Qd``; the
lanes share ``Gp``.  A batch draws each lane's ``x0`` and (gamma1, gamma2)
from the seed; the build condenses each lane's plant with the port's
``condense``, stacks the lanes into one distinct ``PrimalQP`` and
dualizes it with ``dualize_distinct``; the solve is ``solve_auto``.
Tests copy this file to ``problems/quadruple_tank_fleet.py`` under a root
of their own."""

from __future__ import annotations

import numpy as np
import torch

from pqp_for_mpc_tpu_torch.config import SolverConfig
from pqp_for_mpc_tpu_torch.dual import dualize_distinct
from pqp_for_mpc_tpu_torch.models import MPCSpec, condense
from pqp_for_mpc_tpu_torch.models.plants import LinearPlant
from pqp_for_mpc_tpu_torch.problem import PrimalQP
from pqp_for_mpc_tpu_torch.routing import route_solve, solve_auto


def plant(conf: dict, g1: float, g2: float) -> LinearPlant:
    """The tanks linearized at the configuration's point with the valve
    split (g1, g2), Euler-discretized at ``dt``."""
    p = conf["plant"]
    T, a, k = np.asarray(p["T"], np.float64), p["areas"], p["k"]
    Ac = np.diag(-1.0 / T)
    Ac[0, 2] = a[2] / (a[0] * T[2])
    Ac[1, 3] = a[3] / (a[1] * T[3])
    Bc = np.array([[g1 * k[0] / a[0], 0.0], [0.0, g2 * k[1] / a[1]],
                   [0.0, (1 - g2) * k[1] / a[2]],
                   [(1 - g1) * k[0] / a[3], 0.0]])
    return LinearPlant(A=np.eye(4) + p["dt"] * Ac, B=p["dt"] * Bc,
                       E=np.zeros((4, 1)), C=np.asarray(p["C"], np.float64),
                       name="quadruple_tank")


class Problem:
    def __init__(self, conf: dict, cfg: SolverConfig, traffic: dict,
                 device: torch.device):
        self.conf, self.cfg, self.traffic = conf, cfg, traffic
        self.device = device
        self.ns, self.nu = 4, 2
        self.n_var = conf["horizon"] * self.nu
        self.n_con = 4 * self.n_var

    def route(self, lanes: int, warm: bool) -> str:
        return route_solve(self.n_con, lanes, True, self.cfg,
                           m_dim=self.n_var, platform=self.device.type,
                           warm=warm)

    def draw(self, gen: torch.Generator, lanes: int) -> dict:
        """x0 ~ N(0, draw_std^2) and (gamma1, gamma2) uniform in the box
        between the configuration's two operating points."""
        p, dev = self.conf["plant"], self.device
        lo = torch.tensor(p["gamma_lo"], device=dev)[:, None]
        hi = torch.tensor(p["gamma_hi"], device=dev)[:, None]
        x0 = self.traffic["draw_std"] * torch.randn(
            (self.ns, lanes), generator=gen, device=dev)
        u = torch.rand((2, lanes), generator=gen, device=dev)
        return {"x0": x0, "gamma": lo + (hi - lo) * u}

    def build(self, params: dict):
        c, a = self.conf, np.asarray
        gam = params["gamma"].double().cpu().numpy()
        parts = []
        for b in range(gam.shape[1]):
            spec = MPCSpec(plant(c, *gam[:, b]), horizon=c["horizon"],
                           Qy=a(c["Qy"]), R=a(c["R"]), r=a(c["r"]),
                           u_min=a(c["u_min"]), u_max=a(c["u_max"]),
                           du_max=a(c["du_max"]))
            data = condense(spec, device=self.device)
            parts.append(data.assemble(x=params["x0"][:, b:b + 1]))
        primal = PrimalQP(
            Qp=torch.stack([q.Qp for q in parts]),
            Qp_inv=torch.stack([q.Qp_inv for q in parts]),
            Fp=torch.cat([q.Fp for q in parts], 1),
            Mp=torch.cat([q.Mp for q in parts]),
            Gp=torch.stack([q.Gp for q in parts]),
            Kp=torch.stack([q.Kp for q in parts], 1))
        return primal, dualize_distinct(primal,
                                        theta_floor=self.cfg.theta_floor)

    def solve(self, built):
        return solve_auto(*built, cfg=self.cfg)

    def lanes(self, params: dict, idx=None) -> dict:
        """The reference's inputs of lanes ``idx`` (all by default)."""
        pick = (lambda v: v) if idx is None else (lambda v: v[:, idx])
        x0 = pick(params["x0"])
        return {"x0": x0, "gamma": pick(params["gamma"]),
                "u_prev": torch.zeros(self.nu, x0.shape[1],
                                      device=x0.device)}
