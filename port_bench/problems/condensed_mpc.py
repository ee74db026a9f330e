"""The program's side of a ``condensed_mpc`` configuration.

The configuration's numbers become the port's ``MPCSpec``.  A batch runs
``condense`` once in set-up (with ``dual_geometry``), then per batch
``CondensedMPCData.assemble`` and ``dualize_forcing`` (the build) and
``solve_auto`` (the solve).  A loop runs ``MPCController.step(x,
u_prev=u)``, warm-started by the controller itself, against the
benchmark's own float64 NumPy plant ``x+ = A x + B u0 + w`` (:class:`Loop`).  A lane's
parameter is its initial state ``x0``.
"""

from __future__ import annotations

import numpy as np
import torch

from pqp_for_mpc_tpu_torch.config import SolverConfig
from pqp_for_mpc_tpu_torch.dual import dual_geometry, dualize_forcing
from pqp_for_mpc_tpu_torch.models import MPCController, MPCSpec, condense
from pqp_for_mpc_tpu_torch.models.plants import LinearPlant
from pqp_for_mpc_tpu_torch.routing import route_solve, solve_auto


def spec(conf: dict) -> MPCSpec:
    p = conf["plant"]
    a = lambda v: np.asarray(v, np.float64)
    plant = LinearPlant(A=a(p["A"]), B=a(p["B"]), E=a(p["E"]), C=a(p["C"]),
                        name=p["name"])
    return MPCSpec(plant, horizon=conf["horizon"], Qy=a(conf["Qy"]),
                   R=a(conf["R"]), r=a(conf["r"]), u_min=a(conf["u_min"]),
                   u_max=a(conf["u_max"]), du_max=a(conf["du_max"]))


class Problem:
    def __init__(self, conf: dict, cfg: SolverConfig, traffic: dict,
                 device: torch.device):
        self.conf, self.cfg, self.traffic = conf, cfg, traffic
        self.device = device
        self.spec = spec(conf)
        self.ns = self.spec.plant.n_state
        self.nu = self.spec.plant.n_input
        self.n_var = conf["horizon"] * self.nu
        self.n_con = 4 * self.n_var
        if traffic["mode"] == "batch":
            self.data = condense(self.spec, device=device)
            self.Qp = self.data.qp()
            self.geom = dual_geometry(self.data.Gp, self.data.Qp_inv,
                                      theta_floor=cfg.theta_floor)

    def route(self, lanes: int, warm: bool) -> str:
        return route_solve(self.n_con, lanes, False, self.cfg,
                           m_dim=self.n_var, platform=self.device.type,
                           warm=warm)

    def draw(self, gen: torch.Generator, lanes: int) -> torch.Tensor:
        """Initial states x0 ~ N(0, draw_std^2), (ns, lanes) float32."""
        return self.traffic["draw_std"] * torch.randn(
            (self.ns, lanes), generator=gen, device=self.device)

    # the batch: build, then solve
    def build(self, x0: torch.Tensor):
        primal = self.data.assemble(x=x0, Qp=self.Qp)
        return primal, dualize_forcing(self.geom, primal.Fp, primal.Mp,
                                       primal.Kp)

    def solve(self, built):
        return solve_auto(*built, cfg=self.cfg)

    def lanes(self, x0: torch.Tensor, idx=None) -> dict:
        """The reference's inputs of lanes ``idx`` (all by default) of a
        batch."""
        x = x0 if idx is None else x0[:, idx]
        return {"x0": x, "u_prev": torch.zeros(self.nu, x.shape[1],
                                               device=x.device)}

    def loop(self, rng: np.random.Generator):
        return Loop(self, rng)


class Loop:
    """The closed loop at B = 1: state and input on the host in float64.

    The states come in segments of ``redraw_every`` steps: a segment
    starts from a state drawn from N(0, draw_std^2) (the redraw) and
    carries its own plant noise w ~ N(0, step_std^2) per step,
    x+ = A x + B u0 + w.  With ``"pool": K`` the segments are a fixed pool
    of K, drawn from the traffic's ``pool_seed`` (the same for every run),
    run in one fixed circular order; the run's seed picks the segment the
    window starts on, and the warm-up runs the segment before it, so each
    run does the same work in another order.  (How long a step takes
    depends on the segment before it, through the controller's warm
    start, so a fresh order per cycle would change the work from run to
    run.)  With ``"pool": 0`` every segment is drawn afresh from the run's
    seed."""

    def __init__(self, problem: Problem, rng: np.random.Generator):
        t = problem.traffic
        if t["lanes"] != 1:
            raise ValueError("a condensed_mpc loop runs one lane")
        self.p, self.rng = problem, rng
        p = problem.conf["plant"]
        self.A = np.asarray(p["A"], np.float64)
        self.B = np.asarray(p["B"], np.float64)
        self.ctrl = MPCController(problem.spec, cfg=problem.cfg,
                                  device=problem.device)
        self.rows = slice(0, problem.nu)        # the rows of U a step returns
        K, L = t["pool"], t["redraw_every"]
        self.cycle = max(K, 1) * L              # steps of a whole cycle
        if K:
            pool = np.random.Generator(np.random.PCG64(t["pool_seed"]))
            self.starts = pool.normal(0.0, t["draw_std"], (K, problem.ns))
            self.noise = pool.normal(0.0, t["step_std"], (K, L, problem.ns))
            # the warm-up's segment is seg + 1, the window's first seg + 2
            self.seg = int(rng.integers(K)) - 2
        self._next_segment()
        self.u = np.zeros(problem.nu)

    def _next_segment(self) -> None:
        """The next segment's drawn state and plant noise."""
        t, self.j = self.p.traffic, 0
        if t["pool"]:
            self.seg = (self.seg + 1) % t["pool"]
            self.x, self.w = self.starts[self.seg], self.noise[self.seg]
        else:
            self.x = self.rng.normal(0.0, t["draw_std"], self.p.ns)
            self.w = self.rng.normal(0.0, t["step_std"],
                                     (t["redraw_every"], self.p.ns))

    def solve(self):
        """The step: (SolveResult, u0 on the device)."""
        u0, res = self.ctrl.step(self.x, u_prev=self.u)
        return res, u0

    def lanes(self) -> dict:
        """The reference's inputs of this step's lane."""
        as_t = lambda v: torch.as_tensor(v, dtype=torch.float64)[:, None]
        return {"x0": as_t(self.x), "u_prev": as_t(self.u)}

    def advance(self, out: np.ndarray) -> None:
        """The plant, or the next segment's drawn state."""
        u0 = np.asarray(out, np.float64).reshape(-1)
        self.j += 1
        if self.j == len(self.w):
            self._next_segment()
        else:
            self.x = self.A @ self.x + self.B @ u0 + self.w[self.j - 1]
        self.u = u0
