"""LTI plant model zoo.

The reference ships exactly one plant, pre-condensed to text files (a
29-state thermal/HVAC-like model, judging by ``example/x.txt`` ~304-308 K
states and ``example/D.txt`` = 312.15 K; SURVEY.md §2.1).  It never
represents the plant itself.  This module provides the plant abstraction
plus a family of standard test plants; :mod:`pqp_for_mpc_tpu_torch.models.mpc`
condenses any of them over an arbitrary horizon — the derivation step the
reference omits (SURVEY.md §5, "long-context" row).

Discrete-time LTI dynamics:  x+ = A x + B u + E d,   y = C x.

A copy of ``pqp_for_mpc_tpu/models/plants.py`` (NumPy only): importing that
module would run its package's ``__init__``, which imports JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class LinearPlant:
    """Discrete-time LTI plant with disturbance input."""

    A: np.ndarray  # (ns, ns)
    B: np.ndarray  # (ns, nu)
    E: np.ndarray  # (ns, nd)
    C: np.ndarray  # (ny, ns)
    name: str = "plant"

    @property
    def n_state(self) -> int:
        return self.A.shape[0]

    @property
    def n_input(self) -> int:
        return self.B.shape[1]

    @property
    def n_dist(self) -> int:
        return self.E.shape[1]

    @property
    def n_output(self) -> int:
        return self.C.shape[0]

    def step(self, x, u, d=None):
        xn = self.A @ x + self.B @ u
        if d is not None:
            xn = xn + self.E @ d
        return xn


@dataclasses.dataclass(frozen=True)
class LTVPlant:
    """Discrete-time linear TIME-VARYING plant over a fixed horizon:

        x_{k+1} = A[k] x_k + B[k] u_k + E[k] d_k,   k = 0..H-1,
        y_{k+1} = C[k] x_{k+1}

    (slot convention: stage k's output map ``C[k]`` applies to the state
    that stage produces, matching the stacked prediction ``X = x_1..x_H``
    used everywhere else).  Beyond the reference's surface — its plant is
    one precondensed LTI instance (PQP_CPU.c:757-930) — the LTV form is
    exactly what successive linearization of a nonlinear plant along a
    nominal trajectory produces, with the affine remainder
    ``f(xbar,ubar) - A xbar - B ubar`` riding the disturbance channel
    (``E = I``, ``dseq`` = remainder); see examples/nonlinear_mpc.py.

    :func:`~pqp_for_mpc_tpu_torch.models.mpc.condense` accepts it (dense,
    via time-varying prediction matrices).
    """

    A: np.ndarray  # (H, ns, ns)
    B: np.ndarray  # (H, ns, nu)
    E: np.ndarray  # (H, ns, nd)
    C: np.ndarray  # (H, ny, ns)
    name: str = "ltv"

    @property
    def horizon(self) -> int:
        return self.A.shape[0]

    @property
    def n_state(self) -> int:
        return self.A.shape[1]

    @property
    def n_input(self) -> int:
        return self.B.shape[2]

    @property
    def n_dist(self) -> int:
        return self.E.shape[2]

    @property
    def n_output(self) -> int:
        return self.C.shape[1]

    def step(self, k: int, x, u, d=None):
        xn = self.A[k] @ x + self.B[k] @ u
        if d is not None:
            xn = xn + self.E[k] @ d
        return xn


def stack_plant(plant: LinearPlant, H: int) -> LTVPlant:
    """Broadcast an LTI plant to the stacked per-stage LTV form."""
    rep = lambda m: np.broadcast_to(
        np.asarray(m, np.float32), (H,) + np.asarray(m).shape).copy()
    return LTVPlant(A=rep(plant.A), B=rep(plant.B), E=rep(plant.E),
                    C=rep(plant.C), name=plant.name + "_stacked")


def _f32(*arrays):
    return tuple(np.asarray(a, np.float32) for a in arrays)


def double_integrator(dt: float = 0.1) -> LinearPlant:
    """Classic 2-state double integrator (position/velocity, force input)."""
    A = np.array([[1.0, dt], [0.0, 1.0]])
    B = np.array([[0.5 * dt * dt], [dt]])
    E = np.zeros((2, 1))
    C = np.array([[1.0, 0.0]])
    A, B, E, C = _f32(A, B, E, C)
    return LinearPlant(A, B, E, C, name="double_integrator")


def mass_spring_damper(n_masses: int = 3, dt: float = 0.05,
                       k: float = 2.0, c: float = 0.5) -> LinearPlant:
    """Chain of ``n_masses`` unit masses coupled by springs/dampers;
    actuated at every mass, disturbance force at the last mass,
    positions observed.  State = [positions; velocities]."""
    n = n_masses
    K = np.zeros((n, n))
    for i in range(n):
        K[i, i] = -2.0 * k
        if i > 0:
            K[i, i - 1] = k
        if i < n - 1:
            K[i, i + 1] = k
    Cd = K * (c / k)
    Ac = np.block([[np.zeros((n, n)), np.eye(n)], [K, Cd]])
    Bc = np.vstack([np.zeros((n, n)), np.eye(n)])
    Ec = np.zeros((2 * n, 1))
    Ec[-1, 0] = 1.0
    # forward-Euler discretization (adequate for a test plant at small dt)
    A = np.eye(2 * n) + dt * Ac
    B = dt * Bc
    E = dt * Ec
    C = np.hstack([np.eye(n), np.zeros((n, n))])
    A, B, E, C = _f32(A, B, E, C)
    return LinearPlant(A, B, E, C, name=f"mass_spring_{n_masses}")


def thermal_rc(n_rooms: int = 29, n_heaters: int = 7, dt: float = 60.0,
               seed: int = 0) -> LinearPlant:
    """RC-network building thermal model in the spirit of the reference's
    example plant (29 states / 7 inputs / ambient-temperature disturbance).

    Rooms exchange heat along a random sparse adjacency; ``n_heaters``
    heaters each drive one room; the disturbance is the ambient
    temperature coupling into every room.
    """
    rng = np.random.default_rng(seed)
    n = n_rooms
    G = np.zeros((n, n))  # conductances
    order = rng.permutation(n)
    for a, b in zip(order[:-1], order[1:]):  # spanning chain => connected
        g = rng.uniform(0.5, 1.5)
        G[a, b] = G[b, a] = g
    for _ in range(n):  # extra random links
        a, b = rng.integers(0, n, 2)
        if a != b:
            g = rng.uniform(0.1, 0.6)
            G[a, b] = G[b, a] = g
    g_amb = rng.uniform(0.05, 0.2, n)
    cap = rng.uniform(5.0, 15.0, n)  # thermal capacitances
    Ac = np.zeros((n, n))
    for i in range(n):
        Ac[i] = G[i] / cap[i]
        Ac[i, i] = -(G[i].sum() + g_amb[i]) / cap[i]
    heater_rooms = rng.permutation(n)[:n_heaters]
    Bc = np.zeros((n, n_heaters))
    for j, r in enumerate(heater_rooms):
        Bc[r, j] = 1.0 / cap[r]
    Ec = (g_amb / cap)[:, None]
    A = np.eye(n) + dt * Ac
    B = dt * Bc
    E = dt * Ec
    C = np.zeros((n_heaters, n))
    for j, r in enumerate(heater_rooms):
        C[j, r] = 1.0  # observe heated rooms
    A, B, E, C = _f32(A, B, E, C)
    return LinearPlant(A, B, E, C, name=f"thermal_rc_{n}x{n_heaters}")


def random_stable(n_state: int, n_input: int, n_dist: int = 1,
                  n_output: int | None = None, rho: float = 0.95,
                  seed: int = 0) -> LinearPlant:
    """Random discrete-time plant with spectral radius scaled to ``rho``."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n_state, n_state))
    A *= rho / max(abs(np.linalg.eigvals(A)))
    B = rng.standard_normal((n_state, n_input))
    E = rng.standard_normal((n_state, n_dist)) * 0.1
    ny = n_output or min(n_state, n_input)
    C = rng.standard_normal((ny, n_state)) / np.sqrt(n_state)
    A, B, E, C = _f32(A, B, E, C)
    return LinearPlant(A, B, E, C, name=f"random_{n_state}x{n_input}")


def dc_motor(dt: float = 0.01) -> LinearPlant:
    """Armature-controlled DC motor: state [angle, angular velocity,
    current], voltage input, load-torque disturbance, angle observed."""
    J, b, K, R, L = 0.01, 0.1, 0.01, 1.0, 0.5
    Ac = np.array([[0.0, 1.0, 0.0],
                   [0.0, -b / J, K / J],
                   [0.0, -K / L, -R / L]])
    Bc = np.array([[0.0], [0.0], [1.0 / L]])
    Ec = np.array([[0.0], [-1.0 / J], [0.0]])
    A = np.eye(3) + dt * Ac
    B = dt * Bc
    E = dt * Ec
    C = np.array([[1.0, 0.0, 0.0]])
    A, B, E, C = _f32(A, B, E, C)
    return LinearPlant(A, B, E, C, name="dc_motor")


def aircraft_pitch(dt: float = 0.02) -> LinearPlant:
    """Longitudinal pitch dynamics (standard 3-state trainer model:
    angle of attack, pitch rate, pitch angle; elevator input; vertical
    gust disturbance; pitch angle observed)."""
    Ac = np.array([[-0.313, 56.7, 0.0],
                   [-0.0139, -0.426, 0.0],
                   [0.0, 56.7, 0.0]])
    Bc = np.array([[0.232], [0.0203], [0.0]])
    Ec = np.array([[0.1], [0.001], [0.0]])
    A = np.eye(3) + dt * Ac
    B = dt * Bc
    E = dt * Ec
    C = np.array([[0.0, 0.0, 1.0]])
    A, B, E, C = _f32(A, B, E, C)
    return LinearPlant(A, B, E, C, name="aircraft_pitch")


def quadruple_tank(dt: float = 1.0) -> LinearPlant:
    """Johansson's quadruple-tank process (linearized at the minimum-
    phase operating point): 4 tank levels, 2 pump inputs, inflow
    disturbance into tank 3, lower-tank levels observed."""
    T = np.array([62.0, 90.0, 23.0, 30.0])      # time constants
    A1, A3 = 28.0, 28.0
    A2, A4 = 32.0, 32.0
    k1, k2 = 3.33, 3.35
    g1, g2 = 0.7, 0.6
    Ac = np.diag(-1.0 / T)
    Ac[0, 2] = A3 / (A1 * T[2])
    Ac[1, 3] = A4 / (A2 * T[3])
    Bc = np.array([[g1 * k1 / A1, 0.0],
                   [0.0, g2 * k2 / A2],
                   [0.0, (1 - g2) * k2 / A3],
                   [(1 - g1) * k1 / A4, 0.0]])
    Ec = np.array([[0.0], [0.0], [1.0 / A3], [0.0]])
    A = np.eye(4) + dt * Ac
    B = dt * Bc
    E = dt * Ec
    C = np.array([[1.0, 0.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0]])
    A, B, E, C = _f32(A, B, E, C)
    return LinearPlant(A, B, E, C, name="quadruple_tank")


ZOO = {
    "double_integrator": double_integrator,
    "mass_spring_damper": mass_spring_damper,
    "thermal_rc": thermal_rc,
    "random_stable": random_stable,
    "dc_motor": dc_motor,
    "aircraft_pitch": aircraft_pitch,
    "quadruple_tank": quadruple_tank,
}
