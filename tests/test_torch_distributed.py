"""The port's multi-process entry points on a two-process gloo ring: the
cases of ``tests/test_distributed.py``, each rank one process with one
device (the CPU), against the JAX package's single-process solve.

* data axis: ``initialize`` + ``global_mesh`` (2 x 1), each rank builds
  only its ``process_local_batch_slice`` of the batch, solves it with
  ``solve_batched`` and all-gathers the lanes; held to the port's
  single-process solve (U within 1e-5, iterations and verdicts equal), and
  to JAX's with U within 1e-5 and iterations within the parity bar where
  both certify; under this strict configuration a lane's verdict can sit
  at the float32 floor of its gap, so each lane whose verdict differs from
  JAX's is audited below that floor in float64
  (``tests/test_torch_parallel.py``);
* model axis: ``solve_row_sharded`` on a 1 x 2 mesh, so every all-gather of
  Y and every partial-sum all-reduce crosses the process boundary; every
  lane certified, U within 5e-4 of JAX's ``solve_batched`` (its bar).

Marked slow, as the JAX package marks its two.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pqp_for_mpc_tpu import SolverConfig as JConfig
from pqp_for_mpc_tpu import dualize as jdualize
from pqp_for_mpc_tpu import solve_batched as jsolve_batched
from pqp_for_mpc_tpu.problem import PrimalQP as JPrimal
from pqp_for_mpc_tpu_torch import (PrimalQP, SolverConfig, dualize,
                                   solve_batched)
from test_torch_parallel import f64_gap_below_floor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: tests/test_distributed.py's configurations
CFG_DATA = dict(max_iters=20_000, check_every=4)
CFG_MODEL = dict(max_iters=20_000, check_every=4, accel_every=4, eaj=1e-3,
                 erj=1e-5, strict_weak_duality=False)

WORKER = r"""
import sys
rank, store, out, case = sys.argv[1:]
rank = int(rank)
import numpy as np, torch
torch.set_num_threads(1)
import pqp_for_mpc_tpu_torch.parallel.distributed as dist
from pqp_for_mpc_tpu_torch import (PrimalQP, SolverConfig, dualize,
                                   solve_batched)
from pqp_for_mpc_tpu_torch.parallel import make_mesh, solve_row_sharded
dist.initialize(init_method=f"file://{store}", num_processes=2,
                process_id=rank, device="cpu", timeout_s=120)
B, M, N = (16, 8, 20) if case == "data" else (8, 8, 16)
rng = np.random.default_rng(0)           # same instance on both ranks
L = rng.standard_normal((M, M)).astype(np.float32)
Qp = L @ L.T + M * np.eye(M, dtype=np.float32)
Qp_inv = np.linalg.inv(Qp).astype(np.float32)
Gp = rng.integers(-1, 2, (N, M)).astype(np.float32)
Kp = rng.uniform(1.0, 10.0, N).astype(np.float32)
Fp = rng.standard_normal((M, B)).astype(np.float32) * 5
Mp = rng.standard_normal(B).astype(np.float32)
t = torch.as_tensor
if case == "data":
    mesh = dist.global_mesh(model=1)
    assert tuple(mesh.shape) == (2, 1)
    sl = dist.process_local_batch_slice(B)     # only this rank's lanes
    primal = PrimalQP(Qp=t(Qp), Qp_inv=t(Qp_inv), Fp=t(Fp[:, sl]),
                      Mp=t(Mp[sl]), Gp=t(Gp), Kp=t(Kp))
    res = solve_batched(primal, dualize(primal),
                        cfg=SolverConfig(max_iters=20_000, check_every=4))
else:
    mesh = make_mesh(data=1, model=2, device_type="cpu")
    primal = PrimalQP(Qp=t(Qp), Qp_inv=t(Qp_inv), Fp=t(Fp), Mp=t(Mp),
                      Gp=t(Gp), Kp=t(Kp))
    res = solve_row_sharded(
        primal, dualize(primal),
        cfg=SolverConfig(max_iters=20_000, check_every=4, accel_every=4,
                         eaj=1e-3, erj=1e-5, strict_weak_duality=False),
        mesh=mesh)

def gather(x):           # the lanes of both ranks, in rank order
    parts = [torch.empty_like(x) for _ in range(2)]
    torch.distributed.all_gather(parts, x.contiguous())
    return torch.cat(parts, dim=-1).numpy()

if case == "data":
    z = {f: gather(getattr(res, f)) for f in ("U", "Y", "iters", "converged")}
else:                    # model-replicated U and verdicts: both hold all
    z = dict(U=res.U.numpy(), converged=res.converged.numpy())
torch.distributed.destroy_process_group()
assert "jax" not in sys.modules
np.savez(out, **z)
print("RANK", rank, "OK", flush=True)
"""


def _run(tmp_path, case):
    """Both ranks' saved results; on failure the log of the rank that
    failed."""
    outs = [str(tmp_path / f"{case}{r}.npz") for r in range(2)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(tmp_path / "store"),
         outs[r], case], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(2)]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        logs.append(out.decode(errors="replace"))
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-3000:]}"
        assert f"RANK {r} OK" in log
    return [dict(np.load(o)) for o in outs]


def _problem(B, M, N):
    rng = np.random.default_rng(0)
    L = rng.standard_normal((M, M)).astype(np.float32)
    Qp = L @ L.T + M * np.eye(M, dtype=np.float32)
    return dict(Qp=Qp, Qp_inv=np.linalg.inv(Qp).astype(np.float32),
                Gp=rng.integers(-1, 2, (N, M)).astype(np.float32),
                Kp=rng.uniform(1.0, 10.0, N).astype(np.float32),
                Fp=rng.standard_normal((M, B)).astype(np.float32) * 5,
                Mp=rng.standard_normal(B).astype(np.float32))


def _jax(a, cfg):
    """JAX's single-process solve of the NumPy problem ``a``, and its
    dual."""
    primal = JPrimal(**{k: jnp.asarray(v) for k, v in a.items()})
    dual = jdualize(primal)
    return jsolve_batched(primal, dual, cfg=JConfig(**cfg)), dual


@pytest.mark.slow
def test_two_process_data_parallel(tmp_path):
    ranks = _run(tmp_path, "data")
    a = _problem(16, 8, 20)
    primal = PrimalQP(**{k: torch.as_tensor(v) for k, v in a.items()})
    own = solve_batched(primal, dualize(primal), cfg=SolverConfig(**CFG_DATA))
    ref, ref_dual = _jax(a, CFG_DATA)
    conv = np.asarray(ref.converged)
    for z in ranks:
        np.testing.assert_allclose(z["U"], own.U.numpy(), rtol=1e-5,
                                   atol=1e-5)
        for f in ("iters", "converged"):
            np.testing.assert_array_equal(z[f], getattr(own, f).numpy())
        both = z["converged"] & conv
        np.testing.assert_allclose(z["U"][:, both], np.asarray(ref.U)[:, both],
                                   rtol=1e-5, atol=1e-5)
        want = np.asarray(ref.iters)[both]
        assert (np.abs(z["iters"][both].astype(np.int64) - want)
                <= np.maximum(5, want // 5)).all()
        for side, Y in ((z["converged"] & ~conv, z["Y"]),
                        (conv & ~z["converged"], np.asarray(ref.Y))):
            assert f64_gap_below_floor(a, ref_dual, Y, side).all()


@pytest.mark.slow
def test_two_process_model_axis(tmp_path):
    ranks = _run(tmp_path, "model")
    ref, _ = _jax(_problem(8, 8, 16), CFG_MODEL)
    assert bool(np.asarray(ref.converged).all())
    for z in ranks:
        assert z["converged"].all()
        np.testing.assert_allclose(z["U"], np.asarray(ref.U), rtol=5e-4,
                                   atol=5e-4)
