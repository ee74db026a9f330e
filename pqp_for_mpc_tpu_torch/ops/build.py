"""Build and load the hand-written CUDA kernels of ``csrc/``.

At first use :func:`load_library` compiles every ``csrc/*.cu`` into one
shared library with a plain C interface and loads it with ``ctypes``: one
``nvcc`` per source, all started together,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c -o <obj> csrc/<source>.cu

then one link, ``nvcc -shared -o <lib> <obj>...`` (no relocatable device
code: every object carries its own kernels).  The library goes to ``<repo>/.build/pqp_for_mpc_tpu_torch/`` under a name
that hashes the sources and the flags, so an edited source rebuilds and an
unchanged one loads at once; ``ptxas``'s register and shared-memory report
is kept beside it as ``<lib>.log``.  No ``--use_fast_math``: the update
needs IEEE division and subnormals (multipliers decaying from ``y0`` pass
through the subnormal range, and flushing them to zero would make
absorbing zeros early).  Every C entry point returns ``cudaGetLastError()``
after its launch; :func:`check` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / ".build" / \
    "pqp_for_mpc_tpu_torch"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong

#: argtypes of every C entry point (pointers and the stream as c_void_p,
#: so a 64-bit address is never cut to 32 bits)
SIGNATURES = {
    # qdn, qdp, fdn, fdp, fd_lane, y, y_out, n, B, num_iters, den_eps,
    # stream
    "pqp_iterations_f32": [_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _F, _P],
    # qdn, qdp, qd, gp, qp, qpi,
    # fp, fp_lane, fd, fd_lane, fdp, fdp_lane, fdn, fdn_lane,
    # kps, kps_lane, mp, mp_lane, md, md_lane, y0, y0_lane,
    # y_out, u_out, iters_out, state_out,
    # n, m, B, max_iters, check_every, accel_every,
    # eaj, erj, strict, den_eps, gap_comp, stream
    "full_solve_f32": [_P] * 6 + [_P, _I] * 8 + [_P] * 4 + [_I] * 6
    + [_F, _F, _I, _F, _I, _P],
    # the arguments of full_solve_f32
    "full_solve_packed_f32": [_P] * 6 + [_P, _I] * 8 + [_P] * 4 + [_I] * 6
    + [_F, _F, _I, _F, _I, _P],
    # q, q_bf16, theta, fdn, fdp, fd_lane, y, y_out, y_tmp, n, B,
    # num_iters, den_eps, stream
    "pqp_iterations_tiled": [_P, _I, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I,
                             _F, _P],
    # qh, theta, gp, qp, qpi, fp, fd, fdp, fdn, kps, mp, md, y0,
    # y_out, u_out, iters_out, state_out, yb, qdy, w, g, p, v, lane, part,
    # n, m, B, max_iters, check_every, accel, eaj, erj, strict, den_eps,
    # gap_comp, stream
    "full_solve_tiled_f32": [_P] * 25 + [_I] * 6 + [_F, _F, _I, _F, _I, _P],
    # qdn, qdp, qd, gp, gp_stride, qp, qpi, qp_stride,
    # fp, fd, fdp, fdn, kps, mp, md, y0, y_out, u_out, iters_out, state_out,
    # n, m, B, max_iters, check_every, accel_every, eaj, erj, strict,
    # den_eps, stream
    "full_solve_distinct_f32": [_P] * 4 + [_L] + [_P] * 2 + [_L]
    + [_P] * 12 + [_I] * 6 + [_F, _F, _I, _F, _P],
    # qh, theta, gp, gp_stride, qp, qpi, qp_stride,
    # fp, fd, fdp, fdn, kps, mp, md, y0, y_out, u_out, iters_out, state_out,
    # n, m, B, max_iters, check_every, accel, eaj, erj, strict, den_eps,
    # gap_comp, stream
    "full_solve_distinct_tiled_f32": [_P] * 3 + [_L] + [_P] * 2 + [_L]
    + [_P] * 12 + [_I] * 6 + [_F, _F, _I, _F, _I, _P],
    # q, q_bf16, theta, fdn, fdp, y, y_out, y_tmp, n, B, num_iters,
    # den_eps, stream
    "pqp_iterations_distinct_tiled": [_P, _I] + [_P] * 6 + [_I] * 3
    + [_F, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "pqp_for_mpc_tpu_torch/csrc at first use and need the "
                       "CUDA toolkit")


def _sources() -> list[Path]:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libpqp_kernels_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Compile (when the sources changed) and load the kernel library."""
    lib_path = library_path()
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build in a temporary directory, then rename the library into
        # place: a concurrent or interrupted build never leaves a
        # half-written library behind
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            nvcc = _nvcc()
            jobs = []
            for src in _sources():
                cmd = [nvcc, *NVCC_FLAGS, "-c", "-o",
                       os.path.join(tmp, src.stem + ".o"), str(src)]
                jobs.append((cmd, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            log = []
            failed = []
            for cmd, proc in jobs:
                out = proc.communicate()[0]
                log.append(" ".join(cmd) + "\n" + out)
                if proc.returncode != 0:
                    failed.append(log[-1])
            if failed:
                raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
            lib_tmp = os.path.join(tmp, lib_path.name)
            cmd = [nvcc, "-shared", "-o", lib_tmp,
                   *sorted(str(p) for p in Path(tmp).glob("*.o"))]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError("nvcc link failed:\n" + " ".join(cmd)
                                   + "\n" + proc.stdout + proc.stderr)
            Path(str(lib_path) + ".log").write_text("\n".join(log))
            os.replace(lib_tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.pqp_error_string.argtypes = [ctypes.c_int]
    lib.pqp_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, name: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if code != 0:
        msg = load_library().pqp_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


def stream_handle(device) -> ctypes.c_void_p:
    """The current PyTorch stream of ``device`` as a C pointer."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
