"""LAM-TPU: a dense conjugate-gradient linear-algebra framework in JAX.

A ground-up JAX/XLA/Pallas/shard_map rebuild of the capabilities of the
"LAM — Linear Algebra for MeluXina" student-challenge library
(reference: C++17/CUDA/MPI/NCCL). The reference's six hand-written
parallel backends (OpenMP; MPI+OpenMP; single-GPU CUDA; single-node
multi-GPU CUDA; multi-node CUDA+MPI; multi-node CUDA+NCCL — see
challenge/main/LAM/include/LAM.hpp:1-16) collapse here into ONE CG
engine with placement expressed as sharding:

==============================================================================
reference backend (file)                          LAM-TPU configuration
------------------------------------------------------------------------------
ConjugateGradient_CPU_OMP.hpp                     backend="local"  (1 device)
ConjugateGradient_GPU_CUDA.cu                     backend="local"  (1 device)
ConjugateGradient_CPU_MPI_OMP.hpp                 backend="sharded" (mesh)
ConjugateGradient_MultiGPUS_CUDA.cu               backend="sharded" (mesh)
ConjugateGradient_MultiGPUS_CUDA_MPI.cu           backend="sharded" (mesh)
ConjugateGradient_MultiGPUS_CUDA_NCCL.cu          backend="sharded" (mesh)
==============================================================================

Per-platform defaults (precision, engine, how the Pallas kernel runs)
live in one table, lam_tpu/platform.py.
"""

import os as _os

import jax as _jax

from lam_tpu import platform as _platform

# The whole problem domain is fp64 (the reference instantiates <double>
# everywhere, e.g. ConjugateGradient_GPU_CUDA.cu:408). Enable x64 unless
# the embedding application opts out.
if not _os.environ.get("LAM_TPU_NO_X64"):
    _jax.config.update("jax_enable_x64", True)

# The GPU row's XLA flags, before the backend starts (lam_tpu/platform.py).
# They apply to the whole process; a value XLA_FLAGS already holds wins.
if _platform.expects_gpu():
    _platform.set_gpu_xla_flags()

# Persistent XLA compilation cache: solver programs are compiled once per
# (shape, config) and reused across processes.
CACHE_DIR = _os.path.join(_os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))), ".jax_cache")


def compile_cache_dir(environ=None, gpu=None):
    """Where this program points JAX's compilation cache, or None.

    None when JAX_COMPILATION_CACHE_DIR is set (JAX reads it itself, and
    the program sets no other directory) and off the GPU (an XLA:CPU
    entry is compiled for one host's CPU and must not travel with the
    checkout). Otherwise one fixed path inside the checkout, CACHE_DIR
    (gitignored)."""
    environ = _os.environ if environ is None else environ
    gpu = _platform.expects_gpu() if gpu is None else gpu
    if environ.get("JAX_COMPILATION_CACHE_DIR") or not gpu:
        return None
    return CACHE_DIR


if compile_cache_dir():
    _jax.config.update("jax_compilation_cache_dir", CACHE_DIR)


def force_platform(platform):
    """Switch the JAX platform ('cpu' or 'gpu') after import — the
    env-var route is closed once backends initialize; the virtual mesh,
    the multi-process workers and `lam-cg --platform cpu` call this.
    Forcing 'cpu' also turns the persistent compilation cache off (see
    above)."""
    _platform.lookup(platform)
    _jax.config.update("jax_platforms", platform)
    if platform == "cpu":
        _jax.config.update("jax_compilation_cache_dir", None)


from lam_tpu.solver.cg import (  # noqa: E402
    CGResult,
    cg_solve,
    cg_solve_block,
    cg_solve_ir,
)
from lam_tpu.solver.host_outer import cg_solve_ir_host  # noqa: E402
from lam_tpu.solver.operators import (  # noqa: E402
    DenseOperator,
    LinearOperator,
)
from lam_tpu.solver.api import ConjugateGradient  # noqa: E402

__all__ = [
    "CGResult",
    "cg_solve",
    "cg_solve_block",
    "cg_solve_ir",
    "cg_solve_ir_host",
    "DenseOperator",
    "LinearOperator",
    "ConjugateGradient",
    "force_platform",
]

__version__ = "0.1.0"
