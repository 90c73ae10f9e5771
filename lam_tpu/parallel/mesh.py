"""Device-mesh construction: the whole of the reference's bootstrap layer.

The reference hand-rolls device binding and communicator setup: hostname
hashing to derive local ranks (ConjugateGradient_MultiGPUS_CUDA_MPI.cu:444-456),
NCCL unique-id broadcast over MPI (..._NCCL.cu:309-327, measured at 3-7 s of
init time in TESTS/BEST_RESULTS), CUDA peer-access enablement
(MultiGPUS_CUDA.cu:336-349). Here all of that collapses into a
`jax.sharding.Mesh`; XLA emits the collectives (NCCL on GPUs).

Multi-host: call `jax.distributed.initialize()` before building the mesh
(done by `distributed_init()` below when requested); the same mesh program
then runs unchanged across hosts — the reference's separate "local" vs
"distributed" backends are one configuration here.
"""

from __future__ import annotations

import os
import subprocess

import jax
import numpy as np
from jax._src.distributed import global_state
from jax.sharding import Mesh

from lam_tpu import platform

ROWS_AXIS = "rows"


def distributed_init(coordinator_address=None, num_processes=None,
                     process_id=None, **kwargs):
    """Multi-process bootstrap: the jax.distributed analog of the
    reference's MPI_Init + NCCL unique-id broadcast + ncclCommInitRank
    (ConjugateGradient_MultiGPUS_CUDA_NCCL.cu:309-327) and its
    hostname-hash device binding (..._MPI.cu:444-456).

    With explicit arguments (the CLI's --coordinator/--num-processes/
    --process-id) this MUST succeed — errors propagate, exactly like a
    failed ncclCommInitRank would abort the reference. Called with no
    arguments it is the auto-detect form (cluster launchers such as
    Slurm) and
    'already initialized' is tolerated so library users can call it
    idempotently. After it returns, `jax.devices()` is the GLOBAL device
    list and the same mesh program runs unchanged across processes.

    On a GPU host each process gets ONE card (`local_device_ids`,
    process_id modulo the host's card count) unless the caller names
    them: a JAX process reserves most of every card it sees, so two
    processes that both saw all cards would run out of memory."""
    if (coordinator_address is not None and process_id is not None
            and "local_device_ids" not in kwargs
            and platform.expects_gpu()):
        kwargs["local_device_ids"] = [process_id % _local_gpu_count()]
    state = global_state
    if state.client is not None:
        if coordinator_address is not None:
            # the explicit form must either already be in effect (exact
            # topology match -> idempotent no-op, like a repeated
            # MPI_Initialized check) or fail loudly: a prior
            # initialization with a DIFFERENT topology cannot be
            # re-bootstrapped, and silently continuing would run the
            # wrong mesh — the moral equivalent of a second MPI_Init
            same = (
                state.coordinator_address == coordinator_address
                and (num_processes is None
                     or state.num_processes == num_processes)
                and (process_id is None or state.process_id == process_id))
            if not same:
                raise RuntimeError(
                    "jax.distributed is already initialized with a "
                    "different coordinator/process topology; it cannot "
                    "be re-bootstrapped in this process")
        return  # already initialized (matching or auto-detect): no-op
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id, **kwargs)
    except (RuntimeError, ValueError):
        if coordinator_address is not None:
            raise
        # auto-detect form: single-process or already initialized


def _local_gpu_count():
    """Cards this host gives the process: CUDA_VISIBLE_DEVICES when set,
    else what `nvidia-smi -L` lists (JAX's own count would initialize
    the backend before jax.distributed may)."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible:
        return len([d for d in visible.split(",") if d.strip()])
    out = subprocess.run(["nvidia-smi", "-L"], check=True,
                         capture_output=True, text=True).stdout
    return max(1, sum(line.startswith("GPU ") for line in out.splitlines()))


def make_mesh(n_devices=None, axis_name=ROWS_AXIS):
    """1-D mesh over the first n_devices (default: all) devices.

    The CG decomposition is 1-D data parallelism over matrix rows — the
    same decomposition as every reference backend (SURVEY.md §2.3) — so a
    1-D mesh is the natural shape (every card reaches every other at the
    same rate, so no device order is better than another).
    """
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(
            f"requested {n_devices} devices, have {len(devices)}")
    return Mesh(np.array(devices[:n_devices]), (axis_name,))
