"""Per-platform defaults: the one place the solver asks which device it is on.

Each row says what `precision="auto"` and `engine="auto"` resolve to and
how the Pallas kernel (ops/gemv.py) runs there. A platform without a row
is an error, never a silent fallback.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os
import subprocess
import warnings

import jax


@dataclasses.dataclass(frozen=True)
class Platform:
    precision: str          # precision="auto"
    engine: str             # engine="auto"
    pallas_interpret: bool  # run Pallas kernels in the interpreter
    pallas_backend: str     # the Pallas route kernels compile through
    xla_flags: tuple = ()   # set before the backend starts


PLATFORMS = {
    # tests: native f64 under XLA, the kernel interpreted
    "cpu": Platform(precision="f64", engine="xla", pallas_interpret=True,
                    pallas_backend="triton"),
    # the card: native f64 under XLA, the kernel compiled through Triton.
    # XLA's GPU autotuner times candidate kernels on scratch copies of
    # their operands while it compiles: with the 36.5 GiB N=70000 matrix
    # resident, compiling its matvec would ask for a second one and run
    # out of memory. The solver's products are bandwidth-bound
    # reductions, and the kernel carries its own configuration. (Not a
    # per-program compiler option: JAX refuses those on a jit called
    # inside another jit, and the solver's loops nest.)
    "gpu": Platform(precision="f64", engine="xla", pallas_interpret=False,
                    pallas_backend="triton",
                    xla_flags=("--xla_gpu_autotune_level=0",)),
}


def lookup(name):
    try:
        return PLATFORMS[name]
    except KeyError:
        raise RuntimeError(
            f"platform {name!r} has no row in lam_tpu.platform.PLATFORMS "
            f"(known: {', '.join(PLATFORMS)})") from None


def current():
    """The row of the platform JAX computes on."""
    return lookup(jax.default_backend())


_CUDA_PLUGINS = ("jax_cuda13_plugin", "jax_cuda12_plugin",
                 "jax_plugins.xla_cuda13", "jax_plugins.xla_cuda12")


def _importable(name):
    try:
        return importlib.util.find_spec(name) is not None
    except ModuleNotFoundError:
        return False


def expects_gpu():
    """Whether JAX will pick the GPU, decided WITHOUT initializing a
    backend (callers run before jax.distributed.initialize and before
    the compilation cache is first consulted): a CUDA plugin is
    installed and neither JAX_PLATFORMS nor jax_platforms pins the
    CPU."""
    pinned = jax.config.jax_platforms or os.environ.get("JAX_PLATFORMS", "")
    names = {p.strip().lower() for p in pinned.split(",") if p.strip()}
    if names and not names & {"gpu", "cuda"}:
        return False
    return any(_importable(m) for m in _CUDA_PLUGINS)


def add_xla_flags(flags, environ=None):
    """Append `flags` to XLA_FLAGS; a flag the environment already
    names keeps its value. Returns the flags it added."""
    environ = os.environ if environ is None else environ
    current = environ.get("XLA_FLAGS", "")
    added = [f for f in flags if f.split("=")[0] not in current]
    environ["XLA_FLAGS"] = " ".join([current, *added]).strip()
    return added


def set_gpu_xla_flags(environ=None, backend_started=None):
    """Add the gpu row's XLA flags (lam_tpu/__init__.py calls this at
    import). XLA reads XLA_FLAGS once, when JAX starts its backend: if
    that happened before, the flags added now cannot take effect, and
    this warns instead of leaving the out-of-memory failure they prevent
    to show up later."""
    added = add_xla_flags(PLATFORMS["gpu"].xla_flags, environ)
    if backend_started is None:
        from jax._src import xla_bridge
        backend_started = xla_bridge.backends_are_initialized()
    if added and backend_started:
        warnings.warn(
            f"JAX started its backend before lam_tpu was imported, so "
            f"XLA_FLAGS {' '.join(added)} cannot take effect; compiling "
            f"a matvec over a matrix larger than a third of the card's "
            f"memory may run out of memory. Import lam_tpu first, or set "
            f"XLA_FLAGS before JAX starts.", RuntimeWarning, stacklevel=3)
    return added


def card_line():
    """`name, power.limit` of every card, as nvidia-smi reports them —
    printed beside every device measurement (a card set below its
    maximum power runs slower under load)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return "; ".join(line.strip() for line in out.splitlines()
                     if line.strip())


def require_gpu():
    """Fail, never fall back, when JAX computes on anything but a GPU —
    for the measurement paths, whose numbers must come from the card.
    Returns the device description those paths record."""
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"needs an NVIDIA GPU, JAX found {backend!r}")
    d = jax.devices()[0]
    return {"platform": d.platform, "device_kind": d.device_kind,
            "device_count": len(jax.devices()), "card": card_line()}
