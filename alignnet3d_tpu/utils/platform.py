"""Platform helpers: the persistent compile cache, and the CPU backend.

On a machine with a GPU, JAX uses it by default. Tests and the
multi-device dry runs run on the CPU: set ``JAX_PLATFORMS=cpu`` in the
environment, or call ``force_cpu`` before the first JAX computation.
"""

from __future__ import annotations

import os
import re

# <repo>/.jax_cache: a fixed path, because the path is part of the cache
# key and a directory that moves never hits
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)


def setup_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    this sets no other directory. Otherwise the cache goes to
    ``DEFAULT_CACHE_DIR``. Entry points call this once, before their
    first compilation; importing the package never does.
    """
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def jax_backend_initialized() -> bool:
    """True if any JAX backend client has already been created.

    Once a backend exists, platform switches (``jax.config.update``,
    ``JAX_PLATFORMS``) are inert for this process — callers that need a
    different platform/device count must re-exec in a clean subprocess.
    """
    try:
        from jax._src import xla_bridge

        return bool(xla_bridge._backends)
    except Exception:  # pragma: no cover - private API moved
        return False


def force_cpu(num_devices: int | None = None) -> None:
    """Force the CPU backend, optionally with N virtual devices.

    Must be called before any JAX computation runs. ``num_devices`` only
    takes effect if the CPU client has not initialized yet; an existing
    ``xla_force_host_platform_device_count`` flag is raised (never
    lowered) to the requested count.
    """
    if num_devices is not None:
        flags = os.environ.get("XLA_FLAGS", "")
        m = re.search(r"--xla_force_host_platform_device_count=(\d+)", flags)
        if m is None:
            flags = (
                flags + f" --xla_force_host_platform_device_count={num_devices}"
            ).strip()
        elif int(m.group(1)) < num_devices:
            flags = (
                flags[: m.start()]
                + f"--xla_force_host_platform_device_count={num_devices}"
                + flags[m.end() :]
            )
        os.environ["XLA_FLAGS"] = flags
    import jax

    jax.config.update("jax_platforms", "cpu")
