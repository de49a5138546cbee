from alignnet3d_tpu.utils.platform import (  # noqa: F401
    force_cpu,
    jax_backend_initialized,
    setup_compile_cache,
)
