"""JAX platform selection, device memory budget and compile cache.

The system runs on an NVIDIA GPU. With ``JAX_PLATFORMS`` unset the GPU
is required and its absence is an error at start-up; the CPU runs only
when asked for with ``JAX_PLATFORMS=cpu`` (tests, small local runs).
"""
import os

# the repository root: the compile cache lives inside the checkout
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# device memory assumed on the CPU backend, which reports no limit: a
# fixed test budget so that layout choices in tests do not depend on
# the host's RAM
CPU_TEST_BUDGET_BYTES = 16 << 30


class NoGpuError(RuntimeError):
    """No GPU is reachable and no other platform was asked for."""


def force_platform():
    """Pin JAX to the GPU unless JAX_PLATFORMS names a platform (JAX
    honours that variable itself). Must run before the first JAX
    computation."""
    import jax
    if not os.environ.get("JAX_PLATFORMS"):
        jax.config.update("jax_platforms", "cuda")
        try:
            jax.devices()
        except Exception as e:  # JAX raises several types for this
            raise NoGpuError(
                "no GPU found: metacache_tpu runs on an NVIDIA GPU "
                "(set JAX_PLATFORMS=cpu to run on the CPU instead); "
                f"JAX said: {type(e).__name__}: {e}") from e
    enable_compile_cache()


def ensure_feature_width(kmerlen: int):
    """Enable jax x64 mode for the 64-bit feature config (k > 16).

    The reference binds this at compile time (-DMC_KMER_TYPE=uint64_t,
    src/config.hpp:45-48); here it is a runtime switch that must flip
    before any u64 device array is created (without x64, jnp silently
    truncates uint64 to uint32)."""
    if kmerlen > 16:
        import jax
        if not jax.config.jax_enable_x64:
            jax.config.update("jax_enable_x64", True)


def hbm_budget_bytes(device=None) -> int:
    """Device memory available for the database, mirroring the
    reference's free-VRAM-minus-reserve sizing
    (src/gpu_hashmap.cu:1114-1133: free memory minus 2 GB).

    The total is the allocator's ``bytes_limit`` on a GPU and
    CPU_TEST_BUDGET_BYTES on the CPU; MC_HBM_GB overrides it. The
    reserve (max(2 GiB, 20%) of total) covers batch working sets, XLA
    scratch and the query step's intermediates.
    """
    env = os.environ.get("MC_HBM_GB")
    if env:
        total = int(float(env) * 2**30)
    else:
        import jax
        d = device if device is not None else jax.devices()[0]
        if d.platform == "cpu":
            total = CPU_TEST_BUDGET_BYTES
        else:
            total = (d.memory_stats() or {}).get("bytes_limit")
            if not total:
                raise RuntimeError(
                    f"device {d.device_kind!r} ({d.platform}) reports no "
                    "bytes_limit; set MC_HBM_GB to its memory in GiB")
    reserve = max(2 << 30, total // 5)
    return max(total - reserve, 64 << 20)


def compile_cache_dir() -> str | None:
    """Where this process should keep JAX's persistent compile cache:
    None when JAX_COMPILATION_CACHE_DIR is set (JAX reads it itself),
    else the fixed, git-ignored ``<repo>/.jax_cache``."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return os.path.join(_REPO, ".jax_cache")


def enable_compile_cache():
    """Persistent XLA compilation cache; MC_JAX_CACHE=0 disables."""
    if os.environ.get("MC_JAX_CACHE", "1") == "0":
        return
    import jax
    cache_dir = compile_cache_dir()
    if cache_dir is not None:
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
