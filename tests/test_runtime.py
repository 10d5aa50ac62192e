"""Process set-up helpers (utils/runtime): compile cache and device info."""
import jax

from raytracer_js_tpu.utils import runtime


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself and the
    helper sets nothing."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(runtime.CACHE_ENV, str(tmp_path))
    assert runtime.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_repo(monkeypatch):
    """Unset, the cache lands in the fixed <repo>/.jax_cache (never a
    temporary, pid- or time-derived path)."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv(runtime.CACHE_ENV, raising=False)
    try:
        path = runtime.enable_compile_cache()
        assert path == str(runtime.REPO / ".jax_cache")
        assert (runtime.REPO / "raytracer_js_tpu").is_dir()
        assert jax.config.jax_compilation_cache_dir == path
        assert runtime.enable_compile_cache() == path       # stable
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_device_info_names_the_device(monkeypatch):
    monkeypatch.setattr(runtime, "gpu_name_and_power", lambda: None)
    info = runtime.device_info()
    dev = jax.devices()[0]
    assert info == {"platform": dev.platform, "kind": dev.device_kind,
                    "count": len(jax.devices()), "gpu": None}


def test_gpu_name_without_driver(monkeypatch):
    """No nvidia-smi on the path: None, not an exception."""
    monkeypatch.setenv("PATH", "/nonexistent")
    assert runtime.gpu_name_and_power() is None
