"""Checks that only a GPU can make: the FUSED kernel compiled through
Triton (no interpret mode exists for the compiled route) and the HIGHEST
one-hot gather without TF32 rounding. Skipped on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracer_js_tpu import RenderConfig, make_camera, render_hdr
from raytracer_js_tpu.config import HitBackend
from raytracer_js_tpu.ops.gather import onehot_gather

from scenes import config1_scene

pytestmark = pytest.mark.gpu


def test_fused_frame_compiles_through_triton(gpu):
    scene = config1_scene(with_glass=True, with_tri=True)
    cam = make_camera((0.0, 0.0, 0.5), 256, 256, np.pi / 2, np.pi / 2)
    cfg = RenderConfig(refmax=3, backend=HitBackend.FUSED)
    fused = jax.jit(lambda s: render_hdr(s, cam, cfg)).lower(scene).compile()
    assert "__gpu$xla.gpu.triton" in fused.as_text()
    brute = render_hdr(scene, cam, dataclasses.replace(
        cfg, backend=HitBackend.BRUTE))
    np.testing.assert_allclose(np.asarray(fused(scene)), np.asarray(brute),
                               rtol=1e-4, atol=1e-4)


def test_onehot_gather_exact(gpu):
    k1, k2 = jax.random.split(jax.random.key(1))
    table = jax.random.normal(k1, (1000, 16), jnp.float32)
    idx = jax.random.randint(k2, (1 << 16,), 0, 1000, jnp.int32)
    np.testing.assert_array_equal(np.asarray(jax.jit(onehot_gather)(idx, table)),
                                  np.asarray(jnp.take(table, idx, axis=0)))
