"""Inverse-rendering fit loop (new capability; BASELINE.json config 5).

The reference engine is forward-only; differentiability is the point of this
re-design: pixel loss -> gradients on material colors, entity geometry and
camera pose (SURVEY.md §2 #13 "differentiable leaves"), optimized with optax.

Multi-view batching: config 5 renders an 8-view batch per step; views vmap
over cameras, and under a device mesh the (view, ray) space is sharded via
:mod:`raytracer_js_tpu.parallel.sharding` with psum-reduced gradients.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import optax

from ..config import RenderConfig
from ..models.camera import Camera, pixel_rays
from ..models.scene import Scene
from ..parallel.sharding import RAY_AXIS, float_partition, shard_map
from ..render import render_rays

Array = jnp.ndarray


@dataclasses.dataclass(frozen=True)
class FitConfig:
    steps: int = 100
    lr: float = 1e-2
    optimizer: str = "adam"   # "adam" | "sgd"
    #: checkpoint every N steps into ``ckpt_dir`` (0 = off); a fit restarted
    #: with the same ckpt_dir resumes from the newest snapshot.
    save_every: int = 0
    ckpt_dir: str | None = None
    #: path-replay gradients: re-record the discrete trace structure
    #: (ops/trace.record_paths) every N steps and differentiate the
    #: search-free REPLAY in between (0 = off). One recording costs one
    #: plain forward; every step in between skips the nearest-hit search
    #: entirely — the steady-state speedup for big-scene inverse rendering.
    #: Between recordings the winner sets are slightly stale as geometry
    #: moves (the usual amortized-replay approximation; gradients remain
    #: exact for the recorded structure). replay_every=1 is EXACTLY the
    #: search path's gradient at every step.
    replay_every: int = 0
    #: accel staleness policy for the OCTREE backend: rebuild the octree
    #: from the CURRENT geometry every N steps (0 = never; the accel then
    #: goes stale as leaves move — the nearest-hit search may pick a wrong
    #: primitive near moved geometry, though gradients stay well-defined
    #: through the analytic surface recompute). Rebuilds are host-side and
    #: shape-pinned (accel/octree.build_octree ``like=``) so jit caches
    #: survive. Measured pinned-rebuild cost at depth 8 (native scenekit
    #: CSR): ~2.4 s at 100k prims, ~8.3 s at 1M prims — dominated by the
    #: 16.7M-cell offsets pass, so amortize with accel_every >> 1.
    accel_every: int = 0
    #: optimize the camera poses too (SURVEY §7 step 7: "camera pose
    #: gradients"). Each camera's (pos, front, left, up) leaves join the
    #: param vector AFTER the scene leaves (``trainable`` indices for scene
    #: leaves are unchanged); pixel rays are generated inside the loss from
    #: the rebuilt cameras (models/camera.pixel_rays is closed-form and
    #: differentiable in the pose — the one gradient the reference's
    #: sequential Givens scan cannot express), and the triad is
    #: re-orthonormalized (models/camera.renormalized) after every
    #: optimizer step, the standard manifold-projection retraction.
    fit_cameras: bool = False


@dataclasses.dataclass
class FitResult:
    scene: Scene
    losses: list
    #: fitted cameras (None unless FitConfig.fit_cameras)
    cameras: Optional[list] = None


def _project_triad_grads(params, grads, n_scene: int, n_cams: int):
    """Riemannian projection of camera-triad gradients onto rotations.

    The raw 9-dim (front, left, up) gradient contains radial (scale)
    components — the loss can be decreased by SHRINKING ``front`` (pixel
    ray directions are linear in the triad, so |front| modulates every
    path length and hence the ISL brightness) — which the per-step
    re-orthonormalization then undoes, ratcheting the pose away from the
    target (measured r4: plain adam/sgd on raw triad leaves *diverges* on
    a smooth rotation-recovery landscape whose triad gradients are
    FD-exact). The tangent space of the orthonormal-triad manifold is
    {δv = ω x v}; the projected gradient is the rotation vector
    ``ω = Σ_v v x g_v`` written back per leaf as ``g_v := ω x v``, which
    is a strict descent direction (dL = -lr |ω|² for an SGD step).
    """
    from ..ops.vecmath import cross

    grads = list(grads)
    for i in range(n_cams):
        o = n_scene + 4 * i + 1
        f, l, u = params[o], params[o + 1], params[o + 2]
        w = (cross(f, grads[o]) + cross(l, grads[o + 1])
             + cross(u, grads[o + 2]))
        grads[o] = cross(w, f)
        grads[o + 1] = cross(w, l)
        grads[o + 2] = cross(w, u)
    return grads


def _make_opt(cfg: FitConfig):
    if cfg.optimizer == "adam":
        return optax.adam(cfg.lr)
    if cfg.optimizer == "sgd":
        return optax.sgd(cfg.lr)
    raise ValueError(cfg.optimizer)


def multiview_loss(scene: Scene, cfg: RenderConfig, cameras: Sequence[Camera],
                   targets: Array, key: Array, accel=None) -> Array:
    """Mean-squared pixel loss over a view batch.

    ``targets`` is [V, h*w, 3] (flattened per view). Views share the scene;
    each view's rays get distinct global ids so RNG stays sharding-stable.
    """
    total = jnp.zeros((), jnp.float32)
    n_pix = 0
    for v, cam in enumerate(cameras):
        org, dirs = pixel_rays(cam)
        rid = jnp.arange(org.shape[0], dtype=jnp.int32) + v * org.shape[0]
        colors = render_rays(scene, cfg, org, dirs, key, rid, accel=accel)
        total = total + jnp.sum((colors - targets[v]) ** 2)
        n_pix += org.shape[0]
    return total / n_pix


def fit(scene: Scene, cfg: RenderConfig, cameras: Sequence[Camera],
        targets: Array, fit_cfg: FitConfig = FitConfig(),
        key: Optional[Array] = None,
        trainable: Optional[Callable[[int, Array], bool]] = None,
        mesh=None, accel=None) -> FitResult:
    """Optimize the scene's float leaves to match ``targets``.

    ``trainable(i, leaf)`` masks which float leaves receive updates (by
    zeroing their gradients) — e.g. train texture colors only. With ``mesh``
    the per-step gradient runs ray-sharded with an implicit psum (see
    parallel/sharding.sharded_fit_step notes).

    ``accel`` (OCTREE backend) follows the ``FitConfig.accel_every``
    staleness policy: rebuilt host-side from the current geometry every N
    steps with shapes pinned to the initial build, so the step stays
    jit-cached across rebuilds.
    """
    if key is None:
        key = jax.random.key(0)
    scene_params, rebuild_scene = float_partition(scene)
    n_scene = len(scene_params)
    params = list(scene_params)
    if fit_cfg.fit_cameras:
        for cam in cameras:
            params += [cam.pos, cam.front, cam.left, cam.up]

    def rebuild_all(params):
        if not fit_cfg.fit_cameras:
            return rebuild_scene(params), list(cameras)
        sc = rebuild_scene(params[:n_scene])
        cams = []
        for i, cam in enumerate(cameras):
            o = n_scene + 4 * i
            cams.append(cam.replace(pos=params[o], front=params[o + 1],
                                    left=params[o + 2], up=params[o + 3]))
        return sc, cams

    def rebuild(params):                      # scene-only view (ckpt etc.)
        return rebuild_all(params)[0]

    opt = _make_opt(fit_cfg)
    opt_state = opt.init(params)

    def loss_fn(params, key, accel):
        sc, cams = rebuild_all(params)
        return multiview_loss(sc, cfg, cams, targets, key, accel=accel)

    from ..models.camera import renormalized
    from ..ops.trace import record_paths, trace_rays
    from ..render import start_substance

    def record_fn(params, key, accel):
        sc, cams = rebuild_all(params)
        recs = []
        for v, cam in enumerate(cams):
            org, dirs = pixel_rays(cam)
            rid = (jnp.arange(org.shape[0], dtype=jnp.int32)
                   + v * org.shape[0])
            refr0 = jnp.broadcast_to(start_substance(sc, cam.pos),
                                     (org.shape[0],))
            recs.append(record_paths(sc, cfg, org, dirs, key, rid,
                                     start_refr=refr0, accel=accel))
        return recs

    def loss_replay(params, key, recs):
        sc, cams = rebuild_all(params)
        total = jnp.zeros((), jnp.float32)
        n_pix = 0
        for v, cam in enumerate(cams):
            org, dirs = pixel_rays(cam)
            rid = (jnp.arange(org.shape[0], dtype=jnp.int32)
                   + v * org.shape[0])
            refr0 = jnp.broadcast_to(start_substance(sc, cam.pos),
                                     (org.shape[0],))
            st = trace_rays(sc, cfg, org, dirs, key, rid,
                            start_refr=refr0, pid_seq=recs[v])
            total = total + jnp.sum((st.color - targets[v]) ** 2)
            n_pix += org.shape[0]
        return total / n_pix

    if fit_cfg.replay_every and cfg.spp != 1:
        raise ValueError("replay_every requires spp == 1 (one recorded "
                         "structure per ray)")

    if mesh is None:
        record_jit = jax.jit(record_fn)
        replay_grad = jax.jit(jax.value_and_grad(loss_replay, argnums=0))
        grad_fn = jax.jit(jax.value_and_grad(loss_fn, argnums=0))
    else:
        # Sharded path: every view's rays split over the RAY_AXIS (scene,
        # accel and camera poses replicated; targets [V, N, 3] shard over
        # N). Replay composes with the mesh by recording per shard —
        # pid_seq is sharding-stable because the RNG streams key off the
        # GLOBAL ray id — and replaying inside the shard_map body; the
        # implicit psum of replicated-param cotangents all-reduces the
        # gradients exactly as in the search path (see
        # parallel.sharding.sharded_fit_step NOTE).
        from jax.sharding import PartitionSpec as P

        view_rays = [pixel_rays(cam) for cam in cameras]
        orgs = jnp.stack([o for o, _ in view_rays])          # [V, N, 3]
        dirss = jnp.stack([d for _, d in view_rays])
        n_views, n_view = orgs.shape[0], orgs.shape[1]
        n_dev = mesh.devices.size
        if n_view % n_dev:
            raise ValueError(
                f"rays per view ({n_view}) must divide over {n_dev} devices")
        rids = (jnp.arange(n_view, dtype=jnp.int32)[None, :]
                + jnp.arange(n_views, dtype=jnp.int32)[:, None] * n_view)
        n_total = n_views * n_view
        def _local_loss(params, o, d, rid, tgt, key, accel, recs):
            sc = rebuild(params)
            total = jnp.zeros((), jnp.float32)
            for v in range(n_views):
                refr0 = jnp.broadcast_to(start_substance(sc, o[v, 0]),
                                         (o.shape[1],))
                st = trace_rays(sc, cfg, o[v], d[v], key, rid[v],
                                start_refr=refr0, accel=accel,
                                pid_seq=None if recs is None else recs[v])
                total = total + jnp.sum((st.color - tgt[v]) ** 2)
            return total / n_total

        ray_sp = P(None, RAY_AXIS)

        def _search_step(params, o, d, rid, tgt, key, accel):
            loss, grads = jax.value_and_grad(_local_loss)(
                params, o, d, rid, tgt, key, accel, None)
            return jax.lax.psum(loss, RAY_AXIS), grads

        def _replay_step(params, o, d, rid, tgt, recs, key):
            loss, grads = jax.value_and_grad(_local_loss)(
                params, o, d, rid, tgt, key, None, recs)
            return jax.lax.psum(loss, RAY_AXIS), grads

        def _record_local(params, o, d, rid, key, accel):
            sc = rebuild(params)
            outs = []
            for v in range(n_views):
                refr0 = jnp.broadcast_to(start_substance(sc, o[v, 0]),
                                         (o.shape[1],))
                outs.append(record_paths(sc, cfg, o[v], d[v], key,
                                         rid[v], start_refr=refr0,
                                         accel=accel))
            return jnp.stack(outs)                   # [V, n_shard, refmax]

        if fit_cfg.fit_cameras:
            # Camera-pose leaves are replicated params, so each shard must
            # generate its rays FROM the rebuilt cameras (the pose gradient
            # flows through pixel_rays) — the full closed-form view is
            # evaluated per shard (replicated compute, [n_view, 3] f32 —
            # trivial next to the trace) and dynamically sliced to the
            # shard's ray range by axis_index; the slice transpose routes
            # the ray cotangents back into the replicated pose leaves with
            # the same automatic psum as every other replicated param.
            shard_n = n_view // n_dev

            def _rays_shard(cams, v):
                org, d = pixel_rays(cams[v])
                s = jax.lax.axis_index(RAY_AXIS) * shard_n
                return (jax.lax.dynamic_slice_in_dim(org, s, shard_n),
                        jax.lax.dynamic_slice_in_dim(d, s, shard_n),
                        jnp.arange(shard_n, dtype=jnp.int32) + s
                        + v * n_view)

            def _local_loss_c(params, tgt, key, accel, recs):
                sc, cams = rebuild_all(params)
                total = jnp.zeros((), jnp.float32)
                for v in range(n_views):
                    o, d, rid = _rays_shard(cams, v)
                    refr0 = jnp.broadcast_to(
                        start_substance(sc, cams[v].pos), (shard_n,))
                    st = trace_rays(sc, cfg, o, d, key, rid,
                                    start_refr=refr0, accel=accel,
                                    pid_seq=None if recs is None
                                    else recs[v])
                    total = total + jnp.sum((st.color - tgt[v]) ** 2)
                return total / n_total

            def _search_step_c(params, tgt, key, accel):
                loss, grads = jax.value_and_grad(_local_loss_c)(
                    params, tgt, key, accel, None)
                return jax.lax.psum(loss, RAY_AXIS), grads

            def _replay_step_c(params, tgt, recs, key):
                loss, grads = jax.value_and_grad(_local_loss_c)(
                    params, tgt, key, None, recs)
                return jax.lax.psum(loss, RAY_AXIS), grads

            def _record_local_c(params, key, accel):
                sc, cams = rebuild_all(params)
                outs = []
                for v in range(n_views):
                    o, d, rid = _rays_shard(cams, v)
                    refr0 = jnp.broadcast_to(
                        start_substance(sc, cams[v].pos), (shard_n,))
                    outs.append(record_paths(sc, cfg, o, d, key,
                                             rid, start_refr=refr0,
                                             accel=accel))
                return jnp.stack(outs)           # [V, n_shard, refmax]

            search_sh = shard_map(
                _search_step_c, mesh=mesh,
                in_specs=(P(), ray_sp, P(), P()), out_specs=(P(), P()))
            replay_sh = shard_map(
                _replay_step_c, mesh=mesh,
                in_specs=(P(), ray_sp, ray_sp, P()), out_specs=(P(), P()))
            record_sh = shard_map(
                _record_local_c, mesh=mesh,
                in_specs=(P(), P(), P()), out_specs=ray_sp)
            grad_fn = jax.jit(
                lambda p, k, accel: search_sh(p, targets, k, accel))
            record_jit = jax.jit(
                lambda p, k, accel: record_sh(p, k, accel))
            replay_grad = jax.jit(
                lambda p, k, recs: replay_sh(p, targets, recs, k))
        else:
            search_sh = shard_map(
                _search_step, mesh=mesh,
                in_specs=(P(), ray_sp, ray_sp, ray_sp, ray_sp, P(), P()),
                out_specs=(P(), P()))
            replay_sh = shard_map(
                _replay_step, mesh=mesh,
                in_specs=(P(), ray_sp, ray_sp, ray_sp, ray_sp, ray_sp, P()),
                out_specs=(P(), P()))
            record_sh = shard_map(
                _record_local, mesh=mesh,
                in_specs=(P(), ray_sp, ray_sp, ray_sp, P(), P()),
                out_specs=ray_sp)
            grad_fn = jax.jit(
                lambda p, k, accel: search_sh(p, orgs, dirss, rids, targets,
                                              k, accel))
            record_jit = jax.jit(
                lambda p, k, accel: record_sh(p, orgs, dirss, rids, k,
                                              accel))
            replay_grad = jax.jit(
                lambda p, k, recs: replay_sh(p, orgs, dirss, rids, targets,
                                             recs, k))

    start_step = 0
    if fit_cfg.ckpt_dir:
        from ..utils import checkpoint as ckpt

        newest = ckpt.latest(fit_cfg.ckpt_dir)
        if newest is not None:
            (params, opt_state), start_step, _ = ckpt.restore(
                newest, (params, opt_state))

    losses = []
    for step in range(start_step, fit_cfg.steps):
        if (accel is not None and fit_cfg.accel_every
                and step > start_step
                and (step - start_step) % fit_cfg.accel_every == 0):
            from ..accel.octree import build_octree
            from ..config import OctreeConfig

            accel = build_octree(
                rebuild(params), OctreeConfig(max_depth=accel.max_depth),
                l_cut=accel.l_cut, like=accel)
        k = jax.random.fold_in(key, step)
        if fit_cfg.replay_every:
            if ((step - start_step) % fit_cfg.replay_every == 0
                    or step == start_step):
                recs = record_jit(params, k, accel)
            loss, grads = replay_grad(params, k, recs)
        else:
            loss, grads = grad_fn(params, k, accel)
        if trainable is not None:
            grads = [g if trainable(i, p) else jnp.zeros_like(g)
                     for i, (g, p) in enumerate(zip(grads, params))]
        if fit_cfg.fit_cameras:
            grads = _project_triad_grads(params, grads, n_scene,
                                         len(cameras))
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        if fit_cfg.fit_cameras:
            # manifold retraction: gradient steps denormalize the triad;
            # project back to orthonormal before the next render
            _, cams_now = rebuild_all(params)
            for i, cam in enumerate(cams_now):
                cam = renormalized(cam)
                o = n_scene + 4 * i
                params[o + 1] = cam.front
                params[o + 2] = cam.left
                params[o + 3] = cam.up
        losses.append(float(loss))
        if (fit_cfg.ckpt_dir and fit_cfg.save_every
                and (step + 1) % fit_cfg.save_every == 0):
            from ..utils import checkpoint as ckpt

            import pathlib

            pathlib.Path(fit_cfg.ckpt_dir).mkdir(parents=True, exist_ok=True)
            ckpt.save(pathlib.Path(fit_cfg.ckpt_dir) / f"ckpt_{step + 1}",
                      (params, opt_state), step=step + 1)
    sc_out, cams_out = rebuild_all(params)
    return FitResult(scene=sc_out, losses=losses,
                     cameras=cams_out if fit_cfg.fit_cameras else None)
