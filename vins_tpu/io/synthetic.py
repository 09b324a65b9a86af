"""Synthetic visual-inertial world generator.

The reference validated on-device with a record/playback harness
(SURVEY.md §4 item 2); our primary offline equivalents are EuRoC replay
and this analytic generator, which provides *exact* ground truth for
trajectory, IMU, and landmark observations — the basis for solver
convergence tests (ATE ≈ 0 on noiseless data) and benchmarks.

Trajectory: a circle of radius `r` at angular rate `w`, with optional
vertical bobbing; body x-axis tracks the tangent (pure yaw attitude), so
closed-form position/velocity/acceleration/angular-rate exist everywhere.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Tuple

import jax
import numpy as np
import jax.numpy as jnp

from ..config import VinsConfig
from ..core.preintegration import ImuChunk
from ..core.state import FeatureTable, WindowState
from ..core.factors import Extrinsics
from ..utils import lie


class SyntheticWindow(NamedTuple):
    """Ground-truth window snapshot + raw IMU chunks + landmark geometry."""

    state: WindowState           # ground-truth window state (F frames)
    chunks: ImuChunk             # stacked [W, N] raw IMU between frames
    feats: FeatureTable          # observations of the landmarks
    landmarks: jnp.ndarray       # [L, 3] world points
    ext: Extrinsics
    gravity: jnp.ndarray         # [3]
    timestamps: jnp.ndarray      # [F]


def _traj(t, r=3.0, w=0.6, bob=0.3, bob_w=1.7):
    """Closed-form circle trajectory. Returns p, v, a, yaw, yaw_rate."""
    t = np.asarray(t, np.float64)
    p = np.stack([r * np.cos(w * t), r * np.sin(w * t),
                  bob * np.sin(bob_w * t)], -1)
    v = np.stack([-r * w * np.sin(w * t), r * w * np.cos(w * t),
                  bob * bob_w * np.cos(bob_w * t)], -1)
    a = np.stack([-r * w * w * np.cos(w * t), -r * w * w * np.sin(w * t),
                  -bob * bob_w * bob_w * np.sin(bob_w * t)], -1)
    yaw = w * t + np.pi / 2.0          # tangent direction of the circle
    yaw_rate = np.full_like(t, w)
    return p, v, a, yaw, yaw_rate


def make_synthetic_window(
    cfg: VinsConfig,
    n_landmarks: int = 80,
    seed: int = 0,
    noise_px: float = 0.0,
    imu_noise: float = 0.0,
    t0: float = 0.0,
    frame_dt: float = 0.1,
) -> SyntheticWindow:
    """Build one full window of ground-truth data.

    noise_px: observation noise in *pixels* (converted via focal length).
    imu_noise: multiplier on the config noise densities for IMU corruption.
    """
    rng = np.random.default_rng(seed)
    F = cfg.window.num_frames
    W = F - 1
    M = cfg.window.max_landmarks
    N = cfg.window.max_imu_per_edge
    g_mag = cfg.imu.gravity
    gravity = np.array([0.0, 0.0, g_mag])

    # Frame states.
    t_frames = t0 + frame_dt * np.arange(F)
    p_f, v_f, _, yaw_f, _ = _traj(t_frames)
    q_f = lie.np_yaw_quat(yaw_f)

    state = WindowState(
        p=jnp.asarray(p_f, jnp.float32),
        q=jnp.asarray(q_f, jnp.float32),
        v=jnp.asarray(v_f, jnp.float32),
        ba=jnp.zeros((F, 3), jnp.float32),
        bg=jnp.zeros((F, 3), jnp.float32),
        inv_depth=jnp.zeros((M,), jnp.float32),
    )

    # IMU chunks between frames (row 0 seeds with the sample AT frame i).
    n_sub = N - 1  # integration steps per edge
    dt_imu = frame_dt / n_sub
    dts = np.zeros((W, N), np.float32)
    accs = np.zeros((W, N, 3), np.float32)
    gyrs = np.zeros((W, N, 3), np.float32)
    for e in range(W):
        ts = t_frames[e] + dt_imu * np.arange(N)  # includes both endpoints
        _, _, a_w, yaw, yaw_rate = _traj(ts)
        Rwb = lie.np_quat_to_rotmat(lie.np_yaw_quat(yaw))
        acc_b = np.einsum("nij,nj->ni", Rwb.transpose(0, 2, 1), a_w + gravity)
        gyr_b = np.stack([np.zeros_like(yaw), np.zeros_like(yaw),
                          yaw_rate], -1)
        dts[e, 1:] = dt_imu
        accs[e] = acc_b
        gyrs[e] = gyr_b
    if imu_noise > 0:
        sq = 1.0 / np.sqrt(dt_imu)
        accs += rng.normal(size=accs.shape) * cfg.imu.acc_n * imu_noise * sq * 0.01
        gyrs += rng.normal(size=gyrs.shape) * cfg.imu.gyr_n * imu_noise * sq * 0.01
    chunks = ImuChunk(jnp.asarray(dts), jnp.asarray(accs), jnp.asarray(gyrs))

    # Landmarks: scattered in an annulus outside the circle, varied height.
    ang = rng.uniform(0, 2 * np.pi, n_landmarks)
    rad = rng.uniform(5.0, 9.0, n_landmarks)
    height = rng.uniform(-1.5, 1.5, n_landmarks)
    lms = np.stack([rad * np.cos(ang), rad * np.sin(ang), height], -1)

    # Extrinsics: camera looks along body +x (outward tangent), i.e.
    # R_ic maps camera axes (x right, y down, z forward) to body axes.
    R_ic = np.array([[0.0, 0.0, 1.0],
                     [-1.0, 0.0, 0.0],
                     [0.0, -1.0, 0.0]], np.float32)
    q_ic = lie.np_rotmat_to_quat(R_ic)
    t_ic = np.array([0.05, 0.0, 0.02], np.float32)
    ext = Extrinsics(tic=jnp.asarray(t_ic), qic=jnp.asarray(q_ic))

    # Project landmarks into every frame.
    obs = np.zeros((F, M, 2), np.float32)
    mask = np.zeros((F, M), bool)
    Rwb_f = lie.np_quat_to_rotmat(q_f)
    n_use = min(n_landmarks, M)
    fov_lim = 0.7  # |x/z|,|y/z| limit ~ 35deg half-FOV
    for f in range(F):
        pts_b = np.einsum("ij,nj->ni", Rwb_f[f].T, lms[:n_use] - p_f[f])
        pts_c = np.einsum("ij,nj->ni", R_ic.T, pts_b - t_ic)
        z = pts_c[:, 2]
        ok = z > 0.3
        xy = pts_c[:, :2] / np.maximum(z[:, None], 1e-6)
        ok &= (np.abs(xy[:, 0]) < fov_lim) & (np.abs(xy[:, 1]) < fov_lim)
        if noise_px > 0:
            xy = xy + rng.normal(size=xy.shape) * (noise_px / cfg.camera.focal)
        obs[f, :n_use] = xy
        mask[f, :n_use] = ok

    # Anchor = first frame that observes the slot; valid = >=2 observations.
    first = np.argmax(mask, axis=0).astype(np.int32)           # [M]
    n_obs = mask.sum(axis=0)
    valid = n_obs >= 2
    track_id = np.where(valid, np.arange(M), -1).astype(np.int32)

    # Ground-truth inverse depth at the anchor frame.
    inv_depth = np.zeros(M, np.float32)
    for m in range(n_use):
        if not valid[m]:
            continue
        f = first[m]
        pts_b = Rwb_f[f].T @ (lms[m] - p_f[f])
        pts_c = R_ic.T @ (pts_b - t_ic)
        inv_depth[m] = 1.0 / max(pts_c[2], 1e-3)

    feats = FeatureTable(
        obs=jnp.asarray(obs), mask=jnp.asarray(mask),
        anchor=jnp.asarray(first), valid=jnp.asarray(valid),
        track_id=jnp.asarray(track_id))
    state = state._replace(inv_depth=jnp.asarray(inv_depth))

    return SyntheticWindow(
        state=state, chunks=chunks, feats=feats,
        landmarks=jnp.asarray(lms, jnp.float32), ext=ext,
        gravity=jnp.asarray(gravity, jnp.float32),
        timestamps=jnp.asarray(t_frames, jnp.float32))


class SyntheticSequence(NamedTuple):
    """Per-frame streaming inputs + ground truth for N frames."""

    p: jnp.ndarray           # [N, 3] ground-truth positions
    q: jnp.ndarray           # [N, 4]
    v: jnp.ndarray           # [N, 3]
    chunks: ImuChunk         # stacked [N, S]; chunk k covers (k-1 -> k)
    ids: jnp.ndarray         # [N, Mi] per-frame visible track ids (-1 pad)
    obs: jnp.ndarray         # [N, Mi, 2]
    obs_valid: jnp.ndarray   # [N, Mi]
    landmarks: jnp.ndarray   # [L, 3]
    ext: Extrinsics
    gravity: jnp.ndarray
    timestamps: jnp.ndarray  # [N]


def make_synthetic_sequence(
    cfg: VinsConfig,
    n_frames: int = 60,
    n_landmarks: int = 400,
    seed: int = 0,
    noise_px: float = 0.0,
    frame_dt: float = 0.1,
    t0: float = 0.0,
    traj_kwargs: dict | None = None,
    imu_per_frame: int | None = None,
) -> SyntheticSequence:
    """Streamed version of make_synthetic_window: many frames around the
    circle with a larger landmark field, emitting per-frame (chunk, ids,
    obs) exactly as the front-end would feed the backend.

    imu_per_frame: integration sub-steps per frame interval (default:
    fill the whole buffer). Use a realistic count (e.g. 3-4 at 30 Hz
    camera / 100 Hz IMU) when chunks will be merged across frames.
    """
    tk = traj_kwargs or {}
    traj = lambda t: _traj(t, **tk)
    rng = np.random.default_rng(seed)
    S = cfg.window.max_imu_per_edge
    Mi = cfg.frontend.max_features
    gravity = np.array([0.0, 0.0, cfg.imu.gravity])

    t_frames = t0 + frame_dt * np.arange(n_frames)
    p_f, v_f, _, yaw_f, _ = traj(t_frames)
    q_f = lie.np_yaw_quat(yaw_f)

    n_sub = (S - 1) if imu_per_frame is None else imu_per_frame
    assert n_sub <= S - 1
    dt_imu = frame_dt / n_sub
    dts = np.zeros((n_frames, S), np.float32)
    accs = np.zeros((n_frames, S, 3), np.float32)
    gyrs = np.zeros((n_frames, S, 3), np.float32)
    for k in range(1, n_frames):
        ts = t_frames[k - 1] + dt_imu * np.arange(n_sub + 1)
        _, _, a_w, yaw, yaw_rate = traj(ts)
        Rwb = lie.np_quat_to_rotmat(lie.np_yaw_quat(yaw))
        accs[k, :n_sub + 1] = np.einsum(
            "nij,nj->ni", Rwb.transpose(0, 2, 1), a_w + gravity)
        gyrs[k, :n_sub + 1] = np.stack(
            [np.zeros_like(yaw), np.zeros_like(yaw), yaw_rate], -1)
        dts[k, 1:n_sub + 1] = dt_imu
    chunks = ImuChunk(jnp.asarray(dts), jnp.asarray(accs), jnp.asarray(gyrs))

    ang = rng.uniform(0, 2 * np.pi, n_landmarks)
    rad = rng.uniform(5.0, 9.0, n_landmarks)
    height = rng.uniform(-1.5, 1.5, n_landmarks)
    lms = np.stack([rad * np.cos(ang), rad * np.sin(ang), height], -1)

    R_ic = np.array([[0.0, 0.0, 1.0],
                     [-1.0, 0.0, 0.0],
                     [0.0, -1.0, 0.0]], np.float32)
    q_ic = lie.np_rotmat_to_quat(R_ic)
    t_ic = np.array([0.05, 0.0, 0.02], np.float32)
    ext = Extrinsics(tic=jnp.asarray(t_ic), qic=jnp.asarray(q_ic))

    Rwb_f = lie.np_quat_to_rotmat(q_f)
    fov_lim = 0.7
    ids_out = np.full((n_frames, Mi), -1, np.int32)
    obs_out = np.zeros((n_frames, Mi, 2), np.float32)
    ok_out = np.zeros((n_frames, Mi), bool)
    for f in range(n_frames):
        pts_b = np.einsum("ij,nj->ni", Rwb_f[f].T, lms - p_f[f])
        pts_c = np.einsum("ij,nj->ni", R_ic.T, pts_b - t_ic)
        z = pts_c[:, 2]
        vis = z > 0.3
        xy = pts_c[:, :2] / np.maximum(z[:, None], 1e-6)
        vis &= (np.abs(xy[:, 0]) < fov_lim) & (np.abs(xy[:, 1]) < fov_lim)
        sel = np.flatnonzero(vis)[:Mi]
        if noise_px > 0:
            xy = xy + rng.normal(size=xy.shape) * (noise_px / cfg.camera.focal)
        ids_out[f, :len(sel)] = sel
        obs_out[f, :len(sel)] = xy[sel]
        ok_out[f, :len(sel)] = True

    return SyntheticSequence(
        p=jnp.asarray(p_f, jnp.float32), q=jnp.asarray(q_f, jnp.float32),
        v=jnp.asarray(v_f, jnp.float32), chunks=chunks,
        ids=jnp.asarray(ids_out), obs=jnp.asarray(obs_out),
        obs_valid=jnp.asarray(ok_out),
        landmarks=jnp.asarray(lms, jnp.float32), ext=ext,
        gravity=jnp.asarray(gravity, jnp.float32),
        timestamps=jnp.asarray(t_frames, jnp.float32))


# ---------------------------------------------------------------------------
# Ray-cast renderer: textured cylinder room, geometrically exact parallax
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("H", "W"))
def _render_frames_device(p_cam: jax.Array, R_wc: jax.Array,
                          dirs_c: jax.Array, waves: Tuple[jax.Array, ...],
                          noise_key: jax.Array, params: jax.Array,
                          H: int, W: int) -> jax.Array:
    """Ray-cast all frames on device, one frame per lax.map step.

    p_cam/R_wc: [N,3] camera centers, [N,3,3] camera→world rotations;
    dirs_c: [H,W,3] unit camera-frame ray dirs; waves: (freqs [K,3],
    amps [K], phases [K]) texture basis; params: [4] = (wall_radius,
    floor_z, ceil_z, noise_sigma). The texture sum is one [HW,3]@[3,K]
    matmul + cos + [HW,K]@[K] contraction — device work instead of the
    former 96-iteration host numpy loop (~1 s/frame)."""
    freqs, amps, phases = waves
    wall_radius, floor_z, ceil_z, noise_sigma = (params[0], params[1],
                                                 params[2], params[3])

    def one(args):
        o, R, key = args
        d = dirs_c @ R.T                              # [H,W,3] world dirs
        # Cylinder x²+y²=R²: t from quadratic (camera strictly inside).
        a = d[..., 0] ** 2 + d[..., 1] ** 2
        b = 2 * (o[0] * d[..., 0] + o[1] * d[..., 1])
        c = o[0] ** 2 + o[1] ** 2 - wall_radius ** 2
        disc = jnp.maximum(b * b - 4 * a * c, 0.0)
        t_cyl = (-b + jnp.sqrt(disc)) / jnp.maximum(2 * a, 1e-9)
        # Floor / ceiling planes.
        dz = d[..., 2]
        safe = jnp.where(jnp.abs(dz) < 1e-6, jnp.sign(dz) * 1e-6 + 1e-12,
                         dz)
        t_flo = jnp.where(dz < -1e-6, (floor_z - o[2]) / safe, jnp.inf)
        t_cei = jnp.where(dz > 1e-6, (ceil_z - o[2]) / safe, jnp.inf)
        t_hit = jnp.minimum(jnp.minimum(t_cyl, t_flo), t_cei)
        pts = (o + d * t_hit[..., None]).reshape(-1, 3)
        ang = pts @ freqs.T + phases[None, :]         # [HW, K]
        tex = 0.5 + 1.6 * (jnp.cos(ang) @ amps)
        img = jnp.clip(0.15 + 0.55 * jnp.clip(tex, 0.0, 1.3), 0.0, 1.0)
        img = img + noise_sigma * jax.random.normal(key, img.shape)
        return jnp.clip(img, 0.0, 1.0).reshape(H, W)

    keys = jax.random.split(noise_key, p_cam.shape[0])
    return jax.lax.map(one, (p_cam, R_wc, keys))


def camera_ray_grid(cfg: VinsConfig, distorted: bool = False) -> np.ndarray:
    """[H, W, 3] unit camera-frame ray directions for every pixel. With
    `distorted`, rays are computed through the camera's radial-tangential
    model (utils.camera.pixel_to_normalized), so the rendered images look
    like a REAL distorted camera's output — straight lines curve, and the
    tracker must undistort to get correct geometry."""
    H, W = cfg.camera.height, cfg.camera.width
    cam = cfg.camera
    u, v = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32))
    if distorted:
        from ..utils import camera as cam_mod
        uv = jnp.asarray(np.stack([u, v], -1).reshape(-1, 2))
        xy = np.asarray(cam_mod.pixel_to_normalized(cam, uv)).reshape(H, W, 2)
        dirs_c = np.concatenate([xy, np.ones((H, W, 1), np.float32)], -1)
    else:
        dirs_c = np.stack([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy,
                           np.ones_like(u)], -1)
    return dirs_c / np.linalg.norm(dirs_c, axis=-1, keepdims=True)


def render_camera_frames(p_cam: np.ndarray, R_wc: np.ndarray,
                         cfg: VinsConfig, seed: int = 0,
                         wall_radius: float = 8.0,
                         floor_z: float = -2.0,
                         ceil_z: float = 2.0,
                         noise_sigma: float = 0.005,
                         distorted: bool = False,
                         tex_gain: float = 1.0,
                         tex_freq_max: float = 25.0,
                         device: bool = False) -> np.ndarray:
    """Ray-cast [N, H, W] frames of the textured cylinder room from
    arbitrary camera poses (p_cam [N,3] centers, R_wc [N,3,3] camera→world
    rotations). tex_gain/tex_freq_max sharpen the wave texture (higher
    contrast + finer detail ⇒ stronger trackable corners) without changing
    the default basis other tests' ground truth depends on."""
    rng = np.random.default_rng(seed + 77)
    H, W = cfg.camera.height, cfg.camera.width
    dirs_c = camera_ray_grid(cfg, distorted)

    # Texture wave basis (must be derived from the same rng stream as the
    # previous per-frame construction so textures stay band-limited 1/f).
    tex_rng = np.random.default_rng(seed + 77)
    n_waves = 96
    freqs = tex_rng.uniform(0.5, tex_freq_max,
                            (n_waves, 3)).astype(np.float32)
    mags = np.linalg.norm(freqs, axis=1, keepdims=True)
    amps = (1.0 / mags[:, 0]) ** 0.5
    amps = (amps / amps.sum() * tex_gain).astype(np.float32)
    phases = tex_rng.uniform(0, 2 * np.pi, n_waves).astype(np.float32)

    imgs = _render_frames_device(
        jnp.asarray(p_cam, jnp.float32), jnp.asarray(R_wc, jnp.float32),
        jnp.asarray(dirs_c), (jnp.asarray(freqs), jnp.asarray(amps),
                              jnp.asarray(phases)),
        jax.random.PRNGKey(rng.integers(2 ** 31)),
        jnp.asarray([wall_radius, floor_z, ceil_z, noise_sigma],
                    jnp.float32), H, W)
    # `device=True` skips the host round trip of a [N,H,W] stack
    # (hundreds of MB): the streaming pipeline consumes the frames on
    # the device anyway.
    return imgs if device else np.asarray(imgs)


def render_sequence_images(seq: SyntheticSequence, cfg: VinsConfig,
                           seed: int = 0,
                           wall_radius: float = 8.0,
                           floor_z: float = -2.0,
                           ceil_z: float = 2.0,
                           noise_sigma: float = 0.005,
                           device: bool = False) -> np.ndarray:
    """Render [N, H, W] float32 images by ray-casting a textured cylinder
    room (walls at `wall_radius`, floor/ceiling planes) around the
    trajectory. Every pixel's world point is exact, so parallax, optical
    flow, and triangulation ground truth are all geometrically consistent —
    unlike sprite-based rendering. Runs fully on device
    (_render_frames_device); the wave-texture basis matches the one used
    by ground_truth_correspondence's geometry."""
    R_ic = lie.np_quat_to_rotmat(np.asarray(seq.ext.qic))
    t_ic = np.asarray(seq.ext.tic)
    Rwb = lie.np_quat_to_rotmat(np.asarray(seq.q))
    p_f = np.asarray(seq.p)
    R_wc = np.einsum("nij,jk->nik", Rwb, R_ic)
    p_cam = p_f + np.einsum("nij,j->ni", Rwb, t_ic)
    return render_camera_frames(p_cam, R_wc, cfg, seed, wall_radius,
                                floor_z, ceil_z, noise_sigma,
                                device=device)


def ground_truth_correspondence(seq: SyntheticSequence, cfg: VinsConfig,
                                pts_px: np.ndarray, frame_a: int,
                                frame_b: int,
                                wall_radius: float = 8.0,
                                floor_z: float = -2.0,
                                ceil_z: float = 2.0) -> np.ndarray:
    """Exact correspondence of frame-a pixels in frame-b (the renderer's
    geometry), for validating tracking. Returns [K,2] pixel coords."""
    fx, fy, cx, cy = (cfg.camera.fx, cfg.camera.fy,
                      cfg.camera.cx, cfg.camera.cy)
    R_ic = lie.np_quat_to_rotmat(np.asarray(seq.ext.qic))
    t_ic = np.asarray(seq.ext.tic)
    Rwb = lie.np_quat_to_rotmat(np.asarray(seq.q))
    p_f = np.asarray(seq.p)

    R_wc = Rwb[frame_a] @ R_ic
    o = p_f[frame_a] + Rwb[frame_a] @ t_ic
    d_c = np.stack([(pts_px[:, 0] - cx) / fx, (pts_px[:, 1] - cy) / fy,
                    np.ones(len(pts_px), np.float32)], -1)
    d = d_c @ R_wc.T
    a = d[:, 0] ** 2 + d[:, 1] ** 2
    b = 2 * (o[0] * d[:, 0] + o[1] * d[:, 1])
    c = o[0] ** 2 + o[1] ** 2 - wall_radius ** 2
    t_cyl = (-b + np.sqrt(np.maximum(b * b - 4 * a * c, 0))) / np.maximum(
        2 * a, 1e-9)
    dz = d[:, 2]
    t_flo = np.where(dz < -1e-6, (floor_z - o[2]) / np.where(
        np.abs(dz) < 1e-6, -1e-6, dz), np.inf)
    t_cei = np.where(dz > 1e-6, (ceil_z - o[2]) / np.where(
        np.abs(dz) < 1e-6, 1e-6, dz), np.inf)
    t_hit = np.minimum(np.minimum(t_cyl, t_flo), t_cei)
    X = o + d * t_hit[:, None]

    R_wc2 = Rwb[frame_b] @ R_ic
    o2 = p_f[frame_b] + Rwb[frame_b] @ t_ic
    pc = (X - o2) @ R_wc2
    z = np.maximum(pc[:, 2], 1e-6)
    return np.stack([pc[:, 0] / z * fx + cx, pc[:, 1] / z * fy + cy], -1)


# ---------------------------------------------------------------------------
# Synthetic global-BA problem (for the distributed solver + benchmarks)
# ---------------------------------------------------------------------------


def make_ba_problem(n_poses: int = 16, n_landmarks: int = 512, seed: int = 0,
                    noise_px: float = 0.0, pose_noise: float = 0.0,
                    point_noise: float = 0.0, focal: float = 460.0):
    """Ground-truth + perturbed-initial-guess global BA instance.

    Poses walk a circle looking outward (same geometry as the window
    generator); landmarks fill an annulus. Returns
    (gt_state, init_state, problem) as parallel.dist_ba types.
    """
    from ..parallel.dist_ba import BAProblem, BAState

    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 2.2, n_poses)
    p_f, _, _, yaw_f, _ = _traj(t)
    # world-from-camera: camera z looks outward along body +x.
    R_ic = np.array([[0.0, 0.0, 1.0],
                     [-1.0, 0.0, 0.0],
                     [0.0, -1.0, 0.0]], np.float32)
    q_f = lie.np_yaw_quat(yaw_f)
    Rwb = lie.np_quat_to_rotmat(q_f)
    R_wc = Rwb @ R_ic
    q_wc = lie.np_rotmat_to_quat(R_wc)

    ang = rng.uniform(0, 2 * np.pi, n_landmarks)
    rad = rng.uniform(5.0, 9.0, n_landmarks)
    height = rng.uniform(-1.5, 1.5, n_landmarks)
    lms = np.stack([rad * np.cos(ang), rad * np.sin(ang), height],
                   -1).astype(np.float32)

    obs = np.zeros((n_landmarks, n_poses, 2), np.float32)
    mask = np.zeros((n_landmarks, n_poses), np.float32)
    for k in range(n_poses):
        pc = (lms - p_f[k]) @ R_wc[k]          # R_wcᵀ (X - p)
        z = pc[:, 2]
        ok = z > 0.5
        xy = pc[:, :2] / np.maximum(z[:, None], 1e-6)
        ok &= (np.abs(xy[:, 0]) < 0.8) & (np.abs(xy[:, 1]) < 0.8)
        if noise_px > 0:
            xy = xy + rng.normal(size=xy.shape) * (noise_px / focal)
        obs[:, k] = xy
        mask[:, k] = ok

    # Keep only landmarks with >=2 observations.
    mask[(mask.sum(1) < 2)] = 0.0

    gt = BAState(p=jnp.asarray(p_f, jnp.float32), q=jnp.asarray(q_wc),
                 pts=jnp.asarray(lms))
    p0 = p_f + rng.normal(size=p_f.shape) * pose_noise
    p0[:2] = p_f[:2]  # gauge anchors keep ground truth
    dth = rng.normal(size=(n_poses, 3)) * pose_noise * 0.2
    dth[:2] = 0.0
    q0 = lie.np_quat_mul(q_wc, lie.np_so3_exp_quat(dth))
    x0 = lms + rng.normal(size=lms.shape) * point_noise
    init = BAState(p=jnp.asarray(p0, jnp.float32), q=jnp.asarray(q0),
                   pts=jnp.asarray(x0, jnp.float32))
    pose_free = np.ones(n_poses, np.float32)
    pose_free[:2] = 0.0  # fix two poses: gauge + scale
    prob = BAProblem(obs=jnp.asarray(obs), mask=jnp.asarray(mask),
                     pose_free=jnp.asarray(pose_free))
    return gt, init, prob
