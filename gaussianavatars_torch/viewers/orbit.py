"""Orbit/trackball camera + keyframe timeline for the interactive viewers.

Host-side equivalent of `utils/viewer_utils.py:73-403` (OrbitCamera) and the
keyframe camera path with cubic interpolation in `local_viewer.py:122-288`.
The port's own copy of the JAX package's `viewers/orbit.py`: numpy and
scipy, producing the port's `Camera` (its tensors on the device asked for).
Camera states and keyframe files written by either package load in the
other.
"""
from __future__ import annotations

import json
import math
from typing import List, Optional

import numpy as np


def _rotmat_from_axis_angle(axis: np.ndarray, angle: float) -> np.ndarray:
    axis = axis / (np.linalg.norm(axis) + 1e-12)
    K = np.array([
        [0, -axis[2], axis[1]],
        [axis[2], 0, -axis[0]],
        [-axis[1], axis[0], 0],
    ])
    return np.eye(3) + math.sin(angle) * K + (1 - math.cos(angle)) * (K @ K)


class OrbitCamera:
    """Trackball orbit camera (OpenCV convention: x right, y down, z forward)."""

    def __init__(
        self,
        width: int = 802,
        height: int = 550,
        radius: float = 1.0,
        fovy: float = 0.6981,  # 40°, the demo default
        center=(0.0, 0.0, 0.0),
        convention: str = "opencv",
    ):
        self.width = width
        self.height = height
        self.radius = radius
        self.fovy = fovy
        self.center = np.asarray(center, np.float64)
        # Camera-to-world rotation; identity looks down +z (opencv).
        self.rot = np.eye(3)
        self.convention = convention

    # -- interaction --------------------------------------------------------
    def orbit(self, dx: float, dy: float, sensitivity: float = 0.004) -> None:
        up = self.rot[:, 1]
        right = self.rot[:, 0]
        self.rot = _rotmat_from_axis_angle(up, -dx * sensitivity) @ self.rot
        self.rot = _rotmat_from_axis_angle(right, -dy * sensitivity) @ self.rot

    def pan(self, dx: float, dy: float, sensitivity: float = 0.001) -> None:
        self.center -= sensitivity * self.radius * (
            self.rot[:, 0] * dx + self.rot[:, 1] * dy
        )

    def scale(self, delta: float) -> None:
        self.radius *= 1.1 ** (-delta)

    # -- export -------------------------------------------------------------
    @property
    def position(self) -> np.ndarray:
        return self.center - self.rot[:, 2] * self.radius

    @property
    def pose(self) -> np.ndarray:
        """Camera-to-world 4×4."""
        m = np.eye(4)
        m[:3, :3] = self.rot
        m[:3, 3] = self.position
        return m

    def to_camera(self, znear: float = 0.01, zfar: float = 100.0, device="cuda"):
        from ..data.cameras import make_camera

        w2c = np.linalg.inv(self.pose)
        R = w2c[:3, :3].T
        T = w2c[:3, 3]
        aspect = self.width / self.height
        fovx = 2 * math.atan(math.tan(self.fovy / 2) * aspect)
        return make_camera(R, T, fovx, self.fovy, self.width, self.height,
                           znear=znear, zfar=zfar, device=device)

    def state_dict(self) -> dict:
        return {
            "rot": self.rot.tolist(), "center": self.center.tolist(),
            "radius": self.radius, "fovy": self.fovy,
            "width": self.width, "height": self.height,
        }

    def load_state_dict(self, d: dict) -> None:
        self.rot = np.asarray(d["rot"])
        self.center = np.asarray(d["center"])
        self.radius = float(d["radius"])
        self.fovy = float(d["fovy"])
        self.width = int(d.get("width", self.width))
        self.height = int(d.get("height", self.height))


class KeyframeTimeline:
    """Keyframed camera trajectory with cubic interpolation
    (`local_viewer.py:122-288`)."""

    def __init__(self):
        self.keyframes: List[dict] = []  # {"time": t, "rot": R, "center": c, "radius": r}

    def add(self, time: float, cam: OrbitCamera) -> None:
        self.keyframes.append({
            "time": float(time), "rot": cam.rot.copy(),
            "center": cam.center.copy(), "radius": cam.radius,
        })
        self.keyframes.sort(key=lambda k: k["time"])

    def sample(self, time: float, template: OrbitCamera) -> OrbitCamera:
        """Interpolated camera at `time` (slerp-free: cubic on look-at params)."""
        import copy

        kfs = self.keyframes
        cam = copy.deepcopy(template)
        if not kfs:
            return cam
        if len(kfs) == 1 or time <= kfs[0]["time"]:
            k = kfs[0]
        elif time >= kfs[-1]["time"]:
            k = kfs[-1]
        else:
            times = np.array([k["time"] for k in kfs])
            if len(kfs) >= 4:
                from scipy.interpolate import CubicSpline
                from scipy.spatial.transform import Rotation, Slerp

                centers = np.stack([k["center"] for k in kfs])
                radii = np.array([k["radius"] for k in kfs])
                cs_c = CubicSpline(times, centers)
                cs_r = CubicSpline(times, radii)
                slerp = Slerp(times, Rotation.from_matrix(
                    np.stack([k["rot"] for k in kfs])
                ))
                cam.center = cs_c(time)
                cam.radius = float(cs_r(time))
                cam.rot = slerp(time).as_matrix()
                return cam
            # linear fallback for < 4 keys
            i = int(np.searchsorted(times, time)) - 1
            a, b = kfs[i], kfs[i + 1]
            u = (time - a["time"]) / (b["time"] - a["time"] + 1e-12)
            from scipy.spatial.transform import Rotation, Slerp

            slerp = Slerp([0, 1], Rotation.from_matrix(np.stack([a["rot"], b["rot"]])))
            cam.center = (1 - u) * a["center"] + u * b["center"]
            cam.radius = float((1 - u) * a["radius"] + u * b["radius"])
            cam.rot = slerp(u).as_matrix()
            return cam
        cam.center = k["center"].copy()
        cam.radius = k["radius"]
        cam.rot = k["rot"].copy()
        return cam

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump([
                {"time": k["time"], "rot": k["rot"].tolist(),
                 "center": k["center"].tolist(), "radius": k["radius"]}
                for k in self.keyframes
            ], f)

    def load(self, path: str) -> None:
        with open(path) as f:
            raw = json.load(f)
        self.keyframes = [
            {"time": k["time"], "rot": np.asarray(k["rot"]),
             "center": np.asarray(k["center"]), "radius": k["radius"]}
            for k in raw
        ]


class KeyframeEditor:
    """Interval-based keyframe editing + record timeline, reference-parity
    (`local_viewer.py:122-288`): keyframes hold camera state + a per-key
    frame `interval`; the record timeline componentwise-interpolates every
    state channel (linear for ≤3 keys, cubic otherwise) and, when `cycles`
    > 0, pads one cycle before/after so the loop closes smoothly."""

    CHANNELS = ("rot", "look_at", "radius", "fovy")  # quat(4)/3/1/1

    def __init__(self, fps: int = 25, keyframe_interval: float = 1.0):
        self.keyframes: List[dict] = []
        self.fps = fps
        self.keyframe_interval = keyframe_interval
        self.cycles = 0

    # -- editing (reference callbacks add/delete/update, :446-485) ----------
    def state_of(self, cam: OrbitCamera) -> dict:
        from scipy.spatial.transform import Rotation

        return {
            "rot": Rotation.from_matrix(cam.rot).as_quat(),
            "look_at": np.asarray(cam.center, np.float64).copy(),
            "radius": np.array([cam.radius], np.float64),
            "fovy": np.array([cam.fovy], np.float64),
            "interval": int(round(self.fps * self.keyframe_interval)),
        }

    def apply_state(self, cam: OrbitCamera, state: dict) -> None:
        from scipy.spatial.transform import Rotation

        if "rot" in state:
            cam.rot = Rotation.from_quat(np.asarray(state["rot"])).as_matrix()
        if "look_at" in state:
            cam.center = np.asarray(state["look_at"], np.float64).copy()
        if "radius" in state:
            cam.radius = float(np.asarray(state["radius"]).reshape(-1)[0])
        if "fovy" in state:
            cam.fovy = float(np.asarray(state["fovy"]).reshape(-1)[0])

    def add(self, cam: OrbitCamera, after: Optional[int] = None) -> int:
        idx = len(self.keyframes) if after is None else after + 1
        self.keyframes.insert(idx, self.state_of(cam))
        return idx

    def delete(self, idx: int) -> None:
        self.keyframes.pop(idx)

    def update(self, idx: int, cam: OrbitCamera) -> None:
        self.keyframes[idx] = self.state_of(cam)

    def set_interval(self, keyframe_interval: float) -> None:
        self.keyframe_interval = keyframe_interval
        iv = int(round(self.fps * keyframe_interval))
        for k in self.keyframes:
            k["interval"] = iv

    def start_frame_of(self, idx: int) -> int:
        """Record-timestep where keyframe `idx` sits (listbox jump, :435-441)."""
        return int(sum(k["interval"] for k in self.keyframes[:idx]))

    # -- record timeline (`update_record_timeline`, :122-167) ---------------
    def timeline_length(self) -> int:
        if not self.keyframes:
            return 0
        if self.cycles == 0:
            return int(sum(k["interval"] for k in self.keyframes[:-1]))
        return int(sum(k["interval"] for k in self.keyframes)) * self.cycles

    def frames(self) -> dict:
        """Dict of channel → [T, D] interpolated arrays over the timeline."""
        n = self.timeline_length()
        if n <= 0 or not self.keyframes:
            return {}
        kfs = list(self.keyframes)
        if self.cycles > 0:
            kfs = self.keyframes * (self.cycles + 2)
            t = -sum(k["interval"] for k in self.keyframes)
        else:
            t = 0
        k_x = []
        for k in kfs:
            k_x.append(t)
            t += k["interval"]
        x = np.arange(n)
        out = {}
        if len(kfs) <= 1:
            for ch in self.CHANNELS:
                out[ch] = np.tile(np.asarray(kfs[0][ch])[None], (n, 1))
            return out
        from scipy.interpolate import interp1d

        kind = "linear" if len(kfs) <= 3 else "cubic"
        k_x = np.asarray(k_x, np.float64)
        for ch in self.CHANNELS:
            k_y = np.stack([np.asarray(k[ch], np.float64) for k in kfs])
            if ch == "rot":
                # Hemisphere-align successive quaternions (q and -q are the
                # same rotation): componentwise interpolation across a sign
                # flip would pass near the zero quaternion and the camera
                # would spin the long way (or wildly) between those keys.
                for i in range(1, len(k_y)):
                    if np.dot(k_y[i], k_y[i - 1]) < 0:
                        k_y[i] = -k_y[i]
            f = interp1d(k_x, k_y, axis=0, kind=kind, fill_value="extrapolate")
            out[ch] = f(x)
        return out

    def state_at(self, record_timestep: int) -> dict:
        fr = self.frames()
        return {ch: fr[ch][record_timestep] for ch in fr}

    # -- persistence ---------------------------------------------------------
    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({
                "fps": self.fps, "keyframe_interval": self.keyframe_interval,
                "cycles": self.cycles,
                "keyframes": [
                    {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                     for k, v in kf.items()}
                    for kf in self.keyframes
                ],
            }, f, indent=2)

    def load(self, path: str) -> None:
        with open(path) as f:
            d = json.load(f)
        self.fps = int(d.get("fps", self.fps))
        self.keyframe_interval = float(
            d.get("keyframe_interval", self.keyframe_interval))
        self.cycles = int(d.get("cycles", 0))
        self.keyframes = [
            {k: (np.asarray(v, np.float64) if isinstance(v, list) else v)
             for k, v in kf.items()}
            for kf in d["keyframes"]
        ]


def export_trajectory(
    editor: KeyframeEditor,
    core,
    out_dir: str,
    dynamic: bool = False,
    start_timestep: int = 0,
    show_mesh: bool = False,
) -> dict:
    """Render the record timeline and write `trajectory.json`
    (`export_trajectory`, `local_viewer.py:208-288`): per-frame PNG +
    intrinsics/extrinsics records in the DynamicNerf transforms layout, so
    an exported trajectory can be re-rendered by a `--target` render like
    the reference's."""
    import os

    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    n = editor.timeline_length()
    frames_ch = editor.frames()
    cam = core.cam
    timestep = int(start_timestep)
    traj = {"frames": [], "timestep_indices": [], "camera_indices": []}
    tsteps, cidxs = set(), set()
    for i in range(n):
        editor.apply_state(cam, {ch: frames_ch[ch][i] for ch in frames_ch})
        img = core.render(timestep=timestep, camera=cam.to_camera(device=core.device),
                          show_mesh=show_mesh)
        path = os.path.join(out_dir, f"{i:05d}.png")
        Image.fromarray(
            (np.clip(img, 0, 1) * 255).astype(np.uint8)).save(path)
        h, w = cam.height, cam.width
        fl_y = h / (2 * math.tan(cam.fovy / 2))
        fl_x = fl_y
        c2w = cam.pose.copy()
        c2w[:, [1, 2]] *= -1  # opencv → opengl (reference :247-248)
        traj["frames"].append({
            "cx": w / 2, "cy": h / 2, "fl_x": fl_x, "fl_y": fl_y,
            "h": h, "w": w,
            "camera_angle_x": 2 * math.atan(w / (2 * fl_x)),
            "camera_angle_y": 2 * math.atan(h / (2 * fl_y)),
            "transform_matrix": c2w.tolist(),
            "timestep_index": timestep, "camera_indx": i,
            "file_path": f"{i:05d}.png",
        })
        tsteps.add(timestep)
        cidxs.add(i)
        if dynamic:
            timestep = min(timestep + 1, core.num_timesteps - 1)
    traj["timestep_indices"] = sorted(tsteps)
    traj["camera_indices"] = sorted(cidxs)
    with open(os.path.join(out_dir, "trajectory.json"), "w") as f:
        json.dump(traj, f, indent=2)
    return traj
