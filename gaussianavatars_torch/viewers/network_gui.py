"""Training-monitor wire protocol (TCP), reference-compatible.

The port of the JAX package's `viewers/network_gui.py` (numpy and sockets;
the reference's `gaussian_renderer/network_gui.py:26-88` and the train-loop
service block, `train.py:143-172`): a non-blocking listener inside the
trainer; the client (remote viewer) sends a length-prefixed JSON request —
resolution, transposed view/view-projection matrices, fov, timestep,
show_splatting/show_mesh toggles — and gets back raw RGB bytes plus a JSON
stats dict ({num_timesteps, num_points}). The bytes on the wire are the
JAX package's, so either package's client talks to either's server.

Matrix convention bridge: the wire carries the reference's row-major
*transposed* matrices with the viewer's y/z sign flips
(`network_gui.py:74-77`); `_camera_from_msg` applies the same column flips
then transposes into this package's column-vector `Camera`.

Not here: the JAX server's multi-process branch (a process-local copy of
a sharded state, for `jax.process_count() > 1`) belongs to multi-device
training (ROADMAP queue A item 5). The JAX server strips the timestep
from its jit cache key; the port has no jit cache, so nothing is stripped.
"""
from __future__ import annotations

import json
import math
import socket
from typing import Optional, Tuple

import numpy as np
import torch


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def read_message(conn: socket.socket) -> dict:
    n = int.from_bytes(_recv_exact(conn, 4), "little")
    return json.loads(_recv_exact(conn, n).decode("utf-8"))


def send_message(conn: socket.socket, image: Optional[np.ndarray], payload: dict) -> None:
    """image: [H, W, 3] float in [0,1] or None."""
    if image is not None:
        data = (np.clip(image, 0.0, 1.0) * 255).astype(np.uint8).tobytes()
        conn.sendall(data)
    raw = json.dumps(payload).encode("utf-8")
    conn.sendall(len(raw).to_bytes(4, "little"))
    conn.sendall(raw)


def _camera_from_msg(msg: dict, device="cuda"):
    """The request's `Camera`, its matrices on `device`."""
    from ..data.cameras import Camera
    from ..device import resolve_device

    dev = resolve_device(device)
    width, height = msg["resolution_x"], msg["resolution_y"]
    wv = np.asarray(msg["view_matrix"], np.float32).reshape(4, 4)
    wv[:, 1] = -wv[:, 1]
    wv[:, 2] = -wv[:, 2]
    fp = np.asarray(msg["view_projection_matrix"], np.float32).reshape(4, 4)
    fp[:, 1] = -fp[:, 1]
    world_view = wv.T                      # wire is row-vector (transposed)
    full_proj = fp.T
    inv_wv = np.linalg.inv(world_view)
    proj = full_proj @ inv_wv
    fovy = float(msg["fov_y"])
    fovx = float(msg.get("fov_x", 2 * math.atan(math.tan(fovy / 2) * width / height)))

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32, device=dev)

    return Camera(
        world_view=t(world_view), proj=t(proj), full_proj=t(full_proj),
        camera_center=t(inv_wv[:3, 3]),
        fovx=fovx, fovy=fovy, width=int(width), height=int(height),
        timestep=int(msg.get("timestep") or 0),
    )


class GuiServer:
    """Non-blocking listener used inside the train loop."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6009):
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)
        self.conn: Optional[socket.socket] = None
        self.port = self.listener.getsockname()[1]

    def try_connect(self) -> bool:
        if self.conn is not None:
            return True
        try:
            self.conn, _addr = self.listener.accept()
            self.conn.settimeout(None)
            return True
        except (BlockingIOError, socket.timeout, OSError):
            return False

    def receive(self, device="cuda") -> Tuple[Optional[object], dict]:
        """The next request: (its `Camera` on `device`, or None for a
        control-only message, and the message)."""
        msg = read_message(self.conn)
        msg["do_training"] = bool(msg.get("do_training", True))
        msg["keep_alive"] = bool(msg.get("keep_alive", False))
        if msg["resolution_x"] and msg["resolution_y"]:
            return _camera_from_msg(msg, device), msg
        return None, msg

    def send(self, image: Optional[np.ndarray], payload: dict) -> None:
        send_message(self.conn, image, payload)

    def drop(self) -> None:
        if self.conn is not None:
            try:
                self.conn.close()
            finally:
                self.conn = None

    def close(self) -> None:
        self.drop()
        self.listener.close()


class TrainingGuiServer(GuiServer):
    """The service loop grafted into training (`train.py:143-172`)."""

    def service(self, harness, iteration: int) -> bool:
        """Service one round of viewer requests on the harness's device.

        Returns True while a client is connected. A client that asks with
        `do_training=False` holds the loop here, answering each of its
        requests, until it asks to train again (or, past the last
        iteration, stops asking to be kept alive)."""
        from ..models.gaussians import num_alive
        from ..training.loop import _background, make_render_fn, tile_config

        if not self.try_connect():
            return False
        cfg = harness.cfg
        dev = harness.scene.device
        # Re-read the loop's live tile budgets: overflow recovery grows them
        # mid-run, and a render fn made with the old budgets would keep
        # culling splats from viewer frames.
        tcfg = harness.live_tile_config or tile_config(cfg)
        if getattr(self, "_render_tcfg", None) != tcfg:
            self._render_fn = make_render_fn(harness.model, cfg, tcfg)
            self._render_tcfg = tcfg
        while self.conn is not None:
            try:
                cam, msg = self.receive(dev)
                image = None
                if cam is not None:
                    t = min(cam.timestep, max(harness.scene.num_timesteps - 1, 0))
                    if msg.get("show_splatting", True):
                        image = self._render_fn(harness.state, cam, t, _background(cfg, dev),
                                                cfg.model.sh_degree).cpu().numpy()
                    if harness.model is not None and msg.get("show_mesh", False):
                        image = self._mesh_overlay(harness, cam, msg, image)
                    if image is None and (msg.get("show_splatting", True)
                                          or msg.get("show_mesh", False)):
                        # The client reads an image whenever it asked for
                        # one: keep the byte stream in sync even when no
                        # renderer could serve it (mesh-only vs an unbound
                        # model).
                        image = np.zeros((cam.height, cam.width, 3), np.float32)
                # Reply to every request (the reference answers each
                # message, train.py:143-172); a control-only message
                # (resolution 0) still gets the stats JSON the client
                # blocks on.
                self.send(image, {
                    "num_timesteps": harness.scene.num_timesteps,
                    "num_points": int(num_alive(harness.state.aux)),
                })
                if msg["do_training"] and (
                    iteration < cfg.opt.iterations or not msg["keep_alive"]
                ):
                    break
            except (OSError, ValueError, KeyError):
                # A client that hangs up or sends a malformed request is
                # dropped; training goes on.
                self.drop()
        return self.conn is not None

    @torch.no_grad()
    def _mesh_overlay(self, harness, cam, msg, image):
        from ..ops.mesh_raster import render_mesh_preview
        from ..training.loop import _flame_params
        from .local import blend_mesh

        t = min(cam.timestep, max(harness.scene.num_timesteps - 1, 0))
        verts = harness.model(_flame_params(harness.state, t))[0]
        out = render_mesh_preview(verts, harness.model.faces, cam)
        return blend_mesh(image, out["rgba"].cpu().numpy(), float(msg.get("mesh_opacity", 0.5)))


def camera_message(camera, timestep: int = 0) -> dict:
    """The view part of a request for `camera` (a `Camera`, its matrices
    on any device): the transposed matrices with the viewer's sign flips,
    the fovs, the timestep (`timestep`, else the camera's)."""
    wv = _host(camera.world_view).T.copy()   # to wire convention
    wv[:, 1] = -wv[:, 1]
    wv[:, 2] = -wv[:, 2]
    fp = _host(camera.full_proj).T.copy()
    fp[:, 1] = -fp[:, 1]
    return {
        "resolution_x": camera.width, "resolution_y": camera.height,
        "view_matrix": wv.reshape(-1).tolist(),
        "view_projection_matrix": fp.reshape(-1).tolist(),
        "fov_y": camera.fovy, "fov_x": camera.fovx,
        "z_near": 0.01, "z_far": 100.0,
        "timestep": timestep or camera.timestep,
    }


class RemoteClient:
    """Client side of the protocol (`remote_viewer.py:48-156`)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6009, timeout: float = 10.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)

    def request(
        self,
        camera=None,
        width: int = 0,
        height: int = 0,
        timestep: int = 0,
        do_training: bool = True,
        keep_alive: bool = True,
        show_splatting: bool = True,
        show_mesh: bool = False,
        mesh_opacity: float = 0.5,
        scaling_modifier: float = 1.0,
        use_original_mesh: bool = False,
    ) -> Tuple[Optional[np.ndarray], dict]:
        """Send one request; returns (image [H,W,3] float or None, stats)."""
        if camera is not None:
            width, height = camera.width, camera.height
            msg = camera_message(camera, timestep)
        else:
            msg = {"resolution_x": 0, "resolution_y": 0}
        msg.update(
            do_training=do_training, keep_alive=keep_alive,
            show_splatting=show_splatting, show_mesh=show_mesh,
            mesh_opacity=mesh_opacity, scaling_modifier=scaling_modifier,
            use_original_mesh=use_original_mesh,
        )
        raw = json.dumps(msg).encode("utf-8")
        self.sock.sendall(len(raw).to_bytes(4, "little"))
        self.sock.sendall(raw)
        image = None
        if camera is not None and (show_splatting or show_mesh):
            data = _recv_exact(self.sock, width * height * 3)
            image = np.frombuffer(data, np.uint8).reshape(height, width, 3) / 255.0
        stats = read_message(self.sock)
        return image, stats

    def close(self) -> None:
        self.sock.close()


def _host(x) -> np.ndarray:
    """A matrix (tensor on any device, or array) as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().astype(np.float32)
    return np.asarray(x, np.float32)
