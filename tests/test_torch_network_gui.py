"""The port's viewer wire protocol (`viewers/network_gui.py`) against the
JAX package's: the bytes of a reply, the camera a request describes, and
the port's training server answering the JAX package's client and its own
while it holds the loop, on the tiny Blender scene of
`tests/test_torch_unbound.py` (unbound, 64×48, 8×16 tiles).

The camera is compared at atol 1e-6 (float32 inverse and products in
another framework); everything on the wire byte for byte.
"""
import json
import socket
import threading

import numpy as np
import pytest
import torch

from gaussianavatars_tpu import config as jconfig
from gaussianavatars_tpu.data.cameras import look_at_camera as jlook_at
from gaussianavatars_tpu.viewers import network_gui as jgui
from gaussianavatars_torch import config as tconfig
from gaussianavatars_torch.convert import camera_from_numpy
from gaussianavatars_torch.training import loop as tloop
from gaussianavatars_torch.viewers import network_gui as tgui
from test_torch_unbound import unbound_config, write_blender_scene
from torch_parity import camera_dict, n

CAMERA_MATS = ("world_view", "proj", "full_proj", "camera_center")


def _wire_bytes(send, image, payload) -> bytes:
    a, b = socket.socketpair()
    try:
        send(a, image, payload)
        a.close()
        chunks = []
        while True:
            c = b.recv(65536)
            if not c:
                return b"".join(chunks)
            chunks.append(c)
    finally:
        b.close()


@pytest.mark.parametrize("with_image", [True, False])
def test_send_and_read_message_match_jax(with_image):
    rng = np.random.RandomState(0)
    image = rng.uniform(-0.2, 1.2, (12, 20, 3)).astype(np.float32) if with_image else None
    payload = {"num_timesteps": 3, "num_points": 1234}
    got = _wire_bytes(tgui.send_message, image, payload)
    assert got == _wire_bytes(jgui.send_message, image, payload)
    assert len(got) == (12 * 20 * 3 if with_image else 0) + 4 + len(json.dumps(payload))
    # Each package reads the other's message.
    for send, read in ((tgui.send_message, jgui.read_message),
                       (jgui.send_message, tgui.read_message)):
        a, b = socket.socketpair()
        with a, b:
            send(a, None, payload)
            assert read(b) == payload


def _request_msg(cam) -> dict:
    """The JSON a client sends for `cam` (a JAX camera), as both
    `RemoteClient`s build it."""
    wv = np.asarray(cam.world_view).T.copy()
    wv[:, 1] = -wv[:, 1]
    wv[:, 2] = -wv[:, 2]
    fp = np.asarray(cam.full_proj).T.copy()
    fp[:, 1] = -fp[:, 1]
    return {"resolution_x": cam.width, "resolution_y": cam.height,
            "view_matrix": wv.reshape(-1).tolist(),
            "view_projection_matrix": fp.reshape(-1).tolist(),
            "fov_y": cam.fovy, "fov_x": cam.fovx, "timestep": 1}


@pytest.mark.parametrize("with_fovx", [True, False])
def test_camera_from_msg_matches_jax(with_fovx):
    cam = jlook_at(eye=np.array([0.7, -0.3, -3.0]), target=np.array([0.1, 0.0, 0.2]),
                   fovy=0.7, width=80, height=60)
    msg = _request_msg(cam)
    if not with_fovx:
        msg.pop("fov_x")
    got = tgui._camera_from_msg(dict(msg), device="cpu")
    want = jgui._camera_from_msg(dict(msg))
    for k in CAMERA_MATS:
        np.testing.assert_allclose(n(getattr(got, k)), np.asarray(getattr(want, k)),
                                   atol=1e-6, err_msg=k)
    for k in ("fovx", "fovy", "width", "height", "timestep"):
        assert getattr(got, k) == getattr(want, k), k
    # The request round-trips the view it was made from.
    np.testing.assert_allclose(n(got.full_proj), np.asarray(cam.full_proj), atol=1e-6)


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    root = write_blender_scene(str(tmp_path_factory.mktemp("scene")))
    cfg = tconfig.from_json(jconfig.to_json(unbound_config(root, "")))
    h = tloop.build_harness(cfg, device="cpu")
    h.live_tile_config = tloop.probe_tier_budgets(tloop.tile_config(cfg), cfg, None, h.state,
                                                  h.scene.cameras("train")[0], verbose=False)
    return h


def _serve(server, harness, client_fn, iteration=1):
    """Run `client_fn(port)` in a thread against `server.service`, which
    returns when the client lets training go on. Returns the client's
    result and service's."""
    box = {}

    def run():
        try:
            box["result"] = client_fn(server.port)
        except Exception as e:  # reported by the caller
            box["error"] = e

    th = threading.Thread(target=run)
    th.start()
    connected = False
    for _ in range(2000):
        connected = server.service(harness, iteration)
        if connected or not th.is_alive():
            break
        threading.Event().wait(0.005)
    th.join(timeout=60)
    assert not th.is_alive()
    if "error" in box:
        raise box["error"]
    return box["result"], connected


@pytest.mark.parametrize("client", ["jax", "torch"])
def test_training_server_answers_both_clients(harness, client):
    """The client holds the loop (`do_training=False`) for a splat frame, a
    mesh-only frame (none for an unbound model: zeros keep the stream in
    step) and a control message, then lets it go on."""
    jcam = jlook_at(eye=np.array([0.4, 0.3, -3.0]), target=np.zeros(3), fovy=0.6, width=64,
                    height=48)
    cam = jcam if client == "jax" else camera_from_numpy(camera_dict(jcam), device="cpu")
    remote = (jgui if client == "jax" else tgui).RemoteClient

    def client_fn(port):
        c = remote("127.0.0.1", port, timeout=30)
        try:
            frame, stats = c.request(cam, do_training=False)
            mesh, stats2 = c.request(cam, do_training=False, show_splatting=False,
                                     show_mesh=True)
            none, stats3 = c.request(None, do_training=False)
            _img, stats4 = c.request(None, do_training=True)
        finally:
            c.close()
        return frame, mesh, none, (stats, stats2, stats3, stats4)

    server = tgui.TrainingGuiServer("127.0.0.1", 0)
    try:
        (frame, mesh, none, stats), connected = _serve(server, harness, client_fn)
    finally:
        server.close()
    render = tloop.make_render_fn(None, harness.cfg, harness.live_tile_config)
    tcam = camera_from_numpy(camera_dict(jcam), device="cpu")
    want = render(harness.state, tcam, 0, torch.zeros(3), harness.cfg.model.sh_degree)
    want_u8 = (np.clip(n(want), 0.0, 1.0) * 255).astype(np.uint8)
    assert frame.shape == (48, 64, 3) and want_u8.any()
    np.testing.assert_array_equal(np.round(frame * 255).astype(np.uint8), want_u8)
    assert not mesh.any() and none is None
    n_live = int(harness.state.aux.alive.sum())
    assert all(s == {"num_timesteps": 0, "num_points": n_live} for s in stats)
    assert connected   # the client was still connected when the loop went on


def test_training_server_drops_a_bad_client(harness):
    """A malformed request drops the client; training goes on."""
    def client_fn(port):
        with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
            raw = b"not json"
            s.sendall(len(raw).to_bytes(4, "little") + raw)
            return s.recv(1)    # b"": the server hung up

    server = tgui.TrainingGuiServer("127.0.0.1", 0)
    try:
        got, connected = _serve(server, harness, client_fn)
        assert got == b"" and not connected and server.conn is None
        assert server.service(harness, 2) is False   # nobody waiting
    finally:
        server.close()
