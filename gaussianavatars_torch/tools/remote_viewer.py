"""Training monitor client (`remote_viewer.py` of the reference).

The port of the JAX package's `scripts/remote_viewer.py`: connects to a
running `tools/train.py --port N` (a `viewers/network_gui.TrainingGuiServer`),
requests frames over the reference's wire protocol from an orbit camera and
shows them in a DearPyGui window, or with `--headless` saves `--n_frames`
of them as PNGs. Without DearPyGui the window is not available: a warning,
as in the JAX script.

    python -m gaussianavatars_torch.tools.remote_viewer --port 60000 --headless \\
        [--n_frames 10] [--out_dir DIR] [--pause_training]
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

from ..viewers.network_gui import RemoteClient
from ..viewers.orbit import OrbitCamera


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=60000)
    p.add_argument("--width", "-W", type=int, default=802)
    p.add_argument("--height", "-H", type=int, default=550)
    p.add_argument("--headless", action="store_true")
    p.add_argument("--n_frames", type=int, default=10)
    p.add_argument("--out_dir", default="remote_frames")
    p.add_argument("--pause_training", action="store_true")
    p.add_argument("--show_mesh", action="store_true")
    return p.parse_args(argv)


def run_headless(a, cam: OrbitCamera, client: RemoteClient) -> list:
    """Requests `a.n_frames` frames; returns their (path or None, stats)."""
    from PIL import Image

    os.makedirs(a.out_dir, exist_ok=True)
    out = []
    for i in range(a.n_frames):
        img, stats = client.request(
            camera=cam.to_camera(device="cpu"), timestep=i,
            do_training=not a.pause_training, keep_alive=True, show_mesh=a.show_mesh,
        )
        path = None
        if img is not None:
            path = os.path.join(a.out_dir, f"{i:05d}.png")
            Image.fromarray((img * 255).astype(np.uint8)).save(path)
        print(f"frame {i}: {stats}")
        out.append((path, stats))
        time.sleep(0.1)
    return out


def run_gui(a, cam: OrbitCamera, client: RemoteClient) -> None:
    try:
        import dearpygui.dearpygui as dpg
    except ImportError:
        print("[warn] dearpygui not installed — use --headless")
        return

    dpg.create_context()
    with dpg.texture_registry():
        tex = dpg.add_raw_texture(
            a.width, a.height, np.zeros((a.height, a.width, 3), np.float32),
            format=dpg.mvFormat_Float_rgb,
        )
    state = {"training": True, "timestep": 0}
    with dpg.window(tag="main", no_title_bar=True):
        dpg.add_image(tex)
        dpg.add_text("", tag="stats")
        dpg.add_checkbox(label="train", default_value=True,
                         callback=lambda s, v: state.update(training=v))
        dpg.add_slider_int(label="timestep", max_value=500,
                           callback=lambda s, v: state.update(timestep=v))

    def on_drag(sender, app_data):
        cam.orbit(app_data[1], app_data[2])

    with dpg.handler_registry():
        dpg.add_mouse_drag_handler(button=dpg.mvMouseButton_Left, callback=on_drag)
        dpg.add_mouse_wheel_handler(callback=lambda s, v: cam.scale(v))

    dpg.create_viewport(title="remote viewer", width=a.width + 40, height=a.height + 140)
    dpg.setup_dearpygui()
    dpg.show_viewport()
    dpg.set_primary_window("main", True)
    while dpg.is_dearpygui_running():
        try:
            img, stats = client.request(
                camera=cam.to_camera(device="cpu"), timestep=state["timestep"],
                do_training=state["training"], keep_alive=True, show_mesh=a.show_mesh,
            )
            if img is not None:
                dpg.set_value(tex, img.astype(np.float32))
            dpg.set_value("stats", str(stats))
        except OSError as e:   # the server went away: show it and retry
            dpg.set_value("stats", f"disconnected: {e}")
            time.sleep(0.5)
        dpg.render_dearpygui_frame()
    dpg.destroy_context()


def main(argv=None):
    a = parse_args(argv)
    cam = OrbitCamera(width=a.width, height=a.height, radius=1.0)
    client = RemoteClient(a.host, a.port)
    try:
        if a.headless:
            return run_headless(a, cam, client)
        return run_gui(a, cam, client)
    finally:
        client.close()


if __name__ == "__main__":
    main()
