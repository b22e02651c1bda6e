"""Offline avatar viewer (`local_viewer.py` of the reference).

The port of the JAX package's `scripts/local_viewer.py` over
`viewers/local.AvatarViewerCore` and `viewers/orbit.py`. With DearPyGui:
an interactive window (orbit, pan and zoom, timestep scrubbing, FLAME joint
and expression sliders, splatting and mesh toggles, the keyframe editor).
Without it, a warning and the headless path. `--headless` renders the
timestep sequence, a keyframe trajectory (`--trajectory`) or a keyframe
editor file (`--keyframes`) to PNGs, and to an mp4 when `ffmpeg` is on the
path.

    python -m gaussianavatars_torch.tools.local_viewer MODEL/point_cloud/iteration_N/point_cloud.ply \\
        --headless [--out_dir DIR] [--n_frames N] [--no_pallas] [--device cuda|cpu]

`--no_pallas` renders through the table pipeline and `--device` picks the
device (both flags of the port).
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess

import numpy as np

from ..viewers.local import AvatarViewerCore


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("point_path", help="trained point_cloud.ply")
    p.add_argument("--flame_assets", default="")
    p.add_argument("--motion_path", default="", help="reenactment flame_param.npz")
    p.add_argument("--width", "-W", type=int, default=802)
    p.add_argument("--height", "-H", type=int, default=550)
    p.add_argument("--headless", action="store_true")
    p.add_argument("--out_dir", default="viewer_frames")
    p.add_argument("--trajectory", default="", help="keyframe JSON (orbit.KeyframeTimeline)")
    p.add_argument("--keyframes", default="",
                   help="KeyframeEditor JSON (interval-based, the GUI's editor format) — "
                        "headless: render its record timeline + write trajectory.json")
    p.add_argument("--dynamic", action="store_true",
                   help="advance the timestep per exported frame "
                        "(reference _checkbox_dynamic_record)")
    p.add_argument("--n_frames", type=int, default=0)
    p.add_argument("--show_mesh", action="store_true")
    p.add_argument("--fps", type=int, default=25)
    p.add_argument("--no_pallas", action="store_true",
                   help="the table pipeline instead of the compositor kernels")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def make_core(a) -> AvatarViewerCore:
    return AvatarViewerCore(
        a.point_path, flame_assets=a.flame_assets, motion_path=a.motion_path,
        width=a.width, height=a.height, use_pallas=False if a.no_pallas else None,
        device=a.device,
    )


def run_headless(a) -> list:
    """Renders the frames; returns their paths."""
    from PIL import Image

    from ..viewers.orbit import KeyframeEditor, KeyframeTimeline, export_trajectory

    core = make_core(a)
    if a.keyframes:
        ed = KeyframeEditor(fps=a.fps)
        ed.load(a.keyframes)
        traj = export_trajectory(ed, core, a.out_dir, dynamic=a.dynamic,
                                 show_mesh=a.show_mesh)
        print(f"exported {len(traj['frames'])} trajectory frames to "
              f"{a.out_dir} (trajectory.json)")
        return [os.path.join(a.out_dir, f["file_path"]) for f in traj["frames"]]
    os.makedirs(a.out_dir, exist_ok=True)
    n = a.n_frames or core.num_timesteps
    timeline = None
    if a.trajectory:
        timeline = KeyframeTimeline()
        timeline.load(a.trajectory)
    paths = []
    for i in range(n):
        cam = core.cam
        if timeline is not None:
            cam = timeline.sample(i / max(n - 1, 1), core.cam)
        img = core.render(timestep=i % core.num_timesteps,
                          camera=cam.to_camera(device=core.device), show_mesh=a.show_mesh)
        paths.append(os.path.join(a.out_dir, f"{i:05d}.png"))
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(paths[-1])
    if shutil.which("ffmpeg") and n > 1:
        subprocess.run(
            ["ffmpeg", "-y", "-framerate", str(a.fps), "-i",
             os.path.join(a.out_dir, "%05d.png"), "-pix_fmt", "yuv420p",
             os.path.join(a.out_dir, "out.mp4")],
            check=False, capture_output=True,
        )
    print(f"wrote {n} frames to {a.out_dir} ({core.num_points} Gaussians)")
    return paths


def run_gui(a):
    try:
        import dearpygui.dearpygui as dpg
    except ImportError:
        print("[warn] dearpygui not installed — falling back to --headless")
        return run_headless(a)

    from PIL import Image

    from ..viewers.orbit import KeyframeEditor, export_trajectory

    core = make_core(a)
    editor = KeyframeEditor(fps=a.fps)
    if a.keyframes:
        editor.load(a.keyframes)
    state = {"timestep": 0, "show_mesh": a.show_mesh, "dirty": True,
             "playing": False, "last_img": None}

    def redraw():
        state["dirty"] = True

    dpg.create_context()
    with dpg.texture_registry():
        tex = dpg.add_raw_texture(
            a.width, a.height, np.zeros((a.height, a.width, 3), np.float32),
            format=dpg.mvFormat_Float_rgb,
        )
    with dpg.window(tag="main", no_title_bar=True):
        dpg.add_image(tex)

    # -- control panel (reference `define_gui`, local_viewer.py:301-431) ----
    with dpg.window(label="Control", tag="_control", autosize=True, pos=(0, 0)):
        dpg.add_slider_int(
            label="timestep", tag="_slider_timestep",
            max_value=core.num_timesteps - 1,
            callback=lambda s, v: (state.update(timestep=v), redraw()),
        )
        with dpg.group(horizontal=True):
            dpg.add_checkbox(
                label="show mesh", default_value=a.show_mesh,
                callback=lambda s, v: (state.update(show_mesh=v), redraw()),
            )
            dpg.add_button(label="play/pause", callback=lambda:
                           state.update(playing=not state["playing"]))

        def save_image():
            if state["last_img"] is not None:
                os.makedirs(a.out_dir, exist_ok=True)
                p = os.path.join(a.out_dir, f"frame_{state['timestep']}.png")
                Image.fromarray(
                    (np.clip(state["last_img"], 0, 1) * 255).astype(np.uint8)
                ).save(p)
                print(f"saved {p}")
        dpg.add_button(label="save image", callback=save_image)

        # Keyframe timeline editor (reference :432-520).
        dpg.add_separator()
        dpg.add_text("Keyframes")

        def refresh_listbox(sel=0):
            dpg.configure_item("_listbox_keyframes",
                               items=[str(i) for i in range(len(editor.keyframes))])
            if editor.keyframes:
                dpg.set_value("_listbox_keyframes", str(max(sel, 0)))
            dpg.configure_item("_slider_record", min_value=0,
                               max_value=max(editor.timeline_length() - 1, 0))

        def selected_idx():
            v = dpg.get_value("_listbox_keyframes")
            return int(v) if v else 0

        def kf_select(sender, app_data):
            idx = selected_idx()
            editor.apply_state(core.cam, editor.keyframes[idx])
            dpg.set_value("_slider_record", editor.start_frame_of(idx))
            redraw()

        with dpg.group(horizontal=True):
            dpg.add_listbox([], width=120, tag="_listbox_keyframes",
                            callback=kf_select)
            with dpg.group():
                dpg.add_button(label="add", callback=lambda: refresh_listbox(
                    editor.add(core.cam, after=selected_idx()
                               if editor.keyframes else None)))
                dpg.add_button(label="delete", callback=lambda: (
                    editor.delete(selected_idx()),
                    refresh_listbox(selected_idx() - 1),
                ) if editor.keyframes else None)
                dpg.add_button(label="update", callback=lambda: (
                    editor.update(selected_idx(), core.cam)
                ) if editor.keyframes else None)
        with dpg.group(horizontal=True):
            def set_cycles(s, v):
                editor.cycles = int(v)
                refresh_listbox(selected_idx())
            dpg.add_input_int(label="cycles", default_value=0, width=70,
                              callback=set_cycles)
            dpg.add_input_int(label="interval", default_value=int(
                a.fps * editor.keyframe_interval), width=70,
                callback=lambda s, v: (editor.set_interval(v / a.fps),
                                       refresh_listbox(selected_idx())))

        def record_seek(sender, v):
            editor.apply_state(core.cam, editor.state_at(int(v)))
            redraw()
        dpg.add_slider_int(label="timeline", tag="_slider_record", width=200,
                           callback=record_seek)
        dpg.add_checkbox(label="dynamic", tag="_checkbox_dynamic")
        with dpg.group(horizontal=True):
            dpg.add_button(label="export traj", callback=lambda: (
                export_trajectory(
                    editor, core, a.out_dir,
                    dynamic=bool(dpg.get_value("_checkbox_dynamic")),
                    start_timestep=state["timestep"],
                    show_mesh=state["show_mesh"]),
                editor.save(os.path.join(a.out_dir, "keyframes.json"))))

    # -- FLAME parameter panel (reference :531-589) -------------------------
    if core.model is not None:
        with dpg.window(label="FLAME parameters", autosize=True,
                        pos=(a.width - 300, 0)):
            def toggle_control(s, v):
                core.control_enabled = bool(v)
                redraw()
            dpg.add_checkbox(label="enable control", tag="_checkbox_control",
                             callback=toggle_control)
            dpg.add_separator()
            dpg.add_text("Joints")
            pose_sliders, expr_sliders = [], []

            def set_pose(sender, value, user):
                joint, axis = user
                core.set_pose(joint, axis, value)
                dpg.set_value("_checkbox_control", True)
                redraw()

            for joint in ("rotation", "neck", "jaw", "eyes"):
                with dpg.group(horizontal=True):
                    for axis in range(3):
                        t = f"_slider-{joint}-{axis}"
                        dpg.add_slider_float(
                            min_value=-0.5, max_value=0.5, format="%.2f",
                            width=70, tag=t, callback=set_pose,
                            user_data=(joint, axis))
                        pose_sliders.append(t)
                    dpg.add_text(f"{joint:8s}")
            dpg.add_text("   roll       pitch      yaw")
            dpg.add_separator()
            dpg.add_text("Expressions")

            def set_expr(sender, value, user):
                core.set_expr(user, value)
                dpg.set_value("_checkbox_control", True)
                redraw()

            n_expr_sliders = min(10, core.model.cfg.n_expr)
            for i in range(n_expr_sliders):
                t = f"_slider-expr-{i}"
                dpg.add_slider_float(label=str(i), min_value=-3, max_value=3,
                                     format="%.2f", width=250, tag=t,
                                     callback=set_expr, user_data=i)
                expr_sliders.append(t)

            def reset_flame():
                core.reset_flame()
                core.control_enabled = True
                dpg.set_value("_checkbox_control", True)
                for t in pose_sliders + expr_sliders:
                    dpg.set_value(t, 0.0)
                redraw()
            dpg.add_button(label="reset FLAME", callback=reset_flame)

    def on_drag(sender, app_data):
        core.cam.orbit(app_data[1], app_data[2])
        redraw()

    def on_key(sender, key):
        t = state["timestep"]
        if key == dpg.mvKey_Left:
            t -= 1
        elif key == dpg.mvKey_Right:
            t += 1
        elif key == dpg.mvKey_Home:
            t = 0
        elif key == dpg.mvKey_End:
            t = core.num_timesteps - 1
        state["timestep"] = int(np.clip(t, 0, core.num_timesteps - 1))
        dpg.set_value("_slider_timestep", state["timestep"])
        redraw()

    with dpg.handler_registry():
        dpg.add_mouse_drag_handler(button=dpg.mvMouseButton_Left, callback=on_drag)
        dpg.add_mouse_drag_handler(
            button=dpg.mvMouseButton_Middle,
            callback=lambda s, d: (core.cam.pan(d[1], d[2]), redraw()))
        dpg.add_mouse_wheel_handler(
            callback=lambda s, v: (core.cam.scale(v), redraw()))
        for key in ("Left", "Right", "Home", "End"):
            dpg.add_key_press_handler(getattr(dpg, f"mvKey_{key}"),
                                      callback=on_key)

    dpg.create_viewport(title="GaussianAvatars", width=a.width + 40,
                        height=a.height + 260)
    dpg.setup_dearpygui()
    dpg.show_viewport()
    dpg.set_primary_window("main", True)
    while dpg.is_dearpygui_running():
        if state["playing"]:
            state["timestep"] = (state["timestep"] + 1) % core.num_timesteps
            dpg.set_value("_slider_timestep", state["timestep"])
            state["dirty"] = True
        if state["dirty"]:
            img = core.render(timestep=state["timestep"],
                              show_mesh=state["show_mesh"])
            state["last_img"] = img
            dpg.set_value(tex, img.astype(np.float32))
            state["dirty"] = False
        dpg.render_dearpygui_frame()
    dpg.destroy_context()


def main(argv=None):
    a = parse_args(argv)
    if a.headless:
        return run_headless(a)
    return run_gui(a)


if __name__ == "__main__":
    main()
