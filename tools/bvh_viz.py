"""BVH inspector (capability parity with bvh_visualizer.c).

The reference is an interactive raylib app drawing wireframe AABB cubes per
tree level (bvh_visualizer.c:22-58). Headless equivalent: dump every level's
child AABBs as wireframe line geometry into a Wavefront OBJ (one `o` object
per depth, so any viewer can toggle levels), skipping the zero ("empty lane")
boxes exactly like the reference (bvh_visualizer.c:44-49).

Usage:
    python tools/bvh_viz.py <model.(obj|glb|gltf|npz)> [out.obj]
    python tools/bvh_viz.py <model> --overlay <prefix> [size]
    python tools/bvh_viz.py <model> --interactive [--snapshot out.png]

--overlay renders the scene once and writes <prefix>_level<d>.png per BVH
level with the level's AABB wireframes projected over the render.

--interactive is the direct counterpart of the reference's raylib app
(bvh_visualizer.c:60-107): an orbiting wireframe view of one BVH level at
a time, drawn in the terminal with ANSI half-blocks. Up/Down steps the
shown level (KEY_UP/KEY_DOWN parity), Left/Right orbits, w/s tilts,
+/- zooms, q quits. Level color follows the reference's HSV-by-depth
formula (bvh_visualizer.c:26). --snapshot renders one frame to a PNG
instead (headless self-test).
"""

from __future__ import annotations

import sys

import numpy as np


def _ensure_backend():
    """Use the repository's compile cache; fall back to the CPU when no
    accelerator backend initializes."""
    import jax

    from raytracing_jax.utils import compile_cache

    compile_cache.enable()
    try:
        jax.devices()
    except RuntimeError:
        jax.config.update("jax_platforms", "cpu")

# 12 box edges as pairs of corner indices (corners in zyx bit order)
_EDGES = [
    (0, 1), (0, 2), (1, 3), (2, 3),
    (4, 5), (4, 6), (5, 7), (6, 7),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def dump_bvh_obj(scene, out_path: str) -> dict:
    """Write wireframe AABBs per level; returns {depth: n_boxes}."""
    mins, maxs = scene.bvh.child_boxes_np()  # (n_internal, 8, 3) each
    depth = scene.bvh.depth

    lines = ["# BVH wireframe dump (one object per level)"]
    vert_count = 0
    stats = {}

    level_start = 0
    level_size = 1
    for d in range(depth):
        boxes = []
        for node in range(level_start, level_start + level_size):
            for j in range(8):
                lo = mins[node, j]
                hi = maxs[node, j]
                if (lo == 0).all() and (hi == 0).all():
                    continue  # empty lane (bvh_visualizer.c:44-49)
                boxes.append((lo, hi))
        stats[d] = len(boxes)
        lines.append(f"o level_{d}")
        for lo, hi in boxes:
            corners = [
                [hi[0] if i & 1 else lo[0],
                 hi[1] if i & 2 else lo[1],
                 hi[2] if i & 4 else lo[2]]
                for i in range(8)
            ]
            for c in corners:
                lines.append(f"v {c[0]:.6f} {c[1]:.6f} {c[2]:.6f}")
            for a, b in _EDGES:
                lines.append(f"l {vert_count + a + 1} {vert_count + b + 1}")
            vert_count += 8
        level_start += level_size
        level_size *= 8

    with open(out_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return stats


def _project(camera, pts, width, height):
    """World points (N, 3) -> (px, py, in_front) under the pinhole model of
    render/camera.generate_rays (raytracer.c:641-698), inverted."""
    m = np.asarray(camera.view_matrix, np.float64)
    rot = m[:3, :3]
    org = m[:3, 3]
    c = (pts - org) @ rot  # R^T (P - origin): camera space, -z forward
    in_front = c[:, 2] < -1e-9
    zi = np.where(in_front, -c[:, 2], 1.0)
    f = float(camera.focal_length)
    aspect = width / height
    u = c[:, 0] * f / zi / aspect
    v = -(c[:, 1] * f / zi)
    px = (u + 1.0) * width / 2.0 - 0.5
    py = (v + 1.0) * height / 2.0 - 0.5
    return px, py, in_front


LEVEL_COLORS = [(255, 80, 80), (80, 220, 80), (90, 140, 255), (255, 200, 60),
                (220, 90, 220)]


def overlay_levels(scene, prefix: str, size: int = 512) -> None:
    """Render once, then write one PNG per level with that level's child
    AABBs drawn as projected wireframes."""
    from PIL import Image, ImageDraw

    from raytracing_jax.render.renderer import render

    img, _ = render(scene, size, size, spp=4, max_bounces=3, seed=0)
    base = Image.fromarray(img)

    mins, maxs = scene.bvh.child_boxes_np()
    level_start, level_size = 0, 1
    for d in range(scene.bvh.depth):
        im = base.copy()
        draw = ImageDraw.Draw(im)
        color = LEVEL_COLORS[d % len(LEVEL_COLORS)]
        n = 0
        for node in range(level_start, level_start + level_size):
            for j in range(8):
                lo, hi = mins[node, j], maxs[node, j]
                if (lo == 0).all() and (hi == 0).all():
                    continue
                corners = np.array([
                    [hi[0] if i & 1 else lo[0],
                     hi[1] if i & 2 else lo[1],
                     hi[2] if i & 4 else lo[2]]
                    for i in range(8)
                ])
                px, py, ok = _project(scene.camera, corners, size, size)
                for a, b in _EDGES:
                    if ok[a] and ok[b]:
                        draw.line(
                            (px[a], py[a], px[b], py[b]), fill=color
                        )
                n += 1
        out = f"{prefix}_level{d}.png"
        im.save(out)
        print(f"{out}: {n} boxes")
        level_start += level_size
        level_size *= 8


def _level_corner_sets(scene):
    """Per level: (n_boxes, 8, 3) corner array of the nonempty child boxes
    (empty-lane skip rule = bvh_visualizer.c:44-49)."""
    mins, maxs = scene.bvh.child_boxes_np()
    levels = []
    level_start, level_size = 0, 1
    for _d in range(scene.bvh.depth):
        lo = mins[level_start : level_start + level_size].reshape(-1, 3)
        hi = maxs[level_start : level_start + level_size].reshape(-1, 3)
        keep = ~((lo == 0).all(1) & (hi == 0).all(1))
        lo, hi = lo[keep], hi[keep]
        # corner i takes hi on axis c iff bit c of i is set (same corner
        # order as dump_bvh_obj above)
        bits = ((np.arange(8)[:, None] >> np.arange(3)[None, :]) & 1) != 0
        corners = (
            np.where(bits[None], hi[:, None, :], lo[:, None, :])
            if len(lo)
            else np.zeros((0, 8, 3), np.float32)
        )
        levels.append(corners)
        level_start += level_size
        level_size *= 8
    return levels


def _hsv_level_color(depth_shown: int, tree_depth: int):
    """ColorFromHSV(-360*depth/bvh->depth, 0.7, 1) — bvh_visualizer.c:26."""
    import colorsys

    h = (-(depth_shown) / max(tree_depth, 1)) % 1.0
    r, g, b = colorsys.hsv_to_rgb(h, 0.7, 1.0)
    return np.array([r * 255, g * 255, b * 255], np.float32)


def _raster_frame(level_corners, color, eye, target, width, height,
                  fovy_deg=45.0, cell_aspect=1.0):
    """Rasterize one level's box edges into an (H, W, 3) u8 buffer with a
    look-at pinhole camera (the raylib camera's perspective model).
    cell_aspect: pixel width/height ratio — 1.0 for square pixels (PNG
    snapshots); ~0.5 for terminal half-blocks (cells are ~2x tall)."""
    buf = np.zeros((height, width, 3), np.float32)
    corners = level_corners
    if len(corners) == 0:
        return buf.astype(np.uint8)
    fwd = target - eye
    fwd = fwd / max(np.linalg.norm(fwd), 1e-9)
    upw = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, upw)
    right /= max(np.linalg.norm(right), 1e-9)
    up = np.cross(right, fwd)
    f = 1.0 / np.tan(np.radians(fovy_deg) / 2)
    aspect = width / height * cell_aspect

    pts = corners.reshape(-1, 3) - eye
    cx = pts @ right
    cy = pts @ up
    cz = pts @ fwd
    ok = cz > 1e-6
    zi = np.where(ok, cz, 1.0)
    px = (cx * f / zi / aspect + 1.0) * width / 2.0
    py = (-cy * f / zi + 1.0) * height / 2.0
    px = px.reshape(-1, 8)
    py = py.reshape(-1, 8)
    ok = ok.reshape(-1, 8)

    S = 48  # samples per edge
    t = np.linspace(0.0, 1.0, S)[None, :]
    alpha = 0.35  # additive dim (the reference's ColorAlpha 0.125 analog)
    for a, b in _EDGES:
        good = ok[:, a] & ok[:, b]
        if not good.any():
            continue
        xs = px[good, a, None] * (1 - t) + px[good, b, None] * t
        ys = py[good, a, None] * (1 - t) + py[good, b, None] * t
        xi = np.round(xs).astype(np.int64).ravel()
        yi = np.round(ys).astype(np.int64).ravel()
        m = (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height)
        np.add.at(buf, (yi[m], xi[m]), color * alpha)
    return np.clip(buf, 0, 255).astype(np.uint8)


def _ansi_draw(buf):
    """(H, W, 3) u8 -> half-block ANSI string (two pixel rows per line)."""
    h, w, _ = buf.shape
    out = ["\x1b[H"]
    for y in range(0, h - 1, 2):
        row = []
        for x in range(w):
            tr, tg, tb = buf[y, x]
            br, bg_, bb = buf[y + 1, x]
            row.append(
                f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg_};{bb}m▀"
            )
        out.append("".join(row) + "\x1b[0m")
    return "\n".join(out)


def interactive(scene, snapshot: str | None = None):
    """Terminal port of the raylib viewer loop (bvh_visualizer.c:60-107)."""
    import shutil

    levels = _level_corner_sets(scene)
    depth = scene.bvh.depth
    all_pts = np.concatenate(
        [c.reshape(-1, 3) for c in levels if len(c)], axis=0
    )
    center = (all_pts.min(0) + all_pts.max(0)) / 2
    radius = float(np.linalg.norm(all_pts.max(0) - all_pts.min(0)))
    state = {"show": depth - 1, "az": 0.8, "el": 0.5, "r": 1.6 * radius}

    def frame(width, height, cell_aspect=1.0):
        eye = center + state["r"] * np.array([
            np.cos(state["el"]) * np.sin(state["az"]),
            np.sin(state["el"]),
            np.cos(state["el"]) * np.cos(state["az"]),
        ])
        show = int(np.clip(state["show"], 0, depth - 1))
        color = _hsv_level_color(show + 1, depth)
        return _raster_frame(levels[show], color, eye, center, width,
                             height, cell_aspect=cell_aspect), show

    if snapshot is not None:
        from raytracing_jax.io.image_io import write_png

        buf, show = frame(512, 512)
        write_png(snapshot, buf)
        print(f"{snapshot}: level {show} "
              f"({len(levels[show])} boxes) of depth {depth}")
        return

    import termios
    import tty

    if not sys.stdout.isatty():
        print("--interactive needs a TTY (use --snapshot headless)")
        return
    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    sys.stdout.write("\x1b[2J\x1b[?25l")
    try:
        tty.setcbreak(fd)
        while True:
            cols, rows = shutil.get_terminal_size()
            w, h = cols, 2 * (rows - 1)
            buf, show = frame(w, h, cell_aspect=0.5)  # half-block cells
            sys.stdout.write(_ansi_draw(buf))
            sys.stdout.write(
                f"\n\x1b[0mlevel {show}/{depth - 1} "
                f"({len(levels[show])} boxes)  "
                "[Up/Down] level  [Left/Right,w/s] orbit  [+/-] zoom  [q]uit"
            )
            sys.stdout.flush()
            ch = sys.stdin.read(1)
            if ch == "\x1b":
                seq = sys.stdin.read(2)
                if seq == "[A":
                    state["show"] = min(state["show"] + 1, depth - 1)
                elif seq == "[B":
                    state["show"] = max(state["show"] - 1, 0)
                elif seq == "[C":
                    state["az"] += 0.2
                elif seq == "[D":
                    state["az"] -= 0.2
            elif ch == "w":
                state["el"] = min(state["el"] + 0.15, 1.45)
            elif ch == "s":
                state["el"] = max(state["el"] - 0.15, -1.45)
            elif ch in "+=":
                state["r"] *= 0.85
            elif ch == "-":
                state["r"] /= 0.85
            elif ch == "q":
                break
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)
        sys.stdout.write("\x1b[?25h\x1b[0m\n")


def _load(path):
    if path.endswith(".npz"):
        from raytracing_jax.models.serialization import load_scene_cache

        return load_scene_cache(path)
    from raytracing_jax.io.loader import load_scene

    return load_scene(path, background_path=None, warn=lambda *a: None)


def main(argv):
    _ensure_backend()
    path = argv[0]
    if len(argv) >= 2 and argv[1] == "--interactive":
        snap = None
        if "--snapshot" in argv:
            snap = argv[argv.index("--snapshot") + 1]
        interactive(_load(path), snapshot=snap)
        return
    if len(argv) >= 3 and argv[1] == "--overlay":
        size = int(argv[3]) if len(argv) > 3 else 512
        overlay_levels(_load(path), argv[2], size)
        return
    out = argv[1] if len(argv) > 1 else "bvh_wireframe.obj"
    scene = _load(path)
    stats = dump_bvh_obj(scene, out)
    total = sum(stats.values())
    print(f"wrote {out}: depth={scene.bvh.depth}, "
          + ", ".join(f"level {d}: {n} boxes" for d, n in stats.items())
          + f" ({total} total)")


if __name__ == "__main__":
    main(sys.argv[1:])
