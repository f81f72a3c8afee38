#!/usr/bin/env python3
"""Synthesize a genuinely different third scene — the cross-scene
generalization corpus (VERDICT r4 next #3).

Every committed dataset so far derives from the single 60-second
amsterdam demo clip (demo2 = CAVLC re-encode, holdout = prefix/suffix
split, 1080p = upscale). The reference evaluates across 7 scenes
(reference: parse/config.yaml; config/blobnet/{amsterdam,archie,...}).
Offline, the only way to get a second SCENE is to make one: this
script renders a procedural fixed-camera intersection — different
layout, background texture, object sizes/speeds/trajectories from the
amsterdam roundabout — and encodes it with libx264 via the first-party
encode path (csrc/tools/encode_yuv + utils/mp4loop), producing a
conforming H.264/MP4 with real motion vectors, real residuals, real
GoP structure. No reference-derived pixels anywhere.

Scene (1280x720, 30 fps, default 1800 frames = 60 s, seed-determined):
  - static background: sky gradient, textured building blocks with
    windows, a HORIZONTAL road (the demo's roundabout has no straight
    horizontal road) and a VERTICAL cross street, lane markings;
  - cars (class "car" at the stand-in oracle's area knobs): rounded-
    luminance rectangles, varied tone/size/speed, both directions in
    both roads, spawn schedule from the seed;
  - one bus-sized vehicle crossing slowly (exercises the bus/class-5
    voting when evaluated with bus_area like demo2);
  - pedestrians: small slow movers along the sidewalk (below the
    oracle's min_area -> must NOT become tracks);
  - one car that enters, PARKS for ~20 s on the shoulder, then leaves
    (exercises the aggregator's stationary machinery).

Usage: python examples/make_synth.py [OUT.mp4] [frames] [--seed N]
Default: build_out/synth/synth.mp4, 1800 frames. The default clip is
committed as artifacts/synth.mp4 (golden/synth/inputs.json records its
sha256), so hosts without libx264 run it too.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPO = pathlib.Path(__file__).resolve().parent.parent
W, H = 1280, 720
FPS = 30
# Bump when the procedural recipe changes: build_synth() writes this
# tag to a sidecar and refuses a cached mp4 with a different tag (the
# make_dataset2 stale-cache lesson — dims/sample-count alone can't
# tell two recipes apart). v2: car sprites sized so half-res blob
# areas clear the stand-in oracle's car_area=700 with margin and stay
# below bus_area=2500 — v1 straddled the threshold and GT classes
# flickered 0/2 per frame, which no track-voting pipeline can match.
# v3: every sprite band holds |luma - road| > the oracle's
# diff_threshold (see ROAD_TONE) — v2's tone-proportional windshield/
# skirt bands fell inside the blind zone and fragmented cars in GT,
# MOG2 labels, and masks alike.
# v4: lane geometry resolves at MB scale — one lane per direction with
# a > 4-MB-row gap, no-overtake spawn logic, the bus moved to the
# cross street, parked car to the lower bay (see build_movers) — v3's
# adjacent lanes fused into single blobs on the 16 px mask grid.
# v5: adaptive minimum spawn gap keeps >= 7 MBs of same-lane
# clearance for the whole transit — v4 platoons (followers capped to
# a slow leader) packed close enough for BlobNet dilation to merge.
# v6: occluder gates at the scene edges (see GATES) — objects emerge
# fully sized, so entry-clipped area never poisons the class vote.
# v7: same scene, encoded with ONE x264 thread. libx264's frame-threaded
# encoder picks its thread count from the host's cores (1.5x) and its
# bitstream depends on that count, so v6 clips differed between hosts;
# golden/synth and artifacts/blobnet_synth.npz come from a 1-core host,
# whose encode v7 reproduces byte for byte on any host.
RECIPE = "v7"
X264_OPTS = "threads=1"


def build_background(rng):
    """Static scene plate: (H, W) luma + (H/2, W/2) u/v."""
    y = np.zeros((H, W), np.float32)
    # Sky gradient.
    y[:] = np.linspace(150, 110, H)[:, None]
    # Building blocks along the top: textured rectangles with windows.
    x = 0
    while x < W:
        bw = int(rng.integers(90, 220))
        bh = int(rng.integers(140, 260))
        tone = float(rng.integers(60, 120))
        y[0:bh, x : x + bw] = tone + rng.normal(0, 3, (bh, min(bw, W - x)))
        # Window grid.
        for wy in range(18, bh - 12, 34):
            for wx in range(12, bw - 14, 30):
                if x + wx + 14 < W:
                    y[wy : wy + 16, x + wx : x + wx + 14] = tone + 45
        x += bw + int(rng.integers(6, 22))
    # Horizontal road band (the main street) + sidewalks. The road is
    # wide enough that the two lanes' car extents stay > 4 MB rows
    # apart: the device masks live on a 16 px MB grid, and v3 showed
    # adjacent lanes fuse into single blobs there (GT at half-res
    # mostly keeps them apart — an unmatchable count mismatch).
    road_top, road_bot = 340, 560
    y[road_top - 24 : road_top] = 135  # upper sidewalk
    y[road_bot : road_bot + 24] = 135  # lower sidewalk
    y[road_top:road_bot] = 88 + rng.normal(0, 2.5, (road_bot - road_top, W))
    # Lane markings (dashed center line).
    for x0 in range(0, W, 60):
        y[448:456, x0 : x0 + 30] = 200
    # Vertical cross street.
    vx0, vx1 = 860, 1020
    y[0:road_top, vx0:vx1] = 90 + rng.normal(0, 2.5, (road_top, vx1 - vx0))
    y[road_bot:, vx0:vx1] = 90 + rng.normal(
        0, 2.5, (H - road_bot, vx1 - vx0)
    )
    for y0 in range(0, H, 60):
        y[y0 : y0 + 30, 936:944] = 200
    # Ground below the road.
    y[road_bot + 24 :] += rng.normal(0, 2, (H - road_bot - 24, W))
    u = np.full((H // 2, W // 2), 128, np.float32)
    v = np.full((H // 2, W // 2), 128, np.float32)
    # Slight warm tint on buildings, cool on road.
    v[: road_top // 2] += 4
    u[road_top // 2 : road_bot // 2] += 3
    return y, u, v


# Static OCCLUDER GATES drawn over the movers at the scene edges
# (hedges/structures the traffic passes behind): objects emerge fully
# sized instead of growing from a clipped sliver at the frame edge.
# The area-threshold stand-in oracle classifies a half-visible car as
# class 0 (a real appearance-based detector would not), and the
# aggregator's class vote often lands exactly when a track is new —
# i.e. entering — so edge-clipped entry poisoned whole tracks' votes
# (the v5 lesson). The gates are static, so the median background
# absorbs them and they are invisible to the oracle and MOG2 alike —
# the demo scene's buildings play the same role.
GATES = (
    (316, 640, 0, 110, 52.0),  # left road end (hedge tone 52)
    (316, 640, 1170, W, 52.0),  # right road end
    (0, 96, 855, 1025, 70.0),  # cross-street overpass (top)
    (624, H, 855, 1025, 70.0),  # cross-street exit (bottom)
)


def draw_gates(y, u, v):
    for y0, y1, x0, x1, tone in GATES:
        y[y0:y1, x0:x1] = tone
        u[y0 // 2 : y1 // 2, x0 // 2 : x1 // 2] = 124
        v[y0 // 2 : y1 // 2, x0 // 2 : x1 // 2] = 122


ROAD_TONE = 88  # build_background road luma; sprites must stay far
# from it EVERYWHERE: the stand-in oracle (and MOG2's label model)
# thresholds |luma - bg| > 28, so any sprite band within ~28 of the
# road is invisible, splitting the car into flickering fragments in
# GT, labels, and masks alike (the v2 lesson — tone-proportional
# windshield/skirt bands landed exactly in that blind zone).


def sprite(w, h, tone, rng):
    """Vehicle sprite with a windshield band and a skirt — enough
    structure for real MVs and residuals. Interior bands use FIXED
    tones chosen to contrast with both the body and the road."""
    s = np.full((h, w), tone, np.float32)
    s += rng.normal(0, 2, (h, w))
    yy = np.linspace(-1, 1, h)[:, None]
    xx = np.linspace(-1, 1, w)[None, :]
    s *= 1.0 - 0.10 * (yy**2 + 0.3 * xx**2)
    light = tone >= 110
    s[int(h * 0.15) : int(h * 0.4), int(w * 0.2) : int(w * 0.8)] = (
        35 if light else 185
    )  # windshield (dark glass on light cars, bright trim on dark)
    s[int(h * 0.8) :] = 30 if light else 170  # skirt/wheels
    return np.clip(s, 8, 245)


class Mover:
    def __init__(self, spr, path_fn, t0, t1, chroma=(0.0, 0.0)):
        self.spr = spr
        self.path_fn = path_fn  # frame -> (left, top) floats
        self.t0, self.t1 = t0, t1
        self.chroma = chroma

    def draw(self, i, y, u, v):
        if not (self.t0 <= i < self.t1):
            return
        left, top = self.path_fn(i)
        h, w = self.spr.shape
        l, t = int(round(left)), int(round(top))
        if l + w <= 0 or l >= W or t + h <= 0 or t >= H:
            return
        x0, y0 = max(0, l), max(0, t)
        x1, y1 = min(W, l + w), min(H, t + h)
        y[y0:y1, x0:x1] = self.spr[y0 - t : y1 - t, x0 - l : x1 - l]
        if self.chroma != (0.0, 0.0):
            cu, cv = self.chroma
            u[y0 // 2 : y1 // 2, x0 // 2 : x1 // 2] = 128 + cu
            v[y0 // 2 : y1 // 2, x0 // 2 : x1 // 2] = 128 + cv


def build_movers(rng, frames):
    """One lane per direction, MB-separated (lane A cars span y
    356..414, lane B 482..540 — a > 4-MB-row gap inside the 340..560
    road band), with NO-OVERTAKE spawn logic: a car drawn faster than
    the previous one still on screen is capped to its speed, so
    same-lane cars can never catch up and fuse into one blob (the v3
    lesson: the device masks live on a 16 px MB grid and adjacent/
    overtaking cars merge there long before they merge in the
    half-res GT). Speed diversity survives because every platoon
    leader — the first car after its lane clears — draws freely."""
    movers = []
    LANE_A, LANE_B = 356, 482  # top of sprite: +x and -x directions

    def h_path(speed, lane, start_x):
        return lambda i, s=speed, l=lane, x=start_x: (x + s * i, l)

    # Car sprite sizes: half-res blob areas must clear the oracle's
    # car_area=700 with margin (>= ~48x22/2-res = 1050) and stay well
    # below bus_area=2500 (<= ~70x29 = 2030) so every car votes and
    # counts as class 2 on BOTH the per-frame GT side and the
    # track-voted CoVA side.
    def spawn_lane(lane, sign, t_first, tones, gap_lo, gap_hi):
        t = t_first
        prev = None  # (t, speed, w)
        while t < frames - 60:
            speed = float(rng.uniform(3.0, 8.0))
            w = int(rng.integers(96, 140))
            h = int(rng.integers(44, 58))
            if prev is not None:
                pt, ps, pw = prev
                if ps * (t - pt) - pw < W:  # still on screen
                    speed = min(speed, ps)
                # Same-speed followers keep clearance = speed * gap -
                # prev_width for the whole transit: enforce >= 7 MBs
                # (112 px) so platoon cars stay separable on the MB
                # mask grid (BlobNet dilation bridges ~1-2 MBs).
                need = int((pw + 112) / speed) + 1
                if t - pt < need:
                    t = pt + need
            prev = (t, speed, w)
            spr = sprite(w, h, float(rng.integers(*tones)), rng)
            start = -w - speed * t if sign > 0 else W + speed * t
            movers.append(
                Mover(spr, h_path(sign * speed, lane, start), t, frames,
                      chroma=(float(rng.integers(-12, 12)),
                              float(rng.integers(-12, 12))))
            )
            t += int(rng.integers(gap_lo, gap_hi))

    spawn_lane(LANE_A, +1, 0, (140, 235), 55, 120)
    spawn_lane(LANE_B, -1, 20, (18, 56), 60, 130)

    # Vertical cross-street traffic (same no-overtake rule). The slow
    # BUS is one of these spawns — class 5 at the bus_area knob; it
    # briefly merges with main-street cars in the intersection, which
    # the GT oracle sees the same way.
    def v_path(speed, x, start_y):
        return lambda i, s=speed, xx=x, y0=start_y: (xx, y0 + s * i)

    vprev = None
    for t0 in range(40, frames - 120, 300):
        speed = float(rng.uniform(2.5, 5.0))
        if vprev is not None:
            pt, ps = vprev
            if ps * (t0 - pt) < H + 300:
                speed = min(speed, ps)
        if t0 == 640:  # the bus slot
            speed = min(speed, 2.5)
            spr = sprite(64, 210, 225, rng)
            movers.append(Mover(spr, v_path(speed, 880,
                                            -220 - speed * t0),
                                t0, frames, chroma=(-20.0, 18.0)))
        else:
            spr = sprite(54, 86, float(rng.integers(150, 220)), rng)
            movers.append(
                Mover(spr, v_path(speed, 880, -90 - speed * t0), t0,
                      frames)
            )
        vprev = (t0, speed)

    # Parking car: drives in along the lower-sidewalk bay (y 562 —
    # > 1 MB row clear of lane B), parks ~20 s, drives off
    # (exercises the aggregator's stationary machinery).
    park_spr = sprite(98, 46, 205, rng)
    p_in, p_stop, p_go, p_out = 300, 420, 1020, 1140
    park_x_stop = 560.0

    def park_path(i):
        if i < p_stop:
            return (park_x_stop - 4.0 * (p_stop - i), 562.0)
        if i < p_go:
            return (park_x_stop, 562.0)
        return (park_x_stop + 4.0 * (i - p_go), 562.0)

    movers.append(Mover(park_spr, park_path, p_in, p_out,
                        chroma=(10.0, -14.0)))

    # Pedestrians: small slow movers on the upper sidewalk (above the
    # oracle's min_area but far below car_area -> class-0 noise the
    # queries must ignore; below the device cc_threshold -> never a
    # device track).
    for t0 in range(0, frames - 200, 260):
        spr = sprite(14, 30, float(rng.integers(30, 70)), rng)
        movers.append(Mover(spr, h_path(0.9, 318, -14 - 0.9 * t0), t0,
                            frames))
    return movers


def render(out_mp4, frames=1800, seed=11):
    rng = np.random.default_rng(seed)
    bg_y, bg_u, bg_v = build_background(rng)
    movers = build_movers(rng, frames)

    out_mp4 = pathlib.Path(out_mp4)
    out_mp4.parent.mkdir(parents=True, exist_ok=True)
    tool = REPO / "cova_tpu" / "csrc" / "tools" / "encode_yuv"
    if not tool.exists():
        subprocess.run(
            ["make", "-s", "-C", str(REPO / "cova_tpu" / "csrc"),
             "tools/encode_yuv"],
            check=True,
        )
    rec = str(out_mp4) + ".rec"
    proc = subprocess.Popen(
        [str(tool), "-", rec, f"{W}x{H}", X264_OPTS, "23"],
        stdin=subprocess.PIPE,
    )
    # Per-frame sensor noise comes from a SEPARATE per-frame generator
    # so object schedules stay seed-stable if the noise model changes.
    nrng = np.random.default_rng(seed + 1)
    for i in range(frames):
        y = bg_y.copy()
        u = bg_u.copy()
        v = bg_v.copy()
        for m in movers:
            m.draw(i, y, u, v)
        draw_gates(y, u, v)  # static occluders OVER the traffic
        y += nrng.normal(0, 1.2, y.shape)  # sensor noise
        proc.stdin.write(np.clip(y, 0, 255).astype(np.uint8).tobytes())
        proc.stdin.write(np.clip(u, 0, 255).astype(np.uint8).tobytes())
        proc.stdin.write(np.clip(v, 0, 255).astype(np.uint8).tobytes())
    proc.stdin.close()
    if proc.wait() != 0:
        raise RuntimeError("encode_yuv failed")

    from cova_tpu.utils.mp4loop import mux_rec_to_mp4

    tmp = str(out_mp4) + ".tmp"
    n = mux_rec_to_mp4(rec, tmp)
    os.unlink(rec)
    os.replace(tmp, str(out_mp4))
    print(f"wrote {out_mp4}: {n} samples (synthetic scene, seed {seed})")
    return str(out_mp4)


def build_synth(out_mp4=str(REPO / "build_out" / "synth" / "synth.mp4"),
                frames=1800, seed=11):
    """Cached build (validated like make_dataset2.build_1080p, plus a
    recipe-tag sidecar: dims/sample-count can't distinguish two
    procedural recipes)."""
    tag = f"{RECIPE} seed={seed} frames={frames}"
    sidecar = out_mp4 + ".recipe"
    if os.path.exists(out_mp4):
        ok = False
        try:
            from cova_tpu.codec import Mp4Demuxer

            d = Mp4Demuxer(out_mp4)
            ok = (
                (d.width, d.height, d.num_samples) == (W, H, frames)
                and os.path.exists(sidecar)
                and pathlib.Path(sidecar).read_text() == tag
            )
        except Exception:
            pass
        if ok:
            return out_mp4
        os.unlink(out_mp4)
    path = render(out_mp4, frames=frames, seed=seed)
    pathlib.Path(sidecar).write_text(tag)
    return path


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    out = args[0] if args else str(REPO / "build_out" / "synth" / "synth.mp4")
    frames = int(args[1]) if len(args) > 1 else 1800
    seed = 11
    if "--seed" in sys.argv:
        seed = int(sys.argv[sys.argv.index("--seed") + 1])
    render(out, frames=frames, seed=seed)
