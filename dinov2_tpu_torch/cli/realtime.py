"""Streaming-frame PCA feature visualization (port of
dinov2_tpu/cli/realtime.py, `dinov2-realtime`; the reference's
realtime.cpp): frames at a fixed 854x480, per frame resize (nearest) ->
preprocess -> forward -> PCA -> hconcat(frame, vis) -> imshow; 'q' quits.
An 854x480 frame is a 35x62 patch grid, T = 2171 tokens.

Extensions for headless hosts: --video FILE streams a video file,
--synthetic streams generated frames, --frames N bounds the run,
--no-display prints frame times and FPS instead of showing the frames.

    python -m dinov2_tpu_torch.cli.realtime -m model.gguf --synthetic \
        --no-display --frames 20 [--pipeline | --no-pipeline] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np

from dinov2_tpu_torch.cli._common import add_common_args, engine_from_args, save_image_rgb

WIDTH, HEIGHT = 854, 480  # the reference's realtime.h


def _frame_source(args):
    import cv2

    if args.synthetic:
        rng = np.random.default_rng(0)
        t = 0
        while True:
            # moving gradient + noise: enough structure for PCA to latch onto
            yy, xx = np.mgrid[0:HEIGHT, 0:WIDTH]
            frame = np.stack(
                [
                    ((xx + 5 * t) % 256),
                    ((yy + 3 * t) % 256),
                    ((xx + yy + 2 * t) % 256),
                ],
                axis=-1,
            ).astype(np.uint8)
            frame = np.clip(
                frame.astype(np.int16) + rng.integers(-8, 8, frame.shape), 0, 255
            ).astype(np.uint8)
            t += 1
            yield frame
    else:
        src = args.video if args.video else int(args.camera_id)
        cap = cv2.VideoCapture(src)
        if not cap.isOpened():
            raise RuntimeError(f"failed to open capture source {src!r}")
        while True:
            ok, frame = cap.read()
            if not ok:
                return
            frame = cv2.resize(frame, (WIDTH, HEIGHT), interpolation=cv2.INTER_NEAREST)
            yield cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(parser)
    parser.add_argument("-cid", "--camera_id", type=int, default=0)
    parser.add_argument("--video", default=None, help="stream a video file instead of a camera")
    parser.add_argument("--synthetic", action="store_true", help="stream generated frames")
    parser.add_argument("--frames", type=int, default=0, help="stop after N frames (0 = endless)")
    parser.add_argument("--no-display", action="store_true")
    parser.add_argument("--save-last", default=None, help="write the final hconcat frame here")
    parser.add_argument(
        "--pipeline", dest="pipeline", action="store_const", const="on",
        default="auto",
        help="force double-buffering: queue frame N+1's upload and compute "
        "on the device while frame N's result is read back (display lags one "
        "frame). The default is adaptive: after warmup, both loops are probed "
        "for a few frames and the faster one drives the rest of the stream.",
    )
    parser.add_argument(
        "--no-pipeline", dest="pipeline", action="store_const", const="off",
        help=argparse.SUPPRESS,  # force the synchronous loop
    )
    args = parser.parse_args(argv)

    engine = engine_from_args(args)

    display = not args.no_display
    if display:
        try:
            import cv2

            cv2.namedWindow("dinov2-tpu realtime")
        except Exception:
            display = False

    import cv2

    last = None
    n = 0
    t_start = time.perf_counter()
    t_warm = None  # wall clock after the warmup frames (kernel builds, allocator)
    WARMUP_FRAMES = 3

    def show(frame, vis) -> bool:
        """Resize/compose/display one finished frame; returns False on 'q'."""
        nonlocal last, n, t_warm
        vis = cv2.resize(vis, (WIDTH, HEIGHT), interpolation=cv2.INTER_NEAREST)
        combined = np.concatenate([frame, vis], axis=1)
        last = combined
        n += 1
        if n == WARMUP_FRAMES:
            t_warm = time.perf_counter()
        print(
            f"frame {n}: graph computation took {engine.last_compute_ms:.2f} ms",
            file=sys.stderr,
        )
        if display:
            cv2.imshow("dinov2-tpu realtime", cv2.cvtColor(combined, cv2.COLOR_RGB2BGR))
            if cv2.waitKey(1) & 0xFF == ord("q"):
                return False
        return True

    source = _frame_source(args)

    def _stop_at(budget):
        stop = None if budget is None else n + budget
        if args.frames:
            stop = args.frames if stop is None else min(stop, args.frames)
        return stop

    def run_sync(budget=None) -> bool:
        """Show up to `budget` frames synchronously. Returns True iff the
        stream can continue (budget reached before quit/source-end/cap)."""
        stop = _stop_at(budget)
        for frame in source:
            vis = engine.pca_visualization(frame)
            if not show(frame, vis):
                return False
            if stop is not None and n >= stop:
                return not (args.frames and n >= args.frames)
        return False

    def device_frame(frame) -> np.ndarray:
        """One frame's upload, forward, PCA and copy back: the grid-sized
        visualization on the host."""
        return engine.pca_visualization_async(frame).cpu().numpy()[0]

    def run_pipelined(budget=None) -> bool:
        """Double-buffered: frame N's upload, forward, PCA and copy back run
        on one device thread while this thread makes frame N+1 and shows
        frame N-1. The device thread is the only one that calls the engine.
        It, not this thread, waits where PyTorch waits for the card (the
        PCA's eigh checks its result on the host, and a copy to pageable
        memory waits for the compute queued before it), so the host's frame
        work overlaps the device's. Display lags one frame. Drains its
        in-flight frame before returning, so probe phases are
        self-contained."""
        stop = _stop_at(budget)
        pending: tuple[np.ndarray, Future] | None = None
        t_frame = time.perf_counter()
        with ThreadPoolExecutor(1) as device:
            for frame in source:
                fut = device.submit(device_frame, frame)
                if pending is not None:
                    pframe, pfut = pending
                    vis = pfut.result()  # frame N-1; frame N runs meanwhile
                    engine.last_compute_ms = (time.perf_counter() - t_frame) * 1e3
                    t_frame = time.perf_counter()
                    if not show(pframe, vis):
                        return False
                pending = (frame, fut)
                if stop is not None and n >= stop - 1:
                    break  # the drain below delivers frame `stop`
            if pending is not None:
                pframe, pfut = pending
                vis = pfut.result()
                engine.last_compute_ms = (time.perf_counter() - t_frame) * 1e3
                if not show(pframe, vis):
                    return False
        if args.frames and n >= args.frames:
            return False
        return stop is not None and n >= stop

    if args.pipeline == "off":
        run_sync()
    elif args.pipeline == "on":
        run_pipelined()
    else:
        # adaptive: whether double-buffering wins depends on the host and its
        # attachment to the device. Probe both after warmup and let the
        # stream ride the winner. The pipelined probe pays its own fill and
        # drain, a slight bias toward sync, the safe default.
        PROBE = 6
        cont = run_sync(WARMUP_FRAMES)
        sync_fps = pipe_fps = None
        if cont:
            t0, n0 = time.perf_counter(), n
            cont = run_sync(PROBE)
            if n > n0:
                sync_fps = (n - n0) / (time.perf_counter() - t0)
        if cont:
            t0, n0 = time.perf_counter(), n
            cont = run_pipelined(PROBE)
            if n > n0:
                pipe_fps = (n - n0) / (time.perf_counter() - t0)
        if cont:
            use_pipe = (
                sync_fps is not None and pipe_fps is not None
                and pipe_fps > sync_fps
            )
            print(
                f"auto-pipeline: sync {sync_fps:.2f} FPS vs double-buffered "
                f"{pipe_fps:.2f} FPS -> {'double-buffered' if use_pipe else 'sync'}",
                file=sys.stderr,
            )
            run_pipelined() if use_pipe else run_sync()

    dt = time.perf_counter() - t_start
    if n:
        print(f"{n} frames in {dt:.2f}s = {n / dt:.2f} FPS", file=sys.stderr)
    if t_warm is not None and n > WARMUP_FRAMES:
        sdt = time.perf_counter() - t_warm
        print(
            f"steady-state (excl. first {WARMUP_FRAMES}): "
            f"{n - WARMUP_FRAMES} frames in {sdt:.2f}s = "
            f"{(n - WARMUP_FRAMES) / sdt:.2f} FPS",
            file=sys.stderr,
        )
    if args.save_last and last is not None:
        save_image_rgb(args.save_last, last)
    return 0


if __name__ == "__main__":
    sys.exit(main())
