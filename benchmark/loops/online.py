"""The online loop: one client, the car's autonomy stack.

A closed loop with one client: each frame goes to
`PathPlanner.calculate_path_in_global_frame`, and the next is sent when the
path is back on the host as a numpy array. Each call is timed on the host
clock. On a closed track the frames follow the car around the track from a
station drawn from the seed, so every seed drives the same frames in
another order; a mission with an end (skidpad) drives each run from its
entry to its exit with a new planner.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np

from harness.program import planner_config


class Loop:
    unit = "frame"

    def __init__(self, cell, seed: int, track, device: str = "cuda"):
        self.cell, self.seed, self.track, self.device = cell, seed, track, device
        self.traffic = cell.traffic
        self.drive = track.Drive(cell.config, self.traffic, seed)
        self.next_frame = self.drive.start(np.random.default_rng([seed, 0]))
        self.latencies: list[float] = []
        self.answers: dict[int, np.ndarray | None] = {}
        #: a run of a mission with an end (skidpad) starts again with a new planner
        self.frames_per_run = getattr(self.drive, "frames_per_run", None)
        #: the window drives whole periods: a mission's runs, a closed track's laps
        self.period = self.frames_per_run or self.drive.frames_per_lap
        self.run = None
        self.attempted = self.failed = 0

    def setup(self) -> None:
        from ft_fsd_path_planning_torch import PathPlanner
        from ft_fsd_path_planning_torch.ops import kernel_build

        if self.device == "cuda":
            kernel_build.build_all()
        self.cfg = planner_config(self.cell.config)
        self.PathPlanner = PathPlanner
        self._planner_for(self.next_frame)
        # the shapes of every frame are the same: a few frames warm them up;
        # a relocalizer mission also drives up to its first relocalization
        self._play(self.traffic["warmup_frames"], record=False)
        self._warm_relocalizer()

    def _planner_for(self, i: int) -> None:
        """A new planner at the start of each run of a mission with an end."""
        run = i // self.frames_per_run if self.frames_per_run else 0
        if run != self.run:
            self.planner = self.PathPlanner(self.cfg.mission, config=self.cfg, device=self.device)
            self.run = run

    def _warm_relocalizer(self) -> None:
        if not self.planner.cfg.has_relocalizer:
            return
        for _ in range(self.traffic["max_frames_to_relocalize"]):
            if self.planner.relocalization_info is not None:
                return
            self._play(1, record=False)
        # the check holds the transform against the reference's, and fails
        print("the planner did not relocalize during set-up", file=sys.stderr)

    def _call(self, i: int, record: bool = True) -> None:
        self._planner_for(i)
        frame = self.drive.frame(i)[0]
        t0 = time.perf_counter()
        try:
            path = self.planner.calculate_path_in_global_frame(
                frame.cones, frame.position, frame.direction
            )
            ok = path.shape == (40, 4) and bool(np.all(np.isfinite(path)))
        except Exception as exc:  # a raised plan counts as failed
            print(f"frame {i}: {type(exc).__name__}: {exc}", flush=True, file=sys.stderr)
            path, ok = None, False
        dt = time.perf_counter() - t0
        if record:
            self.latencies.append(dt)
            self.attempted += 1
            self.failed += not ok
            self.answers[i] = path if ok else None

    def _play(self, n: int, record: bool = True) -> int:
        for _ in range(n):
            self._call(self.next_frame, record)
            self.next_frame += 1
        return n

    def window(self, seconds: float) -> float:
        """Whole periods, from the start of the next, until ``seconds`` have
        passed: every window drives the same mix of frames, whatever the
        program's speed. Python's garbage collector is off inside it."""
        if self.frames_per_run:
            self.next_frame += -self.next_frame % self.frames_per_run
            self._planner_for(self.next_frame)
        gc.collect()
        gc.disable()
        try:
            t0 = time.perf_counter()
            t_end = t0 + seconds
            while True:
                self._play(self.period)
                if time.perf_counter() >= t_end:
                    return time.perf_counter() - t0
        finally:
            gc.enable()

    def end_to_end(self, elapsed: float) -> dict:
        ms = np.asarray(self.latencies) * 1e3
        return {
            "plan_ms_p50": float(np.percentile(ms, 50)),
            "plan_ms_p95": float(np.percentile(ms, 95)),
        }

    def to_traced(self) -> None:
        """Drive on to the frames a traced run traces, the same whatever the
        program's speed."""
        self._play(self.traffic["trace_after_frames"], record=False)

    def traced_units(self) -> int:
        return self._play(self.traffic["trace_frames"])

    def staged_units(self) -> int:
        return self._play(self.traffic["stage_frames"], record=False)

    def finish(self) -> None:
        del self.planner

    def to_check(self, rng: np.random.Generator) -> list:
        """Every answer recorded: (frame index, served path or None)."""
        return sorted(self.answers.items())

    def reference(self, key: int):
        return self.track.reference(self.drive, key)
