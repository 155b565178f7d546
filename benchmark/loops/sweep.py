"""The sweep loop: offline tooling pushing many drives through the batch.

Every step calls `parallel/batch.py::batched_step` on a batch of lanes,
each lane a car driving its own track one frame further, with its planner
state carried. Every step's (B, 40, 4) paths and path flags are copied to
the host, as a sweep that writes its results does. The frames of one lap
are made on the host from the seed at set-up, uploaded once, and cycled.
"""

from __future__ import annotations

import time

import numpy as np

from harness.frames import flatten
from harness.program import planner_config


class Loop:
    unit = "step"

    def __init__(self, cell, seed: int, track, device: str = "cuda"):
        self.cell, self.seed, self.track, self.device = cell, seed, track, device
        self.traffic = cell.traffic
        self.batch = self.traffic["batch"]
        self.drives = [track.Drive(cell.config, self.traffic, seed, lane) for lane in range(self.batch)]
        self.steps_per_lap = self.drives[0].frames_per_lap
        self.step = 0
        self.results: list[np.ndarray] = []  # per window step: (B, 40 * 4 + 1)
        self.result_steps: list[int] = []
        self.attempted = self.failed = 0

    def setup(self) -> None:
        import torch
        from ft_fsd_path_planning_torch.models.planner import FrameInput
        from ft_fsd_path_planning_torch.ops import kernel_build
        from ft_fsd_path_planning_torch.parallel.batch import make_batch_state

        if self.device == "cuda":
            kernel_build.build_all()
        self.cfg = planner_config(self.cell.config)
        n = self.cfg.shapes.n_cones
        t, b = self.steps_per_lap, self.batch
        cones = np.zeros((t, b, n, 3), np.float32)
        mask = np.zeros((t, b, n), bool)
        pos = np.zeros((t, b, 2), np.float32)
        direction = np.zeros((t, b, 2), np.float32)
        for lane, drive in enumerate(self.drives):
            for i in range(t):
                frame = drive.frame(i)[0]
                cones[i, lane], mask[i, lane] = flatten(frame.cones, n)
                pos[i, lane], direction[i, lane] = frame.position, frame.direction
        dev = torch.device(self.device)
        self.frames = FrameInput(*(torch.as_tensor(a, device=dev) for a in (cones, mask, pos, direction)))
        self.FrameInput = FrameInput
        self.state = make_batch_state(self.cfg, b, dev)
        self._play(self.traffic["warmup_steps"], record=False)

    def _step(self, record: bool = True) -> None:
        import torch
        from ft_fsd_path_planning_torch.parallel.batch import batched_step

        t = self.step % self.steps_per_lap
        frame = self.FrameInput(*(x[t] for x in self.frames))
        out, self.state = batched_step(self.cfg, self.state, frame)
        host = torch.cat(
            [out.path.reshape(self.batch, -1), out.path_ok[:, None].to(out.path.dtype)], dim=1
        ).cpu().numpy()
        if record:
            ok = (host[:, -1] > 0.5) & np.all(np.isfinite(host[:, :-1]), axis=1)
            self.results.append(host)
            self.result_steps.append(self.step)
            self.attempted += self.batch
            self.failed += int(np.sum(~ok))
        self.step += 1

    def _play(self, n: int, record: bool = True) -> int:
        for _ in range(n):
            self._step(record)
        return n

    def window(self, seconds: float) -> float:
        t_end = time.perf_counter() + seconds
        t0 = time.perf_counter()
        while time.perf_counter() < t_end:
            self._step()
        return time.perf_counter() - t0

    def end_to_end(self, elapsed: float) -> dict:
        return {"solves_per_s": len(self.results) * self.batch / elapsed}

    def to_traced(self) -> None:
        """Step on to the steps a traced run traces."""
        self._play(self.traffic["trace_after_steps"], record=False)

    def traced_units(self) -> int:
        return self._play(self.traffic["trace_steps"])

    def staged_units(self) -> int:
        return self._play(self.traffic["stage_steps"], record=False)

    def finish(self) -> None:
        del self.state, self.frames

    def to_check(self, rng: np.random.Generator) -> list:
        """A sample drawn from the seed of the recorded answers: ((step,
        lane), served path or None)."""
        total = len(self.results) * self.batch
        picks = rng.choice(total, size=min(self.traffic["check_sample"], total), replace=False)
        out = []
        for p in sorted(int(x) for x in picks):
            row = self.results[p // self.batch][p % self.batch]
            ok = row[-1] > 0.5 and np.all(np.isfinite(row[:-1]))
            out.append(((self.result_steps[p // self.batch], p % self.batch),
                        row[:-1].reshape(40, 4).astype(np.float64) if ok else None))
        return out

    def reference(self, key):
        step, lane = key
        return self.track.reference(self.drives[lane], step % self.steps_per_lap)
