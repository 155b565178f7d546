"""With the timed path broken underneath, the check says `correct` is
false: once for each fault these cells can have."""

import pytest
import torch

from dryrun import dry_run


def _unchanged_step(real):
    """A step that returns its state unchanged: the previous path again."""
    def step(cfg, state, frame, *a):
        out, _ = real(cfg, state, frame, *a)
        return out._replace(path=state.path.prev_path), state
    return step


def _half_batch(real):
    """Only the first half of the batch is planned; the rest keeps its
    previous paths."""
    def step(cfg, state, frame):
        half = frame.position.shape[0] // 2
        take = lambda t: t[:half]  # noqa: E731
        from ft_fsd_path_planning_torch.parallel.batch import tree_map
        out, new = real(cfg, tree_map(take, state), tree_map(take, frame))
        path = torch.cat([out.path, state.path.prev_path[half:]])
        ok = torch.cat([out.path_ok, torch.ones_like(out.path_ok[: path.shape[0] - half])])
        return out._replace(path=path, path_ok=ok), state
    return step


def _altered(real):
    """The path comes out 5 cm off where it is produced."""
    def run(*a, **kw):
        out = real(*a, **kw)
        moved = out.path.clone()
        moved[..., 1] += 0.05
        return out._replace(path=moved)
    return run


def _correct(workload, **small):
    return dry_run(workload, 2**31 + 9, 1.5, **small)["correct"]


SWEEP = {"batch": 4, "check_sample": 8, "warmup_steps": 1}


@pytest.mark.parametrize("workload", ["trackdrive.online", "skidpad.online"])
def test_online_unchanged_state(monkeypatch, workload):
    from ft_fsd_path_planning_torch.models import facade

    monkeypatch.setattr(facade, "planner_step", _unchanged_step(facade.planner_step))
    assert _correct(workload) is False


def test_sweep_unchanged_state(monkeypatch):
    from ft_fsd_path_planning_torch.parallel import batch

    monkeypatch.setattr(batch, "planner_step", _unchanged_step(batch.planner_step))
    assert _correct("trackdrive.sweep", **SWEEP) is False


def test_sweep_half_the_batch(monkeypatch):
    from ft_fsd_path_planning_torch.parallel import batch

    monkeypatch.setattr(batch, "planner_step", _half_batch(batch.planner_step))
    assert _correct("trackdrive.sweep", **SWEEP) is False


@pytest.mark.parametrize(
    "workload,small", [("trackdrive.online", {}), ("trackdrive.sweep", SWEEP), ("skidpad.online", {})]
)
def test_answer_altered(monkeypatch, workload, small):
    from ft_fsd_path_planning_torch.models import pathing

    monkeypatch.setattr(pathing, "run_path_calculation", _altered(pathing.run_path_calculation))
    assert _correct(workload, **small) is False


def _moved_relocalization(real):
    """The relocalizer's transform comes out 2 mrad off where it is made."""
    def run(*a, **kw):
        ok, rotation, translation, center = real(*a, **kw)
        return ok, rotation + 0.002, translation, center
    return run


def test_relocalization_altered(monkeypatch):
    from ft_fsd_path_planning_torch.models import relocalization

    monkeypatch.setattr(relocalization, "skidpad_relocalize_once",
                        _moved_relocalization(relocalization.skidpad_relocalize_once))
    assert _correct("skidpad.online") is False
