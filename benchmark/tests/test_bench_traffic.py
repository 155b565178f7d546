"""Traffic is made from the seed: the same seed gives the same frames, and
another seed other frames, over the same track of the configuration."""

import numpy as np
import pytest

from harness import cell as cells
from trackdrive_cells import load


def _drive(workload, seed, lane=None):
    cell = load(workload)
    return cells.track_module(cell).Drive(cell.config, cell.traffic, seed, lane)


def _same(a, b):
    fa, fb = a.frame(7)[0], b.frame(7)[0]
    return all(np.array_equal(x, y) for x, y in zip(fa.cones + [fa.position], fb.cones + [fb.position]))


@pytest.mark.parametrize("seed", [0, 2**31 + 17])
def test_same_seed_same_frames(seed):
    assert _same(_drive("trackdrive.online", seed), _drive("trackdrive.online", seed))
    assert _same(_drive("trackdrive.sweep", seed, 5), _drive("trackdrive.sweep", seed, 5))


def test_other_seed_other_frames():
    assert not _same(_drive("trackdrive.online", 1), _drive("trackdrive.online", 2))
    a, b = _drive("trackdrive.sweep", 1, 0), _drive("trackdrive.sweep", 1, 1)
    assert not np.array_equal(a.track.left[:5], b.track.left[:5]), "lanes drive their own layouts"


def test_online_layout_is_the_configurations():
    a, b = _drive("trackdrive.online", 1), _drive("trackdrive.online", 2)
    np.testing.assert_array_equal(a.track.left, b.track.left)
    assert 120 <= len(a.track.left) + len(a.track.right) + len(a.track.unknown) <= 256


def test_start_station_is_drawn_from_the_seed():
    starts = {_drive("trackdrive.online", s).start(np.random.default_rng([s, 0])) for s in range(8)}
    assert len(starts) > 1


def test_distractors_stay_clear_of_the_borders():
    mod = cells.track_module(load("trackdrive.online"))
    for seed in range(20):
        t = mod.closed_track(seed)
        borders = np.concatenate([t.left, t.right])
        d = np.linalg.norm(t.unknown[:, None] - borders[None], axis=2)
        assert len(t.unknown) == 6 and d.min() >= mod.CLEAR_M
