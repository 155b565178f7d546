"""The port's relocalizers against the JAX package's, on seeded cone sets.

The same numpy inputs go through `skidpad_relocalize_once` /
`acceleration_relocalize_once` of both packages:

* in **float64** (JAX under ``enable_x64`` on the CPU, as its facade's
  refinement runs it; the port in ``torch.float64``): ``ok`` equal, rotation,
  translation and centre within 1e-9;
* in **float32** (what the planner step runs): ``ok`` equal, the mask of
  accepted circle trios equal, rotation within 2e-4 rad, translation within
  2 mm.

The cases cover the full skidpad track seen from several poses, frames with
fewer than 20 cones, fewer than 3 accepted circles, both circle centres on
one side of the origin pose, and acceleration rows of fewer than 4 (and of
fewer than 3) cones. The two transforms are inverses of each other, and
`attempt_relocalization` stores the origin once and freezes the transform
after its first success, lane for lane.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ft_fsd_path_planning_tpu.config import default_config as jax_config
from ft_fsd_path_planning_tpu.models import relocalization as jreloc
from ft_fsd_path_planning_tpu.ops import gatherless as jgl
from ft_fsd_path_planning_tpu.ops import geometry as jgeo
from ft_fsd_path_planning_tpu.utils.mission_types import MissionTypes as JMissionTypes
from ft_fsd_path_planning_torch.config import default_config as torch_config
from ft_fsd_path_planning_torch.models import relocalization as treloc
from ft_fsd_path_planning_torch.parallel import scenarios as tscen
from ft_fsd_path_planning_torch.utils.mission_types import MissionTypes

torch.set_num_threads(1)

N = 64  # cone budget of the cases
F64_TOL = 1e-9
F32_ROT_TOL, F32_TRANS_TOL = 2e-4, 2e-3


def _pad(cones: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    cones = cones[:N]
    xy = np.zeros((N, 2))
    mask = np.zeros(N, bool)
    xy[: len(cones)] = cones
    mask[: len(cones)] = True
    return xy, mask


def _skidpad_cases() -> dict:
    """name -> (cones (N, 2), mask, vehicle position, origin position, origin
    direction, expected ok), float64 numpy."""
    full = tscen.skidpad_session()
    partial = tscen.skidpad_session(True, 60)
    rng = np.random.default_rng(5)
    cases = {}
    for i in (0, 40, 150, 300, 420):
        cones, pos, direction = full[i]
        cases[f"full view, frame {i}"] = (*_pad(cones[0]), pos, full[0][1], full[0][2], None)
    for i in (0, 3, 10, 30):  # 10, 14, 18 and 18 cones in view
        cones, pos, direction = partial[i]
        assert len(cones[0]) < 20
        cases[f"partial view, frame {i} ({len(cones[0])} cones)"] = (*_pad(cones[0]), pos, partial[0][1], partial[0][2], None)
    scatter = rng.uniform(-15.0, 15.0, (30, 2))
    cases["scatter: fewer than 3 accepted circles"] = (*_pad(scatter), np.zeros(2), np.zeros(2), np.array([1.0, 0.0]), False)
    cones, pos, _ = full[0]
    # an origin pose far to one side of the track: both centres on its left
    far = tscen._known_to_map(np.array([0.0, -40.0]), tscen.SKIDPAD_MAP_ROTATION, tscen.SKIDPAD_MAP_SHIFT)
    heading = tscen._rot(np.array([1.0, 0.0]), tscen.SKIDPAD_MAP_ROTATION)
    cases["both centres on one side"] = (*_pad(cones[0]), pos, far, heading, False)
    cases["two cones"] = (*_pad(scatter[:2]), np.zeros(2), np.zeros(2), np.array([1.0, 0.0]), False)
    return cases


SKIDPAD_CASES = _skidpad_cases()


def _accel_cases() -> dict:
    """name -> (cones, mask, position, direction, origin position)."""
    lists = tscen.acceleration_session(1)[0][0]
    left, right = lists[2], lists[1]
    both = np.concatenate([left, right])
    cases = {}
    for name, theta, shift, x in (("aligned", 0.0, (0.0, 0.0), 0.0), ("rotated", 0.7, (3.0, -2.0), 12.0), ("reversed", 2.9, (-8.0, 5.0), 30.0)):
        cones = tscen._known_to_map(both, theta, shift)
        pos = tscen._known_to_map(np.array([x, 0.0]), theta, shift)
        cases[name] = (*_pad(cones), pos, tscen._rot(np.array([1.0, 0.0]), theta), pos - 1.0)
    for k in (0, 2, 3, 4):  # cones in the near-left row
        cones = np.concatenate([left[:k], right[:10]])
        cases[f"{k} row cones"] = (*_pad(cones), np.zeros(2), np.array([1.0, 0.0]), np.array([0.5, 0.25]))
    return cases


ACCEL_CASES = _accel_cases()


def _torch_args(args, dtype):
    return [
        torch.as_tensor(a)[None] if a.dtype == bool else torch.as_tensor(a, dtype=dtype)[None]
        for a in args
    ]


def _jax_call(fn, args, x64: bool):
    dtype = jnp.float64 if x64 else jnp.float32
    with jax.enable_x64(x64):
        out = fn(*(jnp.asarray(a) if a.dtype == bool else jnp.asarray(a, dtype) for a in args))
        return [np.asarray(o) for o in out]


def _jax_accept(xy, mask, pos):
    """The accepted-trio mask of the JAX package's skidpad attempt: the
    statements of `skidpad_relocalize_once` up to ``accept``, on its own
    helpers (the function does not return the mask)."""
    cones_xy, mask, pos = jnp.asarray(xy, jnp.float32), jnp.asarray(mask), jnp.asarray(pos, jnp.float32)
    dist = jnp.where(mask, jnp.linalg.norm(cones_xy - pos, axis=1), jnp.inf)
    neg, close_idx = jax.lax.top_k(-dist, 20)
    close = jgl.take_rows(cones_xy, close_idx)
    close_ok = jnp.isfinite(neg)
    subsets = jnp.asarray(jreloc._SUBSETS)
    pts = jgl.take_rows(close, subsets.reshape(-1)).reshape(-1, 3, 2)
    subset_ok = jnp.all(close_ok[subsets], axis=1)
    d2 = jnp.where(~jnp.eye(3, dtype=bool), jgeo.cdist_sq(pts, pts), jnp.inf)
    mean_nn = jnp.sum(jnp.sqrt(jnp.min(d2, axis=-1)), axis=1) / 3
    pts_noisy = pts + jnp.asarray(jreloc._NOISE_TABLES)[jnp.sum(close_ok)]
    circ = jgeo.circle_fit(pts_noisy, jnp.ones((len(subsets), 3), bool))
    center_s, radius_s = circ[:, :2], circ[:, 2]
    resid = jnp.abs(jnp.linalg.norm(center_s[:, None, :] - pts_noisy, axis=-1) - radius_s[:, None])
    residual = jnp.sum(resid, axis=1) / 3
    margins = jnp.stack([
        1.0 - jnp.abs(radius_s - 7.625), 1.5 - jnp.abs(mean_nn - 2.4), 0.4 - residual,
    ], axis=1)
    return np.asarray(subset_ok & jnp.all(margins > 0, axis=1)), np.asarray(margins)


@pytest.mark.parametrize("case", sorted(SKIDPAD_CASES))
def test_skidpad_relocalize_once_float64(case):
    *args, want_ok = SKIDPAD_CASES[case]
    theirs = _jax_call(jreloc.skidpad_relocalize_once, args, x64=True)
    ours = [o[0].numpy() for o in treloc.skidpad_relocalize_once(*_torch_args(args, torch.float64))]
    assert ours[1].dtype == np.float64 and theirs[1].dtype == np.float64
    assert bool(ours[0]) == bool(theirs[0])
    if want_ok is not None:
        assert bool(ours[0]) is want_ok
    if ours[0]:
        for name, a, b in zip(("rotation", "translation", "center"), ours[1:], theirs[1:]):
            np.testing.assert_allclose(a, b, rtol=0, atol=F64_TOL, err_msg=name)


@pytest.mark.parametrize("case", sorted(SKIDPAD_CASES))
def test_skidpad_relocalize_once_float32(case):
    *args, _ = SKIDPAD_CASES[case]
    theirs = _jax_call(jreloc.skidpad_relocalize_once, args, x64=False)
    targs = _torch_args(args, torch.float32)
    ours = [o[0].numpy() for o in treloc.skidpad_relocalize_once(*targs)]
    accept, _ = treloc.skidpad_accepted_trios(*targs[:3])
    their_accept, margins = _jax_accept(*args[:3])
    differing = np.nonzero(accept[0].numpy() != their_accept)[0]
    assert differing.size == 0, [(int(i), margins[i].tolist()) for i in differing]
    assert bool(ours[0]) == bool(theirs[0])
    if ours[0]:
        assert abs(float(ours[1]) - float(theirs[1])) < F32_ROT_TOL
        np.testing.assert_allclose(ours[2], theirs[2], rtol=0, atol=F32_TRANS_TOL)
        np.testing.assert_array_equal(ours[3], theirs[3])


def test_skidpad_cases_cover_both_outcomes():
    oks = {}
    for case, (*args, _) in SKIDPAD_CASES.items():
        oks[case] = bool(treloc.skidpad_relocalize_once(*_torch_args(args, torch.float64))[0][0])
    assert oks["full view, frame 0"] and not oks["partial view, frame 0 (10 cones)"]
    assert sum(oks.values()) >= 3 and sum(not v for v in oks.values()) >= 4, oks
    # the frame-0 transform undoes the map's rotation (to the accuracy 64 of
    # the track's 72 noisy cones give)
    *args, _ = SKIDPAD_CASES["full view, frame 0"]
    rot = float(treloc.skidpad_relocalize_once(*_torch_args(args, torch.float64))[1][0])
    assert abs(rot + tscen.SKIDPAD_MAP_ROTATION) < 2e-2


def test_skidpad_batched_lanes_equal_single_lanes():
    """A batch of different frames gives each lane what it gets alone."""
    names = sorted(SKIDPAD_CASES)
    stacked = [np.stack([SKIDPAD_CASES[n][i] for n in names]) for i in range(5)]
    batched = treloc.skidpad_relocalize_once(
        *(torch.as_tensor(a) if a.dtype == bool else torch.as_tensor(a, dtype=torch.float32) for a in stacked)
    )
    for lane, name in enumerate(names):
        single = treloc.skidpad_relocalize_once(*_torch_args(SKIDPAD_CASES[name][:5], torch.float32))
        assert bool(batched[0][lane]) == bool(single[0][0]), name
        if single[0][0]:
            for a, b in zip(batched[1:], single[1:]):
                np.testing.assert_allclose(a[lane].numpy(), b[0].numpy(), rtol=0, atol=1e-6, err_msg=name)


def test_skidpad_rejects_a_budget_below_20_cones():
    with pytest.raises(ValueError, match="n_cones >= 20"):
        treloc.skidpad_relocalize_once(
            torch.zeros(1, 12, 2), torch.zeros(1, 12, dtype=torch.bool), torch.zeros(1, 2), torch.zeros(1, 2), torch.ones(1, 2)
        )


@pytest.mark.parametrize("x64", [True, False], ids=["float64", "float32"])
@pytest.mark.parametrize("case", sorted(ACCEL_CASES))
def test_acceleration_relocalize_once(case, x64):
    args = ACCEL_CASES[case]
    theirs = _jax_call(jreloc.acceleration_relocalize_once, args, x64=x64)
    ours = [o[0].numpy() for o in treloc.acceleration_relocalize_once(*_torch_args(args, torch.float64 if x64 else torch.float32))]
    assert bool(ours[0]) == bool(theirs[0])
    assert bool(ours[0]) == (int(case.split()[0]) >= 4 if case.endswith("row cones") else True)
    rot_tol, trans_tol = (F64_TOL, F64_TOL) if x64 else (F32_ROT_TOL, F32_TRANS_TOL)
    # the RANSAC's trio table is static, so even a failed attempt is comparable
    assert abs(float(ours[1]) - float(theirs[1])) < rot_tol
    np.testing.assert_allclose(ours[2], theirs[2], rtol=0, atol=trans_tol)
    np.testing.assert_array_equal(ours[3], theirs[3])


def test_acceleration_finds_the_corridor_angle():
    for name, theta in (("aligned", 0.0), ("rotated", 0.7), ("reversed", 2.9)):
        rot = float(treloc.acceleration_relocalize_once(*_torch_args(ACCEL_CASES[name], torch.float64))[1][0])
        assert abs(np.angle(np.exp(1j * (rot + theta)))) < 0.02, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_transforms_are_inverses(dtype):
    rng = np.random.default_rng(2)
    b = 6
    state = treloc.RelocState.initial(b, torch.device("cpu"))._replace(
        rotation=torch.as_tensor(rng.uniform(-np.pi, np.pi, b), dtype=dtype),
        translation=torch.as_tensor(rng.uniform(-10, 10, (b, 2)), dtype=dtype),
        center=torch.as_tensor(rng.uniform(-10, 10, (b, 2)), dtype=dtype),
    )
    for shape in ((b, 2), (b, 40, 2)):
        pos = torch.as_tensor(rng.uniform(-30, 30, shape), dtype=dtype)
        yaw = torch.as_tensor(rng.uniform(-np.pi, np.pi, shape[:-1]), dtype=dtype)
        known, yaw_k = treloc.transform_to_known_frame(state, pos, yaw)
        back, yaw_b = treloc.transform_to_original_frame(state, known, yaw_k)
        assert float((back - pos).abs().max()) < 1e-5
        assert float((yaw_b - yaw).abs().max()) < 1e-5
        assert float((known - pos).abs().max()) > 1.0  # the transform moves points
    # lane 0 against the JAX package's transform
    jstate = jreloc.RelocState.initial()._replace(
        rotation=jnp.asarray(state.rotation[0].numpy(), jnp.float32),
        translation=jnp.asarray(state.translation[0].numpy(), jnp.float32),
        center=jnp.asarray(state.center[0].numpy(), jnp.float32),
    )
    theirs, _ = jreloc.transform_to_known_frame(jstate, jnp.asarray(pos[0].numpy(), jnp.float32), jnp.zeros(40))
    np.testing.assert_allclose(known[0].numpy(), np.asarray(theirs), rtol=0, atol=2e-5)


def test_attempt_relocalization_stores_origin_once_and_freezes():
    """Three frames, two lanes: lane 0 sees too few cones on frame 0 and
    relocalizes on frame 1; lane 1 relocalizes on frame 0. The origin is the
    first pose of each lane, the transform is frozen after the first success,
    and every field equals the JAX package's per lane."""
    full, partial = tscen.skidpad_session(n_frames=3), tscen.skidpad_session(True, 3)
    lanes = [[partial[0], full[1], full[2]], [full[0], full[1], full[2]]]
    jcfg, tcfg = jax_config(JMissionTypes.skidpad, n_cones=N), torch_config(MissionTypes.skidpad, n_cones=N)
    jstates = [jreloc.RelocState.initial(), jreloc.RelocState.initial()]
    tstate = treloc.RelocState.initial(2, torch.device("cpu"))
    jattempt = jax.jit(lambda s, *a: jreloc.attempt_relocalization(jcfg, s, *a))
    history = []
    for t in range(3):
        padded = [_pad(lanes[lane][t][0][0]) for lane in range(2)]
        xy = np.stack([p[0] for p in padded]).astype(np.float32)
        mask = np.stack([p[1] for p in padded])
        pos = np.stack([lanes[lane][t][1] for lane in range(2)]).astype(np.float32)
        direction = np.stack([lanes[lane][t][2] for lane in range(2)]).astype(np.float32)
        tstate = treloc.attempt_relocalization(
            tcfg, tstate, torch.as_tensor(xy), torch.as_tensor(mask), torch.as_tensor(pos), torch.as_tensor(direction)
        )
        for lane in range(2):
            jstates[lane] = jattempt(jstates[lane], xy[lane], mask[lane], pos[lane], direction[lane])
            for name in treloc.RelocState._fields:
                ours, theirs = getattr(tstate, name)[lane].numpy(), np.asarray(getattr(jstates[lane], name))
                if ours.dtype == bool or name.startswith("origin"):
                    np.testing.assert_array_equal(ours, theirs, err_msg=f"frame {t} lane {lane} {name}")
                else:
                    tol = F32_ROT_TOL if name == "rotation" else F32_TRANS_TOL
                    np.testing.assert_allclose(ours, theirs, rtol=0, atol=tol, err_msg=f"frame {t} lane {lane} {name}")
        history.append(tstate)
    assert history[0].relocalized.tolist() == [False, True]
    assert history[1].relocalized.tolist() == [True, True]
    assert history[0].has_origin.all()
    # origin: each lane's first pose, never overwritten
    np.testing.assert_array_equal(history[2].origin_position[0].numpy(), lanes[0][0][1].astype(np.float32))
    np.testing.assert_array_equal(history[2].origin_position[1].numpy(), lanes[1][0][1].astype(np.float32))
    # frozen after success
    assert float(history[0].rotation[0]) == 0.0 and float(history[1].rotation[0]) != 0.0
    assert torch.equal(history[2].rotation, history[1].rotation)
    assert torch.equal(history[1].rotation[1], history[0].rotation[1])
    assert torch.equal(history[2].translation, history[1].translation)
