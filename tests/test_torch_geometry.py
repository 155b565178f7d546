"""ops/geometry.py, ops/gatherless.py and ops/curvature.py of the port
against the JAX package, one function at a time, on seeded numpy inputs.

Tolerances: index and mask results must be equal; float results agree to
1e-5 absolute (float32 arithmetic in the same order, with library
transcendentals that may differ by an ulp). Lookups must be exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ft_fsd_path_planning_tpu.ops import curvature as jcurv
from ft_fsd_path_planning_tpu.ops import gatherless as jgl
from ft_fsd_path_planning_tpu.ops import geometry as jgeo
from ft_fsd_path_planning_torch.ops import curvature as tcurv
from ft_fsd_path_planning_torch.ops import gatherless as tgl
from ft_fsd_path_planning_torch.ops import geometry as tgeo

# the port's ops are small tensors: one intra-op thread is as fast here and
# leaves the cores to the other test workers
torch.set_num_threads(1)

ATOL = 1e-5
RNG = np.random.default_rng(7)
PTS = RNG.normal(0, 5, (4, 16, 2)).astype(np.float32)
MASK = RNG.random((4, 16)) > 0.3


def t(x):
    return torch.as_tensor(np.array(x))


def close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=atol)


@pytest.mark.parametrize(
    "name", ["normalize_last_axis", "norm_last_axis", "trace_distance_to_next", "trace_angles_between"]
)
def test_unary_vector_ops(name):
    close(getattr(tgeo, name)(t(PTS)), getattr(jgeo, name)(jnp.asarray(PTS)))


def test_angles_rotation_and_distances():
    a, b = PTS[:, :8], PTS[:, 8:]
    close(tgeo.vec_angle_between(t(a), t(b)), jgeo.vec_angle_between(a, b))
    theta = RNG.uniform(-3, 3, (4, 1)).astype(np.float32)
    close(tgeo.rotate(t(a), t(theta)), jgeo.rotate(a, theta))
    angles = RNG.uniform(-7, 7, (2, 32)).astype(np.float32)
    close(tgeo.angle_difference(t(angles[0]), t(angles[1])),
          jgeo.angle_difference(angles[0], angles[1]))
    close(tgeo.cdist_sq(t(a), t(b)), jgeo.cdist_sq(a, b), atol=1e-4)


def test_lerp():
    values = RNG.uniform(-3, 3, (4, 16)).astype(np.float32)
    lo1, hi1 = np.float32(-3.0), np.float32(3.0)
    lo2 = RNG.uniform(0, 1, (4, 1)).astype(np.float32)
    hi2 = lo2 + np.float32(2.5)
    close(tgeo.lerp(t(values), t(lo1), t(hi1), t(lo2), t(hi2)), jgeo.lerp(values, lo1, hi1, lo2, hi2))
    # the ends of the first range map onto the ends of the second
    close(tgeo.lerp(t(np.stack([lo1, hi1])), t(lo1), t(hi1), t(lo2[0]), t(hi2[0])), np.concatenate([lo2[0], hi2[0]]))


def test_points_inside_ellipse():
    center = RNG.normal(0, 2, (4, 2)).astype(np.float32)
    direction = RNG.normal(0, 1, (4, 2)).astype(np.float32)
    ours = tgeo.points_inside_ellipse(t(PTS), t(center), t(direction), 9.0, 4.0)
    theirs = jax.vmap(lambda p, c, d: jgeo.points_inside_ellipse(p, c, d, 9.0, 4.0))(
        PTS, center, direction
    )
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def test_circle_fit_on_noisy_arcs():
    ang = np.linspace(0, 1.2, 20)
    arcs = np.stack(
        [np.stack([r * np.cos(ang) + 3, r * np.sin(ang) - 1], -1) for r in (5.0, 12.0, 40.0)]
    ).astype(np.float32)
    arcs += RNG.normal(0, 0.02, arcs.shape).astype(np.float32)
    mask = np.ones(arcs.shape[:2], bool)
    mask[1, 15:] = False
    ours = tgeo.circle_fit(t(arcs), t(mask)).numpy()
    theirs = np.asarray(jgeo.circle_fit(jnp.asarray(arcs), jnp.asarray(mask)))
    # centre and radius of a 40 m arc are ill-conditioned in float32: compare
    # relative to the radius
    np.testing.assert_allclose(ours, theirs, rtol=1e-3, atol=1e-3)


def test_segments_and_self_intersections():
    poly = RNG.normal(0, 3, (5, 9, 2)).astype(np.float32)
    mask = RNG.random((5, 9)) > 0.2
    np.testing.assert_array_equal(
        tgeo.polyline_self_intersections(t(poly), t(mask)).numpy(),
        np.asarray(jgeo.polyline_self_intersections(jnp.asarray(poly), jnp.asarray(mask))),
    )


def test_masked_reductions_and_compaction():
    vals = RNG.normal(0, 1, (4, 16)).astype(np.float32)
    close(tgeo.masked_median(t(vals), t(MASK)), jgeo.masked_median(vals, MASK))
    np.testing.assert_array_equal(
        tgeo.masked_argmin(t(vals), t(MASK)).numpy(), np.asarray(jgeo.masked_argmin(vals, MASK))
    )
    for length in (None, 8, 24):
        o_t, v_t = tgeo.stable_compact(t(MASK), length)
        o_j, v_j = jgeo.stable_compact(jnp.asarray(MASK), length)
        np.testing.assert_array_equal(o_t.numpy(), np.asarray(o_j))
        np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))


def test_gatherless_lookups_keep_fill_semantics():
    table = RNG.normal(0, 1, (3, 10, 4)).astype(np.float32)
    idx = RNG.integers(-2, 12, (3, 7))
    np.testing.assert_array_equal(
        tgl.take_rows(t(table), t(idx)).numpy(), np.asarray(jgl.take_rows(table, idx))
    )
    np.testing.assert_array_equal(
        tgl.take_vec(t(table[..., 0]), t(idx)).numpy(), np.asarray(jgl.take_vec(table[..., 0], idx))
    )
    k = np.array([0, 3, 10])
    for ours, theirs in (
        (tgl.shift_left, jgl.shift_left),
        (tgl.shift_right, jgl.shift_right),
        (tgl.circular_roll, jgl.circular_roll),
    ):
        np.testing.assert_array_equal(
            ours(t(table), t(k)).numpy(), np.asarray(jax.vmap(theirs)(table, k))
        )
    start = np.array([-4, 2, 8])
    for fill in (0.0, -1.0):
        np.testing.assert_array_equal(
            tgl.window(t(table), t(start), 5, fill).numpy(),
            np.asarray(jax.vmap(lambda a, s: jgl.window(a, s, 5, fill))(table, start)),
        )
    slots = RNG.integers(0, 4, (3, 10))
    vals = RNG.normal(0, 1, (3, 10, 4, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        tgl.select_slot(t(vals), t(slots)).numpy(), np.asarray(jgl.select_slot(vals, slots))
    )


def test_curvature_and_filter():
    p = 64
    s = np.linspace(0, 20, p)
    path = np.stack([s, 4 * np.sin(s / 5)], -1).astype(np.float32)
    paths = np.stack([path, path[::-1].copy()])
    n_valid = np.array([60, 41])
    window = np.array([11, 7])
    ours = tcurv.path_curvature(t(paths), t(n_valid), t(window), 31)
    theirs = jax.vmap(lambda a, n, w: jcurv.path_curvature(a, n, w, 31))(paths, n_valid, window)
    close(ours, theirs, atol=1e-4)
    size = np.array([5, 4])
    ours_f = tcurv.uniform_filter1d_nearest(ours, t(n_valid), t(size), 31)
    theirs_f = jax.vmap(lambda v, n, z: jcurv.uniform_filter1d_nearest(v, n, z, 31))(
        np.asarray(theirs), n_valid, size
    )
    close(ours_f, theirs_f, atol=1e-4)
