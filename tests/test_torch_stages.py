"""The three pipeline stages of the port against the JAX package, each on
the same inputs: sorting on `make_frame_batch(seed)` frames (B = 8,
n_cones = 64), matching on the JAX sorter's output, pathing on the JAX
matcher's output and the JAX initial state.

Tolerances: sorted orders, masks and match indices must be equal; cone
positions agree to 1e-5 m (the same float32 arithmetic); paths agree
laterally to 1 cm over their common span (the fits run different but
equally accurate solvers, see test_torch_fitpack.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ft_fsd_path_planning_tpu.config import default_config as jax_config
from ft_fsd_path_planning_tpu.models import matching as jm
from ft_fsd_path_planning_tpu.models import pathing as jp
from ft_fsd_path_planning_tpu.models import sorting as js
from ft_fsd_path_planning_tpu.models.planner import make_initial_state
from ft_fsd_path_planning_tpu.parallel import scenarios as jscen
from ft_fsd_path_planning_torch.config import default_config as torch_config
from ft_fsd_path_planning_torch.models import matching as tm
from ft_fsd_path_planning_torch.models import pathing as tp
from ft_fsd_path_planning_torch.models import sorting as ts
from ft_fsd_path_planning_torch.models.planner import _pad_side
from ft_fsd_path_planning_torch.parallel import scenarios as tscen
from tests.torch_parity import path_parity_deviation

# the port's ops are small tensors: one intra-op thread is as fast here and
# leaves the cores to the other test workers
torch.set_num_threads(1)

B, N = 8, 64
JCFG = jax_config(n_cones=N)
TCFG = torch_config(n_cones=N)


def t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def frames():
    return jscen.make_frame_batch(JCFG, B, seed=3)


@pytest.fixture(scope="module")
def jax_sorted(frames):
    run = jax.jit(jax.vmap(lambda c, m, p, d: js.run_cone_sorting(JCFG, c, m, p, d)))
    out = run(frames.cones, frames.mask, frames.position, frames.direction)
    return jax.tree.map(np.asarray, out)


@pytest.fixture(scope="module")
def matching_input(frames, jax_sorted):
    s = JCFG.shapes.side_len
    pad = lambda a, m: _pad_side(t(a), t(m), s)  # noqa: E731
    ml, mlm = pad(jax_sorted.left_cones, jax_sorted.left_mask)
    mr, mrm = pad(jax_sorted.right_cones, jax_sorted.right_mask)
    return tm.MatchingInput(ml, mlm, mr, mrm, t(frames.position), t(frames.direction))


@pytest.fixture(scope="module")
def jax_matched(matching_input):
    run = jax.jit(jax.vmap(lambda *a: jm.run_cone_matching(JCFG, jm.MatchingInput(*a))))
    return jax.tree.map(np.asarray, run(*(x.numpy() for x in matching_input)))


def test_make_frame_batch_is_the_same_data(frames):
    ours = tscen.make_frame_batch(TCFG, B, seed=3, device="cpu")
    for a, b in zip(ours, frames):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_sorting_matches(frames, jax_sorted):
    ours = ts.run_cone_sorting(
        TCFG, t(frames.cones), t(frames.mask), t(frames.position), t(frames.direction)
    )
    for name in ("left_mask", "right_mask"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(), getattr(jax_sorted, name))
    for name in ("left_cones", "right_cones"):
        np.testing.assert_allclose(getattr(ours, name).numpy(), getattr(jax_sorted, name), atol=1e-5)
    assert jax_sorted.left_mask.sum() > 3 * B and jax_sorted.right_mask.sum() > 3 * B


def test_matching_matches(matching_input, jax_matched):
    ours = tm.run_cone_matching(TCFG, matching_input)
    for name in ours._fields:
        a, b = getattr(ours, name).numpy(), getattr(jax_matched, name)
        if a.dtype == np.float32:
            np.testing.assert_allclose(a, b, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_pathing_matches(matching_input, jax_matched):
    state = make_initial_state(JCFG)
    prev = np.broadcast_to(np.asarray(state.path.prev_path), (B,) + state.path.prev_path.shape)
    inp = (
        jax_matched.left_cones, jax_matched.left_mask,
        jax_matched.right_cones, jax_matched.right_mask,
        jax_matched.left_to_right, jax_matched.right_to_left,
        matching_input.position.numpy(), matching_input.direction.numpy(),
    )
    run = jax.jit(jax.vmap(
        lambda pp, *a: jp.run_path_calculation(
            JCFG, jp.PathInput(*a), jp.GlobalPathBuffer.empty(8),
            jp.PathState(pp, jnp.asarray(0, jnp.int32)),
        )
    ))
    theirs = jax.tree.map(np.asarray, run(prev, *inp))
    ours = tp.run_path_calculation(
        TCFG,
        tp.PathInput(*(t(a) for a in inp)),
        tp.GlobalPathBuffer.empty(B, 8, torch.device("cpu")),
        tp.PathState(t(prev), torch.zeros(B, dtype=torch.int32)),
    )
    np.testing.assert_array_equal(ours.ok.numpy(), theirs.ok)
    np.testing.assert_array_equal(ours.too_far.numpy(), theirs.too_far)
    np.testing.assert_array_equal(ours.centerline_mask.numpy(), theirs.centerline_mask)
    devs = [path_parity_deviation(theirs.path[b], ours.path[b].numpy()) for b in range(B)]
    assert max(devs) < 0.01, devs


def test_initial_path_state_matches():
    ours = tp.initial_path_state(TCFG, 2, torch.device("cpu"))
    theirs = np.asarray(make_initial_state(JCFG).path.prev_path)
    assert ours.prev_path.shape == (2,) + theirs.shape
    assert path_parity_deviation(theirs, ours.prev_path[1].numpy()) < 0.01
