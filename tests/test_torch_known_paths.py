"""The port's own copy of the known mission paths and of the relocalizers'
static tables against the JAX package's: equal bit for bit (they are numpy
constants built from seeds, no arithmetic of either framework).
"""

import numpy as np
import pytest
import torch

from ft_fsd_path_planning_tpu.assets import known_paths as jpaths
from ft_fsd_path_planning_tpu.config import ShapeBudget as JShapeBudget
from ft_fsd_path_planning_tpu.config import large_map_config as jax_large_map_config
from ft_fsd_path_planning_tpu.models import planner as jplanner
from ft_fsd_path_planning_tpu.models import relocalization as jreloc
from ft_fsd_path_planning_tpu.utils.mission_types import MissionTypes as JMissionTypes
from ft_fsd_path_planning_torch.assets import known_paths as tpaths
from ft_fsd_path_planning_torch.config import ShapeBudget, default_config, large_map_config
from ft_fsd_path_planning_torch.models import planner as tplanner
from ft_fsd_path_planning_torch.models import relocalization as treloc
from ft_fsd_path_planning_torch.utils.mission_types import MissionTypes

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["BASE_SKIDPAD_PATH", "BASE_ACCELERATION_PATH"])
def test_known_paths_equal_bit_for_bit(name):
    ours, theirs = getattr(tpaths, name), getattr(jpaths, name)
    assert ours.dtype == theirs.dtype == np.float64
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(tpaths.generate_skidpad_path(), jpaths.BASE_SKIDPAD_PATH)
    assert tpaths._LAPS == jpaths._LAPS


def test_relocalizer_tables_equal():
    np.testing.assert_array_equal(treloc._subset_table(), jreloc._SUBSETS)
    assert treloc._subset_table().shape == (1140, 3)
    noise = treloc._noise_tables()
    assert noise.shape == (21, 1140, 3, 2) and noise.dtype == np.float32
    np.testing.assert_array_equal(noise, jreloc._NOISE_TABLES)
    np.testing.assert_array_equal(treloc._ransac_u(), jreloc._RANSAC_U)
    np.testing.assert_array_equal(treloc._reference_centers(), jreloc._reference_centers())
    assert treloc._reference_centers().dtype == np.float64


def test_device_constants_are_cached_per_device_and_dtype():
    cpu = torch.device("cpu")
    subsets, noise32, centers32 = treloc._skidpad_constants(cpu, torch.float32)
    assert treloc._skidpad_constants(cpu, torch.float32)[1] is noise32
    _, noise64, centers64 = treloc._skidpad_constants(cpu, torch.float64)
    assert noise64.dtype == centers64.dtype == torch.float64 and subsets.dtype == torch.int64
    # the float64 tables carry the float32 table's values, not new draws
    np.testing.assert_array_equal(noise64.numpy(), treloc._noise_tables().astype(np.float64))
    np.testing.assert_array_equal(centers64.numpy(), treloc._reference_centers())
    np.testing.assert_array_equal(centers32.numpy(), treloc._reference_centers().astype(np.float32))


@pytest.mark.parametrize("mission", ["skidpad", "acceleration", "ebs_test"])
def test_known_global_path_buffer_matches_jax(mission):
    from ft_fsd_path_planning_tpu.config import default_config as jax_config

    theirs = jplanner._known_global_path(jax_config(getattr(JMissionTypes, mission)))
    active = torch.tensor([True, False, True])
    ours = tplanner._known_global_path(default_config(getattr(MissionTypes, mission)), active)
    assert ours.points.shape == (3, tplanner.GLOBAL_PATH_BUFFER_LEN, 2)
    for lane in range(3):
        np.testing.assert_array_equal(ours.points[lane].numpy(), np.asarray(theirs.points))
    assert ours.n_valid.tolist() == [int(theirs.n_valid)] * 3
    assert ours.active.tolist() == [True, False, True]


def test_config_presets_and_range_check_match_jax():
    ours, theirs = large_map_config(MissionTypes.acceleration), jax_large_map_config(JMissionTypes.acceleration)
    assert ours.shapes.n_cones == theirs.shapes.n_cones == 256
    assert (ours.shapes.global_window, ours.shapes.dense_samples) == (704, 1024)
    assert (theirs.shapes.global_window, theirs.shapes.dense_samples) == (704, 1024)
    assert ours.supports_global_path and theirs.supports_global_path
    for budget in (ShapeBudget, JShapeBudget):
        for bad in (0, -1, 2**24):
            with pytest.raises(ValueError, match="outside"):
                budget(n_cones=bad)
        with pytest.raises(ValueError, match="global_window"):
            budget(global_window=0)
