"""The port's multi-process data parallelism against one process and the
JAX package, on the CPU.

Two gloo processes (`ft_fsd_path_planning_torch.parallel.worker`, one
torch thread each) solve a global batch of 8 seeded frames, each feeding
only its own rows, at the tiny configuration of the JAX package's
distributed test (`__graft_entry__._tiny_config`: beam width 8, max length
8, 32 cones) and at the default one (n_cones = 128), as
`tests/test_distributed.py` and `tests/test_multichip.py::
test_sharded_equals_single_device` do for the JAX package. Tolerances:
* stitched paths laterally under 1 cm from a single-process `batched_step`
  and, at the tiny configuration, from the JAX package's `batched_step` on
  the same frames (`tests/torch_parity.py`: float reassociation can move the
  20 m trim by one tail sample);
* the reduced metrics equal on both ranks, bit for bit (one all_reduce);
  the mean path length within 0.1 m of the single process's (a flipped tail
  sample moves a frame's length by 0.165 m).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax

import __graft_entry__
from ft_fsd_path_planning_tpu.models.planner import FrameInput as JFrameInput
from ft_fsd_path_planning_tpu.parallel import batch as jbatch
from ft_fsd_path_planning_torch.config import default_config
from ft_fsd_path_planning_torch.models.planner import FrameInput
from ft_fsd_path_planning_torch.parallel import batch as tbatch
from ft_fsd_path_planning_torch.parallel import distributed, dryrun, worker
from ft_fsd_path_planning_torch.parallel.scenarios import make_frame_batch, make_frame_batch_numpy
from tests.torch_parity import path_parity_deviation

torch.set_num_threads(1)

GLOBAL_BATCH = 8
LATERAL_TOL = 0.01
CONFIGS = {"tiny": dryrun.tiny_config, "default": lambda: default_config(n_cones=128)}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Run the two ranks once; returns (output dir, both ranks' reports)."""
    out = tmp_path_factory.mktemp("ranks")
    worker.spawn("step", 2, device="cpu", timeout=300, out=str(out), config="tiny,default",
                 global_batch=GLOBAL_BATCH)
    reports = [json.loads((out / f"rank_{r}.json").read_text()) for r in (0, 1)]
    return out, reports


def _stitched(out: Path, name: str) -> np.ndarray:
    return np.concatenate([np.load(out / f"paths_{name}_{r}.npy") for r in (0, 1)])


def _single(name: str):
    cfg = CONFIGS[name]()
    frames = make_frame_batch(cfg, GLOBAL_BATCH, seed=0, device="cpu")
    outs, _ = tbatch.batched_step(cfg, tbatch.make_batch_state(cfg, GLOBAL_BATCH, "cpu"), frames)
    return outs, tbatch.batch_metrics(outs)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_two_processes_match_one(two_ranks, name):
    out, reports = two_ranks
    paths = _stitched(out, name)
    assert paths.shape == (GLOBAL_BATCH, 40, 4) and np.isfinite(paths).all()
    outs, metrics = _single(name)
    devs = [path_parity_deviation(outs.path[b].numpy(), paths[b]) for b in range(GLOBAL_BATCH)]
    assert max(devs) < LATERAL_TOL, devs
    got = [r["configs"][name]["metrics"] for r in reports]
    assert got[0] == got[1]  # one all_reduce: the same numbers on every rank
    assert got[0]["n_frames"] == GLOBAL_BATCH
    assert got[0]["mean_path_length"] == pytest.approx(float(metrics.mean_path_length), abs=0.1)
    assert got[0]["solve_success_rate"] == pytest.approx(float(metrics.solve_success_rate))
    assert got[0]["relocalized_rate"] == 0.0  # trackdrive has no relocalizer
    # per-rank slicing covered the whole batch exactly once; the CPU launches no kernel
    assert sorted((r["configs"][name]["lo"], r["configs"][name]["hi"]) for r in reports) == [(0, 4), (4, 8)]
    assert all(r["configs"][name]["launches"]["B1"] == r["configs"][name]["launches"]["B2"] == 0 for r in reports)


def test_two_processes_match_jax_at_the_tiny_config(two_ranks):
    out, _ = two_ranks
    paths = _stitched(out, "tiny")
    jcfg = __graft_entry__._tiny_config()
    arrays = make_frame_batch_numpy(dryrun.tiny_config(), GLOBAL_BATCH, seed=0)
    theirs, _ = jax.jit(lambda s, f: jbatch.batched_step(jcfg, s, f))(
        jbatch.make_batch_state(jcfg, GLOBAL_BATCH), JFrameInput(*arrays)
    )
    theirs = np.asarray(theirs.path)
    devs = [path_parity_deviation(theirs[b], paths[b]) for b in range(GLOBAL_BATCH)]
    assert max(devs) < LATERAL_TOL, devs


def test_ranks_refuse_an_uneven_batch(two_ranks):
    _, reports = two_ranks
    for r in reports:
        assert r["uneven_error"] == (
            f"global_batch={GLOBAL_BATCH - 1} must divide evenly over 2 processes (pad the batch to a multiple)"
        )


def test_tiny_config_mirrors_jax():
    mine, theirs = dryrun.tiny_config(), __graft_entry__._tiny_config()
    assert (mine.sorting.beam_width, mine.sorting.max_length) == (theirs.sorting.beam_width, theirs.sorting.max_length)
    for field in ("n_cones", "config_len", "side_len", "dense_samples", "curvature_window", "global_window"):
        assert getattr(mine.shapes, field) == getattr(theirs.shapes, field), field


def test_host_local_slice_single_process():
    assert not dist.is_initialized()
    assert distributed.host_local_slice(GLOBAL_BATCH) == (0, GLOBAL_BATCH)
    assert distributed.host_local_slice(7) == (0, 7)  # one process takes any batch


def test_host_local_slice_by_rank(monkeypatch):
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    assert distributed.host_local_slice(GLOBAL_BATCH) == (4, 8)
    with pytest.raises(ValueError, match="must divide evenly over 2 processes"):
        distributed.host_local_slice(7)


def test_sharded_step_without_group_is_batched_step():
    """One process, no group: the sharded step is `batched_step` with the
    metrics as sum / count, and a mesh must match the process count."""
    cfg = default_config(n_cones=128)
    mesh = distributed.global_mesh(device="cpu")
    assert mesh.group is None and (mesh.size, mesh.rank) == (1, 0) and mesh.device == torch.device("cpu")
    with pytest.raises(ValueError, match="needs 2 processes"):
        tbatch.make_mesh(2, device="cpu")
    states = distributed.make_global_state(cfg, mesh, GLOBAL_BATCH)
    arrays = FrameInput(*make_frame_batch_numpy(cfg, GLOBAL_BATCH, seed=0))
    frames = distributed.make_global_batch(mesh, arrays, GLOBAL_BATCH)
    outs, new_states, metrics = tbatch.sharded_batched_step(cfg, mesh)(states, frames)
    want, metrics_want = _single("default")
    assert torch.equal(outs.path, want.path)
    for got, ref in zip(metrics, metrics_want):
        assert float(got) == pytest.approx(float(ref), rel=1e-6)
    assert new_states.path.prev_path.shape == (GLOBAL_BATCH, 40, 4)
    with pytest.raises(ValueError, match="add up to 8, not global_batch=16"):
        distributed.make_global_batch(mesh, arrays, 16)


def test_shard_batch_keeps_this_ranks_rows(monkeypatch):
    cfg = default_config(n_cones=128)
    frames = make_frame_batch(cfg, GLOBAL_BATCH, seed=0, device="cpu")
    mesh = tbatch.Mesh(group="two ranks", device=torch.device("cpu"))
    monkeypatch.setattr(dist, "get_world_size", lambda group: 2)
    monkeypatch.setattr(dist, "get_rank", lambda group: 1)
    mine = tbatch.shard_batch(mesh, frames)
    for got, full in zip(mine, frames):
        assert torch.equal(got, full[4:])
    state = tbatch.shard_batch(mesh, tbatch.make_batch_state(cfg, GLOBAL_BATCH, "cpu"))
    assert state.path.prev_path.shape[0] == 4 and state.reloc.relocalized.shape == (4,)
    with pytest.raises(ValueError, match="must divide evenly"):
        tbatch.shard_batch(mesh, make_frame_batch(cfg, 7, seed=0, device="cpu"))


def test_dryrun_multichip_two_processes(capsys):
    line = dryrun.dryrun_multichip(2, device="cpu", timeout=300)
    assert line.startswith("dryrun_multichip ok: 2 devices, batch 4, mean path length")
    assert line in capsys.readouterr().out


def test_entry_points_refuse_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from ft_fsd_path_planning_torch import scaling_bench

    with pytest.raises(RuntimeError, match="device='cpu'"):
        distributed.global_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        distributed.initialize_distributed("tcp://localhost:1", 1, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        scaling_bench.main([])
    assert not dist.is_initialized()
