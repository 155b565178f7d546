"""The port's plan server against the JAX package's, on the CPU.

* `_build_config` equals the JAX package's field by field, for the
  defaults and two sets of overrides.
* A real `PlanServer` on 127.0.0.1, port 0, on the CPU answers `/` (the
  page), `/scenarios` (the eight fixtures and the knobs, as the JAX server
  has them), `/plan` on two scenarios in one request (paths within 1 cm of
  the JAX package's `_plan` on the same payload), a malformed request (500
  with the error) and then a good one again (200), and a second request to
  the same config that carries the planner's state on.
* Without a GPU the server refuses to start unless given the CPU.
"""

import dataclasses
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from ft_fsd_path_planning_tpu.demo import serve as jserve
from ft_fsd_path_planning_torch.demo import serve
from ft_fsd_path_planning_torch.ops import beam_search
from tests.torch_parity import path_parity_deviation

torch.set_num_threads(1)

LATERAL_TOL = 0.01
OVERRIDES = [
    {},
    {"mission": "skidpad", "n_cones": 64, "beam_width": 16, "smoothing": 0.5},
    {
        "max_length": 10, "max_dist": 5.5, "threshold_directional_angle_deg": 35.0,
        "threshold_absolute_angle_deg": 70.0, "mpc_path_length": 15.0,
        "experimental_performance_improvements": True, "mission": "acceleration",
    },
]


def _fields(cfg, prefix=""):
    out = {}
    for f in dataclasses.fields(cfg):
        value = getattr(cfg, f.name)
        if dataclasses.is_dataclass(value):
            out.update(_fields(value, f"{prefix}{f.name}."))
        else:
            out[prefix + f.name] = getattr(value, "name", value)
    return out


@pytest.mark.parametrize("overrides", OVERRIDES)
def test_build_config_equals_jax(overrides):
    ours = _fields(serve._build_config(overrides))
    theirs = _fields(jserve._build_config(overrides))
    assert ours == theirs
    assert ours["shapes.config_len"] == overrides.get("max_length", 12)


@pytest.fixture(scope="module")
def server():
    srv = serve.PlanServer(("127.0.0.1", 0), device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}", srv
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def _get(url):
    with urllib.request.urlopen(url, timeout=120) as r:
        return r.status, r.read()


def _post(url, body: bytes):
    req = urllib.request.Request(url + "/plan", data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def test_page_and_scenarios(server):
    url, _ = server
    status, page = _get(url + "/")
    assert status == 200 and b"/plan" in page and b"<html" in page
    status, body = _get(url + "/scenarios")
    data = json.loads(body)
    assert status == 200
    theirs = jserve._scenario_payload()
    assert list(data["scenarios"]) == list(theirs) and len(theirs) == 8
    assert data["scenarios"] == json.loads(json.dumps(theirs))
    assert data["knobs"].keys() == jserve._KNOBS.keys()
    assert {k: v[0] for k, v in data["knobs"].items()} == {k: v[0] for k, v in jserve._KNOBS.items()}
    with pytest.raises(urllib.error.HTTPError):
        _get(url + "/nowhere")


def test_plan_matches_jax_and_recovers_from_a_bad_request(server):
    url, srv = server
    scen = jserve._scenario_payload()
    payload = {"config": {"beam_width": 24}, "frames": [scen["hairpin"], scen["noisy_corner"]]}
    status, ours = _post(url, json.dumps(payload).encode())
    assert status == 200, ours
    theirs = jserve._plan(json.loads(json.dumps(payload)))
    assert len(ours["paths"]) == len(theirs["paths"]) == 2
    for path, jpath in zip(ours["paths"], theirs["paths"]):
        path = np.asarray(path)
        assert path.shape == (40, 4) and np.isfinite(path).all()
        assert path_parity_deviation(np.asarray(jpath), path) < LATERAL_TOL
    assert [len(i["sorted_left"]) for i in ours["intermediates"]] == [
        len(i["sorted_left"]) for i in theirs["intermediates"]
    ]
    assert ours["timing_ms"] > 0

    status, err = _post(url, b'{"frames": [{"car_position": [0.0, 0.0]}]}')
    assert status == 500 and "slam_cones" in err["error"]
    status, err = _post(url, b"not json")
    assert status == 500 and "error" in err
    # one planner per config (the malformed request made the default config's)
    planners = dict(srv.planners)
    assert sorted(cfg.sorting.beam_width for cfg, _ in planners) == [24, 32]
    status, again = _post(url, json.dumps({"config": {"beam_width": 24}, "frames": [scen["straight"]]}).encode())
    assert status == 200 and np.isfinite(np.asarray(again["paths"])).all()
    assert srv.planners == planners  # the same planner, its state carried on
    assert all(dev == torch.device("cpu") and p.device == dev for (_, dev), p in planners.items())


def test_beam_width_16_through_the_kernels_plain_version(monkeypatch):
    """The plan server's beam-width knob at 16, the kernel's second
    instantiation: B2's plain version (what the kernel is held against on
    the card) gives the sorter's scan's paths and sorted sides."""
    frames = [jserve._scenario_payload()[n] for n in ("hairpin_extreme", "corner_missing_blue")]
    payload = {"config": {"beam_width": 16}, "frames": frames}
    monkeypatch.setenv("FT_FSD_FUSED_BEAM", "1")
    fused = serve._plan(payload, {}, torch.device("cpu"))
    monkeypatch.setenv("FT_FSD_FUSED_BEAM", "0")
    scan = serve._plan(payload, {}, torch.device("cpu"))
    assert fused["paths"] == scan["paths"]
    assert [i["sorted_left"] for i in fused["intermediates"]] == [i["sorted_left"] for i in scan["intermediates"]]
    assert beam_search.kernel_supports(16, 12, 5)


def test_server_refuses_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.PlanServer(("127.0.0.1", 0))
