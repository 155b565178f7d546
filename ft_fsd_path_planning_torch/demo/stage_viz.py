"""Per-stage pipeline visualization of one scenario: the data on the card,
the drawing on the host.

Counterpart of `ft_fsd_path_planning_tpu/demo/stage_viz.py` (the
reference's streamlit debug pages as a headless matplotlib renderer), split
in two:

* :func:`stage_data` runs the planner and the sorter's stages on a device
  (default ``cuda``) and returns numpy arrays: the cones, the k-NN adjacency
  of each side (sorting's search space), each side's beam-search pool with
  its costs, validity, winner and self-intersection counts, the matches with
  the virtual cones, and the MPC path;
* :func:`draw` renders them as one figure of four panels with matplotlib's
  Agg backend, imported there only (the machine with the card need not have
  matplotlib).

Usage:
    python -m ft_fsd_path_planning_torch.demo.stage_viz hairpin -o build/hairpin.png [--device cpu]
    python -m ft_fsd_path_planning_torch.demo.stage_viz --list
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ft_fsd_path_planning_torch.demo.scenarios import ALL_SCENARIOS
from ft_fsd_path_planning_torch.device import resolve_device
from ft_fsd_path_planning_torch.models import sorting
from ft_fsd_path_planning_torch.models.facade import PathPlanner, flatten_cones_by_type
from ft_fsd_path_planning_torch.ops import geometry as geo
from ft_fsd_path_planning_torch.utils.cone_types import ConeTypes
from ft_fsd_path_planning_torch.utils.mission_types import MissionTypes

SIDES = (ConeTypes.LEFT, ConeTypes.RIGHT)
_SIDE_COLOR = {ConeTypes.LEFT: "tab:blue", ConeTypes.RIGHT: "goldenrod"}


def stage_data(name: str, device: str | torch.device | None = None) -> dict:
    """The arrays the four panels draw for scenario ``name``, computed on
    ``device``: ``cones`` (the input lists by type), ``position``,
    ``direction``, ``xy`` (N, 2) flattened cones, ``adjacency`` {side: (E,
    2) edges i < j}, ``beam`` {side: configs (K, L), valid (K,), costs (K,),
    best (L,), self_crossings (K,)}, ``matches`` (left and right with their
    virtual cones, left-to-right and right-to-left indices), ``sorted_left``,
    ``sorted_right`` and ``path`` (40, 4)."""
    dev = resolve_device(device)
    cones, pos, direction = ALL_SCENARIOS[name]()
    planner = PathPlanner(MissionTypes.trackdrive, device=dev)
    path, sorted_l, sorted_r, left_v, right_v, l2r, r2l = planner.calculate_path_in_global_frame(
        cones, pos, direction, return_intermediate_results=True
    )

    cfg = planner.cfg
    pts, mask = flatten_cones_by_type(cones, cfg.shapes.n_cones)
    g = len(SIDES)
    points = torch.as_tensor(pts, device=dev)[None].expand(g, -1, -1)
    valid_mask = torch.as_tensor(mask, device=dev)[None].expand(g, -1)
    cone_type = torch.tensor([int(ct) for ct in SIDES], device=dev)
    position = torch.as_tensor(np.asarray(pos, np.float32), device=dev)[None].expand(g, -1)
    heading = torch.as_tensor(np.asarray(direction, np.float32), device=dev)[None].expand(g, -1)

    # both sides as one batch of G = 2 searches, as the planner runs them
    prefix, _ = sorting.select_starting_cones(cfg.sorting, points, valid_mask, cone_type, position, heading)
    adj, _, _ = sorting.build_adjacency(cfg.sorting, points, valid_mask, cone_type, prefix[:, 0])
    res = sorting.sort_one_side(cfg, points, valid_mask, cone_type, position, heading)
    xy = points[:, :, :2]
    configs = res.configs
    cfg_pts = torch.take_along_dim(
        xy[:, None], configs.clamp(0, xy.shape[1] - 1)[..., None], dim=2
    )  # (G, K, L, 2)
    crossings = geo.polyline_self_intersections(cfg_pts, (configs >= 0) & res.valid[..., None])

    adj, configs, valid, costs, best, crossings = (
        t.cpu().numpy() for t in (adj, configs, res.valid, res.costs, res.best, crossings)
    )
    return {
        "name": name,
        "cones": [np.asarray(c, float).reshape(-1, 2) for c in cones],
        "position": np.asarray(pos, float),
        "direction": np.asarray(direction, float),
        "xy": pts[:, :2],
        "adjacency": {ct: np.argwhere(np.triu(adj[i])) for i, ct in enumerate(SIDES)},
        "beam": {
            ct: {"configs": configs[i], "valid": valid[i], "costs": costs[i], "best": best[i],
                 "self_crossings": crossings[i]}
            for i, ct in enumerate(SIDES)
        },
        "matches": {"left": left_v, "right": right_v, "left_to_right": l2r, "right_to_left": r2l},
        "sorted_left": sorted_l,
        "sorted_right": sorted_r,
        "path": path,
    }


def draw(data: dict, out_path: str) -> None:
    """Render ``stage_data``'s arrays as one PNG of four panels: the
    adjacency, the beam search's winners and pool, the matching, the path
    coloured by curvature."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pos, direction, xy = data["position"], data["direction"], data["xy"]
    fig, axes = plt.subplots(2, 2, figsize=(15, 13))
    for ax in axes.ravel():
        ax.set_aspect("equal")
        for ct in (ConeTypes.LEFT, ConeTypes.RIGHT, ConeTypes.UNKNOWN):
            arr = data["cones"][ct]
            if len(arr):
                ax.plot(arr[:, 0], arr[:, 1], ".", color=_SIDE_COLOR.get(ct, "gray"), ms=8)
        ax.plot([pos[0]], [pos[1]], "ks", ms=9)
        ax.annotate("", xy=pos[:2] + direction[:2] * 2.5, xytext=pos[:2],
                    arrowprops=dict(arrowstyle="->", color="k"))

    ax = axes[0, 0]
    ax.set_title("1. k-NN adjacency (sorting search space)")
    for ct in SIDES:
        for i, j in data["adjacency"][ct]:
            ax.plot(xy[[i, j], 0], xy[[i, j], 1], "-", color=_SIDE_COLOR[ct], lw=0.6, alpha=0.5)

    ax = axes[0, 1]
    ax.set_title("2. beam search: winners + pool")
    info = []
    for ct in SIDES:
        beam = data["beam"][ct]
        order = np.argsort(beam["costs"])
        for k in order[1:6]:  # runner-up configs, faint
            if beam["valid"][k]:
                seq = beam["configs"][k][beam["configs"][k] >= 0]
                ax.plot(xy[seq, 0], xy[seq, 1], "--", color=_SIDE_COLOR[ct], lw=0.8, alpha=0.35)
        seq = beam["best"][beam["best"] >= 0]
        if len(seq):
            ax.plot(xy[seq, 0], xy[seq, 1], "-", color=_SIDE_COLOR[ct], lw=2.2)
        info.append(
            f"{ConeTypes(ct).name}: pool={int(beam['valid'].sum())}  best cost={beam['costs'][order[0]]:.3f}  "
            f"self-crossings(best)={beam['self_crossings'][order[0]]}"
        )
    ax.text(0.02, 0.02, "\n".join(info), transform=ax.transAxes, fontsize=9, va="bottom",
            bbox=dict(boxstyle="round", fc="w", alpha=0.8))

    ax = axes[1, 0]
    ax.set_title("3. matching: pairs + virtual cones")
    m = data["matches"]
    for side_pts, matches, other_pts, color in (
        (m["left"], m["left_to_right"], m["right"], "tab:blue"),
        (m["right"], m["right_to_left"], m["left"], "goldenrod"),
    ):
        if len(side_pts):
            ax.plot(side_pts[:, 0], side_pts[:, 1], "o", mfc="none", color=color, ms=10)
        for i, j in enumerate(np.asarray(matches)):
            if j >= 0 and i < len(side_pts) and j < len(other_pts):
                ax.plot([side_pts[i, 0], other_pts[j, 0]], [side_pts[i, 1], other_pts[j, 1]],
                        "-", color="gray", lw=0.7, alpha=0.6)

    ax = axes[1, 1]
    ax.set_title("4. MPC path (colored by curvature)")
    path = data["path"]
    sc = ax.scatter(path[:, 1], path[:, 2], c=path[:, 3], cmap="coolwarm", s=22, vmin=-0.2, vmax=0.2)
    fig.colorbar(sc, ax=ax, label="curvature [1/m]", shrink=0.8)
    for key, color in (("sorted_left", "tab:blue"), ("sorted_right", "goldenrod")):
        if len(data[key]):
            ax.plot(data[key][:, 0], data[key][:, 1], "-", color=color, lw=1, alpha=0.5)

    fig.suptitle(f"scenario: {data['name']}", fontsize=14)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    print(f"saved {out_path}")


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("scenario", nargs="?", default="simple_corner")
    parser.add_argument("-o", "--output", default="stage_viz.png")
    parser.add_argument("--list", action="store_true")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.list:
        print("\n".join(sorted(ALL_SCENARIOS)))
        return
    draw(stage_data(args.scenario, args.device), args.output)


if __name__ == "__main__":
    main()
