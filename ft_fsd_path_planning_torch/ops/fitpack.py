"""FITPACK smoothing-spline emulation (fpcurf/fppara), batched in PyTorch.

Counterpart of `ft_fsd_path_planning_tpu/ops/fitpack.py`, which describes the
algorithm: part 1 grows an adaptive knot set until the least-squares
spline's SSR drops to the smoothing budget ``s``; part 2 finds FITPACK's
Lagrange parameter ``p`` with the rational root iteration. Every function
here takes a leading batch axis of independent traces.

:func:`fitpack_fit` solves part 1's iteration 0, the least-squares
polynomial on the empty knot set, eagerly (kernel B1 through
``ops/spline.py::_solve_spd_banded``) and hands the rest to
:func:`fitpack_parts12`: on a CPU tensor its plain version
:func:`fitpack_parts12_plain`, on a CUDA tensor one launch of the
hand-written kernel `csrc/fitpack_part2.cu`, in which every lane runs the
knot insertions, part 1's least-squares solves, part 2 and the tiny-input
closed form to its own end on the card, with no host sync.

In the plain version the three JAX ``lax.while_loop``s (part-1 outer
iterations, knot insertions, part-2 p-iteration) become Python loops over an
``active`` mask: each trip computes every lane and keeps the new carry only
on lanes whose own condition holds, which is what the vmapped while loop
does, and the loop ends when no lane is active (one host sync per trip).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ft_fsd_path_planning_torch.ops import kernel_build
from ft_fsd_path_planning_torch.ops.spline import _solve_spd_banded, chord_lengths
from ft_fsd_path_planning_torch.utils import timer

Tensor = torch.Tensor

K = 3  # cubic splines
MAX_INT = 24  # interior-knot budget
NC = MAX_INT + K + 1  # B-spline coefficient budget (28)
NEST = MAX_INT + 2 * (K + 1)  # padded full knot-vector length (32)
NI = MAX_INT + 1  # knot-interval budget

OUTER = 16  # part-1 outer iterations
NPLUS_MAX = 8  # knot insertions per outer iteration
MAXIT = 20  # part-2 iterations (FITPACK's maxit)
TOL = 1e-3  # FITPACK's tol: acc = tol * s

_CON1, _CON4, _CON9 = 0.1, 0.04, 0.9  # fprati constants (fpcurf.f:27)
_BIG = 3.0e38
_EPS_DIAG = 1e-6

#: host syncs spent on loop conditions since the last reset (one per trip
#: check of each masked loop)
loop_syncs = 0
#: launches of the fit kernel since the last reset, as the counter
#: ``fitpack.part2.launches`` counts them: each runs part 2 of its fits (plain
#: calls do not count)
part2_launch_count = 0
#: the most sites a fit may have for the kernel (``kMaxSites``)
PART2_MAX_SITES = 4096


def _any(active: Tensor, trips: str) -> bool:
    """Whether any lane is active: one host sync, counted in ``loop_syncs``
    and in the loop's own counter ``trips``."""
    global loop_syncs
    loop_syncs += 1
    timer.count(trips)
    return bool(active.any())


def _f32_to_i32(x: Tensor) -> Tensor:
    """float32 -> int32 truncation that saturates like XLA's convert (NaN -> 0)."""
    x = torch.nan_to_num(x, nan=0.0, posinf=2147483520.0, neginf=-2147483648.0)
    return torch.clamp(x, -2147483648.0, 2147483520.0).to(torch.int32)


def _sel(cond: Tensor, new: Tensor, old: Tensor) -> Tensor:
    """where(cond, new, old) with cond (B,) broadcast over trailing axes."""
    return torch.where(cond.reshape(cond.shape + (1,) * (new.dim() - 1)), new, old)


class FpSpline(NamedTuple):
    """Fitted FITPACK-style splines with adaptive (padded) knot vectors."""

    t_int: Tensor  # (B, MAX_INT) interior knots, ascending; pad = +_BIG
    n_int: Tensor  # (B,) int32 live interior-knot count
    coef: Tensor  # (B, NC, 2) B-spline coefficients (pad rows zero)
    u_max: Tensor  # (B,) chord length of the data
    ok: Tensor  # (B,) bool; False mirrors the reference's splprep ValueError
    budget_hit: Tensor  # (B,) part 1 exited on the MAX_INT/OUTER budget


# ---------------------------------------------------------------------------
# basis evaluation on an arbitrary clamped knot vector
# ---------------------------------------------------------------------------


def _full_knots(t_int: Tensor, n_int: Tensor, u_max: Tensor) -> Tensor:
    """(B, NEST) clamped vectors [0*4 | t_int | u_max * rest]."""
    j = torch.arange(MAX_INT, device=t_int.device)
    interior = torch.where(j[None, :] < n_int[:, None], t_int, u_max[:, None])
    b = t_int.shape[0]
    return torch.cat(
        [
            torch.zeros((b, K + 1), dtype=t_int.dtype, device=t_int.device),
            interior,
            torch.ones((b, K + 1), dtype=t_int.dtype, device=t_int.device) * u_max[:, None],
        ],
        dim=1,
    )


def _basis4(x: Tensor, t_full: Tensor, n_int: Tensor) -> tuple[Tensor, Tensor]:
    """Nonzero cubic B-spline basis values at each site.

    x (B, M) -> (values (B, M, 4), span (B, M) int) with span the knot
    interval index in [K, K + n_int]; sites past u_max keep the last span
    (FITPACK ``splev`` extrapolation, ext=0). A site equal to an interior
    knot belongs to the interval on its right.
    """
    j = torch.arange(MAX_INT, device=x.device)
    t_int = t_full[:, K + 1 : K + 1 + MAX_INT]
    live = j[None, None, :] < n_int[:, None, None]
    span = K + torch.sum(live & (x[:, :, None] >= t_int[:, None, :]), dim=2)

    # knots t[span-2 .. span+3]; span + 3 <= K + MAX_INT + 3 < NEST
    offs = torch.arange(-K + 1, K + 1, device=x.device)
    idx = span[:, :, None] + offs
    twin = torch.take_along_dim(t_full[:, None, :], idx, dim=2)  # (B, M, 6)

    # de Boor basis_funs (The NURBS Book A2.2), degree 3
    vals = [torch.ones_like(x)]
    for deg in range(1, K + 1):
        saved = torch.zeros_like(x)
        new_vals = []
        for r in range(deg):
            rt = twin[:, :, K - 1 + (r + 1)] - x
            lf = x - twin[:, :, K - (deg - r)]
            denom = rt + lf
            denom = torch.where(torch.abs(denom) > 1e-30, denom, torch.ones_like(denom))
            tmp = vals[r] / denom
            new_vals.append(saved + rt * tmp)
            saved = lf * tmp
        new_vals.append(saved)
        vals = new_vals
    return torch.stack(vals, dim=-1), span


def _design(x: Tensor, mask: Tensor, t_full: Tensor, n_int: Tensor) -> Tensor:
    """(B, M, NC) masked design matrices (zero rows for padded sites):
    column span - K + r holds basis value r."""
    vals, span = _basis4(x, t_full, n_int)
    cols = span[:, :, None] - K + torch.arange(K + 1, device=x.device)
    b = torch.zeros(x.shape + (NC,), dtype=x.dtype, device=x.device)
    b.scatter_(2, cols, vals)
    return b * mask[:, :, None].to(x.dtype)


# ---------------------------------------------------------------------------
# banded LSQ solve + residual bookkeeping
# ---------------------------------------------------------------------------


def _normal_eqs(b: Tensor, y: Tensor, n_int: Tensor):
    """(G with padded identity + jitter, rhs, live-coefficient mask)."""
    live = torch.arange(NC, device=b.device)[None, :] < (n_int + K + 1)[:, None]
    bt = b.transpose(1, 2)
    g = torch.matmul(bt, b)
    # padded coefficient rows get an identity so the factorization exists;
    # a small live-diagonal jitter keeps the f32 Cholesky stable
    tr = torch.diagonal(g, dim1=1, dim2=2).sum(dim=1) / torch.clamp(
        torch.sum(live, dim=1), min=1
    )
    add = torch.where(live, _EPS_DIAG * tr[:, None], tr[:, None].expand_as(live))
    g = g + torch.diag_embed(add)
    rhs = torch.matmul(bt, y)
    return g, rhs, live


_BW = K + 1  # half-bandwidth of B^T B (and of B^T B + D^T D/p^2)


def _chol_band_factor(g: Tensor):
    """Unrolled half-bandwidth-4 Cholesky of (B, NC, NC) SPD matrices, plain
    PyTorch: returns (rows, diag) where rows[i] holds L[i, i-4..i-1] (None
    out of range) and diag[i] = L[i, i]."""
    l_rows = []
    diag = []
    for i in range(NC):
        row = []
        for off in range(_BW, 0, -1):
            j = i - off
            if j < 0:
                row.append(None)
                continue
            acc = g[:, i, j]
            for off2 in range(_BW, 0, -1):
                k_idx = i - off2
                if k_idx < 0 or k_idx >= j:
                    continue
                a = row[_BW - off2]
                b = l_rows[j][_BW - (j - k_idx)] if (j - k_idx) <= _BW else None
                if a is not None and b is not None:
                    acc = acc - a * b
            row.append(acc / diag[j])
        s = g[:, i, i]
        for off in range(_BW, 0, -1):
            r = row[_BW - off]
            if r is not None:
                s = s - r * r
        diag.append(torch.sqrt(torch.clamp(s, min=1e-30)))
        l_rows.append(row)
    return l_rows, diag


def _band_chol_diag_sum(g: Tensor, live: Tensor) -> Tensor:
    """sum(diag(chol(G))) over live coefficients (FITPACK's initial p)."""
    _, diag = _chol_band_factor(g)
    dvec = torch.stack(diag, dim=1)
    return torch.sum(torch.where(live, dvec, torch.zeros_like(dvec)), dim=1)


def _lsq_solve(b: Tensor, y: Tensor, mask: Tensor, n_int: Tensor):
    """LSQ spline coefficients on the current knots: (coef (B, NC, 2),
    fp (B,), residuals (B, M)) with per-site squared errors summed over
    dims; one extra refinement with the dense G keeps the residual vector
    near FITPACK's f64 accuracy."""
    g, rhs, live = _normal_eqs(b, y, n_int)
    c = _solve_spd_banded(g, rhs)
    r1 = rhs - torch.matmul(g, c)
    c = c + _solve_spd_banded(g, r1)
    c = c * live[:, :, None]
    fitted = torch.matmul(b, c)
    resid = torch.sum((fitted - y) ** 2, dim=2) * mask.to(b.dtype)
    fp = torch.sum(resid, dim=1)
    return c, fp, resid


def _knot_sites(x: Tensor, mask: Tensor, t_int: Tensor, n_int: Tensor):
    """(interval index (B, M), knot-coincident site flag (B, M))."""
    valid_knot = torch.arange(MAX_INT, device=x.device)[None, None, :] < n_int[:, None, None]
    iv = torch.sum((x[:, :, None] >= t_int[:, None, :]) & valid_knot, dim=2)
    cross = torch.any((x[:, :, None] == t_int[:, None, :]) & valid_knot, dim=2) & mask
    return iv, cross


def _interval_stats(x, mask, resid, t_int, n_int, endpoint_mask):
    """FITPACK's fpint/nrdata for the current knot set (fpcurf.f:140-215).

    fpint[j]: residual sum of interval j, each knot-coincident site's
    residual split half to the interval it closes and half to the one it
    opens. nrdata[j]: data sites strictly inside interval j.
    """
    iv, cross = _knot_sites(x, mask, t_int, n_int)
    ivs = torch.arange(NI, device=x.device)
    onehot_iv = (iv[:, :, None] == ivs).to(x.dtype)
    onehot_prev = ((iv[:, :, None] - 1) == ivs).to(x.dtype)
    w_main = resid * torch.where(cross, 0.5, 1.0)
    w_prev = resid * torch.where(cross, 0.5, 0.0)
    fpint = torch.einsum("bm,bmj->bj", w_main, onehot_iv) + torch.einsum(
        "bm,bmj->bj", w_prev, onehot_prev
    )
    inside = mask & ~cross & ~endpoint_mask
    nrdata = torch.einsum("bm,bmj->bj", inside.to(x.dtype), onehot_iv).to(torch.int32)
    live_iv = ivs[None, :] <= n_int[:, None]
    return (
        torch.where(live_iv, fpint, torch.zeros_like(fpint)),
        torch.where(live_iv, nrdata, torch.zeros_like(nrdata)),
    )


def _insert_knot(x, mask, t_int, n_int, fpint, nrdata, endpoint_mask):
    """One fpknot step: pick the worst interval, place the new knot at its
    count-median data site, split fpint/nrdata proportionally."""
    ivs = torch.arange(NI, device=x.device)[None, :]
    can = (nrdata > 0) & (ivs <= n_int[:, None])
    score = torch.where(can, fpint, torch.full_like(fpint, -1.0))
    number = torch.argmax(score, dim=1)
    fpmax = torch.take_along_dim(score, number[:, None], dim=1)[:, 0]
    any_ok = fpmax > 0.0

    maxpt = torch.take_along_dim(nrdata, number[:, None], dim=1)[:, 0]
    ihalf = maxpt // 2 + 1

    # the ihalf-th strictly-inside site of interval `number`
    iv, cross = _knot_sites(x, mask, t_int, n_int)
    inside = mask & ~cross & ~endpoint_mask & (iv == number[:, None])
    ranks = torch.cumsum(inside.to(torch.int32), dim=1)
    hit = inside & (ranks == ihalf[:, None])
    new_knot = torch.sum(torch.where(hit, x, torch.zeros_like(x)), dim=1)

    # sorted insert into the padded vector
    slot = torch.arange(MAX_INT, device=x.device)[None, :] == n_int[:, None]
    t_new = torch.sort(torch.where(slot, new_knot[:, None], t_int), dim=1).values
    n_new = n_int + 1

    # proportional split (fpknot.f tail): interval `number` -> two intervals
    am = torch.clamp(maxpt.to(x.dtype), min=1.0)
    f_lo = fpmax * (ihalf - 1).to(x.dtype) / am
    f_hi = fpmax * (maxpt - ihalf).to(x.dtype) / am
    shift_f = torch.roll(fpint, 1, dims=1)
    shift_n = torch.roll(nrdata, 1, dims=1)
    num = number[:, None]
    fpint_new = torch.where(
        ivs < num,
        fpint,
        torch.where(
            ivs == num,
            f_lo[:, None].expand_as(fpint),
            torch.where(ivs == num + 1, f_hi[:, None].expand_as(fpint), shift_f),
        ),
    )
    nrdata_new = torch.where(
        ivs < num,
        nrdata,
        torch.where(
            ivs == num,
            (ihalf - 1)[:, None].expand_as(nrdata),
            torch.where(ivs == num + 1, (maxpt - ihalf)[:, None].expand_as(nrdata), shift_n),
        ),
    ).to(nrdata.dtype)

    keep = ~any_ok
    return (
        _sel(keep, t_int, t_new),
        torch.where(keep, n_int, n_new),
        _sel(keep, fpint, fpint_new),
        _sel(keep, nrdata, nrdata_new),
    )


# ---------------------------------------------------------------------------
# part 2: discontinuity penalty + root_rati
# ---------------------------------------------------------------------------


def _disc_matrix(t_full: Tensor, n_int: Tensor, u_max: Tensor) -> Tensor:
    """(B, MAX_INT, NC) k-th-derivative-jump rows with FITPACK normalization
    (fpdisc.f): row j (valid for j < n_int) covers coefs j..j+k+1."""
    dev = t_full.device
    rows = torch.arange(MAX_INT, device=dev)
    cols = torch.arange(K + 2, device=dev)
    i = rows[:, None] + cols[None, :]  # (R, 5) coef index
    jknot = rows + K + 1  # (R,) knot index of the jump
    b = t_full.shape[0]

    def tk(idx: Tensor) -> Tensor:  # t_full[idx], idx < NEST by construction
        flat = idx.reshape(1, -1).expand(b, -1)
        return torch.gather(t_full, 1, flat).reshape((b,) + idx.shape)

    s = torch.arange(K + 2, device=dev)
    ii = i[:, :, None] + s[None, None, :]  # (R, 5, 5)
    tj = tk(jknot)[:, :, None, None]
    terms = torch.where(ii == jknot[:, None, None], torch.ones_like(tj), tj - tk(ii))
    prodd = torch.prod(terms, dim=-1)  # (B, R, 5)
    prodd = torch.where(torch.abs(prodd) > 1e-30, prodd, torch.ones_like(prodd))

    numer = tk(i + K + 1) - tk(i)
    nrint = (n_int + 1).to(t_full.dtype)
    q = u_max / nrint
    scale = q * q * q
    vals = numer / prodd * scale[:, None, None]  # (B, R, 5)

    valid = (rows[None, :] < n_int[:, None]).to(t_full.dtype)
    d = torch.zeros((b, MAX_INT, NC), dtype=t_full.dtype, device=dev)
    d.scatter_(2, i[None].expand(b, -1, -1), vals)
    return d * valid[:, :, None]


def _fprati(p1, f1, p2, f2, p3, f3, p3_inf):
    """Root of the rational interpolant r(p) = (u p + v)/(p + w)."""
    h1 = f1 * (f2 - f3)
    h2 = f2 * (f3 - f1)
    h3 = f3 * (f1 - f2)
    d_inf = torch.where(torch.abs(h3) > 1e-30, h3, torch.full_like(h3, 1e-30))
    p_inf = -(p2 * h1 + p1 * h2) / d_inf
    den = p1 * h1 + p2 * h2 + p3 * h3
    den = torch.where(torch.abs(den) > 1e-30, den, torch.full_like(den, 1e-30))
    p_fin = -(p1 * p2 * h3 + p2 * p3 * h1 + p1 * p3 * h2) / den
    return torch.where(p3_inf, p_inf, p_fin)


@timer.spanned("stage.fitpack.root_rati")
def _root_rati(b, y, mask, g, rhs, dtd, s, acc, p0, f1_0, f3_0, c_lsq, n_int, skip):
    """FITPACK's p-iteration (fpcurf.f:229-330) over the lanes that need it;
    ``skip`` lanes start converged. Returns (coefficients, trips (B,) int32):
    a lane's trips are the loop-condition checks its own loop would make, the
    one that ends it included, 0 for a ``skip`` lane; at B = 1 they are the
    loop's ``fitpack.trips.root_rati`` count."""
    live = torch.arange(NC, device=b.device)[None, :] < (n_int + K + 1)[:, None]
    maskf = mask.to(b.dtype)

    def solve_at(p):
        a = g + dtd / (p * p)[:, None, None]
        c = _solve_spd_banded(a, rhs)
        c = c * live[:, :, None]
        fitted = torch.matmul(b, c)
        fp = torch.sum(torch.sum((fitted - y) ** 2, dim=2) * maskf, dim=1)
        return c, fp - s

    zeros_i = torch.zeros_like(n_int)
    p, p1, f1 = p0, torch.zeros_like(p0), f1_0
    p3, f3 = torch.zeros_like(p0), f3_0
    p3_inf = torch.ones_like(skip)
    ich1, ich3 = zeros_i, zeros_i
    c_best = c_lsq
    conv, stop = skip.clone(), torch.zeros_like(skip)
    running, trips = ~skip, zeros_i
    it = 0
    while it < MAXIT:
        active = ~(conv | stop)
        trips = trips + running.to(trips.dtype)
        running = running & active
        if not _any(active, "fitpack.trips.root_rati"):
            break
        c2, f2 = solve_at(p)
        # a float32 band factorization can break down on G + D^T D / p^2 when
        # p is small against the data's scale (a 100 m hairpin: D^T D / p^2
        # ~1e9 beside G ~1e1, a pivot cancels to <= 0 and the solve returns
        # inf or NaN). Such a trial counts as a p that was too small: the lane
        # keeps its bracket and its carry and takes branch 2's step, so the
        # next p lies in (p, p3), where D^T D / p^2 is smaller.
        broke = active & ~torch.isfinite(f2)
        active = active & ~broke
        c_best = _sel(active, c2, c_best)

        new_conv = active & (torch.abs(f2) < acc)

        # branch 1: initial p too large (f2 barely above f3)
        b1 = active & ~new_conv & (ich3 == 0) & (f2 - f3 <= acc)
        p_b1 = p * _CON4
        p_b1 = torch.where(p_b1 <= p1, p1 * _CON9 + p * _CON1, p_b1)
        ich3_set = active & ~new_conv & (ich3 == 0) & ~b1 & (f2 < 0)

        # branch 2: initial p too small. A step beyond p3 falls back inside
        # the bracket (fpcurf.f: if(p.ge.p3)); the JAX package, like SciPy's
        # Python port of this loop, tests p <= p3 and so can leave it. The
        # kernel's too_small_p (csrc/fitpack_part2.cu) is the same rule.
        b2 = active & ~new_conv & ~b1 & (ich1 == 0) & (f1 - f2 <= acc)
        p_b2 = p / _CON4
        p_b2 = torch.where(~p3_inf & (p_b2 >= p3), p * _CON1 + p3 * _CON9, p_b2)
        ich1_set = active & ~new_conv & ~b1 & (ich1 == 0) & ~b2 & (f2 > 0)

        # monotonicity failure -> stop with current spline (ier=2)
        mono_bad = active & ~new_conv & ~b1 & ~b2 & ((f1 <= f2) | (f2 <= f3))

        # rational step
        do_step = active & ~new_conv & ~b1 & ~b2 & ~mono_bad
        p_new = _fprati(p1, f1, p, f2, p3, f3, p3_inf)
        neg = f2 < 0
        p3_s = torch.where(neg, p, p3)
        f3_s = torch.where(neg, f2, f3)
        p3_inf_s = p3_inf & ~neg
        p1_s = torch.where(neg, p1, p)
        f1_s = torch.where(neg, f1, f2)

        p_out = torch.where(b1, p_b1, torch.where(b2, p_b2, torch.where(do_step, p_new, p)))
        p1_out = torch.where(b2, p, torch.where(do_step, p1_s, p1))
        f1_out = torch.where(b2, f2, torch.where(do_step, f1_s, f1))
        p3_out = torch.where(b1, p, torch.where(do_step, p3_s, p3))
        f3_out = torch.where(b1, f2, torch.where(do_step, f3_s, f3))
        p3_inf_out = torch.where(b1, torch.zeros_like(p3_inf), torch.where(do_step, p3_inf_s, p3_inf))

        # lanes whose loop already ended keep their carry
        p = torch.where(active, p_out, torch.where(broke, p_b2, p))
        p1 = torch.where(active, p1_out, p1)
        f1 = torch.where(active, f1_out, f1)
        p3 = torch.where(active, p3_out, p3)
        f3 = torch.where(active, f3_out, f3)
        p3_inf = torch.where(active, p3_inf_out, p3_inf)
        ich1 = torch.where(ich1_set, 1, ich1)
        ich3 = torch.where(ich3_set, 1, ich3)
        conv = conv | new_conv
        stop = stop | mono_bad
        it += 1
    return c_best, trips


def fitpack_part2_plain(u, points, mask, t_int, n_int, u_max, c_lsq, fp0, fp_lsq, s, acc):
    """FITPACK's part 2 on the final knots, the kernel's plain version.

    Skipped (one host sync, the gate) when no lane has interior knots with
    its LSQ spline farther than ``acc`` from ``s``: FITPACK returns the LSQ
    spline there. Else the design, the normal equations, the initial p from
    the diagonal of G's Cholesky factor, the discontinuity penalty D^T D and
    the p-iteration :func:`_root_rati`. Returns (coefficients (B, NC, 2),
    trips (B,) int32, as :func:`_root_rati` counts them)."""
    dtype = points.dtype
    fpms = fp_lsq - s
    skip = (n_int == 0) | (torch.abs(fpms) < acc)
    if not _any(~skip, "fitpack.trips.part2"):
        return c_lsq, torch.zeros_like(n_int)
    t_full = _full_knots(t_int, n_int, u_max)
    b = _design(u, mask, t_full, n_int)
    g, rhs, live_c = _normal_eqs(b, points, n_int)
    diag_sum = _band_chol_diag_sum(g, live_c)
    nc_live = (n_int + K + 1).to(dtype)
    p0 = nc_live / torch.clamp(diag_sum, min=1e-30)
    f1_0 = fp0 - s  # p = 0: LSQ polynomial (no interior knots)
    f3_0 = fpms  # p = inf: LSQ spline on the final knots
    d = _disc_matrix(t_full, n_int, u_max)
    dtd = torch.matmul(d.transpose(1, 2), d)
    c_p2, trips = _root_rati(b, points, mask, g, rhs, dtd, s, acc, p0, f1_0, f3_0, c_lsq, n_int, skip)
    return _sel(skip, c_lsq, c_p2), trips


@functools.lru_cache(maxsize=None)
def _fit_library() -> ctypes.CDLL:
    """The library of csrc/fitpack_part2.cu with its C entry declared, built
    and bound once."""
    lib = kernel_build.load("fitpack_part2")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fitpack_fit_f32.argtypes = [ptr] * 7 + [f32, f32, i32, i32] + [ptr] * 6
    lib.fitpack_fit_f32.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# tiny-input closed forms (m <= 4 -> interpolating polynomial, Bezier coefs)
# ---------------------------------------------------------------------------


def _solve_spd4(g: Tensor, rhs: Tensor) -> Tensor:
    """Unrolled 4x4 SPD Cholesky solve, g (B, 4, 4), rhs (B, 4, R)."""
    eps = 1e-30

    def sq(v):
        return torch.sqrt(torch.clamp(v, min=eps))

    l11 = sq(g[:, 0, 0])
    l21 = g[:, 1, 0] / l11
    l31 = g[:, 2, 0] / l11
    l41 = g[:, 3, 0] / l11
    l22 = sq(g[:, 1, 1] - l21 * l21)
    l32 = (g[:, 2, 1] - l31 * l21) / l22
    l42 = (g[:, 3, 1] - l41 * l21) / l22
    l33 = sq(g[:, 2, 2] - l31 * l31 - l32 * l32)
    l43 = (g[:, 3, 2] - l41 * l31 - l42 * l32) / l33
    l44 = sq(g[:, 3, 3] - l41 * l41 - l42 * l42 - l43 * l43)
    c = lambda v: v[:, None]  # noqa: E731
    z0 = rhs[:, 0] / c(l11)
    z1 = (rhs[:, 1] - c(l21) * z0) / c(l22)
    z2 = (rhs[:, 2] - c(l31) * z0 - c(l32) * z1) / c(l33)
    z3 = (rhs[:, 3] - c(l41) * z0 - c(l42) * z1 - c(l43) * z2) / c(l44)
    x3 = z3 / c(l44)
    x2 = (z2 - c(l43) * x3) / c(l33)
    x1 = (z1 - c(l32) * x2 - c(l42) * x3) / c(l22)
    x0 = (z0 - c(l21) * x1 - c(l31) * x2 - c(l41) * x3) / c(l11)
    return torch.stack([x0, x1, x2, x3], dim=1)


_M_INV = np.asarray(
    [
        [1.0, 0.0, 0.0, 0.0],
        [1.0, 1.0 / 3.0, 0.0, 0.0],
        [1.0, 2.0 / 3.0, 1.0 / 3.0, 0.0],
        [1.0, 1.0, 1.0, 1.0],
    ],
    np.float32,
)


def _tiny_fit(u: Tensor, points: Tensor, mask: Tensor, u_max: Tensor) -> Tensor:
    """Interpolating polynomial of degree n_valid-1 (<= 3) as Bezier control
    points on [0, u_max] in the NC-padded coefficient array."""
    dtype, dev = points.dtype, points.device
    n_valid = torch.sum(mask, dim=1)
    t = torch.where(mask, u / torch.clamp(u_max, min=1e-9)[:, None], torch.ones_like(u))
    degree = torch.clamp(n_valid - 1, 1, 3)
    col_ok = (torch.arange(4, device=dev)[None, :] <= degree[:, None]).to(dtype)
    w = mask.to(dtype)
    powers = torch.stack([torch.ones_like(t), t, t * t, t * t * t], dim=-1) * w[:, :, None]
    powers = powers * col_ok[:, None, :]
    pt = powers.transpose(1, 2)
    g = torch.matmul(pt, powers)
    tr = torch.diagonal(g, dim1=1, dim2=2).sum(dim=1)
    g = g + (1e-7 * tr / 4.0 + 1e-12)[:, None, None] * torch.eye(4, dtype=dtype, device=dev)
    rhs = torch.matmul(pt, points * w[:, :, None])
    a = _solve_spd4(g, rhs)  # monomial coefs (B, 4, 2) on t in [0, 1]
    bez = torch.matmul(torch.as_tensor(_M_INV, device=dev), a)
    coef = torch.zeros((points.shape[0], NC, 2), dtype=dtype, device=dev)
    coef[:, :4] = bez
    return coef


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def fitpack_parts12_plain(u, points, mask, u_max, c0, fp0, resid0, s, acc):
    """FITPACK's parts 1 and 2 after iteration 0, the kernel's plain version.

    From the chord parameters u (B, M), points (B, M, 2), mask (B, M), u_max
    (B,) and iteration 0 of part 1, the least-squares polynomial on the empty
    knot set (coefficients c0 (B, NC, 2), SSR fp0 (B,), squared residual a
    site resid0 (B, M)): the first knot insertion, part 1's masked loop of
    least-squares solves and knot insertions (one host sync a trip of each),
    part 2 (:func:`fitpack_part2_plain`) and the tiny-input closed form. Returns
    (t_int, n_int, coef, budget_hit, trips (B, 2) int32: a lane's part-1
    solves after iteration 0 and its part-2 trips, 0 and 0 on a tiny lane)."""
    dtype, dev = points.dtype, points.device
    bsz, m = mask.shape
    n_valid = torch.sum(mask, dim=1)

    last_idx = torch.clamp(n_valid - 1, min=0)
    idx = torch.arange(m, device=dev)[None, :]
    endpoint_mask = (idx == 0) | (idx == last_idx[:, None])

    t_i0 = torch.full((bsz, MAX_INT), _BIG, dtype=dtype, device=dev)
    n_i0 = torch.zeros(bsz, dtype=torch.int32, device=dev)

    done0 = (torch.abs(fp0 - s) < acc) | (fp0 - s < 0)
    fpint0, nrdata0 = _interval_stats(u, mask, resid0, t_i0, n_i0, endpoint_mask)
    # first insertion round: nplus = 1 when n_int == 0 (fpcurf.f:158)
    t_ins, n_ins, _, _ = _insert_knot(u, mask, t_i0, n_i0, fpint0, nrdata0, endpoint_mask)
    t_int = _sel(done0, t_i0, t_ins)
    n_int = torch.where(done0, n_i0, n_ins)

    c_lsq, fp_lsq = c0, fp0
    nplus_prev = torch.ones(bsz, dtype=torch.int32, device=dev)
    done = done0
    budget_hit = torch.zeros_like(done0)
    trips1 = torch.zeros_like(n_i0)
    it = 1
    with timer.span("stage.fitpack.part1"):
        while it <= OUTER:
            active = ~done
            if not _any(active, "fitpack.trips.part1"):
                break
            trips1 = trips1 + active.to(trips1.dtype)
            # knots for this round were inserted by the previous trip; solve on them
            b = _design(u, mask, _full_knots(t_int, n_int, u_max), n_int)
            c, fp, resid = _lsq_solve(b, points, mask, n_int)
            fpms = fp - s
            newly = (torch.abs(fpms) < acc) | (fpms < 0)
            # budget exhausted: this solve is the fall-through solve on the final set
            budget_now = ~newly & ((n_int >= MAX_INT) | (it >= OUTER))
            done_now = newly | budget_now

            # FITPACK nplus update (fpcurf.f:150-160)
            delta = fp_lsq - fp
            big_delta = delta > acc
            ratio = nplus_prev.to(dtype) * fpms / torch.where(big_delta, delta, torch.ones_like(delta))
            npl1 = torch.where(big_delta, _f32_to_i32(ratio), nplus_prev * 2)
            nplus = torch.minimum(
                nplus_prev * 2,
                torch.clamp(torch.maximum(npl1, nplus_prev // 2), min=1),
            )
            nplus = torch.where(n_int == 0, torch.ones_like(nplus), nplus)

            fpint, nrdata = _interval_stats(u, mask, resid, t_int, n_int, endpoint_mask)
            ti, ni, fpi, nrd = t_int, n_int, fpint, nrdata
            limit = torch.clamp(nplus, max=NPLUS_MAX)
            jstep = 0
            with timer.span("stage.fitpack.insert"):
                while True:
                    ins = active & (jstep < limit) & ~done_now & (ni < MAX_INT)
                    if not _any(ins, "fitpack.trips.insert"):
                        break
                    ti2, ni2, fpi2, nrd2 = _insert_knot(u, mask, ti, ni, fpi, nrd, endpoint_mask)
                    ti, ni = _sel(ins, ti2, ti), torch.where(ins, ni2, ni)
                    fpi, nrd = _sel(ins, fpi2, fpi), _sel(ins, nrd2, nrd)
                    jstep += 1

            keep_old = done_now
            t_int = _sel(active, _sel(keep_old, t_int, ti), t_int)
            n_int = torch.where(active, torch.where(keep_old, n_int, ni), n_int)
            c_lsq = _sel(active, c, c_lsq)
            fp_lsq = torch.where(active, fp, fp_lsq)
            nplus_prev = torch.where(active, nplus, nplus_prev)
            budget_hit = torch.where(active, budget_now, budget_hit)
            done = torch.where(active, done_now, done)
            it += 1

    with timer.span("stage.fitpack.part2"):
        coef, trips2 = fitpack_part2_plain(u, points, mask, t_int, n_int, u_max, c_lsq, fp0, fp_lsq, s, acc)

    # tiny inputs: interpolating polynomial (degree n-1) — also the m=4 cubic
    tiny = n_valid <= 4
    coef = _sel(tiny, _tiny_fit(u, points, mask, u_max), coef)
    t_int = _sel(tiny, torch.full_like(t_int, _BIG), t_int)
    n_int = torch.where(tiny, torch.zeros_like(n_int), n_int)
    trips = torch.where(tiny[:, None], 0, torch.stack([trips1, trips2], dim=1))
    return t_int, n_int, coef, budget_hit & ~tiny, trips


def fitpack_parts12_cuda(u, points, mask, u_max, c0, fp0, resid0, s, acc):
    """Launch the fit kernel on the current stream (no synchronisation): one
    warp a lane, every lane through parts 1 and 2 to its own end. The same
    arguments and results as :func:`fitpack_parts12_plain`; raises on what
    the kernel does not take. The launch still runs part 2 of every fit, so
    it counts as a part-2 launch."""
    global part2_launch_count
    bsz, m = mask.shape
    f32 = (u, points, u_max, c0, fp0, resid0)
    if any(a.device != u.device for a in f32 + (mask,)) or u.device.type != "cuda":
        raise ValueError("fitpack_parts12_cuda takes CUDA tensors on one device")
    if any(a.dtype != torch.float32 for a in f32) or mask.dtype != torch.bool:
        raise TypeError("fitpack_parts12_cuda takes float32 data and a bool mask")
    shapes = {
        "u": (u, (bsz, m)), "points": (points, (bsz, m, 2)), "u_max": (u_max, (bsz,)),
        "c0": (c0, (bsz, NC, 2)), "fp0": (fp0, (bsz,)), "resid0": (resid0, (bsz, m)),
    }
    for name, (a, want) in shapes.items():
        if tuple(a.shape) != want:
            raise ValueError(f"fitpack_parts12_cuda: {name} is {tuple(a.shape)}, expected {want}")
    if not 1 <= m <= PART2_MAX_SITES:
        raise ValueError(f"the fit kernel takes 1 to {PART2_MAX_SITES} sites, got {m}")
    dev = u.device
    t_int = torch.empty((bsz, MAX_INT), dtype=torch.float32, device=dev)
    n_int = torch.empty((bsz,), dtype=torch.int32, device=dev)
    coef = torch.empty((bsz, NC, 2), dtype=torch.float32, device=dev)
    budget_hit = torch.empty((bsz,), dtype=torch.bool, device=dev)
    trips = torch.empty((bsz, 2), dtype=torch.int32, device=dev)
    if bsz == 0:
        return t_int, n_int, coef, budget_hit, trips
    args = [a.contiguous() for a in (u, points, mask, u_max, c0, fp0, resid0)]
    lib = _fit_library()
    with torch.cuda.device(dev):
        err = lib.fitpack_fit_f32(
            *(a.data_ptr() for a in args), s, acc, bsz, m,
            *(a.data_ptr() for a in (t_int, n_int, coef, budget_hit, trips)),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fitpack_fit kernel launch failed: CUDA error {err}")
    part2_launch_count += 1
    timer.count("fitpack.part2.launches")
    return t_int, n_int, coef, budget_hit, trips


def fitpack_parts12(u, points, mask, u_max, c0, fp0, resid0, s, acc):
    """FITPACK's parts 1 and 2 after iteration 0 (arguments and results as
    :func:`fitpack_parts12_plain`). CPU tensors take the plain version,
    CUDA tensors the kernel."""
    if u.device.type == "cpu":
        return fitpack_parts12_plain(u, points, mask, u_max, c0, fp0, resid0, s, acc)
    return fitpack_parts12_cuda(u, points, mask, u_max, c0, fp0, resid0, s, acc)


@timer.spanned("stage.fitpack.fit")
def fitpack_fit(points: Tensor, mask: Tensor, smoothing: float) -> FpSpline:
    """Fit the FITPACK smoothing spline through masked traces points
    (B, M, 2), mask (B, M); ``smoothing`` is FITPACK's ``s``."""
    bsz = mask.shape[0]
    s = float(np.float32(smoothing))
    acc = float(np.float32(TOL) * np.float32(smoothing))
    u, u_max, ok = chord_lengths(points, mask)

    # part-1 iteration 0: the LSQ polynomial on the empty knot set
    t_i0 = torch.full((bsz, MAX_INT), _BIG, dtype=points.dtype, device=points.device)
    n_i0 = torch.zeros(bsz, dtype=torch.int32, device=points.device)
    b0 = _design(u, mask, _full_knots(t_i0, n_i0, u_max), n_i0)
    c0, fp0, resid0 = _lsq_solve(b0, points, mask, n_i0)

    t_int, n_int, coef, budget_hit, _ = fitpack_parts12(u, points, mask, u_max, c0, fp0, resid0, s, acc)
    return FpSpline(t_int=t_int, n_int=n_int, coef=coef, u_max=u_max, ok=ok, budget_hit=budget_hit)


def fitpack_eval(fit: FpSpline, u: Tensor) -> Tensor:
    """Evaluate the splines at chord parameters u (B, P) -> (B, P, 2).

    Sites beyond [0, u_max] return the polynomial extension of the end
    pieces (FITPACK splev ext=0 semantics)."""
    t_full = _full_knots(fit.t_int, fit.n_int, fit.u_max)
    vals, span = _basis4(u, t_full, fit.n_int)
    cols = span[:, :, None] - K + torch.arange(K + 1, device=u.device)  # (B, P, 4)
    coef = torch.take_along_dim(fit.coef[:, None, :, :], cols[..., None], dim=2)  # (B, P, 4, 2)
    out = vals[..., 0, None] * coef[:, :, 0]
    for r in range(1, K + 1):
        out = out + vals[..., r, None] * coef[:, :, r]
    return out


def fitpack_eval_every(
    fit: FpSpline,
    every: float | Tensor,
    n_samples: int,
    max_u: float | None = None,
) -> tuple[Tensor, Tensor, Tensor]:
    """Reference SplineEvaluator.predict: sample every ``every`` (a float or
    a (B,) tensor) along the chord parameter up to ``max_u`` (default u_max).

    Returns (points (B, n_samples, 2), u_grid (B, n_samples), valid)."""
    dtype, dev = fit.u_max.dtype, fit.u_max.device
    bsz = fit.u_max.shape[0]
    mu = fit.u_max if max_u is None else torch.full_like(fit.u_max, max_u)
    iota = torch.arange(n_samples, dtype=dtype, device=dev)[None, :]
    if isinstance(every, Tensor):
        u_grid = iota * every[:, None]
    else:
        u_grid = (iota * every).expand(bsz, -1)
    valid = u_grid < mu[:, None]
    pts = fitpack_eval(fit, u_grid)
    pts = torch.where(valid[..., None], pts, torch.zeros_like(pts))
    return pts, u_grid, valid
