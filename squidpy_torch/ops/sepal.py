"""Sepal's diffusion (counterpart of ``squidpy_tpu/ops/sepal.py``).

Every gene of a block diffuses at once by explicit Euler steps: saturated
nodes take the 4- or 6-neighbour laplacian of the old state, unsaturated
nodes the laplacian of their nearest saturated node, the state is clamped
at 0, and a gene stops (keeps its state) at the first step whose entropy
change is at most ``thresh``. The score is ``dt`` times that step.

The arithmetic is the JAX package's as XLA compiles it on the CPU: no FMA,
and each division by a constant is a product with the rounded reciprocal
(the hex laplacian times ``1/3``, the entropy times ``1/n_sat``); a
saturated node's hex update folds ``1/3`` and ``dt`` into one constant
(:func:`_recip3dt`). The entropy's two column sums take a fixed order,
shared by the kernel and the plain version: saturated rows in runs of 8 added in order, then a pairwise
tree over the runs (zeros past the end). A CUDA tensor runs kernel K11
(``csrc/sepal.cu``), float32, by one of two routes chosen by shape
(:func:`_k11_route`): the whole diffusion of a few genes a block in shared
memory, in one launch, where two buffers of a gene column fit there (a
Visium section); else one streaming pass a step over the state in device
memory. A CPU tensor runs :func:`_diffusion_plain`, in any float type.
"""

from __future__ import annotations

import numpy as np
import torch

from squidpy_torch import _cuda

__all__ = ["sepal_diffusion"]

_RUN = 8  # rows a run of the entropy sums (csrc/sepal.cu kRun)
_BLOCK_ROWS = 256  # saturated rows a block of K11's streaming route (csrc/sepal.cu kRows)
_CHECK_EVERY = 64  # passes a call into K11's streaming route between reads of the active genes


def _ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """Column sums of ``x`` ``(rows, g)`` in K11's order: rows in runs of
    :data:`_RUN` added in order, then a pairwise tree over the runs, padded
    with zero runs to a power of two."""
    runs = max(1, -(-x.shape[0] // _RUN))
    span = 1 << (runs - 1).bit_length()
    v = torch.nn.functional.pad(x, (0, 0, 0, span * _RUN - x.shape[0])).view(span, _RUN, x.shape[1])
    s = v[:, 0]
    for t in range(1, _RUN):
        s = s + v[:, t]
    while s.shape[0] > 1:
        s = s[0::2] + s[1::2]
    return s[0]


def _entropy(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Shannon entropy (nats) of each column of ``x`` with p(0) adding 0,
    as the JAX package's ``_entropy_cols``, the sums in K11's order."""
    pos = x > 0
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    xs = _ordered_sum(torch.where(pos, x, zero))
    safe = torch.where(xs < eps, torch.ones_like(xs), xs)
    xn = torch.where(pos, x / safe, zero)
    xl = torch.log(torch.maximum(xn, torch.full_like(xn, eps)))
    ent = -_ordered_sum(torch.where(pos, xn * xl, zero))
    return torch.where(xs < eps, zero, ent)


def _constants(dtype: torch.dtype, n_sat: int, dt: float, thresh: float) -> tuple[float, float, float, float, float]:
    """``dt``, ``thresh``, 1/3, 1/n_sat and epsilon rounded to ``dtype``, the
    reciprocals as XLA folds them (each operand rounded, then divided)."""
    f = np.float32 if dtype == torch.float32 else np.float64
    return (float(f(dt)), float(f(thresh)), float(f(1) / f(3)), float(f(1) / f(n_sat)), float(np.finfo(f).eps))


def _recip3dt(dtype: torch.dtype, dt: float) -> float:
    """The one constant of a saturated node's hex update: XLA folds ``(x *
    f(1/3)) * dt`` into ``x * f(f(1/3) * dt)`` (each rounded to ``dtype``),
    but not through the gather of the unsaturated nodes' updates."""
    f = np.float32 if dtype == torch.float32 else np.float64
    return float(f(f(1) / f(3)) * f(dt))


def _diffusion_plain(conc0: torch.Tensor, sat: torch.Tensor, sat_idx: torch.Tensor, unsat: torch.Tensor,
                     unsat_to_sat_pos: torch.Tensor, use_hex: bool, n_iter: int, dt: float,
                     thresh: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of K11 on ``conc0``'s device: ``(done_iter, state)``."""
    dtype = conc0.dtype
    n_genes, n_sat = conc0.shape[1], sat.shape[0]
    dt_, thresh_, recip3, recip_sat, eps = _constants(dtype, n_sat, dt, thresh)
    recip3dt = _recip3dt(dtype, dt)
    sat, sat_idx = sat.long(), sat_idx.long()
    unsat, pos = unsat.long(), unsat_to_sat_pos.long()
    conc = conc0.clone()
    prev = torch.ones(n_genes, dtype=dtype, device=conc.device)
    active = torch.ones(n_genes, dtype=torch.bool, device=conc.device)
    done = torch.full((n_genes,), float("nan"), dtype=dtype, device=conc.device)
    for i in range(n_iter):
        if not bool(active.any()):
            break
        centre = conc[sat]
        nh = conc[sat_idx[:, 0]]
        for j in range(1, sat_idx.shape[1]):
            nh = nh + conc[sat_idx[:, j]]
        if use_hex:
            lap = 2.0 * nh - 12.0 * centre
            upd, upd_unsat = lap * recip3dt, ((lap * recip3) * dt_)[pos]
        else:
            upd = (nh - 4.0 * centre) * dt_
            upd_unsat = upd[pos]
        new = conc.clone()
        new[sat] = centre + upd
        new[unsat] = conc[unsat] + upd_unsat
        new = torch.where(new < 0, torch.zeros((), dtype=dtype, device=conc.device), new)  # NaN stays NaN
        conc = torch.where(active[None, :], new, conc)
        ent = _entropy(conc[sat], eps) * recip_sat
        newly = active & ((ent - prev).abs() <= thresh_)
        done = torch.where(newly, torch.full_like(done, float(i)), done)
        active = active & ~newly
        prev = ent
    return done, conc


def _next_pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


_FAN = 32  # partials one block folds, a group of K11's streaming fold (csrc/sepal.cu kFan)
_TILE_GENES = 64  # genes a streaming block, two a lane (kTileGenes)
_RES_MAX_GENES = 8  # genes a resident block, at most (kResMaxGenes)
_RES_STATIC = 1024  # the resident kernel's static shared memory, rounded up


def _k11_levels(n_sat: int) -> tuple[int, int]:
    """The streaming fold's scratch: partials and ticket groups summed over
    its levels (each level folds groups of 32 partials of the one below,
    from one partial a block of 256 saturated rows up to one)."""
    parts = groups = 0
    count = -(-n_sat // _BLOCK_ROWS)
    while count > 1:
        parts += count
        count = -(-count // _FAN)
        groups += count
    return parts, groups


def _k11_resident_smem(n: int, n_sat: int, genes: int) -> int:
    """Shared memory of a resident block: both buffers of each gene's column
    (n padded to 4), its partials of 32 saturated positions (a power of
    two of them, at least 32) and each of the 32 warps' scratch (36 float2)."""
    n_pad = (n + 3) & ~3
    span = max(_FAN, _next_pow2(-(-n_sat // 32)))
    return 8 * genes * n_pad + 8 * genes * span + 8 * 36 * 32


def _k11_route(n: int, n_sat: int, n_genes: int, smem_optin: int, sms: int) -> int:
    """K11's route by shape, once a call: the genes a resident block holds,
    or 0 for the streaming route. At most 8, and at most the most whose two
    column buffers fit the card's opt-in shared memory a block (0 where not
    one fits); from half that up, the count that leaves the fewest genes a
    block times rounds of blocks on the card's SMs (one block an SM), the
    larger on a tie."""
    most = 0
    while most < min(_RES_MAX_GENES, n_genes) and _k11_resident_smem(n, n_sat, most + 1) + _RES_STATIC <= smem_optin:
        most += 1
    if not most:
        return 0

    def cost(g: int) -> int:
        blocks = -(-n_genes // g)
        return -(-blocks // sms) * g

    return min(range(-(-most // 2), most + 1), key=lambda g: (cost(g), -g))


def _clamp0(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x < 0, torch.zeros((), dtype=x.dtype, device=x.device), x)  # NaN stays NaN


def _diffusion_k11(conc0: torch.Tensor, sat: torch.Tensor, sat_idx: torch.Tensor, unsat: torch.Tensor,
                   unsat_to_sat_pos: torch.Tensor, use_hex: bool, n_iter: int, dt: float,
                   thresh: float) -> tuple[torch.Tensor, torch.Tensor]:
    """K11 by the route :func:`_k11_route` picks: the resident kernel in one
    launch, or the streaming passes, :data:`_CHECK_EVERY` a call with one
    read of the active genes between calls; ``(done_iter, state)``."""
    _cuda.require(conc0, "conc0", torch.float32)
    n, n_genes = conc0.shape
    n_sat, k = sat_idx.shape
    if n_sat < 1 or k not in (4, 6):
        raise ValueError(f"K11 needs saturated nodes of 4 or 6 neighbours, found {n_sat} of {k}.")
    sat, sat_idx = sat.to(torch.int32).contiguous(), sat_idx.to(torch.int32).contiguous()
    unsat, pos = unsat.to(torch.int32).contiguous(), unsat_to_sat_pos.to(torch.int32).contiguous()
    for name, t in (("sat", sat), ("sat_idx", sat_idx), ("unsat", unsat), ("unsat_to_sat_pos", pos)):
        _cuda.require(t, name, torch.int32)
    dt_, thresh_, recip3, recip_sat, eps = _constants(torch.float32, n_sat, dt, thresh)
    device = conc0.device
    lib = _cuda.library()
    stencil = (sat.data_ptr(), sat_idx.data_ptr(), n_sat, k, unsat.data_ptr(), pos.data_ptr(), unsat.shape[0],
               int(use_hex), dt_, recip3, _recip3dt(torch.float32, dt), recip_sat, eps, thresh_, n_iter)
    genes = _k11_route(n, n_sat, n_genes, *_cuda.device_info())
    if genes:
        state = conc0.clone()
        done = torch.empty(n_genes, dtype=torch.float32, device=device)
        code = lib.sqt_sepal_resident(state.data_ptr(), n_genes, n_genes, n, *stencil, genes, done.data_ptr(),
                                      _cuda.stream_ptr())
        _cuda.check(code, "sepal_resident")
        _cuda.launches["sepal_resident"] += 1
        return done, state
    ld = n_genes + n_genes % 2  # a lane loads its two genes at once
    if n * ld // 2 >= 1 << 32:
        raise ValueError(f"K11 addresses the state by 32-bit offsets: {n} x {ld} values is too many.")
    bufs = (torch.empty((n, ld), dtype=torch.float32, device=device), torch.empty((n, ld), dtype=torch.float32,
                                                                                 device=device))
    bufs[0][:, :n_genes] = conc0
    # a node of neither table (a degree above k) is never written by a pass:
    # as in the plain version it keeps its state clamped at 0 from step 0 on,
    # so both buffers hold that after pass 0 (run alone then)
    others = n > n_sat + unsat.shape[0]
    if others:
        bufs[1][:, :n_genes] = _clamp0(conc0)
    parts, groups = _k11_levels(n_sat)
    tiles = -(-n_genes // _TILE_GENES)
    part = torch.empty((max(parts, 1), tiles, 32, 4), dtype=torch.float32, device=device)
    tickets = torch.zeros((max(groups, 1), tiles), dtype=torch.int32, device=device)
    active = torch.zeros((2, n_genes), dtype=torch.uint8, device=device)
    active[0] = 1
    sums = torch.zeros((2, n_genes), dtype=torch.float32, device=device)
    prev = torch.ones(n_genes, dtype=torch.float32, device=device)
    done = torch.full((n_genes,), float("nan"), dtype=torch.float32, device=device)
    p = 0
    while p <= n_iter:  # passes 0..n_iter: the last one takes the budget's last entropy
        passes = min(1 if others and p == 0 else _CHECK_EVERY, n_iter + 1 - p)
        code = lib.sqt_sepal_passes(bufs[0].data_ptr(), bufs[1].data_ptr(), ld, n_genes, *stencil, p, passes,
                                    part.data_ptr(), tickets.data_ptr(), active.data_ptr(), sums.data_ptr(),
                                    prev.data_ptr(), done.data_ptr(), _cuda.stream_ptr())
        _cuda.check(code, "sepal_diffusion")
        _cuda.launches["sepal_diffusion"] += 1
        p += passes
        if others and p == 1 and n_iter > 0:
            bufs[0].copy_(_clamp0(bufs[0]))
        if p <= n_iter and not bool(active[p % 2].any()):  # one wait every _CHECK_EVERY passes
            break
    state = bufs[(p - 1) % 2]  # the buffer the last pass read
    return done, state if ld == n_genes else state[:, :n_genes].contiguous()


def sepal_diffusion(conc0: torch.Tensor, sat: torch.Tensor, sat_idx: torch.Tensor, unsat: torch.Tensor,
                    unsat_to_sat_pos: torch.Tensor, use_hex: bool, n_iter: int, dt: float, thresh: float, *,
                    return_state: bool = False) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """The step at which each gene's entropy converged (``conc0``'s dtype;
    NaN where it did not within ``n_iter``), for ``conc0`` ``(n_cells,
    n_genes)``, the saturated nodes ``sat`` with their neighbours ``sat_idx``
    ``(n_sat, 4 or 6)``, the unsaturated nodes ``unsat`` and the position in
    ``sat`` of each one's nearest saturated node. With ``return_state`` the
    final concentrations too. Kernel K11 on a CUDA tensor (float32), its
    plain version on a CPU tensor."""
    args = (conc0, sat, sat_idx, unsat, unsat_to_sat_pos, bool(use_hex), int(n_iter), float(dt), float(thresh))
    done, state = _diffusion_plain(*args) if conc0.device.type == "cpu" else _diffusion_k11(*args)
    return (done, state) if return_state else done
