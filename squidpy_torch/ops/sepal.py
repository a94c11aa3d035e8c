"""Sepal's diffusion (counterpart of ``squidpy_tpu/ops/sepal.py``).

Every gene of a block diffuses at once by explicit Euler steps: saturated
nodes take the 4- or 6-neighbour laplacian of the old state, unsaturated
nodes the laplacian of their nearest saturated node, the state is clamped
at 0, and a gene stops (keeps its state) at the first step whose entropy
change is at most ``thresh``. The score is ``dt`` times that step.

The arithmetic is the JAX package's as XLA compiles it on the CPU: no FMA,
and each division by a constant is a product with the rounded reciprocal
(the hex laplacian times ``1/3``, the entropy times ``1/n_sat``). The
entropy's two column sums take a fixed order, shared by the kernel and the
plain version: saturated rows in runs of 8 added in order, then a pairwise
tree over the runs (zeros past the end). A CUDA tensor runs kernel K11
(``csrc/sepal.cu``), float32; a CPU tensor runs :func:`_diffusion_plain`,
in any float type.
"""

from __future__ import annotations

import numpy as np
import torch

from squidpy_torch import _cuda

__all__ = ["sepal_diffusion"]

_RUN = 8  # rows a run of the entropy sums (csrc/sepal.cu kRun)
_BLOCK_ROWS = 256  # saturated rows a block of K11 (csrc/sepal.cu kRows)
_MIN_SPAN = 32  # K11's finish folds at least one partial a warp of 32
_CHECK_EVERY = 64  # steps a call into K11 between reads of the active genes


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


def _diffusion_plain(conc0: torch.Tensor, sat: torch.Tensor, sat_idx: torch.Tensor, unsat: torch.Tensor,
                     unsat_to_sat_pos: torch.Tensor, use_hex: bool, n_iter: int, dt: float,
                     thresh: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of K11 on ``conc0``'s device: ``(done_iter, state)``."""
    dtype = conc0.dtype
    n_genes, n_sat = conc0.shape[1], sat.shape[0]
    dt_, thresh_, recip3, recip_sat, eps = _constants(dtype, n_sat, dt, thresh)
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
        d2 = (2.0 * nh - 12.0 * centre) * recip3 if use_hex else nh - 4.0 * centre
        upd = d2 * dt_
        new = conc.clone()
        new[sat] = centre + upd
        new[unsat] = conc[unsat] + upd[pos]
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


def _diffusion_k11(conc0: torch.Tensor, sat: torch.Tensor, sat_idx: torch.Tensor, unsat: torch.Tensor,
                   unsat_to_sat_pos: torch.Tensor, use_hex: bool, n_iter: int, dt: float,
                   thresh: float) -> tuple[torch.Tensor, torch.Tensor]:
    """K11: :data:`_CHECK_EVERY` steps a call (four kernels a step), then
    one read of the active genes; ``(done_iter, state)``."""
    _cuda.require(conc0, "conc0", torch.float32)
    n_genes = conc0.shape[1]
    n_sat, k = sat_idx.shape
    if n_sat < 1 or k not in (4, 6):
        raise ValueError(f"K11 needs saturated nodes of 4 or 6 neighbours, found {n_sat} of {k}.")
    sat, sat_idx = sat.to(torch.int32).contiguous(), sat_idx.to(torch.int32).contiguous()
    unsat, pos = unsat.to(torch.int32).contiguous(), unsat_to_sat_pos.to(torch.int32).contiguous()
    for name, t in (("sat", sat), ("sat_idx", sat_idx), ("unsat", unsat), ("unsat_to_sat_pos", pos)):
        _cuda.require(t, name, torch.int32)
    dt_, thresh_, recip3, recip_sat, eps = _constants(torch.float32, n_sat, dt, thresh)
    device = conc0.device
    bufs = (conc0.clone(), torch.empty_like(conc0))
    span = max(_MIN_SPAN, _next_pow2(-(-n_sat // _BLOCK_ROWS)))
    part_x = torch.empty((span, n_genes), dtype=torch.float32, device=device)
    part_h = torch.empty_like(part_x)
    total = torch.empty(n_genes, dtype=torch.float32, device=device)
    active = torch.ones(n_genes, dtype=torch.uint8, device=device)
    prev = torch.ones(n_genes, dtype=torch.float32, device=device)
    done = torch.full((n_genes,), float("nan"), dtype=torch.float32, device=device)
    lib = _cuda.library()
    i = 0
    while i < n_iter:
        steps = min(_CHECK_EVERY, n_iter - i)
        code = lib.sqt_sepal_steps(bufs[0].data_ptr(), bufs[1].data_ptr(), n_genes, n_genes, sat.data_ptr(),
                                   sat_idx.data_ptr(), n_sat, k, unsat.data_ptr(), pos.data_ptr(), unsat.shape[0],
                                   int(use_hex), dt_, recip3, recip_sat, eps, thresh_, i, steps, span,
                                   part_x.data_ptr(), part_h.data_ptr(), total.data_ptr(), active.data_ptr(),
                                   prev.data_ptr(), done.data_ptr(), _cuda.stream_ptr())
        _cuda.check(code, "sepal_diffusion")
        _cuda.launches["sepal_diffusion"] += 1
        i += steps
        if not bool(active.any()):  # one wait every _CHECK_EVERY steps
            break
    return done, bufs[i % 2]


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
