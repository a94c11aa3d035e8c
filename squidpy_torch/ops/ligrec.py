"""Receptor-ligand permutation counts (counterpart of ``squidpy_tpu/ops/ligrec.py``).

:func:`cluster_means` is the observed per-cluster means, one one-hot product
(TF32 off). :func:`ligrec_perm_counts` is the CellPhoneDB null: for each
permutation of the labels, the cluster sums of X, scaled by each cluster's
float reciprocal size, and the count of ``g[c1, rec] + g[c2, lig] > m_sum``
over the permutations. On a CUDA tensor it runs kernel K9
(``csrc/ligrec_perms.cu``) by one of two routes, picked once a call by
:func:`_k9_route`: on count data (integral X in [0, 255] whose column totals
stay below 2^24 in float32, 2^53 in float64) the integral route sums the
one-hot product exactly on the tensor cores, in int8 from a gene-major
uint8 copy of X (:func:`counts_operand`); otherwise the float route adds
each cell into its cluster's sum once. On the CPU it runs
:func:`ligrec_perm_counts_plain`: the integral route's exact int64 sums
(``index_add_``), rounded once, or the float route's order: within a slab of
:data:`SLAB` cells by cell, then across slabs by slab. Where the integral
route applies every order gives the same sums, so the two routes agree bit
for bit. Both return exact int64 counts. The shuffled labels are uint8
(rows padded to :func:`label_stride` columns; 255, or any value past the
clusters, adds nothing) or, past 255 clusters, int32.

The left side of the compare rounds as the JAX package's does on the CPU,
where XLA fuses the receptor's scaling into the add:
``fma(sum[c1, rec], inv[c1], round(sum[c2, lig] * inv[c2]))``. The kernel
calls ``fma``; the plain version emulates it exactly (:func:`fma_plain`).
"""

from __future__ import annotations

import torch

from squidpy_torch import _cuda

__all__ = ["SLAB", "cluster_means", "counts_operand", "fma_plain", "label_stride", "ligrec_perm_counts",
           "ligrec_perm_counts_plain"]

# cells a slab: K9 sums a slab's cells in order, then the slabs in order
SLAB = 2048
# cells a slab of the integral route: its int32 partials stay exact (at most 2^23 x 255)
INT_SLAB = 16384
# columns of K9's uint8 labels and of the uint8 copy of X: rows padded to a multiple
_LABEL_ALIGN = 128
# sums below these are exact in any order (integral data)
_EXACT_BELOW = {torch.float32: 2.0**24, torch.float64: 2.0**53}
# the integral route's block: (warps, permutations a warp)
_K9_MMA_LAYOUT = (4, 2)

_SMEM_BYTES = 227 * 1024  # shared memory a block may hold on the H100
_SMEM_TARGET = 100 * 1024  # K9's tables a block: two blocks an SM
_PARTIALS_BYTES = 1 << 30  # K9's per-slab partial sums, a launch


def cluster_means(x: torch.Tensor, labels: torch.Tensor, n_cls: int) -> torch.Tensor:
    """Per-cluster gene means ``(n_cls, n_genes)``: the one-hot product in
    x's dtype with TF32 off, divided by each cluster's size (1 for an empty
    cluster), as the JAX package's ``cluster_means``."""
    onehot = torch.nn.functional.one_hot(labels.to(torch.int64), n_cls).to(x.dtype)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        sums = onehot.T @ x
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    counts = onehot.sum(dim=0)[:, None]
    return sums / torch.where(counts == 0, torch.ones_like(counts), counts)


def _inv_counts(counts_per_cluster: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``1 / counts`` in x's dtype (1 for an empty cluster), a correctly
    rounded division, as the JAX package's."""
    c = counts_per_cluster.to(dtype)
    return 1.0 / torch.where(c == 0, torch.ones_like(c), c)


def _cluster_sums_plain(x: torch.Tensor, labels: torch.Tensor, n_cls: int) -> torch.Tensor:
    """``(P, n_cls, G)`` cluster sums in K9's order: each slab's cells added
    one by one, by cell, into zeroed sums, then the slabs' sums added by
    slab. Padding rows add +0.0, which changes no sum; labels outside
    ``[0, n_cls)`` go to a spare cluster that is dropped."""
    n, n_genes = x.shape
    n_perms = labels.shape[0]
    labels = labels[:, :n]
    n_slabs = -(-n // SLAB)
    width = min(SLAB, n)
    pad = n_slabs * width - n
    xs = torch.nn.functional.pad(x, (0, 0, 0, pad)).view(n_slabs, width, n_genes)
    lab = labels.to(torch.int64)
    lab = torch.where((lab >= 0) & (lab < n_cls), lab, n_cls)
    ls = torch.nn.functional.pad(lab, (0, pad)).view(n_perms, n_slabs, width)
    acc = torch.zeros((n_slabs, n_perms, n_cls + 1, n_genes), dtype=x.dtype, device=x.device)
    s_idx = torch.arange(n_slabs, device=x.device)[:, None]
    p_idx = torch.arange(n_perms, device=x.device)[None, :]
    for j in range(width):
        acc[s_idx, p_idx, ls[:, :, j].T] += xs[:, j][:, None, :]
    tot = acc[0].clone()
    for s in range(1, n_slabs):
        tot += acc[s]
    return tot[:, :n_cls]


def _cluster_sums_int(x: torch.Tensor, labels: torch.Tensor, n_cls: int) -> torch.Tensor:
    """``(P, n_cls, G)`` cluster sums of integral ``x`` (the integral
    route): exact int64 sums (``index_add_``), rounded once to x's dtype.
    Labels outside ``[0, n_cls)`` go to a spare cluster that is dropped."""
    n, n_genes = x.shape
    xi = x.to(torch.int64)
    lab = labels[:, :n].to(torch.int64)
    lab = torch.where((lab >= 0) & (lab < n_cls), lab, n_cls)
    acc = torch.zeros((labels.shape[0], n_cls + 1, n_genes), dtype=torch.int64, device=x.device)
    for p in range(labels.shape[0]):
        acc[p].index_add_(0, lab[p], xi)
    return acc[:, :n_cls].to(x.dtype)


def _k9_route(x: torch.Tensor, n_cls: int) -> str:
    """K9's route for ``x``: ``"integral"`` where X is integral, in [0, 255],
    and every gene's column total, which bounds every cluster sum, is below
    2^24 (float32) or 2^53 (float64), with at most 255 clusters (uint8
    labels); else ``"float"``. One read of the device."""
    if n_cls > 255 or x.numel() == 0 or x.dtype not in _EXACT_BELOW:
        return "float"
    ok = torch.stack([(x == torch.floor(x)).all(), (x >= 0).all(), (x <= 255).all(),
                      (x.sum(dim=0, dtype=torch.float64) < _EXACT_BELOW[x.dtype]).all()]).all()
    return "integral" if bool(ok) else "float"


def label_stride(n: int) -> int:
    """Columns a row of K9's uint8 labels (and of the uint8 copy of X)
    takes: n rounded up to a multiple of 128."""
    return -(-max(n, 1) // _LABEL_ALIGN) * _LABEL_ALIGN


def counts_operand(x: torch.Tensor) -> torch.Tensor:
    """The integral route's operand: x transposed to ``(G, label_stride(n))``
    uint8, zero past column n. Exact where :func:`_k9_route` says
    ``"integral"``."""
    n, n_genes = x.shape
    xt = torch.zeros((n_genes, label_stride(n)), dtype=torch.uint8, device=x.device)
    xt[:, :n] = x.T.to(torch.uint8)
    return xt


def _labels_u8(labels: torch.Tensor, n: int, n_cls: int) -> torch.Tensor:
    """``(P, label_stride(n))`` uint8 labels: the input itself when it is
    uint8 with rows of that many columns, else a copy with every label
    outside ``[0, n_cls)`` as 255 and 255 past column n."""
    ld = label_stride(n)
    if labels.dtype == torch.uint8 and labels.shape[1] == ld and labels.is_contiguous():
        return labels
    lab = labels[:, :n].to(torch.int64)
    out = torch.full((labels.shape[0], ld), 255, dtype=torch.uint8, device=labels.device)
    out[:, :n] = torch.where((lab >= 0) & (lab < n_cls), lab, 255).to(torch.uint8)
    return out


def _two_sum(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``a + b = s + e`` exactly, ``s`` the rounded sum (Knuth's TwoSum)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _round_to_odd(s: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """The value ``s + e`` (``|e|`` below half an ulp of ``s``) rounded to
    odd: ``s`` when exact or its last bit is odd, else its neighbour toward
    ``e``, whose last bit is odd."""
    bits = s.view(torch.int64 if s.dtype == torch.float64 else torch.int32)
    step = (e != 0) & ((bits & 1) == 0) & torch.isfinite(s)
    toward = torch.where(e > 0, torch.full_like(s, float("inf")), torch.full_like(s, float("-inf")))
    return torch.where(step, torch.nextafter(s, toward), s)


def _split(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Veltkamp's split of a float64 into two halves of 26 bits."""
    c = 134217729.0 * a  # 2^27 + 1
    hi = c - (c - a)
    return hi, a - hi


def fma_plain(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` with one rounding, in float32 or float64, from rounded
    operations alone (torch has no fused multiply-add on every device).
    float32: the product is exact in float64, and the float64 sum rounded
    to odd rounds correctly to float32. float64: Dekker's exact product
    ``uh + ul``, ``th + tl = c + uh`` exactly, then ``th + RO(tl + ul)``
    (Boldo and Melquiond, 2008)."""
    if a.dtype == torch.float32:
        s, e = _two_sum(a.double() * b.double(), c.double())
        return _round_to_odd(s, e).float()
    ah, al = _split(a)
    bh, bl = _split(b)
    uh = a * b
    ul = ((ah * bh - uh) + ah * bl + al * bh) + al * bl
    th, tl = _two_sum(c, uh)
    v, ve = _two_sum(tl, ul)
    out = th + _round_to_odd(v, ve)
    # infinities and NaN: the plain expression's value
    return torch.where(torch.isfinite(out), out, a * b + c)


def _perm_chunk_plain(x, labels, inv_counts, rec, lig, c1, c2, m_sum, n_cls, route) -> torch.Tensor:
    sums = (_cluster_sums_int if route == "integral" else _cluster_sums_plain)(x, labels, n_cls)
    s_rec = sums[:, c1[None, :], rec[:, None]]  # (P, I, J)
    g_lig = sums[:, c2[None, :], lig[:, None]] * inv_counts[c2][None, None, :]
    left = fma_plain(s_rec, inv_counts[c1][None, None, :].expand_as(s_rec), g_lig)
    return (left > m_sum[None]).sum(dim=0, dtype=torch.int64)


def ligrec_perm_counts_plain(
    x: torch.Tensor,
    shuffled_labels: torch.Tensor,
    counts_per_cluster: torch.Tensor,
    rec: torch.Tensor,
    lig: torch.Tensor,
    c1: torch.Tensor,
    c2: torch.Tensor,
    m_sum: torch.Tensor,
    n_cls: int,
    *,
    chunk_size: int | None = None,
    route: str | None = None,
) -> torch.Tensor:
    """Plain torch version of K9 (see :func:`ligrec_perm_counts`), in
    permutation chunks of ``chunk_size`` (by default 64), by ``route`` (by
    default :func:`_k9_route`'s)."""
    route = route or _k9_route(x, n_cls)
    inv = _inv_counts(counts_per_cluster, x.dtype)
    rec, lig, c1, c2 = (t.to(torch.int64) for t in (rec, lig, c1, c2))
    out = torch.zeros((rec.shape[0], c1.shape[0]), dtype=torch.int64, device=x.device)
    step = max(1, min(int(chunk_size or 64), shuffled_labels.shape[0]))
    for p0 in range(0, shuffled_labels.shape[0], step):
        out += _perm_chunk_plain(x, shuffled_labels[p0 : p0 + step], inv, rec, lig, c1, c2, m_sum, n_cls, route)
    return out


def _k9_layout(n_cls: int, itemsize: int) -> tuple[int, int]:
    """K9's block: ``(warps, permutations a warp)``, each permutation with an
    ``n_cls x 32`` table of sums in shared memory. Four warps with the most
    permutations (4, 2 or 1) whose tables stay within 100 KB; past that,
    one permutation a warp and as many warps (at most 4) as 227 KB holds
    (0: the clusters do not fit). The kernel also takes 8 a warp, which
    ``chip_smoke.py``'s ``[diag] k9_layout`` line times beside the others."""
    table = n_cls * 32 * itemsize
    for per_warp in (4, 2, 1):
        if 4 * per_warp * table <= _SMEM_TARGET:
            return 4, per_warp
    return min(4, _SMEM_BYTES // table), 1


def ligrec_perm_counts(
    x: torch.Tensor,
    shuffled_labels: torch.Tensor,
    counts_per_cluster: torch.Tensor,
    rec: torch.Tensor,
    lig: torch.Tensor,
    c1: torch.Tensor,
    c2: torch.Tensor,
    m_sum: torch.Tensor,
    n_cls: int,
    *,
    chunk_size: int | None = None,
    route: str | None = None,
    xt: torch.Tensor | None = None,
) -> torch.Tensor:
    """Σ over permutations of ``groups[c1, rec] + groups[c2, lig] > m_sum``.

    ``x`` ``(n_cells, n_genes)`` float32 or float64; ``shuffled_labels``
    ``(n_perms, >= n_cells)``, any integer type (columns past n_cells are
    not read); ``counts_per_cluster`` ``(n_cls,)``; ``rec``/``lig`` ``(I,)``
    gene columns; ``c1``/``c2`` ``(J,)`` clusters; ``m_sum`` ``(I, J)`` in
    x's dtype. ``groups`` are each permutation's cluster sums scaled by the
    float reciprocal of the cluster's size, the receptor's product fused
    into the add (see the module). Returns the ``(I, J)`` int64 exceedance
    counts. ``route`` is :func:`_k9_route`'s (found here when not given) and
    ``xt`` the integral route's :func:`counts_operand` (made here when not
    given): a caller with several chunks finds both once. A CPU tensor runs
    :func:`ligrec_perm_counts_plain`; a CUDA tensor launches kernel K9,
    ``chunk_size`` permutations a launch (by default as many as 1 GiB of
    per-slab partial sums holds).
    """
    if x.device.type == "cpu":
        return ligrec_perm_counts_plain(x, shuffled_labels, counts_per_cluster, rec, lig, c1, c2, m_sum, n_cls,
                                        chunk_size=chunk_size, route=route)
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"K9 takes float32 or float64 expression, found {x.dtype}.")
    n, n_genes = x.shape
    n_perms = shuffled_labels.shape[0]
    n_inter, n_pairs = rec.shape[0], c1.shape[0]
    if n == 0:
        raise ValueError("K9 needs at least one cell.")
    if shuffled_labels.ndim != 2 or shuffled_labels.shape[1] < n:
        raise ValueError(f"`shuffled_labels` must have shape ({n_perms}, >= {n}), found {tuple(shuffled_labels.shape)}.")
    route = route or _k9_route(x, n_cls)
    integral = route == "integral"
    itemsize = x.element_size()
    warps, per_warp = _K9_MMA_LAYOUT if integral else _k9_layout(n_cls, itemsize)
    if warps < 1:
        raise ValueError(f"K9 holds at most {_SMEM_BYTES // (32 * itemsize)} clusters of {x.dtype} sums in shared "
                         f"memory, found {n_cls}.")
    x = x.contiguous()
    if n_cls <= 255:
        labels = _labels_u8(shuffled_labels, n, n_cls)
    elif integral:
        raise ValueError("K9's integral route takes uint8 labels: at most 255 clusters.")
    else:
        labels = shuffled_labels[:, :n].to(torch.int32).contiguous()
    idx = [t.to(device=x.device, dtype=torch.int32).contiguous() for t in (rec, lig, c1, c2)]
    inv = _inv_counts(counts_per_cluster.to(x.device), x.dtype).contiguous()
    m_sum = m_sum.to(device=x.device, dtype=x.dtype).contiguous()
    for name, t, dtype, shape in (("x", x, x.dtype, (n, n_genes)), ("shuffled_labels", labels, labels.dtype, None),
                                  ("m_sum", m_sum, x.dtype, (n_inter, n_pairs)),
                                  ("counts_per_cluster", inv, x.dtype, (n_cls,))):
        _cuda.require(t, name, dtype, shape)
    if integral:
        xt = counts_operand(x) if xt is None else xt
        _cuda.require(xt, "xt", torch.uint8, (n_genes, label_stride(n)))
    if n_inter and n_pairs:  # the kernel reads the sums at these columns and clusters
        lo_rec, lo_lig, lo_c1, lo_c2, hi_rec, hi_lig, hi_c1, hi_c2 = torch.stack(
            [t.min() for t in idx] + [t.max() for t in idx]).tolist()
        if min(lo_rec, lo_lig, lo_c1, lo_c2) < 0 or max(hi_rec, hi_lig) >= n_genes or max(hi_c1, hi_c2) >= n_cls:
            raise ValueError(f"`rec`/`lig` must lie in [0, {n_genes}) and `c1`/`c2` in [0, {n_cls}).")
    slab = INT_SLAB if integral else SLAB
    n_slabs = -(-n // slab)
    part_item = 4 if integral else itemsize
    if chunk_size is None:
        chunk_size = max(1, _PARTIALS_BYTES // (n_slabs * n_cls * n_genes * part_item))
    step = max(1, min(int(chunk_size), n_perms))
    partials = torch.empty((n_slabs, step, n_cls, n_genes), dtype=torch.int32 if integral else x.dtype,
                           device=x.device)
    sums = torch.empty((step, n_cls, n_genes), dtype=x.dtype, device=x.device)
    counts = torch.zeros((n_inter, n_pairs), dtype=torch.int64, device=x.device)
    lib = _cuda.library()
    ld = labels.stride(0)
    dtype_code = 0 if x.dtype == torch.float32 else 1
    tail = (inv.data_ptr(), idx[0].data_ptr(), idx[1].data_ptr(), n_inter, idx[2].data_ptr(), idx[3].data_ptr(),
            n_pairs, m_sum.data_ptr(), slab, partials.data_ptr(), sums.data_ptr(), counts.data_ptr(), dtype_code,
            _cuda.stream_ptr())
    for p0 in range(0, n_perms, step):
        pc = min(step, n_perms - p0)
        lab = labels[p0:].data_ptr()
        if integral:
            code = lib.sqt_ligrec_perms_int(xt.data_ptr(), xt.stride(0), n, n_genes, lab, ld, pc, n_cls, warps,
                                            per_warp, *tail)
        else:
            code = lib.sqt_ligrec_perms(x.data_ptr(), n, n_genes, lab, labels.element_size(), ld, pc, n_cls, warps,
                                        per_warp, *tail)
        _cuda.check(code, "ligrec_perms")
        _cuda.launches["ligrec_perms"] += 1
    return counts
