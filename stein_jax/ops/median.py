"""On-device medians for the RBF bandwidth heuristic.

The reference computes the *exact* median of all n^2 entries of the pairwise
squared-distance matrix D — including the zero diagonal and both symmetric
copies (reference: stein/utilities/compute_median.py:4-16, called from
stein/kernels/abstract_kernel.py:38). Its top_k formulation is numerically
identical to ``np.median`` of the flattened matrix.

Strategies:

- ``exact_median``: full sort-based median of a materialised D. O(n^2 log n);
  the reference semantics (n=4096 -> 64 MB fp32 D).
- ``subsampled_sq_dist_median``: exact median over a deterministic strided
  subset of D's *rows* (all columns kept), never materialising full D. The
  bandwidth is a heuristic, so the O(1/sqrt(m)) quantile error of a
  multi-million-entry subsample is statistically invisible.
- ``bisect_median`` and its warm, sharded and ring variants: sort-free
  searches on the value axis over a strided row subsample, counting
  |{D <= t}| per round.
- ``binned_median``: two-level histogram refinement over blocks of D computed
  on the fly — deterministic, near-exact (interval shrinks by the bin count
  per level), bounded memory. Also the primitive behind the distributed
  median (histograms are psum-able across hosts).
"""


import jax
import jax.numpy as jnp


# Tightest-first candidate brackets for the warm search, as multiples of
# the previous step's median. [0.92, 1.09] covers typical converged drift
# (<2%/step); [0.7, 1.4] catches the early fast-shrink phase (drift up to
# ~30%/step) at a 5x tighter refinement than the wide fallback; [0.25, 4]
# is the rare-jump fallback before a full cold restart. Per-step midpoint
# error <= (hi - lo) * med / 4^rounds for whichever bracket verifies.
DEFAULT_BRACKETS = ((0.92, 1.09), (0.7, 1.4), (0.25, 4.0))


def select_bracket(med_prev, ends, cnts, k_c, lo_full, hi_full):
    """Branchless tightest-valid-bracket select: widest-first applies,
    tightest-last overrides; a bracket is valid iff its endpoint counts
    provably straddle the median's rank k."""
    have_hint = med_prev > 0
    lo0, hi0 = lo_full, hi_full
    for (a, b), (c_a, c_b) in reversed(list(zip(ends, cnts))):
        valid = have_hint & (c_a < k_c) & (c_b >= k_c)
        lo0 = jnp.where(valid, a, lo0)
        hi0 = jnp.where(valid, b, hi0)
    return lo0, hi0


def exact_median(D):
    """Exact median over all entries of D, matching np.median semantics."""
    return jnp.median(D)


def _row_block_sq_dists(theta_rows, theta, rowsq_rows, rowsq):
    """Squared distances between a row block and all particles.

    Same algebraic form as the reference's D = r + r^T - 2 T T^T
    (abstract_kernel.py:33-35), restricted to a block of rows. The Gram
    matmul runs at Precision.HIGHEST — D cancels catastrophically at
    small inter-particle distances, where reduced-precision (TF32) Gram
    entries would destroy it (see ops/rbf.pairwise_sq_dists)."""
    return (
        rowsq_rows[:, None]
        + rowsq[None, :]
        - 2.0 * jnp.matmul(
            theta_rows, theta.T,
            precision=jax.lax.Precision.HIGHEST,
        )
    )


def _subsample_idx(n, max_rows):
    """THE single-device strided-row subsample policy:
    idx = arange(max_rows) * (n // max_rows), or None when every row is
    kept (n <= max_rows). Every single-device median entry point derives
    its rows from here, so they count bitwise the same values; the
    single-device analogue of _local_row_idx."""
    if n <= max_rows:
        return None
    stride = n // max_rows
    return jnp.arange(max_rows) * stride


def row_subsample_block(theta, max_rows=512):
    """The strided-row distance block D[idx, :] for _subsample_idx's
    deterministic subset (all rows when n <= max_rows), shared by every
    single-device median entry point, so they provably count bitwise the
    same values."""
    rowsq = jnp.sum(theta * theta, axis=1)
    idx = _subsample_idx(theta.shape[0], max_rows)
    if idx is None:
        return _row_block_sq_dists(theta, theta, rowsq, rowsq)
    return _row_block_sq_dists(theta[idx], theta, rowsq[idx], rowsq)


def subsampled_sq_dist_median(theta, max_rows=512):
    """Exact median of the squared-distance sub-matrix D[idx, :] for a
    deterministic strided row subset idx. Never materialises full D.

    For max_rows >= n this equals the exact full median.
    """
    return jnp.median(row_subsample_block(theta, max_rows))


def _strided_rows(D, max_rows):
    """Deterministic strided row subsample of a materialised D — the same
    rows (hence bitwise the same values, given equal matmul precision) as
    the block the theta-based entry points compute (_subsample_idx)."""
    idx = _subsample_idx(D.shape[0], max_rows)
    return D if idx is None else D[idx]


def bisect_median_on_D(D, max_rows=512, passes=30):
    """bisect_median for callers that already materialised the full
    [n, n] distance matrix (the XLA phi path computes D for the kernel
    anyway — recomputing a distance block just for the median would
    duplicate a HIGHEST-precision Gram matmul)."""
    Ds = _strided_rows(D, max_rows)
    lo0 = jnp.minimum(jnp.min(Ds), 0.0)
    hi0 = jnp.max(Ds)

    def count_le(mid, cdt):
        return jnp.sum(Ds <= mid, dtype=cdt)

    return _bisect_search(count_le, Ds.size, lo0, hi0, passes)


def bisect_median(theta, max_rows=512, passes=30):
    """Sort-free median of the (row-subsampled) squared-distance matrix via
    bisection on the value axis.

    Compute the [m, n] distance block once, then run ``passes`` halvings
    of the value interval, counting |{D <= mid}| per step (a streaming
    compare+sum over the cached block); both middle order statistics
    refine in the same loop. After 30 halvings the interval is 2^-30 of
    the value range — below fp32 resolution, i.e. exact for the subsample.
    With max_rows >= n this is the exact full median. Whether this beats
    a sort on the GPU is not measured yet.
    """
    D = row_subsample_block(theta, max_rows)

    lo0 = jnp.minimum(jnp.min(D), 0.0)
    hi0 = jnp.max(D)

    def count_le(mid, cdt):
        return jnp.sum(D <= mid, dtype=cdt)

    return _bisect_search(count_le, D.size, lo0, hi0, passes)


def _bisect_search(count_le, total, lo0, hi0, passes, count_many=None):
    """Shared bisection core: find the median's order statistic(s) of a
    distribution queryable only through ``count_le(mid, count_dtype) ->
    |{x <= mid}|`` (a streaming count, possibly psum'd across shards).
    ``count_many(ts, cdt) -> [len(ts)] counts`` may be supplied to batch
    multiple thresholds into one collective (the sharded caller turns the
    quad-ary round's three counts into a single psum).

    For large totals the two middle order statistics are separated by
    ~1/total of the distribution — far below the bandwidth heuristic's
    sensitivity — so a single rank search suffices and halves the
    sequential count kernels (which dominate small-n step time). Small
    totals keep both ranks so the even-count median matches np.median
    exactly."""
    k_lo = (total + 1) // 2
    k_hi = total // 2 + 1
    # Count in f32 when int32 would overflow (> 2^31 entries).
    cdt = jnp.float32 if total >= 2 ** 31 else jnp.int32
    k_lo_c = jnp.asarray(k_lo, cdt)
    k_hi_c = jnp.asarray(k_hi, cdt)

    if count_many is None:
        def count_many(ts, cdt):
            return jnp.stack([count_le(t, cdt) for t in ts])

    if total > 100_000:
        # Quad-ary refinement: three thresholds per round share ONE pass
        # over D (XLA fuses the three compare+sum reductions into a
        # single read), gaining 2 bits per sequential kernel.
        # ceil(passes/2) rounds give the same precision as `passes`
        # binary halvings.
        rounds = (passes + 1) // 2

        def body(_, carry):
            lo, hi = carry
            w = 0.25 * (hi - lo)
            cnts = count_many((lo + w, lo + 2.0 * w, lo + 3.0 * w), cdt)
            # b = number of interior thresholds below the target rank =
            # index of the sub-interval containing it.
            b = jnp.sum((cnts < k_lo_c).astype(lo.dtype))
            lo_new = lo + b * w
            return lo_new, lo_new + w

        lo_a, hi_a = jax.lax.fori_loop(0, rounds, body, (lo0, hi0))
        return 0.5 * (lo_a + hi_a)

    def body(_, carry):
        lo_a, hi_a, lo_b, hi_b = carry
        mid_a = 0.5 * (lo_a + hi_a)
        mid_b = 0.5 * (lo_b + hi_b)
        cnt_a = count_le(mid_a, cdt)
        cnt_b = count_le(mid_b, cdt)
        go_lo_a = cnt_a >= k_lo_c   # k_lo-th smallest is <= mid_a
        go_lo_b = cnt_b >= k_hi_c
        return (
            jnp.where(go_lo_a, lo_a, mid_a),
            jnp.where(go_lo_a, mid_a, hi_a),
            jnp.where(go_lo_b, lo_b, mid_b),
            jnp.where(go_lo_b, mid_b, hi_b),
        )

    lo_a, hi_a, lo_b, hi_b = jax.lax.fori_loop(
        0, passes, body, (lo0, hi0, lo0, hi0)
    )
    return 0.5 * (0.5 * (lo_a + hi_a) + 0.5 * (lo_b + hi_b))


def _block_histogram(theta, rowsq, theta_cols, colsq, lo, hi, n_bins,
                     block_rows):
    """Histogram of the squared distances between ``theta``'s rows and
    ``theta_cols``'s rows over [lo, hi], computed by streaming row blocks of
    D (recomputed on the fly; D never materialised).

    Values outside [lo, hi] clamp into the boundary bins. Returns int32
    counts of shape [n_bins]. In the sharded step, ``theta`` is the local
    particle block and ``theta_cols`` the all-gathered global particles.
    """
    n = theta.shape[0]
    block_rows = min(block_rows, n)
    n_blocks = n // block_rows
    width = (hi - lo) / n_bins

    # Per-block scatter counts in int32 (exact; a block holds at most
    # block_rows * n_cols < 2^31 entries), accumulated across blocks in
    # float32 (totals reach n^2, which overflows int32 beyond n=46341;
    # the f32 vector-add rounding is ~ulp(total) ranks — far below a bin's
    # resolution). Scattering 1.0 directly into an f32 accumulator would
    # instead SATURATE once a bin crosses 2^24 (adding 1 becomes a no-op).
    def block_counts(rows, rsq):
        D = _row_block_sq_dists(rows, theta_cols, rsq, colsq)
        b = jnp.clip(((D - lo) / width).astype(jnp.int32), 0, n_bins - 1)
        ints = jnp.zeros((n_bins,), jnp.int32).at[b.ravel()].add(1)
        return ints.astype(jnp.float32)

    def body(carry, i):
        start = i * block_rows
        rows = jax.lax.dynamic_slice_in_dim(theta, start, block_rows, axis=0)
        rsq = jax.lax.dynamic_slice_in_dim(rowsq, start, block_rows, axis=0)
        return carry + block_counts(rows, rsq), None

    counts, _ = jax.lax.scan(
        body, jnp.zeros((n_bins,), jnp.float32), jnp.arange(n_blocks)
    )
    # Remainder rows (n not divisible by block_rows).
    rem = n - n_blocks * block_rows
    if rem > 0:
        counts = counts + block_counts(theta[-rem:], rowsq[-rem:])
    return counts


def binned_median(theta, n_bins=4096, n_levels=2, block_rows=256,
                  axis_name=None, theta_cols=None):
    """Near-exact median of all n^2 squared distances via multi-level
    histogram refinement, without materialising D.

    Each level shrinks the search interval by a factor of ``n_bins``; after
    ``n_levels`` levels the returned bin centre is within
    ``range(D) / n_bins**n_levels / 2`` of the exact median — for the
    bandwidth heuristic this is far below Monte-Carlo noise.

    If ``axis_name`` is given (inside shard_map), ``theta`` is the local
    particle block, ``theta_cols`` must be the all-gathered global particle
    matrix, and histograms plus the global max are psum'd across the
    particle axis so every shard agrees on the global median: this is the
    distributed bandwidth of SURVEY.md §5.
    """
    n = theta.shape[0]
    rowsq = jnp.sum(theta * theta, axis=1)
    if theta_cols is None:
        theta_cols = theta
        colsq = rowsq
    else:
        colsq = jnp.sum(theta_cols * theta_cols, axis=1)

    # Global value range of D: the cheap bound max_ij D_ij <= 4*max_i
    # rowsq_i (|a-b|^2 <= 2|a|^2 + 2|b|^2), and lo slightly below 0 for
    # fp-negative distances.
    max_rsq = jnp.max(colsq)
    if axis_name is not None:
        max_rsq = jax.lax.pmax(max_rsq, axis_name)
    hi0 = 4.0 * max_rsq + 1e-12
    lo0 = jnp.asarray(-1e-6, theta.dtype) * (1.0 + hi0)

    n_total = theta_cols.shape[0]
    total = n_total * n_total
    # Ranks of the two middle order statistics (1-indexed): for even totals
    # the median is the mean of ranks total//2 and total//2+1; for odd totals
    # both ranks coincide at (total+1)//2.
    k_lo = (total + 1) // 2
    k_hi = total // 2 + 1

    def refine(lo, hi, k):
        """Locate the bin containing the k-th smallest; return its bounds."""
        counts = _block_histogram(
            theta, rowsq, theta_cols, colsq, lo, hi, n_bins, block_rows
        )
        if axis_name is not None:
            counts = jax.lax.psum(counts, axis_name)
        cum = jnp.cumsum(counts)
        b = jnp.searchsorted(
            cum, jnp.float32(k), side="left"
        ).astype(theta.dtype)
        width = (hi - lo) / n_bins
        return lo + b * width, lo + (b + 1.0) * width

    lo_a, hi_a = lo0, hi0
    lo_b, hi_b = lo0, hi0
    for _ in range(n_levels):
        lo_a, hi_a = refine(lo_a, hi_a, k_lo)
        lo_b, hi_b = refine(lo_b, hi_b, k_hi)
    return 0.5 * ((lo_a + hi_a) * 0.5 + (lo_b + hi_b) * 0.5)


def warm_bisect_median(theta, med_prev, max_rows=512, warm_passes=8,
                       brackets=DEFAULT_BRACKETS):
    """Branchless bisect median warm-started from the previous step's value
    — the scan fast path (r1's lax.cond variant was a measured net loss;
    this version has no data-dependent branches).

    SVGD particles move a small fraction of the inter-particle scale per
    step, so the median of D drifts slowly. One fused pass over the cached
    distance block computes min, max, and the counts at every candidate
    interval endpoint (DEFAULT_BRACKETS, tightest first); a branchless
    select then picks the TIGHTEST interval that provably brackets the
    median's rank, falling back to [min(D), max(D)] with no hint / after
    a wild jump, followed by ceil(warm_passes/2) quad-ary rounds (2 bits
    per sequential kernel, like _bisect_search).

    Per-step error is bounded by the verified bracket's final width,
    (hi - lo)*med/4^rounds: 0.17 (tight), 0.7 (mid — the early
    fast-shrink phase, drift up to ~30%/step, which measured as the
    binding regime on real trajectories), 3.75 (rare-jump wide). At
    warm_passes=6 the mid-bracket bound is 1.1% of med vs 5.9% under the
    old tight/wide-only chain (measured max 3.3% — the mid bracket
    exists because of that measurement). Posterior effects are pinned by
    the statistical tests; callers needing tighter per-step bandwidths
    raise warm_passes. On a true cold
    start the bound is range/4^rounds — callers that scan
    (api.run / train_on_batches) seed the carry with a full cold
    bisect_median of the initial particles, so the cold fallback only
    fires after a >4x single-step median jump. The brackets are
    re-verified against actual counts every step, so error never
    accumulates across the scan.

    1+ceil(warm_passes/2) sequential count passes replace the cold
    search's 1+ceil(passes/2).
    """
    D = row_subsample_block(theta, max_rows)
    return _warm_search(D, med_prev, warm_passes, brackets)


def warm_bisect_median_on_D(D, med_prev, max_rows=512, warm_passes=8,
                            brackets=DEFAULT_BRACKETS):
    """warm_bisect_median for callers that already materialised the full
    [n, n] D (see bisect_median_on_D)."""
    return _warm_search(_strided_rows(D, max_rows), med_prev, warm_passes,
                        brackets)


def _warm_search(D, med_prev, warm_passes, brackets=None,
                 axis_name=None, total=None):
    """Shared warm-bracket search. With ``axis_name`` (inside shard_map),
    ``D`` is each shard's row block of a ``total``-entry global sample:
    counts psum (batched — ONE collective for all bracket endpoints,
    one per quad-ary round) and the range reduces via a single batched
    pmax of [-lo, hi], so every shard refines the same interval.

    ``brackets`` is the tightest-first chain of candidate intervals
    (multiples of med_prev); the tightest whose endpoint counts provably
    bracket the median's rank wins, else the full range."""
    if brackets is None:
        brackets = DEFAULT_BRACKETS
    if total is None:
        total = D.size
    k = (total + 1) // 2
    cdt = jnp.float32 if total >= 2 ** 31 else jnp.int32
    k_c = jnp.asarray(k, cdt)

    # Pass 1 (one read of D, XLA fuses all the reductions): global range
    # + every candidate endpoint count.
    ends = [(lo * med_prev, hi * med_prev) for lo, hi in brackets]
    lo_full = jnp.minimum(jnp.min(D), 0.0)
    hi_full = jnp.max(D)
    cnts = [
        (jnp.sum(D <= a, dtype=cdt), jnp.sum(D <= b, dtype=cdt))
        for a, b in ends
    ]
    if axis_name is not None:
        mm = jax.lax.pmax(jnp.stack([-lo_full, hi_full]), axis_name)
        lo_full, hi_full = -mm[0], mm[1]
        flat = jax.lax.psum(
            jnp.stack([c for pair in cnts for c in pair]), axis_name
        )
        cnts = [(flat[2 * i], flat[2 * i + 1]) for i in range(len(cnts))]

    lo0, hi0 = select_bracket(med_prev, ends, cnts, k_c, lo_full, hi_full)
    return _quad_rounds(D, lo0, hi0, k_c, (warm_passes + 1) // 2, cdt,
                        axis_name)


def _quad_rounds(D, lo0, hi0, k_c, rounds, cdt, axis_name=None):
    """The warm search's quad-ary refinement rounds (2 bits per
    sequential count pass; one batched psum per round when sharded)."""
    def body(_, carry):
        lo, hi = carry
        w = 0.25 * (hi - lo)
        cnts = jnp.stack([
            jnp.sum(D <= lo + w, dtype=cdt),
            jnp.sum(D <= lo + 2.0 * w, dtype=cdt),
            jnp.sum(D <= lo + 3.0 * w, dtype=cdt),
        ])
        if axis_name is not None:
            cnts = jax.lax.psum(cnts, axis_name)
        b = jnp.sum((cnts < k_c).astype(lo.dtype))
        lo_new = lo + b * w
        return lo_new, lo_new + w

    lo, hi = jax.lax.fori_loop(0, rounds, body, (lo0, hi0))
    return 0.5 * (lo + hi)


def grid_edges(med_prev, hi_bound, brackets, g1):
    """Threshold grids for the O(1)-collective warm search: for every
    candidate bracket (multiples of ``med_prev``) PLUS the always-valid
    full-range fallback [~0, hi_bound], the g1+1 uniform edge values.
    Returns a flat list of (n_brackets + 1) * (g1 + 1) scalars, bracket-
    major, tightest bracket first, fallback last. ``hi_bound`` must
    upper-bound every D entry (|a-b|^2 <= 4 max |x|^2 plus an fp headroom
    factor); the fallback's lo sits just below zero to admit fp-negative
    distances (cf. binned_median's lo0)."""
    cands = [(lo * med_prev, hi * med_prev) for lo, hi in brackets]
    lo_f = jnp.asarray(-1e-6, jnp.float32) * (1.0 + hi_bound)
    cands.append((lo_f, hi_bound))
    edges = []
    for lo, hi in cands:
        w = (hi - lo) / g1
        edges.extend(lo + t * w for t in range(g1 + 1))
    return edges


def sharded_warm_from_grid(D, med_prev, cnts_local, hi_bound, axis_name,
                           total, warm_passes=8,
                           brackets=DEFAULT_BRACKETS, g1=16):
    """Finish the O(1)-collective SHARDED warm search whose pass-1 work —
    the local per-candidate-bracket (g1+1)-point GRID counts at
    grid_edges — is ``cnts_local``. TWO batched psums total (vs pmax +
    counts psum + one psum per quad-ary round for the rounds search):

      psum 1 (``cnts_local``): selects the tightest candidate whose grid
        endpoints provably straddle the median's rank k (the same
        verified-bracket semantics as select_bracket, widest-first
        applies / tightest-last overrides, with the full-range fallback
        [~0, hi_bound] always valid) AND locates the rank's g1-ary
        sub-bin within it — the first refinement round rides the
        selection collective.
      psum 2: one g2-ary count round over the emitted ``D`` block
        (g2 - 1 interior thresholds in ONE fused pass) pins the final
        interval.

    ``g1`` must be a power of two and match the counted grid; g2 is derived
    so the final width = candidate_width / (g1 * g2) =
    candidate_width / 2**warm_passes — the identical bound to the
    quad-round chain it replaces at every g1 (same verified-candidate
    widths, same per-step re-verification so error never accumulates).
    The g1/g2 split moves count work between the first pass ((g1+1)
    edges per candidate) and the second (g2-1 edges, one fused read of D)
    without changing the collective count — two psums at any split.
    The only looser case is the rare no-valid-bracket fallback, whose
    width is the hi_bound range (~4x max centered row-norm^2) instead of
    the pmax'd true range — a one-step precision class, re-verified next
    step. ``hi_bound`` must upper-bound every D entry and be computed
    SHARD-IDENTICALLY (derive it from the all-gathered particles);
    ``total`` is the global entry count behind rank k.

    Semantics target: stein/utilities/compute_median.py:4-16 via the
    warm-bracket bound, as everywhere else."""
    k = (total + 1) // 2
    cdt = jnp.float32 if total >= 2 ** 31 else jnp.int32
    k_c = jnp.asarray(k, cdt)
    cnts_g = jax.lax.psum(cnts_local.astype(cdt), axis_name)

    edges = grid_edges(med_prev, hi_bound, brackets, g1)
    have_hint = med_prev > 0

    def cand_bin(ci, gate):
        """Candidate ci's validity and located g1-ary sub-bin bounds."""
        base = ci * (g1 + 1)
        c = cnts_g[base:base + g1 + 1]
        lo_e = edges[base]
        w = edges[base + 1] - edges[base]
        valid = gate & (c[0] < k_c) & (c[g1] >= k_c)
        b = jnp.sum((c[1:g1] < k_c).astype(lo_e.dtype))
        lo = lo_e + b * w
        return valid, lo, lo + w

    # Widest-first chain, tightest-valid wins (select_bracket's order);
    # the fallback grid (last candidate) is valid by construction.
    _, lo0, hi0 = cand_bin(len(brackets), jnp.asarray(True))
    for ci in reversed(range(len(brackets))):
        valid, lo_c, hi_c = cand_bin(ci, have_hint)
        lo0 = jnp.where(valid, lo_c, lo0)
        hi0 = jnp.where(valid, hi_c, hi0)

    lg1 = g1.bit_length() - 1
    if g1 != 2 ** lg1:
        raise ValueError(f"grid g1 must be a power of two (got {g1})")
    g2 = 2 ** max(warm_passes - lg1, 1)
    if g2 > 1024:
        # The g2 pass unrolls g2 - 1 fused threshold counts at trace
        # time (the rounds chain loops instead): an unbounded
        # warm_passes would emit tens of thousands of count
        # expressions and hang compilation. 1024 covers every sane
        # width target (warm_passes <= log2(g1) + 10) with a <= ms
        # trace; beyond that the quad-round search is the right tool.
        raise ValueError(
            f"median_collectives='grid' unrolls 2**(warm_passes - "
            f"log2(g1)) = {g2} threshold counts per step; cap "
            f"warm_passes at {lg1 + 10} for g1={g1}, or use "
            "median_collectives='rounds' (looped search) for deeper "
            "refinement"
        )
    w2 = (hi0 - lo0) / g2
    cnts2 = jnp.stack([
        jnp.sum(D <= lo0 + t * w2, dtype=cdt) for t in range(1, g2)
    ])
    cnts2 = jax.lax.psum(cnts2, axis_name)
    b2 = jnp.sum((cnts2 < k_c).astype(lo0.dtype))
    return lo0 + (b2 + 0.5) * w2


def _local_row_idx(n_loc, axis_name, max_rows):
    """THE local-row subsample policy shared by every distributed median
    entry point (~max_rows rows used globally, split evenly across the
    particle axis, strided locally). One copy, so the theta-based and
    on-D variants provably count bitwise the same rows. Returns
    (row_indices, global_row_count)."""
    n_dev = jax.lax.axis_size(axis_name)
    m = max(min(max_rows // n_dev, n_loc), 1)
    stride = max(n_loc // m, 1)
    return jnp.arange(m) * stride, m * n_dev


def _sharded_row_block(theta_loc, theta_all, axis_name, max_rows):
    """Each shard's strided LOCAL-row subsample against the gathered
    global columns: the distributed analogue of _strided_rows, with
    ~max_rows rows used globally (split evenly across shards). Returns
    (D_block, total_global_entries)."""
    n = theta_all.shape[0]
    idx, m_global = _local_row_idx(theta_loc.shape[0], axis_name, max_rows)
    rows = theta_loc[idx]
    rsq_rows = jnp.sum(rows * rows, axis=1)
    rsq_all = jnp.sum(theta_all * theta_all, axis=1)
    D = _row_block_sq_dists(rows, theta_all, rsq_rows, rsq_all)
    return D, m_global * n


def sharded_bisect_median(theta_loc, theta_all, axis_name, max_rows=512,
                          passes=30):
    """Distributed sort-free median for the all-gather sharded step: each
    shard counts over a strided subsample of its LOCAL rows against the
    gathered global columns; counts psum over the particle axis, so every
    shard bisects the same global interval and agrees on the result.

    ~max_rows rows are used globally (split evenly across shards)."""
    D, total = _sharded_row_block(theta_loc, theta_all, axis_name, max_rows)
    return _sharded_bisect_on_rows(D, axis_name, total, passes)


def sharded_warm_bisect_median_on_D(D_rows, med_prev, axis_name,
                                    max_rows=512, warm_passes=8,
                                    brackets=DEFAULT_BRACKETS):
    """Distributed warm_bisect_median for the all-gather sharded step,
    on the local [n_loc, n] distance rows it materialises: the same
    branchless verified-bracket search (see warm_bisect_median's error
    bounds), counting on a strided local-row subsample, with every
    count/range reduction psum'd across the particle axis — 1 batched
    psum for the bracket pass plus one per quad-ary round, vs
    1+ceil(passes/2) for the cold sharded search. With max_rows covering
    all rows it is bitwise equal to the single-device warm search on the
    same particles (identical counts -> identical interval arithmetic)."""
    n_loc, n = D_rows.shape
    idx, m_global = _local_row_idx(n_loc, axis_name, max_rows)
    return _warm_search(D_rows[idx], med_prev, warm_passes, brackets,
                        axis_name=axis_name, total=m_global * n)


def sharded_warm_grid_on_D(D_rows, med_prev, hi_bound, axis_name,
                           max_rows=512, warm_passes=8,
                           brackets=DEFAULT_BRACKETS, g1=8):
    """The O(1)-collective GRID warm search for callers that already
    materialised their local [n_loc, n] distance rows (the 2-D mesh
    step, parallel/sharded2d.py — D_rows is psum'd over the model axis
    and so replicated there; the particle axis is the only one counted
    over). No kernel needed: the grid counts are ONE fused XLA read of
    the subsampled rows (every edge's compare folds into the same
    traversal), then sharded_warm_from_grid finishes with its two
    batched psums — vs pmin/pmax + endpoint psum + one psum per
    quad-ary round for the rounds search. ``hi_bound`` must bound every
    D entry shard-identically; the 2-D caller derives it from the
    psum'd centred column norms (|a-b|^2 <= 4 max |x - mean|^2). Same
    width/2**warm_passes contract as everywhere."""
    n_loc, n = D_rows.shape
    idx, m_global = _local_row_idx(n_loc, axis_name, max_rows)
    D = D_rows[idx]
    edges = grid_edges(med_prev, hi_bound, brackets, g1)
    cdt = jnp.float32 if m_global * n >= 2 ** 31 else jnp.int32
    cnts = jnp.stack([jnp.sum(D <= t, dtype=cdt) for t in edges])
    return sharded_warm_from_grid(
        D, med_prev, cnts, hi_bound, axis_name,
        total=m_global * n, warm_passes=warm_passes,
        brackets=brackets, g1=g1,
    )


def _sharded_bisect_on_rows(Ds, axis_name, total, passes):
    """Shared core of the distributed bisect medians: every shard holds a
    row block ``Ds`` of the global sample (``total`` entries across the
    axis), counts locally, and psums so all shards bisect the same
    interval. The quad-ary round's three local counts batch into ONE psum
    (one collective per round instead of three)."""
    lo0 = jax.lax.pmin(jnp.minimum(jnp.min(Ds), 0.0), axis_name)
    hi0 = jax.lax.pmax(jnp.max(Ds), axis_name)

    def count_le(mid, cdt):
        return jax.lax.psum(jnp.sum(Ds <= mid, dtype=cdt), axis_name)

    def count_many(ts, cdt):
        local = jnp.stack([jnp.sum(Ds <= t, dtype=cdt) for t in ts])
        return jax.lax.psum(local, axis_name)

    return _bisect_search(count_le, total, lo0, hi0, passes,
                          count_many=count_many)


def sharded_bisect_median_on_D(D_rows, axis_name, max_rows=512, passes=30):
    """sharded_bisect_median for callers that already hold their exact
    local distance rows ``[n_loc, n]`` — the 2-D (particles x model) mesh
    step materialises D_rows after its model-axis Gram psum, so counting
    on it directly avoids recomputing any distance block.

    Counts run over a strided subsample of the local rows and psum over
    the PARTICLE axis only; D_rows must be replicated over any other mesh
    axes (it is, post-psum), so every shard bisects the same global
    interval and agrees on the result. Semantics: compute_median.py:4-16
    to fp-bisection resolution."""
    n_loc, n = D_rows.shape
    idx, m_global = _local_row_idx(n_loc, axis_name, max_rows)
    return _sharded_bisect_on_rows(D_rows[idx], axis_name,
                                   m_global * n, passes)


def ring_median_block(theta_loc, axis_name, max_rows=512):
    """Each shard's strided LOCAL-row subsample against ALL global
    columns, assembled by ring circulation (ppermute) instead of an
    all-gather — the ring layout's analogue of _sharded_row_block, with
    peak per-device extra footprint O(m_loc x n) for m_loc ~ max_rows /
    n_dev rows (a few MB) instead of the all-gather's O(n x p).

    Columns are written at their source shard's offset, so the block
    holds exactly the same entries as the all-gather block — and since
    threshold counts are order-invariant sums, every bisect/warm search
    on it is BITWISE-equal to its all-gather counterpart (same strided
    rows via _local_row_idx, same per-entry HIGHEST-precision dot).

    Returns (D_block [m_loc, n], total_global_entries)."""
    n_dev = jax.lax.axis_size(axis_name)
    n_loc = theta_loc.shape[0]
    n = n_loc * n_dev
    idx, m_global = _local_row_idx(n_loc, axis_name, max_rows)
    rows = theta_loc[idx]
    rsq_rows = jnp.sum(rows * rows, axis=1)
    rsq_loc = jnp.sum(theta_loc * theta_loc, axis=1)
    my = jax.lax.axis_index(axis_name)
    perm = [(j, (j + 1) % n_dev) for j in range(n_dev)]

    def body(r, carry):
        D, blk, blk_rsq = carry
        src = (my - r) % n_dev        # whose block we hold at rotation r
        D_blk = _row_block_sq_dists(rows, blk, rsq_rows, blk_rsq)
        col0 = (src * n_loc).astype(jnp.int32)
        D = jax.lax.dynamic_update_slice(
            D, D_blk, (jnp.zeros((), jnp.int32), col0)
        )
        blk = jax.lax.ppermute(blk, axis_name, perm)
        blk_rsq = jax.lax.ppermute(blk_rsq, axis_name, perm)
        return D, blk, blk_rsq

    D0 = jnp.zeros((rows.shape[0], n), theta_loc.dtype)
    D, _, _ = jax.lax.fori_loop(
        0, n_dev, body, (D0, theta_loc, rsq_loc)
    )
    return D, m_global * n


def ring_bisect_median(theta_loc, axis_name, max_rows=512, passes=30):
    """Distributed sort-free median for the RING sharded step: the
    strided-row block is assembled by ring circulation (ring_median_block)
    and the search counts psum — bitwise-equal to sharded_bisect_median
    on the same particles (identical entries, order-invariant counts)."""
    D, total = ring_median_block(theta_loc, axis_name, max_rows)
    return _sharded_bisect_on_rows(D, axis_name, total, passes)


def ring_warm_bisect_median(theta_loc, med_prev, axis_name, max_rows=512,
                            warm_passes=8, brackets=DEFAULT_BRACKETS):
    """Distributed warm_bisect_median for the RING sharded step —
    bitwise-equal to sharded_warm_bisect_median_on_D on the same particles
    (see ring_median_block), at ring-circulation memory cost."""
    D, total = ring_median_block(theta_loc, axis_name, max_rows)
    return _warm_search(D, med_prev, warm_passes, brackets,
                        axis_name=axis_name, total=total)


def ring_binned_median(theta_loc, axis_name, n_bins=2048, n_levels=2):
    """Distributed histogram-refinement median where the particle blocks
    circulate around the ring (ppermute) instead of being all-gathered —
    pairs with the ring kernel pass in parallel/sharded.py. Each shard
    accumulates the histogram of its local rows against every circulating
    column block; psum over the axis completes the n^2 coverage."""
    n_dev = jax.lax.axis_size(axis_name)
    n_loc = theta_loc.shape[0]
    n_total = n_loc * n_dev
    rsq_loc = jnp.sum(theta_loc * theta_loc, axis=1)

    max_rsq = jax.lax.pmax(jnp.max(rsq_loc), axis_name)
    hi0 = 4.0 * max_rsq + 1e-12
    lo0 = jnp.asarray(-1e-6, theta_loc.dtype) * (1.0 + hi0)

    total = n_total * n_total
    k_lo = (total + 1) // 2
    k_hi = total // 2 + 1
    perm = [(j, (j + 1) % n_dev) for j in range(n_dev)]

    def ring_hist(lo, hi):
        width = (hi - lo) / n_bins

        def body(i, carry):
            counts, blk_theta, blk_rsq = carry
            D = _row_block_sq_dists(theta_loc, blk_theta, rsq_loc, blk_rsq)
            b = jnp.clip(((D - lo) / width).astype(jnp.int32), 0, n_bins - 1)
            # Per-iteration int32 scatter then f32 accumulate: see
            # _block_histogram (direct f32 scatter saturates at 2^24 per
            # bin; int32 overflows across the full n^2 total).
            ints = jnp.zeros((n_bins,), jnp.int32).at[b.ravel()].add(1)
            counts = counts + ints.astype(jnp.float32)
            blk_theta = jax.lax.ppermute(blk_theta, axis_name, perm)
            blk_rsq = jax.lax.ppermute(blk_rsq, axis_name, perm)
            return counts, blk_theta, blk_rsq

        counts, _, _ = jax.lax.fori_loop(
            0, n_dev, body,
            (jnp.zeros((n_bins,), jnp.float32), theta_loc, rsq_loc),
        )
        return jax.lax.psum(counts, axis_name)

    def refine(lo, hi, k):
        cum = jnp.cumsum(ring_hist(lo, hi))
        b = jnp.searchsorted(
            cum, jnp.float32(k), side="left"
        ).astype(theta_loc.dtype)
        width = (hi - lo) / n_bins
        return lo + b * width, lo + (b + 1.0) * width

    lo_a, hi_a = lo0, hi0
    lo_b, hi_b = lo0, hi0
    for _ in range(n_levels):
        lo_a, hi_a = refine(lo_a, hi_a, k_lo)
        lo_b, hi_b = refine(lo_b, hi_b, k_hi)
    return 0.5 * ((lo_a + hi_a) * 0.5 + (lo_b + hi_b) * 0.5)
