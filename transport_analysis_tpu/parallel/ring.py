"""Ring-distributed windowed lag correlation (sequence parallelism).

The frame axis is this framework's "sequence" (SURVEY.md §5). For
windowed (exact, non-FFT) correlations at frame counts that exceed one
chip, the trajectory is sharded into B contiguous frame blocks across a
mesh axis, and block pairs exchange around a ring of devices:

    round k (k = 0..B-1):
      every device holds its own block X_i and a visiting block X_j,
      j = i + k (non-cyclic — rounds where j ≥ B contribute nothing);
      it accumulates the pair's cross-correlation into the lag window
      [kL-L+1, kL+L-1]; then the visiting block moves one hop
      (jax.lax.ppermute) around the ring.

Every lag 0..N-1 receives contributions from exactly the frame pairs
the serial algorithm uses, so after the final psum the result is
bit-comparable to the single-device windowed kernel. Communication is
nearest-neighbor only (``ppermute``), compute is O(N²/B) per
device — the distributed analogue of the reference's O(N²) lag loop
(reference velocityautocorr.py:223-235).

``mode='acf'`` accumulates v·v lag products (VACF); ``mode='einstein'``
accumulates (A_i − A_j)² differences (Helfand/MSD).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def _pair_accumulate(out, x_local, x_visit, k, L, N, mode, sum_d):
    """Add block-pair (i, i+k) contributions into the (N, P) lag sums.

    For round k the pair covers lags kL+δ, δ ∈ (-L, L). Computed as a
    fori_loop over the 2L-1 shifts of the visiting block against the
    local block.
    """
    # pad the visiting block so shift indexing is static-length
    pad = jnp.zeros((L, *x_visit.shape[1:]), x_visit.dtype)
    xv = jnp.concatenate([pad, x_visit, pad], axis=0)  # (3L, P, d)

    def body(s, out):
        # shift s ∈ [0, 2L-1] ↔ δ = s - (L-1); lag = kL + δ
        delta = s - (L - 1)
        lag = k * L + delta
        # products of x_local[a] with x_visit[a + δ] for valid a
        window = jax.lax.dynamic_slice_in_dim(xv, s + 1, L, axis=0)
        if mode == "acf":
            prod = jnp.sum(x_local * window, axis=-1)  # (L, P)
        else:  # einstein: squared difference
            diff = x_local - window
            prod = jnp.sum(diff * diff, axis=-1)
            if not sum_d:
                prod = prod / x_local.shape[-1]
        # mask invalid rows: visiting entries outside [0, L) pre-pad,
        # i.e. a + δ outside the real block, are zero-padded already —
        # but for 'einstein' zero-padding corrupts (x-0)². Mask rows.
        a = jnp.arange(L)
        valid = (a + delta >= 0) & (a + delta < L)
        # also drop δ<0 in round 0 (those pairs belong to lag<0 / are
        # the transpose of δ>0) and any lag outside [0, N)
        valid_round = jnp.logical_and(lag >= 0, lag < N)
        valid_round = jnp.logical_and(valid_round, (k > 0) | (delta >= 0))
        prod = jnp.where(
            (valid & valid_round)[:, None], prod, 0.0
        )
        contrib = jnp.sum(prod, axis=0)  # (P,)
        safe_lag = jnp.clip(lag, 0, N - 1)
        add = jnp.where(valid_round, contrib, 0.0)
        return out.at[safe_lag].add(add)

    return jax.lax.fori_loop(0, 2 * L - 1, body, out)


def _ring_kernel(x, n_frames, axis_name, mode, sum_d):
    """shard_map body: x is the local (L, P, d) block."""
    L = x.shape[0]
    B = jax.lax.psum(1, axis_name)
    i = jax.lax.axis_index(axis_name)
    N = n_frames
    out = jnp.zeros((N, x.shape[1]), x.dtype)

    # ring schedule: visiting block starts as our own (k=0) and then
    # hops backward so that at round k we hold block i+k
    perm = [(d, (d - 1) % B) for d in range(B)]

    def round_body(k, carry):
        out, visit = carry
        # block index we currently hold: j = i + k (mod B); contributions
        # only count when i + k < B (non-cyclic upper-triangular pairs)
        j_valid = (i + k) < B
        contrib = _pair_accumulate(
            jnp.zeros_like(out), x, visit, k, L, N, mode, sum_d
        )
        out = out + jnp.where(j_valid, 1.0, 0.0) * contrib
        visit = jax.lax.ppermute(visit, axis_name, perm)
        return out, visit

    out, _ = jax.lax.fori_loop(0, B, round_body, (out, x))
    # every device computed partial sums for disjoint pair sets →
    # all-reduce over the ring axis
    return jax.lax.psum(out, axis_name)


def windowed_correlation_ring(
    x,
    mesh: Mesh,
    axis_name: str = "frames",
    mode: str = "acf",
    sum_d: bool = True,
):
    """Distributed exact windowed correlation over a frame-sharded block.

    Parameters
    ----------
    x : (N, P, d) array; N must divide evenly by the mesh axis size.
    mesh : jax.sharding.Mesh containing ``axis_name``.
    mode : 'acf' (lag products) or 'einstein' (squared lag differences).
    sum_d : sum components (VACF/MSD) vs average them (Helfand).

    Returns
    -------
    (N, P) per-lag *means*: sums / (N - lag), matching ops.acf_windowed
    / ops.einstein_difference_windowed.
    """
    from jax import shard_map

    x = jnp.asarray(x)
    N = x.shape[0]
    B = mesh.shape[axis_name]
    if N % B:
        raise ValueError(
            f"n_frames={N} must be divisible by mesh axis {axis_name}={B}"
        )

    pspec_in = P(axis_name, *([None] * (x.ndim - 1)))
    pspec_out = P(*([None] * 2))

    fn = shard_map(
        partial(
            _ring_kernel,
            n_frames=N,
            axis_name=axis_name,
            mode=mode,
            sum_d=sum_d,
        ),
        mesh=mesh,
        in_specs=(pspec_in,),
        out_specs=pspec_out,
        check_vma=False,
    )
    x_sharded = jax.device_put(x, NamedSharding(mesh, pspec_in))
    sums = fn(x_sharded)
    norm = (N - jnp.arange(N, dtype=x.dtype))[:, None]
    out = sums / norm
    if mode == "einstein":
        out = out.at[0].set(0.0)
    return out
