"""Clustering-based leaflet classification.

Behavioral reference: src/analysis/clustering.rs (spectral) and
src/analysis/spherical_clustering.rs (1-D GMM).

Spectral: similarity W = exp(−σ d²) over head-group atoms, normalized
Laplacian I − D^{-1/2} W D^{-1/2}, the two smallest non-trivial eigenvectors
row-normalized, k-means(k=2) with first-two-rows init. The reference runs a
"precise" dense path for ≤5000 heads and a Lanczos "sloppy" heuristic with
retries above; on the device the dense eigendecomposition is cheap at these
sizes, so the precise path runs always (deterministic — the retry/validation
machinery and its nondeterministic seed vector disappear, SURVEY.md §7
step 9). Cluster→leaflet identity is resolved on the host: ab initio on the
first assignment frame (larger cluster = upper; tie → the cluster holding
the lowest head index), then ≥80% membership overlap with the previous
assignment (clustering.rs classify_by_match).

Spherical: distances of heads from their center of geometry → two-component
1-D GMM fit by EM (percentile init, log-sum-exp, variance/weight floors);
the component with the larger mean distance (outer shell) is the upper
leaflet.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..parallel.context import put_const

from ..errors import ClusterError
from .pbc import circular_mean_cog, min_image, naive_cog

PRECISE_SIGMA = 1.0
CLASSIFICATION_LIMIT = 0.8
KMEANS_ITERS = 100
GMM_MAX_ITERATIONS = 50
GMM_TOLERANCE = 1e-4


def _pairwise_sq_distances(points, box, handle_pbc):
    d = points[:, None, :] - points[None, :, :]
    if handle_pbc:
        d = min_image(d, box[None, None, :])
    return jnp.sum(d * d, axis=-1)


def _kmeans2(embedding):
    """Deterministic k-means with k=2.

    The reference initializes centroids with the first two rows
    (clustering.rs:632-636), which degenerates when the first two heads sit
    in the same leaflet AND one cluster is a tight point mass while the
    other spreads over an arc of the row-normalized embedding (leaflets of
    very different connectivity — e.g. vesicle shells). Farthest-point
    initialization (c0 = row 0, c1 = the row farthest from it) is equally
    deterministic, picks the same bipartition on well-separated membranes,
    and stays correct in the degenerate geometries."""
    c0_init = embedding[0]
    far = jnp.argmax(jnp.sum((embedding - c0_init) ** 2, axis=1))
    init = jnp.stack([c0_init, embedding[far]])

    def body(_, centroids):
        d0 = jnp.sum((embedding - centroids[0]) ** 2, axis=1)
        d1 = jnp.sum((embedding - centroids[1]) ** 2, axis=1)
        labels = (d1 < d0).astype(jnp.float32)          # 1 → cluster 1
        w1 = labels[:, None]
        w0 = 1.0 - w1
        c0 = jnp.sum(embedding * w0, axis=0) / jnp.maximum(w0.sum(), 1.0)
        c1 = jnp.sum(embedding * w1, axis=0) / jnp.maximum(w1.sum(), 1.0)
        # empty-cluster fallback: first data point
        c0 = jnp.where(w0.sum() > 0, c0, embedding[0])
        c1 = jnp.where(w1.sum() > 0, c1, embedding[0])
        return jnp.stack([c0, c1])

    centroids = jax.lax.fori_loop(
        0, KMEANS_ITERS, body, init)
    d0 = jnp.sum((embedding - centroids[0]) ** 2, axis=1)
    d1 = jnp.sum((embedding - centroids[1]) ** 2, axis=1)
    return (d1 < d0).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("handle_pbc",))
def _spectral_labels(coords, box_diag, head_idx, *, handle_pbc):
    """(B, A, 3) → (B, M) raw k-means cluster labels per frame."""

    def per_frame(args):
        frame, box = args
        heads = jnp.take(frame, head_idx, axis=0)
        d2 = _pairwise_sq_distances(heads, box, handle_pbc)
        w = jnp.exp(-PRECISE_SIGMA * d2)
        degree = jnp.sum(w, axis=1)
        d_inv_sqrt = jnp.where(degree > 1e-10, 1.0 / jnp.sqrt(degree), 0.0)
        # top-3 eigenvectors of the normalized similarity S = D^-1/2 W
        # D^-1/2 — the same subspace as the 3 smallest of the normalized
        # Laplacian I − S the reference uses (clustering.rs:586-611).
        # The reference skips "the first eigenvector since it is zero"
        # (clustering.rs:457, 483-487) — but when the two leaflets are
        # spectrally near-disconnected the top space is nearly 2-D and an
        # f32 eigensolver may return ANY rotation of it, leaving the
        # inter-leaflet indicator inside the skipped vector. Deflate the
        # ANALYTIC top vector v0 = D^{1/2}·1 from the retained span
        # instead, and take the two principal directions of the
        # remainder — the same 2-D embedding space the reference
        # intends, independent of eigenbasis rotation.
        s_mat = w * d_inv_sqrt[:, None] * d_inv_sqrt[None, :]
        v0 = jnp.sqrt(jnp.maximum(degree, 0.0))
        v0 = v0 / jnp.maximum(jnp.linalg.norm(v0), 1e-30)
        n = heads.shape[0]
        _, vecs = jnp.linalg.eigh(jnp.eye(n) - s_mat)
        span = vecs[:, :3]
        span = span - v0[:, None] * (v0 @ span)[None, :]
        u, _, _ = jnp.linalg.svd(span, full_matrices=False)
        embedding = _rayleigh_weighted(u[:, :2],
                                       lambda v: v - s_mat @ v)
        return _kmeans2(embedding)

    return jax.lax.map(per_frame, (coords, box_diag))


def _rayleigh_weighted(u2, lap):
    """Rayleigh–Ritz the normalized Laplacian within the deflated 2-D
    span, then shrink the higher-energy direction by √(λ₁/λ₂) before
    row normalization.

    The deflated span's SVD basis is an ARBITRARY rotation of its two
    directions (their singular values are equal by construction), so
    the inter-cluster INDICATOR — the direction with near-zero
    Laplacian energy; an exact null vector for spectrally disconnected
    leaflets — generally arrives mixed with an intra-sheet mode of
    strictly positive energy. Diagonalizing the 2×2 restriction
    H = U₂ᵀ(I−S)U₂ separates them exactly, regardless of basis
    rotation. Row-normalizing equal-weight columns then lets k-means
    latch onto the in-sheet mode — observed live on a flat synthetic
    bilayer: one frame in thousands produced an orthogonal split that
    failed the ≥80 % frame-to-frame match (SpectralOrienter).
    Energy-weighting keeps the indicator dominant exactly when the
    spectrum says it should be, and leaves genuinely
    two-null-direction geometries (e.g. vesicle shells, where both
    retained directions have ~zero energy) untouched — λ₁ ≈ λ₂ →
    weight ≈ 1, the reference's equal-weight embedding."""
    l0 = lap(u2[:, 0])
    l1 = lap(u2[:, 1])
    h00 = jnp.vdot(u2[:, 0], l0)
    h01 = jnp.vdot(u2[:, 0], l1)
    h11 = jnp.vdot(u2[:, 1], l1)
    h = jnp.stack([jnp.stack([h00, h01]), jnp.stack([h01, h11])])
    lam, q = jnp.linalg.eigh(h)                       # ascending
    v = u2 @ q
    lam = jnp.maximum(lam, 1e-9)
    w = jnp.sqrt(lam[0] / lam[1])                     # ≤ 1
    embedding = jnp.stack([v[:, 0], v[:, 1] * w], axis=1)
    norm = jnp.sqrt(jnp.sum(embedding ** 2, axis=1, keepdims=True))
    return jnp.where(norm > 1e-10, embedding / norm, embedding)


# dense spectral clustering holds an (n, n) similarity matrix and runs a
# full eigh — fine at membrane sizes (the reference's precise path caps at
# 5000 heads and falls back to a heuristic Lanczos). Larger systems switch
# to the Nyström landmark path below: O(n · m) memory, dense matrix
# products, no (n, n) matrix — the replacement for the reference's
# sparse-Lanczos
# "sloppy" regime (clustering.rs:163-246, src/lanczos/) including its
# determinism problem: landmarks are stride-sampled, not random.
DENSE_CLUSTER_HEADS = 20_000
NYSTROM_LANDMARKS = 1024
# rank clip for the landmark-similarity eigendecomposition: directions
# below this fraction of the top eigenvalue are treated as numerically
# null (genuinely redundant landmarks)
NYSTROM_RANK_TOL = 1e-6


@functools.partial(jax.jit, static_argnames=("handle_pbc",))
def _spectral_labels_nystrom(coords, box_diag, head_idx, landmark_pos, *,
                             handle_pbc):
    """(B, A, 3) → (B, M) k-means labels via a Nyström spectral embedding.

    W ≈ C W_LL⁻¹ Cᵀ with C = exp(−σ d²(heads, landmarks)): degrees,
    normalization and the leading eigenvectors of the normalized
    similarity all follow from (n, m) and (m, m) dense algebra — bounded
    memory, arbitrary n. The embedding then goes through the same
    null-deflation + principal-direction + k-means pipeline as the dense
    path."""

    def per_frame(args):
        frame, box = args
        heads = jnp.take(frame, head_idx, axis=0)          # (n, 3)
        marks = jnp.take(heads, landmark_pos, axis=0)      # (m, 3)
        d = heads[:, None, :] - marks[None, :, :]
        if handle_pbc:
            d = min_image(d, box[None, None, :])
        c = jnp.exp(-PRECISE_SIGMA * jnp.sum(d * d, axis=-1))   # (n, m)
        w_ll = jnp.take(c, landmark_pos, axis=0)           # (m, m)
        t = jnp.sum(c, axis=0)                              # Cᵀ·1, (m,)

        # W_LL^{-1/2} through its eigendecomposition,
        # clipping numerically-null directions (landmark redundancy)
        s, e = jnp.linalg.eigh(w_ll)
        s_max = jnp.max(s)
        good = s > NYSTROM_RANK_TOL * s_max
        inv_sqrt_v = jnp.where(
            good, 1.0 / jnp.sqrt(jnp.maximum(s, 1e-30)), 0.0)
        inv_v = jnp.where(good, 1.0 / jnp.maximum(s, 1e-30), 0.0)
        # approximate degrees: d̂ = C W_LL⁻¹ Cᵀ 1
        degree = c @ (e @ (inv_v * (e.T @ t)))          # (n,)
        degree = jnp.maximum(degree, 1e-10)
        b = c * (1.0 / jnp.sqrt(degree))[:, None]       # D^{-1/2} C
        r = b @ (e * inv_sqrt_v[None, :])               # (n, m)
        g = r.T @ r
        mu, q = jnp.linalg.eigh(g)                      # ascending
        top = q[:, -3:]                                 # 3 largest
        mu_top = jnp.maximum(mu[-3:], 1e-12)
        u = (r @ top) * (1.0 / jnp.sqrt(mu_top))[None, :]   # (n, 3)

        # same rotation-robust, energy-weighted embedding as the dense
        # path (S ≈ R Rᵀ, so (I − S)v ≈ v − R(Rᵀv))
        v0 = jnp.sqrt(jnp.maximum(degree, 0.0))
        v0 = v0 / jnp.maximum(jnp.linalg.norm(v0), 1e-30)
        span = u - v0[:, None] * (v0 @ u)[None, :]
        uu, _, _ = jnp.linalg.svd(span, full_matrices=False)
        embedding = _rayleigh_weighted(uu[:, :2],
                                       lambda v: v - r @ (r.T @ v))
        return _kmeans2(embedding)

    return jax.lax.map(per_frame, (coords, box_diag))


def make_spectral_labels(head_indices, handle_pbc=True):
    head_indices = np.asarray(head_indices)
    head_d = put_const(head_indices.astype(np.int32))
    n = len(head_indices)

    if n <= DENSE_CLUSTER_HEADS:
        def compute(coords, box_diag):
            return _spectral_labels(coords, box_diag, head_d,
                                    handle_pbc=handle_pbc)

        return compute

    # deterministic stride-sampled landmarks (positions into the head list)
    m = min(NYSTROM_LANDMARKS, n)
    landmark_pos = np.unique(
        np.linspace(0, n - 1, m).round().astype(np.int64))
    landmark_d = put_const(landmark_pos.astype(np.int32))

    def compute(coords, box_diag):
        return _spectral_labels_nystrom(coords, box_diag, head_d,
                                        landmark_d, handle_pbc=handle_pbc)

    return compute


class SpectralOrienter:
    """Sequential cluster→leaflet identity across assignment frames."""

    def __init__(self, head_indices):
        self.head_indices = np.asarray(head_indices)
        self.prev_upper = None   # (M,) bool

    def orient(self, labels: np.ndarray) -> np.ndarray:
        """raw (M,) k-means labels → (M,) classes (0 upper, 1 lower)."""
        c1 = labels == 0
        c2 = ~c1
        if self.prev_upper is None:
            n1, n2 = int(c1.sum()), int(c2.sum())
            if n1 > n2:
                upper = c1
            elif n2 > n1:
                upper = c2
            else:
                # tie: the cluster holding the lowest head atom index
                first = int(np.argmin(self.head_indices))
                upper = c1 if c1[first] else c2
        else:
            overlap_upper = (c1 & self.prev_upper).sum() / max(c1.sum(), 1)
            overlap_lower = (c1 & ~self.prev_upper).sum() / max(c1.sum(), 1)
            if (overlap_upper < CLASSIFICATION_LIMIT
                    and overlap_lower < CLASSIFICATION_LIMIT):
                # wording: src/errors.rs:531-537
                # (ClusterError::CouldNotMatchLeaflets); "number of
                # threads" reads "number of devices" in this architecture
                pct = int(CLASSIFICATION_LIMIT * 100)
                raise ClusterError(
                    f"clustering leaflet classification failed\ndetails: "
                    f"when comparing current frame to previous frame, the "
                    f"previously identified leaflets show >{pct}% lipid "
                    f"composition change\nhint: this may be caused by "
                    f"either of several issues:\n  - leaflets identified "
                    f"incorrectly => consider manual leaflet assignment,\n"
                    f"  - too rapid flip-flop => increase classification "
                    f"frequency,\n  - frames too far apart => increase "
                    f"classification frequency")
            upper = c1 if overlap_upper >= overlap_lower else c2
        self.prev_upper = upper
        return np.where(upper, 0, 1).astype(np.int32)


# ------------------------------------------------------------------ spherical


def _spherical_classes_impl(coords, box_diag, head_idx, *, handle_pbc):
    """(B, A, 3) → (B, M) classes (0 = outer/upper, 1 = inner/lower)."""

    def per_frame(args):
        frame, box = args
        heads = jnp.take(frame, head_idx, axis=0)      # (M, 3)
        mask = jnp.ones(heads.shape[:-1], frame.dtype)
        if handle_pbc:
            center = circular_mean_cog(heads[None], mask[None], box[None])[0]
        else:
            center = naive_cog(heads[None], mask[None])[0]
        rel = heads - center
        if handle_pbc:
            rel = min_image(rel, box[None, :])
        dist = jnp.sqrt(jnp.sum(rel * rel, axis=-1))   # (M,)

        # GMM init: 25th/75th percentile means, global variance
        sorted_d = jnp.sort(dist)
        n = dist.shape[0]
        mean_a0 = sorted_d[n // 4]
        mean_b0 = sorted_d[(3 * n) // 4]
        gmean = jnp.mean(dist)
        gvar = jnp.maximum(jnp.var(dist, ddof=1), 1e-6)

        def em(_, state):
            w_a, m_a, v_a, m_b, v_b = state
            log_w_a = jnp.log(w_a)
            log_w_b = jnp.log(1.0 - w_a)

            def log_gauss(x, m, v):
                return -0.5 * (jnp.log(2.0 * jnp.pi) + jnp.log(v)
                               + (x - m) ** 2 / v)

            ja = log_w_a + log_gauss(dist, m_a, v_a)
            jb = log_w_b + log_gauss(dist, m_b, v_b)
            mx = jnp.maximum(ja, jb)
            log_px = mx + jnp.log(jnp.exp(ja - mx) + jnp.exp(jb - mx))
            resp_a = jnp.exp(ja - log_px)

            sum_a = jnp.maximum(resp_a.sum(), 1e-6)
            sum_b = jnp.maximum(n - resp_a.sum(), 1e-6)
            w_a = jnp.clip(sum_a / n, 1e-4, 1.0 - 1e-4)
            m_a = jnp.sum(resp_a * dist) / sum_a
            m_b = jnp.sum((1.0 - resp_a) * dist) / sum_b
            v_a = jnp.maximum(
                jnp.sum(resp_a * (dist - m_a) ** 2) / sum_a, 1e-6)
            v_b = jnp.maximum(
                jnp.sum((1.0 - resp_a) * (dist - m_b) ** 2) / sum_b, 1e-6)
            return (w_a, m_a, v_a, m_b, v_b)

        state = jax.lax.fori_loop(
            0, GMM_MAX_ITERATIONS, em,
            (jnp.float32(0.5), mean_a0, gvar, mean_b0, gvar))
        w_a, m_a, v_a, m_b, v_b = state
        ja = jnp.log(w_a) - 0.5 * (jnp.log(2 * jnp.pi) + jnp.log(v_a)
                                   + (dist - m_a) ** 2 / v_a)
        jb = jnp.log(1 - w_a) - 0.5 * (jnp.log(2 * jnp.pi) + jnp.log(v_b)
                                       + (dist - m_b) ** 2 / v_b)
        mx = jnp.maximum(ja, jb)
        resp_a = jnp.exp(ja - (mx + jnp.log(jnp.exp(ja - mx)
                                            + jnp.exp(jb - mx))))
        in_a = resp_a >= 0.5
        # outer shell (larger mean distance) = upper leaflet
        a_is_outer = m_a >= m_b
        upper = jnp.where(a_is_outer, in_a, ~in_a)
        return jnp.where(upper, 0, 1).astype(jnp.int32)

    return jax.lax.map(per_frame, (coords, box_diag))


_spherical_classes = jax.jit(
    _spherical_classes_impl, static_argnames=("handle_pbc",))


def make_spherical_classifier(head_indices, handle_pbc=True):
    head_d = put_const(np.asarray(head_indices, np.int32))

    def classify(coords, box_diag):
        return _spherical_classes(coords, box_diag, head_d,
                                  handle_pbc=handle_pbc)

    def impl(coords, box_diag):
        """Traceable body for fused per-batch programs (the GMM EM is
        pure lax device code)."""
        return _spherical_classes_impl(coords, box_diag, head_d,
                                       handle_pbc=handle_pbc)

    classify.impl = impl
    return classify
