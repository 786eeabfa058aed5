"""Membrane-normal estimation.

Behavioral reference: src/analysis/normal.rs — Static (axis), Dynamic
(per-molecule per-frame PCA of the local head-group cloud,
membrane_normal_from_cloud :421-458), Manual (per-frame per-molecule vectors).

Dynamic normals on the device: for every molecule, the cloud is every atom of the
normal-heads selection within `radius` of the molecule's head (min-image
relative positions are whole by construction); the smallest principal axis
comes from a closed-form batched 3x3 eigendecomposition of the masked
covariance — no per-molecule SVDs, no cell grids (SURVEY.md §7 step 6).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..parallel.context import put_const

from .pbc import min_image


def _smallest_eigvec_3x3(cov):
    """(..., 3, 3) symmetric → (..., 3) unit eigenvector of the smallest
    eigenvalue (jnp.linalg.eigh ascending order)."""
    _, vecs = jnp.linalg.eigh(cov)
    return vecs[..., :, 0]


def _dynamic_normals_impl(coords, box_diag, head_idx, cloud_idx, radius, *,
                          handle_pbc):
    """(B, A, 3) coords → (B, M, 3) unit normals (+ (B, M) cloud sizes)."""

    def per_frame(args):
        frame, box = args
        heads = jnp.take(frame, head_idx, axis=0)       # (M, 3)
        cloud = jnp.take(frame, cloud_idx, axis=0)      # (C, 3)
        rel = cloud[None, :, :] - heads[:, None, :]     # (M, C, 3)
        if handle_pbc:
            rel = min_image(rel, box[None, None, :])
        d2 = jnp.sum(rel * rel, axis=-1)                # (M, C)
        mask = (d2 <= radius * radius).astype(frame.dtype)
        count = jnp.sum(mask, axis=-1)                  # (M,)
        weights = mask / jnp.maximum(count, 1.0)[:, None]
        centroid = jnp.einsum("mc,mcd->md", weights, rel)
        centered = (rel - centroid[:, None, :]) * mask[..., None]
        cov = jnp.einsum("mcd,mce->mde", centered, centered)
        normal = _smallest_eigvec_3x3(cov)
        return normal, count

    return jax.lax.map(per_frame, (coords, box_diag))


_dynamic_normals = jax.jit(
    _dynamic_normals_impl, static_argnames=("handle_pbc",))


def make_dynamic_normals(head_indices, cloud_indices, radius,
                         handle_pbc=True):
    head_d = put_const(np.asarray(head_indices, np.int32))
    cloud_d = put_const(np.asarray(cloud_indices, np.int32))
    radius_d = jnp.float32(radius)

    def compute(coords, box_diag):
        return _dynamic_normals(coords, box_diag, head_d, cloud_d, radius_d,
                                handle_pbc=handle_pbc)

    def impl(coords, box_diag):
        """Traceable body for fused per-batch programs."""
        return _dynamic_normals_impl(coords, box_diag, head_d, cloud_d,
                                     radius_d, handle_pbc=handle_pbc)

    compute.impl = impl
    # wire-slot atom demand for the b7 aux side channel: the PCA consumes
    # only the normal-heads cloud (~hundreds of atoms), so a b7 run ships
    # cloud positions instead of full coordinates (analysis engine b7x
    # path; reference normal.rs:179-199 builds the same heads cloud)
    compute.aux_info = {
        "atoms": np.asarray(cloud_indices, np.int64),
        "rebuild": lambda pos_of: make_dynamic_normals(
            pos_of(np.asarray(head_indices, np.int64)),
            pos_of(np.asarray(cloud_indices, np.int64)),
            radius, handle_pbc),
    }
    return compute
