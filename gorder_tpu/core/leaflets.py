"""Leaflet-assignment kernels.

Behavioral reference: src/analysis/leaflets.rs (8 methods, SURVEY.md §2.1).
Device-side methods (global / local / individual) are pure per-frame
computations over the batch; manual methods (from file / map / NDX) become
host-side per-assignment-frame lookup tables. Clustering methods live in
gorder_tpu/core/clustering.py.

Classes: 0 = upper, 1 = lower (matching the reference's Leaflet enum).

Frequency gating (`once` / `every N`) is implemented by the caller: the
kernel returns assignments for every frame of the batch; the caller gathers
the assignment-frame rows (the reference's cross-thread rendezvous becomes an
index map — SURVEY.md §7 "Frequency-gated leaflet reuse").

Index arrays are passed as device arguments (not closure constants) to keep
XLA compile times low; flags are the only static arguments.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

from ..parallel.context import put_const

from .pbc import circular_mean_cog, min_image, naive_cog


def _global_classify_impl(coords, box_diag, membrane_idx, head_idx, *,
                          normal_axis, handle_pbc):
    membrane = jnp.take(coords, membrane_idx, axis=1)      # (B, Nm, 3)
    mask = jnp.ones(membrane.shape[:-1], coords.dtype)
    if handle_pbc:
        center = circular_mean_cog(membrane, mask, box_diag)
    else:
        center = naive_cog(membrane, mask)
    heads = jnp.take(coords, head_idx, axis=1)             # (B, M, 3)
    delta = heads[..., normal_axis] - center[:, None, normal_axis]
    if handle_pbc:
        length = box_diag[:, None, normal_axis]
        delta = delta - length * jnp.round(delta / length)
    return jnp.where(delta >= 0, 0, 1).astype(jnp.int32)


_global_classify = jax.jit(
    _global_classify_impl, static_argnames=("normal_axis", "handle_pbc"))


def make_global_classifier(membrane_indices, head_indices, normal_axis,
                           handle_pbc=True):
    """Global method: head above/below the whole-membrane center of geometry
    along the normal axis."""
    membrane_d = put_const(np.asarray(membrane_indices, np.int32))
    heads_d = put_const(np.asarray(head_indices, np.int32))

    def classify(coords, box_diag):
        return _global_classify(coords, box_diag, membrane_d, heads_d,
                                normal_axis=int(normal_axis),
                                handle_pbc=handle_pbc)

    def impl(coords, box_diag):
        """Traceable body for fused per-batch programs."""
        return _global_classify_impl(coords, box_diag, membrane_d, heads_d,
                                     normal_axis=int(normal_axis),
                                     handle_pbc=handle_pbc)

    def channel_impl(heads, cog, box_diag):
        """Traceable classes from the b7 wire's side channels: heads
        (B, M, 3) f32 absolute positions (bit-identical to a coordinate
        gather — the aux channel ships the exact decode integers) and
        cog (B,) f32, the refined Bai-Breen membrane center along the
        normal axis computed by the decoder (native/xdr.cpp
        bai_breen_axis). Same sidedness test as _global_classify_impl."""
        delta = heads[..., int(normal_axis)] - cog[:, None]
        if handle_pbc:
            length = box_diag[:, None, int(normal_axis)]
            delta = delta - length * jnp.round(delta / length)
        return jnp.where(delta >= 0, 0, 1).astype(jnp.int32)

    def channel_coords_impl(coords, cog, box_diag):
        """Traceable classes from full coordinates + the decoder's COG
        channel: the coordinate-wire twin of channel_impl, so every wire
        format classifies against the SAME per-frame Bai-Breen center
        (native/xdr.cpp xtc_cog_axis) and the printed output is bitwise
        identical across wires. The gathered heads are bit-identical to
        the b7g aux channel (same decode integers, same dequantization)."""
        heads = jnp.take(coords, heads_d, axis=1)          # (B, M, 3)
        delta = heads[..., int(normal_axis)] - cog[:, None]
        if handle_pbc:
            length = box_diag[:, None, int(normal_axis)]
            delta = delta - length * jnp.round(delta / length)
        return jnp.where(delta >= 0, 0, 1).astype(jnp.int32)

    classify.impl = impl
    classify.channel_impl = channel_impl
    classify.channel_coords_impl = channel_coords_impl
    # (membrane slots, head slots, axis, pbc) for the decoder's channels
    classify.channel_info = (np.asarray(membrane_indices, np.int64),
                             np.asarray(head_indices, np.int64),
                             int(normal_axis), bool(handle_pbc))
    return classify


def _local_classify_impl(coords, box_diag, membrane_idx, head_idx, radius, *,
                         normal_axis, handle_pbc):
    plane_axes = tuple(a for a in range(3) if a != normal_axis)

    def per_frame(args):
        frame, box = args                                   # (A, 3), (3,)
        membrane = jnp.take(frame, membrane_idx, axis=0)    # (Nm, 3)
        heads = jnp.take(frame, head_idx, axis=0)           # (M, 3)
        d = membrane[None, :, :] - heads[:, None, :]        # (M, Nm, 3)
        if handle_pbc:
            d = min_image(d, box[None, None, :])
        d_plane2 = d[..., plane_axes[0]] ** 2 + d[..., plane_axes[1]] ** 2
        weights = (d_plane2 <= radius * radius).astype(frame.dtype)  # (M,Nm)

        if handle_pbc:
            theta = membrane[:, normal_axis] / box[normal_axis] \
                * (2.0 * jnp.pi)                            # (Nm,)
            xi = weights @ jnp.cos(theta)
            zeta = weights @ jnp.sin(theta)
            mean_theta = jnp.arctan2(-zeta, -xi) + jnp.pi
            center_z = mean_theta / (2.0 * jnp.pi) * box[normal_axis]
            delta = heads[:, normal_axis] - center_z
            delta = delta - box[normal_axis] * jnp.round(delta / box[normal_axis])
        else:
            total = weights @ membrane[:, normal_axis]
            count = jnp.maximum(weights.sum(axis=-1), 1e-30)
            delta = heads[:, normal_axis] - total / count
        return jnp.where(delta >= 0, 0, 1).astype(jnp.int32)

    # sequential over frames: bounds the O(M·Nm) working set to one frame
    return jax.lax.map(per_frame, (coords, box_diag))


_local_classify = jax.jit(
    _local_classify_impl, static_argnames=("normal_axis", "handle_pbc"))


def make_local_classifier(membrane_indices, head_indices, normal_axis,
                          radius, handle_pbc=True):
    """Local method: reference center = center of geometry of membrane atoms
    within an in-plane cylinder around each head.

    The reference accelerates this with a cell grid; on the device an O(M·Nm)
    masked reduction is one dense fused pass (SURVEY.md §2.6 item 5)."""
    membrane_d = put_const(np.asarray(membrane_indices, np.int32))
    heads_d = put_const(np.asarray(head_indices, np.int32))
    radius_d = jnp.float32(radius)

    def classify(coords, box_diag):
        return _local_classify(coords, box_diag, membrane_d, heads_d,
                               radius_d, normal_axis=int(normal_axis),
                               handle_pbc=handle_pbc)

    def impl(coords, box_diag):
        """Traceable body for fused per-batch programs."""
        return _local_classify_impl(coords, box_diag, membrane_d, heads_d,
                                    radius_d, normal_axis=int(normal_axis),
                                    handle_pbc=handle_pbc)

    classify.impl = impl
    return classify


def _individual_classify_impl(coords, box_diag, head_idx, methyl_idx,
                              methyl_mol, onehot, *, normal_axis,
                              handle_pbc):
    heads = jnp.take(coords, head_idx, axis=1)             # (B, M, 3)
    methyls = jnp.take(coords, methyl_idx, axis=1)         # (B, K, 3)
    head_of_methyl = jnp.take(heads, methyl_mol, axis=1)   # (B, K, 3)
    delta = head_of_methyl[..., normal_axis] - methyls[..., normal_axis]
    if handle_pbc:
        length = box_diag[:, None, normal_axis]
        delta = delta - length * jnp.round(delta / length)
    total = jnp.einsum("bk,km->bm", delta, onehot)         # (B, M)
    return jnp.where(total >= 0, 0, 1).astype(jnp.int32)


_individual_classify = jax.jit(
    _individual_classify_impl, static_argnames=("normal_axis", "handle_pbc"))


def make_individual_classifier(head_indices, methyl_indices, methyl_mol,
                               n_molecules, normal_axis, handle_pbc=True):
    """Individual method: sign of the summed wrapped (head − methyl)
    distance along the normal (leaflets.rs Individual)."""
    heads_d = put_const(np.asarray(head_indices, np.int32))
    methyls_d = put_const(np.asarray(methyl_indices, np.int32))
    mol_d = put_const(np.asarray(methyl_mol, np.int32))
    onehot = np.zeros((len(methyl_indices), n_molecules), np.float32)
    onehot[np.arange(len(methyl_indices)), np.asarray(methyl_mol)] = 1.0
    onehot_d = put_const(onehot)

    def classify(coords, box_diag):
        return _individual_classify(coords, box_diag, heads_d, methyls_d,
                                    mol_d, onehot_d,
                                    normal_axis=int(normal_axis),
                                    handle_pbc=handle_pbc)

    def impl(coords, box_diag):
        """Traceable body for fused per-batch programs."""
        return _individual_classify_impl(
            coords, box_diag, heads_d, methyls_d, mol_d, onehot_d,
            normal_axis=int(normal_axis), handle_pbc=handle_pbc)

    classify.impl = impl
    # wire-slot atom demand for the b7 aux side channel: classification
    # consumes only head + methyl positions (a few per molecule), so a b7
    # run ships those instead of full coordinates (analysis engine b7x
    # path; reference leaflets.rs Individual)
    classify.aux_info = {
        "atoms": np.unique(np.concatenate([
            np.asarray(head_indices, np.int64),
            np.asarray(methyl_indices, np.int64)])),
        "rebuild": lambda pos_of: make_individual_classifier(
            pos_of(np.asarray(head_indices, np.int64)),
            pos_of(np.asarray(methyl_indices, np.int64)),
            methyl_mol, n_molecules, normal_axis, handle_pbc),
    }
    return classify
