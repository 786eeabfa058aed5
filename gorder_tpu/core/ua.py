"""United-atom virtual-hydrogen kernel.

Behavioral reference: src/analysis/uaorder.rs — buildH-style hydrogen
reconstruction (constants :35-41, prediction :944-1106) and per-atom virtual
bond accumulation. Re-architected for batched execution: atoms are grouped by kind
(CH3 / CH2 / CH1-unsaturated / CH1-saturated) into flat index arrays; each
kind's hydrogens are reconstructed for the whole frame batch with vectorized
Rodrigues rotations, then every virtual C-H sample flows through the same
quantize + one-hot-matmul reduction as real bonds (core/order.py).

Parity notes:
- the reference's bond position for geometry/ordermaps is
  `hydrogen + (hydrogen - target)/2` (uaorder.rs:386) — reproduced verbatim;
- rotations and normalizations in f32 like the reference (nalgebra f32).
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from ..parallel.context import put_const

from .order import limb_reduce, quantize_split
from .pbc import min_image

TETRAHEDRAL_ANGLE = np.float32(1.910633)
TETRAHEDRAL_ANGLE_HALF = np.float32(0.9553165)
BOND_LENGTH = np.float32(0.109)
CH3_ANGLE = np.float32(2.0943952)


def _gather(coords, idx):
    return jnp.take(coords, idx, axis=1)


def _planarize(*vs):
    """(..., 3) arrays → planar (x, y, z) tuples."""
    return [tuple(v[..., i] for i in range(3)) if v is not None else None
            for v in vs]


def _restack(planar_list):
    return [jnp.stack(p, axis=-1) for p in planar_list]


def predict_ch3(t, h1, h2, box, handle_pbc):
    """(..., 3) target/helper positions → 3 hydrogen positions.

    Vector-layout wrapper over the planar production formulation below
    (one formulation, no drift)."""
    tp, h1p, h2p, boxp = _planarize(t, h1, h2, box)
    return _restack(predict_ch3_planar(tp, h1p, h2p, boxp, handle_pbc))


def predict_ch2(t, h1, h2, box, handle_pbc):
    tp, h1p, h2p, boxp = _planarize(t, h1, h2, box)
    return _restack(predict_ch2_planar(tp, h1p, h2p, boxp, handle_pbc))


def predict_ch1_unsaturated(t, h1, h2, box, handle_pbc):
    tp, h1p, h2p, boxp = _planarize(t, h1, h2, box)
    return _restack(
        predict_ch1_unsaturated_planar(tp, h1p, h2p, boxp, handle_pbc))


def predict_ch1_saturated(t, h1, h2, h3, box, handle_pbc):
    tp, h1p, h2p, h3p, boxp = _planarize(t, h1, h2, h3, box)
    return _restack(
        predict_ch1_saturated_planar(tp, h1p, h2p, h3p, boxp, handle_pbc))


# ---------------------------------------------------------------------------
# Planar (structure-of-arrays) formulation — the production path.
#
# A vector-layout formulation operates on (..., 3) arrays whose minor
# dimension is 3, so elementwise work is strided over a size-3 axis. The
# planar formulation computes on three contiguous (B, n) x/y/z planes
# instead. A planar triple is a Python tuple (x, y, z) of
# same-shaped arrays. The vector-signature predictors above are thin
# planarize→compute→restack wrappers so there is exactly one numeric
# formulation (tests/test_kernel_units.py planar parity).
# ---------------------------------------------------------------------------


def _psub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _pdot(a, b):
    # jnp.sum(v, axis=-1) reduction order over a size-3 minor axis:
    # (x + y) + z
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def _pcross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _pnormalize(v, eps=1e-30):
    n = jnp.sqrt(jnp.maximum(_pdot(v, v), eps))
    return (v[0] / n, v[1] / n, v[2] / n)


def _pmin_image(d, box):
    return tuple(di - bi * jnp.round(di / bi) for di, bi in zip(d, box))


def _pwrap(x, box):
    return tuple(xi - bi * jnp.floor(xi / bi) for xi, bi in zip(x, box))


def _prodrigues_cs(v, axis, cos, sin):
    """Planar Rodrigues from precomputed cos/sin:
    v·cos + (axis×v)·sin + (axis·(axis·v))·(1−cos), with the vector
    version's exact multiply grouping ((axis * k_dot_v) * (1 − cos))."""
    kc = _pcross(axis, v)
    kdv = _pdot(axis, v)
    one_m = 1.0 - cos
    return tuple(v[i] * cos + kc[i] * sin + (axis[i] * kdv) * one_m
                 for i in range(3))


def _prodrigues(v, axis, angle):
    return _prodrigues_cs(v, axis, jnp.cos(angle), jnp.sin(angle))


def _padd_bond(t, hv):
    """t + normalize(hv) * BOND_LENGTH, planar."""
    u = _pnormalize(hv)
    return (t[0] + u[0] * BOND_LENGTH,
            t[1] + u[1] * BOND_LENGTH,
            t[2] + u[2] * BOND_LENGTH)


def predict_ch3_planar(t, h1, h2, box, handle_pbc):
    th1 = _psub(h1, t)
    th2 = _psub(h2, t)
    if handle_pbc:
        th1 = _pmin_image(th1, box)
        th2 = _pmin_image(th2, box)
    axis1 = _pnormalize(_pcross(th2, th1))
    hv1 = _prodrigues(th1, axis1, TETRAHEDRAL_ANGLE)
    hydrogen1 = _padd_bond(t, hv1)
    axis2 = _pnormalize(th1)
    hv2 = _prodrigues(hv1, axis2, CH3_ANGLE)
    hv3 = _prodrigues(hv1, axis2, -CH3_ANGLE)
    return [hydrogen1, _padd_bond(t, hv2), _padd_bond(t, hv3)]


def predict_ch2_planar(t, h1, h2, box, handle_pbc):
    th1 = _psub(h1, t)
    th2 = _psub(h2, t)
    if handle_pbc:
        th1 = _pmin_image(th1, box)
        th2 = _pmin_image(th2, box)
    u1 = _pnormalize(th1)
    u2 = _pnormalize(th2)
    plane_normal = _pcross(u2, u1)
    rot_axis = _pnormalize(_psub(u1, u2))
    rot_vec = _pcross(plane_normal, rot_axis)
    hv1 = _prodrigues(rot_vec, rot_axis, TETRAHEDRAL_ANGLE_HALF)
    hv2 = _prodrigues(rot_vec, rot_axis, -TETRAHEDRAL_ANGLE_HALF)
    return [_padd_bond(t, hv1), _padd_bond(t, hv2)]


def predict_ch1_unsaturated_planar(t, h1, h2, box, handle_pbc):
    th1 = _psub(h1, t)
    th2 = _psub(h2, t)
    if handle_pbc:
        th1 = _pmin_image(th1, box)
        th2 = _pmin_image(th2, box)
    dot = _pdot(th1, th2)
    norms = jnp.sqrt(_pdot(th1, th1) * _pdot(th2, th2))
    gamma = jnp.arccos(jnp.clip(dot / jnp.maximum(norms, 1e-30), -1.0, 1.0))
    axis = _pnormalize(_pcross(th1, th2))
    hv = _prodrigues(th2, axis, jnp.pi - gamma / 2.0)
    return [_padd_bond(t, hv)]


def predict_ch1_saturated_planar(t, h1, h2, h3, box, handle_pbc):
    th1 = _psub(h1, t)
    th2 = _psub(h2, t)
    th3 = _psub(h3, t)
    if handle_pbc:
        th1 = _pmin_image(th1, box)
        th2 = _pmin_image(th2, box)
        th3 = _pmin_image(th3, box)
    n1 = _pnormalize(th1)
    n2 = _pnormalize(th2)
    n3 = _pnormalize(th3)
    hv = tuple(-(n1[i] + n2[i] + n3[i]) for i in range(3))
    return [_padd_bond(t, hv)]


def _ua_step_impl(coords, box_diag, normal, frame_mask, indices, bond_mol,
                  onehot, leaflet_classes, inv_scale=None,
                  bond_type_ids=None, map_state=None, geom_ref=None, *,
                  handle_pbc, with_leaflets, normal_mode, layout,
                  quantized=False, map_spec=None, geom_spec=None):
    """layout: tuple of (category, n_atoms) pairs in concatenation order.

    `indices` is a dict of per-category index arrays; each category yields
    n_atoms * n_hydrogens virtual-bond samples, concatenated in layout order
    (hydrogen-major per atom: atom0-H0, atom0-H1, ..., atom1-H0, ...)."""
    from .geometry import inside_mask
    from .ordermap import map_cells, update_maps

    # Planar (structure-of-arrays) execution: all per-sample math runs on
    # contiguous (B, n) x/y/z planes (see the planar-predictor block
    # above). Planarize the coordinate
    # array ONCE; every op from here on is bit-identical to the vector
    # formulation.
    if quantized:
        cs = inv_scale[:, None]
        cpl = tuple(coords[..., i].astype(jnp.float32) * cs
                    for i in range(3))
    else:
        cpl = tuple(coords[..., i] for i in range(3))
    boxp = tuple(box_diag[:, i:i + 1] for i in range(3))  # (B, 1) columns
    if normal_mode == "static":
        npl = None
    else:
        npl = tuple(normal[..., i] for i in range(3))     # (B, M) planes

    def gather(ix):
        return tuple(jnp.take(p, ix, axis=1) for p in cpl)

    with_pos = map_spec is not None or geom_spec is not None
    pos_parts = []
    sch_parts = []
    for category, _n in layout:
        ix = indices[category]
        t = gather(ix["target"])
        h1 = gather(ix["h1"])
        h2 = gather(ix["h2"]) if "h2" in ix else None
        if category == "ch3":
            hydrogens = predict_ch3_planar(t, h1, h2, boxp, handle_pbc)
        elif category == "ch2":
            hydrogens = predict_ch2_planar(t, h1, h2, boxp, handle_pbc)
        elif category == "ch1u":
            hydrogens = predict_ch1_unsaturated_planar(
                t, h1, h2, boxp, handle_pbc)
        else:  # ch1s
            h3 = gather(ix["h3"])
            hydrogens = predict_ch1_saturated_planar(
                t, h1, h2, h3, boxp, handle_pbc)

        if normal_mode != "static":
            pb_normal = tuple(jnp.take(p, ix["mol"], axis=1) for p in npl)
            n2 = jnp.maximum(_pdot(pb_normal, pb_normal), 1e-18)

        per_atom = []
        per_atom_pos = []
        for hpos in hydrogens:
            if handle_pbc:
                hpos = _pwrap(hpos, boxp)
            vec = _psub(hpos, t)
            if handle_pbc:
                vec = _pmin_image(vec, boxp)
            if normal_mode == "static":
                proj = (vec[0] * normal[0] + vec[1] * normal[1]) \
                    + vec[2] * normal[2]
                n2 = jnp.float32(1.0)
            else:
                proj = _pdot(vec, pb_normal)
            d2 = jnp.maximum(_pdot(vec, vec), 1e-18)
            per_atom.append(1.5 * (proj * proj) / (d2 * n2) - 0.5)
            if with_pos:
                # the reference's bond position (uaorder.rs:386):
                # hydrogen + (hydrogen − target)/2
                per_atom_pos.append(tuple(
                    hpos[i] + vec[i] * 0.5 for i in range(3)))
        # hydrogen-major per atom: (B, n, K) → (B, n*K)
        stacked = jnp.stack(per_atom, axis=-1)
        sch_parts.append(stacked.reshape(stacked.shape[0], -1))
        if with_pos:
            # (B, n, K, 3) in the vector layout the map/geometry kernels
            # expect — assembled only when those kernels are active
            pstacked = jnp.stack(
                [jnp.stack([p[i] for p in per_atom_pos], axis=-1)
                 for i in range(3)], axis=-1)              # (B, n, K, 3)
            pos_parts.append(
                pstacked.reshape(pstacked.shape[0], -1, 3))

    sch = jnp.concatenate(sch_parts, axis=1)          # (B, Nv)

    l2, l1, l0 = quantize_split(sch)
    valid = frame_mask[:, None].astype(jnp.float32)
    ones = jnp.broadcast_to(valid, sch.shape)

    if with_pos:
        bond_pos = jnp.concatenate(pos_parts, axis=1)  # (B, Nv, 3)
    if geom_spec is not None:
        from .order import _geometry_reference

        coords_f = jnp.stack(cpl, axis=-1)          # dequantized (B, N, 3)
        ref = _geometry_reference(coords_f, box_diag, geom_ref, handle_pbc)
        geo = inside_mask(bond_pos, ref, box_diag, geom_spec, handle_pbc)
        ones = ones * geo

    masks = {"total": ones}
    if with_leaflets:
        cls = jnp.take(leaflet_classes, bond_mol, axis=1)
        masks["upper"] = ones * (cls == 0)
        masks["lower"] = ones * (cls == 1)

    out = {c: limb_reduce(l2, l1, l0, m, onehot) for c, m in masks.items()}

    if map_spec is not None:
        n_types = onehot.shape[1]
        cells, _ = map_cells(bond_pos, map_spec, bond_type_ids, n_types)
        map_state = update_maps(map_state, sch, cells, masks)
    return out, map_state


_ua_step = jax.jit(
    _ua_step_impl,
    static_argnames=("handle_pbc", "with_leaflets", "normal_mode", "layout",
                     "quantized", "map_spec", "geom_spec"),
)


def make_ua_step(categories: Dict[str, Dict[str, np.ndarray]],
                 bond_type: np.ndarray, bond_mol: np.ndarray, n_types: int,
                 *, handle_pbc=True, with_leaflets=False,
                 normal_mode="static", map_spec=None, geom_spec=None):
    """categories: {'ch3': {'target','h1','h2','mol'}, 'ch2': ...,
    'ch1u': ..., 'ch1s': {..., 'h3'}}; bond_type/bond_mol are per
    virtual-bond-sample arrays in the concatenated layout order."""
    from .order import _one_hot

    layout = tuple(
        (cat, len(categories[cat]["target"]))
        for cat in ("ch3", "ch2", "ch1u", "ch1s") if cat in categories
    )
    indices = {
        cat: {k: put_const(np.asarray(v, np.int32))
              for k, v in categories[cat].items()}
        for cat, _ in layout
    }
    onehot_d = put_const(_one_hot(np.asarray(bond_type), n_types))
    bond_mol_d = put_const(np.asarray(bond_mol, np.int32))
    bond_type_d = put_const(np.asarray(bond_type, np.int32))
    dummy = put_const(np.zeros((1, 1), np.int32))

    def step(coords, box_diag, normal, frame_mask, leaflet_classes=None,
             inv_scale=None, map_state=None, geom_ref=None):
        return _ua_step(
            coords, box_diag, normal, frame_mask, indices, bond_mol_d,
            onehot_d,
            leaflet_classes if leaflet_classes is not None else dummy,
            inv_scale, bond_type_d, map_state, geom_ref,
            handle_pbc=handle_pbc, with_leaflets=with_leaflets,
            normal_mode=normal_mode, layout=layout,
            quantized=inv_scale is not None,
            map_spec=map_spec, geom_spec=geom_spec,
        )

    def impl(coords, box_diag, normal, frame_mask, leaflet_classes=None,
             inv_scale=None, map_state=None, geom_ref=None,
             geom_plane=None, *, diff_input=False):
        """Traceable (unjitted) body for fused per-batch programs
        (engine/fused.py _build_fused_steps): wire reconstruction and the
        UA kernel compile as ONE XLA program. geom_plane is accepted for
        signature parity with the bond-based step (the decoder geometry
        channel is bond-wire-only, which UA never rides)."""
        assert not diff_input and geom_plane is None
        return _ua_step_impl(
            coords, box_diag, normal, frame_mask, indices, bond_mol_d,
            onehot_d,
            leaflet_classes if leaflet_classes is not None else dummy,
            inv_scale, bond_type_d, map_state, geom_ref,
            handle_pbc=handle_pbc, with_leaflets=with_leaflets,
            normal_mode=normal_mode, layout=layout,
            quantized=inv_scale is not None,
            map_spec=map_spec, geom_spec=geom_spec,
        )

    step.impl = impl
    return step
